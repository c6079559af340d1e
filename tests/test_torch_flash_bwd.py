"""The port's flash-attention backward on the CPU (the plain versions of
the dQ and dK/dV Hopper kernels, reached through the autograd Function)
against `jax.vjp` of paddle_tpu's flash attention, whose backward runs the
Pallas `_flash_bwd_dq_kernel` / `_flash_bwd_dkv_kernel` in interpret mode
as tests/test_attention.py runs them.  Inputs and the output cotangent come
from a seeded numpy RNG and go to both packages.

Tolerances: fp32 atol=rtol=1e-5 (same algorithm, different summation
order); bf16 atol=rtol=2e-2 through the public op against the reference
in bf16 (the JAX op tiles differently and each output is rounded to bf16
once more; gradients here are O(1), so that is a few bf16 ulps);
atol=rtol=1e-2 for the dQ and dK/dV plain versions against the Pallas
`_flash_bwd_dq_kernel` / `_flash_bwd_dkv_kernel` themselves on the same
out, lse and D: both sides round P and dS to bf16 before their products
(dQ: `ds.astype(ks.dtype)`), so they differ by the summation order and
one rounding of the output; atol=rtol=2e-3 for the same comparison in
fp16 (an fp16 ulp is 2^-11 relative, 8x finer than bf16's).  The padded
head dims (48, 96) hold fp32 tolerance: zero columns change no sum.

The fp32 dQ and dK/dV kernels multiply in 3xTF32 on the tensor cores;
`test_fp32_kernels_error_model_matches_pallas_kernels` emulates that
arithmetic here (`_mm_3xtf32`) and holds it to the 1e-4 that
chip_smoke.py gates the kernels with.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as jattn
from paddle_tpu_torch.ops import attention as tattn

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_KERNEL_TOL = dict(rtol=1e-2, atol=1e-2)
FP32_KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)
FP16_KERNEL_TOL = dict(rtol=2e-3, atol=2e-3)
_MATMUL = torch.matmul  # the fp32 product, before a test swaps it


def _tf32(x):
    """x as the tensor cores read an fp32 register as TF32: the 13 low
    mantissa bits cleared."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the fp32 kernels take it (csrc/tf32.cuh): each operand
    split as x = hi + lo, hi = x with 13 mantissa bits cleared and lo =
    x - hi, lo read truncated to TF32 as well; three products lo hi +
    hi lo + hi hi, summed in fp32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return _MATMUL(al, bh) + _MATMUL(ah, bl) + _MATMUL(ah, bh)


def _mm_tf32(a, b):
    """a @ b in plain TF32: one product of the hi parts."""
    return _MATMUL(_tf32(a), _tf32(b))


def _inputs(b, h, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32)
            for s in (sq, sk, sk, sq)]  # q, k, v, dO


def _grads_both(q, k, v, g, causal, dtype="float32"):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))
    _, vjp = jax.vjp(lambda a, b_, c: jattn.flash_attention(
        a, b_, c, causal=causal), jq, jk, jv)
    ref = [np.asarray(x.astype(jnp.float32)) for x in vjp(jg)]
    tq, tk, tv, tg = (torch.from_numpy(x).to(tdt) for x in (q, k, v, g))
    _, tvjp = torch.func.vjp(lambda a, b_, c: tattn.flash_attention(
        a, b_, c, causal=causal), tq, tk, tv)
    got = [x.float().numpy() for x in tvjp(tg)]
    return ref, got


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64])
def test_flash_bwd_matches_pallas_fp32(causal, d):
    ref, got = _grads_both(*_inputs(2, 2, 64, 64, d, seed=d), causal)
    for tag, r, g in zip(("dq", "dk", "dv"), ref, got):
        np.testing.assert_allclose(g, r, err_msg=tag, **FP32_TOL)


@pytest.mark.parametrize("sq,sk", [(32, 96), (96, 32)])
def test_flash_bwd_cross_length_causal(sq, sk):
    """Bottom-right causal alignment with Sq != Sk both ways.  For Sq > Sk
    the first Sq - Sk queries see no key: their dq is 0 on both sides and
    they add nothing to dk, dv."""
    ref, got = _grads_both(*_inputs(2, 2, sq, sk, 32, seed=5), True)
    for tag, r, g in zip(("dq", "dk", "dv"), ref, got):
        np.testing.assert_allclose(g, r, err_msg=tag, **FP32_TOL)
    if sq > sk:
        assert np.all(got[0][:, :, :sq - sk] == 0)


def test_flash_bwd_matches_pallas_bf16():
    ref, got = _grads_both(*_inputs(2, 2, 64, 64, 32, seed=7), False,
                           dtype="bfloat16")
    for tag, r, g in zip(("dq", "dk", "dv"), ref, got):
        np.testing.assert_allclose(g, r, err_msg=tag, **BF16_TOL)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_dkv_plain_matches_pallas_kernel(causal, d):
    """flash_attention_bwd_dkv_plain in bf16 against the Pallas dK/dV
    kernel (`_flash_bwd`, interpret mode) on the same inputs: out and lse
    from the Pallas forward, D = rowsum(dO * O) from the same out."""
    q, k, v, g = _inputs(2, 2, 128, 128, d, seed=20 + d + causal)
    jq, jk, jv, jg = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g))
    scale = 1.0 / float(np.sqrt(d))
    out, lse = jattn._flash_fwd(jq, jk, jv, causal, scale, 64, 64,
                                interpret=True)
    _, ref_dk, ref_dv = jattn._flash_bwd(jq, jk, jv, out, lse, jg, causal,
                                         scale, 64, 64, interpret=True)
    tq, tk, tv, tg = (torch.from_numpy(x).to(torch.bfloat16)
                      for x in (q, k, v, g))
    tout = torch.tensor(np.asarray(out.astype(jnp.float32))).to(
        torch.bfloat16)
    tlse = torch.tensor(np.asarray(lse)[..., 0])
    dd = (tg.float() * tout.float()).sum(-1)
    dk, dv = tattn.flash_attention_bwd_dkv_plain(tq, tk, tv, tg, tlse, dd,
                                                 causal)
    assert dk.dtype == dv.dtype == torch.bfloat16
    for tag, got, ref in (("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   err_msg=tag, **BF16_KERNEL_TOL)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_dq_plain_matches_pallas_kernel(causal, d):
    """flash_attention_bwd_dq_plain in bf16 against the Pallas dQ kernel
    (`_flash_bwd`, interpret mode) on the same inputs: out and lse from
    the Pallas forward, D = rowsum(dO * O) from the same out."""
    q, k, v, g = _inputs(2, 2, 128, 128, d, seed=40 + d + causal)
    jq, jk, jv, jg = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g))
    scale = 1.0 / float(np.sqrt(d))
    out, lse = jattn._flash_fwd(jq, jk, jv, causal, scale, 64, 64,
                                interpret=True)
    ref_dq = jattn._flash_bwd(jq, jk, jv, out, lse, jg, causal, scale, 64,
                              64, interpret=True)[0]
    tq, tk, tv, tg = (torch.from_numpy(x).to(torch.bfloat16)
                      for x in (q, k, v, g))
    tout = torch.tensor(np.asarray(out.astype(jnp.float32))).to(
        torch.bfloat16)
    tlse = torch.tensor(np.asarray(lse)[..., 0])
    dd = (tg.float() * tout.float()).sum(-1)
    dq = tattn.flash_attention_bwd_dq_plain(tq, tk, tv, tg, tlse, dd, causal)
    assert dq.dtype == torch.bfloat16
    np.testing.assert_allclose(dq.float().numpy(),
                               np.asarray(ref_dq.astype(jnp.float32)),
                               **BF16_KERNEL_TOL)


def _pallas_bwd(q, k, v, g, causal, jdt, tdt):
    """The Pallas forward and backward (interpret mode) at the inputs' own
    head dim in `jdt`, and the port's operands in `tdt`: q, k, v, dO, and
    lse and D = rowsum(dO * O) from the Pallas out.  Returns (reference
    (dq, dk, dv) in fp32, port operands, scale)."""
    d = q.shape[-1]
    jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))
    scale = 1.0 / float(np.sqrt(d))
    out, lse = jattn._flash_fwd(jq, jk, jv, causal, scale, 64, 64,
                                interpret=True)
    ref = [np.asarray(x.astype(jnp.float32)) for x in jattn._flash_bwd(
        jq, jk, jv, out, lse, jg, causal, scale, 64, 64, interpret=True)]
    tq, tk, tv, tg = (torch.from_numpy(x).to(tdt) for x in (q, k, v, g))
    tout = torch.tensor(np.asarray(out.astype(jnp.float32))).to(tdt)
    tlse = torch.tensor(np.asarray(lse)[..., 0])
    dd = (tg.float() * tout.float()).sum(-1)
    return ref, (tq, tk, tv, tg, tlse, dd), scale


@pytest.mark.parametrize("d", [48, 96])
@pytest.mark.parametrize("causal", [False, True])
def test_padded_head_dim_bwd_matches_pallas(causal, d):
    """The kernels' path for a head dim without an instance: q, k, v and
    dO zero-padded to kernel_head_dim(d), dQ and dK/dV at the padded width
    with the scale of the real d (lse and D unchanged by zero columns),
    dq, dk, dv sliced back.  Held against the Pallas `_flash_bwd`
    (interpret mode) at the real d in fp32: FP32_TOL."""
    q, k, v, g = _inputs(2, 2, 128, 128, d, seed=70 + d + causal)
    ref, (tq, tk, tv, tg, tlse, dd), scale = _pallas_bwd(
        q, k, v, g, causal, jnp.float32, torch.float32)
    dp, (pq, pk, pv, pg) = tattn.kernel_operands(d, tq, tk, tv, tg)
    dq = tattn.flash_attention_bwd_dq_plain(pq, pk, pv, pg, tlse, dd,
                                            causal, scale)
    dk, dv = tattn.flash_attention_bwd_dkv_plain(pq, pk, pv, pg, tlse, dd,
                                                 causal, scale)
    for tag, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert got.shape[-1] == dp and torch.all(got[..., d:] == 0), tag
        np.testing.assert_allclose(got[..., :d].numpy(), want, err_msg=tag,
                                   **FP32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_fp16_bwd_plain_matches_pallas_kernels(causal):
    """flash_attention_bwd_dq_plain and _dkv_plain in fp16 (the fp16
    kernels' plain versions: P and dS rounded to fp16 before the second
    products, as the TPU kernels' `.astype`) against the Pallas
    `_flash_bwd` in interpret mode in fp16 on the same out, lse and D:
    FP16_KERNEL_TOL (summation order and one fp16 rounding of each
    output; an fp16 ulp is 2^-11 relative)."""
    q, k, v, g = _inputs(2, 2, 128, 128, 64, seed=80 + causal)
    ref, args, _ = _pallas_bwd(q, k, v, g, causal, jnp.float16,
                               torch.float16)
    dq = tattn.flash_attention_bwd_dq_plain(*args, causal)
    dk, dv = tattn.flash_attention_bwd_dkv_plain(*args, causal)
    for tag, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert got.dtype == torch.float16, tag
        np.testing.assert_allclose(got.float().numpy(), want, err_msg=tag,
                                   **FP16_KERNEL_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dq_plain_rounds_ds_like_the_kernels(dtype):
    """The dQ plain version multiplies dS rounded to the input dtype (one
    key tile: dQ = scale round(dS) k exactly); in fp32 the rounding is the
    identity, so fp32 dQ is the unrounded product to the last bit."""
    q, k, v, g = (torch.from_numpy(x).to(dtype)
                  for x in _inputs(1, 1, 48, 32, 32, seed=8))
    scale = 1.0 / np.sqrt(32)
    out, lse = tattn.flash_attention_plain(q, k, v)
    dd = (g.float() * out.float()).sum(-1)
    dq = tattn.flash_attention_bwd_dq_plain(q, k, v, g, lse, dd)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    ds = p * (torch.matmul(g.float(), v.float().transpose(-1, -2)) -
              dd[..., None])
    want = torch.matmul(ds.to(dtype).float(), k.float()) * scale
    torch.testing.assert_close(dq, want.to(dtype), rtol=0, atol=0)


def test_dkv_plain_rounds_p_and_ds_like_the_kernels():
    """In bf16 the dK/dV plain version multiplies P and dS rounded to bf16
    (one q tile: dV = round(P)^T dO, dK = scale round(dS)^T q exactly)."""
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in _inputs(1, 1, 32, 48, 32, seed=6))
    scale = 1.0 / np.sqrt(32)
    out, lse = tattn.flash_attention_plain(q, k, v)
    dd = (g.float() * out.float()).sum(-1)
    dk, dv = tattn.flash_attention_bwd_dkv_plain(q, k, v, g, lse, dd)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    ds = p * (torch.matmul(g.float(), v.float().transpose(-1, -2)) -
              dd[..., None])
    r = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    want_dv = torch.matmul(r(p).transpose(-1, -2), g.float())
    want_dk = torch.matmul(r(ds).transpose(-1, -2), q.float()) * scale
    torch.testing.assert_close(dv, want_dv.to(torch.bfloat16), rtol=0,
                               atol=0)
    torch.testing.assert_close(dk, want_dk.to(torch.bfloat16), rtol=0,
                               atol=0)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_fp32_kernels_error_model_matches_pallas_kernels(monkeypatch, causal,
                                                         d):
    """The plain dQ and dK/dV tile loops with every product taken as the
    fp32 kernels take it (3xTF32) against the Pallas `_flash_bwd_dq_kernel`
    / `_flash_bwd_dkv_kernel` in interpret mode in fp32, on the same out,
    lse and D: within 1e-4.  The same loops in plain TF32 miss 1e-4 on
    every output, so the three products are what keeps the kernels at an
    fp32-level error."""
    q, k, v, g = _inputs(1, 2, 128, 128, d, seed=60 + d + causal)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    scale = 1.0 / float(np.sqrt(d))
    out, lse = jattn._flash_fwd(jq, jk, jv, causal, scale, 64, 64,
                                interpret=True)
    ref = [np.asarray(x) for x in jattn._flash_bwd(
        jq, jk, jv, out, lse, jg, causal, scale, 64, 64, interpret=True)]
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    tlse = torch.from_numpy(np.array(lse)[..., 0])
    dd = (tg * torch.from_numpy(np.array(out))).sum(-1)

    def grads(matmul):
        monkeypatch.setattr(torch, "matmul", matmul)
        try:
            dq = tattn.flash_attention_bwd_dq_plain(tq, tk, tv, tg, tlse, dd,
                                                    causal)
            dk, dv = tattn.flash_attention_bwd_dkv_plain(tq, tk, tv, tg,
                                                         tlse, dd, causal)
        finally:
            monkeypatch.setattr(torch, "matmul", _MATMUL)
        return [x.numpy() for x in (dq, dk, dv)]

    for tag, got, want in zip(("dq", "dk", "dv"), grads(_mm_3xtf32), ref):
        np.testing.assert_allclose(got, want, err_msg=tag, **FP32_KERNEL_TOL)
    for tag, got, want in zip(("dq", "dk", "dv"), grads(_mm_tf32), ref):
        assert not np.allclose(got, want, **FP32_KERNEL_TOL), tag


def test_plain_dq_dkv_split_equals_whole():
    """flash_attention_bwd_plain is the dQ and dK/dV plain versions side
    by side; D = rowsum(dO * O) as the autograd Function computes it."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 2, 40, 72, 32, 3))
    out, lse = tattn.flash_attention_plain(q, k, v, causal=True)
    dd = (g * out).sum(-1)
    dq, dk, dv = tattn.flash_attention_bwd_plain(q, k, v, g, lse, dd, True)
    torch.testing.assert_close(
        dq, tattn.flash_attention_bwd_dq_plain(q, k, v, g, lse, dd, True),
        rtol=0, atol=0)
    dk2, dv2 = tattn.flash_attention_bwd_dkv_plain(q, k, v, g, lse, dd, True)
    torch.testing.assert_close(dk, dk2, rtol=0, atol=0)
    torch.testing.assert_close(dv, dv2, rtol=0, atol=0)


def test_backward_kernels_get_plain_tensors_under_vjp(monkeypatch):
    """Inside torch.func.vjp (how the grad ops run) the autograd Function's
    backward sees functorch wrappers with no data pointer; the backward
    kernels must still be handed plain tensors, as a CUDA launch needs
    their addresses.  The CPU dispatch stands in for the launch here."""
    seen = []
    plain = tattn.flash_attention_bwd_plain

    def needs_pointers(*args):
        for t in args:
            if isinstance(t, torch.Tensor):
                t.data_ptr()
        seen.append(True)
        return plain(*args)

    monkeypatch.setattr(tattn, "flash_attention_bwd_plain", needs_pointers)
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 1, 16, 16, 32, 0))
    with torch.no_grad():
        _, vjp = torch.func.vjp(lambda a: tattn.flash_attention(a, k, v), q)
        (dq,) = vjp(g)
    assert seen and dq.shape == q.shape and torch.isfinite(dq).all()


def test_bwd_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 1, 8, 64)
    lse, dd = torch.zeros(1, 1, 8), torch.zeros(1, 1, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tattn.flash_attention_bwd_dq_cuda(q, q, q, q, lse, dd)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tattn.flash_attention_bwd_dkv_cuda(q, q, q, q, lse, dd)
    meta = torch.empty(1, 1, 8, 64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        tattn.flash_attention_bwd(meta, meta, meta, meta, lse, meta)
