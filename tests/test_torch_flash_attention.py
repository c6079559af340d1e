"""The port's flash attention on the CPU (the plain version of the Hopper
kernel) against paddle_tpu's Pallas flash kernel, run in interpret mode
as tests/test_attention.py runs it.  Inputs come from a seeded numpy RNG
and go to both packages.

Tolerances: fp32 atol=rtol=1e-5 (same algorithm, different summation
order); bf16 atol=rtol=2e-2 through the public op (the JAX op tiles the
keys differently, and each side rounds P and the output to bf16), and
atol=rtol=1e-2 for the plain version against the Pallas kernel itself at
the same 64-row tiles: both round P to bf16 before the P.V product, so
they differ by the summation order and one bf16 rounding of the output
(a bf16 ulp is 2^-8 relative); fp16 atol=rtol=2e-3 for the same
comparison in fp16 (an fp16 ulp is 2^-11 relative, 8x finer).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import attention as jattn
from paddle_tpu_torch.ops import attention as tattn

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_KERNEL_TOL = dict(rtol=1e-2, atol=1e-2)
FP16_KERNEL_TOL = dict(rtol=2e-3, atol=2e-3)


def _inputs(b, h, sq, sk, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, h, sk, d).astype(np.float32)
    v = rng.randn(b, h, sk, d).astype(np.float32)
    return q, k, v


def _both(q, k, v, causal, dtype="float32"):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = jattn.flash_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                jnp.asarray(v, jdt), causal=causal)
    got = tattn.flash_attention(torch.from_numpy(q).to(tdt),
                                torch.from_numpy(k).to(tdt),
                                torch.from_numpy(v).to(tdt), causal=causal)
    return (np.asarray(ref.astype(jnp.float32)),
            got.float().numpy())


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_pallas(causal, d):
    q, k, v = _inputs(2, 2, 64, 64, d)
    ref, got = _both(q, k, v, causal)
    np.testing.assert_allclose(got, ref, **FP32_TOL)


@pytest.mark.parametrize("sq,sk", [(32, 96), (96, 32)])
def test_flash_cross_length_causal(sq, sk):
    """Bottom-right causal alignment with sq != sk.  For sq > sk the first
    sq - sk queries see no key: both flash paths write 0 there."""
    q, k, v = _inputs(2, 2, sq, sk, 32, seed=1)
    ref, got = _both(q, k, v, causal=True)
    valid = np.arange(sq) + (sk - sq) >= 0
    np.testing.assert_allclose(got[:, :, valid], ref[:, :, valid], **FP32_TOL)
    assert np.all(got[:, :, ~valid] == 0.0)
    assert np.all(ref[:, :, ~valid] == 0.0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bf16_inputs(causal):
    q, k, v = _inputs(1, 2, 64, 64, 32, seed=2)
    ref, got = _both(q, k, v, causal, dtype="bfloat16")
    np.testing.assert_allclose(got, ref, **BF16_TOL)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_plain_matches_pallas_kernel(causal, d):
    """flash_attention_plain in bf16 against the Pallas `_flash_fwd`
    (interpret mode) at the same 64-row q and key tiles: out and lse."""
    q, k, v = _inputs(2, 2, 128, 128, d, seed=10 + d + causal)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    scale = 1.0 / float(np.sqrt(d))
    ref, ref_lse = jattn._flash_fwd(jq, jk, jv, causal, scale, 64, 64,
                                    interpret=True)
    got, lse = tattn.flash_attention_plain(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **BF16_KERNEL_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               **FP32_TOL)


def test_plain_rounds_p_like_the_kernels():
    """In bf16 the plain version's P.V product takes P rounded to bf16:
    with one key tile, out is exactly round(P) v / l of the fp32 P."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(1, 1, 16, 48, 32, seed=4))
    out, lse = tattn.flash_attention_plain(q, k, v)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / np.sqrt(32)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    want = torch.matmul(p.to(torch.bfloat16).float(), v.float()) / \
        p.sum(-1, keepdim=True)
    torch.testing.assert_close(out, want.to(torch.bfloat16), rtol=0, atol=0)


def test_plain_lse_and_ragged_tiles():
    """lse of the plain version is the row logsumexp of the scaled
    scores; a key length that is not a multiple of the 64-row tile
    matches the score-matrix path."""
    q, k, v = _inputs(1, 2, 40, 100, 32, seed=3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = tattn.flash_attention_plain(tq, tk, tv)
    scores = torch.matmul(tq, tk.transpose(-1, -2)) / np.sqrt(32)
    np.testing.assert_allclose(lse.numpy(),
                               torch.logsumexp(scores, -1).numpy(),
                               **FP32_TOL)
    np.testing.assert_allclose(
        out.numpy(), tattn.reference_attention(tq, tk, tv).numpy(),
        **FP32_TOL)
    _, lse_c = tattn.flash_attention_plain(tq[:, :, :8], tk[:, :, :4],
                                           tv[:, :, :4], causal=True)
    assert torch.isinf(lse_c[:, :, :4]).all() and \
        torch.isfinite(lse_c[:, :, 4:]).all()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """Any positive head dim and fp16 reach the kernels (D = 48 is padded,
    fp16 has wgmma instances, D = 160 pads to the D = 256 kernels, D = 264
    to the split-D route at 512); an empty head dim, a dtype without a
    kernel, a strided head dim, a CPU tensor handed to the launcher and a
    device without a kernel still raise."""
    for ok in (torch.zeros(1, 1, 8, 48), torch.zeros(1, 1, 8, 96),
               torch.zeros(1, 1, 8, 64, dtype=torch.float16),
               torch.zeros(1, 1, 8, 160), torch.zeros(1, 1, 8, 256),
               torch.zeros(1, 1, 8, 264)):
        tattn._check_cuda_args(ok, ok, ok)
    assert tattn.kernel_head_dim(264) == 512
    q = torch.zeros(1, 1, 8, 0)
    with pytest.raises(ValueError, match="positive head dim"):
        tattn._check_cuda_args(q, q, q)
    f64 = torch.zeros(1, 1, 8, 64, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        tattn._check_cuda_args(f64, f64, f64)
    t = torch.zeros(1, 1, 64, 8).transpose(-1, -2)
    with pytest.raises(ValueError, match="contiguous head dim"):
        tattn._check_cuda_args(t, t, t)
    ok = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tattn.flash_attention_cuda(ok, ok, ok)
    meta = torch.empty(1, 1, 8, 64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        tattn.flash_attention(meta, meta, meta)


@pytest.mark.parametrize("d", [48, 96])
@pytest.mark.parametrize("causal", [False, True])
def test_padded_head_dim_matches_pallas(causal, d):
    """The kernels' path for a head dim without an instance: q, k, v
    zero-padded to kernel_head_dim(d) (64, 128), the forward at the padded
    width with the scale of the real d, out sliced back.  Held against the
    Pallas `_flash_fwd` (interpret mode) at the real d: out and lse.  The
    zero columns add nothing to q k^T, so fp32 tolerance holds."""
    q, k, v = _inputs(2, 2, 128, 128, d, seed=30 + d + causal)
    scale = 1.0 / float(np.sqrt(d))
    ref, ref_lse = jattn._flash_fwd(*(jnp.asarray(x) for x in (q, k, v)),
                                    causal, scale, 64, 64, interpret=True)
    dp, padded = tattn.kernel_operands(
        d, *(torch.from_numpy(x) for x in (q, k, v)))
    assert dp == tattn.kernel_head_dim(d) == (64 if d == 48 else 128)
    assert all(t.shape[-1] == dp and t.is_contiguous() for t in padded)
    out, lse = tattn.flash_attention_plain(*padded, causal=causal,
                                           scale=scale)
    assert torch.all(out[..., d:] == 0)
    np.testing.assert_allclose(out[..., :d].numpy(), np.asarray(ref),
                               **FP32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               **FP32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_fp16_plain_matches_pallas_kernel(causal):
    """flash_attention_plain in fp16 (the fp16 kernels' plain version: P
    rounded to fp16 before P.v, the TPU kernel's `p.astype(vs.dtype)`)
    against the Pallas `_flash_fwd` in interpret mode in fp16 at the same
    64-row tiles: out within FP16_KERNEL_TOL (summation order and one fp16
    rounding of the output; an fp16 ulp is 2^-11 relative), lse within
    fp32 tolerance."""
    q, k, v = _inputs(2, 2, 128, 128, 64, seed=50 + causal)
    jq, jk, jv = (jnp.asarray(x, jnp.float16) for x in (q, k, v))
    ref, ref_lse = jattn._flash_fwd(jq, jk, jv, causal, 0.125, 64, 64,
                                    interpret=True)
    got, lse = tattn.flash_attention_plain(
        *(torch.from_numpy(x).to(torch.float16) for x in (q, k, v)),
        causal=causal)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **FP16_KERNEL_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               **FP32_TOL)


def test_bf16_views_that_tma_refuses():
    """The bf16 and fp16 kernels read q, k, v (and dO) through TMA tensor
    maps, which need a 16-byte aligned base address and byte strides that
    are multiples of 16.  kernel_operands copies a view that TMA refuses
    to a contiguous tensor and counts the copy in
    flash_attention.view_copies; the strided head-split view [B, S, H*D]
    -> [B, H, S, D] of the main path, and any fp32 view, pass uncopied."""
    bf16 = torch.bfloat16
    split = torch.randn(2, 8, 4 * 64).to(bf16).view(2, 8, 4, 64) \
        .permute(0, 2, 1, 3)
    flat = torch.randn(2 * 4 * 8 * 64 + 1).to(bf16)
    shifted = flat[1:].view(2, 4, 8, 64)  # storage offset of one element
    odd = torch.randn(2, 8, 4 * 64 + 4).to(bf16)[..., :256] \
        .view(2, 8, 4, 64).permute(0, 2, 1, 3)  # sequence stride 260 x 2 B
    half = torch.randn(2 * 4 * 8 * 64 + 1).to(torch.float16)[1:] \
        .view(2, 4, 8, 64)
    f32 = torch.zeros(2 * 4 * 8 * 64 + 1)[1:].view(2, 4, 8, 64)
    assert tattn.tma_accepts(split)
    assert not any(map(tattn.tma_accepts, (shifted, odd, half)))
    before = tattn.flash_attention.view_copies
    dp, (a, b, c) = tattn.kernel_operands(64, split, split, f32)
    assert dp == 64 and a is split and b is split and c is f32
    assert tattn.flash_attention.view_copies == before
    _, copied = tattn.kernel_operands(64, shifted, odd, half)
    assert tattn.flash_attention.view_copies == before + 3
    for got, view in zip(copied, (shifted, odd, half)):
        assert got is not view and tattn.tma_accepts(got)
        assert got.is_contiguous() and got.dtype == view.dtype
        assert torch.equal(got, view)


def _wide_head_dim_parity(d, causal, dp):
    """The padded plain forward, dQ and dK/dV at kernel head dim dp (the
    route of the D = 256 and split-D kernels: q, k, v and dO zero-padded
    by kernel_operands, the scale of the real d, sliced back) against the
    Pallas `_flash_fwd` and `_flash_bwd` (interpret mode) at the real d in
    fp32: FP32_TOL for out, lse, dq, dk and dv."""
    q, k, v = _inputs(1, 2, 128, 128, d, seed=90 + d + causal)
    g = np.random.RandomState(d).randn(*q.shape).astype(np.float32)
    scale = 1.0 / float(np.sqrt(d))
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    ref, ref_lse = jattn._flash_fwd(jq, jk, jv, causal, scale, 64, 64,
                                    interpret=True)
    ref_grads = jattn._flash_bwd(jq, jk, jv, ref, ref_lse, jg, causal,
                                 scale, 64, 64, interpret=True)
    assert tattn.kernel_head_dim(d) == dp
    got_dp, (pq, pk, pv, pg) = tattn.kernel_operands(
        d, *(torch.from_numpy(x) for x in (q, k, v, g)))
    assert got_dp == dp and all(t.shape[-1] == dp for t in (pq, pk, pv, pg))
    out, lse = tattn.flash_attention_plain(pq, pk, pv, causal=causal,
                                           scale=scale)
    np.testing.assert_allclose(out[..., :d].numpy(), np.asarray(ref),
                               **FP32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               **FP32_TOL)
    dd = (pg * out).sum(-1)
    dq = tattn.flash_attention_bwd_dq_plain(pq, pk, pv, pg, lse, dd, causal,
                                            scale)
    dk, dv = tattn.flash_attention_bwd_dkv_plain(pq, pk, pv, pg, lse, dd,
                                                 causal, scale)
    for tag, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref_grads):
        assert torch.all(got[..., d:] == 0), tag
        np.testing.assert_allclose(got[..., :d].numpy(), np.asarray(want),
                                   err_msg=tag, **FP32_TOL)


@pytest.mark.parametrize("d", [160, 200, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_head_dims_to_256_match_pallas(causal, d):
    """Head dims 129-256, the route of the D = 256 kernels (D = 256
    itself unpadded)."""
    _wide_head_dim_parity(d, causal, 256)


@pytest.mark.parametrize("d", [320, 512, 768])
@pytest.mark.parametrize("causal", [False, True])
def test_head_dims_above_256_match_pallas(causal, d):
    """Head dims above 256, the split-D routes: padded to the next multiple
    of 256 (320 -> 512; 512 and 768, three 256-column chunks, unpadded)."""
    _wide_head_dim_parity(d, causal, -(-d // 256) * 256)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("d", [320, 512])
@pytest.mark.parametrize("causal", [False, True])
def test_16bit_head_dims_above_256_bwd_match_pallas(causal, d, dtype):
    """The 16-bit split-D dQ and dK/dV's plain versions at the padded
    kernel head dim (320 -> 512: q, k, v and dO zero-padded by
    kernel_operands, the scale of the real d, sliced back) against the
    Pallas `_flash_bwd` in interpret mode at the real d in the same dtype,
    on the Pallas forward's out and lse: both round P and dS to the dtype
    before the second products, so they differ by the summation order and
    one rounding of each output (BF16_KERNEL_TOL, FP16_KERNEL_TOL)."""
    jdt, tdt, tol = {
        "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_KERNEL_TOL),
        "float16": (jnp.float16, torch.float16, FP16_KERNEL_TOL)}[dtype]
    q, k, v = _inputs(1, 2, 128, 128, d, seed=110 + d + causal)
    g = np.random.RandomState(d + 1).randn(*q.shape).astype(np.float32)
    scale = 1.0 / float(np.sqrt(d))
    jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))
    out, lse = jattn._flash_fwd(jq, jk, jv, causal, scale, 64, 64,
                                interpret=True)
    ref = jattn._flash_bwd(jq, jk, jv, out, lse, jg, causal, scale, 64, 64,
                           interpret=True)
    tout = torch.tensor(np.asarray(out.astype(jnp.float32))).to(tdt)
    tlse = torch.tensor(np.asarray(lse)[..., 0])
    tg = torch.from_numpy(g).to(tdt)
    dd = (tg.float() * tout.float()).sum(-1)
    dp, (pq, pk, pv, pg) = tattn.kernel_operands(
        d, *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), tg,
        kind="bwd_dq")
    assert dp == 512
    dq = tattn.flash_attention_bwd_dq_plain(pq, pk, pv, pg, tlse, dd, causal,
                                            scale)
    dk, dv = tattn.flash_attention_bwd_dkv_plain(pq, pk, pv, pg, tlse, dd,
                                                 causal, scale)
    for tag, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert got.dtype == tdt and torch.all(got[..., d:] == 0), tag
        np.testing.assert_allclose(got[..., :d].float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   err_msg=tag, **tol)


# which route (and so which launch count) each kernel takes, by kind,
# kernel head dim and dtype
_ROUTES = {
    (128, False): {"fwd": "le128", "bwd_dq": "le128", "bwd_dkv": "le128"},
    (128, True): {"fwd": "le128", "bwd_dq": "le128", "bwd_dkv": "le128"},
    (256, False): {"fwd": "tf32_split_d", "bwd_dq": "tf32_split_d",
                   "bwd_dkv": "tf32_split_d"},
    (256, True): {"fwd": "wgmma256", "bwd_dq": "wgmma256",
                  "bwd_dkv": "wgmma256"},
    (512, False): {"fwd": "tf32_split_d", "bwd_dq": "tf32_split_d",
                   "bwd_dkv": "tf32_split_d"},
    (512, True): {"fwd": "wgmma_split_d", "bwd_dq": "wgmma_split_d",
                  "bwd_dkv": "wgmma_split_d"},
}
_ROUTES[768, False], _ROUTES[768, True] = _ROUTES[512, False], \
    _ROUTES[512, True]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("dp", [128, 256, 512, 768])
@pytest.mark.parametrize("kind", ["fwd", "bwd_dq", "bwd_dkv"])
def test_route_and_launch_count_by_kernel(kind, dp, dtype):
    """The kernel each (kind, kernel head dim, dtype) runs: up to 128 the
    kernels of flash_attn_fwd.cu / flash_attn_bwd.cu; at 256 the 16-bit
    wgmma forward, dQ and dK/dV; above 256 the 16-bit forward, dQ and
    dK/dV on the split-D wgmma kernels; from 256 up the fp32 forward, dQ
    and dK/dV on the 3xTF32 split-D kernels.  Each route has its own
    launch count on all three wrappers, and the routes (and dtypes) that
    read their operands through TMA are the ones whose refused views are
    copied."""
    want = _ROUTES[dp, dtype != torch.float32][kind]
    assert tattn._route(kind, dp, dtype) == want
    count = tattn.LAUNCH_COUNTS[want]
    assert len(set(tattn.LAUNCH_COUNTS.values())) == \
        len(tattn.LAUNCH_COUNTS) == 4
    for wrapper in (tattn.flash_attention, tattn.flash_attention_bwd_dq_cuda,
                    tattn.flash_attention_bwd_dkv_cuda):
        assert isinstance(getattr(wrapper, count), int)
    assert tuple(tattn._TMA_ROUTES.get(want, ())) == {
        "le128": (torch.bfloat16, torch.float16),
        "wgmma256": (torch.bfloat16, torch.float16),
        "wgmma_split_d": (torch.bfloat16, torch.float16),
        "tf32_split_d": (torch.float32,)}.get(want, ())


def test_d256_views_that_tma_refuses_by_kernel():
    """At D = 256 the 16-bit forward, dQ and dK/dV all read through TMA
    (the wgmma kernels): kernel_operands copies a bf16 or fp16 view that
    TMA refuses, and counts the copy, for every kind.  At D = 512 so do
    the 16-bit split-D wgmma forward, dQ and dK/dV.  In fp32 the 3xTF32
    split-D forward, dQ and dK/dV read through TMA at D = 256 and 512
    alike: copied and counted for every kind."""
    def refused(d, dtype):
        return torch.randn(2 * 3 * 8 * d + 1).to(dtype)[1:] \
            .view(2, 3, 8, d)

    for dtype in (torch.bfloat16, torch.float16):
        for d, kind, copied in ((256, "fwd", True), (256, "bwd_dkv", True),
                                (256, "bwd_dq", True), (512, "fwd", True),
                                (512, "bwd_dq", True),
                                (512, "bwd_dkv", True)):
            view = refused(d, dtype)
            assert not tattn.tma_accepts(view)
            before = tattn.flash_attention.view_copies
            dp, (got, other) = tattn.kernel_operands(d, view, view,
                                                     kind=kind)
            assert dp == d
            assert tattn.flash_attention.view_copies == \
                before + (2 if copied else 0), (d, kind)
            assert (got is not view) == copied, (d, kind)
            assert torch.equal(got, view) and torch.equal(other, view)
            if copied:
                assert tattn.tma_accepts(got) and got.is_contiguous()
    for d in (256, 512):
        f32 = torch.randn(2 * 3 * 8 * d + 1)[1:].view(2, 3, 8, d)
        for kind in ("fwd", "bwd_dq", "bwd_dkv"):
            before = tattn.flash_attention.view_copies
            dp, (a,) = tattn.kernel_operands(d, f32, kind=kind)
            assert dp == d and a is not f32, (d, kind)
            assert torch.equal(a, f32) and tattn.tma_accepts(a)
            assert tattn.flash_attention.view_copies == before + 1


def test_no_d256_route_or_source_is_left():
    """The fp32 dQ and dK/dV at D = 256 run on the 3xTF32 split-D kernels
    of csrc/flash_attn_bwd.cu: no route or launch count is left for the
    SIMT kernels that ran them, and no file of the package names their
    source."""
    import pathlib
    assert "d256" not in tattn.LAUNCH_COUNTS
    assert not any("d256" in c for c in tattn.LAUNCH_COUNTS.values())
    for kind in ("bwd_dq", "bwd_dkv"):
        assert tattn._route(kind, 256, torch.float32) == "tf32_split_d"
    # the deleted source, spelt in two parts so that a search for its
    # name finds no live reference in the repository
    retired = "flash_attn_d" + "256"
    pkg = pathlib.Path(tattn.__file__).resolve().parents[1]
    assert not (pkg / "csrc" / f"{retired}.cu").exists()
    named = [str(f.relative_to(pkg)) for f in pkg.rglob("*")
             if f.is_file() and f.suffix in (".py", ".cu", ".cuh")
             and retired in f.read_text()]
    assert named == []
