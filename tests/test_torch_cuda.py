"""Tests of the port that need the card: the hand-written kernels (flash
forward, flash backward dQ and dK/dV, fused cross-entropy) against their
plain versions (in bf16 and fp16 the forward, dQ and dK/dV are the wgmma
kernels, in fp32 the 3xTF32 kernels: the cases cover D = 32, 64, 128 and
the zero-padded D = 48, 96, ragged S, causal Sq != Sk, the strided
head-split views, fp32 views 4 bytes past a 16-byte boundary and 16-bit
views that TMA refuses, which are copied; head dims 129-256 on the
16-bit wgmma forward, dQ and dK/dV at D = 256, head dims above 256 on
the 16-bit split-D wgmma forward, dQ and dK/dV, and from 256 up the fp32
3xTF32 split-D forward, dQ and dK/dV), the GPU Predictor against the
CPU one, the paged KV pool and the generation engine on the card, a training step on the GPU against the same step on the CPU,
`Executor.run_steps` (CUDA-graph replay of the step) against eager
`run()` steps (sparse SGD and lazy Adam too), the dropout kernel (csrc/dropout_philox.cu) against
its plain version, bit for bit, alone and replayed in a captured step,
the random kernel (csrc/philox_random.cu) against its plain version
(uniform bit for bit, normal within 4 ulps) and under run_steps, its
truncated-normal (within 4 ulps), integer and Bernoulli draws (bit for
bit) and the randperm / multinomial built on them, and the paddle.tensor
ops whose orders a CUDA library leaves open (top_k_v2's ties and NaNs,
argsort's NaNs, unique's first occurrences) against their CPU results,
and the dygraph training path: backward through the flash kernels from a
MultiHeadAttention (fp32 and bf16, D = 64) against the same module on the
CPU, F.cross_entropy through the fused kernel and its gradient against
torch ops, the dropout Function's gradient equal to grad * Mask / (1 - p)
bit for bit, and GradScaler over CUDA gradients; ZeRO-3 run_steps under
NCCL at world 1 against eager runs, bit for bit, the tensor-parallel
ops on CUDA tensors against their CPU results, ring attention composed
from the flash kernels against the plain ring, and the hoisted
gradient-merge window of run_steps against the unhoisted one, bit for
bit; the executor's telemetry gauges (tokens/s, walked-FLOPs MFU, the
walked and the measured peak bytes) after a replayed run_steps call;
the convolution, pooling, norm and interpolation tier (every op type and
its grad op, every new dygraph layer) on the card against the CPU, and
nn.SyncBatchNorm under NCCL at world 1 against BatchNorm2D.

Tolerances against the plain versions: fp32 1e-4 (summation order;
3xTF32 keeps an fp32-level error), bf16 2e-2 and fp16 5e-3 (both sides
round P and dS where the TPU kernels do and round the outputs; a bf16 ulp
is 2^-8 relative, an fp16 ulp 2^-11).
Marked `cuda`; each skips (inside the test) where no CUDA device is
present.  On a GPU machine:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.ops import fused_xent as tfx

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 5e-3}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the Hopper kernels run only on the "
                    "card")


@pytest.mark.parametrize("b,h,sq,sk,d,dtype,causal", [
    (2, 4, 128, 128, 64, torch.float32, False),
    (2, 4, 96, 160, 32, torch.float32, True),
    (2, 4, 160, 96, 128, torch.bfloat16, True),
    (1, 2, 200, 200, 64, torch.bfloat16, False),
    (1, 2, 200, 200, 32, torch.bfloat16, False),
    (1, 2, 200, 200, 128, torch.bfloat16, False),
    (1, 2, 384, 512, 64, torch.bfloat16, True),
    (2, 4, 128, 128, 64, torch.float16, False),
    (1, 2, 160, 96, 128, torch.float16, True),
    (1, 2, 200, 200, 32, torch.float16, False),
    (2, 4, 128, 128, 48, torch.float32, False),
    (1, 2, 200, 200, 96, torch.bfloat16, True),
    (1, 2, 200, 200, 96, torch.float16, False),
])
def test_kernel_matches_plain_version(b, h, sq, sk, d, dtype, causal):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=g).to(dtype)
               for s in (sq, sk, sk))
    before = tattn.flash_attention.launches
    out, lse = tattn.flash_attention(q, k, v, causal=causal,
                                     return_lse=True)
    torch.cuda.synchronize()
    assert tattn.flash_attention.launches == before + 1
    ref, ref_lse = tattn.flash_attention_plain(q, k, v, causal=causal)
    tol = TOL[dtype]
    assert out.shape == (b, h, sq, d) and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], ref_lse[fin], rtol=tol, atol=tol)


def test_gpu_predictor_matches_cpu_predictor(tmp_path):
    _need_cuda()
    from paddle_tpu_torch import static
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.io import save_inference_model
    from paddle_tpu_torch.models import build_bert_base
    torch.backends.cuda.matmul.allow_tf32 = False
    prev = tattn._FLASH_STATE["mode"]
    tattn.enable_flash_attention(True)
    try:
        main, startup, out = build_bert_base(vocab=64, seq=64, hidden=128,
                                             layers_n=2, heads=2,
                                             use_amp=False)
    finally:
        tattn._FLASH_STATE["mode"] = prev
    exe = static.Executor(static.CPUPlace())
    with static.scope_guard(static.Scope()):
        exe.run(startup)
        save_inference_model(str(tmp_path), ["ids", "pos"], [out], exe,
                             main)
    rng = np.random.RandomState(0)
    feeds = [rng.randint(0, 64, (3, 64)).astype(np.int64),
             np.tile(np.arange(64, dtype=np.int64), (3, 1))]
    cpu_cfg = Config(str(tmp_path))
    cpu_cfg.disable_gpu()
    (want,) = create_predictor(cpu_cfg).run(feeds)
    before = tattn.flash_attention.launches
    (got,) = create_predictor(Config(str(tmp_path))).run(feeds)
    assert tattn.flash_attention.launches == before + 2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,h,sq,sk,d,dtype,causal", [
    (2, 4, 128, 128, 64, torch.float32, False),
    (2, 4, 96, 160, 32, torch.float32, True),
    (2, 4, 160, 96, 128, torch.bfloat16, True),
    (1, 2, 200, 200, 64, torch.bfloat16, False),
    (1, 2, 200, 200, 32, torch.bfloat16, False),
    (1, 2, 200, 200, 128, torch.bfloat16, False),
    (1, 2, 384, 512, 64, torch.bfloat16, True),
    (2, 4, 128, 128, 64, torch.float16, False),
    (1, 2, 160, 96, 128, torch.float16, True),
    (1, 2, 200, 200, 32, torch.float16, False),
    (2, 4, 128, 128, 48, torch.float32, False),
    (1, 2, 200, 200, 96, torch.bfloat16, True),
    (1, 2, 200, 200, 96, torch.float16, False),
])
def test_backward_kernels_match_plain_version(b, h, sq, sk, d, dtype,
                                              causal):
    """Through the autograd Function (torch.func.vjp, as the grad ops run
    it): one launch each of dQ and dK/dV, results as the plain versions.
    Tolerance TOL (1e-4 fp32, summation order; 2e-2 bf16 and 5e-3 fp16:
    both round the outputs to the input dtype, the plain version computes
    in fp32).  D = 48 and 96 run zero-padded to 64 and 128."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(b, h, s, d, device="cuda",
                               generator=g).to(dtype)
                   for s in (sq, sk, sk, sq))
    before = (tattn.flash_attention_bwd_dq_cuda.launches,
              tattn.flash_attention_bwd_dkv_cuda.launches)
    with torch.no_grad():
        _, vjp = torch.func.vjp(lambda a, b_, c: tattn.flash_attention(
            a, b_, c, causal=causal), q, k, v)
        grads = vjp(do)
    torch.cuda.synchronize()
    assert (tattn.flash_attention_bwd_dq_cuda.launches,
            tattn.flash_attention_bwd_dkv_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    out, lse = tattn.flash_attention_plain(q, k, v, causal=causal)
    dd = (do.float() * out.float()).sum(-1)
    ref = tattn.flash_attention_bwd_plain(q, k, v, do, lse, dd, causal)
    tol = TOL[dtype]
    for got, want in zip(grads, ref):
        assert got.shape == want.shape and got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def _bhsd(g, b, h, s, d, dtype, strided):
    if strided:  # [B, S, H*D] -> [B, H, S, D], the view transpose2 makes
        x = torch.randn(b, s, h * d, device="cuda", generator=g)
        return x.to(dtype).reshape(b, s, h, d).permute(0, 2, 1, 3)
    return torch.randn(b, h, s, d, device="cuda", generator=g).to(dtype)


# b, h, sq, sk, d, causal, strided
_CASES = [
    (2, 4, 128, 128, 32, False, False),
    (2, 4, 256, 256, 64, False, True),
    (2, 4, 128, 128, 128, False, False),
    (1, 2, 96, 160, 64, True, False),
    (1, 2, 160, 96, 64, True, False),
    (1, 2, 200, 200, 64, False, False),
    (1, 2, 200, 200, 128, True, False),
    (1, 2, 200, 200, 32, False, True),
]


def _dq_args(b, h, sq, sk, d, causal, strided, seed=3):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (_bhsd(g, b, h, s, d, torch.bfloat16, strided)
                   for s in (sq, sk, sk, sq))
    out, lse = tattn.flash_attention_plain(q, k, v, causal=causal)
    dd = (do.float() * out.float()).sum(-1)
    return q, k, v, do, lse, dd, causal


@pytest.mark.parametrize("b,h,sq,sk,d,causal,strided", _CASES)
def test_wgmma_dq_matches_plain_version(b, h, sq, sk, d, causal, strided):
    """The bf16 dQ kernel (wgmma) against flash_attention_bwd_dq_plain,
    which rounds dS to bf16 where the kernel does: tolerance 2e-2 (the
    plain version is computed in fp32, both round dq to bf16).  With
    causal Sq > Sk the first Sq - Sk rows see no key: their dq is 0."""
    _need_cuda()
    args = _dq_args(b, h, sq, sk, d, causal, strided)
    before = tattn.flash_attention_bwd_dq_cuda.launches
    dq = tattn.flash_attention_bwd_dq_cuda(*args)
    torch.cuda.synchronize()
    assert tattn.flash_attention_bwd_dq_cuda.launches == before + 1
    assert dq.dtype == torch.bfloat16 and dq.shape == (b, h, sq, d)
    ref = tattn.flash_attention_bwd_dq_plain(*args)
    torch.testing.assert_close(dq.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)
    if causal and sq > sk:
        assert torch.all(dq[:, :, :sq - sk] == 0)


def test_wgmma_dq_is_deterministic():
    """No atomics: two launches on the same inputs give the same bits."""
    _need_cuda()
    args = _dq_args(2, 4, 384, 384, 64, True, True, seed=4)
    first = tattn.flash_attention_bwd_dq_cuda(*args)
    second = tattn.flash_attention_bwd_dq_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


def test_wgmma_dq_d256_is_deterministic():
    """The wgmma dQ at D = 256 (K/V tiles of 32 keys) has no atomics
    either: two launches on the same inputs give the same bits, both on
    the wgmma256 route."""
    _need_cuda()
    args = _dq_args(2, 4, 384, 384, 256, True, True, seed=4)
    before = tattn.flash_attention_bwd_dq_cuda.launches_wgmma256
    first = tattn.flash_attention_bwd_dq_cuda(*args)
    second = tattn.flash_attention_bwd_dq_cuda(*args)
    torch.cuda.synchronize()
    assert tattn.flash_attention_bwd_dq_cuda.launches_wgmma256 == before + 2
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


def _shifted(t, elems=2):
    """t's values in a view `elems` elements past a 16-byte boundary (a
    base address TMA refuses)."""
    flat = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    view = flat[elems:].view(t.shape)
    view.copy_(t)
    return view


def test_dq_wrapper_refuses_views_tma_refuses():
    """A bf16 view that TMA refuses (here 4 bytes past a 16-byte boundary)
    is copied to a contiguous tensor before each launch, counted in
    flash_attention.view_copies: the forward, dQ and dK/dV launch and give
    the bits of the aligned tensors."""
    _need_cuda()
    q, k, v, do, lse, dd, _ = _dq_args(1, 2, 64, 64, 64, False, False)
    sq, sdo = _shifted(q), _shifted(do)
    assert sq.data_ptr() % 16 == 4 and not tattn.tma_accepts(sq)
    copies = tattn.flash_attention.view_copies
    out, lse2 = tattn.flash_attention_cuda(sq, k, v)
    dq = tattn.flash_attention_bwd_dq_cuda(sq, k, v, sdo, lse, dd)
    dk, dv = tattn.flash_attention_bwd_dkv_cuda(q, k, v, sdo, lse, dd)
    torch.cuda.synchronize()
    assert tattn.flash_attention.view_copies == copies + 4
    want_out, want_lse = tattn.flash_attention_cuda(q, k, v)
    want_dq = tattn.flash_attention_bwd_dq_cuda(q, k, v, do, lse, dd)
    want_dk, want_dv = tattn.flash_attention_bwd_dkv_cuda(q, k, v, do, lse,
                                                          dd)
    for got, want in ((out, want_out), (lse2, want_lse), (dq, want_dq),
                      (dk, want_dk), (dv, want_dv)):
        assert torch.equal(got, want)
    # the head-split views of the training program take no copy
    hs = _bhsd(torch.Generator(device="cuda").manual_seed(9), 2, 4, 64, 64,
               torch.bfloat16, True)
    tattn.flash_attention_cuda(hs, hs, hs)
    assert tattn.flash_attention.view_copies == copies + 4


@pytest.mark.parametrize("b,h,sq,sk,d,causal,strided", _CASES + [
    (1, 2, 130, 70, 64, False, "offset")])
def test_fp32_forward_matches_plain_version(b, h, sq, sk, d, causal,
                                            strided):
    """The fp32 forward (3xTF32 on the tensor cores) against
    flash_attention_plain at 1e-4 (the serving path's kernel gate): out,
    lse, the rows whose lse is -inf, and 0 on fully-masked rows.  The
    "offset" case starts k and v 4 bytes past a 16-byte boundary, so the
    kernel takes its 4-byte copies."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(5)
    if strided == "offset":
        q = _bhsd(g, b, h, sq, d, torch.float32, False)
        k, v = (torch.randn(b * h * sk * d + 1, device="cuda",
                            generator=g)[1:].view(b, h, sk, d)
                for _ in range(2))
        assert k.data_ptr() % 16 == 4
    else:
        q, k, v = (_bhsd(g, b, h, s, d, torch.float32, strided)
                   for s in (sq, sk, sk))
    before = tattn.flash_attention.launches
    out, lse = tattn.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tattn.flash_attention.launches == before + 1
    ref, ref_lse = tattn.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], ref_lse[fin], rtol=1e-4, atol=1e-4)
    if causal and sq > sk:
        assert torch.all(out[:, :, :sq - sk] == 0)


def _fp32_bwd_args(b, h, sq, sk, d, causal, strided, seed=6):
    """fp32 q, k, v, dO (the "offset" views start 4 bytes past a 16-byte
    boundary, so the kernels take their 4-byte copies), lse and D from the
    plain forward."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if strided == "offset":
        q, k, v, do = (torch.randn(b * h * s * d + 1, device="cuda",
                                   generator=g)[1:].view(b, h, s, d)
                       for s in (sq, sk, sk, sq))
        assert all(t.data_ptr() % 16 == 4 for t in (q, k, v, do))
    else:
        q, k, v, do = (_bhsd(g, b, h, s, d, torch.float32, strided)
                       for s in (sq, sk, sk, sq))
    out, lse = tattn.flash_attention_plain(q, k, v, causal=causal)
    dd = (do * out).sum(-1)
    return q, k, v, do, lse, dd, causal


@pytest.mark.parametrize("b,h,sq,sk,d,causal,strided", _CASES + [
    (1, 2, 130, 70, 64, True, "offset"),
    (1, 2, 70, 130, 128, False, "offset")])
def test_fp32_backward_kernels_match_plain_version(b, h, sq, sk, d, causal,
                                                   strided):
    """The fp32 dQ and dK/dV kernels (3xTF32 on the tensor cores) against
    flash_attention_bwd_dq_plain / _dkv_plain at 1e-4 (the kernel gate of
    chip_smoke.py: summation order, and 3xTF32 keeps an fp32-level
    error).  With causal Sq > Sk the first Sq - Sk rows see no key: their
    dq is exactly 0."""
    _need_cuda()
    args = _fp32_bwd_args(b, h, sq, sk, d, causal, strided)
    before = (tattn.flash_attention_bwd_dq_cuda.launches,
              tattn.flash_attention_bwd_dkv_cuda.launches)
    dq = tattn.flash_attention_bwd_dq_cuda(*args)
    dk, dv = tattn.flash_attention_bwd_dkv_cuda(*args)
    torch.cuda.synchronize()
    assert (tattn.flash_attention_bwd_dq_cuda.launches,
            tattn.flash_attention_bwd_dkv_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    ref_dq = tattn.flash_attention_bwd_dq_plain(*args)
    ref_dk, ref_dv = tattn.flash_attention_bwd_dkv_plain(*args)
    for tag, got, want in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                           ("dv", dv, ref_dv)):
        assert got.dtype == torch.float32 and got.shape == want.shape, tag
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"{tag}: {m}")
    if causal and sq > sk:
        assert torch.all(dq[:, :, :sq - sk] == 0)


def test_fp32_backward_kernels_are_deterministic():
    """No atomics: two launches of each fp32 kernel give the same bits."""
    _need_cuda()
    args = _fp32_bwd_args(2, 4, 384, 384, 64, True, True, seed=7)
    first = (tattn.flash_attention_bwd_dq_cuda(*args),
             *tattn.flash_attention_bwd_dkv_cuda(*args))
    second = (tattn.flash_attention_bwd_dq_cuda(*args),
              *tattn.flash_attention_bwd_dkv_cuda(*args))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_fp32_split_d_kernels_are_deterministic():
    """No atomics in the 3xTF32 split-D kernels either: two launches of the
    forward, the dQ and the dK/dV at D = 512 (causal, head-split views)
    give the same bits, and every chunk's CTA agrees on lse."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, do = (_bhsd(g, 2, 2, s, 512, torch.float32, True)
                   for s in (384, 320, 320, 384))
    runs = []
    for _ in range(2):
        out, lse = tattn.flash_attention_cuda(q, k, v, causal=True)
        dd = (do * out).sum(-1)
        args = (q, k, v, do, lse, dd, True)
        runs.append((out, lse, tattn.flash_attention_bwd_dq_cuda(*args),
                     *tattn.flash_attention_bwd_dkv_cuda(*args)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_16bit_split_d_dkv_is_deterministic(dtype):
    """No atomics in the wgmma split-D dK/dV: two launches at D = 768
    (three chunks, causal, head-split views) give the same bits."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(12)
    q, k, v, do = (_bhsd(g, 2, 2, s, 768, dtype, True)
                   for s in (384, 320, 320, 384))
    out, lse = tattn.flash_attention_cuda(q, k, v, causal=True)
    dd = (do.float() * out.float()).sum(-1)
    before = tattn.flash_attention_bwd_dkv_cuda.launches_wgmma_split_d
    runs = [tattn.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, dd,
                                               causal=True)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert tattn.flash_attention_bwd_dkv_cuda.launches_wgmma_split_d == \
        before + 2
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_16bit_split_d_dq_is_deterministic(dtype):
    """No atomics in the wgmma split-D dQ: two launches at D = 512 (one
    512-column chunk) and D = 768 (two 384-column chunks), causal, on
    head-split views, give the same bits, each counted on
    `launches_wgmma_split_d`."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(14)
    for d in (512, 768):
        q, k, v, do = (_bhsd(g, 2, 2, s, d, dtype, True)
                       for s in (384, 320, 320, 384))
        out, lse = tattn.flash_attention_cuda(q, k, v, causal=True)
        dd = (do.float() * out.float()).sum(-1)
        before = tattn.flash_attention_bwd_dq_cuda.launches_wgmma_split_d
        first, second = (tattn.flash_attention_bwd_dq_cuda(
            q, k, v, do, lse, dd, causal=True) for _ in range(2))
        torch.cuda.synchronize()
        assert tattn.flash_attention_bwd_dq_cuda.launches_wgmma_split_d == \
            before + 2
        assert torch.equal(first.view(torch.int16), second.view(torch.int16))


def test_fp32_bwd_entries_take_d256_refuse_d384():
    """The fp32 dQ and dK/dV C entries of csrc/flash_attn_bwd.cu run the
    3xTF32 split-D kernels at D = 256 (one chunk) and return
    cudaErrorInvalidValue (1) for fp32 D = 384, which is not a multiple of
    256 (the wrapper pads it to 512), launching nothing."""
    _need_cuda()
    lib = tattn._bwd_kernel_lib()
    g = torch.Generator(device="cuda").manual_seed(13)
    stream = torch.cuda.current_stream().cuda_stream
    for d, want in ((256, 0), (384, 1)):
        q, k, v, do = (_bhsd(g, 1, 2, 64, d, torch.float32, False)
                       for _ in range(4))
        out, lse = tattn.flash_attention_plain(q, k, v)
        dd = (do * out).sum(-1)
        dq, dk, dv = (torch.full_like(q, 7.0) for _ in range(3))
        strides = [t.stride(i) for t in (q, k, v, do) for i in range(3)]
        tail = (tattn._DTYPE_CODE[torch.float32], 1, 2, 64, 64, d, *strides,
                0, 1.0 / d ** 0.5, stream)
        ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
               lse.data_ptr(), dd.data_ptr())
        assert lib.flash_attn_bwd_dq(*ins, dq.data_ptr(), *tail) == want
        assert lib.flash_attn_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(),
                                      *tail) == want
        torch.cuda.synchronize()
        if want:
            assert all(torch.all(t == 7.0) for t in (dq, dk, dv)), d
            continue
        args = (q, k, v, do, lse, dd, False)
        ref_dk, ref_dv = tattn.flash_attention_bwd_dkv_plain(*args)
        for got, ref in ((dq, tattn.flash_attention_bwd_dq_plain(*args)),
                         (dk, ref_dk), (dv, ref_dv)):
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_fp32_split_d_bwd_d256_is_deterministic():
    """No atomics in the 3xTF32 split-D dQ and dK/dV at D = 256 (one chunk
    each): two launches, causal, on head-split views, give the same bits,
    each counted on `launches_tf32_split_d`."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(15)
    q, k, v, do = (_bhsd(g, 2, 2, s, 256, torch.float32, True)
                   for s in (384, 320, 320, 384))
    out, lse = tattn.flash_attention_cuda(q, k, v, causal=True)
    dd = (do * out).sum(-1)
    args = (q, k, v, do, lse, dd, True)
    wrappers = (tattn.flash_attention_bwd_dq_cuda,
                tattn.flash_attention_bwd_dkv_cuda)
    before = [f.launches_tf32_split_d for f in wrappers]
    first = (tattn.flash_attention_bwd_dq_cuda(*args),
             *tattn.flash_attention_bwd_dkv_cuda(*args))
    second = (tattn.flash_attention_bwd_dq_cuda(*args),
              *tattn.flash_attention_bwd_dkv_cuda(*args))
    torch.cuda.synchronize()
    assert [f.launches_tf32_split_d for f in wrappers] == \
        [n + 2 for n in before]
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("t,v,dtype,ignore", [
    (64, 30522, torch.float32, -100),
    (64, 30522, torch.bfloat16, 7),
    (33, 1000, torch.float32, -1),
    (64, 30522, torch.float16, -100),
    (33, 1000, torch.float16, 3),
])
def test_fused_xent_kernel_matches_plain_version(t, v, dtype, ignore):
    """Loss and lse as fused_xent_plain (tolerance 1e-4: summation order),
    ignored rows 0, and the torch backward through the Function."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(2)
    logits = (2 * torch.randn(t, v, device="cuda", generator=g)).to(dtype)
    label = torch.randint(0, v, (t,), device="cuda", generator=g)
    label[::5] = ignore
    before = tfx.fused_xent_cuda.launches
    loss, lse = tfx.fused_xent_cuda(logits, label, ignore)
    torch.cuda.synchronize()
    assert tfx.fused_xent_cuda.launches == before + 1
    ref_loss, ref_lse = tfx.fused_xent_plain(logits, label, ignore)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)
    assert torch.all(loss[::5] == 0)
    _, vjp = torch.func.vjp(
        lambda x: tfx.fused_softmax_xent(x, label, ignore), logits)
    (grad,) = vjp(torch.ones(t, device="cuda"))
    want = tfx.fused_xent_bwd(logits, label, ref_lse, torch.ones(t,
                                                                device="cuda"),
                              ignore)
    torch.testing.assert_close(grad.float(), want.float(), rtol=1e-4,
                               atol=1e-4)


def test_gpu_training_step_matches_cpu(tmp_path):
    """Two Adam steps of the small pretraining program (flash and fused CE
    on, fp32) on the GPU and on the CPU from the same weights: losses
    within 1e-4 relative (the kernels and cuBLAS sum in other orders)."""
    _need_cuda()
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.io import load_params_from_numpy
    from paddle_tpu_torch.models import build_bert_pretrain
    torch.backends.cuda.matmul.allow_tf32 = False
    prev = tattn._FLASH_STATE["mode"]
    tattn.enable_flash_attention(True)
    try:
        _reset_unique_names()
        main, startup, loss = build_bert_pretrain(
            vocab=128, seq=64, hidden=128, layers_n=2, heads=2,
            use_amp=False)
    finally:
        tattn._FLASH_STATE["mode"] = prev
    scope = static.Scope()
    with static.scope_guard(scope):
        static.Executor(static.CPUPlace()).run(startup)
    init = {n: t.numpy().copy() for n, t in scope.vars.items()}
    rng = np.random.RandomState(0)
    feed = {"ids": rng.randint(0, 128, (2, 64)),
            "pos": np.tile(np.arange(64), (2, 1)),
            "labels": rng.randint(0, 128, (2, 64, 1))}
    losses = {}
    tfx.enable_fused_xent(True)
    try:
        for place in (static.CPUPlace(), static.CUDAPlace(0)):
            run_scope = static.Scope()
            load_params_from_numpy(run_scope, init, place)
            exe = static.Executor(place)
            with static.scope_guard(run_scope):
                losses[str(place)] = [
                    float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                    for _ in range(2)]
    finally:
        tfx.enable_fused_xent(False)
    cpu, gpu = losses.values()
    np.testing.assert_allclose(gpu, cpu, rtol=1e-4)


# ---------------------------------------------------------------------------
# Executor.run_steps: the training step captured as a CUDA graph
# ---------------------------------------------------------------------------
def _small_pretrain(use_amp):
    """The bench's pretraining program at a small width (flash on), its
    startup weights as numpy arrays and a fixed batch of K steps."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.models import build_bert_pretrain
    torch.backends.cuda.matmul.allow_tf32 = False
    prev = tattn._FLASH_STATE["mode"]
    tattn.enable_flash_attention(True)
    try:
        _reset_unique_names()
        main, startup, loss = build_bert_pretrain(
            vocab=128, seq=64, hidden=128, layers_n=2, heads=2,
            use_amp=use_amp)
    finally:
        tattn._FLASH_STATE["mode"] = prev
    scope = static.Scope()
    with static.scope_guard(scope):
        static.Executor(static.CPUPlace()).run(startup)
    init = {n: t.numpy().copy() for n, t in scope.vars.items()}
    return main, loss, init


def _stacked_feed(k, seed=0):
    rng = np.random.RandomState(seed)
    return {"ids": rng.randint(0, 128, (k, 2, 64)),
            "pos": np.tile(np.arange(64), (k, 2, 1)),
            "labels": rng.randint(0, 128, (k, 2, 64, 1))}


def _gpu_scope(init):
    from paddle_tpu_torch import static
    from paddle_tpu_torch.io import load_params_from_numpy
    scope = static.Scope()
    load_params_from_numpy(scope, init, static.CUDAPlace(0))
    return scope


def _eager_losses(main, loss, init, feed, steps):
    """`steps` Executor.run steps on the GPU; (losses, final scope)."""
    from paddle_tpu_torch import static
    exe, scope = static.Executor(), _gpu_scope(init)
    with static.scope_guard(scope):
        losses = [float(exe.run(main, feed={n: v[i] for n, v in feed.items()},
                                fetch_list=[loss])[0]) for i in steps]
    return np.asarray(losses, np.float32), scope


@pytest.mark.parametrize("use_amp", [False, True])
def test_run_steps_graph_replay_matches_eager_run(use_amp):
    """K = 3 steps replayed from one captured graph against 3 eager run()
    steps from the same weights: the same kernels on the same inputs, so
    the losses and every persistable after the last step are equal to
    the last bit."""
    _need_cuda()
    from paddle_tpu_torch import static
    main, loss, init = _small_pretrain(use_amp)
    feed = _stacked_feed(3)
    tfx.enable_fused_xent(True)
    try:
        want, eager_scope = _eager_losses(main, loss, init, feed, range(3))
        exe, scope = static.Executor(), _gpu_scope(init)
        with static.scope_guard(scope):
            (got,) = exe.run_steps(main, feed=feed, fetch_list=[loss])
    finally:
        tfx.enable_fused_xent(False)
    assert got.shape == (3,) and np.all(np.isfinite(got))
    np.testing.assert_array_equal(got.reshape(3), want)
    assert exe.cache_stats() == {"hits": 0, "misses": 1, "traces": 1}
    for n, t in eager_scope.vars.items():
        assert torch.equal(scope.vars[n], t), n
    exe.close()


def test_step_telemetry_gauges_on_the_card():
    """The executor's per-step gauges after a replayed run_steps call
    (K = 3): tokens/s from the feed, the MFU from the walked FLOPs over
    the step's own seconds and the card's data-sheet peak, the walked
    peak bytes, and the allocator's peak read after the captured window
    (the capture happens once: telemetry adds no capture).
    memory_report measures one step without moving the caller's state."""
    _need_cuda()
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core.monitor import gauge_get, hist_snapshot
    from paddle_tpu_torch.static.flops_analysis import peak_flops_per_chip
    main, loss, init = _small_pretrain(True)
    feed = _stacked_feed(3)
    tfx.enable_fused_xent(True)
    try:
        exe, scope = static.Executor(), _gpu_scope(init)
        with static.scope_guard(scope):
            exe.run_steps(main, feed=feed, fetch_list=[loss])
            tps = gauge_get("train.tokens_per_sec")
            mfu = gauge_get("train.mfu")
            step_ms = hist_snapshot("train.step_ms")
            before = {n: t.clone() for n, t in scope.vars.items()}
            rep = exe.memory_report(main, feed={n: v[0]
                                                for n, v in feed.items()})
    finally:
        tfx.enable_fused_xent(False)
    assert exe.cache_stats()["traces"] == 1
    tokens = 3 * 2 * 64
    flops = static.analyze_flops(main, batch=2)["total_flops"]
    dt = tokens / tps
    assert mfu == pytest.approx(flops * 3 / dt / peak_flops_per_chip(),
                                rel=1e-9)
    assert step_ms["count"] >= 1
    assert gauge_get("hbm.predicted_peak_bytes") == \
        static.estimate_peak_bytes(main, batch=2)
    assert gauge_get("hbm.device_peak_bytes") > 0
    assert rep["device"]["max_memory_allocated"] > 0
    for n, t in before.items():
        assert torch.equal(scope.vars[n], t), n
    exe.close()


def test_run_steps_captures_once_then_replays():
    """A second call of the same shape and a short final chunk (K' < K)
    replay the captured graph: one capture, then hits; the losses follow
    the eager walk over all the steps; close() frees the graph's pool."""
    _need_cuda()
    from paddle_tpu_torch import static
    main, loss, init = _small_pretrain(False)
    feed = _stacked_feed(5, seed=1)
    tfx.enable_fused_xent(True)
    try:
        want, _ = _eager_losses(main, loss, init, feed, range(5))
        exe, scope = static.Executor(), _gpu_scope(init)
        got = []
        with static.scope_guard(scope):
            for lo, hi in ((0, 2), (2, 4), (4, 5)):
                (lv,) = exe.run_steps(
                    main, feed={n: v[lo:hi] for n, v in feed.items()},
                    fetch_list=[loss])
                got.extend(lv.reshape(-1))
    finally:
        tfx.enable_fused_xent(False)
    assert exe.cache_stats() == {"hits": 2, "misses": 1, "traces": 1}
    np.testing.assert_array_equal(np.asarray(got, np.float32), want)
    # the graph's private memory pool outlives empty_cache() until close()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    exe.close()
    assert torch.cuda.memory_reserved() < held


def test_run_steps_interleaved_with_run_trains_current_weights():
    """run() between two run_steps calls rebinds the scope's persistables
    to new tensors; the next replay copies them into the captured buffers
    and trains from them, so the five losses are the eager walk's."""
    _need_cuda()
    from paddle_tpu_torch import static
    main, loss, init = _small_pretrain(False)
    feed = _stacked_feed(5, seed=2)
    tfx.enable_fused_xent(True)
    try:
        want, eager_scope = _eager_losses(main, loss, init, feed, range(5))
        exe, scope = static.Executor(), _gpu_scope(init)
        with static.scope_guard(scope):
            (a,) = exe.run_steps(main, feed={n: v[:2] for n, v in
                                             feed.items()},
                                 fetch_list=[loss])
            (b,) = exe.run(main, feed={n: v[2] for n, v in feed.items()},
                           fetch_list=[loss])
            (c,) = exe.run_steps(main, feed={n: v[3:] for n, v in
                                             feed.items()},
                                 fetch_list=[loss])
    finally:
        tfx.enable_fused_xent(False)
    got = np.concatenate([a.reshape(-1), np.reshape(b, -1), c.reshape(-1)])
    np.testing.assert_array_equal(got.astype(np.float32), want)
    for n, t in eager_scope.vars.items():
        assert torch.equal(scope.vars[n], t), n
    exe.close()


def test_run_steps_refuses_random_ops():
    """A program that draws random numbers is no longer refused on CUDA:
    the startup program's uniform_random runs under run_steps through the
    Philox kernel (its seed read from the step seed buffer), each replay
    draws anew, and the draws equal eager run() calls for the same step
    seeds bit for bit."""
    _need_cuda()
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import random as trandom
    from paddle_tpu_torch.static import layers
    main, startup = static.Program(), static.Program()
    startup.random_seed = 7
    with static.program_guard(main, startup):
        x = layers.data("x", [-1, 4])
        layers.fc(x, 2)
    w = next(p.name for p in main.all_parameters() if p.shape == (4, 2))
    feed = {"x": np.zeros((3, 2, 4), np.float32)}
    exe, eager = static.Executor(), []
    with static.scope_guard(static.Scope()):
        for i in range(3):
            exe.run(startup, feed={"x": feed["x"][i]})
            eager.append(static.global_scope().vars[w].clone())
    exe2 = static.Executor()
    before = trandom.random_cuda.launches
    with static.scope_guard(static.Scope()):
        (got,) = exe2.run_steps(startup, feed=feed, fetch_list=[w])
    assert trandom.random_cuda.launches > before
    assert exe2.cache_stats()["traces"] == 1
    np.testing.assert_array_equal(got, torch.stack(eager).cpu().numpy())
    assert not np.array_equal(got[0], got[1])
    exe2.close()


def _sparse_embedding_program(make_opt):
    """A 64-row `is_sparse` embedding under a mean-pooled fc, trained by
    `make_opt(static)`; (main, startup, loss)."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.static import layers
    _reset_unique_names()
    main, startup = static.Program(), static.Program()
    startup.random_seed = 5
    with static.program_guard(main, startup):
        ids = layers.data("ids", [-1, 16], dtype="int64")
        y = layers.data("y", [-1, 1])
        emb = layers.embedding(ids, size=[64, 32], is_sparse=True)
        pred = layers.fc(layers.scale(layers.reduce_sum(emb, dim=1),
                                      1.0 / 16), size=1)
        loss = layers.mean(layers.square(layers.elementwise_sub(pred, y)))
        make_opt(static).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("opt", ["sgd", "lazy_adam"])
def test_run_steps_sparse_update_matches_run(opt):
    """Sparse SGD and Adam(lazy_mode=True) under run_steps (the capturing
    call, K = 4, ids with duplicates) against 4 eager run() steps from the
    same weights: the losses and every persistable bit for bit.  The
    capture's warm-up step changes no state, so the embedding trains 4
    times, not 5."""
    _need_cuda()
    from paddle_tpu_torch import static
    make = {"sgd": lambda s: s.SGD(0.5),
            "lazy_adam": lambda s: s.Adam(0.05, lazy_mode=True)}[opt]
    main, startup, loss = _sparse_embedding_program(make)
    with static.scope_guard(static.Scope()):
        static.Executor().run(startup)
        init = {n: t for n, t in static.global_scope().vars.items()
                if t is not None}
    rng = np.random.RandomState(3)
    k = 4
    feed = {"ids": rng.randint(0, 64, (k, 8, 16)).astype(np.int64),
            "y": rng.rand(k, 8, 1).astype(np.float32)}

    def scope_of_init():
        scope = static.Scope()
        for n, t in init.items():
            scope.set(n, t.clone())
        return scope
    exe, eager_scope = static.Executor(), scope_of_init()
    with static.scope_guard(eager_scope):
        want = [float(exe.run(main, feed={n: v[i] for n, v in feed.items()},
                              fetch_list=[loss])[0]) for i in range(k)]
    exe2, scope = static.Executor(), scope_of_init()
    with static.scope_guard(scope):
        (got,) = exe2.run_steps(main, feed=feed, fetch_list=[loss])
    assert exe2.cache_stats()["traces"] == 1
    np.testing.assert_array_equal(np.asarray(got, np.float32).reshape(-1),
                                  np.asarray(want, np.float32))
    for n, t in eager_scope.vars.items():
        if t is not None:
            assert torch.equal(scope.vars[n], t), n
    exe2.close()


@pytest.mark.parametrize("n", [30522 * 768, 1000003, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_philox_random_kernel_matches_plain_version(n, dtype):
    """The uniform equal to the plain version bit for bit; the normal
    within 4 ulps of the output dtype (the card's logf / sincosf against
    the CPU's log / cos / sin), from a device seed and a host seed."""
    _need_cuda()
    from paddle_tpu_torch.ops import random as trandom
    seed_t = torch.tensor([987654321], dtype=torch.int64, device="cuda")
    for seed in (seed_t, 12345):
        for dist, a, b in ((trandom.UNIFORM, -0.25, 0.75),
                           (trandom.NORMAL, 0.0, 0.02)):
            before = trandom.random_cuda.launches
            got = trandom.random_draw((n,), dtype, dist, a, b, seed, 17,
                                      "cuda")
            assert trandom.random_cuda.launches == before + 1
            want = trandom.random_plain((n,), dtype, dist, a, b,
                                        seed.cpu() if torch.is_tensor(seed)
                                        else seed, 17)
            got = got.cpu()
            if dist == trandom.UNIFORM:
                assert torch.equal(got, want)
            else:
                ulp = torch.finfo(dtype).eps * torch.maximum(
                    want.float().abs(), torch.tensor(b))
                assert ((got.float() - want.float()).abs()
                        <= 4 * ulp).all()


def test_philox_random_wrong_seed_and_no_fallback():
    _need_cuda()
    from paddle_tpu_torch.ops import random as trandom
    with pytest.raises(ValueError, match="one-element int64 seed"):
        trandom.random_cuda((8,), torch.float32, trandom.UNIFORM, 0.0, 1.0,
                            torch.tensor([1], dtype=torch.int32,
                                         device="cuda"), 0, "cuda")
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        trandom.random_cuda((8,), torch.float64, trandom.UNIFORM, 0.0, 1.0,
                            1, 0, "cuda")


def test_run_steps_failing_capture_raises(monkeypatch):
    """An op that reads a device value back to the host cannot be
    captured: run_steps raises with the CUDA error and runs nothing
    eagerly in its place."""
    _need_cuda()
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import registry
    main, loss, init = _small_pretrain(False)
    info = registry.get_op_info("mean")
    kernel = info.kernel

    def syncing_mean(ins, attrs, ctx):
        float(ins["X"].sum())  # a host read: refused inside a capture
        return kernel(ins, attrs, ctx)

    monkeypatch.setattr(info, "kernel", syncing_mean)
    exe, scope = static.Executor(), _gpu_scope(init)
    before = {n: t.clone() for n, t in scope.vars.items()}
    with static.scope_guard(scope):
        with pytest.raises(RuntimeError, match="capture of the step failed"):
            exe.run_steps(main, feed=_stacked_feed(2), fetch_list=[loss])
    monkeypatch.setattr(info, "kernel", kernel)
    torch.cuda.synchronize()
    for n, t in before.items():
        assert torch.equal(scope.vars[n], t), n


# ---------------------------------------------------------------------------
# the dropout kernel: Philox bits from a seed in device memory
# ---------------------------------------------------------------------------
def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("shape,dtype,p,upscale,host_seed", [
    ((8, 12, 128, 128), torch.bfloat16, 0.1, True, False),
    ((4, 128, 768), torch.float32, 0.1, True, False),
    ((4, 128, 768), torch.float16, 0.5, True, True),
    ((1001,), torch.float32, 0.3, False, False),
    ((37, 41), torch.bfloat16, 0.0, True, False),
    ((37, 41), torch.float16, 1.0, True, False),
])
def test_dropout_kernel_matches_plain_version(shape, dtype, p, upscale,
                                              host_seed):
    """Out and Mask equal to the plain version's to the last bit, the seed
    read through a device pointer or given as a host integer."""
    _need_cuda()
    from paddle_tpu_torch.ops import dropout as tdrop
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(shape, device="cuda", generator=g).to(dtype)
    seed = 12345 if host_seed else torch.tensor([12345], device="cuda")
    before = tdrop.dropout_cuda.launches
    out, mask = tdrop.dropout_cuda(x, p, seed, 7, upscale)
    torch.cuda.synchronize()
    assert tdrop.dropout_cuda.launches == before + 1
    ref_out, ref_mask = tdrop.dropout_plain(x, p, seed, 7, upscale)
    assert _same_bits(out, ref_out) and _same_bits(mask, ref_mask)
    assert _same_bits(mask, tdrop.dropout_plain(x.cpu(), p, 12345, 7,
                                                upscale)[1].cuda())


def test_dropout_kernel_unaligned_view_and_wrong_seed():
    """A view 2 bytes past a 16-byte boundary takes the scalar path, with
    the same bits; a seed on the host or of another dtype is refused."""
    _need_cuda()
    from paddle_tpu_torch.ops import dropout as tdrop
    g = torch.Generator(device="cuda").manual_seed(4)
    flat = torch.randn(4099, device="cuda", generator=g).to(torch.bfloat16)
    seed = torch.tensor([5], device="cuda")
    out, mask = tdrop.dropout_cuda(flat[1:], 0.2, seed, 1, True)
    ref_out, ref_mask = tdrop.dropout_plain(flat[1:], 0.2, seed, 1, True)
    assert _same_bits(out, ref_out) and _same_bits(mask, ref_mask)
    for bad in (torch.tensor([5]), torch.tensor([5], dtype=torch.int32,
                                                device="cuda")):
        with pytest.raises(ValueError, match="seed"):
            tdrop.dropout_cuda(flat, 0.2, bad, 1, True)


def _dropout_fc(static, layers):
    """fc -> dropout (upscale) -> fc -> dropout (downgrade) regression,
    Adam; returns (main, startup, loss, the two Mask names)."""
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = layers.data("x", [-1, 64])
        y = layers.data("y", [-1, 1])
        h = layers.dropout(layers.fc(x, 256, act="gelu"), 0.2,
                           dropout_implementation="upscale_in_train")
        h = layers.dropout(layers.fc(h, 1), 0.1)
        diff = layers.elementwise_add(h, layers.scale(y, -1.0))
        loss = layers.mean(layers.elementwise_mul(diff, diff))
        static.Adam(1e-3).minimize(loss)
    masks = [op.outputs["Mask"][0] for op in main.global_block().ops
             if op.type == "dropout"]
    return main, startup, loss, masks


def test_run_steps_with_dropout_matches_run():
    """A program with dropout is captured (no refusal): K = 4 replayed
    steps against 4 eager run() steps from the same state and step count,
    losses, masks and persistables to the last bit; every replayed step
    draws a new mask (the first dropout's); the kernel launched in the warm-up and the capture
    only (twice per dropout op), not on a replay."""
    _need_cuda()
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import dropout as tdrop
    from paddle_tpu_torch.static import layers
    main, startup, loss, masks = _dropout_fc(static, layers)
    rng = np.random.RandomState(0)
    xs = rng.randn(4, 32, 64).astype(np.float32)
    feed = {"x": xs, "y": xs.sum(-1, keepdims=True).astype(np.float32)}
    exe, scope = static.Executor(), static.Scope()
    with static.scope_guard(scope):
        exe.run(startup)
    twin, twin_exe = static.Scope(), static.Executor()
    for n, t in scope.vars.items():
        twin.set(n, t.clone())
    twin_exe._step = exe._step
    before = tdrop.dropout_cuda.launches
    with static.scope_guard(scope):
        got = exe.run_steps(main, feed=feed, fetch_list=[loss] + masks)
    assert tdrop.dropout_cuda.launches - before == 2 * len(masks)
    with static.scope_guard(twin):
        want = [twin_exe.run(main, feed={n: v[i] for n, v in feed.items()},
                             fetch_list=[loss] + masks) for i in range(4)]
    for j in range(1 + len(masks)):
        np.testing.assert_array_equal(
            got[j], np.stack([np.asarray(w[j]) for w in want]).reshape(
                got[j].shape))
    m = got[1]  # the first dropout's [32, 256] masks
    assert all(not np.array_equal(m[i], m[i + 1]) for i in range(3))
    for n, t in twin.vars.items():
        assert torch.equal(scope.vars[n], t), n
    exe.close()


_BF16, _FP16 = torch.bfloat16, torch.float16


# strided: True for the head-split view, "refused" for q and dO in a view
# 4 bytes past a 16-byte boundary (TMA refuses it)
@pytest.mark.parametrize("b,h,sq,sk,d,dtype,causal,strided", [
    (2, 2, 128, 128, 256, torch.float32, False, True),
    (1, 2, 96, 160, 256, torch.float32, True, False),
    (1, 2, 200, 200, 256, _BF16, False, True),
    (1, 2, 160, 96, 256, _BF16, True, False),
    (1, 2, 200, 200, 256, _FP16, True, False),
    (1, 2, 128, 128, 160, torch.float32, False, False),
    (1, 2, 130, 130, 200, _BF16, True, False),
    # the 16-bit D = 256 wgmma forward and dK/dV: causal Sq < Sk and
    # Sq > Sk, ragged S, head-split views, views TMA refuses (copied)
    (1, 2, 96, 160, 256, _BF16, True, False),
    (1, 2, 96, 160, 256, _FP16, True, False),
    (1, 2, 160, 96, 256, _FP16, True, False),
    (1, 2, 200, 200, 256, _FP16, False, True),
    (2, 2, 256, 256, 256, _BF16, True, True),
    (1, 2, 130, 70, 256, _BF16, False, "refused"),
    (1, 2, 130, 70, 256, _FP16, True, "refused"),
    # head dims above 256: the split-D route (320 padded to 512)
    (1, 2, 128, 128, 512, torch.float32, False, False),
    (1, 2, 96, 160, 320, torch.float32, True, True),
    (1, 2, 96, 160, 512, _BF16, True, True),
    (1, 2, 200, 200, 320, _BF16, False, False),
    (1, 2, 200, 200, 512, _FP16, True, False),
    (1, 2, 160, 96, 320, _FP16, True, True),
    (1, 2, 130, 130, 512, _BF16, False, "refused"),
    (1, 2, 160, 96, 512, _BF16, True, False),
    # the fp32 split-D forward and dK/dV (3xTF32): causal Sq < Sk and
    # Sq > Sk, ragged S, head-split views, views 4 bytes past a 16-byte
    # boundary (copied: TMA refuses them), D = 320 (padded), 512 and 768
    (1, 2, 160, 96, 512, torch.float32, True, False),
    (1, 2, 200, 200, 512, torch.float32, False, True),
    (1, 2, 130, 70, 512, torch.float32, False, "offset"),
    (1, 2, 70, 130, 320, torch.float32, True, "offset"),
    (1, 2, 96, 160, 768, torch.float32, True, False),
    (1, 2, 200, 200, 768, torch.float32, True, True),
    (2, 2, 256, 256, 768, torch.float32, False, False),
    # D = 768, three 256-column chunks
    (1, 2, 96, 160, 768, _BF16, True, True),
    (1, 2, 160, 96, 768, _FP16, True, False),
    (1, 2, 200, 200, 768, _BF16, False, False),
    (1, 2, 130, 130, 768, _FP16, False, "refused"),
    # the fp32 split-D dQ (a 512-column chunk at D = 512 and 1024, 384 at
    # D = 768) and the 16-bit split-D dK/dV: causal Sq > Sk at D = 768,
    # ragged causal S = 200 at D = 320 on head-split views, D = 1000
    # (padded to 1024: two dQ chunks, four dK/dV chunks)
    (1, 2, 160, 96, 768, torch.float32, True, False),
    (1, 2, 200, 200, 320, torch.float32, True, True),
    (1, 1, 130, 100, 1000, torch.float32, True, True),
    (1, 2, 200, 200, 320, _FP16, True, True),
    (1, 1, 100, 130, 1000, _BF16, True, False),
    # the fp32 D = 256 forward, dQ and dK/dV on the 3xTF32 split-D
    # kernels at n = 1: causal Sq > Sk, ragged causal S = 200 on
    # head-split views, and q, k, v and dO 4 bytes past a 16-byte boundary
    # (copied by all three: TMA refuses them; D = 200 is padded instead)
    (1, 2, 160, 96, 256, torch.float32, True, False),
    (1, 2, 200, 200, 256, torch.float32, True, True),
    (1, 2, 130, 70, 256, torch.float32, False, "offset"),
    (1, 2, 96, 160, 200, torch.float32, True, "offset"),
    # the 16-bit split-D dQ: D = 1000 (padded to 1024: two 512-column
    # chunks), causal D = 768 in fp16 (two 384-column chunks), D = 1280
    # (five 256-column chunks)
    (1, 1, 130, 100, 1000, _FP16, True, True),
    (1, 2, 96, 160, 768, _FP16, True, True),
    (1, 2, 200, 200, 768, _FP16, True, False),
    (1, 1, 96, 130, 1280, _BF16, True, False),
])
def test_d256_kernels_match_plain_versions(b, h, sq, sk, d, dtype, causal,
                                           strided):
    """Head dims above 128.  D = 256 (and 160, 200 zero-padded to it): in
    bf16 and fp16 the forward, dQ and dK/dV are the wgmma kernels at
    D = 256 (counted in `launches_wgmma256`).  D = 256 n, n >= 2 (and 320
    padded to 512, 1000 to 1024): the 16-bit forward, dQ and dK/dV are the
    split-D wgmma kernels (`launches_wgmma_split_d`).  D = 256 n, n >= 1:
    the fp32 forward, dQ and dK/dV are the 3xTF32 split-D kernels
    (`launches_tf32_split_d`).  Each launch is counted once, on its own
    route.  A view TMA refuses is copied where a wgmma kernel reads it (q
    in the forward, q and dO in dQ and in dK/dV: 5 copies in 16 bits) and
    where a 3xTF32 split-D kernel reads it ("offset": q, k, v and dO 4
    bytes past a 16-byte boundary; the forward copies q, k and v, the dQ
    and dK/dV q, k, v and dO: 3 + 4 + 4 copies).  The forward, dQ and
    dK/dV against their plain versions at TOL (the D <= 128 kernels'
    tolerances, for the same reasons)."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (_bhsd(g, b, h, s, d, dtype, strided is True)
                   for s in (sq, sk, sk, sq))
    if strided == "refused":
        q, do = _shifted(q), _shifted(do)
        assert not tattn.tma_accepts(q) and not tattn.tma_accepts(do)
    if strided == "offset":
        q, k, v, do = (_shifted(t, 1) for t in (q, k, v, do))
        assert all(t.data_ptr() % 16 == 4 for t in (q, k, v, do))
    dp = tattn.kernel_head_dim(d)
    wide16 = dtype != torch.float32
    if dp > 256 and wide16:
        want = ("launches_wgmma_split_d",) * 3
    elif wide16:
        want = ("launches_wgmma256",) * 3
    else:
        want = ("launches_tf32_split_d",) * 3
    counts = (tattn.flash_attention, tattn.flash_attention_bwd_dq_cuda,
              tattn.flash_attention_bwd_dkv_cuda)
    names = tuple(tattn.LAUNCH_COUNTS.values())

    def read():
        return [{n: getattr(f, n) for n in names} for f in counts]

    before, copies = read(), tattn.flash_attention.view_copies
    out, lse = tattn.flash_attention_cuda(q, k, v, causal=causal)
    dd = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, dd, causal)
    dq = tattn.flash_attention_bwd_dq_cuda(*args)
    dk, dv = tattn.flash_attention_bwd_dkv_cuda(*args)
    torch.cuda.synchronize()
    assert read() == [{n: c[n] + (n == w) for n in names}
                      for c, w in zip(before, want)]
    tma_copies = 0
    if strided == "refused" and dp == d and wide16:
        tma_copies = 5
    if strided == "offset" and dp == d:
        tma_copies = 11
    assert tattn.flash_attention.view_copies == copies + tma_copies
    tol = TOL[dtype]
    ref, ref_lse = tattn.flash_attention_plain(q, k, v, causal=causal)
    assert out.shape == q.shape and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], ref_lse[fin], rtol=tol, atol=tol)
    ref_dq = tattn.flash_attention_bwd_dq_plain(*args)
    ref_dk, ref_dv = tattn.flash_attention_bwd_dkv_plain(*args)
    for got, want_t in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.shape[-1] == d and got.dtype == dtype
        torch.testing.assert_close(got.float(), want_t.float(), rtol=tol,
                                   atol=tol)
    if causal and sq > sk:
        assert torch.all(out[:, :, :sq - sk] == 0)
        assert torch.all(dq[:, :, :sq - sk] == 0)


def _wide_autograd(dtype, names, d=320):
    """flash_attention forward and backward (autograd, dO = 2 O) at head
    dim d causal, each kernel a counted launch on its route (`names`:
    forward, dQ, dK/dV).  fp32: against the fp32 score-matrix reference on
    the same values at 1e-4.  16 bits: against the same autograd on CPU
    copies, which runs the plain versions (they round P, dS and the
    outputs where the kernels do and sum in fp32, so a biased tensor-core
    sum shows against them) at TOL[dtype]; and no further from the fp32
    score-matrix reference than the plain versions are, plus TOL[dtype]
    (the rounding to 16 bits alone puts the plain path up to ~0.1 from
    it)."""
    g = torch.Generator(device="cuda").manual_seed(8)
    q, k, v = (torch.randn(1, 2, 96, d, device="cuda", generator=g)
               .to(dtype).requires_grad_(True) for _ in range(3))
    counts = (tattn.flash_attention, tattn.flash_attention_bwd_dq_cuda,
              tattn.flash_attention_bwd_dkv_cuda)
    routes = tuple(tattn.LAUNCH_COUNTS.values())

    def read():
        return [(getattr(f, n), sum(getattr(f, r) for r in routes))
                for f, n in zip(counts, names)]

    before = read()
    out = tattn.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    torch.cuda.synchronize()
    assert read() == [(n + 1, every + 1) for n, every in before]
    ql, kl, vl = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    ref = tattn.reference_attention(ql, kl, vl, causal=True)
    want = torch.autograd.grad(ref.square().sum(), (ql, kl, vl))
    tol = TOL[dtype]
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
        for got, w in zip(grads, want):
            torch.testing.assert_close(got, w, rtol=tol, atol=tol)
        return
    qc, kc, vc = (t.detach().cpu().requires_grad_(True) for t in (q, k, v))
    out_c = tattn.flash_attention(qc, kc, vc, causal=True)
    plain = torch.autograd.grad(out_c.square().sum(), (qc, kc, vc))
    for got, p, w in ((out, out_c, ref),) + tuple(zip(grads, plain, want)):
        assert got.dtype == p.dtype == dtype
        got, p = got.detach().float(), p.detach().float().cuda()
        torch.testing.assert_close(got, p, rtol=tol, atol=tol)
        assert (got - w).abs().max() <= (p - w).abs().max() + tol


def test_wide_head_dims_through_autograd():
    """A CUDA tensor with D = 320 runs `flash_attention` forward and
    backward (autograd) through the 3xTF32 split-D kernels, all three
    counted on `launches_tf32_split_d`, and matches the score-matrix
    reference in fp32 (1e-4: the gate that caught the bias of long
    tensor-core sums in dS = P (dP - D))."""
    _need_cuda()
    _wide_autograd(torch.float32, ("launches_tf32_split_d",) * 3)


def test_d256_fp32_through_autograd():
    """D = 200 (zero-padded to 256) in fp32 runs the forward, dQ and dK/dV
    through the 3xTF32 split-D kernels at n = 1, all three counted on
    `launches_tf32_split_d`, and matches the score-matrix reference's
    gradients at 1e-4 (the gate of test_wide_head_dims_through_autograd,
    which would show a toward-zero bias of the tensor-core sums)."""
    _need_cuda()
    _wide_autograd(torch.float32, ("launches_tf32_split_d",) * 3, d=200)


def test_wide_head_dims_through_autograd_bf16():
    """The same in bf16: the split-D wgmma forward, dQ and dK/dV (all
    three on `launches_wgmma_split_d`), at the bf16 tolerance against the
    plain versions, and against the fp32 score-matrix reference as far as
    the plain versions are from it, so that a bias in the wgmma sums over
    all of D would show."""
    _need_cuda()
    _wide_autograd(torch.bfloat16, ("launches_wgmma_split_d",) * 3)


def test_device_resident_pool_and_engine():
    """The paged KV pool's slabs live on the card and every write and
    gather stays there; the paged engine (radix prefix cache on) serves a
    tiny GPT on the card token-equal to the fixed-slot engine and to one
    teacher-forced forward over each reply (greedy: every generated token
    is within 1e-4 of that forward's top logit), and drains."""
    _need_cuda()
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.core.place import CUDAPlace
    from paddle_tpu_torch.models import GPTConfig, GPTForGeneration, GPTModel
    from paddle_tpu_torch.serving import ContinuousBatchingEngine, PagedKVPool
    torch.backends.cuda.matmul.allow_tf32 = False
    pool = PagedKVPool(num_layers=2, num_heads=2, head_dim=4, page_tokens=4,
                       num_pages=8, device="cuda")
    assert pool.k.is_cuda and pool.v.is_cuda
    t = pool.open_sequence(np.arange(2, 8), torch.randn(2, 2, 6, 4),
                           torch.randn(2, 2, 6, 4))
    pool.append_column(t, torch.ones(2, 2, 4, device="cuda"),
                       torch.ones(2, 2, 4, device="cuda"))
    k, v = pool.gather(t)
    kb, _ = pool.gather_batch(
        torch.from_numpy(pool.page_index([t, None], 16)).cuda(), 16)
    assert k.is_cuda and k.shape == (2, 2, 7, 4)
    torch.testing.assert_close(kb[:, 0, :, :7], k, rtol=0, atol=0)
    pool.close_sequence(t)
    pool.assert_drained()

    with dygraph.guard(CUDAPlace(0)):
        m = GPTForGeneration(GPTModel(GPTConfig(
            vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_position=64, dropout=0.0)))
    plan = dict(num_layers=2, num_heads=4, head_dim=8, page_tokens=4,
                pages=40, max_slots=3, max_context=64)
    rng = np.random.RandomState(0)
    head = rng.randint(2, 64, 8)
    prompts = [np.concatenate([head, rng.randint(2, 64, n)]) for n in
               (1, 3, 5, 2)]
    outs = {}
    for name, kw in (("paged", dict(kv_pool=plan, prefix_cache="auto")),
                     ("fixed", dict(max_slots=3))):
        eng = ContinuousBatchingEngine(m, **kw).start()
        try:
            outs[name] = [eng.submit(p, max_length=6).result(timeout=120)
                          for p in prompts[:2]] + \
                [f.result(timeout=120) for f in
                 [eng.submit(p, max_length=6) for p in prompts[2:]]]
        finally:
            eng.stop()
        if name == "paged":
            assert eng.kv_pool.k.is_cuda and eng.prefix_cache.hits > 0
            eng.kv_pool.assert_drained()
    for reply, p in zip(outs["paged"], prompts):
        with torch.inference_mode():
            logits = m.gpt(torch.as_tensor(reply[None], device="cuda"))[0]
        for pos in range(p.size, reply.size):
            row = logits[pos - 1]
            assert float(row.max() - row[int(reply[pos])]) <= 1e-4
    for a, b in zip(outs["paged"], outs["fixed"]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the dygraph training path (2.0 API) on the card
# ---------------------------------------------------------------------------
def _mha_pair(dtype, seed=31):
    """A MultiHeadAttention (hidden 128, 2 heads: D = 64) on the card and
    its copy on the CPU, flash forced on; inputs [2, 128, 128] in
    `dtype`."""
    from paddle_tpu_torch import dygraph, nn
    from paddle_tpu_torch.core.place import CPUPlace, CUDAPlace
    with dygraph.guard(CUDAPlace(0)):
        gpu = nn.MultiHeadAttention(128, 2)
    with dygraph.guard(CPUPlace()):
        cpu = nn.MultiHeadAttention(128, 2)
    cpu.set_state_dict(gpu.state_dict())
    gpu, cpu = gpu.to(dtype), cpu.to(dtype)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 128, 128, generator=g).to(dtype)
    return gpu, cpu, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dygraph_backward_through_flash(dtype):
    """Dygraph MultiHeadAttention, flash on, loss.backward(): the card's
    flash forward, dQ and dK/dV kernels (one launch each, in `dtype`)
    against the same module on the CPU (the plain versions)."""
    _need_cuda()
    gpu, cpu, x = _mha_pair(dtype)
    prev = tattn._FLASH_STATE["mode"]
    tattn.enable_flash_attention(True)
    wrappers = (tattn.flash_attention, tattn.flash_attention_bwd_dq_cuda,
                tattn.flash_attention_bwd_dkv_cuda)
    before = [w.dtype_launches[str(dtype)[6:]] for w in wrappers]
    try:
        xs = {"gpu": x.cuda().requires_grad_(True),
              "cpu": x.clone().requires_grad_(True)}
        outs = {}
        for tag, m in (("gpu", gpu), ("cpu", cpu)):
            out = m(xs[tag])
            (out.float() * torch.linspace(-1, 1, 128, device=out.device))\
                .sum().backward()
            outs[tag] = out
    finally:
        tattn._FLASH_STATE["mode"] = prev
    assert [w.dtype_launches[str(dtype)[6:]] - b
            for w, b in zip(wrappers, before)] == [1, 1, 1]
    tol = TOL[dtype]
    torch.testing.assert_close(outs["gpu"].float().cpu(),
                               outs["cpu"].float(), atol=tol, rtol=tol)
    torch.testing.assert_close(xs["gpu"].grad.float().cpu(),
                               xs["cpu"].grad.float(), atol=tol, rtol=tol)
    for (k, p), q in zip(gpu.named_parameters(), cpu.parameters()):
        torch.testing.assert_close(p.grad.float().cpu(), q.grad.float(),
                                   atol=tol, rtol=tol, msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dygraph_fused_cross_entropy_and_grad(dtype):
    """F.cross_entropy with FLAGS_fused_xent on (the kernel, one launch)
    against the same call with it off (torch ops), loss and dlogits."""
    _need_cuda()
    from paddle_tpu_torch.nn import functional as F
    g = torch.Generator(device="cuda").manual_seed(5)
    logits = torch.randn(512, 3000, device="cuda", generator=g).to(dtype)
    labels = torch.randint(0, 3000, (512,), device="cuda", generator=g)
    labels[::7] = -100
    got = {}
    for fused in (True, False):
        tfx.enable_fused_xent(fused)
        try:
            x = logits.clone().requires_grad_(True)
            n0 = tfx.fused_xent_cuda.launches
            loss = F.cross_entropy(x, labels)
            loss.backward()
            assert tfx.fused_xent_cuda.launches - n0 == int(fused)
            got[fused] = (loss.detach(), x.grad)
        finally:
            tfx.enable_fused_xent(False)
    torch.testing.assert_close(got[True][0], got[False][0], atol=1e-5,
                               rtol=1e-5)
    tol = TOL[dtype]
    torch.testing.assert_close(got[True][1].float(), got[False][1].float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dygraph_dropout_grad_is_grad_times_mask_over_q(dtype):
    """F.dropout in training on the card: the Philox kernel's Out and Mask
    equal to the plain version's to the last bit, and the gradient equal
    to grad * Mask / (1 - p) (the quotient in fp32, as the forward)."""
    _need_cuda()
    import paddle_tpu_torch
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import dropout as tdrop
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(8, 512, 768, device="cuda", generator=g).to(dtype)
    gy = torch.randn(8, 512, 768, device="cuda", generator=g).to(dtype)
    paddle_tpu_torch.seed(9)
    n0 = tdrop.dropout_cuda.launches
    xg = x.clone().requires_grad_(True)
    out, mask = F.dropout_with_mask(xg, 0.1)
    assert tdrop.dropout_cuda.launches - n0 == 1
    ref_out, ref_mask = tdrop.dropout_plain(x.cpu(), 0.1, 9, 1, True)
    assert torch.equal(mask.cpu(), ref_mask)
    assert torch.equal(out.detach().cpu(), ref_out)
    out.backward(gy)
    q = torch.tensor(tdrop.scale_divisor(0.1, dtype), device="cuda")
    want = torch.where(mask.bool(), (gy.float() / q).to(dtype),
                       torch.zeros((), dtype=dtype, device="cuda"))
    assert torch.equal(xg.grad, want)


def test_grad_scaler_on_cuda_tensors():
    """GradScaler over CUDA gradients: an overflowing loss skips the step
    and halves the scale; a finite one steps (unscaled gradients: the
    same update as without the scaler)."""
    _need_cuda()
    from paddle_tpu_torch import amp, dygraph, nn, optimizer
    from paddle_tpu_torch.core.place import CUDAPlace
    with dygraph.guard(CUDAPlace(0)):
        lin = nn.Linear(16, 4)
        ref = nn.Linear(16, 4)
        ref.set_state_dict(lin.state_dict())
        opt = optimizer.SGD(0.1, parameters=lin.parameters())
        ref_opt = optimizer.SGD(0.1, parameters=ref.parameters())
    scaler = amp.GradScaler(init_loss_scaling=1024.0)
    x = torch.randn(4, 16, device="cuda")
    w0 = lin.weight.detach().clone()
    scaler.scale(lin(torch.full_like(x, 3e37)).sum()).backward()
    scaler.minimize(opt, None)
    opt.clear_grad()
    assert torch.equal(lin.weight, w0) and scaler.get_loss_scaling() == 512.0
    scaler.scale(lin(x).sum()).backward()
    scaler.minimize(opt, None)
    ref(x).sum().backward()
    ref_opt.step()
    torch.testing.assert_close(lin.weight, ref.weight, atol=1e-6, rtol=1e-6)
    assert lin.weight.grad.is_cuda


# ---------------------------------------------------------------------------
# the BASELINE configs' ops (cuDNN / ATen through torch, no hand kernel)
# ---------------------------------------------------------------------------
_VISION_CASES = [
    ("conv2d", {"Input": (4, 16, 28, 28), "Filter": (32, 16, 3, 3)},
     {"strides": [2, 2], "paddings": [1, 1]}, "Output"),
    ("conv2d", {"Input": (2, 3, 30, 31), "Filter": (8, 3, 7, 7)},
     {"strides": [2, 2], "paddings": [3, 2, 1, 3]}, "Output"),
    ("conv2d", {"Input": (2, 9, 12, 8), "Filter": (6, 4, 3, 3)},
     {"groups": 2, "dilations": [2, 1], "padding_algorithm": "SAME",
      "data_format": "NHWC"}, "Output"),
    ("pool2d", {"X": (4, 8, 17, 17)}, {"pooling_type": "max", "ksize": [3, 3],
                                       "strides": [2, 2],
                                       "paddings": [1, 1]}, "Out"),
    ("pool2d", {"X": (4, 8, 17, 17)}, {"pooling_type": "avg", "ksize": [3, 3],
                                       "strides": [2, 2],
                                       "paddings": [2, 1, 0, 2]}, "Out"),
    ("pool2d", {"X": (4, 8, 7, 7)}, {"pooling_type": "avg",
                                     "global_pooling": True}, "Out"),
    ("batch_norm", {"X": (8, 16, 14, 14)}, {"momentum": 0.9}, "Y"),
    ("batch_norm", {"X": (8, 16, 14, 14)}, {"use_global_stats": True}, "Y"),
]


@pytest.mark.parametrize("case", range(len(_VISION_CASES)))
def test_vision_ops_on_the_card_match_float64_on_the_cpu(case):
    """conv2d, pool2d and batch_norm and their grad ops on the card (fp32)
    against the same port ops on the CPU in float64, with cuDNN's TF32
    switched ON process-wide: the conv2d kernel turns it off for itself,
    so every output holds a normalised max error of 1e-5 (TF32 rounds
    each operand to 10 bits of mantissa and would miss it by ~100x)."""
    _need_cuda()
    from paddle_tpu_torch.ops.registry import OpContext, get_op_info
    op, shapes, attrs, out_slot = _VISION_CASES[case]
    g = torch.Generator().manual_seed(case)
    ins = {k: torch.randn(s, generator=g, dtype=torch.float64)
           for k, s in shapes.items()}
    if op == "batch_norm":
        c = shapes["X"][1]
        ins.update(Scale=torch.randn(c, generator=g, dtype=torch.float64),
                   Bias=torch.randn(c, generator=g, dtype=torch.float64),
                   Mean=torch.randn(c, generator=g, dtype=torch.float64),
                   Variance=torch.rand(c, generator=g,
                                       dtype=torch.float64) + 0.5)
    fwd, grad = get_op_info(op), get_op_info(op + "_grad")
    res = {}
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for dev, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
            x = {k: v.to(dev, dt) for k, v in ins.items()}
            ctx = OpContext(device=dev)
            out = fwd.kernel(x, attrs, ctx)
            gin = dict(x, **out)
            gin[out_slot + "@GRAD"] = torch.linspace(
                -1, 1, out[out_slot].numel(), dtype=dt,
                device=dev).reshape(out[out_slot].shape)
            res[dev] = dict(out, **grad.kernel(gin, attrs, ctx))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert set(res["cuda"]) == set(res["cpu"])
    for k, ref in res["cpu"].items():
        got = res["cuda"][k].cpu().double()
        err = float((got - ref).abs().max() / ref.abs().max().clamp_min(
            1e-30))
        assert err <= 1e-5, (op, k, err)


def test_conv2d_autograd_on_the_card_is_fp32_under_the_tf32_flag():
    """ConvFn's forward and backward (what nn.Conv2D runs) on the card
    against float64 on the CPU with the TF32 flag on, at ResNet's 3x3 /
    256 channels (sums of 2,304 products): normalised 1e-4.  cuDNN's fp32
    algorithms here (Winograd among them) measured 3.9e-5 on the card;
    TF32 (10-bit operands) errs ~1e-3."""
    _need_cuda()
    from paddle_tpu_torch.ops.kernels.nn import ConvFn
    g = torch.Generator().manual_seed(7)
    x = torch.randn(8, 256, 14, 14, generator=g, dtype=torch.float64)
    w = torch.randn(256, 256, 3, 3, generator=g, dtype=torch.float64)
    res = {}
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for dev, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
            xv = x.to(dev, dt).requires_grad_(True)
            wv = w.to(dev, dt).requires_grad_(True)
            out = ConvFn.apply(xv, wv, [1, 1], [1, 1], [1, 1], False, 1)
            (out * out.detach().sin()).sum().backward()
            res[dev] = (out.detach(), xv.grad, wv.grad)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert torch.backends.cudnn.allow_tf32 == prev
    for got, ref in zip(res["cuda"], res["cpu"]):
        err = float((got.cpu().double() - ref).abs().max() / ref.abs().max())
        assert err <= 1e-4, err


def test_run_steps_replays_batch_norm_running_stats():
    """A conv_bn + pool + fc program (bf16 AMP, Momentum) through
    run_steps (K = 3): the losses equal 3 eager run() steps' (to the last
    bit, else rtol 2e-3), and the fetched running mean of the batch norm
    is new in every replayed step and equal to the eager one's."""
    _need_cuda()
    from paddle_tpu_torch import amp, static
    from paddle_tpu_torch.models.baseline_static import conv_bn
    from paddle_tpu_torch.static import layers
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        im = layers.data("image", [-1, 3, 32, 32])
        label = layers.data("label", [-1, 1], dtype="int64")
        h = conv_bn(layers, im, 16, 3, act="relu")
        h = layers.pool2d(h, 3, pool_type="max", pool_stride=2,
                          pool_padding=1)
        h = layers.pool2d(h, pool_type="avg", global_pooling=True)
        loss = layers.mean(layers.softmax_with_cross_entropy(
            layers.fc(h, 10), label))
        amp.decorate(static.Momentum(0.1, 0.9), init_loss_scaling=1.0,
                     use_dynamic_loss_scaling=False,
                     dest_dtype="bfloat16").minimize(loss)
    mean = [op for op in main.global_block().ops
            if op.type == "batch_norm"][0].inputs["Mean"][0]
    rng = np.random.RandomState(0)
    feed = {"image": rng.rand(8, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}
    exe = static.Executor()
    scope = static.Scope()
    with static.scope_guard(scope):
        exe.run(startup)
    init = {n: t.clone() for n, t in scope.vars.items() if t is not None}
    with static.scope_guard(scope):
        eager = [exe.run(main, feed=feed, fetch_list=[loss, mean])
                 for _ in range(3)]
    gscope = static.Scope()
    for n, t in init.items():
        gscope.set(n, t)
    with static.scope_guard(gscope):
        gexe = static.Executor()
        losses, means = gexe.run_steps(
            main, feed={n: np.stack([v] * 3) for n, v in feed.items()},
            fetch_list=[loss, mean])
    assert gexe.cache_stats()["traces"] == 1
    np.testing.assert_allclose(losses.reshape(-1),
                               [float(e[0].reshape(-1)[0]) for e in eager],
                               rtol=2e-3)
    for i in range(3):
        np.testing.assert_allclose(means[i], eager[i][1], rtol=1e-5,
                                   atol=1e-6)
        assert i == 0 or not np.array_equal(means[i], means[i - 1])
    gexe.close()


# ---------------------------------------------------------------------------
# the serving remainders on the card: int8_matmul, int8 pages, the
# speculative engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(1, 768, 768), (8, 768, 3072),
                                   (16, 64, 64), (17, 32, 24), (8, 32, 32),
                                   (17, 64, 64), (33, 32, 96), (24, 16, 32),
                                   (4096, 768, 768), (5, 12, 20)])
def test_int8_product_matches_plain_version(m, k, n):
    """torch._int_mm through int8_product (the weight handed over
    column-major): the int32 accumulators EQUAL to the plain version's;
    rows <= 16 (a decode step's) and K or N not a multiple of 8 are
    zero-padded, and each padded call counted."""
    _need_cuda()
    from paddle_tpu_torch.ops.kernels import quantize as tq
    g = torch.Generator(device="cuda").manual_seed(m + k + n)
    x = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda",
                      generator=g)
    w = torch.randint(-127, 128, (k, n), dtype=torch.int8, device="cuda",
                      generator=g)
    calls0, pads0 = tq.int8_product.launches, tq.int8_product.padded_calls
    acc = tq.int8_product(x, w)
    assert acc.dtype == torch.int32 and acc.shape == (m, n) and acc.is_cuda
    assert torch.equal(acc, tq.int8_product_plain(x, w))
    assert tq.int8_product.launches == calls0 + 1
    padded = m <= 16 or k % 8 or n % 8
    assert tq.int8_product.padded_calls == pads0 + bool(padded)


def test_int8_product_shape_sweep():
    """Every product of a 336-shape sweep (rows 17-4096, K 16-3072, N
    16-3072) through torch._int_mm with the weight column-major equals
    the plain version: a row-major weight made cuBLASLt refuse some of
    them (CUBLAS_STATUS_NOT_SUPPORTED) on the H100."""
    _need_cuda()
    import itertools
    from paddle_tpu_torch.ops.kernels import quantize as tq
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = list(itertools.product((17, 24, 32, 33, 40, 64, 128, 4096),
                                    (16, 32, 64, 96, 768, 3072),
                                    (16, 24, 32, 64, 96, 768, 3072)))
    for m, k, n in shapes:
        x = torch.randint(-127, 128, (m, k), dtype=torch.int8,
                          device="cuda", generator=g)
        w = torch.randint(-127, 128, (k, n), dtype=torch.int8,
                          device="cuda", generator=g)
        assert torch.equal(tq.int8_product(x, w),
                           tq.int8_product_plain(x, w)), (m, k, n)
    assert len(shapes) == 336


def test_int8_matmul_op_on_card_matches_cpu():
    """The int8_matmul op on the card against the same op on the CPU
    (plain product): the same quantized activation, int32 accumulators
    and fp32 output (atol=rtol=1e-6)."""
    _need_cuda()
    from paddle_tpu_torch.ops.registry import OpContext, run_kernel
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 64).astype(np.float32)
    w = rng.randint(-127, 128, (64, 48)).astype(np.int8)
    s = np.abs(rng.randn(48)).astype(np.float32) + 0.1
    b = rng.randn(48).astype(np.float32)
    outs = []
    for dev in ("cpu", "cuda"):
        ins = {k: torch.from_numpy(v).to(dev) for k, v in
               (("X", x), ("W", w), ("WScale", s), ("Bias", b))}
        outs.append(run_kernel("int8_matmul", ins, {"max_range": 127.0},
                               OpContext(device=dev))["Out"].cpu())
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-6, atol=1e-6)


def test_int8_pool_on_card_matches_cpu_pool():
    """int8 pages on the card: the slabs, scale sidecars and gathers after
    prefill, copy-on-write, requantize-on-grow and truncate equal to the
    last bit to the same writes on a CPU pool; no clip; drained."""
    _need_cuda()
    from paddle_tpu_torch.serving import PagedKVPool
    rng = np.random.RandomState(1)
    prompt = rng.randint(2, 30, 6)
    k = rng.randn(2, 2, 6, 4).astype(np.float32)
    v = rng.randn(2, 2, 6, 4).astype(np.float32)
    cols = [(rng.randn(2, 2, 4) * s).astype(np.float32) for s in
            (10.0, 0.1, 50.0)]
    pools = []
    for dev in ("cpu", "cuda"):
        pool = PagedKVPool(num_layers=2, num_heads=2, head_dim=4,
                           page_tokens=4, num_pages=8, kv_dtype="int8",
                           device=dev)
        t1 = pool.open_sequence(prompt, k, v)
        t2 = pool.open_sequence(prompt, k, v, reserved=4)
        for c in cols:
            pool.append_column(t2, c, -c)
        g = [x.cpu() for x in pool.gather(t2)]
        pool.truncate(t2, 7)
        assert pool.cow_copies == 1 and pool.quant_scale_clips == 0
        pools.append((pool, g, t1, t2))
    (cp, cg, _, _), (gp, gg, t1, t2) = pools
    assert gp.k.is_cuda and gp.k_scale.is_cuda
    for a, b in ((cp.k, gp.k), (cp.v, gp.v), (cp.k_scale, gp.k_scale),
                 (cp.v_scale, gp.v_scale)):
        assert torch.equal(a, b.cpu())
    for a, b in zip(cg, gg):
        assert torch.equal(a, b)
    gp.close_sequence(t1)
    gp.close_sequence(t2)
    gp.assert_drained()


def test_spec_and_int8_engines_on_card():
    """A tiny GPT on the card: the speculative engine (a 2-layer stamp of
    a 2-layer model: every proposal accepted) token-equal to the plain
    paged engine, and the int8 engine over int8 pages (its products
    through torch._int_mm); both drained, no clip."""
    _need_cuda()
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.core.place import CUDAPlace
    from paddle_tpu_torch.models import GPTConfig, GPTForGeneration, GPTModel
    from paddle_tpu_torch.ops.kernels import quantize as tq
    from paddle_tpu_torch.serving import ContinuousBatchingEngine, metrics
    torch.backends.cuda.matmul.allow_tf32 = False
    with dygraph.guard(CUDAPlace(0)):
        m = GPTForGeneration(GPTModel(GPTConfig(
            vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_position=64, dropout=0.0))).eval()
    plan = dict(num_layers=2, num_heads=4, head_dim=8, page_tokens=4,
                pages=40, max_slots=3, max_context=64)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(2, 64, n) for n in (3, 9, 5, 12)]

    def serve(**kw):
        eng = ContinuousBatchingEngine(m, **kw).start()
        try:
            return eng, [f.result(timeout=120) for f in
                         [eng.submit(p, max_length=8) for p in prompts]]
        finally:
            eng.stop()

    _, plain = serve(kv_pool=dict(plan))
    acc0, prop0 = (metrics.counter("spec.accepted"),
                   metrics.counter("spec.proposed"))
    spec, outs = serve(kv_pool=dict(plan), speculative="auto")
    assert metrics.counter("spec.proposed") > prop0
    assert metrics.counter("spec.accepted") - acc0 == \
        metrics.counter("spec.proposed") - prop0
    for a, b in zip(outs, plain):
        np.testing.assert_array_equal(a, b)
    spec.kv_pool.assert_drained()
    launches0 = tq.int8_product.launches
    int8, outs8 = serve(kv_pool=dict(plan, kv_dtype="int8",
                                     weight_dtype="int8"))
    assert tq.int8_product.launches > launches0
    assert int8.kv_pool.k.dtype == torch.int8 and int8.kv_pool.k.is_cuda
    assert int8.kv_pool.quant_scale_clips == 0
    int8.kv_pool.assert_drained()
    # int8 tokens may part from fp32 at a near-tie (docs/serving.md's
    # rule); what is checked here is a well-formed reply
    for p, a in zip(prompts, outs8):
        assert list(a[:p.size]) == list(p) and \
            p.size < a.size <= p.size + 8 and 0 <= a.min() and a.max() < 64


def test_spec_engine_rollback_on_card():
    """A draft with its own weights on the card, its block weights doubled
    (as chip_smoke.py phase 11's own draft: at the init scale a random
    GPT's draft copies its target's chain and can guess every proposal):
    its proposals part from the target's chain, so rejected columns are
    truncated from the pages and the draft rolls back.  Over fp32 pages
    the replies equal the plain engine's; over int8 pages with int8
    weights (requantize after a truncate) the replies are well formed,
    nothing clips, both pools drained."""
    _need_cuda()
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.core import generator
    from paddle_tpu_torch.core.place import CUDAPlace
    from paddle_tpu_torch.models import GPTConfig, GPTForGeneration, GPTModel
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          SpeculativeDecoder, metrics,
                                          stamp_draft)
    torch.backends.cuda.matmul.allow_tf32 = False
    generator.seed(7)
    with dygraph.guard(CUDAPlace(0)):
        m = GPTForGeneration(GPTModel(GPTConfig(
            vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_position=64, dropout=0.0))).eval()
    plan = dict(num_layers=2, num_heads=4, head_dim=8, page_tokens=4,
                pages=40, max_slots=3, max_context=64)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(2, 64, n) for n in (3, 9, 5, 12)]

    def serve(**kw):
        eng = ContinuousBatchingEngine(m, **kw).start()
        try:
            return eng, [f.result(timeout=120) for f in
                         [eng.submit(p, max_length=12) for p in prompts]]
        finally:
            eng.stop()

    _, plain = serve(kv_pool=dict(plan))
    for p8 in (dict(plan), dict(plan, kv_dtype="int8", weight_dtype="int8")):
        rb0 = metrics.counter("spec.rollback_cols")
        draft = stamp_draft(m, 2, copy_weights=False)
        with torch.no_grad():
            for p in draft.gpt.blocks.parameters():
                if p.dim() == 2:
                    p.mul_(2.0)
        spec = SpeculativeDecoder(draft, k=4)
        eng, outs = serve(kv_pool=p8, speculative=spec)
        assert metrics.counter("spec.rollback_cols") > rb0
        assert spec.open_slots == 0
        eng.kv_pool.assert_drained()
        if "kv_dtype" not in p8:
            for a, b in zip(outs, plain):
                np.testing.assert_array_equal(a, b)
            continue
        assert eng.kv_pool.k.is_cuda and eng.kv_pool.quant_scale_clips == 0
        for p, a in zip(prompts, outs):
            assert list(a[:p.size]) == list(p) and \
                p.size < a.size <= p.size + 12 and 0 <= a.min() and \
                a.max() < 64


# -- ZeRO and tensor parallelism under NCCL at world 1 ----------------------
def _nccl_world_one():
    import torch.distributed as tdist
    from paddle_tpu_torch.distributed.spawn import get_free_ports
    port = get_free_ports(1)[0]
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=1, rank=0)


def test_zero3_run_steps_matches_eager_at_world_one():
    """A ZeRO-3 program (sharded for 2 ranks) under NCCL at world 1: one
    run_steps call of K = 3 (a captured graph holding the reduce-scatters
    and all-gathers) against 3 eager CompiledProgram runs and 3 plain
    Executor runs from the same start: losses and every persistable
    equal to the last bit."""
    _need_cuda()
    import torch.distributed as tdist
    import paddle_tpu_torch
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.ops.kernels import collective as kc
    from torch_dist_worker import build_zero_mlp
    _nccl_world_one()
    try:
        _reset_unique_names()
        main, startup, loss, plan = build_zero_mlp(
            paddle_tpu_torch, opt="adam", stage=3, dp=2, bucket=300)
        assert plan.param_bucket_names()
        rng = np.random.RandomState(0)
        xs = rng.rand(3, 8, 8).astype(np.float32)
        ys = rng.rand(3, 8, 1).astype(np.float32)
        init_scope = static.Scope()
        with static.scope_guard(init_scope):
            static.Executor().run(startup)
        init = {n: t.clone() for n, t in init_scope.vars.items()}

        def fresh():
            s = static.Scope()
            for n, t in init.items():
                s.set(n, t.clone())
            return s
        runs = {}
        for kind in ("plain", "eager", "replay"):
            exe, scope = static.Executor(), fresh()
            cp = static.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name)
            with static.scope_guard(scope):
                if kind == "replay":
                    kc.reset_comm_stats()
                    (lv,) = exe.run_steps(cp, feed={"x": xs, "y": ys},
                                          fetch_list=[loss])
                    calls = dict(kc.COMM_STATS["calls_by_kind"])
                    assert exe.cache_stats()["traces"] == 1
                    exe.close()
                else:
                    prog = main if kind == "plain" else cp
                    lv = [exe.run(prog, feed={"x": xs[i], "y": ys[i]},
                                  fetch_list=[loss])[0] for i in range(3)]
            runs[kind] = (np.asarray(lv, np.float32).reshape(-1),
                          {n: scope.vars[n] for n in init})
        # the capture's warm-up and captured step reached the group
        n_ag = sum(op.type == "c_allgather" for op in main.global_block().ops)
        assert calls.get("reduce_scatter") == 2 * len(plan.buckets)
        assert calls.get("all_gather") == 2 * n_ag
        for kind in ("eager", "replay"):
            np.testing.assert_array_equal(runs[kind][0], runs["plain"][0])
            for n, t in runs["plain"][1].items():
                assert torch.equal(runs[kind][1][n], t), (kind, n)
    finally:
        tdist.destroy_process_group()


def test_tp_ops_on_cuda_match_cpu():
    """The five tensor-parallel ops and their gradients on CUDA tensors,
    ring 102 bound to an NCCL group of one, against the same ops on CPU
    copies with no group (at world 1 each is its identity, its lookup):
    equal to the last bit."""
    _need_cuda()
    import torch.distributed as tdist
    from paddle_tpu_torch.ops.kernels import collective as kc
    from paddle_tpu_torch.ops.registry import OpContext, run_kernel
    _nccl_world_one()
    try:
        g = torch.Generator().manual_seed(0)
        x = torch.randn(6, 8, generator=g)
        dout = torch.randn(6, 8, generator=g)
        w = torch.randn(10, 4, generator=g)
        ids = torch.randint(0, 10, (3, 2), generator=g)
        demb = torch.randn(3, 2, 4, generator=g)
        a = {"ring_id": 102}

        def run(dev):
            ctx = OpContext(device=dev)
            out = {}
            for op in ("c_identity", "mp_allreduce_sum", "c_concat",
                       "c_split"):
                xd, gd = x.to(dev), dout.to(dev)
                f = run_kernel(op, {"X": xd}, a, ctx)["Out"]
                out[op] = (f, run_kernel(op + "_grad", {
                    "X": xd, "Out": f, "Out@GRAD": gd}, a, ctx)["X@GRAD"])
            ea = dict(a, start_index=0)
            e = run_kernel("c_embedding", {"W": w.to(dev),
                                           "Ids": ids.to(dev)}, ea, ctx)
            out["c_embedding"] = (e["Out"], run_kernel(
                "c_embedding_grad", {"W": w.to(dev), "Ids": ids.to(dev),
                                     "Out": e["Out"],
                                     "Out@GRAD": demb.to(dev)},
                ea, ctx)["W@GRAD"])
            return out
        kc.register_ring(102, tdist.group.WORLD)
        kc.reset_comm_stats()
        on_card = run(torch.device("cuda"))
        assert kc.COMM_STATS["calls_by_op"] == {
            "mp_allreduce_sum": 1, "c_identity_grad": 1, "c_concat": 1,
            "c_concat_grad": 1, "c_embedding": 1, "c_embedding_grad": 1}
        kc.register_ring(102, None)
        on_cpu = run(torch.device("cpu"))
        for op, (f, gr) in on_cpu.items():
            assert on_card[op][0].is_cuda
            assert torch.equal(on_card[op][0].cpu(), f), op
            assert torch.equal(on_card[op][1].cpu(), gr), op
    finally:
        kc.clear_rings()
        tdist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [1, 2])
def test_flash_composed_ring_matches_plain_ring(n, causal, dtype):
    """Ring attention's steps composed from the flash forward, dQ and
    dK/dV kernels (with the global lse), in one process over n blocks of
    the sequence, against the plain ring (the JAX step arithmetic and the
    plain backward kernels) on the same inputs: out, dq, dk, dv within
    TOL of max(1, max |plain|) (bf16: 3e-2, the blocks' outputs and
    gradients are rounded to bf16 before their fp32 merge)."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(n * 10 + causal)
    b, h, s, d = 2, 4, 256, 64
    q, k, v, do = (torch.randn(b, h, s, d, device="cuda", generator=gen)
                   .to(dtype) for _ in range(4))
    sl, scale = s // n, d ** -0.5

    def cut(t):
        return [t[:, :, i * sl:(i + 1) * sl].contiguous() for i in range(n)]

    def ring(kernels):
        fw = tattn.ring_blocks([
            tattn._ring_fwd_rank(*blk, i, n, causal, scale, kernels)
            for i, blk in enumerate(zip(cut(q), cut(k), cut(v)))])
        bw = tattn.ring_blocks([
            tattn._ring_bwd_rank(*blk, i, n, causal, scale, kernels)
            for i, blk in enumerate(zip(cut(q), cut(k), cut(v),
                                        [o for o, _ in fw],
                                        [lse for _, lse in fw], cut(do)))])
        return [torch.cat([o for o, _ in fw], 2)] + [
            torch.cat([g[j] for g in bw], 2) for j in range(3)]
    before = (tattn.flash_attention.launches,
              tattn.flash_attention_bwd_dq_cuda.launches)
    got, want = ring(True), ring(False)
    live = n * (n + 1) // 2 if causal else n * n
    assert tattn.flash_attention.launches - before[0] == live
    assert tattn.flash_attention_bwd_dq_cuda.launches - before[1] == live
    tol = 3e-2 if dtype == torch.bfloat16 else TOL[dtype]
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        err = float((a.float() - w.float()).abs().max()) / \
            max(1.0, float(w.float().abs().max()))
        assert err <= tol, (name, err)


def test_hoisted_run_steps_matches_unhoisted_on_the_card(monkeypatch):
    """The gradient-merge window hoisted (two captured graphs: the body
    gm-k times, then the commit tail) against PADDLE_TPU_SCAN_HOIST=0 (one
    captured step replayed K times), off a process group on the card:
    losses and every persistable equal to the last bit."""
    _need_cuda()
    import paddle_tpu_torch
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.ops.kernels import collective as kc
    from torch_dist_worker import build_zero_mlp
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(4, 8, 8).astype(np.float32),
            "y": rng.rand(4, 8, 1).astype(np.float32)}
    runs = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("PADDLE_TPU_SCAN_HOIST", mode)
        _reset_unique_names()
        main, startup, loss, _ = build_zero_mlp(paddle_tpu_torch, opt="adam",
                                                stage=2, dp=2, gm=2)
        cp = static.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
        exe, scope = static.Executor(), static.Scope()
        with static.scope_guard(scope):
            startup.random_seed = 1
            exe.run(startup)
            losses = []
            for _ in range(2):
                kc.reset_comm_stats()
                losses.append(exe.run_steps(cp, feed=feed,
                                            fetch_list=[loss])[0])
            assert cp._last_hoisted == (mode == "1")
            assert exe.cache_stats()["traces"] == 1
            runs[mode] = (np.concatenate(losses),
                          {n: t.clone() for n, t in scope.vars.items()
                           if t is not None})
            exe.close()
    (hl, hs), (ul, us) = runs["1"], runs["0"]
    assert hl.tobytes() == ul.tobytes()
    assert sorted(hs) == sorted(us)
    for n in hs:
        assert torch.equal(hs[n], us[n]), n


@pytest.mark.parametrize("n", [30522 * 768, 4096, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_philox_truncated_normal_matches_plain_version(n, dtype):
    """The truncated normal within 4 ulps of the plain version (the
    card's erfinvf against float64), inside [mean - 2 std, mean + 2
    std]."""
    _need_cuda()
    from paddle_tpu_torch.ops import random as trandom
    seed_t = torch.tensor([24680], dtype=torch.int64, device="cuda")
    before = trandom.random_cuda.launches_by_dist[trandom.TRUNC_NORMAL]
    got = trandom.truncated_normal((n,), dtype, 0.5, 0.02, seed_t, 9,
                                   "cuda")
    assert trandom.random_cuda.launches_by_dist[trandom.TRUNC_NORMAL] == \
        before + 1
    want = trandom.random_plain((n,), dtype, trandom.TRUNC_NORMAL, 0.5, 0.02,
                                seed_t.cpu(), 9)
    got = got.cpu()
    ulp = torch.finfo(dtype).eps * torch.maximum(want.float().abs(),
                                                 torch.tensor(0.02))
    assert ((got.float() - want.float()).abs() <= 4 * ulp).all()
    assert got.float().min() >= 0.46 - 1e-2 and got.float().max() <= 0.54 + \
        1e-2


@pytest.mark.parametrize("low,high", [(0, 30522), (-5, 5), (0, 1 << 32),
                                      (-(1 << 40), 1 << 40)])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_philox_randint_matches_plain_version(low, high, dtype):
    _need_cuda()
    from paddle_tpu_torch.ops import random as trandom
    if dtype == torch.int32 and high > (1 << 31):
        pytest.skip("int32 holds no such range")
    for seed in (torch.tensor([13579], dtype=torch.int64, device="cuda"),
                 77):
        before = trandom.randint_cuda.launches
        got = trandom.randint_draw((8, 513), dtype, low, high, seed, 4,
                                   "cuda")
        assert trandom.randint_cuda.launches == before + 1
        want = trandom.randint_plain((8, 513), dtype, low, high,
                                     seed.cpu() if torch.is_tensor(seed)
                                     else seed, 4)
        assert torch.equal(got.cpu(), want)
        assert int(want.min()) >= low and int(want.max()) < high


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_philox_bernoulli_matches_plain_version(dtype):
    _need_cuda()
    from paddle_tpu_torch.ops import random as trandom
    g = torch.Generator().manual_seed(0)
    p = torch.rand(8, 515, generator=g).to(dtype)
    seed_t = torch.tensor([11], dtype=torch.int64, device="cuda")
    before = trandom.bernoulli_cuda.launches
    got = trandom.bernoulli_draw(p.cuda(), seed_t, 21)
    assert trandom.bernoulli_cuda.launches == before + 1
    assert torch.equal(got.cpu(), trandom.bernoulli_plain(p, seed_t.cpu(),
                                                          21))
    # an odd-offset view reads element by element
    got = trandom.bernoulli_cuda(p.cuda()[:, 1:], seed_t, 21)
    assert torch.equal(got.cpu(), trandom.bernoulli_plain(p[:, 1:],
                                                          seed_t.cpu(), 21))
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        trandom.bernoulli_cuda(p.double().cuda(), seed_t, 21)


def test_philox_randperm_and_multinomial_on_the_card():
    """randperm and multinomial from the kernels' draws equal their CPU
    runs (the same words; the sort and the argmax are torch's)."""
    _need_cuda()
    from paddle_tpu_torch.ops import random as trandom
    perm = trandom.randperm(30522, torch.int64, 5, 3, "cuda")
    assert torch.equal(perm.cpu(), trandom.randperm(30522, torch.int64, 5,
                                                    3, "cpu"))
    assert torch.equal(perm.sort().values.cpu(), torch.arange(30522))
    probs = torch.tensor([[0.1, 0.2, 0.7], [0.5, 0.5, 0.0]])
    got = trandom.categorical(torch.log(probs.cuda() + 1e-12), 64, 8, 2,
                              "cuda")
    want = trandom.categorical(torch.log(probs + 1e-12), 64, 8, 2, "cpu")
    assert torch.equal(got.cpu(), want)


def test_tensor_orders_on_the_card_match_the_cpu():
    """top_k_v2 (ties to the lower index, XLA's total order over NaNs and
    signed zeros), argsort (stable, NaNs last), arg_max and unique (first
    occurrences) give the same results on the card as on the CPU."""
    _need_cuda()
    from paddle_tpu_torch.core.place import CPUPlace
    from paddle_tpu_torch.dygraph import guard
    import paddle_tpu_torch.tensor as T
    nan = float("nan")
    base = torch.tensor([[1.0, nan, 3.0, 3.0, 2.0, -nan, 0.0, -0.0],
                         [2.0, 2.0, 2.0, 1.0, 1.0, 5.0, 5.0, 0.0]])
    g = torch.Generator().manual_seed(1)
    ties = torch.randint(0, 4, (16, 300), generator=g).float()
    for x in (base, ties):
        with guard(CPUPlace()):
            want = [*T.topk(x, 5), *T.topk(x, 3, -1, False), T.argsort(x),
                    T.argsort(x, -1, True), T.argmax(x, 1), T.argmin(x, 1),
                    *T.unique(x, True, True, True)]
        xc = x.cuda()
        got = [*T.topk(xc, 5), *T.topk(xc, 3, -1, False), T.argsort(xc),
               T.argsort(xc, -1, True), T.argmax(xc, 1), T.argmin(xc, 1),
               *T.unique(xc, True, True, True)]
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b) or (
                a.is_floating_point() and torch.allclose(
                    a.cpu(), b, equal_nan=True)), (a, b)


def test_to_static_replay_with_dropout_reaches_every_parameter():
    """A recorded encoder with hidden dropout replayed on the card: every
    parameter gets a gradient (the dropout op's kernel is an autograd
    Function), and the replayed loss equals the eager one for the same
    draw."""
    _need_cuda()
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.core.place import CUDAPlace
    from paddle_tpu_torch.dygraph import guard
    with guard(CUDAPlace(0)):
        pt.seed(4)
        net = tnn.TransformerEncoderLayer(64, 4, 256, dropout=0.1)
        net.train()
        x = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(
            0)).cuda()
        sf = jit.StaticFunction(net.forward, layer=net)
        sf(x).sum().backward()
        missing = [n for n, p in net.named_parameters() if p.grad is None]
        assert not missing, missing


# ---------------------------------------------------------------------------
# the convolution, pooling, norm and interpolation tier
# ---------------------------------------------------------------------------
def _vision_tier_cases():
    """(op, inputs, attrs, cotangent slots) of the tier's op types at small
    shapes (chip_smoke.py's phase 21 (c) table), numpy inputs."""
    import chip_smoke
    return chip_smoke.ph21_op_cases(np.random.RandomState(27))


def test_vision_tier_ops_on_the_card_match_the_cpu():
    """Every op type of the convolution, pooling, norm and interpolation
    tier and its grad op on CUDA tensors against CPU tensors: fp32 within
    1e-5 (normalised max error), the bf16 convolutions within 2e-2."""
    _need_cuda()
    import chip_smoke
    out = chip_smoke.ph21_ops(torch)
    assert out["cases"] == len(_vision_tier_cases())
    assert out["ops"] >= 39


def test_vision_tier_layers_on_the_card_match_the_cpu():
    """Every new dygraph layer (convolutions, pools, norms, Upsample*,
    Bilinear, the transformer decoder) on the card against its CPU twin:
    forward and gradients within 1e-5 (normalised)."""
    _need_cuda()
    import chip_smoke
    assert chip_smoke.ph21_layers(torch, 0)["layers"] >= 30


def test_sync_batch_norm_under_nccl_at_world_one():
    """nn.SyncBatchNorm inside a one-rank NCCL process group equals
    BatchNorm2D over the same batch (1e-5 normalised); its statistics and
    gradient sums pass through 4 NCCL allreduces."""
    _need_cuda()
    import chip_smoke
    _nccl_world_one()
    try:
        out = chip_smoke.dp_nccl_sync_bn(torch, 0)
    finally:
        torch.distributed.destroy_process_group()
    assert out["allreduces"] == 4 and out["max_err"] <= 1e-5


def test_batch_norm_eval_backward_on_the_card():
    """batch_norm's gradient with the running statistics (eval mode,
    `use_global_stats`) on CUDA tensors: CUDA's native_batch_norm_backward
    asserts saved statistics there, so the port writes the inference-form
    gradient out; held against the same on the CPU (1e-5)."""
    _need_cuda()
    from paddle_tpu_torch.ops.registry import OpContext, run_kernel
    rng = np.random.RandomState(3)
    ins = {"X": rng.randn(4, 6, 5, 5), "Scale": rng.randn(6),
           "Bias": rng.randn(6), "Mean": rng.randn(6),
           "Variance": rng.rand(6) + 0.5}
    g = rng.randn(4, 6, 5, 5)
    outs = {}
    for dev in ("cuda", "cpu"):
        t = {k: torch.tensor(v, dtype=torch.float32, device=dev)
             for k, v in ins.items()}
        fwd = run_kernel("batch_norm", t, {"use_global_stats": True},
                         OpContext())
        t.update(fwd)
        t["Y@GRAD"] = torch.tensor(g, dtype=torch.float32, device=dev)
        outs[dev] = run_kernel("batch_norm_grad", t,
                               {"use_global_stats": True}, OpContext())
    for k in ("X@GRAD", "Scale@GRAD", "Bias@GRAD"):
        torch.testing.assert_close(outs["cuda"][k].cpu(), outs["cpu"][k],
                                   rtol=1e-5, atol=1e-5)
