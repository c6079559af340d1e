"""Attention: flash attention forward and backward (hand-written Hopper
kernels) and the plain score-matrix path.

Counterpart of paddle_tpu/ops/attention.py.  The flash dispatch flags
(`enable_flash_attention`, `set_flash_min_seq_len`, `use_flash_for`) are
kept with the same defaults, so a program built in either package takes
the same branch op for op.

`flash_attention(q, k, v)` over [B, H, S, D] tensors:
  * a CUDA tensor launches the forward kernel in csrc/flash_attn_fwd.cu
    (which replaces the Pallas `_flash_fwd_kernel`), or raises;
  * a CPU tensor runs `flash_attention_plain`, the same online-softmax
    algorithm written in PyTorch: a loop over 64-row K/V tiles with the
    same mask, fully-masked-row semantics and bf16 rounding of P.  The CPU
    tests use it, and chip_smoke.py holds the kernel against it.

The call is a `torch.autograd.Function` (counterpart of the JAX package's
`jax.custom_vjp`): its forward saves out and lse, its backward computes
D = rowsum(dO * O) as a torch op and then runs the two backward kernels
of csrc/flash_attn_bwd.cu, dQ and dK/dV (replacing `_flash_bwd_dq_kernel`
and `_flash_bwd_dkv_kernel`), or on the CPU their plain version
`flash_attention_bwd_plain`.

Which kernel runs, by dtype (dispatched inside each C entry):
  * bf16 (the AMP training program) and fp16: the forward, dQ and dK/dV
    are warp-specialized wgmma kernels fed by TMA (csrc/hopper.cuh holds
    the building blocks), one source for both 16-bit types.  At the
    training shape the forward is bounded by its bytes, dQ and dK/dV by
    their tensor-core operations; the tensor cores are reached at full
    rate only through wgmma, with operands in the swizzled shared-memory
    layout TMA writes.  TMA needs 16-byte aligned base addresses and byte
    strides that are multiples of 16: the wrappers copy a view that TMA
    refuses to a contiguous tensor first (counted in
    `flash_attention.view_copies`; the head-split views of the training
    program need no copy).  All three round P (and dS) to the input dtype
    before the second product, where the TPU kernels do;
  * fp32 (serving, fp32 training): the forward, dQ and dK/dV run on the
    tensor cores in 3xTF32 with `mma.sync` (each fp32 operand split into
    two TF32 halves and each product taken as hi*hi + hi*lo + lo*hi,
    accumulated in fp32: fp32-level error, not TF32's three digits).
    They take any strided fp32 view with a contiguous head dim (the
    split-D forward, dQ and dK/dV, from head dim 256 up, read through TMA:
    a view it refuses is copied first).

The kernels have instances for head dims 32, 64, 128 and 256, and a
split-D route for every multiple of 256 above it (the fp32 kernels' from
256 up).  Any other head dim is zero-padded up to the next of them (q, k,
v and dO along D; the scale stays 1/sqrt(real D)): up to 128 the next
instance, 129-255 to 256, above 256 the next multiple of 256 (320 ->
512).  out, dq, dk and dv are
sliced back: zero columns leave q k^T, lse and rowsum(dO * O) unchanged,
so this is exact, at the cost of the padded columns' bytes and
operations (a D = 96 head does the work of D = 128).  The kernel head
dim and the dtype select the kernel, each counted on its wrapper:
  * D <= 128: csrc/flash_attn_fwd.cu / flash_attn_bwd.cu (`launches`);
  * D = 256, bf16 and fp16: the same wgmma forward, dQ and dK/dV at
    D = 256 (`launches_wgmma256`);
  * D = 256 n, n >= 2, the bf16 and fp16 forward, dQ and dK/dV: the
    split-D wgmma kernels of csrc/flash_attn_fwd.cu / flash_attn_bwd.cu
    (`flash_fwd_split_d_wgmma_kernel`, `flash_bwd_dq_split_d_wgmma_kernel`,
    `flash_bwd_dkv_split_d_wgmma_kernel`), a CTA per chunk of the output
    (256 columns; dQ up to 512), the operands streamed as 64-column boxes
    through a TMA ring (`launches_wgmma_split_d`);
  * D = 256 n, n >= 1, the fp32 forward, dQ and dK/dV: 3xTF32
    `mma.sync` kernels of csrc/flash_attn_fwd.cu / flash_attn_bwd.cu
    (`flash_fwd_split_d_tf32_kernel`, `flash_bwd_dq_split_d_tf32_kernel`,
    `flash_bwd_dkv_split_d_tf32_kernel`), a CTA per chunk of the output
    (256 columns; dQ up to 512), the operands streamed as 32-column boxes
    through a TMA ring; an fp32 view TMA refuses is copied first, as in 16
    bits (`launches_tf32_split_d`).
    The split-D routes recompute the scores over all of D in each chunk's
    CTA, so the score work is n times its share (the fp32 kernels at
    D = 256 and the dQ at D = 512 compute them once).

Fully-masked rows (causal with Sq > Sk leaves the first Sq - Sk queries
no visible key) output ZERO on both flash paths, like the TPU flash
kernel; `reference_attention` averages V there instead.  Neither value is
meaningful; callers must not consume those rows.

The TPU kernel falls back to `reference_attention` for sequence lengths
that do not tile (`_fit_block`); the Hopper kernels mask ragged tiles and
take any length, so the port has no such fallback.

`ring_attention(q, k, v, group, causal)` is sequence-parallel attention
over a process group (the JAX package's over a mesh axis, `ppermute`
there, point-to-point sends here): each rank holds a [B, H, S/n, D]
shard, K/V rotate around the ring, causal masking uses global positions.
Each rank's ring is a generator that yields what it passes on
(`_ring_fwd_rank`, `_ring_bwd_rank`): `_drive` runs one over a group,
`ring_blocks` runs n of them in one process (the kernel checks).  On CUDA
every step is a flash kernel launch: the forward's (out, lse) merged in
fp32, the backward's dQ and dK/dV from the merged lse, the dK/dV sums
riding with their K/V block and one more hop home; on the CPU the plain
ring (the JAX step arithmetic) and the plain backward kernels.
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch

from ..core.dtype import dtype_name

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_cuda",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_bwd_dq_plain", "flash_attention_bwd_dkv_plain",
           "flash_attention_bwd_dq_cuda", "flash_attention_bwd_dkv_cuda",
           "reference_attention", "enable_flash_attention", "use_flash_for",
           "set_flash_min_seq_len", "FLASH_HEAD_DIMS", "kernel_head_dim",
           "kernel_operands", "tma_accepts", "LAUNCH_COUNTS",
           "ring_attention", "ring_blocks", "SP_RING_ID", "RING_STATS"]

# same defaults as paddle_tpu: "auto" takes flash only from 8192 up (a
# threshold that paddle_tpu measured on its TPU, kept so both packages
# build identical programs; the H100's own crossover is not measured yet)
_FLASH_STATE = {"mode": "auto", "min_seq_len": 8192}

FLASH_HEAD_DIMS = (32, 64, 128, 256)  # the kernels' instances; others pad up
_D256 = 256  # the widest instance; above it, split-D in 256-column chunks
_BLOCK_K = 64  # K/V tile of the plain version (the kernel's BK)
_BLOCK_Q = 64  # q tile of the plain dK/dV loop (the dkv kernel's BQ)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_TMA_DTYPES = (torch.bfloat16, torch.float16)  # the wgmma kernels' inputs
# route -> the dtypes in which its kernels read q, k, v and dO through TMA
# (in the others they read through strides)
_TMA_ROUTES = {"le128": _TMA_DTYPES, "wgmma256": _TMA_DTYPES,
               "wgmma_split_d": _TMA_DTYPES, "tf32_split_d": (torch.float32,)}


def enable_flash_attention(on: bool = True):
    """Force attention builders through (on=True) or away from (on=False)
    the flash op, overriding the seq-length auto-dispatch."""
    _FLASH_STATE["mode"] = "on" if on else "off"


def set_flash_min_seq_len(n: int):
    """Auto-dispatch crossover: sequences >= n take the flash op."""
    _FLASH_STATE["min_seq_len"] = int(n)


def use_flash_for(seq_len) -> bool:
    """Per-callsite dispatch decision: forced on/off wins; in auto mode a
    STATIC sequence length >= the crossover threshold selects flash."""
    if _FLASH_STATE["mode"] == "on":
        return True
    from ..core.flags import flag
    if bool(flag("use_flash_attention", False)):
        return True
    if _FLASH_STATE["mode"] == "off":
        return False
    if seq_len is None or not isinstance(seq_len, int) or seq_len <= 0:
        return False
    thr = int(flag("flash_min_seq_len", _FLASH_STATE["min_seq_len"]))
    return seq_len >= thr


def reference_attention(q, k, v, bias=None, causal=False, scale=None):
    """Plain softmax(QK^T)V with the [Sq, Sk] scores materialized.
    q, k, v: [B, H, S, D]."""
    d = q.shape[-1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.matmul(probs.to(q.dtype), v)


def flash_attention_plain(q, k, v, causal=False, scale=None):
    """The flash forward written in PyTorch: online softmax over 64-row
    K/V tiles, fp32 statistics and accumulator, bottom-right causal mask,
    fully-masked rows -> 0 with lse = -inf.  Returns (out in q.dtype,
    lse [B, H, Sq] fp32).  Computes in fp32 whatever the input dtype,
    except that P is rounded to the input dtype before the P.v product
    (the TPU kernel's `p.astype(vs.dtype)`); the row sum stays on the fp32
    P."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    qf = q.float()
    m = torch.full((b, h, sq, 1), -math.inf, device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    for k0 in range(0, sk, _BLOCK_K):
        ks = k[:, :, k0:k0 + _BLOCK_K].float()
        vs = v[:, :, k0:k0 + _BLOCK_K].float()
        s = torch.matmul(qf, ks.transpose(-1, -2)) * scale
        if causal:
            kpos = torch.arange(k0, k0 + ks.shape[2], device=q.device)[None]
            s = s.masked_fill(qpos < kpos, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        live = torch.isfinite(m_new)
        safe = torch.where(live, m_new, torch.zeros_like(m_new))
        p = torch.where(live, torch.exp(s - safe), torch.zeros_like(s))
        alpha = torch.where(torch.isfinite(m), torch.exp(m - safe),
                            torch.zeros_like(m))
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.matmul(p.to(q.dtype).float(), vs)
        m = m_new
    denom = l.clamp_min(1e-30)
    out = (acc / denom).to(q.dtype)
    lse = torch.where(torch.isfinite(m), m + torch.log(denom),
                      torch.full_like(m, -math.inf))
    return out, lse.squeeze(-1)


def _check_cuda_args(q, k, v):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention kernels take float32, bfloat16 or "
                        f"float16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention expects [B, H, S, D] tensors")
    b, h, _, d = q.shape
    kernel_head_dim(d)
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"flash_attention shape mismatch: q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    if not (k.device == v.device == q.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention kernel needs a contiguous "
                             f"head dim; {name} has stride {t.stride(3)}")
    if b > 65535 or h > 65535:
        raise ValueError("flash_attention kernel: B and H must be <= 65535")


def kernel_head_dim(d):
    """The head dim of the kernel that runs head dim d: the next of
    FLASH_HEAD_DIMS, above 256 the next multiple of 256 (the split-D
    route); d itself when it is one of them."""
    if d <= 0:
        raise ValueError(f"flash_attention kernels need a positive head "
                         f"dim, got {d}")
    for dp in FLASH_HEAD_DIMS:
        if d <= dp:
            return dp
    return -(-d // _D256) * _D256


def tma_accepts(t):
    """Whether the 16-bit kernels' TMA tensor maps take the view t: a
    16-byte aligned base address, and byte strides that are multiples of
    16 along batch, head and sequence (a dim of length 1 has no stride
    that TMA uses)."""
    if t.data_ptr() % 16:
        return False
    return all(t.shape[dim] <= 1 or (t.stride(dim) * t.element_size()) % 16
               == 0 for dim in range(3))


def _route(kind, dp, dtype):
    """Which kernel runs `kind` ("fwd", "bwd_dq" or "bwd_dkv") at kernel
    head dim dp in `dtype`: "le128" (csrc/flash_attn_fwd.cu /
    flash_attn_bwd.cu), "wgmma256" (the same files' 16-bit wgmma kernels
    at D = 256), "wgmma_split_d" (the 16-bit split-D wgmma forward, dQ and
    dK/dV of the same files at D = 256 n, n >= 2) or "tf32_split_d" (the
    fp32 3xTF32 split-D forward, dQ and dK/dV of the same files at
    D = 256 n, n >= 1)."""
    if dp < _D256:
        return "le128"
    if dtype in _TMA_DTYPES:
        return "wgmma256" if dp == _D256 else "wgmma_split_d"
    return "tf32_split_d"


def kernel_operands(d, *tensors, kind="fwd"):
    """The [B, H, S, d] tensors as kernel `kind` takes them: zero-padded
    along D up to kernel_head_dim(d) (a new contiguous tensor), and a
    view that TMA refuses copied to a contiguous tensor (counted in
    flash_attention.view_copies) where that kernel reads through TMA (the
    16-bit kernels, and the fp32 split-D forward, dQ and dK/dV from head
    dim 256 up; the fp32 kernels up to 128 read through strides and take
    any view).  Returns the kernel's head dim and the tensors."""
    dp = kernel_head_dim(d)
    out = []
    for t in tensors:
        if dp != d:
            t = torch.nn.functional.pad(t, (0, dp - d)).contiguous()
        elif t.dtype in _TMA_ROUTES.get(_route(kind, dp, t.dtype), ()) \
                and not tma_accepts(t):
            t = t.clone(memory_format=torch.contiguous_format)
            flash_attention.view_copies += 1
        out.append(t)
    return dp, out


def _kernel_lib():
    from ..core.kernel_build import load_library
    lib = load_library("flash_attn_fwd")
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attn_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                       ll, ll, ll, ll, ll, ll, ll, ll, ll,
                                       i, ctypes.c_float, p]
        lib.flash_attn_fwd.restype = i
        lib.flash_attn_error_string.argtypes = [i]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


# backward kernel -> its C entry in flash_attn_bwd.cu
_ENTRIES = {"bwd_dq": "flash_attn_bwd_dq", "bwd_dkv": "flash_attn_bwd_dkv"}
# route (see _route) -> the wrapper's launch count
LAUNCH_COUNTS = {"le128": "launches", "wgmma256": "launches_wgmma256",
                 "wgmma_split_d": "launches_wgmma_split_d",
                 "tf32_split_d": "launches_tf32_split_d"}


def _kernel_entry(kind, dp, dtype):
    """The C entry of kernel `kind` ("fwd", "bwd_dq" or "bwd_dkv") at the
    kernel head dim dp in `dtype`, its library's error-string function and
    the name of the wrapper's launch count (LAUNCH_COUNTS[_route])."""
    count = LAUNCH_COUNTS[_route(kind, dp, dtype)]
    if kind == "fwd":
        lib = _kernel_lib()
        return lib.flash_attn_fwd, lib.flash_attn_error_string, count
    lib = _bwd_kernel_lib()
    return (getattr(lib, _ENTRIES[kind]), lib.flash_attn_bwd_error_string,
            count)


def _launch(wrapper, kind, dp, dtype, device, *args):
    """Launch kernel `kind` at kernel head dim dp in `dtype` with `args` on
    the current stream of `device`; raise on a CUDA error, else add one to
    the wrapper's launch count of that kernel and to its count of launches
    in `dtype` (`dtype_launches`, keyed "float32", "bfloat16", ...)."""
    fn, err_string, count = _kernel_entry(kind, dp, dtype)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err} "
                           f"({err_string(err).decode()})")
    setattr(wrapper, count, getattr(wrapper, count) + 1)
    wrapper.dtype_launches[dtype_name(dtype)] += 1


def flash_attention_cuda(q, k, v, causal=False, scale=None):
    """Launch the Hopper kernel on CUDA tensors.  Returns (out, lse)."""
    if not q.is_cuda:
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    _check_cuda_args(q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = (1.0 / math.sqrt(d)) if scale is None else float(scale)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return torch.empty_like(q, memory_format=torch.contiguous_format), \
            lse
    dp, (q, k, v) = kernel_operands(d, q, k, v, kind="fwd")
    out = torch.empty((b, h, sq, dp), dtype=q.dtype, device=q.device)
    _launch(flash_attention, "fwd", dp, q.dtype, q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _DTYPE_CODE[q.dtype], b, h, sq, sk, dp,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(bool(causal)), scale)
    return (out if dp == d else out[..., :d]), lse


def _bwd_tiles(q, k, v, do, lse, dd, causal, scale):
    """fp32 operands and a function giving P and dS of one (q rows, keys)
    tile: P recomputed from q, k and lse (0 on rows whose lse is -inf),
    dS = P * (dP - D)."""
    sq, sk = q.shape[2], k.shape[2]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    live = torch.isfinite(lse)[..., None]                 # [B, H, Sq, 1]
    safe_lse = torch.where(live, lse[..., None],
                           torch.zeros_like(lse)[..., None])
    ddc = dd[..., None]

    def tile(q0, q1, k0, k1):
        s = torch.matmul(qf[:, :, q0:q1],
                         kf[:, :, k0:k1].transpose(-1, -2)) * scale
        if causal:
            qpos = torch.arange(q0, q1, device=q.device)[:, None] + (sk - sq)
            kpos = torch.arange(k0, k1, device=q.device)[None]
            s = s.masked_fill(qpos < kpos, -math.inf)
        p = torch.where(live[:, :, q0:q1],
                        torch.exp(s - safe_lse[:, :, q0:q1]),
                        torch.zeros_like(s))
        dp = torch.matmul(dof[:, :, q0:q1], vf[:, :, k0:k1].transpose(-1, -2))
        return p, p * (dp - ddc[:, :, q0:q1])

    return qf, kf, dof, tile


def flash_attention_bwd_dq_plain(q, k, v, do, lse, dd, causal=False,
                                 scale=None):
    """The dQ kernel written in PyTorch: a loop over 64-row K/V tiles,
    dQ += scale * dS k, in fp32 except that dS is rounded to the input
    dtype before the product (the TPU kernel's `ds.astype(ks.dtype)`; in
    fp32 the rounding is the identity).  `dd` is D = rowsum(dO * O)
    [B, H, Sq] fp32.  Returns dq in the input dtype."""
    scale = (1.0 / math.sqrt(q.shape[3])) if scale is None else scale
    sq, sk = q.shape[2], k.shape[2]
    _, kf, _, tile = _bwd_tiles(q, k, v, do, lse, dd, causal, scale)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, _BLOCK_K):
        k1 = min(k0 + _BLOCK_K, sk)
        _, ds = tile(0, sq, k0, k1)
        ds = ds.to(q.dtype).float()
        dq = dq + torch.matmul(ds, kf[:, :, k0:k1]) * scale
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, dd, causal=False,
                                  scale=None):
    """The dK/dV kernel written in PyTorch: a loop over 64-row q tiles,
    dV += P^T dO and dK += scale * dS^T q, in fp32 except that P and dS
    are rounded to the input dtype before the two products (the TPU
    kernel's `p.astype(do.dtype)`, `.astype(q.dtype)`).  Returns (dk, dv)
    in the input dtype."""
    scale = (1.0 / math.sqrt(q.shape[3])) if scale is None else scale
    sq, sk = q.shape[2], k.shape[2]
    qf, _, dof, tile = _bwd_tiles(q, k, v, do, lse, dd, causal, scale)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for q0 in range(0, sq, _BLOCK_Q):
        q1 = min(q0 + _BLOCK_Q, sq)
        p, ds = (x.to(q.dtype).float() for x in tile(q0, q1, 0, sk))
        dv = dv + torch.matmul(p.transpose(-1, -2), dof[:, :, q0:q1])
        dk = dk + torch.matmul(ds.transpose(-1, -2), qf[:, :, q0:q1]) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, do, lse, dd, causal=False,
                              scale=None):
    """Both backward kernels' plain versions: (dq, dk, dv)."""
    dq = flash_attention_bwd_dq_plain(q, k, v, do, lse, dd, causal, scale)
    return (dq,) + flash_attention_bwd_dkv_plain(q, k, v, do, lse, dd,
                                                 causal, scale)


def _bwd_kernel_lib():
    from ..core.kernel_build import load_library
    lib = load_library("flash_attn_bwd")
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        tail = [i] * 6 + [ll] * 12 + [i, ctypes.c_float, p]
        lib.flash_attn_bwd_dq.argtypes = [p] * 7 + tail
        lib.flash_attn_bwd_dkv.argtypes = [p] * 8 + tail
        lib.flash_attn_bwd_dq.restype = i
        lib.flash_attn_bwd_dkv.restype = i
        lib.flash_attn_bwd_error_string.argtypes = [i]
        lib.flash_attn_bwd_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check_bwd_args(q, k, v, do, lse, dd):
    if not q.is_cuda:
        raise ValueError(f"the flash backward kernels need CUDA tensors, "
                         f"got {q.device}")
    _check_cuda_args(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.stride(3) != 1:
        raise ValueError(f"flash backward: dO must match q {tuple(q.shape)} "
                         f"{q.dtype} with a contiguous head dim, got "
                         f"{tuple(do.shape)} {do.dtype} strides "
                         f"{do.stride()}")
    for name, t in (("lse", lse), ("D", dd)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"flash backward: {name} must be a contiguous "
                             f"fp32 [B, H, Sq] tensor, got {tuple(t.shape)} "
                             f"{t.dtype}")
    if not (do.device == lse.device == dd.device == q.device):
        raise ValueError("flash backward: inputs on different devices")


def _bwd_launch(wrapper, kind, outs, q, k, v, do, lse, dd, causal, scale):
    """Launch backward kernel `kind` on kernel operands (kernel_operands)
    into `outs`, which have the kernel's head dim."""
    b, h, sq, d = q.shape
    strides = [t.stride(i) for t in (q, k, v, do) for i in range(3)]
    _launch(wrapper, kind, d, q.dtype, q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dd.data_ptr(), *[t.data_ptr() for t in outs],
            _DTYPE_CODE[q.dtype], b, h, sq, k.shape[2], d, *strides,
            int(bool(causal)), float(scale))


def flash_attention_bwd_dq_cuda(q, k, v, do, lse, dd, causal=False,
                                scale=None):
    """Launch the dQ kernel (csrc/flash_attn_bwd.cu) on CUDA tensors."""
    _check_bwd_args(q, k, v, do, lse, dd)
    d = q.shape[3]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    if q.numel() == 0 or k.shape[2] == 0:
        return torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    dp, (q, k, v, do) = kernel_operands(d, q, k, v, do, kind="bwd_dq")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch(flash_attention_bwd_dq_cuda, "bwd_dq", (dq,), q, k, v, do,
                lse, dd, causal, scale)
    return dq if dp == d else dq[..., :d]


def flash_attention_bwd_dkv_cuda(q, k, v, do, lse, dd, causal=False,
                                 scale=None):
    """Launch the dK/dV kernel (csrc/flash_attn_bwd.cu) on CUDA tensors."""
    _check_bwd_args(q, k, v, do, lse, dd)
    d = q.shape[3]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    if k.numel() == 0 or q.shape[2] == 0:
        return (torch.zeros(k.shape, dtype=k.dtype, device=k.device),
                torch.zeros(v.shape, dtype=v.dtype, device=v.device))
    dp, (q, k, v, do) = kernel_operands(d, q, k, v, do, kind="bwd_dkv")
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _bwd_launch(flash_attention_bwd_dkv_cuda, "bwd_dkv", (dk, dv), q, k, v,
                do, lse, dd, causal, scale)
    if dp != d:
        dk, dv = dk[..., :d], dv[..., :d]
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, do, causal=False, scale=None):
    """(dq, dk, dv) of flash attention from the saved out and lse: D =
    rowsum(dO * O) in fp32 (a torch op, as the JAX package leaves it to
    XLA), then the dQ and dK/dV kernels on CUDA tensors, their plain
    version on CPU tensors."""
    if do.stride(-1) != 1:
        do = do.contiguous()
    dd = (do.float() * out.float()).sum(-1)
    if q.is_cuda:
        dq = flash_attention_bwd_dq_cuda(q, k, v, do, lse, dd, causal, scale)
        dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, dd, causal,
                                              scale)
        return dq, dk, dv
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, lse, dd, causal, scale)
    raise RuntimeError(f"flash_attention: no kernel for device {q.device}")


def _flash_fwd(q, k, v, causal, scale):
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    raise RuntimeError(f"flash_attention: no kernel for device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its backward kernels (the port's counterpart
    of `jax.custom_vjp` around `_flash`).  New-style forward /
    setup_context, so torch.func.vjp (the grad ops' replay) reaches the
    backward."""

    @staticmethod
    def forward(q, k, v, causal, scale):
        return _flash_fwd(q, k, v, causal, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, scale = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _FlashAttentionBwd.apply(q, k, v, out, lse, g_out,
                                              ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


class _FlashAttentionBwd(torch.autograd.Function):
    """The backward kernels as a Function of their own.  Inside
    torch.func.vjp, `_FlashAttention.backward` is handed functorch's
    wrapper tensors, which have no data pointer for a kernel; a Function's
    forward is handed the plain tensors underneath.  Not differentiable
    (the JAX package's Pallas backward has no grad either)."""

    @staticmethod
    def forward(q, k, v, out, lse, do, causal, scale):
        return flash_attention_bwd(q, k, v, out, lse, do, causal, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash attention has no double backward")


def flash_attention(q, k, v, bias=None, causal=False, scale=None,
                    return_lse=False):
    """Flash attention over [B, H, S, D] tensors, differentiable.  `bias`
    forces the score-matrix path (as in paddle_tpu).  Mixed q/k/v dtypes
    promote to a common dtype first.  CUDA tensors go to the Hopper
    kernels, CPU tensors to their plain versions; any other device
    raises."""
    if bias is not None:
        return reference_attention(q, k, v, bias=bias, causal=causal,
                                   scale=scale)
    cdt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    q, k, v = q.to(cdt), k.to(cdt), v.to(cdt)
    scale = (1.0 / math.sqrt(q.shape[-1])) if scale is None else float(scale)
    out, lse = _FlashAttention.apply(q, k, v, bool(causal), scale)
    return (out, lse) if return_lse else out


# launches of each Hopper kernel in this process, one count per route
# (LAUNCH_COUNTS) and one per dtype (`dtype_launches`, a Counter), and the
# copies of views that TMA refuses (callers reset them to 0 around the run
# they want to count)
for _wrapper in (flash_attention, flash_attention_bwd_dq_cuda,
                 flash_attention_bwd_dkv_cuda):
    for _count in LAUNCH_COUNTS.values():
        setattr(_wrapper, _count, 0)
    _wrapper.dtype_launches = collections.Counter()
flash_attention.view_copies = 0


# ---------------------------------------------------------------------------
# ring attention (sequence parallel)
# ---------------------------------------------------------------------------
# the ring id of the sequence-parallel group (user groups from
# distributed.new_group start at 1 and must not collide), as in paddle_tpu
SP_RING_ID = 101
# K/V bytes this process sent around a ring, and the ring steps it ran
# (each step one block of work, live or skipped); callers reset them
RING_STATS = {"bytes_sent": 0, "steps": 0}


def _ring_fwd_rank(q, k, v, me, n, causal, scale, flash):
    """One rank's forward ring as a generator: it yields the K/V block to
    pass on (and gets back a function that waits for the next one), and
    returns (out in q.dtype, lse fp32 [B, H, S]).

    `flash=False` is the JAX package's step arithmetic (fp32 scores, P
    rounded to V's dtype, an unnormalised fp32 accumulator divided at the
    end).  `flash=True` composes each step from the forward kernel:
    (out, lse) of the block, merged into fp32 running statistics; a block
    whose keys all lie after the queries (causal, src > me) is skipped,
    the diagonal block (src == me) runs causal."""
    b, h, s_loc, d = q.shape
    dev = q.device
    m = torch.full((b, h, s_loc, 1), -math.inf, device=dev)
    l = torch.zeros((b, h, s_loc, 1), device=dev)
    acc = torch.zeros((b, h, s_loc, d), device=dev)
    qf = q.float()
    qpos = me * s_loc + torch.arange(s_loc, device=dev)[:, None]
    ks, vs = k, v
    for step in range(n):
        src = (me - step) % n
        wait = (yield (ks, vs)) if step < n - 1 else None
        RING_STATS["steps"] += 1
        if not (causal and src > me):
            if flash:
                ob, lb = _flash_fwd(q, ks, vs, causal and src == me, scale)
                lb = lb[..., None]
                m_new = torch.maximum(m, lb)
                a = torch.where(torch.isfinite(m), torch.exp(m - m_new),
                                torch.zeros_like(m))
                w = torch.where(torch.isfinite(lb), torch.exp(lb - m_new),
                                torch.zeros_like(lb))
                l = l * a + w
                acc = acc * a + ob.float() * w
            else:
                s = torch.matmul(qf, ks.float().transpose(-1, -2)) * scale
                if causal:
                    kpos = src * s_loc + torch.arange(s_loc,
                                                      device=dev)[None]
                    s = s.masked_fill(qpos < kpos, -math.inf)
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                live = torch.isfinite(m_new)
                safe = torch.where(live, m_new, torch.zeros_like(m_new))
                p = torch.where(live, torch.exp(s - safe),
                                torch.zeros_like(s))
                a = torch.where(torch.isfinite(m), torch.exp(m - safe),
                                torch.zeros_like(m))
                l = a * l + p.sum(dim=-1, keepdim=True)
                acc = a * acc + torch.matmul(p.to(vs.dtype).float(),
                                             vs.float())
            m = m_new
        if wait is not None:
            ks, vs = wait()
    # (with flash the statistics merged are the blocks' lse: m and l are
    # then the running max and sum of exp(lse_b - m), and m + log l the
    # global lse either way)
    denom = l.clamp_min(1e-30)
    lse = torch.where(torch.isfinite(m), m + torch.log(denom),
                      torch.full_like(m, -math.inf))
    return (acc / denom).to(q.dtype), lse.squeeze(-1)


def _ring_bwd_rank(q, k, v, out, lse, do, me, n, causal, scale, kernels):
    """One rank's backward ring as a generator (the forward's protocol):
    D = rowsum(dO * O) once, then per step the dQ and dK/dV of the block
    held, both from the GLOBAL lse (a block's own lse would give a wrong
    gradient that still looks plausible): the kernels of
    csrc/flash_attn_bwd.cu (`kernels=True`) or their plain versions.  dQ
    sums in fp32 here; the dK/dV sums (fp32) travel with their K/V block
    and take one more hop home after the last step.  Returns (dq, dk, dv)
    in the input dtypes."""
    if do.stride(-1) != 1:
        do = do.contiguous()
    dd = (do.float() * out.float()).sum(-1)
    lse = lse.contiguous()
    if kernels:
        dq_fn, dkv_fn = flash_attention_bwd_dq_cuda, \
            flash_attention_bwd_dkv_cuda
    else:
        dq_fn, dkv_fn = flash_attention_bwd_dq_plain, \
            flash_attention_bwd_dkv_plain
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dvs = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    ks, vs = k, v
    for step in range(n):
        src = (me - step) % n
        if not (causal and src > me):
            c = causal and src == me
            dq = dq + dq_fn(q, ks, vs, do, lse, dd, c, scale).float()
            dk_b, dv_b = dkv_fn(q, ks, vs, do, lse, dd, c, scale)
            dks = dks + dk_b.float()
            dvs = dvs + dv_b.float()
        if step < n - 1:
            ks, vs, dks, dvs = (yield (ks, vs, dks, dvs))()
    if n > 1:
        # the sums of the block that came from rank me + 1 go home
        dks, dvs = (yield (dks, dvs))()
    return dq.to(q.dtype), dks.to(k.dtype), dvs.to(v.dtype)


def _drive(gen, group):
    """Run one rank's ring generator over `group`: each yielded list of
    tensors goes to the next rank while the previous rank's arrives,
    send and receive posted together (batch_isend_irecv, so the ring
    cannot deadlock).  Under gloo CUDA tensors go through host copies."""
    import torch.distributed as dist
    from .kernels.collective import rank_of, world_of
    if group is None:
        return ring_blocks([gen])[0]
    n, me = world_of(group), rank_of(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    stage = dist.get_backend(group) == "gloo"
    try:
        outgoing = next(gen)
        while True:
            sends = [t.contiguous() for t in outgoing]
            devs = [t.device for t in sends]
            if stage:
                sends = [t.cpu() for t in sends]
            recvs = [torch.empty_like(t) for t in sends]
            ops = [dist.P2POp(dist.isend, t, nxt, group, tag=i)
                   for i, t in enumerate(sends)] + \
                [dist.P2POp(dist.irecv, t, prv, group, tag=i)
                 for i, t in enumerate(recvs)]
            reqs = dist.batch_isend_irecv(ops)
            RING_STATS["bytes_sent"] += sum(t.numel() * t.element_size()
                                            for t in sends)

            def wait(reqs=reqs, recvs=recvs, devs=devs):
                for r in reqs:
                    r.wait()
                return [t.to(dv) for t, dv in zip(recvs, devs)]
            outgoing = gen.send(wait)
    except StopIteration as e:
        return e.value


def ring_blocks(gens):
    """Run n ranks' ring generators in one process, in lockstep: rank i
    receives what rank i - 1 yielded.  Returns their results in rank
    order (the n-block decomposition without a process group: the kernel
    checks, and a ring off a process group)."""
    n = len(gens)
    outgoing, results = [None] * n, [None] * n

    def advance(i, wait):
        try:
            outgoing[i] = gens[i].send(wait)
            return False
        except StopIteration as e:
            results[i] = e.value
            return True

    done = [advance(i, None) for i in range(n)]
    while not all(done):
        sent = list(outgoing)
        done = [advance(i, lambda i=i: list(sent[(i - 1) % n]))
                for i in range(n)]
    return results


def _ring_kernels(q):
    """Whether a ring on `q` runs the flash kernels (CUDA) or the plain
    versions (CPU); any other device raises."""
    if q.is_cuda:
        return True
    if q.device.type == "cpu":
        return False
    raise RuntimeError(f"ring_attention: no kernel for device {q.device}")


class _RingAttention(torch.autograd.Function):
    """Ring attention over the sp group, with a backward that runs the
    reverse ring (a replay of the forward's point-to-point sends by
    autograd would post them in the wrong order)."""

    @staticmethod
    def forward(q, k, v, group, causal, scale):
        from .kernels.collective import rank_of, world_of
        flash = _ring_kernels(q)
        gen = _ring_fwd_rank(q, k, v, rank_of(group), world_of(group),
                             causal, scale, flash)
        return _drive(gen, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, group, causal, scale = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _RingAttentionBwd.apply(q, k, v, out, lse, g_out,
                                             ctx.group, ctx.causal,
                                             ctx.scale)
        return dq, dk, dv, None, None, None


class _RingAttentionBwd(torch.autograd.Function):
    """The backward ring as a Function of its own (plain tensors for the
    kernels inside torch.func.vjp, as `_FlashAttentionBwd`)."""

    @staticmethod
    def forward(q, k, v, out, lse, do, group, causal, scale):
        from .kernels.collective import rank_of, world_of
        gen = _ring_bwd_rank(q, k, v, out, lse, do, rank_of(group),
                             world_of(group), causal, scale,
                             _ring_kernels(q))
        return _drive(gen, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("ring attention has no double backward")


def ring_attention(q, k, v, group, causal=False, scale=None):
    """Sequence-parallel attention over the process group `group` (the
    JAX package's `ring_attention` over a mesh axis): each rank holds
    [B, H, S/n, D] shards of q, k and v (rank r the rows
    [r S/n, (r+1) S/n)), K/V rotate around the ring, causal masking uses
    GLOBAL positions and a fully masked block contributes 0.
    Differentiable.  CUDA tensors compose each step from the flash
    kernels (forward; dQ and dK/dV with the global lse); CPU tensors run
    the plain ring (the JAX step arithmetic; the plain backward kernels).
    In 16 bits the two differ by the rounding of each block's output to
    the storage dtype before the merge (and of each block's dQ, dK, dV
    before their fp32 sums) on the kernel path."""
    cdt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    q, k, v = q.to(cdt), k.to(cdt), v.to(cdt)
    scale = (1.0 / math.sqrt(q.shape[-1])) if scale is None else float(scale)
    out, _ = _RingAttention.apply(q, k, v, group, bool(causal), scale)
    return out
