"""Fused softmax-cross-entropy: hard-label loss in one streaming pass over
the vocabulary (hand-written Hopper kernel).

Counterpart of paddle_tpu/ops/fused_xent.py.  `fused_softmax_xent(logits
[T, V], label [T])` returns the loss [T] in fp32 without materializing
the softmax:
  * a CUDA tensor launches the kernel in csrc/fused_xent_fwd.cu (which
    replaces the Pallas `_fused_xent_kernel`), or raises;
  * a CPU (or meta) tensor runs `fused_xent_plain`, the same online
    max / sumexp / picked-logit sweep written in PyTorch over 2048-column
    vocab blocks.
Semantics of both (those of the TPU kernel): loss = lse - logit[label];
loss = 0 where label == ignore_index, whatever its sign; a label outside
[0, V) that is not ignore_index picks nothing, so loss = lse; lse is
written for every row.

The backward (the JAX package's `_bwd`, plain XLA there) stays torch ops:
dlogits = (exp(logits - lse) - onehot) * dy, with dy zeroed on ignored
rows, in one pass over the logits.  The call is a
`torch.autograd.Function`.

`maybe_fused_xent` is the dispatch hook of the softmax_with_cross_entropy
kernel.  It keeps the JAX package's flag, hard-label and last-axis
conditions and drops two (ROADMAP.md, "When fused CE engages"): the port
has no trace, so "only when traced" is gone (the Softmax output becomes a
zero-stride expand of a 0-d zero, which allocates nothing), and
`lead % 8 == 0`, a TPU sublane constraint, is gone because the CUDA
kernel handles one row per block.
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch

from ..core.dtype import dtype_name

__all__ = ["fused_softmax_xent", "fused_xent_plain", "fused_xent_cuda",
           "fused_xent_bwd", "maybe_fused_xent", "fused_xent_enabled",
           "enable_fused_xent"]

_BLOCK_V = 2048  # vocab block of the plain version (the TPU kernel's bv)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def fused_xent_plain(logits, label, ignore_index=-100):
    """The fused forward written in PyTorch: an online max / sumexp over
    2048-column vocab blocks and the picked logit, fp32 throughout.
    Returns (loss [T], lse [T]), both fp32."""
    t, v = logits.shape
    lbl = label.reshape(t).long()
    m = torch.full((t,), -math.inf, device=logits.device)
    s = torch.zeros((t,), device=logits.device)
    picked = torch.zeros((t,), device=logits.device)
    for v0 in range(0, v, _BLOCK_V):
        chunk = logits[:, v0:v0 + _BLOCK_V].float()
        m_new = torch.maximum(m, chunk.amax(dim=1))
        safe = torch.where(torch.isfinite(m_new), m_new,
                           torch.zeros_like(m_new))
        alpha = torch.where(torch.isfinite(m), torch.exp(m - safe),
                            torch.zeros_like(m))
        s = alpha * s + torch.exp(chunk - safe[:, None]).sum(dim=1)
        m = m_new
        cols = torch.arange(v0, v0 + chunk.shape[1], device=logits.device)
        hit = cols[None] == lbl[:, None]
        picked = picked + torch.where(hit, chunk,
                                      torch.zeros_like(chunk)).sum(dim=1)
    lse = torch.where(torch.isfinite(m), m + torch.log(s.clamp_min(1e-30)),
                      torch.full_like(m, -math.inf))
    loss = torch.where(lbl == ignore_index, torch.zeros_like(lse),
                       lse - picked)
    return loss, lse


def _kernel_lib():
    from ..core.kernel_build import load_library
    lib = load_library("fused_xent_fwd")
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fused_xent_fwd.argtypes = [p, p, p, p, i, i, i, ll, ll, p]
        lib.fused_xent_fwd.restype = i
        lib.fused_xent_error_string.argtypes = [i]
        lib.fused_xent_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def fused_xent_cuda(logits, label, ignore_index=-100):
    """Launch the Hopper kernel on CUDA tensors: logits [T, V] fp32, bf16
    or fp16 with a contiguous vocab dim (any row stride), label [T] int64.
    Returns (loss [T], lse [T]), both fp32."""
    if not logits.is_cuda:
        raise ValueError(f"fused_xent_cuda needs CUDA tensors, got "
                         f"{logits.device}")
    if logits.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_xent kernel takes float32, bfloat16 or "
                        f"float16 logits, got {logits.dtype}")
    if logits.dim() != 2 or logits.stride(1) != 1:
        raise ValueError(f"fused_xent kernel needs [T, V] logits with a "
                         f"contiguous vocab dim, got {tuple(logits.shape)} "
                         f"strides {logits.stride()}")
    t, v = logits.shape
    if v == 0 or v > 2 ** 31 - 1:
        raise ValueError(f"fused_xent kernel: vocab size {v} out of range")
    if label.numel() != t or label.device != logits.device or \
            label.dtype != torch.int64:
        raise ValueError(f"fused_xent kernel needs int64 labels [T={t}] on "
                         f"{logits.device}, got {tuple(label.shape)} "
                         f"{label.dtype} on {label.device}")
    label = label.reshape(t).contiguous()
    loss = torch.empty((t,), dtype=torch.float32, device=logits.device)
    lse = torch.empty((t,), dtype=torch.float32, device=logits.device)
    if t == 0:
        return loss, lse
    lib = _kernel_lib()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.fused_xent_fwd(
            logits.data_ptr(), label.data_ptr(), loss.data_ptr(),
            lse.data_ptr(), _DTYPE_CODE[logits.dtype], t, v,
            logits.stride(0), int(ignore_index), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_xent_fwd launch failed: CUDA error {err} "
            f"({lib.fused_xent_error_string(err).decode()})")
    fused_xent_cuda.launches += 1
    fused_xent_cuda.dtype_launches[dtype_name(logits.dtype)] += 1
    return loss, lse


def fused_xent_bwd(logits, label, lse, dy, ignore_index=-100):
    """dlogits = (exp(logits - lse) - onehot(label)) * dy, dy zeroed on
    ignored rows (the JAX package's `_bwd`, label clipped into [0, V) for
    the one-hot as there).  Returns dlogits in the logits dtype."""
    t, v = logits.shape
    lbl = label.reshape(t).long()
    dyf = dy.reshape(t).float()
    dyf = torch.where(lbl == ignore_index, torch.zeros_like(dyf), dyf)
    d = torch.exp(logits.float() - lse[:, None]) * dyf[:, None]
    d.index_put_((torch.arange(t, device=d.device), lbl.clamp(0, v - 1)),
                 -dyf, accumulate=True)
    return d.to(logits.dtype)


class _FusedXent(torch.autograd.Function):
    """Fused cross-entropy with its backward (the port's counterpart of
    the JAX package's `jax.custom_vjp` around `fused_softmax_xent`)."""

    @staticmethod
    def forward(logits, label, ignore_index):
        if logits.is_cuda:
            return fused_xent_cuda(logits, label, ignore_index)
        if logits.device.type in ("cpu", "meta"):
            return fused_xent_plain(logits, label, ignore_index)
        raise RuntimeError(f"fused_xent: no kernel for device "
                           f"{logits.device}")

    @staticmethod
    def setup_context(ctx, inputs, output):
        logits, label, ignore_index = inputs
        ctx.save_for_backward(logits, label, output[1])
        ctx.ignore_index = ignore_index
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, g_loss, g_lse):
        logits, label, lse = ctx.saved_tensors
        return (fused_xent_bwd(logits, label, lse, g_loss, ctx.ignore_index),
                None, None)


def fused_softmax_xent(logits, label, ignore_index=-100):
    """loss [T] fp32 for hard labels [T] over logits [T, V];
    differentiable in logits."""
    loss, _ = _FusedXent.apply(logits, label.reshape(-1).long(),
                               int(ignore_index))
    return loss


def fused_xent_enabled() -> bool:
    from ..core.flags import flag
    return bool(flag("fused_xent"))


def enable_fused_xent(on: bool = True):
    from ..core.flags import set_flags
    set_flags({"fused_xent": bool(on)})


def maybe_fused_xent(logits, label, axis, soft_label, ignore_index):
    """Dispatch hook for the softmax_with_cross_entropy kernel: the loss
    [..., 1] (fp32) when the fused path applies, else None.  Conditions:
    flag on, hard labels, last axis."""
    if not fused_xent_enabled() or soft_label:
        return None
    if axis != logits.dim() - 1:
        return None
    lead = tuple(logits.shape[:-1])
    lbl = label
    if lbl.dim() == logits.dim() and lbl.shape[-1] == 1:
        lbl = lbl[..., 0]
    loss = fused_softmax_xent(
        logits.reshape(math.prod(lead), logits.shape[-1]), lbl,
        ignore_index if ignore_index is not None else -100)
    return loss.reshape(*lead, 1)


# launches of the Hopper kernel in this process, in all and by logits
# dtype (callers reset them around the run they want to count)
fused_xent_cuda.launches = 0
fused_xent_cuda.dtype_launches = collections.Counter()
