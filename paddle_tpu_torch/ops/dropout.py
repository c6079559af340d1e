"""Dropout on a counter-based generator whose seed lives in device memory
(hand-written Hopper kernel).

There is no TPU kernel to replace: the JAX package's `dropout` op draws its
keep mask with `jax.random.bernoulli(fold_in(PRNGKey(seed), uid))` under
XLA (paddle_tpu/ops/kernels/nn.py:490).  The port draws it with
Philox-4x32-10, keyed by (seed, op uid), one counter per group of four
elements:

  * a CUDA tensor launches the kernel in csrc/dropout_philox.cu, or raises.
    The seed is a one-element int64 tensor on the card read through its
    pointer (the executor's step seed, which a CUDA graph of the step
    reads afresh on every replay) or a host integer (a `fix_seed` op);
  * a CPU (or meta) tensor runs `dropout_plain`, the same generator in
    PyTorch int64 arithmetic: the same bits, element for element.

No library call draws from a seed held in device memory (a
torch.Generator is seeded from the host), so `torch.nn.functional.dropout`
is only the yardstick of the kernel's speed: it draws other numbers.

Semantics (those of the JAX package's kernel): keep(e) when the element's
32-bit draw is below ceil((1 - p) 2^32); Out = keep ? x / q : 0 for
`upscale_in_train` (q = 1 - p in X's dtype, the quotient in fp32, rounded
to X's dtype), Out = keep ? x : 0 for `downgrade_in_infer`; Mask = keep as
uint8.  `apply_mask` applies a saved mask the same way (the gradient).
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["philox4x32", "philox_draws", "keep_threshold", "scale_divisor",
           "DropoutFn",
           "apply_mask", "dropout_plain", "dropout_cuda", "dropout_fwd"]

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _mulhilo(m: int, c):
    """(hi, lo) 32-bit words of m * c for a 32-bit constant m and int64
    tensor c of 32-bit values.  c is split into 16-bit halves so that no
    product leaves int64: m * c_lo and m * c_hi stay below 2^48."""
    p0 = m * (c & 0xFFFF)
    p1 = m * (c >> 16)
    mid = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (mid >> 32), mid & _MASK32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox-4x32-10 over int64 tensors holding 32-bit words (counter
    c0..c3, key k0, k1: tensors or ints); returns the four output words."""
    for i in range(10):
        if i:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _seed_word(seed, device):
    """The key's first word: seed mod 2^32, from an int or an int64 tensor
    (read on `device`, as the kernel reads it through its pointer)."""
    if isinstance(seed, torch.Tensor):
        return (seed.reshape(()).to(device=device, dtype=torch.int64)
                & _MASK32)
    return int(seed) & _MASK32


def philox_draws(n: int, seed, uid: int, device="cpu"):
    """The 32-bit draws (int64 tensor [n]) of elements 0..n-1: word e % 4 of
    philox((g mod 2^32, g >> 32, 0, 0), (seed mod 2^32, uid mod 2^32)) for
    g = e // 4."""
    g = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(g)
    words = philox4x32(g & _MASK32, g >> 32, zero, zero,
                       _seed_word(seed, device), int(uid) & _MASK32)
    return torch.stack(words, dim=1).reshape(-1)[:n]


def keep_threshold(p: float) -> int:
    """An element is kept when its draw is below this: ceil((1 - p) 2^32),
    clamped to [0, 2^32]."""
    return min(2 ** 32, max(0, math.ceil((1.0 - float(p)) * 2 ** 32)))


def scale_divisor(p: float, dtype) -> float:
    """q of upscale_in_train: max(1 - p, 1e-8) rounded to `dtype` (the JAX
    package divides by `jnp.asarray(max(1 - p, 1e-8), x.dtype)`)."""
    return float(torch.tensor(max(1.0 - float(p), 1e-8), dtype=dtype))


def apply_mask(x, keep, p: float, upscale: bool):
    """keep ? x / q : 0 (upscale) or keep ? x : 0, in X's dtype; the
    quotient is an fp32 IEEE division by a 0-d tensor on X's device (a
    Python-float divisor of a CUDA tensor becomes a multiply by its
    reciprocal)."""
    if upscale:
        q = torch.full((), scale_divisor(p, x.dtype), dtype=torch.float32,
                       device=x.device)
        x = (x.float() / q).to(x.dtype)
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def dropout_plain(x, p: float, seed, uid: int, upscale: bool):
    """The kernel's function in PyTorch: (Out, Mask uint8) with the same
    bits, for any device."""
    thr = keep_threshold(p)
    keep = (philox_draws(x.numel(), seed, uid, x.device) < thr) \
        .reshape(x.shape)
    return apply_mask(x, keep, p, upscale), keep.to(torch.uint8)


def _kernel_lib():
    from ..core.kernel_build import load_library
    lib = load_library("dropout_philox")
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dropout_philox_fwd.argtypes = [p, p, p, ll, i, p, ll, ll,
                                           ctypes.c_ulonglong,
                                           ctypes.c_float, i, p]
        lib.dropout_philox_fwd.restype = i
        lib.dropout_philox_error_string.argtypes = [i]
        lib.dropout_philox_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def dropout_cuda(x, p: float, seed, uid: int, upscale: bool):
    """Launch the Hopper kernel: x a contiguous CUDA tensor (fp32, bf16 or
    fp16), seed a one-element int64 CUDA tensor on x's device or an int.
    Returns (Out, Mask uint8)."""
    if not x.is_cuda:
        raise ValueError(f"dropout_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"dropout kernel takes float32, bfloat16 or float16, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"dropout kernel needs a contiguous tensor, got "
                         f"strides {x.stride()} for {tuple(x.shape)}")
    seed_ptr, seed_value = None, 0
    if isinstance(seed, torch.Tensor):
        if seed.device != x.device or seed.dtype != torch.int64 or \
                seed.numel() != 1:
            raise ValueError(f"dropout kernel reads a one-element int64 "
                             f"seed on {x.device}, got {tuple(seed.shape)} "
                             f"{seed.dtype} on {seed.device}")
        seed_ptr = seed.data_ptr()
    else:
        seed_value = int(seed)
    out = torch.empty_like(x)
    mask = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    n = x.numel()
    if n == 0:
        return out, mask
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dropout_philox_fwd(
            x.data_ptr(), out.data_ptr(), mask.data_ptr(), n,
            _DTYPE_CODE[x.dtype], seed_ptr, seed_value, int(uid),
            keep_threshold(p), scale_divisor(p, x.dtype), int(bool(upscale)),
            stream)
    if err != 0:
        raise RuntimeError(
            f"dropout_philox_fwd launch failed: CUDA error {err} "
            f"({lib.dropout_philox_error_string(err).decode()})")
    dropout_cuda.launches += 1
    return out, mask


def dropout_fwd(x, p: float, seed, uid: int, upscale: bool):
    """(Out, Mask): the kernel for a CUDA tensor, the plain version for a
    CPU (or meta) one."""
    if x.is_cuda:
        return dropout_cuda(x, p, seed, uid, upscale)
    if x.device.type in ("cpu", "meta"):
        return dropout_plain(x, p, seed, uid, upscale)
    raise RuntimeError(f"dropout: no kernel for device {x.device}")


class DropoutFn(torch.autograd.Function):
    """Dropout in training: (Out, Mask) from `dropout_fwd`; the gradient
    is Out@GRAD through the saved Mask (`apply_mask`), scaled as the
    forward was, so nothing is drawn twice.  The dygraph `F.dropout` and
    the `dropout` op's kernel both run it, so the op stays differentiable
    where torch autograd replays it (a `jit.to_static` program): the
    kernel's own output carries no autograd history."""

    @staticmethod
    def forward(x, p, seed, uid, upscale):
        return dropout_fwd(x.contiguous(), p, seed, uid, upscale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, p, _, _, upscale = inputs
        ctx.save_for_backward(output[1])
        ctx.p, ctx.upscale = p, upscale
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, g_out, g_mask):
        (mask,) = ctx.saved_tensors
        return (apply_mask(g_out, mask.bool(), ctx.p, ctx.upscale),
                None, None, None, None)


# launches of the Hopper kernel in this process (plain integer; callers
# reset it to 0 around the run they want to count)
dropout_cuda.launches = 0
