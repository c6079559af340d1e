"""Uniform, normal, truncated-normal, integer and Bernoulli draws on a
counter-based generator whose seed lives in device memory (hand-written
Hopper kernel).

There is no TPU kernel to replace: the JAX package's `uniform_random`,
`gaussian_random`, `truncated_gaussian_random`, `bernoulli` and `randint`
ops draw with `jax.random` under XLA
(paddle_tpu/ops/kernels/random.py:20,40,48,58,64).  The port needs a
kernel for the reason dropout does (ops/dropout.py): no library call draws
from a seed held in device memory, so a CUDA graph of a step that draws
(an initializer, dpsgd's noise) would replay one draw forever.

The generator is dropout's Philox-4x32-10 with dropout's keying: key
(seed mod 2^32, uid mod 2^32), counter (g mod 2^32, g >> 32, 0, 0) for the
group g = e // 4 of the element e (row-major), word e % 4 of the result
its 32-bit draw w(e).  From it:

  * uniform: u(e) = (w(e) >> 8) 2^-24 in [0, 1), exact in fp32; the
    output is u * span + lo in fp32, each step rounded on its own (no
    fused multiply-add), span = fp32(fp32(max) - fp32(min)), lo =
    fp32(min), then rounded to the op's dtype;
  * normal: Box-Muller over the pair of draws (w(2j), w(2j + 1)) of the
    element pair j = e // 2: u1 = ((w(2j) >> 8) + 1) 2^-24 in (0, 1],
    u2 = (w(2j + 1) >> 8) 2^-24, theta = fp32(2 pi u2) (2 pi rounded to
    fp32), r = sqrt(-2 log u1), z = r cos(theta) for the even element and
    r sin(theta) for the odd one; the output is mean + std z in fp32, then
    rounded to the op's dtype.  The kernel computes r and z in fp32
    (`logf`, `sqrtf`, `sincosf`); the plain version computes them in
    float64 and rounds z once, so it is the correctly rounded z to within
    a float64 ulp, and the kernel's z lies within a few fp32 ulps of it;
  * truncated normal (the TruncatedNormal initializer's draw, as
    `jax.random.truncated_normal(-2, 2)`: the inverse CDF): u = (w(e) >>
    8) 2^-24, t = A (2u - 1) in fp32 with A = erf(sqrt 2) rounded to fp32
    (2u - 1 exact, one rounding), z = sqrt(2) erfinv(t) clipped to
    [-2, 2], the output mean + std z in fp32, then the op's dtype.  The
    kernel's `erfinvf` and the plain version's float64 erfinv (rounded
    once) differ by a few fp32 ulps;
  * integers (`randint_draw`) in [low, high): span = high - low; for a
    span up to 2^32 low + (w(e) span) >> 32 (multiply-shift: one word an
    element, bias below span / 2^32); above it a second word h(e), word
    e % 4 of the counter (g mod 2^32, g >> 32, 1, 0), and low + ((h(e) mod
    2^31) 2^32 + w(e)) mod span.  Equal bit for bit;
  * Bernoulli (`bernoulli_draw`): 1 where u(e) = (w(e) >> 8) 2^-24 < p(e)
    (X's element as fp32), else 0, in X's dtype.  Equal bit for bit.

`randperm` sorts n integer draws over the full 32-bit span (w itself) with
a stable sort; `multinomial` and `sampling_id` take the argmax of
log(p + 1e-12) plus Gumbel noise -log(-log u) of uniform draws (the
Gumbel-max form of the JAX ops' `jax.random.categorical`).  The sort and
the argmax are torch ops, the draws the kernel's.

A CUDA tensor launches the kernel in csrc/philox_random.cu (or raises); a
CPU (or meta) device runs `random_plain`, the same function in PyTorch:
the uniform equal bit for bit, the normal within a few ulps (the card's
fp32 `logf` / `sincosf` against float64).  The kernel is built without fast math, so the
accurate `logf` and `sincosf` run.  `torch.rand` / `torch.randn` are only
the yardsticks of its speed: they draw other numbers.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .dropout import _seed_word, philox4x32, _MASK32

__all__ = ["random_plain", "random_cuda", "random_draw", "uniform",
           "normal", "truncated_normal", "randint_plain", "randint_cuda",
           "randint_draw", "bernoulli_plain", "bernoulli_cuda",
           "bernoulli_draw", "randperm", "categorical", "UNIFORM", "NORMAL",
           "TRUNC_NORMAL"]

UNIFORM, NORMAL, TRUNC_NORMAL = 0, 1, 2
_TRUNC_A = float(np.float32(math.erf(math.sqrt(2.0))))
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_TWO_PI = float(np.float32(2.0 * math.pi))
_U24 = 2.0 ** -24


def _words(n: int, seed, uid: int, device, stream: int = 0):
    """The int64 draws w(0..n-1) of dropout's generator (counter word 2 =
    `stream`: 1 gives randint's second words h)."""
    g = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(g)
    words = philox4x32(g & _MASK32, g >> 32, zero + stream, zero,
                       _seed_word(seed, device), int(uid) & _MASK32)
    return torch.stack(words, dim=1).reshape(-1)[:n]


def _f32(x, device):
    """A 0-d fp32 tensor: scalar operands of the plain arithmetic stay fp32
    and are never folded into a reciprocal or a double."""
    return torch.tensor(float(np.float32(x)), dtype=torch.float32,
                        device=device)


def affine(dist: int, a: float, b: float):
    """The kernel's two fp32 constants: (lo, span) of a uniform over
    [a, b), (mean, std) of a normal."""
    if dist == UNIFORM:
        lo = np.float32(a)
        return float(lo), float(np.float32(np.float32(b) - lo))
    return float(np.float32(a)), float(np.float32(b))


def random_plain(shape, dtype, dist: int, a: float, b: float, seed, uid: int,
                 device="cpu"):
    """The kernel's function in PyTorch: a uniform over [a, b) (dist
    UNIFORM) or a normal of mean a and std b (dist NORMAL), `shape`, in
    `dtype`, keyed by (seed, uid)."""
    n = int(np.prod(shape, dtype=np.int64)) if len(shape) else 1
    device = torch.device(device)
    c0, c1 = (_f32(v, device) for v in affine(dist, a, b))
    if n == 0:
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    if dist == UNIFORM:
        u = (_words(n, seed, uid, device) >> 8).to(torch.float32) * _U24
        out = u * c1 + c0
    elif dist == TRUNC_NORMAL:
        u = (_words(n, seed, uid, device) >> 8).to(torch.float32) * _U24
        t = (u * _f32(2.0, device) - _f32(1.0, device)) * \
            _f32(_TRUNC_A, device)
        # erfinv in float64, rounded once to fp32 (as the normal's
        # transcendental part)
        z = (torch.special.erfinv(t.double()) * math.sqrt(2.0)).to(
            torch.float32).clamp(-2.0, 2.0)
        out = z * c1 + c0
    else:
        w = _words(n + (n & 1), seed, uid, device).reshape(-1, 2)
        u1 = ((w[:, 0] >> 8) + 1).to(torch.float32) * _U24
        u2 = (w[:, 1] >> 8).to(torch.float32) * _U24
        theta = u2 * _f32(_TWO_PI, device)
        # the transcendental part in float64, rounded once to fp32: the
        # CPU's vectorized fp32 log / sin / cos may round differently from
        # call to call (their path depends on alignment), float64 does not
        # show through the rounding
        r = torch.sqrt(torch.log(u1.double()) * -2.0)
        theta = theta.double()
        z = torch.stack([r * torch.cos(theta), r * torch.sin(theta)],
                        dim=1).reshape(-1)[:n].to(torch.float32)
        out = z * c1 + c0
    return out.reshape(tuple(shape)).to(dtype)


def _kernel_lib():
    from ..core.kernel_build import load_library
    lib = load_library("philox_random")
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.philox_random_fill.argtypes = [p, ll, i, i, p, ll, ll, f, f, p]
        lib.philox_random_fill.restype = i
        lib.philox_randint_fill.argtypes = [p, ll, i, p, ll, ll, ll, ll, p]
        lib.philox_randint_fill.restype = i
        lib.philox_bernoulli_fill.argtypes = [p, p, ll, i, p, ll, ll, p]
        lib.philox_bernoulli_fill.restype = i
        lib.philox_random_error_string.argtypes = [i]
        lib.philox_random_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def random_cuda(shape, dtype, dist: int, a: float, b: float, seed, uid: int,
                device):
    """Launch the Hopper kernel into a new tensor on the CUDA `device`;
    seed a one-element int64 tensor on that device or an int."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"random_cuda needs a CUDA device, got {device}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"philox_random kernel writes float32, bfloat16 or "
                        f"float16, got {dtype}")
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    seed_ptr, seed_value = _seed_args(seed, out.device)
    n = out.numel()
    if n == 0:
        return out
    c0, c1 = affine(dist, a, b)
    lib = _kernel_lib()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.philox_random_fill(out.data_ptr(), n, _DTYPE_CODE[dtype],
                                     int(dist), seed_ptr, seed_value,
                                     int(uid), c0, c1, stream)
    if err != 0:
        raise RuntimeError(
            f"philox_random_fill launch failed: CUDA error {err} "
            f"({lib.philox_random_error_string(err).decode()})")
    random_cuda.launches += 1
    random_cuda.launches_by_dist[int(dist)] += 1
    return out


def random_draw(shape, dtype, dist: int, a: float, b: float, seed, uid: int,
                device):
    """The kernel on a CUDA device, the plain version on a CPU (or meta)
    one."""
    device = torch.device(device)
    if device.type == "cuda":
        return random_cuda(shape, dtype, dist, a, b, seed, uid, device)
    if device.type in ("cpu", "meta"):
        return random_plain(shape, dtype, dist, a, b, seed, uid, device)
    raise RuntimeError(f"philox_random: no kernel for device {device}")


def truncated_normal(shape, dtype, mean, std, seed, uid, device):
    return random_draw(shape, dtype, TRUNC_NORMAL, mean, std, seed, uid,
                       device)


def _numel(shape):
    return int(np.prod(shape, dtype=np.int64)) if len(shape) else 1


def _mulhi32(w, span: int):
    """(w span) >> 32 for int64 tensors w of 32-bit values and span <=
    2^32, without leaving int64: w split into 16-bit halves."""
    a = (w >> 16) * span
    b = (w & 0xFFFF) * span
    return (a >> 16) + ((((a & 0xFFFF) << 16) + b) >> 32)


def randint_plain(shape, dtype, low: int, high: int, seed, uid: int,
                  device="cpu"):
    """The kernel's integers in [low, high), `shape`, in `dtype` (int32 or
    int64), keyed by (seed, uid)."""
    span = int(high) - int(low)
    if span < 1:
        raise ValueError(f"randint: high ({high}) must exceed low ({low})")
    device = torch.device(device)
    n = _numel(shape)
    w = _words(n, seed, uid, device)
    if span <= 1 << 32:
        off = _mulhi32(w, span)
    else:
        h = _words(n, seed, uid, device, stream=1)
        off = (((h & 0x7FFFFFFF) << 32) | w) % span
    return (off + int(low)).reshape(tuple(shape)).to(dtype)


_INT_CODE = {torch.int32: 0, torch.int64: 1}


def _seed_args(seed, device):
    """(pointer, value) of the seed as the C entries take it."""
    if isinstance(seed, torch.Tensor):
        if seed.device != device or seed.dtype != torch.int64 or \
                seed.numel() != 1:
            raise ValueError(f"philox_random kernels read a one-element "
                             f"int64 seed on {device}, got "
                             f"{tuple(seed.shape)} {seed.dtype} on "
                             f"{seed.device}")
        return seed.data_ptr(), 0
    return None, int(seed)


def _check(lib, err, entry):
    if err != 0:
        raise RuntimeError(
            f"{entry} launch failed: CUDA error {err} "
            f"({lib.philox_random_error_string(err).decode()})")


def randint_cuda(shape, dtype, low: int, high: int, seed, uid: int,
                 device):
    """Launch the integer kernel into a new tensor on the CUDA `device`."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"randint_cuda needs a CUDA device, got {device}")
    if dtype not in _INT_CODE:
        raise TypeError(f"philox_randint kernel writes int32 or int64, got "
                        f"{dtype}")
    span = int(high) - int(low)
    if not 1 <= span < 1 << 63:
        raise ValueError(f"randint: span {span} outside [1, 2^63)")
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    seed_ptr, seed_value = _seed_args(seed, out.device)
    if out.numel() == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.philox_randint_fill(out.data_ptr(), out.numel(),
                                      _INT_CODE[dtype], seed_ptr, seed_value,
                                      int(uid), int(low), span, stream)
    _check(lib, err, "philox_randint_fill")
    randint_cuda.launches += 1
    return out


def randint_draw(shape, dtype, low, high, seed, uid, device):
    """The integer kernel on a CUDA device, the plain version on a CPU (or
    meta) one."""
    device = torch.device(device)
    if device.type == "cuda":
        return randint_cuda(shape, dtype, low, high, seed, uid, device)
    if device.type in ("cpu", "meta"):
        return randint_plain(shape, dtype, low, high, seed, uid, device)
    raise RuntimeError(f"philox_randint: no kernel for device {device}")


def bernoulli_plain(x, seed, uid: int):
    """The kernel's draw: 1 where u < x (as fp32), else 0, in x's dtype."""
    u = (_words(x.numel(), seed, uid, x.device) >> 8).to(torch.float32) * \
        _U24
    return (u < x.reshape(-1).to(torch.float32)).reshape(x.shape).to(
        x.dtype)


def bernoulli_cuda(x, seed, uid: int):
    """Launch the Bernoulli kernel over the CUDA tensor x."""
    if x.device.type != "cuda":
        raise ValueError(f"bernoulli_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"philox_bernoulli kernel reads float32, bfloat16 "
                        f"or float16, got {x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    seed_ptr, seed_value = _seed_args(seed, x.device)
    if x.numel() == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.philox_bernoulli_fill(out.data_ptr(), x.data_ptr(),
                                        x.numel(), _DTYPE_CODE[x.dtype],
                                        seed_ptr, seed_value, int(uid),
                                        stream)
    _check(lib, err, "philox_bernoulli_fill")
    bernoulli_cuda.launches += 1
    return out


def bernoulli_draw(x, seed, uid):
    if x.device.type == "cuda":
        return bernoulli_cuda(x, seed, uid)
    if x.device.type in ("cpu", "meta"):
        return bernoulli_plain(x, seed, uid)
    raise RuntimeError(f"philox_bernoulli: no kernel for device {x.device}")


def randperm(n: int, dtype, seed, uid, device):
    """A permutation of range(n): the stable sort of n draws over the
    full 32-bit span."""
    keys = randint_draw((n,), torch.int64, 0, 1 << 32, seed, uid, device)
    return torch.sort(keys, stable=True).indices.to(dtype)


def categorical(logits, num: int, seed, uid, device):
    """`num` draws a row of the categorical over the last axis of
    `logits` ([..., K] -> [..., num], int64): the argmax of logits plus
    Gumbel noise -log(-log u) of the kernel's uniform draws."""
    u = uniform((num,) + tuple(logits.shape), torch.float32, 0.0, 1.0,
                seed, uid, device)
    gumbel = -torch.log(-torch.log(u))
    idx = torch.argmax(logits.to(torch.float32) + gumbel, dim=-1)
    return torch.movedim(idx, 0, -1).to(torch.int64)


def uniform(shape, dtype, lo, hi, seed, uid, device):
    return random_draw(shape, dtype, UNIFORM, lo, hi, seed, uid, device)


def normal(shape, dtype, mean, std, seed, uid, device):
    return random_draw(shape, dtype, NORMAL, mean, std, seed, uid, device)


# launches of the Hopper kernels in this process (plain integers; callers
# reset them to 0 around the run they want to count); random_cuda's
# launches count every distribution, `launches_by_dist` each one
random_cuda.launches = 0
random_cuda.launches_by_dist = {UNIFORM: 0, NORMAL: 0, TRUNC_NORMAL: 0}
randint_cuda.launches = 0
bernoulli_cuda.launches = 0
