"""Fake-quantization ops and the int8 execution op.

Counterpart of paddle_tpu/ops/kernels/quantize.py, op for op and in the
same arithmetic order, so the int8 grids are bitwise the JAX package's:
`_quant` is `round(x / max(scale, 1e-8) * b)` (a division, then a
multiplication; torch.round and jnp.round both round half to even), and
the dequantize ops multiply by `scale / max_range`.

  * fake_quantize_abs_max, fake_channel_wise_quantize_abs_max: float
    values on the int8 grid, and the scales;
  * fake_dequantize_max_abs, fake_channel_wise_dequantize_max_abs;
  * the moving-average ops (scale = accum / state, state = rho state + 1);
  * the two *_quantize_dequantize_* ops and moving_average_abs_max_scale,
    whose gradient is the straight-through estimator;
  * quantize / dequantize / requantize (the scale-multiply convention of
    the reference's int8 inference chain);
  * int8_matmul: dynamic per-tensor activation quantization, an int8 x
    int8 product into int32, one dequant multiply, the bias.

The JAX package computes int8_matmul's product with `lax.dot_general(...,
preferred_element_type=int32)` outside any Pallas kernel, so here it is a
library product too: `torch._int_mm` on a CUDA tensor, and its plain
version (`int8_product_plain`: the product of the upcast operands, exact)
on a CPU tensor.  `torch._int_mm` on CUDA takes more than 16 rows and K,
N divisible by 8: `int8_product` pads the rows (to 17) and K, N where
needed with zeros, which changes no accumulator and not the per-tensor
absmax taken before, and counts what it padded (`int8_product.launches`,
`.padded_calls`, `.padded_rows`).  It hands cuBLASLt the weight
column-major: with a row-major [K, N] weight, torch 2.11's `_int_mm`
raised CUBLAS_STATUS_NOT_SUPPORTED on the H100 for small products (17
rows, K = N = 32 or 64); column-major it takes every shape of
tests/test_torch_cuda.py::test_int8_product_shape_sweep.  Divisions
by a constant divide by a 0-d tensor (`_c`), so a CUDA tensor gets the
same bits as a CPU one.
"""
from __future__ import annotations

import torch

from ..registry import register_op

__all__ = ["int8_product", "int8_product_plain", "quantize_activation",
           "column_major"]

# torch._int_mm's CUDA contract: rows > 16, K and N multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8


def _c(like: torch.Tensor, value: float) -> torch.Tensor:
    """`value` as a 0-d tensor on `like`'s device.  Dividing by it is a
    true division on either device: a Python-scalar divisor makes torch's
    CUDA kernel multiply by the reciprocal (one rounding off the JAX
    package's x / c), and a Python-scalar dividend (`c / x`) does the same
    on the CPU too."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _bin(attrs):
    # bit_length=8 -> 127 (reference: (1 << (bit_length - 1)) - 1)
    return float((1 << (attrs.get("bit_length", 8) - 1)) - 1)


def _abs_max(x):
    return torch.clamp_min(x.abs().max(), 1e-8)


def _quant(x, scale, b):
    """The quantization grid (one source of truth for round and clip);
    `scale` may be a scalar or broadcastable (channel-wise)."""
    return torch.clamp(torch.round(x / torch.clamp_min(scale, 1e-8) * b),
                       -b, b)


def _quant_dequant(x, scale, b):
    s = torch.clamp_min(scale, 1e-8)
    return (_quant(x, scale, b) * (s / _c(s, b))).to(x.dtype)


def _ste_grad(ins, attrs, ctx):
    """Straight-through estimator: the cotangent passes the
    quant-dequant unchanged."""
    g = ins.get("Out@GRAD")
    if g is None:
        return {}
    return {"X@GRAD": g}


def _channel_shape(x, axis):
    shape = [1] * x.dim()
    shape[axis] = -1
    return shape


# -- quantize-only (inference / freeze path) --------------------------------
@register_op("fake_quantize_abs_max", inputs=["X"],
             outputs=["Out", "OutScale"], grad=None)
def fake_quantize_abs_max(ins, attrs, ctx):
    x = ins["X"]
    scale = _abs_max(x)
    return {"Out": _quant(x, scale, _bin(attrs)),
            "OutScale": scale.reshape(1)}


@register_op("fake_channel_wise_quantize_abs_max", inputs=["X"],
             outputs=["Out", "OutScale"], grad=None)
def fake_channel_wise_quantize_abs_max(ins, attrs, ctx):
    x = ins["X"]
    axis = attrs.get("quant_axis", 0)
    red = tuple(i for i in range(x.dim()) if i != axis)
    scale = torch.clamp_min(x.abs().amax(dim=red), 1e-8)
    q = _quant(x, scale.reshape(_channel_shape(x, axis)), _bin(attrs))
    return {"Out": q, "OutScale": scale}


@register_op("fake_dequantize_max_abs", inputs=["X", "Scale!"],
             outputs=["Out"], grad=None)
def fake_dequantize_max_abs(ins, attrs, ctx):
    scale = ins["Scale"].reshape(())
    max_range = float(attrs.get("max_range", 127.0))
    return {"Out": ins["X"].float() * (scale / _c(scale, max_range))}


@register_op("fake_channel_wise_dequantize_max_abs",
             inputs=["X", "Scales*"], outputs=["Out"], grad=None)
def fake_channel_wise_dequantize_max_abs(ins, attrs, ctx):
    x, scales = ins["X"], ins["Scales"]
    qb = float(attrs.get("max_range", 127.0))
    shape = _channel_shape(x, attrs.get("quant_axis", 0))
    out = x.float() * (scales[0].reshape(shape) / _c(scales[0], qb))
    if len(scales) > 1:  # second-level (activation) scale
        out = out * (scales[1].reshape(()) / _c(scales[1], qb))
    return {"Out": out}


# -- the int8 inference chain (scale-multiply convention) -------------------
@register_op("quantize", inputs=["Input"], outputs=["Output"], grad=None)
def quantize_op(ins, attrs, ctx):
    """fp32 -> int8 (or uint8 for a non-negative input): round(x * s)."""
    scale = float(attrs.get("Scale", attrs.get("scale", 1.0)))
    q = torch.round(ins["Input"].float() * scale)
    if bool(attrs.get("is_negative_input", True)):
        return {"Output": torch.clamp(q, -128, 127).to(torch.int8)}
    return {"Output": torch.clamp(q, 0, 255).to(torch.uint8)}


@register_op("dequantize", inputs=["Input"], outputs=["Output"],
             grad=None)
def dequantize_op(ins, attrs, ctx):
    """int8 / uint8 -> fp32: q / scale."""
    scale = float(attrs.get("Scale", attrs.get("scale", 1.0)))
    x = ins["Input"].float()
    return {"Output": x / _c(x, scale)}


@register_op("requantize", inputs=["Input"], outputs=["Output"],
             grad=None)
def requantize_op(ins, attrs, ctx):
    """Rescale an int8 tensor between two quantized domains:
    round(q * s_out / s_in)."""
    s_in = float(attrs.get("Scale_in", attrs.get("scale_in", 1.0)))
    s_out = float(attrs.get("Scale_out", attrs.get("scale_out", 1.0)))
    q = torch.round(ins["Input"].float() * (s_out / s_in))
    return {"Output": torch.clamp(q, -128, 127).to(torch.int8)}


def int8_product_plain(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The int32 accumulators of xq [M, K] int8 @ w [K, N] int8: the
    product of the operands upcast to float64, where every partial sum
    (|sum| <= 127^2 K, well under 2^53) is an exact integer in any
    summation order, on either device."""
    return torch.matmul(xq.double(), w.double()).to(torch.int32)


def _round_up(n, m):
    return -(-n // m) * m


def column_major(w: torch.Tensor) -> torch.Tensor:
    """The same [K, N] values laid out column-major (stride (1, K)), the
    layout torch._int_mm's cuBLASLt product takes at every shape."""
    if w.stride(0) == 1 and w.stride(1) == w.shape[0]:
        return w
    return w.t().contiguous().t()


def int8_product(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """xq [M, K] int8 @ w [K, N] int8 -> int32 [M, N].  A CUDA tensor
    goes to torch._int_mm with the weight column-major (a copy unless it
    is already: callers store their weights so), zero-padded to more than
    16 rows and K, N multiples of 8 (each padded call counted; short rows
    pad xq alone); a CPU tensor to the plain version."""
    if not xq.is_cuda:
        return int8_product_plain(xq, w)
    m, k = xq.shape
    n = w.shape[1]
    mp = max(m, _INT_MM_MIN_ROWS)
    kp, np_ = _round_up(k, _INT_MM_ALIGN), _round_up(n, _INT_MM_ALIGN)
    if (mp, kp, np_) != (m, k, n):
        int8_product.padded_calls += 1
        int8_product.padded_rows += mp - m
        xq = torch.nn.functional.pad(xq, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        # pad the [N, K] transpose: one copy, already column-major
        w = torch.nn.functional.pad(w.t(), (0, kp - k, 0, np_ - n)).t()
    acc = torch._int_mm(xq.contiguous(), column_major(w))
    int8_product.launches += 1
    return acc[:m, :n]


int8_product.launches = 0
int8_product.padded_calls = 0
int8_product.padded_rows = 0


def quantize_activation(x: torch.Tensor):
    """int8_matmul's dynamic per-tensor quantization of its input:
    (round(x * xs) clipped to +-127 as int8, xs = 127 / absmax)."""
    xf = x.float()
    xs = _c(xf, 127.0) / torch.clamp_min(xf.abs().max(), 1e-8)
    return torch.clamp(torch.round(xf * xs), -127, 127).to(torch.int8), xs


@register_op("int8_matmul", inputs=["X", "W!", "WScale!", "Bias?"],
             outputs=["Out"], grad=None)
def int8_matmul(ins, attrs, ctx):
    """The op quant_int8_pass and freeze_weights_int8 write: X [..., K]
    quantized per tensor (127 / absmax, round, clip to +-127), the int8
    product with W [K, N] into int32, then acc * (WScale / max_range) /
    xs and the bias.  WScale is per tensor [1] or per out-channel [N]."""
    x, w, ws = ins["X"], ins["W"], ins["WScale"]
    max_range = float(attrs.get("max_range", 127.0))
    xq, xs = quantize_activation(x)
    acc = int8_product(xq.reshape(-1, xq.shape[-1]), w.to(torch.int8))
    wscale = ws.float().reshape(-1)
    wscale = wscale / _c(wscale, max_range)
    deq = wscale.reshape(()) if wscale.numel() == 1 else wscale[None, :]
    out = acc.float() * deq / xs
    out = out.reshape(tuple(x.shape[:-1]) + (w.shape[1],))
    if ins.get("Bias") is not None:
        out = out + ins["Bias"].float()
    return {"Out": out.to(x.dtype if x.dtype != torch.int8
                          else torch.float32)}


# -- quant + dequant (the QAT path, straight-through gradient) --------------
@register_op("fake_quantize_dequantize_abs_max", inputs=["X"],
             outputs=["Out", "OutScale"], grad=_ste_grad)
def fake_quantize_dequantize_abs_max(ins, attrs, ctx):
    x = ins["X"]
    scale = _abs_max(x)
    return {"Out": _quant_dequant(x, scale, _bin(attrs)),
            "OutScale": scale.reshape(1)}


@register_op("fake_channel_wise_quantize_dequantize_abs_max", inputs=["X"],
             outputs=["Out", "OutScale"], grad=_ste_grad)
def fake_channel_wise_quantize_dequantize_abs_max(ins, attrs, ctx):
    x = ins["X"]
    axis = attrs.get("quant_axis", 0)
    red = tuple(i for i in range(x.dim()) if i != axis)
    scale = torch.clamp_min(x.abs().amax(dim=red), 1e-8)
    out = _quant_dequant(x, scale.reshape(_channel_shape(x, axis)),
                         _bin(attrs))
    return {"Out": out, "OutScale": scale}


def _mul_add(a: float, b: torch.Tensor, c) -> torch.Tensor:
    """float32(a) * b + c rounded once, as a fused multiply-add: XLA
    contracts the reference's `rho * state + 1` into an FMA.  The float32
    product is exact in float64, so one float64 sum and the cast to
    float32 give the FMA's value."""
    a64 = torch.tensor(a, dtype=torch.float32).double()
    c64 = c.double() if isinstance(c, torch.Tensor) else float(c)
    return (a64 * b.double() + c64).float()


def _moving_average(ins, attrs, x):
    """Scale tracking: state = rho state + 1, accum = rho accum + absmax,
    scale = accum / state (FindMovingAverageAbsMax)."""
    rho = attrs.get("moving_rate", 0.9)
    cur = _abs_max(x)
    in_state, in_accum = ins.get("InState"), ins.get("InAccum")
    state = _mul_add(rho, in_state.reshape(()), 1.0) \
        if in_state is not None \
        else torch.ones((), dtype=torch.float32, device=x.device)
    accum = _mul_add(rho, in_accum.reshape(()), cur) \
        if in_accum is not None else cur
    return accum / state, state, accum


def _moving_average_outputs(scale, state, accum):
    return {"OutScale": scale.reshape(1), "OutState": state.reshape(1),
            "OutAccum": accum.reshape(1)}


@register_op("fake_quantize_moving_average_abs_max",
             inputs=["X", "InScale!", "InState?!", "InAccum?!"],
             outputs=["Out", "OutScale", "OutState?", "OutAccum?"],
             grad=None)
def fake_quantize_moving_average_abs_max(ins, attrs, ctx):
    x = ins["X"]
    b = _bin(attrs)
    if attrs.get("is_test", False) or ctx.is_test:
        scale = ins["InScale"].reshape(())
        return {"Out": _quant(x, scale, b), "OutScale": scale.reshape(1)}
    scale, state, accum = _moving_average(ins, attrs, x)
    return {"Out": _quant(x, scale, b),
            **_moving_average_outputs(scale, state, accum)}


@register_op("fake_quantize_dequantize_moving_average_abs_max",
             inputs=["X", "InScale!", "InState?!", "InAccum?!"],
             outputs=["Out", "OutScale", "OutState?", "OutAccum?"],
             grad=_ste_grad)
def fake_quantize_dequantize_moving_average_abs_max(ins, attrs, ctx):
    x = ins["X"]
    b = _bin(attrs)
    if attrs.get("is_test", False) or ctx.is_test:
        scale = ins["InScale"].reshape(())
        return {"Out": _quant_dequant(x, scale, b),
                "OutScale": scale.reshape(1)}
    scale, state, accum = _moving_average(ins, attrs, x)
    return {"Out": _quant_dequant(x, scale, b),
            **_moving_average_outputs(scale, state, accum)}


@register_op("moving_average_abs_max_scale",
             inputs=["X", "InState?!", "InAccum?!"],
             outputs=["Out?", "OutScale", "OutState?", "OutAccum?"],
             grad=_ste_grad)
def moving_average_abs_max_scale(ins, attrs, ctx):
    """Observer op: the identity on X, tracking its scale (the freeze
    pass reads it for activation thresholds)."""
    x = ins["X"]
    if attrs.get("is_test", False) or ctx.is_test:
        return {"Out": x}
    scale, state, accum = _moving_average(ins, attrs, x)
    return {"Out": x, **_moving_average_outputs(scale, state, accum)}
