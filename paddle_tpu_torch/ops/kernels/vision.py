"""Vision ops of paddle_tpu/ops/kernels/vision.py, the detection ops
aside: the ten interpolation ops, affine_channel, affine_grid and
grid_sampler.

The interpolation keeps the JAX package's function, not torch's or
Paddle's (ROADMAP.md Queue 3):
  * bilinear / bicubic / linear / trilinear without `align_corners` (and
    linear / trilinear always: they never read it) are
    `jax.image.resize`: half-pixel centres, a triangle or a Keys cubic
    (a = -0.5) kernel, and when an axis shrinks, an antialiasing kernel
    widened by in / out (`scale_and_translate`'s weight matrices, written
    here: one [in, out] matrix an axis whose size changes, normalised
    over its taps, zero where the sample falls outside the input);
  * bilinear and bicubic with `align_corners` (the default) are the same
    bilinear emulation: corner-aligned sample positions, two taps an
    axis, clamped at the border;
  * nearest floors i * in / out, or with `align_corners` rounds
    i (in - 1) / (out - 1) half to even.
The weights and indices are computed in float64 on the host and the
contraction runs in the input's dtype (fp32 for half inputs).

affine_grid and grid_sampler are align-corners-true and clamp the
sampled corners to the border; `mode`, `padding_mode` and
`align_corners` are not read."""
from __future__ import annotations

import numpy as np
import torch

from ..registry import register_op
from .nn import _cdt


def _interp_size(x, attrs, ins):
    out_h = attrs.get("out_h", -1)
    out_w = attrs.get("out_w", -1)
    scale = attrs.get("scale", 0.0)
    if ins.get("OutSize") is not None:
        sz = ins["OutSize"].reshape(-1).tolist()
        out_h, out_w = int(sz[0]), int(sz[1])
    elif scale and scale > 0:
        out_h = int(x.shape[2] * scale)
        out_w = int(x.shape[3] * scale)
    return out_h, out_w


def _interp_size_nd(x, attrs, ins, keys):
    """OutSize tensor > scale attr > out_* attrs, as for the 2-d family."""
    out = ins.get("OutSize")
    if out is not None:
        vals = [int(v) for v in out.reshape(-1).tolist()]
        if len(vals) == len(keys):
            return vals
    scale = attrs.get("scale", 0.0)
    scales = (list(scale) if isinstance(scale, (list, tuple))
              else [scale] * len(keys))
    if scales and all(s and float(s) > 0 for s in scales):
        return [int(dim * float(s)) for dim, s in zip(x.shape[2:], scales)]
    sizes = [int(attrs.get(k, -1)) for k in keys]
    if all(s > 0 for s in sizes):
        return sizes
    raise ValueError(
        "interp: no target size — give OutSize, positive scale, or "
        f"{keys}")


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def weight_matrix(n_in, n_out, kernel):
    """jax.image's `compute_weight_mat` at scale out / in, translation 0,
    antialiased: [n_in, n_out] in float64."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = (_keys_cubic if kernel == "cubic" else _triangle)(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def image_resize(x, out_spatial, kernel):
    """`jax.image.resize(x, x.shape[:2] + out_spatial, kernel)` over the
    axes from 2 on: each axis whose size changes contracted with its
    weight matrix (rounded to x's dtype, as jax.image casts it)."""
    cdt = _cdt(x)
    out = x
    for i, n_out in enumerate(out_spatial):
        axis = 2 + i
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        w = torch.as_tensor(weight_matrix(n_in, n_out, kernel),
                            device=x.device).to(x.dtype).to(cdt)
        out = torch.tensordot(out.to(cdt), w, dims=([axis], [0])) \
            .movedim(-1, axis)
    return out.to(x.dtype)


def _resize(x, oh, ow, method, align_corners):
    _, _, h, w = x.shape
    if method == "nearest":
        if align_corners:
            ridx = np.round(np.arange(oh) * (h - 1) / max(oh - 1, 1))
            cidx = np.round(np.arange(ow) * (w - 1) / max(ow - 1, 1))
        else:
            ridx = np.floor(np.arange(oh) * (h / oh))
            cidx = np.floor(np.arange(ow) * (w / ow))
        ridx = torch.as_tensor(np.clip(ridx, 0, h - 1).astype(np.int64),
                               device=x.device)
        cidx = torch.as_tensor(np.clip(cidx, 0, w - 1).astype(np.int64),
                               device=x.device)
        return x[:, :, ridx][:, :, :, cidx]
    if align_corners:
        # the bilinear emulation, for bicubic too
        ry = np.arange(oh) * (h - 1) / max(oh - 1, 1)
        rx = np.arange(ow) * (w - 1) / max(ow - 1, 1)
        y0, x0 = np.floor(ry).astype(np.int64), np.floor(rx).astype(np.int64)
        y1, x1 = np.clip(y0 + 1, 0, h - 1), np.clip(x0 + 1, 0, w - 1)
        cdt = _cdt(x)
        wy = torch.as_tensor(ry - y0, device=x.device).to(cdt)[:, None]
        wx = torch.as_tensor(rx - x0, device=x.device).to(cdt)[None, :]
        xf = x.to(cdt)
        t = [torch.as_tensor(i, device=x.device) for i in (y0, y1, x0, x1)]

        def g(yy, xx):
            return xf[:, :, yy][:, :, :, xx]

        out = (g(t[0], t[2]) * (1 - wy) * (1 - wx) + g(t[1], t[2]) * wy
               * (1 - wx) + g(t[0], t[3]) * (1 - wy) * wx + g(t[1], t[3])
               * wy * wx)
        return out.to(x.dtype)
    return image_resize(x, (oh, ow),
                        "cubic" if method == "bicubic" else "linear")


def _make_interp(name, method):
    @register_op(name, inputs=["X", "OutSize?!", "SizeTensor*?!", "Scale?!"],
                 outputs=["Out"])
    def kernel(ins, attrs, ctx, _m=method):
        x = ins["X"]
        oh, ow = _interp_size(x, attrs, ins)
        return {"Out": _resize(x, oh, ow, _m,
                               attrs.get("align_corners", True))}
    return kernel


for _name, _method in (("bilinear_interp", "bilinear"),
                       ("nearest_interp", "nearest"),
                       ("bicubic_interp", "bicubic")):
    _make_interp(_name, _method)
    _make_interp(_name + "_v2", _method)


def _make_interp_nd(name, keys):
    @register_op(name, inputs=["X", "OutSize?!", "Scale?!"],
                 outputs=["Out"])
    def kernel(ins, attrs, ctx):
        x = ins["X"]
        return {"Out": image_resize(
            x, tuple(_interp_size_nd(x, attrs, ins, keys)), "linear")}
    return kernel


for _name in ("linear_interp", "linear_interp_v2"):
    _make_interp_nd(_name, ["out_w"])
for _name in ("trilinear_interp", "trilinear_interp_v2"):
    _make_interp_nd(_name, ["out_d", "out_h", "out_w"])


@register_op("affine_channel", inputs=["X", "Scale", "Bias"],
             outputs=["Out"])
def affine_channel(ins, attrs, ctx):
    shape = (1, -1, 1, 1) if attrs.get("data_layout", "NCHW") == "NCHW" \
        else (1, 1, 1, -1)
    return {"Out": ins["X"] * ins["Scale"].reshape(shape)
            + ins["Bias"].reshape(shape)}


@register_op("affine_grid", inputs=["Theta", "OutputShape?!"],
             outputs=["Output"])
def affine_grid(ins, attrs, ctx):
    """Theta [N, 2, 3] applied to the (x, y, 1) of an H x W grid over
    [-1, 1] (corners included): Output [N, H, W, 2]."""
    theta = ins["Theta"]
    shape = attrs.get("output_shape", [])
    if ins.get("OutputShape") is not None:
        shape = [int(s) for s in ins["OutputShape"].reshape(-1).tolist()]
    n, _, h, w = shape
    ys = torch.linspace(-1, 1, h, dtype=theta.dtype, device=theta.device)
    xs = torch.linspace(-1, 1, w, dtype=theta.dtype, device=theta.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(-1, 3)
    grid = torch.einsum("nij,pj->npi", theta, base)
    return {"Output": grid.reshape(n, h, w, 2)}


@register_op("grid_sampler", inputs=["X", "Grid"], outputs=["Output"])
def grid_sampler(ins, attrs, ctx):
    """Bilinear samples of X [N, C, H, W] at Grid [N, H', W', 2] in
    [-1, 1], corners aligned, each corner index clamped to the border."""
    x, grid = ins["X"], ins["Grid"]
    n, _, h, w = x.shape
    gx = (grid[..., 0] + 1) * (w - 1) / 2
    gy = (grid[..., 1] + 1) * (h - 1) / 2
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = (gx - x0)[..., None], (gy - y0)[..., None]
    batch = torch.arange(n, device=x.device)[:, None, None]
    xl = x.movedim(1, -1)  # [n, h, w, c]

    def gather(yy, xx):
        yy = yy.clamp(0, h - 1).long()
        xx = xx.clamp(0, w - 1).long()
        return xl[batch, yy, xx]  # [n, h', w', c]

    out = (gather(y0, x0) * ((1 - wy) * (1 - wx))
           + gather(y0, x0 + 1) * ((1 - wy) * wx)
           + gather(y0 + 1, x0) * (wy * (1 - wx))
           + gather(y0 + 1, x0 + 1) * (wy * wx))
    return {"Output": out.movedim(-1, 1).to(x.dtype)}
