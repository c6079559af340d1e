"""The interpolation and sampling ops against the JAX package's kernels,
forward and grad: {bilinear,nearest,bicubic}_interp[_v2],
linear_interp[_v2], trilinear_interp[_v2], affine_channel, affine_grid
and grid_sampler.  Every mode with `align_corners` on and off, up- and
down-sampling (jax.image antialiases a shrinking axis), sizes from the
out_* attrs, `scale` and the OutSize input.  Tolerances in
tests/torch_nn_cases.py.  The reference behaviours the port keeps are
pinned at the end (ROADMAP.md Queue 3 items 51-52)."""
import numpy as np
import pytest
import torch

from test_torch_train_ops import _run_torch
from torch_nn_cases import bf16, check_case, f, grad_slots_match

OPS2D = [f"{m}_interp{v}" for m in ("bilinear", "nearest", "bicubic")
         for v in ("", "_v2")]

# (input, attrs): up, down, mixed, by scale, odd sizes
GEOMS = {
    "up": (f(2, 3, 5, 6), {"out_h": 9, "out_w": 11}),
    "down": (f(2, 2, 12, 10), {"out_h": 5, "out_w": 4}),
    "mixed": (f(1, 3, 7, 4), {"out_h": 3, "out_w": 9}),
    "scale": (f(2, 2, 4, 6), {"scale": 1.5}),
    "shrink_scale": (f(1, 2, 9, 9), {"scale": 0.5}),
}

CASES = {}
for _op in OPS2D:
    for _g, (_x, _a) in GEOMS.items():
        for _ac in (True, False):
            CASES[f"{_op}_{_g}_ac{int(_ac)}"] = (
                _op, {"X": _x}, dict(_a, align_corners=_ac), ["Out"])
CASES.update({
    "bilinear_outsize": ("bilinear_interp_v2",
                         {"X": f(2, 2, 4, 5),
                          "OutSize": np.array([7, 3], np.int32)},
                         {"out_h": 2, "out_w": 2, "align_corners": False},
                         ["Out"]),
    "bicubic_bf16": ("bicubic_interp", {"X": bf16(1, 2, 6, 6)},
                     {"out_h": 9, "out_w": 4, "align_corners": False},
                     ["Out"]),
    "bilinear_bf16_ac": ("bilinear_interp_v2", {"X": bf16(1, 2, 5, 5)},
                         {"out_h": 8, "out_w": 8}, ["Out"]),
    "linear_up": ("linear_interp", {"X": f(2, 3, 7)}, {"out_w": 12},
                  ["Out"]),
    "linear_down_v2": ("linear_interp_v2", {"X": f(2, 3, 16)},
                       {"out_w": 5, "align_corners": True}, ["Out"]),
    "linear_scale": ("linear_interp", {"X": f(1, 2, 6)}, {"scale": 2.5},
                     ["Out"]),
    "trilinear_up": ("trilinear_interp", {"X": f(1, 2, 3, 4, 5)},
                     {"out_d": 5, "out_h": 6, "out_w": 7}, ["Out"]),
    "trilinear_down_v2": ("trilinear_interp_v2", {"X": f(1, 2, 8, 6, 7)},
                          {"out_d": 3, "out_h": 6, "out_w": 4}, ["Out"]),
    "trilinear_scale_outsize": ("trilinear_interp",
                                {"X": f(1, 1, 4, 4, 4),
                                 "OutSize": np.array([2, 5, 6], np.int32)},
                                {"scale": 2.0}, ["Out"]),
    "affine_channel": ("affine_channel", {"X": f(2, 3, 4, 4), "Scale": f(3),
                                          "Bias": f(3)}, {}, ["Out"]),
    "affine_channel_nhwc": ("affine_channel",
                            {"X": f(2, 4, 4, 3), "Scale": f(3),
                             "Bias": f(3)}, {"data_layout": "NHWC"},
                            ["Out"]),
    "grid_sampler": ("grid_sampler", {"X": f(2, 3, 5, 6),
                                      "Grid": np.tanh(f(2, 4, 7, 2))},
                     {}, ["Output"]),
    "grid_sampler_border": ("grid_sampler",
                            {"X": f(1, 2, 4, 4),
                             "Grid": 1.4 * np.tanh(f(1, 3, 3, 2))},
                            {"mode": "nearest", "padding_mode": "zeros"},
                            ["Output"]),
})


@pytest.mark.parametrize("name", list(CASES))
def test_op_and_grad_match_jax(name):
    op, ins, attrs, ct = CASES[name]
    check_case(op, ins, attrs, ct, jit="OutSize" not in ins)


def test_affine_grid_matches_jax():
    """Output and Theta@GRAD.  The JAX kernel builds its base grid with
    jnp.linspace, float64 under the tests' x64 (float32 without it), so
    Theta is float64 here and the output float64 in both."""
    theta = f(2, 2, 3).astype(np.float64)
    for attrs, extra in (({"output_shape": [2, 3, 5, 4]}, {}),
                         ({}, {"OutputShape": np.array([2, 3, 3, 6],
                                                       np.int32)})):
        check_case("affine_grid", dict({"Theta": theta}, **extra), attrs,
                   ["Output"], jit=not extra)


@pytest.mark.parametrize("op", OPS2D + ["linear_interp", "trilinear_interp",
                                        "affine_channel", "affine_grid",
                                        "grid_sampler"])
def test_grad_slots_follow_the_reference_convention(op):
    grad_slots_match(op)


# ---------------------------------------------------------------------------
# reference behaviours the port keeps (ROADMAP.md Queue 3)
# ---------------------------------------------------------------------------
def test_interp_is_jax_image_resize_not_torch_item_51():
    """Queue 3 item 51: without align_corners the 2-d ops are
    jax.image.resize: shrinking antialiases (torch's F.interpolate does
    not), bicubic is Keys a = -0.5 (torch -0.75); bicubic with
    align_corners is the bilinear emulation; nearest rounds half to even
    with align_corners and floors without."""
    x = f(1, 1, 12, 12)
    t = torch.from_numpy(x)
    down = _run_torch("bilinear_interp", {"X": x},
                      {"out_h": 4, "out_w": 4, "align_corners": False})
    tv = torch.nn.functional.interpolate(t, size=(4, 4), mode="bilinear",
                                         align_corners=False)
    assert np.abs(down["Out"].numpy() - tv.numpy()).max() > 1e-2
    up = _run_torch("bicubic_interp", {"X": x[:, :, :5, :5]},
                    {"out_h": 9, "out_w": 9, "align_corners": False})
    tc = torch.nn.functional.interpolate(t[:, :, :5, :5], size=(9, 9),
                                         mode="bicubic", align_corners=False)
    assert np.abs(up["Out"].numpy() - tc.numpy()).max() > 1e-3
    cub = _run_torch("bicubic_interp", {"X": x}, {"out_h": 7, "out_w": 5})
    lin = _run_torch("bilinear_interp", {"X": x}, {"out_h": 7, "out_w": 5})
    np.testing.assert_array_equal(cub["Out"].numpy(), lin["Out"].numpy())
    near = _run_torch("nearest_interp", {"X": x[:, :, :3, :3]},
                      {"out_h": 5, "out_w": 5, "align_corners": True})
    # i (3 - 1) / (5 - 1) = 0.5 at i = 1 rounds to 0, 1.5 at i = 3 to 2
    np.testing.assert_array_equal(near["Out"].numpy()[0, 0, 1],
                                  near["Out"].numpy()[0, 0, 0])
    np.testing.assert_array_equal(near["Out"].numpy()[0, 0, 3],
                                  x[0, 0, 2, [0, 0, 1, 2, 2]])
    for op, ins, a in (("linear_interp", {"X": f(1, 2, 5)}, {"out_w": 8}),
                       ("trilinear_interp", {"X": f(1, 1, 3, 3, 3)},
                        {"out_d": 4, "out_h": 4, "out_w": 4})):
        on = _run_torch(op, ins, dict(a, align_corners=True))["Out"]
        off = _run_torch(op, ins, dict(a, align_corners=False))["Out"]
        np.testing.assert_array_equal(on.numpy(), off.numpy())


def test_grid_sample_clamps_to_the_border_and_reads_no_mode_item_52():
    """Queue 3 item 52: grid_sampler (and affine_grid) are
    align-corners-true; a sample outside [-1, 1] takes the border's
    value (no zero padding) and `mode` / `padding_mode` are not read."""
    x = f(1, 1, 3, 3)
    grid = np.array([[[[-3.0, -3.0], [3.0, 3.0]]]], np.float32)
    for attrs in ({}, {"mode": "nearest", "padding_mode": "zeros",
                       "align_corners": False}):
        ref, got = check_case("grid_sampler", {"X": x, "Grid": grid}, attrs,
                              None)
        np.testing.assert_allclose(got["Output"].numpy()[0, 0, 0],
                                   [x[0, 0, 0, 0], x[0, 0, 2, 2]],
                                   rtol=1e-6)
