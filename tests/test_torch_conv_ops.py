"""The convolution ops of the slice against the JAX package's kernels,
forward and grad: conv3d, depthwise_conv2d, conv2d_transpose,
conv3d_transpose, depthwise_conv2d_transpose (cuDNN through the port's
`ConvFn`; XLA convolutions in the JAX package), unfold and im2sequence.
The attrs cover strides, 2- / 4- / 6-value paddings, SAME and VALID,
dilations, groups, NHWC / NDHWC, `output_size`, and bf16.  Tolerances
in tests/torch_nn_cases.py."""
import numpy as np
import pytest

from torch_nn_cases import bf16, check_case, f, grad_slots_match

_I = ["Output"]


def _c(op, x, w, **attrs):
    return (op, {"Input": x, "Filter": w}, attrs, _I)


CASES = {
    "conv3d": _c("conv3d", f(2, 3, 5, 6, 5), f(4, 3, 3, 2, 3)),
    "conv3d_s2_pad": _c("conv3d", f(2, 2, 7, 6, 5), f(4, 2, 3, 3, 3),
                        strides=[2, 1, 2], paddings=[1, 0, 2]),
    "conv3d_pad6_dil": _c("conv3d", f(1, 2, 7, 7, 6), f(3, 2, 2, 3, 2),
                          paddings=[1, 0, 0, 2, 1, 1], dilations=[2, 1, 2]),
    "conv3d_same_groups": _c("conv3d", f(2, 4, 5, 5, 4), f(6, 2, 3, 3, 3),
                             strides=[2, 2, 1], groups=2,
                             padding_algorithm="SAME"),
    "conv3d_valid_ndhwc": _c("conv3d", f(2, 5, 4, 6, 3), f(4, 3, 2, 2, 3),
                             paddings=[3, 3, 3], padding_algorithm="VALID",
                             data_format="NDHWC"),
    "conv3d_bf16": _c("conv3d", bf16(2, 4, 5, 5, 5), bf16(4, 4, 3, 3, 3),
                      paddings=[1, 1, 1]),
    "depthwise": _c("depthwise_conv2d", f(2, 4, 8, 7), f(4, 1, 3, 3),
                    paddings=[1, 1]),
    "depthwise_mult_s2": _c("depthwise_conv2d", f(2, 3, 9, 9),
                            f(6, 1, 3, 3), strides=[2, 2],
                            paddings=[0, 1, 1, 2]),
    "depthwise_nhwc_same": _c("depthwise_conv2d", f(2, 7, 8, 4),
                              f(4, 1, 3, 2), strides=[2, 1],
                              dilations=[1, 2], padding_algorithm="SAME",
                              data_format="NHWC"),
    "depthwise_bf16": _c("depthwise_conv2d", bf16(2, 8, 8, 8),
                         bf16(8, 1, 3, 3), strides=[2, 2], paddings=[1, 1]),
    "deconv2d": _c("conv2d_transpose", f(2, 3, 5, 6), f(3, 4, 3, 3)),
    "deconv2d_s2_p1": _c("conv2d_transpose", f(2, 4, 5, 5), f(4, 2, 3, 3),
                         strides=[2, 2], paddings=[1, 1]),
    "deconv2d_pad4_dil": _c("conv2d_transpose", f(2, 2, 5, 4),
                            f(2, 3, 3, 2), strides=[2, 3],
                            paddings=[0, 1, 2, 0], dilations=[2, 1]),
    "deconv2d_groups": _c("conv2d_transpose", f(2, 4, 5, 5), f(4, 3, 2, 2),
                          strides=[2, 2], groups=2),
    "deconv2d_output_size": _c("conv2d_transpose", f(2, 3, 4, 4),
                               f(3, 2, 3, 3), strides=[2, 2],
                               paddings=[1, 1], output_size=[8, 8]),
    "deconv2d_same": _c("conv2d_transpose", f(2, 3, 5, 6), f(3, 2, 3, 4),
                        dilations=[1, 2], padding_algorithm="SAME"),
    "deconv2d_valid": _c("conv2d_transpose", f(2, 3, 4, 4), f(3, 2, 3, 3),
                         strides=[2, 1], paddings=[1, 1],
                         padding_algorithm="VALID"),
    "deconv2d_bf16": _c("conv2d_transpose", bf16(2, 8, 5, 5),
                        bf16(8, 4, 3, 3), strides=[2, 2], paddings=[1, 1]),
    "deconv3d": _c("conv3d_transpose", f(2, 3, 3, 4, 3), f(3, 2, 3, 2, 3),
                   strides=[2, 1, 2], paddings=[1, 0, 1]),
    "deconv3d_ndhwc_osize": _c("conv3d_transpose", f(2, 3, 4, 3, 3),
                               f(3, 2, 2, 2, 2), strides=[2, 2, 2],
                               output_size=[7, 9, 7],
                               data_format="NDHWC"),
    "deconv3d_groups_dil": _c("conv3d_transpose", f(1, 4, 3, 3, 3),
                              f(4, 1, 2, 3, 2), groups=2,
                              dilations=[2, 1, 1], paddings=[0, 1, 0]),
    "deconv3d_bf16": _c("conv3d_transpose", bf16(2, 4, 3, 3, 3),
                        bf16(4, 2, 3, 3, 3), strides=[2, 2, 2],
                        paddings=[1, 1, 1]),
    "dw_deconv": _c("depthwise_conv2d_transpose", f(2, 3, 5, 5),
                    f(3, 1, 3, 3), strides=[2, 2], paddings=[1, 1]),
    "dw_deconv_pad4": _c("depthwise_conv2d_transpose", f(2, 4, 4, 5),
                         f(4, 1, 2, 3), strides=[1, 2], dilations=[2, 1],
                         paddings=[0, 1, 1, 0]),
    "unfold": ("unfold", {"X": f(2, 3, 6, 7)}, {"kernel_sizes": [2, 3]},
               ["Y"]),
    "unfold_pad4_s2_dil": ("unfold", {"X": f(2, 2, 7, 6)},
                           {"kernel_sizes": [3, 2], "strides": [2, 1],
                            "paddings": [1, 0, 2, 1],
                            "dilations": [1, 2]}, ["Y"]),
    "unfold_pad2": ("unfold", {"X": f(1, 2, 5, 5)},
                    {"kernel_sizes": [3, 3], "paddings": [1, 2]}, ["Y"]),
    "im2sequence": ("im2sequence", {"X": f(2, 3, 6, 5)},
                    {"kernels": [2, 2], "strides": [2, 1],
                     "paddings": [1, 0, 0, 1]}, ["Out"]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_op_and_grad_match_jax(name):
    op, ins, attrs, ct = CASES[name]
    check_case(op, ins, attrs, ct)


@pytest.mark.parametrize("op", ["conv3d", "depthwise_conv2d",
                                "conv2d_transpose", "conv3d_transpose",
                                "depthwise_conv2d_transpose", "unfold"])
def test_grad_slots_follow_the_reference_convention(op):
    grad_slots_match(op)


def test_conv_transpose_output_size_range_is_checked():
    """output_size outside [natural, natural + stride - 1] raises in both
    packages, with the same message."""
    from test_torch_train_ops import _run_jax, _run_torch
    ins = {"Input": f(1, 2, 4, 4), "Filter": f(2, 2, 3, 3)}
    attrs = {"strides": [2, 2], "output_size": [11, 9]}
    msgs = []
    for run in (_run_jax, _run_torch):
        with pytest.raises(ValueError) as e:
            run("conv2d_transpose", ins, attrs)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_conv_transpose_same_with_a_stride_raises_as_the_reference():
    """lax refuses a string padding with lhs dilation; the port raises the
    same ValueError for SAME at a stride above 1."""
    from test_torch_train_ops import _run_jax, _run_torch
    ins = {"Input": f(1, 2, 4, 4), "Filter": f(2, 2, 3, 3)}
    attrs = {"strides": [2, 1], "padding_algorithm": "SAME"}
    msgs = []
    for run in (_run_jax, _run_torch):
        with pytest.raises(ValueError) as e:
            run("conv2d_transpose", ins, attrs)
        msgs.append(str(e.value).splitlines()[0])
    assert msgs[0] == msgs[1]


def test_conv2d_transpose_ignores_data_format_as_the_reference():
    """ROADMAP.md Queue 3 item 53: conv2d_transpose computes NCHW whatever
    `data_format` says (the JAX kernel calls `_conv_transpose_nd`
    directly), while conv3d_transpose honours NDHWC."""
    ins = {"Input": f(2, 3, 4, 5), "Filter": f(3, 2, 3, 3)}
    ref, got = check_case("conv2d_transpose", ins,
                          {"data_format": "NHWC"}, None)
    plain, _ = check_case("conv2d_transpose", ins, {}, None)
    np.testing.assert_array_equal(ref["Output"], plain["Output"])
    assert got["Output"].shape == (2, 2, 6, 7)
