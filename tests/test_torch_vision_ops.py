"""The ops of the BASELINE configs (LeNet-5, ResNet-50, Transformer-big)
against the JAX package's kernels: conv2d, pool2d, batch_norm, relu,
label_smooth and one_hot_v2, and their grad ops.

Each case feeds the same numpy arrays (a seeded RandomState) and attrs to
paddle_tpu's kernel (under jax.jit, as its executor runs it) and to the
port's, then feeds both grad ops the same cotangents: the port's grad op
against the JAX package's (jax.vjp of its forward).  The cases cover the
attrs the three configs use and the rest of each kernel's domain: conv2d
strides, paddings of 2 and 4 values, SAME and VALID, dilation, groups,
NHWC and a bias; pool2d max and avg, exclusive on and off, global and
adaptive, asymmetric and SAME padding; batch_norm in training, `is_test`
and `use_global_stats`, NCHW, NHWC and 2-D, every output slot compared.

Tolerances: fp32 atol = rtol = 1e-5 (the same formulas; cuDNN / ATen and
XLA sum in other orders).  bf16 (the convolutions of the AMP ResNet):
atol = rtol = 2e-2 on the forward and 5e-2 on the gradients, which sum
over 8 products rounded to 8 bits of mantissa in another order.

Max-pool inputs have no ties: on a tie each package sends the gradient to
one element of the window, and the two may pick different ones (after a
relu, a tie of zeros carries a zero gradient upstream anyway).

The port's batch_norm grad op returns X@GRAD, Scale@GRAD and Bias@GRAD;
the JAX vjp also has gradients for the Mean and Variance slots, which no
program asks for: both packages' builders make the running stats
non-trainable and stop_gradient, and the dygraph layers keep them as
buffers.  The reference behaviours the port keeps on purpose are pinned at
the end (ROADMAP.md Queue 3)."""
import numpy as np
import pytest
import torch

import paddle_tpu.static  # noqa: F401  (registers the JAX kernels)
import paddle_tpu_torch.static  # noqa: F401  (registers the port's kernels)
from paddle_tpu_torch.core.dtype import dtype_name
from paddle_tpu_torch.ops import registry as treg
from test_torch_train_ops import _f32, _rand, _run_jax, _run_torch


@pytest.fixture(autouse=True, scope="module")
def contained_state():
    """What a module of these tests changes in its worker process, put
    back afterwards: two torch threads while it runs (the suite runs six
    workers on a shared CPU: torch's default of one thread per core
    oversubscribes it and slows the JAX package's wall-time gates), and
    the JAX package's global generator, which the vision models seed and
    draw from (a later test that builds a model without a seed would
    otherwise get other weights)."""
    from paddle_tpu.core import generator
    rng, threads = generator.get_rng_state(), torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    generator.set_rng_state(rng)


_R = np.random.RandomState(0)


def _f(*shape):
    return _rand(_R, shape)


def _bf16(*shape):
    return (_rand(_R, shape), "bfloat16")


def _conv(x, w, **attrs):
    return ("conv2d", {"Input": x, "Filter": w}, attrs, ["Output"])


def _pool(x, **attrs):
    return ("pool2d", {"X": x}, attrs, ["Out"])


def _bn_ins(x, c):
    return {"X": x, "Scale": _f(c), "Bias": _f(c), "Mean": _f(c),
            "Variance": np.abs(_f(c)) + 0.5}


# op type, inputs (numpy; an (array, "bfloat16") tuple is a bf16 input),
# attrs, output slots that receive a cotangent (None: no grad op)
CASES = {
    # LeNet's convolutions, then ResNet's (7x7 stride 2, 3x3, 1x1)
    "conv_pad2": _conv(_f(2, 1, 12, 12), _f(6, 1, 5, 5), paddings=[2, 2]),
    "conv_valid_default": _conv(_f(2, 6, 8, 8), _f(4, 6, 5, 5)),
    "conv_7x7_s2": _conv(_f(2, 3, 16, 16), _f(8, 3, 7, 7), strides=[2, 2],
                         paddings=[3, 3]),
    "conv_1x1_s2": _conv(_f(2, 8, 9, 9), _f(4, 8, 1, 1), strides=[2, 2]),
    "conv_pad4": _conv(_f(2, 3, 9, 10), _f(4, 3, 3, 3), strides=[2, 1],
                       paddings=[1, 2, 0, 1]),
    "conv_same_s2_dil2": _conv(_f(2, 3, 11, 9), _f(4, 3, 3, 2),
                               strides=[2, 2], dilations=[2, 2],
                               padding_algorithm="SAME"),
    "conv_valid_groups": _conv(_f(2, 4, 7, 7), _f(6, 2, 3, 3), groups=2,
                               paddings=[5, 5],
                               padding_algorithm="VALID"),
    "conv_dilation": _conv(_f(2, 3, 10, 10), _f(4, 3, 3, 3),
                           dilations=[2, 3], paddings=[2, 2]),
    "conv_nhwc": _conv(_f(2, 8, 7, 3), _f(5, 3, 3, 3), strides=[2, 1],
                       paddings=[1, 1], data_format="NHWC"),
    "conv_bias": ("conv2d", {"Input": _f(2, 3, 6, 6), "Filter":
                             _f(4, 3, 3, 3), "Bias": _f(4)},
                  {"paddings": [1, 1]}, ["Output"]),
    "conv_bf16": _conv(_bf16(2, 8, 8, 8), _bf16(4, 8, 3, 3), strides=[2, 2],
                       paddings=[1, 1]),
    # pooling: LeNet's 2x2 / 2, ResNet's 3x3 / 2 pad 1 and global avg
    "max_2x2": _pool(_f(2, 3, 8, 8), pooling_type="max", ksize=[2, 2],
                     strides=[2, 2]),
    "max_3x3_s2_p1": _pool(_f(2, 3, 9, 9), pooling_type="max",
                           ksize=[3, 3], strides=[2, 2], paddings=[1, 1]),
    "max_pad4": _pool(_f(2, 3, 8, 7), pooling_type="max", ksize=[3, 2],
                      strides=[2, 2], paddings=[2, 0, 0, 1]),
    "max_same": _pool(_f(2, 3, 7, 8), pooling_type="max", ksize=[3, 3],
                      strides=[2, 3], padding_algorithm="SAME"),
    "avg_exclusive": _pool(_f(2, 3, 9, 9), pooling_type="avg",
                           ksize=[3, 3], strides=[2, 2], paddings=[1, 1],
                           exclusive=True),
    "avg_inclusive": _pool(_f(2, 3, 9, 9), pooling_type="avg",
                           ksize=[3, 3], strides=[2, 2], paddings=[1, 1],
                           exclusive=False),
    "avg_pad4_exclusive": _pool(_f(2, 3, 8, 7), pooling_type="avg",
                                ksize=[3, 3], strides=[2, 2],
                                paddings=[2, 1, 0, 2], exclusive=True),
    "avg_pad4_inclusive": _pool(_f(2, 3, 8, 7), pooling_type="avg",
                                ksize=[3, 3], strides=[2, 2],
                                paddings=[0, 1, 2, 0], exclusive=False),
    "avg_same": _pool(_f(2, 3, 7, 8), pooling_type="avg", ksize=[2, 3],
                      strides=[2, 2], padding_algorithm="SAME"),
    "avg_global": _pool(_f(2, 6, 5, 5), pooling_type="avg",
                        global_pooling=True),
    "max_global": _pool(_f(2, 6, 5, 5), pooling_type="max", ksize=[2, 2],
                        global_pooling=True),
    "avg_adaptive_2x2": _pool(_f(2, 3, 8, 9), pooling_type="avg",
                              ksize=[2, 2], adaptive=True),
    "max_adaptive_2x3": _pool(_f(2, 3, 8, 9), pooling_type="max",
                              ksize=[2, 3], adaptive=True),
    "avg_adaptive_1x1": _pool(_f(2, 3, 8, 9), pooling_type="avg",
                              ksize=[1, 1], adaptive=True),
    # batch_norm
    "bn_train": ("batch_norm", _bn_ins(_f(4, 3, 5, 5), 3),
                 {"momentum": 0.9, "epsilon": 1e-5}, ["Y"]),
    "bn_train_2d": ("batch_norm", _bn_ins(_f(8, 6), 6),
                    {"momentum": 0.8, "epsilon": 1e-3}, ["Y"]),
    "bn_train_nhwc": ("batch_norm", _bn_ins(_f(3, 4, 5, 6), 6),
                      {"momentum": 0.9, "data_format": "NHWC"}, ["Y"]),
    "bn_is_test": ("batch_norm", _bn_ins(_f(4, 3, 5, 5), 3),
                   {"is_test": True}, ["Y"]),
    "bn_global_stats": ("batch_norm", _bn_ins(_f(4, 3, 5, 5), 3),
                        {"use_global_stats": True, "epsilon": 1e-4},
                        ["Y"]),
    # relu, label_smooth, one_hot_v2
    "relu": ("relu", {"X": _f(4, 9)}, {}, ["Out"]),
    "label_smooth": ("label_smooth", {"X": _f(2, 3, 10)},
                     {"epsilon": 0.1}, ["Out"]),
    "label_smooth_prior": ("label_smooth",
                           {"X": _f(2, 3, 10), "PriorDist": _f(10)},
                           {"epsilon": 0.2}, ["Out"]),
    "one_hot_v2": ("one_hot_v2",
                   {"X": np.array([[0, 3, 6, 7], [-1, 2, 5, 1]], np.int64)},
                   {"depth": 7}, None),
}

# the gradients of the running stats' slots, which the port leaves out
_BN_STAT_GRADS = {"Mean@GRAD", "Variance@GRAD"}


def _compare(ref, got, keys, what, tol):
    for k in keys:
        r, g = ref[k], got[k]
        assert dtype_name(g.dtype) == np.dtype(r.dtype).name, (what, k)
        assert tuple(g.shape) == tuple(r.shape), (what, k)
        np.testing.assert_allclose(_f32(g), _f32(r), err_msg=f"{what} {k}",
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(CASES))
def test_op_and_grad_match_jax(name):
    op_type, ins, attrs, ct_slots = CASES[name]
    low = any(isinstance(v, tuple) for v in ins.values())
    ref = _run_jax(op_type, ins, attrs)
    got = _run_torch(op_type, ins, attrs)
    assert set(got) == set(ref), (set(got), set(ref))
    _compare(ref, got, list(ref), op_type, 2e-2 if low else 1e-5)
    if ct_slots is None:
        assert not treg.get_op_info(op_type).has_grad
        return
    rng = np.random.RandomState(1)
    gins = dict(ins)
    gins.update({k: (v if v.dtype.name != "bfloat16"
                     else (v.astype(np.float32), "bfloat16"))
                 for k, v in ref.items()})
    for slot in ct_slots:
        ct = _rand(rng, ref[slot].shape)
        gins[slot + "@GRAD"] = ct if ref[slot].dtype.name != "bfloat16" \
            else (ct, "bfloat16")
    gref = _run_jax(op_type + "_grad", gins, attrs)
    ggot = _run_torch(op_type + "_grad", gins, attrs)
    want = set(gref) - (_BN_STAT_GRADS if op_type == "batch_norm"
                        else set())
    assert set(ggot) == want, (set(ggot), set(gref))
    assert all(np.abs(_f32(gref[k])).max() > 0 for k in want)
    _compare(gref, ggot, sorted(want), op_type + "_grad",
             5e-2 if low else 1e-5)


def test_grad_slots_follow_the_reference_convention():
    from paddle_tpu.ops import registry as jreg
    for t in ("conv2d", "pool2d", "batch_norm", "relu", "label_smooth"):
        j, p = jreg.get_op_info(t + "_grad"), treg.get_op_info(t + "_grad")
        assert [s.name for s in p.inputs] == [s.name for s in j.inputs]
        assert [s.name for s in p.outputs] == [s.name for s in j.outputs]
    assert treg.get_op_info("one_hot_v2_grad") is None


def test_fp32_conv_is_not_tf32_on_the_cpu_flag():
    """`exact_fp32` restores cuDNN's flag, and leaves it alone for CPU
    tensors (the card's check is in test_torch_cuda.py)."""
    from paddle_tpu_torch.ops.kernels.nn import exact_fp32
    prev = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        with exact_fp32(torch.ones(1)):
            assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev


# ---------------------------------------------------------------------------
# reference behaviours the port keeps (ROADMAP.md Queue 3)
# ---------------------------------------------------------------------------
def test_pool_ignores_ceil_mode_and_data_format_as_the_reference():
    """`_pool` reads neither `ceil_mode` nor `data_format`: a 7x7 input
    pooled 2x2 / 2 with ceil_mode gives 3x3 (Paddle: 4x4), and an NHWC
    input is pooled over its last two axes (W and C)."""
    x = _f(2, 7, 7, 4)
    for attrs in ({"pooling_type": "max", "ksize": [2, 2],
                   "strides": [2, 2], "ceil_mode": True},
                  {"pooling_type": "avg", "ksize": [2, 2],
                   "strides": [2, 2], "data_format": "NHWC"}):
        ref = _run_jax("pool2d", {"X": x}, attrs)["Out"]
        got = _run_torch("pool2d", {"X": x}, attrs)["Out"]
        assert ref.shape == tuple(got.shape) == (2, 7, 3, 2)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_static_batch_norm_nhwc_normalises_axis_1_as_the_reference():
    """The static builder writes `data_layout`; the kernel reads
    `data_format` (NCHW by default).  So an NHWC static batch_norm
    normalises axis 1 in both packages: a [2, 4, 4, 4] input (H = C)
    builds and runs, and its Y equals the NCHW formula over axis 1."""
    import paddle_tpu.static as jstatic
    from paddle_tpu.core.program import _reset_unique_names as jreset
    from paddle_tpu_torch import static as tstatic
    from paddle_tpu_torch.core.program import _reset_unique_names as treset
    x = _f(2, 4, 4, 4)
    ys = []
    for pkg, reset, place in ((jstatic, jreset, None),
                              (tstatic, treset, tstatic.CPUPlace())):
        reset()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            xv = pkg.data("x", [2, 4, 4, 4])
            y = pkg.layers.batch_norm(xv, data_layout="NHWC")
        op = [o for o in main.global_block().ops if o.type == "batch_norm"]
        assert op[0].attrs["data_layout"] == "NHWC"
        assert "data_format" not in op[0].attrs
        exe = pkg.Executor(place) if place else pkg.Executor()
        scope = pkg.Scope()
        with pkg.scope_guard(scope):
            exe.run(startup)
            (out,) = exe.run(main, feed={"x": x}, fetch_list=[y])
        ys.append(np.asarray(out, np.float32))
    m = x.mean(axis=(0, 2, 3), keepdims=True)
    v = x.var(axis=(0, 2, 3), keepdims=True)
    np.testing.assert_allclose(ys[0], (x - m) / np.sqrt(v + 1e-5),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ys[1], ys[0], rtol=1e-5, atol=1e-5)
