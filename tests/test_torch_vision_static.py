"""The vision tier's static builders against the JAX package's: one
program built from conv3d, conv2d_transpose (filter from output_size
too), conv3d_transpose, data_norm, pool3d, adaptive_pool2d, group_norm,
instance_norm, lrn, resize_bilinear, resize_nearest, pad2d and the nets
simple_img_conv_pool / img_conv_group, trained by SGD.  The JAX
builder's conv2d_transpose cannot derive its filter from `output_size`
(ROADMAP.md Queue 3 item 59): the port's does.  Built in both
packages from reset unique-name counters it serializes equal
(`to_dict`), and from the JAX startup's weights
(`io.load_params_from_numpy`) both executors run it equal: 3 steps'
losses rtol 1e-5 and every persistable atol 1e-5 (fp32)."""
import numpy as np

import paddle_tpu.static as jstatic
import paddle_tpu.static.nets as jnets
from paddle_tpu.core.program import _reset_unique_names as jreset
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core.program import _reset_unique_names as treset
from paddle_tpu_torch.static import nets as tnets
from test_torch_baseline_train import _assert_state_close, _train_both
from test_torch_vision_ops import contained_state  # noqa: F401


def vision_program(static, nets):
    layers = static.layers
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        im = layers.data("image", [-1, 3, 8, 8])
        vol = layers.data("vol", [-1, 2, 4, 6, 6])
        tab = layers.data("tab", [-1, 4])
        a = nets.simple_img_conv_pool(im, 4, 3, 2, 2, act="relu")
        b = nets.img_conv_group(im, [4, 4], 2, conv_act="relu",
                                conv_with_batchnorm=[True, False],
                                pool_stride=2)
        h = layers.group_norm(b, 2)
        h = layers.instance_norm(h)
        h = layers.lrn(h, n=3)
        h = layers.pad2d(h, [1, 0, 0, 1], mode="reflect")
        h = layers.conv2d_transpose(h, 3, filter_size=3, stride=2,
                                    padding=1)
        h = layers.conv2d_transpose(h, 2, output_size=[20, 20],
                                    filter_size=[3, 3], stride=2)
        h = layers.resize_bilinear(h, out_shape=[6, 5], align_corners=False)
        h = layers.resize_nearest(h, scale=2.0)
        h = layers.adaptive_pool2d(h, [2, 2], pool_type="avg")
        v = layers.conv3d(vol, 3, 3, padding=1, act="relu")
        v = layers.pool3d(v, 2, "max", 2)
        v = layers.conv3d_transpose(v, 2, filter_size=2, stride=2)
        d = layers.data_norm(tab)
        loss = layers.elementwise_add(
            layers.elementwise_add(layers.mean(layers.square(h)),
                                   layers.mean(layers.square(v))),
            layers.elementwise_add(layers.mean(layers.square(d)),
                                   layers.mean(layers.square(a))))
        static.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _feed():
    r = np.random.RandomState(0)
    return {"image": r.randn(2, 3, 8, 8).astype(np.float32),
            "vol": r.randn(2, 2, 4, 6, 6).astype(np.float32),
            "tab": r.randn(2, 4).astype(np.float32)}


def test_vision_builders_serialize_and_train_as_the_jax_package():
    jreset()
    ref = vision_program(jstatic, jnets)
    treset()
    port = vision_program(tstatic, tnets)
    assert port[0].to_dict() == ref[0].to_dict()
    assert port[1].to_dict() == ref[1].to_dict()
    types = {op.type for op in port[0].global_block().ops}
    assert {"conv3d", "conv2d_transpose", "conv3d_transpose", "data_norm",
            "pool3d", "pool2d", "group_norm", "instance_norm", "lrn",
            "bilinear_interp", "nearest_interp", "pad2d", "batch_norm",
            "conv3d_grad", "conv2d_transpose_grad", "group_norm_grad",
            "bilinear_interp_grad"} <= types
    ref_l, got_l, jscope, tscope, init = _train_both(ref, port, _feed(), 3)
    np.testing.assert_allclose(got_l, ref_l, rtol=1e-5)
    assert ref_l[-1] < ref_l[0]
    fixed = _assert_state_close(jscope, tscope, init, atol=1e-5)
    # what the steps leave alone: the lr, data_norm's statistics, and the
    # group norm's scale, whose gradient instance_norm cancels
    assert sorted(fixed) == [
        "data_norm_0_BatchSize_0", "data_norm_0_BatchSquareSum_0",
        "data_norm_0_BatchSum_0", "group_norm_0.w_0", "learning_rate_0"]


def test_conv2d_transpose_filter_from_output_size_item_59():
    """Queue 3 item 59: the JAX conv2d_transpose builder derives the
    filter from `output_size` with `range(2)`, which in its layers module
    is the generated `range` op builder, so it raises; the port's uses
    the builtin (as the JAX conv3d_transpose builder does) and builds a
    [Cin, Cout, k, k] filter whose output is `output_size`."""
    import pytest
    jreset()
    main, startup = jstatic.Program(), jstatic.Program()
    with jstatic.program_guard(main, startup):
        x = jstatic.layers.data("x", [-1, 3, 5, 5])
        with pytest.raises(AttributeError):
            jstatic.layers.conv2d_transpose(x, 2, output_size=[11, 11],
                                            stride=2)
    treset()
    main, startup = tstatic.Program(), tstatic.Program()
    with tstatic.program_guard(main, startup):
        x = tstatic.layers.data("x", [-1, 3, 5, 5])
        y = tstatic.layers.conv2d_transpose(x, 2, output_size=[11, 11],
                                            stride=2)
    op = [o for o in main.global_block().ops
          if o.type == "conv2d_transpose"][0]
    w = main.global_block().var(op.inputs["Filter"][0])
    assert list(w.shape) == [3, 2, 3, 3]
    exe = tstatic.Executor(tstatic.CPUPlace())
    with tstatic.scope_guard(tstatic.Scope()):
        exe.run(startup)
        (out,) = exe.run(main, feed={"x": np.ones((1, 3, 5, 5),
                                                  np.float32)},
                         fetch_list=[y])
    assert out.shape == (1, 2, 11, 11)


def test_nn_initializer_names_build_the_jax_startup_program():
    """paddle.nn.initializer's 2.0 names: the port exports the JAX
    module's, and each, as a parameter's initializer, writes the same
    startup op with the same attrs (programs serialize equal)."""
    import paddle_tpu.nn.initializer as jinit
    import paddle_tpu_torch.nn.initializer as tinit
    from paddle_tpu.static import ParamAttr as JAttr
    from paddle_tpu_torch.static import ParamAttr as TAttr
    names = [n for n in dir(jinit) if not n.startswith("_")
             and isinstance(getattr(jinit, n), type)]
    assert names and all(hasattr(tinit, n) for n in names), names
    kinds = [("Uniform", (-0.5, 0.5)), ("TruncatedNormal", (0.0, 0.02)),
             ("XavierNormal", ()), ("XavierUniform", ()),
             ("KaimingNormal", ()), ("KaimingUniform", ()), ("MSRA", ()),
             ("Constant", (0.3,)), ("Normal", (0.0, 2.0))]
    progs = []
    for static, init, attr, reset in ((jstatic, jinit, JAttr, jreset),
                                      (tstatic, tinit, TAttr, treset)):
        reset()
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            x = static.layers.data("x", [-1, 6])
            for name, args in kinds:
                static.layers.fc(x, 4, param_attr=attr(
                    initializer=getattr(init, name)(*args)))
        progs.append(startup.to_dict())
    assert progs[1] == progs[0]
