"""The inference passes this port adds, against the JAX package's:
conv_bn_fuse_pass (a conv-bn net, with and without a conv bias, and
build_resnet50 at a tiny image size) and the bf16 Predictor
(Config.enable_bfloat16: the AMP rewrite after the passes) on a tiny
flash BERT.

Each model is built and initialised by the JAX package and saved with its
save_inference_model; both Predictors load that directory.  The batch
norms' running mean and variance, scale and bias are drawn from a seed
(the startup's 0 / 1 / 1 / 0 would make the fold nearly the identity and
hide a wrong one).

Tolerances: folded filters and biases BITWISE equal to the JAX package's
(both fold on the host in fp32 numpy, in the same order); fp32 outputs
within a normalised max error (max |a - b| / max |b|) of 1e-5 against
the JAX Predictor and against the port's own unfolded pipeline
(delete_pass): with drawn statistics ResNet-50's logits reach ~4e3, and
53 fp32 convolutions summed in other orders part by ~1e-6 of that; the
bf16 program serialized equal to
the JAX package's, its outputs within 2e-2 (atol and rtol, a few bf16
ulps of O(1) values over 2 layers) of the JAX bf16 Predictor's and
within 5e-2 of the fp32 Predictor's."""
import numpy as np
import pytest
import torch

import paddle_tpu.static as jstatic
from paddle_tpu.core.program import _reset_unique_names as jax_reset_names
from paddle_tpu_torch.core.program import (_reset_unique_names as
                                           torch_reset_names)
from paddle_tpu.inference import Config as JConfig, create_predictor as jpred
from paddle_tpu.io.framework_io import save_inference_model as jsave_model

from paddle_tpu_torch.inference import Config as TConfig, create_predictor

from test_torch_baseline_programs import bench_resnet
from test_torch_program import SMALL, build_ref_bert, flash_mode

NORM_FP32 = 1e-5
BF16 = dict(rtol=2e-2, atol=2e-2)
BF16_VS_FP32 = dict(rtol=5e-2, atol=5e-2)


@pytest.fixture(autouse=True, scope="module")
def contained_state():
    """Two torch threads while the module runs (six test workers share the
    CPU), the previous count and the JAX package's generator restored
    after."""
    from paddle_tpu.core import generator
    rng, threads = generator.get_rng_state(), torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    generator.set_rng_state(rng)


def _save_reference(dirname, main, startup, feeds, target, seed=0):
    """Initialise the weights, draw every batch norm's running stats, scale
    and bias from `seed`, save the inference model.  With `startup` the
    JAX startup program initialises the weights; without one (ResNet-50:
    XLA compiles its ~160 initializers for ~15 s) every persistable is
    drawn from `seed` (He-scaled normal weights, zero biases)."""
    scope, exe = jstatic.Scope(), jstatic.Executor()
    rng = np.random.RandomState(seed)
    with jstatic.scope_guard(scope):
        if startup is not None:
            exe.run(startup)
        else:
            for v in main.list_vars():
                if v.persistable and v.shape and min(v.shape) > 0:
                    fan_in = int(np.prod(v.shape[1:])) if len(v.shape) > 1 \
                        else 0
                    w = rng.randn(*v.shape) * np.sqrt(2.0 / fan_in) \
                        if fan_in else np.zeros(v.shape)
                    scope.set(v.name, np.asarray(w, np.float32))
        for op in main.global_block().ops:
            if op.type != "batch_norm":
                continue
            c = np.asarray(scope.get(op.inputs["Scale"][0])).shape
            for slot, draw in (("Scale", lambda: rng.rand(*c) + 0.5),
                               ("Bias", lambda: rng.randn(*c)),
                               ("Mean", lambda: rng.randn(*c)),
                               ("Variance", lambda: rng.rand(*c) + 0.5)):
                scope.set(op.inputs[slot][0],
                          np.asarray(draw(), np.float32))
        jsave_model(dirname, feeds, [target], exe, main)


def _port(dirname, *deleted, bf16=False):
    cfg = TConfig(dirname)
    cfg.disable_gpu()
    for p in deleted:
        cfg.delete_pass(p)
    if bf16:
        cfg.enable_bfloat16()
    return create_predictor(cfg)


def _ref(dirname, bf16=False):
    cfg = JConfig(dirname)
    if bf16:
        cfg.enable_bfloat16()
    return jpred(cfg)


def _check_fold(dirname, feed, n_folds):
    ref, port = _ref(dirname), _port(dirname)
    unfolded = _port(dirname, "conv_bn_fuse_pass")
    assert port._pass_stats.get("conv_bn_fused") == \
        ref._pass_stats.get("conv_bn_fused") == n_folds
    types = [op.type for op in port._program.global_block().ops]
    assert "batch_norm" not in types
    assert types == [op.type for op in ref._program.global_block().ops]
    assert [op.type for op in unfolded._program.global_block().ops].count(
        "batch_norm") == n_folds
    # every value the fold wrote, bitwise
    written = set()
    for op in port._program.global_block().ops:
        if op.type == "conv2d":
            written.add(op.inputs["Filter"][0])
        if op.type == "elementwise_add":
            written.update(n for n in op.inputs["Y"]
                           if n in port._scope.vars)
    assert len(written) >= 2 * n_folds
    for n in written:
        want = np.asarray(ref._scope.get(n))
        got = port._scope.get(n).numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), n
    (want,) = ref.run(feed)
    (got,) = port.run(feed)
    (plain,) = unfolded.run(feed)
    for other in (np.asarray(want), plain):
        err = np.abs(got - other).max() / np.abs(other).max()
        assert err < NORM_FP32, err
    return got


@pytest.mark.parametrize("conv_bias", [False, True])
def test_conv_bn_fold_small_net(tmp_path, conv_bias):
    from paddle_tpu.static import layers
    jax_reset_names()
    main, startup = jstatic.Program(), jstatic.Program()
    with jstatic.program_guard(main, startup):
        x = layers.data("image", [-1, 3, 8, 8])
        h = layers.conv2d(x, 6, 3, padding=1,
                          bias_attr=None if conv_bias else False)
        h = layers.batch_norm(h, act="relu")
        h = layers.conv2d(h, 4, 3, stride=2, bias_attr=False)
        out = layers.batch_norm(h)
    d = str(tmp_path)
    _save_reference(d, main, startup, ["image"], out)
    x = np.random.RandomState(1).randn(2, 3, 8, 8).astype(np.float32)
    _check_fold(d, [x], 2)


def test_conv_bn_fold_resnet50(tmp_path):
    jax_reset_names()
    main, _, _ = bench_resnet.build_resnet50(
        batch=2, img=32, classes=10, use_amp=False)
    logits = [op for op in main.global_block().ops
              if op.type == "softmax_with_cross_entropy"][0] \
        .inputs["Logits"][0]
    d = str(tmp_path)
    _save_reference(d, main, None, ["image"],
                    main.global_block().var(logits))
    x = np.random.RandomState(2).randn(2, 3, 32, 32).astype(np.float32)
    out = _check_fold(d, [x], 53)
    assert out.shape == (2, 10) and np.isfinite(out).all()


def test_conv_bn_fold_needs_a_scope_and_leaves_other_programs():
    """Without a scope the pass does nothing (both packages); a batch
    norm whose conv output has another reader is not folded."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.inference.passes import PassContext, get_pass
    from paddle_tpu_torch.static import layers
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = layers.data("image", [-1, 3, 8, 8])
        c = layers.conv2d(x, 4, 3, bias_attr=False)
        out = layers.elementwise_add(layers.batch_norm(c), c)
    main._set_test_mode()
    before = [op.type for op in main.global_block().ops]
    prog = get_pass("conv_bn_fuse_pass")(main, PassContext())
    assert [op.type for op in prog.global_block().ops] == before
    ctx = PassContext(scope=static.Scope())
    prog = get_pass("conv_bn_fuse_pass")(main, ctx)
    assert [op.type for op in prog.global_block().ops] == before
    assert out.name in [n for op in prog.global_block().ops
                        for n in op.output_names()]


def test_bf16_predictor_tiny_flash_bert(tmp_path):
    d = str(tmp_path)
    with flash_mode(True):
        jax_reset_names()
        # the AMP rewrite names its casts by unique_name: both counters
        # fresh, whatever an earlier test in this process built
        torch_reset_names()
        main, startup, out = build_ref_bert(**SMALL)
        _save_reference(d, main, startup, ["ids", "pos"], out)
        ref16, port16 = _ref(d, bf16=True), _port(d, bf16=True)
        port32 = _port(d)
    assert port16._config.precision_mode() == 3
    assert port16._program.to_dict() == ref16._program.to_dict()
    ops = port16._program.global_block().ops
    flash = [op for op in ops if op.type == "flash_attention"]
    assert len(flash) == SMALL["layers_n"]
    block = port16._program.global_block()
    for op in flash:
        assert all(block.var(n).dtype == "bfloat16"
                   for n in op.input_names())
    # on no AMP list: stays fp32
    fused = [op for op in ops
             if op.type == "fused_embedding_eltwise_layernorm"]
    assert len(fused) == 1 and \
        block.var(fused[0].outputs["Out"][0]).dtype == "float32"
    rng = np.random.RandomState(4)
    feed = [rng.randint(0, SMALL["vocab"], (3, SMALL["seq"]))
            .astype(np.int64),
            np.tile(np.arange(SMALL["seq"], dtype=np.int64), (3, 1))]
    with flash_mode(True):
        (want,) = ref16.run(feed)
        (got,) = port16.run(feed)
        (f32,) = port32.run(feed)
    # numpy has no bf16: a bf16 fetch is its float32 upcast
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **BF16)
    np.testing.assert_allclose(got, f32, **BF16_VS_FP32)
    assert np.abs(got - f32).max() > 0  # the bf16 program really ran


def test_bf16_fetch_is_the_exact_float32_upcast():
    from paddle_tpu_torch.static.executor import as_numpy
    t = torch.randn(5, 3).to(torch.bfloat16)
    a = as_numpy(t)
    assert a.dtype == np.float32
    assert a.tobytes() == t.float().numpy().tobytes()


def test_tensorrt_precision_mode_selects_the_bf16_pipeline(tmp_path):
    from paddle_tpu_torch.inference import PrecisionType
    cfg = TConfig(str(tmp_path))
    cfg.enable_tensorrt_engine(precision_mode=PrecisionType.Bfloat16)
    assert cfg.precision_mode() == PrecisionType.Bfloat16
    cfg.enable_tensorrt_engine()
    assert cfg.precision_mode() == PrecisionType.Float32
