"""The quantization tier against the JAX package: every op of
ops/kernels/quantize.py, the int8_matmul accumulators, the slim passes
(QuantizationTransformPass, QuantizationFreezePass, freeze_weights_int8,
PostTrainingQuantization) and PTQ-frozen models through both Predictors.

Inputs are seeded numpy arrays handed to both packages; weights cross
from the reference scope into the port with load_params_from_numpy.

Tolerances: int8 grids (the float values of fake_quantize_*, the int8
tensors of quantize / requantize, frozen int8 weights and their scales)
BITWISE; the int32 accumulators of int8_matmul EQUAL; fp32 outputs 1e-6
(the same formulas, one division or multiplication apart at most);
programs serialized equal.  End to end, the frozen models follow the JAX
package's own bound (tests/test_int8_execution.py: normalised error
< 0.1 against the float model), the port's error against fp32 is at
most 1.5x the reference's, and the two Predictors agree within 1e-5
(the tiny BERT's calibrated activation scales cross from the reference
scope first: calibration sums in another order, and an ulp of a scale
moves a rounding boundary of the activation grid)."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.static as jstatic
from paddle_tpu.core.program import _reset_unique_names as jax_reset_names
from paddle_tpu.inference import Config as JConfig, create_predictor as jpred
from paddle_tpu.io.framework_io import save_inference_model as jsave_model
from paddle_tpu.ops import registry as jreg
import paddle_tpu.slim as jslim
from paddle_tpu.slim.quantization import freeze_weights_int8 as jfreeze8

import paddle_tpu_torch.static as tstatic
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.core.program import (_reset_unique_names as
                                           torch_reset_names)
from paddle_tpu_torch.inference import Config as TConfig, create_predictor
from paddle_tpu_torch.io import (load_params_from_numpy,
                                 save_inference_model as tsave_model)
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.ops.kernels import quantize as tq
import paddle_tpu_torch.slim as tslim

from test_torch_program import SMALL, build_ref_bert, flash_mode
from test_torch_train_ops import _run_jax, _run_torch

FP32 = dict(rtol=1e-6, atol=1e-6)
E2E_BOUND = 0.1        # tests/test_int8_execution.py:133
E2E_RATIO = 1.5        # the port's error over the reference's


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


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_bits(a, b, what):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype)
    assert a.tobytes() == b.tobytes(), (what, np.abs(
        a.astype(np.float64) - b.astype(np.float64)).max())


R = np.random.RandomState(0)
X = R.randn(6, 8).astype(np.float32) * 3
W4 = R.randn(4, 3, 2, 2).astype(np.float32)
XQ = np.clip(np.round(R.randn(6, 8) * 40), -127, 127).astype(np.float32)

# (op, inputs, attrs, output slots held bitwise, output slots held 1e-6)
OP_CASES = [
    ("fake_quantize_abs_max", {"X": X}, {}, ["Out", "OutScale"], []),
    ("fake_quantize_abs_max", {"X": X}, {"bit_length": 4},
     ["Out", "OutScale"], []),
    ("fake_channel_wise_quantize_abs_max", {"X": W4}, {"quant_axis": 0},
     ["Out", "OutScale"], []),
    ("fake_channel_wise_quantize_abs_max", {"X": X}, {"quant_axis": 1},
     ["Out", "OutScale"], []),
    ("fake_dequantize_max_abs",
     {"X": XQ, "Scale": np.asarray([2.5], np.float32)},
     {"max_range": 127.0}, [], ["Out"]),
    ("fake_channel_wise_dequantize_max_abs",
     {"X": XQ, "Scales": [np.abs(R.randn(8)).astype(np.float32) + .1]},
     {"quant_axis": 1}, [], ["Out"]),
    ("fake_channel_wise_dequantize_max_abs",
     {"X": XQ, "Scales": [np.abs(R.randn(6)).astype(np.float32) + .1,
                          np.asarray([3.0], np.float32)]},
     {"quant_axis": 0}, [], ["Out"]),
    ("quantize", {"Input": X}, {"Scale": 127.0 / 9.0}, ["Output"], []),
    ("quantize", {"Input": np.abs(X)},
     {"Scale": 20.0, "is_negative_input": False}, ["Output"], []),
    ("dequantize", {"Input": XQ.astype(np.int8)}, {"Scale": 14.1}, [],
     ["Output"]),
    ("requantize", {"Input": XQ.astype(np.int8)},
     {"Scale_in": 14.1, "Scale_out": 7.05}, ["Output"], []),
    ("fake_quantize_dequantize_abs_max", {"X": X}, {}, ["Out", "OutScale"],
     []),
    ("fake_channel_wise_quantize_dequantize_abs_max", {"X": W4},
     {"quant_axis": 0}, ["Out", "OutScale"], []),
    ("fake_quantize_moving_average_abs_max",
     {"X": X, "InScale": np.asarray([4.0], np.float32),
      "InState": np.asarray([1.9], np.float32),
      "InAccum": np.asarray([7.3], np.float32)},
     {"moving_rate": 0.9}, ["Out"], ["OutScale", "OutState", "OutAccum"]),
    ("fake_quantize_moving_average_abs_max",
     {"X": X, "InScale": np.asarray([4.0], np.float32)},
     {"is_test": True}, ["Out", "OutScale"], []),
    ("fake_quantize_dequantize_moving_average_abs_max",
     {"X": X, "InScale": np.asarray([4.0], np.float32),
      "InState": np.asarray([1.9], np.float32),
      "InAccum": np.asarray([7.3], np.float32)},
     {}, ["Out"], ["OutScale", "OutState", "OutAccum"]),
    ("fake_quantize_dequantize_moving_average_abs_max",
     {"X": X, "InScale": np.asarray([4.0], np.float32)},
     {"is_test": True}, ["Out", "OutScale"], []),
    ("moving_average_abs_max_scale",
     {"X": X, "InState": np.asarray([1.9], np.float32),
      "InAccum": np.asarray([7.3], np.float32)},
     {}, ["Out"], ["OutScale", "OutState", "OutAccum"]),
]


@pytest.mark.parametrize("case", OP_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(OP_CASES)])
def test_quantize_op_matches_reference(case):
    op, ins, attrs, exact, close = case
    ref = _run_jax(op, ins, attrs)
    got = _run_torch(op, ins, attrs)
    for k in exact:
        _same_bits(ref[k], got[k], f"{op}.{k}")
    for k in close:
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]),
                                   err_msg=f"{op}.{k}", **FP32)


@pytest.mark.parametrize("op", [
    "fake_quantize_dequantize_abs_max",
    "fake_channel_wise_quantize_dequantize_abs_max",
    "fake_quantize_dequantize_moving_average_abs_max",
    "moving_average_abs_max_scale"])
def test_straight_through_gradient(op):
    g = R.randn(6, 8).astype(np.float32)
    ins = {"X": X, "Out@GRAD": g}
    ref = jreg.get_op_info(op + "_grad").kernel(
        {k: jnp.asarray(v) for k, v in ins.items()}, {}, jreg.OpContext())
    got = treg.get_op_info(op + "_grad").kernel(
        {k: torch.from_numpy(v) for k, v in ins.items()}, {},
        treg.OpContext())
    _same_bits(np.asarray(ref["X@GRAD"]), got["X@GRAD"], op)
    _same_bits(g, got["X@GRAD"], op)


@pytest.mark.parametrize("rows,k,n,per_channel,bias", [
    (5, 8, 4, False, True), (5, 8, 4, True, False),
    (40, 32, 24, True, True), (3, 7, 5, True, True)])
def test_int8_matmul_accumulators_and_output(rows, k, n, per_channel,
                                             bias):
    rng = np.random.RandomState(rows * 100 + k)
    x = rng.randn(rows, k).astype(np.float32)
    w = rng.randn(k, n).astype(np.float32)
    s = np.abs(w).max(axis=0) if per_channel \
        else np.asarray([np.abs(w).max()], np.float32)
    wq = np.clip(np.round(w / s * 127.0), -127, 127).astype(np.int8)
    ins = {"X": x, "W": wq, "WScale": s.astype(np.float32)}
    if bias:
        ins["Bias"] = rng.randn(n).astype(np.float32)
    ref = _run_jax("int8_matmul", ins, {"max_range": 127.0})
    got = _run_torch("int8_matmul", ins, {"max_range": 127.0})
    np.testing.assert_allclose(_np(got["Out"]), ref["Out"], **FP32)
    # the int32 accumulators: the reference's own quantization of x and
    # its dot_general, against the port's int8_product on the same xq
    xf = jnp.asarray(x)
    xs = 127.0 / jnp.maximum(jnp.max(jnp.abs(xf)), 1e-8)
    jxq = jnp.clip(jnp.round(xf * xs), -127, 127).astype(jnp.int8)
    jacc = jax.lax.dot_general(jxq, jnp.asarray(wq),
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    tx = torch.from_numpy(x)
    txs = 127.0 / torch.clamp_min(tx.abs().max(), 1e-8)
    txq = torch.clamp(torch.round(tx * txs), -127, 127).to(torch.int8)
    _same_bits(np.asarray(jxq), txq, "xq")
    _same_bits(np.asarray(jacc), tq.int8_product(txq, torch.from_numpy(wq)),
               "acc")


def test_int8_product_refuses_nothing_on_cpu_and_counts_no_launch():
    """A CPU tensor takes the plain version: no _int_mm launch counted."""
    before = tq.int8_product.launches
    a = torch.randint(-127, 128, (3, 5), dtype=torch.int8)
    b = torch.randint(-127, 128, (5, 2), dtype=torch.int8)
    torch.testing.assert_close(tq.int8_product(a, b),
                               a.int() @ b.int(), rtol=0, atol=0)
    assert tq.int8_product.launches == before


# -- the passes ---------------------------------------------------------------
def _mlp(pkg_static, act_quant_layers=False):
    from importlib import import_module
    layers = import_module(pkg_static.__name__ + ".layers")
    main, startup = pkg_static.Program(), pkg_static.Program()
    with pkg_static.program_guard(main, startup):
        x = layers.data("x", [-1, 8])
        h = layers.fc(x, 16, act="relu")
        pred = layers.fc(h, 3, act="softmax")
    return main, startup, pred


def _both(builder):
    jax_reset_names()
    ref = builder(jstatic)
    torch_reset_names()
    port = builder(tstatic)
    return ref, port


def _init_both(jstartup, jmain):
    """Run the reference startup; copy every persistable into a port
    scope on the CPU.  Returns (jax scope, port scope, jax executor, port
    executor)."""
    jscope, tscope = jstatic.Scope(), tstatic.Scope()
    jexe = jstatic.Executor()
    with jstatic.scope_guard(jscope):
        jexe.run(jstartup)
    params = {v.name: np.asarray(jscope.get(v.name))
              for v in jmain.list_vars() if v.persistable
              and jscope.get(v.name) is not None}
    load_params_from_numpy(tscope, params, CPUPlace())
    return jscope, tscope, jexe, tstatic.Executor(CPUPlace())


def _calib(n, rows=8, width=8, seed=2):
    rng = np.random.RandomState(seed)
    return [{"x": rng.rand(rows, width).astype(np.float32)}
            for _ in range(n)]


def test_transform_pass_program_and_forward_equal():
    """QAT transform on a training build (startup initializers added):
    programs equal; one forward from the same weights equal (Out 1e-6,
    the moving-average state outputs 1e-6)."""
    def build(pkg):
        main, startup, pred = _mlp(pkg)
        mod = jslim if pkg is jstatic else tslim
        mod.QuantizationTransformPass().apply(main, startup)
        return main, startup, pred

    (jm, js, jp), (tm, ts, tp) = _both(build)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    assert tm._n_quantized_inputs == jm._n_quantized_inputs == 4
    jscope, tscope, jexe, texe = _init_both(js, jm)
    feed = _calib(1)[0]
    state = [op.outputs["OutState"][0] for op in tm.global_block().ops
             if op.type.endswith("moving_average_abs_max")]
    with jstatic.scope_guard(jscope):
        want = jexe.run(jm, feed=feed, fetch_list=[jp] + state)
    got = texe.run(tm, feed=feed, fetch_list=[tp.name] + state,
                   scope=tscope)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, np.asarray(a), **FP32)


def test_freeze_pass_program_and_int8_weights_bitwise():
    def build(pkg):
        main, startup, pred = _mlp(pkg)
        infer = main.clone(for_test=True)
        mod = jslim if pkg is jstatic else tslim
        mod.QuantizationTransformPass(
            weight_quantize_type="abs_max").apply(infer)
        return infer, startup, pred

    (jm, js, jp), (tm, ts, tp) = _both(build)
    jscope, tscope, _, _ = _init_both(js, jm)
    jslim.QuantizationFreezePass().apply(jm, jscope)
    tslim.QuantizationFreezePass().apply(tm, tscope)
    assert tm.to_dict() == jm.to_dict()
    frozen = [v.name for v in tm.list_vars()
              if ".int8" in v.name or ".deq_scale" in v.name]
    assert len(frozen) == 4
    for n in frozen:
        _same_bits(np.asarray(jscope.get(n)), tscope.get(n), n)
    assert tscope.get(frozen[0]).dtype in (torch.int8, torch.float32)


def test_freeze_weights_int8_program_weights_and_outputs():
    (jm, js, jp), (tm, ts, tp) = _both(_mlp)
    jscope, tscope, jexe, texe = _init_both(js, jm)
    ji, ti = jm.clone(for_test=True), tm.clone(for_test=True)
    assert jfreeze8(ji, jscope) == \
        tslim.freeze_weights_int8(ti, tscope) == 2
    assert ti.to_dict() == ji.to_dict()
    for n in [v.name for v in ti.list_vars() if v.name.endswith(
            (".int8", ".deq_scale"))]:
        _same_bits(np.asarray(jscope.get(n)), tscope.get(n), n)
    feed = _calib(1)[0]
    with jstatic.scope_guard(jscope):
        (want,) = jexe.run(ji, feed=feed, fetch_list=[jp])
    (got,) = texe.run(ti, feed=feed, fetch_list=[tp.name], scope=tscope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def _ptq_both(builder, feeds_fn):
    """PTQ on both packages from the same weights: returns (jax quant
    program, port quant program, scopes, executors, float outputs)."""
    (jm, js, jout), (tm, ts, tout) = _both(builder)
    jscope, tscope, jexe, texe = _init_both(js, jm)
    feeds = feeds_fn()
    with jstatic.scope_guard(jscope):
        jq = jslim.PostTrainingQuantization(
            jexe, jm, list(feeds[0]), scope=jscope).quantize(feeds)
    tq_prog = tslim.PostTrainingQuantization(
        texe, tm, list(feeds[0]), scope=tscope).quantize(feeds)
    return jm, jq, jout, tm, tq_prog, tout, jscope, tscope, jexe, texe


def _check_ptq_programs(jq, tq_prog, jscope, tscope):
    assert tq_prog.to_dict() == jq.to_dict()
    block = tq_prog.global_block()
    n_int8 = 0
    for v in tq_prog.list_vars():
        if v.dtype == "int8" or v.name.endswith(".deq_scale") or \
                ".deq_scale_" in v.name:
            _same_bits(np.asarray(jscope.get(v.name)), tscope.get(v.name),
                       v.name)
            n_int8 += v.dtype == "int8"
    # calibrated activation scales: the same batches through two fp32
    # executors (summation order may differ by an ulp)
    for op in block.ops:
        if op.type == "fake_quantize_dequantize_moving_average_abs_max":
            n = op.inputs["InScale"][0]
            np.testing.assert_allclose(tscope.get(n).numpy(),
                                       np.asarray(jscope.get(n)), **FP32)
    return n_int8


def _predictors(tmp_path, feed_names, jq, jout, tq_prog, tout, jscope,
                tscope, jexe, texe, flash=None):
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    with jstatic.scope_guard(jscope):
        jsave_model(jd, feed_names, [jout], jexe, jq)
    with tstatic.scope_guard(tscope):
        tsave_model(td, feed_names, [tout], texe, tq_prog)
    ctx = flash_mode(flash) if flash is not None else \
        contextlib.nullcontext()
    with ctx:
        ref = jpred(JConfig(jd))
        cfg = TConfig(td)
        cfg.disable_gpu()
        port = create_predictor(cfg)
    return ref, port


def _no_float_product_over_int8(program):
    block = program.global_block()
    producer = {n: op for op in block.ops for n in op.output_names()}
    for op in block.ops:
        if op.type in ("mul", "fc", "matmul", "matmul_v2"):
            w = op.inputs.get("W" if op.type == "fc" else "Y", [None])[0]
            p = producer.get(w)
            assert p is None or not p.type.startswith("fake_"), \
                f"{op.type} still reads dequantized {w}"


def _err(out, ref):
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-6))


def test_ptq_mlp_programs_weights_and_predictors(tmp_path):
    (jm, jq, jout, tm, tq_prog, tout, jscope, tscope, jexe,
     texe) = _ptq_both(_mlp, lambda: _calib(4))
    assert _check_ptq_programs(jq, tq_prog, jscope, tscope) == 2
    x = _calib(1, seed=5)[0]["x"]
    with jstatic.scope_guard(jscope):
        (float_out,) = jexe.run(jm, feed={"x": x}, fetch_list=[jout])
    ref, port = _predictors(tmp_path, ["x"], jq, jout, tq_prog, tout,
                            jscope, tscope, jexe, texe)
    types = [op.type for op in port._program.global_block().ops]
    assert types.count("int8_matmul") == 2, types
    assert not any(t in ("mul", "fc") for t in types), types
    _no_float_product_over_int8(port._program)
    assert port._pass_stats.get("int8_matmul_rewritten") == 2
    # the Predictor lays each int8 weight out column-major once
    for op in port._program.global_block().ops:
        if op.type == "int8_matmul":
            w = port._scope.get(op.inputs["W"][0])
            assert w.dtype == torch.int8 and w.stride() == (1, w.shape[0])
    (want,) = ref.run([x])
    (got,) = port.run([x])
    e_ref, e_port = _err(np.asarray(want), float_out), _err(got, float_out)
    assert e_port < E2E_BOUND and e_port <= E2E_RATIO * e_ref + 1e-6, \
        (e_port, e_ref)
    # on 2-D activations both packages run the same int8_matmul ops
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def _bert(pkg):
    if pkg is jstatic:
        return build_ref_bert(**SMALL)
    from paddle_tpu_torch.models import build_bert_base
    return build_bert_base(use_amp=False, **SMALL)


def _bert_feeds(n=4, batch=2, seed=3):
    rng = np.random.RandomState(seed)
    pos = np.tile(np.arange(SMALL["seq"], dtype=np.int64), (batch, 1))
    return [{"ids": rng.randint(0, SMALL["vocab"], (batch, SMALL["seq"]))
             .astype(np.int64), "pos": pos} for _ in range(n)]


def test_ptq_tiny_bert_programs_weights_and_predictors(tmp_path):
    with flash_mode(True):
        (jm, jq, jout, tm, tq_prog, tout, jscope, tscope, jexe,
         texe) = _ptq_both(_bert, _bert_feeds)
    # 6 projections a layer: q, k, v, out, fc1, fc2
    n_proj = 6 * SMALL["layers_n"]
    assert _check_ptq_programs(jq, tq_prog, jscope, tscope) == n_proj
    # the calibrated activation scales, held at 1e-6 above, cross from
    # the reference scope
    for op in tq_prog.global_block().ops:
        if op.type == "fake_quantize_dequantize_moving_average_abs_max":
            n = op.inputs["InScale"][0]
            tscope.set(n, torch.from_numpy(np.array(jscope.get(n))))
    feed = _bert_feeds(1, seed=9)[0]
    with jstatic.scope_guard(jscope):
        (float_out,) = jexe.run(jm, feed=feed, fetch_list=[jout])
    ref, port = _predictors(tmp_path, ["ids", "pos"], jq, jout, tq_prog,
                            tout, jscope, tscope, jexe, texe, flash=True)
    assert port._program.to_dict() == ref._program.to_dict()
    # quant_int8_pass rewrites 2-D activations only: BERT's [B, S, H]
    # projections stay, in both packages, on the fp32 product of the
    # dequantized int8 weight
    types = [op.type for op in port._program.global_block().ops]
    assert types.count("int8_matmul") == 0, types
    assert types.count("mul") == n_proj and "flash_attention" in types
    assert "int8_matmul_rewritten" not in port._pass_stats
    (want,) = ref.run([feed["ids"], feed["pos"]])
    (got,) = port.run([feed["ids"], feed["pos"]])
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    float_out = np.asarray(float_out)
    e_ref, e_port = _err(np.asarray(want), float_out), _err(got, float_out)
    assert e_port < E2E_BOUND and e_port <= E2E_RATIO * e_ref, \
        (e_port, e_ref)


def test_ptq_rejects_a_qat_program():
    (jm, js, jp), (tm, ts, tp) = _both(_mlp)
    tslim.QuantizationTransformPass().apply(tm)
    with pytest.raises(ValueError, match="FLOAT inference"):
        tslim.PostTrainingQuantization(
            tstatic.Executor(CPUPlace()), tm, ["x"],
            scope=tstatic.Scope()).quantize(_calib(1))
    with pytest.raises(ValueError, match="unsupported PTQ algo"):
        tslim.PostTrainingQuantization(
            tstatic.Executor(CPUPlace()), tm, ["x"], algo="kl")
