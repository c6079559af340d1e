"""The binary proto program container, held against paddle_tpu: the same
program serialized by both packages gives equal ProgramDesc messages, a
`PTIM` model directory written by either package loads in the other with
equal fetches (1e-6, fp32), and the attr type fidelity cases of
tests/test_serialization.py pass on the port (mirrors that file)."""
import numpy as np
import pytest
import torch

import paddle_tpu.static as jstatic
from paddle_tpu.core import framework_pb2 as jpb
from paddle_tpu.core.program import Program as JProgram
from paddle_tpu.core.program import _reset_unique_names as jreset
from paddle_tpu.io.framework_io import (
    load_inference_model as jload_model, save_inference_model as jsave_model)

import paddle_tpu_torch.static as tstatic
from paddle_tpu_torch.core import framework_pb2 as tpb
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.program import _reset_unique_names as treset
from paddle_tpu_torch.core.serialization import (
    program_to_proto, serialize_program)
from paddle_tpu_torch.io.framework_io import (
    load_inference_model as tload_model, save_inference_model as tsave_model)

CPU = tstatic.CPUPlace()


def small_program(static):
    """tests/test_serialization.py's program, from either package."""
    from importlib import import_module
    layers = import_module(static.__name__ + ".layers")
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = layers.data("x", [-1, 8])
        y = layers.data("y", [-1, 1])
        h = layers.fc(x, 16, act="relu",
                      param_attr=static.ParamAttr(
                          initializer=static.Constant(0.3)))
        pred = layers.fc(h, 1,
                         param_attr=static.ParamAttr(
                             initializer=static.Constant(0.1)))
        loss = layers.mean(layers.square(layers.elementwise_sub(pred, y)))
        static.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss, pred


def both_programs():
    jreset()
    j = small_program(jstatic)
    treset()
    t = small_program(tstatic)
    return j, t


def test_descriptor_is_the_jax_packages():
    """One serialized file descriptor in both packages (the default pool
    took it twice), so one wire format."""
    assert tpb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
    assert tpb.DESCRIPTOR.name == "paddle_tpu/core/framework.proto"
    assert tpb.DESCRIPTOR.package == "paddle_tpu.framework"


@pytest.mark.parametrize("which", ["main", "startup"])
def test_same_program_gives_equal_programdesc_messages(which):
    (jm, js, _, _), (tm, ts, _, _) = both_programs()
    jp, tp = (jm, tm) if which == "main" else (js, ts)
    assert tp.to_dict() == jp.to_dict()
    # compared as messages: protobuf map order is not fixed
    jmsg = jpb.ProgramDesc.FromString(jp.serialize_to_string(format="proto"))
    tmsg = jpb.ProgramDesc.FromString(tp.serialize_to_string(format="proto"))
    assert tmsg == jmsg
    assert program_to_proto(tp) == tpb.ProgramDesc.FromString(
        serialize_program(tp))


def test_proto_bytes_parse_in_the_other_package():
    (jm, _, _, _), (tm, _, _, _) = both_programs()
    assert TProgram.parse_from_string(
        jm.serialize_to_string(format="proto")).to_dict() == jm.to_dict()
    assert JProgram.parse_from_string(
        tm.serialize_to_string(format="proto")).to_dict() == tm.to_dict()


def test_proto_roundtrip_runs_identically():
    _, (main, startup, loss, _) = both_programs()
    data = main.serialize_to_string(format="proto")
    assert not data.lstrip().startswith(b"{")
    clone = TProgram.parse_from_string(data)
    assert clone.fingerprint() == main.fingerprint()
    rng = np.random.RandomState(0)
    xb = rng.rand(4, 8).astype(np.float32)
    yb = rng.rand(4, 1).astype(np.float32)
    outs = []
    for prog in (main, clone):
        scope = tstatic.Scope()
        with tstatic.scope_guard(scope):
            exe = tstatic.Executor(CPU)
            exe.run(startup)
            outs.append([float(exe.run(prog, feed={"x": xb, "y": yb},
                                       fetch_list=[loss.name])[0])
                         for _ in range(3)])
    assert outs[0] == outs[1]


def test_json_and_proto_agree():
    _, (main, _, _, _) = both_programs()
    via_json = TProgram.parse_from_string(main.serialize_to_string())
    via_proto = TProgram.parse_from_string(
        main.serialize_to_string(format="proto"))
    assert via_json.fingerprint() == via_proto.fingerprint()


def test_attr_type_fidelity():
    p = TProgram()
    b = p.global_block()
    b.create_var("x", [2, 2])
    attrs = {"i": 7, "f": 0.5, "s": "hello", "b_true": True,
             "b_false": False, "ints": [1, 2, 3], "floats": [1.5, 2.5],
             "strs": ["a", "b"], "bools": [True, False], "empty": [],
             "nested": {"k": [1, 2], "s": "v"}, "none": None}
    b.append_op("scale", {"X": ["x"]}, {"Out": ["x"]}, dict(attrs))
    clone = TProgram.parse_from_string(p.serialize_to_string(format="proto"))
    got = clone.global_block().ops[0].attrs
    for k, v in attrs.items():
        assert got[k] == v, (k, got[k], v)
    assert isinstance(got["i"], int) and isinstance(got["f"], float)
    assert got["b_true"] is True and got["none"] is None


def test_mixed_type_lists_and_var_type_roundtrip():
    p = TProgram()
    b = p.global_block()
    v = b.create_var("rows", [10, 4])
    v.attrs["var_type"] = "SELECTED_ROWS"
    b.append_op("scale", {"X": ["rows"]}, {"Out": ["rows"]},
                {"mixed_if": [1, 2.5], "mixed_bi": [True, 2]})
    for fmt in ("json", "proto"):
        clone = TProgram.parse_from_string(p.serialize_to_string(format=fmt))
        got = clone.global_block().ops[0].attrs
        assert got["mixed_if"] == [1, 2.5], (fmt, got)
        assert got["mixed_bi"] == [True, 2], (fmt, got)
        assert clone.global_block().var("rows").attrs["var_type"] == \
            "SELECTED_ROWS", fmt
        again = TProgram.parse_from_string(
            clone.serialize_to_string(format=fmt))
        assert again.global_block().var("rows").attrs["var_type"] == \
            "SELECTED_ROWS", fmt


def test_unserializable_attr_raises():
    p = TProgram()
    b = p.global_block()
    b.create_var("x", [2])
    b.append_op("scale", {"X": ["x"]}, {"Out": ["x"]}, {"bad": {"o": object()}})
    with pytest.raises(TypeError, match="proto-serializable"):
        p.serialize_to_string(format="proto")


def _startup_values(static_pkg, startup, exe_place=None):
    scope = static_pkg.Scope()
    with static_pkg.scope_guard(scope):
        exe = static_pkg.Executor(exe_place) if exe_place is not None \
            else static_pkg.Executor()
        exe.run(startup)
    return scope, exe


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ptim_model_dir_loads_in_the_other_package(tmp_path, writer):
    (jm, js, _, jpred), (tm, ts, _, tpred) = both_programs()
    x = np.random.RandomState(1).rand(5, 8).astype(np.float32)
    d = str(tmp_path / "model")
    if writer == "jax":
        scope, exe = _startup_values(jstatic, js)
        with jstatic.scope_guard(scope):
            jsave_model(d, ["x"], [jpred], exe, main_program=jm,
                        model_format="proto")
            prog, feeds, fetches = jload_model(d, exe)
            ref = np.asarray(exe.run(prog, feed={"x": x},
                                     fetch_list=fetches)[0])
        scope = tstatic.Scope()
        with tstatic.scope_guard(scope):
            exe = tstatic.Executor(CPU)
            prog, feeds, fetches = tload_model(d, exe)
            got = exe.run(prog, feed={"x": x}, fetch_list=fetches)[0]
    else:
        scope, exe = _startup_values(tstatic, ts, CPU)
        with tstatic.scope_guard(scope):
            tsave_model(d, ["x"], [tpred], exe, main_program=tm,
                        model_format="proto")
            prog, feeds, fetches = tload_model(d, exe)
            ref = exe.run(prog, feed={"x": x}, fetch_list=fetches)[0]
        scope = jstatic.Scope()
        with jstatic.scope_guard(scope):
            exe = jstatic.Executor()
            prog, feeds, fetches = jload_model(d, exe)
            got = np.asarray(exe.run(prog, feed={"x": x},
                                     fetch_list=fetches)[0])
    with open(d + "/__model__", "rb") as f:
        assert f.read(4) == b"PTIM"
    assert feeds == ["x"]
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_proto_model_runs_in_the_port_predictor(tmp_path):
    from paddle_tpu_torch.inference import Config, create_predictor
    _, (tm, ts, _, tpred) = both_programs()
    scope, exe = _startup_values(tstatic, ts, CPU)
    d = str(tmp_path / "model")
    x = np.random.RandomState(2).rand(3, 8).astype(np.float32)
    with tstatic.scope_guard(scope):
        tsave_model(d, ["x"], [tpred], exe, main_program=tm,
                    model_format="proto")
        ref = exe.run(tm, feed={"x": x, "y": np.zeros((3, 1), np.float32)},
                      fetch_list=[tpred])[0]
    cfg = Config(d)
    cfg.disable_gpu()
    pred = create_predictor(cfg)
    h = pred.get_input_handle(pred.get_input_names()[0])
    h.copy_from_cpu(x)
    pred.run()
    got = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert isinstance(torch.as_tensor(got), torch.Tensor)
