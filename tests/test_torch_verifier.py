"""The port's static verifier against the JAX package's, on the CPU.

Every program is built twice from the same unique-name state, once with
each package, and the two builds must serialize equal; then
`check_program(level="all")` must report the same diagnostics in both
(code, severity, block and op index, op type, var), in the same order.
The matrices are tests/test_verifier.py's: the clean programs the rewrite
passes produce (0 diagnostics, or only the V208 advisory where that file
allows it) and its seeded defects (each caught with its stable code).

Then the port's own wiring: PADDLE_TPU_VERIFY's self-check in the
rewrite passes and the Predictor, and `verify_first_compile` in
`Executor.run`, `Executor.run_steps` and `CompiledProgram`.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.amp  # noqa: F401
import paddle_tpu.static as jstatic
import paddle_tpu_torch
import paddle_tpu_torch.amp  # noqa: F401
import paddle_tpu_torch.static as tstatic

torch.set_num_threads(2)


def _namespace(root, static):
    from importlib import import_module
    name = root.__name__
    prog = import_module(name + ".core.program")
    pf = import_module(name + ".core.pass_framework")
    return types.SimpleNamespace(
        name=name, static=static, layers=static.layers, amp=root.amp,
        OpDesc=prog.OpDesc, OpRole=prog.OpRole,
        reset=prog._reset_unique_names,
        record_applied=pf.record_applied, has_applied=pf.has_applied,
        verifier=import_module(name + ".static.verifier"),
        shard=import_module(name + ".distributed.sharding")
        .shard_optimizer_states,
        elasticize=import_module(name + ".distributed.elastic").elasticize,
        insert_grad_allreduce=import_module(
            name + ".distributed.compiled_program").insert_grad_allreduce,
        mark_scan_hoist=import_module(
            name + ".distributed.scan_window").mark_scan_hoist)


JAX = _namespace(paddle_tpu, jstatic)
PORT = _namespace(paddle_tpu_torch, tstatic)


def diag_keys(report):
    return [(d.code, d.severity, d.block_idx, d.op_idx, d.op_type, d.var)
            for d in report.diagnostics]


def build_train(P, opt=None, lr=1e-3):
    """tests/test_verifier.py's small minimized program in package P:
    (main, startup, loss)."""
    P.reset()
    main, startup = P.static.Program(), P.static.Program()
    with P.static.program_guard(main, startup):
        x = P.layers.data("x", [-1, 8])
        y = P.layers.data("y", [-1, 1])
        h = P.layers.fc(x, 16, act="relu")
        pred = P.layers.fc(h, 1)
        loss = P.layers.mean(P.layers.square(
            P.layers.elementwise_sub(pred, y)))
        getattr(P.static, opt or "Adam")(learning_rate=lr).minimize(loss)
    return main, startup, loss


def build_sharded(P, dp=8, stage=1, gm=0, **kw):
    main, startup, loss = build_train(P, **kw)
    plan = P.shard(main, startup, dp_degree=dp, stage=stage)
    if gm:
        P.static.gradient_merge(main, gm, startup)
    return main, startup, loss, plan


def _uid(main):
    return main._next_uid()


# --- the clean matrix: each case returns (program, check kwargs) ----------
def c_plain(P):
    m, s, loss = build_train(P)
    return m, dict(startup=s, fetch_list=[loss.name])


def _c_optimizer(opt):
    def case(P):
        m, s, loss = build_train(P, opt=opt)
        return m, dict(startup=s, fetch_list=[loss.name])
    return case


def c_zero1(P):
    m, s, loss, _ = build_sharded(P)
    return m, dict(startup=s, fetch_list=[loss.name])


def c_zero1_gm(P):
    m, s, loss, _ = build_sharded(P, gm=4)
    return m, dict(startup=s, fetch_list=[loss.name])


def c_zero1_gm_hoisted(P):
    m, s, loss, _ = build_sharded(P, gm=4)
    P.mark_scan_hoist(m)
    return m, dict(startup=s, fetch_list=[loss.name])


def c_elastic(P):
    m, s, loss = build_train(P)
    P.elasticize(m, s, logical_dp=8, loss_name=loss)
    return m, dict(startup=s, fetch_list=[loss.name + "@ELASTIC_AVG"])


def c_amp(P):
    P.reset()
    m, s = P.static.Program(), P.static.Program()
    with P.static.program_guard(m, s):
        x = P.layers.data("x", [-1, 8])
        y = P.layers.data("y", [-1, 1])
        h = P.layers.fc(x, 16, act="relu")
        pred = P.layers.fc(h, 1)
        loss = P.layers.mean(P.layers.square(
            P.layers.elementwise_sub(pred, y)))
        opt = P.amp.decorate(P.static.Adam(learning_rate=1e-3),
                             use_dynamic_loss_scaling=True)
        opt.minimize(loss, s)
    return m, dict(startup=s, fetch_list=[loss.name])


def c_recompute(P):
    P.reset()
    m, s = P.static.Program(), P.static.Program()
    with P.static.program_guard(m, s):
        x = P.layers.data("x", [-1, 8])
        y = P.layers.data("y", [-1, 1])
        h1 = P.layers.fc(x, 16, act="relu")
        h2 = P.layers.fc(h1, 16, act="relu")
        pred = P.layers.fc(h2, 1)
        loss = P.layers.mean(P.layers.square(
            P.layers.elementwise_sub(pred, y)))
        opt = P.static.RecomputeOptimizer(P.static.Adam(learning_rate=1e-3))
        opt._set_checkpoints([h1])
        opt.minimize(loss)
    assert P.has_applied(m, "recompute")
    return m, dict(startup=s, fetch_list=[loss.name])


def c_grad_allreduce(P):
    m, s, loss = build_train(P)
    return P.insert_grad_allreduce(m), dict(startup=s,
                                            fetch_list=[loss.name])


def c_grad_allreduce_twice(P):
    m, s, loss = build_train(P)
    again = P.insert_grad_allreduce(P.insert_grad_allreduce(m))
    return again, dict(fetch_list=[loss.name])


def c_zero2_gm(P):
    m, s, loss, _ = build_sharded(P, stage=2, gm=2)
    return m, dict(startup=s, fetch_list=[loss.name])


def c_zero3(P):
    m, s, loss, _ = build_sharded(P, stage=3)
    return m, dict(startup=s, fetch_list=[loss.name])


def c_zero3_gm(P):
    m, s, loss, _ = build_sharded(P, stage=3, gm=2)
    return m, dict(startup=s, fetch_list=[loss.name])


def c_bench_amp(P):
    """bench.py's BERT pretraining program (flash, fused CE, AMP) at a
    small width."""
    from test_torch_train_program import build_both
    (jm, js, jl), (tm, ts, tl) = build_both(True)
    if P is JAX:
        return jm, dict(startup=js, fetch_list=[jl.name])
    return tm, dict(startup=ts, fetch_list=[tl.name])


CLEAN = {
    "plain": (c_plain, set()),
    "sgd": (_c_optimizer("SGD"), set()),
    "momentum": (_c_optimizer("Momentum"), set()),
    "adamw": (_c_optimizer("AdamW"), set()),
    "lamb": (_c_optimizer("Lamb"), set()),
    "zero1": (c_zero1, set()),
    "zero1_gm": (c_zero1_gm, {"V208"}),
    "zero1_gm_hoisted": (c_zero1_gm_hoisted, set()),
    "elastic": (c_elastic, set()),
    "amp": (c_amp, set()),
    "recompute": (c_recompute, set()),
    "grad_allreduce": (c_grad_allreduce, set()),
    "grad_allreduce_twice": (c_grad_allreduce_twice, set()),
    "zero2_gm": (c_zero2_gm, {"V208"}),
    "zero3": (c_zero3, set()),
    "zero3_gm": (c_zero3_gm, {"V208"}),
    "bench_amp": (c_bench_amp, set()),
}


def _run_case(case, level="all"):
    out = []
    for P in (JAX, PORT):
        prog, kw = case(P)
        same_json = kw.pop("same_json", True)
        out.append((prog, kw.get("startup"),
                    P.verifier.check_program(prog, level=level, **kw)))
    (jp, js, jr), (tp, ts, tr) = out
    if same_json:
        assert tp.to_dict() == jp.to_dict()
    if js is not None:
        assert ts.to_dict() == js.to_dict()
    return jr, tr


@pytest.mark.parametrize("name", sorted(CLEAN))
def test_clean_programs_match(name):
    case, allowed = CLEAN[name]
    jr, tr = _run_case(case)
    assert diag_keys(tr) == diag_keys(jr)
    assert not tr.errors, tr.render()
    assert {d.code for d in tr.diagnostics} <= allowed, tr.render()


# --- the mutation matrix: (case, expected code) ---------------------------
def m_V101(P):
    m, _, loss = build_train(P)
    m.global_block().ops.insert(0, P.OpDesc(
        "scale", {"X": ["never_defined"]}, {"Out": ["q"]},
        {"scale": 1.0, "op_uid": _uid(m)}))
    return m, dict(fetch_list=[loss.name])


def m_V102(P):
    m, _, loss = build_train(P)
    blk = m.global_block()
    blk.create_var(name="phantom@GRAD", shape=[8], dtype="float32")
    blk.ops.append(P.OpDesc(
        "fill_constant", {}, {"Out": ["phantom@GRAD"]},
        {"shape": [8], "value": 0.0, "dtype": "float32",
         "op_uid": _uid(m)}))
    return m, dict(fetch_list=[loss.name])


def m_V103(P):
    m, _, loss = build_train(P)
    m.global_block().var(loss.name).dtype = "int32"
    return m, dict(fetch_list=[loss.name])


def m_V104(P):
    m, _, loss = build_train(P)
    blk = m.global_block()
    fc_out = next(op for op in blk.ops if op.type == "mul")
    v = blk.var(fc_out.outputs["Out"][0])
    v.shape = tuple(d + 3 for d in v.shape)
    return m, dict(fetch_list=[loss.name])


def m_V106(P):
    m, _, loss = build_train(P)
    blk = m.global_block()
    tmp = next(n for op in blk.ops for n in op.output_names()
               if not blk.var(n).persistable)
    blk.ops.append(P.OpDesc(
        "fill_constant", {}, {"Out": [tmp]},
        {"shape": [1], "value": 0.0, "dtype": "float32",
         "op_uid": _uid(m)}))
    return m, dict(fetch_list=[loss.name])


def m_V107_feed(P):
    m, _, loss = build_train(P)
    m.global_block().ops.append(P.OpDesc(
        "scale", {"X": ["x"]}, {"Out": ["x"]},
        {"scale": 1.0, "op_uid": _uid(m)}))
    return m, dict(fetch_list=[loss.name])


def m_V107_fetch(P):
    m, _, _ = build_train(P)
    return m, dict(fetch_list=["no_such_var"])


def m_V109(P):
    m, _, loss = build_train(P)
    m.global_block().ops.append(P.OpDesc("totally_fake_op", {}, {}, {}))
    return m, dict(fetch_list=[loss.name])


def m_V201_swapped(P):
    m, _, loss, _ = build_sharded(P)
    blk = m.global_block()
    rs = next(i for i, op in enumerate(blk.ops)
              if op.type == "c_reducescatter")
    ag = next(i for i, op in enumerate(blk.ops) if op.type == "c_allgather")
    blk.ops[rs], blk.ops[ag] = blk.ops[ag], blk.ops[rs]
    return m, dict(fetch_list=[loss.name])


def m_V201_orphan(P):
    m, _, loss, _ = build_sharded(P)
    blk = m.global_block()
    blk.ops = [op for op in blk.ops if op.type != "c_allgather"]
    return m, dict(fetch_list=[loss.name])


def m_V202_ring(P):
    m, _, loss, _ = build_sharded(P)
    next(op for op in m.global_block().ops
         if op.type == "c_allgather").attrs["ring_id"] = 1
    return m, dict(fetch_list=[loss.name])


def m_V202_degree(P):
    m, _, loss, _ = build_sharded(P)
    next(op for op in m.global_block().ops
         if op.type == "c_reducescatter").attrs["dp_degree"] = 4
    return m, dict(fetch_list=[loss.name])


def m_V203(P):
    m, _, loss, _ = build_sharded(P)
    rs = next(op for op in m.global_block().ops
              if op.type == "c_reducescatter")
    xv = m.global_block().var(rs.inputs["X"][0])
    xv.shape = (int(xv.shape[0]) + 1,)
    return m, dict(fetch_list=[loss.name])


def m_V204(P):
    m, _, loss, plan = build_sharded(P)
    m.global_block().var(plan.slot_var_names()[0]).attrs["dp_shard"] = 4
    return m, dict(fetch_list=[loss.name])


def m_V205(P):
    m, _, loss = build_train(P)
    sub = m.create_block()
    m.rollback()
    sub.ops.append(P.OpDesc(
        "c_allreduce_sum", {"X": ["x"]}, {"Out": ["x"]},
        {"ring_id": 0, "op_uid": _uid(m)}))
    return m, dict(fetch_list=[loss.name])


def m_V206(P):
    m, s, loss = build_train(P)
    P.elasticize(m, s, logical_dp=8, loss_name=loss)
    blk = m.global_block()
    blk.create_var(name="hazard_out", shape=[1], dtype="float32")
    blk.ops.append(P.OpDesc(
        "c_allreduce_sum", {"X": [loss.name]}, {"Out": ["hazard_out"]},
        {"ring_id": 0, "op_uid": _uid(m)}))
    return m, dict(fetch_list=[loss.name + "@ELASTIC_AVG"])


def m_V207(P):
    m, _, loss = build_train(P)
    p = P.insert_grad_allreduce(m)
    blk = p.global_block()
    ar_i, ar = next((i, op) for i, op in enumerate(blk.ops)
                    if op.type == "c_allreduce_sum")
    blk.create_var(name="re_reduced", shape=None, dtype="float32")
    blk.ops.insert(ar_i + 1, P.OpDesc(
        "c_allreduce_sum", {"X": [ar.outputs["Out"][0]]},
        {"Out": ["re_reduced"]}, {"ring_id": 0, "op_uid": _uid(p)}))
    return p, dict(fetch_list=[loss.name])


def m_V301(P):
    m, s, loss = build_train(P)
    ps = m.all_parameters()
    s.global_block().ops.append(P.OpDesc(
        "assign", {"X": [ps[0].name]}, {"Out": [ps[1].name]},
        {"op_uid": _uid(s)}))
    return m, dict(startup=s, fetch_list=[loss.name])


def m_V302(P):
    m, _, loss = build_train(P)
    blk = m.global_block()
    param = m.all_parameters()[0]
    blk.create_var(name="post_read", shape=param.shape, dtype=param.dtype,
                   stop_gradient=True)
    blk.ops.append(P.OpDesc(
        "scale", {"X": [param.name]}, {"Out": ["post_read"]},
        {"scale": 2.0, P.OpRole.KEY: P.OpRole.Forward, "op_uid": _uid(m)}))
    return m, dict(fetch_list=[loss.name])


def m_V303(P):
    m, _, _, plan = build_sharded(P)
    return m, dict(fetch_list=[plan.slot_var_names()[0]])


def m_V40x(P):
    m, _, loss = build_train(P)
    blk = m.global_block()
    blk.create_var(name="ragged", shape=[-1, -1], dtype="float32",
                   is_data=True)
    blk.create_var(name="scalar_feed", shape=[], dtype="float32",
                   is_data=True)
    # the captured constant is the package's own array type
    blk.ops[3].attrs["captured"] = (np.zeros(3) if P is JAX
                                    else torch.zeros(3))
    return m, dict(fetch_list=[loss.name], same_json=False)


def m_V502(P):
    m, _, loss, _ = build_sharded(P)
    m._applied_passes = [{"pass": "gradient_merge", "k": 2},
                         {"pass": "zero1_sharding"}]
    return m, dict(fetch_list=[loss.name])


def m_V501(P):
    m, _, loss = build_train(P)
    P.record_applied(m, "elastic", logical_dp=8)
    P.record_applied(m, "gradient_merge", k=2)
    return m, dict(fetch_list=[loss.name])


def m_V503(P):
    m, _, loss = build_train(P)
    P.record_applied(m, "zero1_sharding", dp_degree=8)
    P.record_applied(m, "elastic", logical_dp=8)
    return m, dict(fetch_list=[loss.name])


def m_V201_zero3_no_update(P):
    m, _, loss, _ = build_sharded(P, stage=3)
    blk = m.global_block()
    blk.ops = [op for op in blk.ops if not op.attrs.get("zero_sharded")]
    return m, dict(fetch_list=[loss.name])


def m_V201_zero3_replicated_gather(P):
    m, _, loss, plan = build_sharded(P, stage=3)
    for name in plan.param_bucket_names():
        m.global_block().var(name).attrs.pop("dp_shard", None)
    return m, dict(fetch_list=[loss.name])


def m_V204_zero3_stamp(P):
    m, _, loss, _ = build_sharded(P, stage=3)
    op = next(op for op in m.global_block().ops
              if op.attrs.get("zero_stage") == 3)
    op.attrs["zero_stage"] = 1
    return m, dict(fetch_list=[loss.name])


def m_V204_zero3_plan(P):
    m, _, loss, _ = build_sharded(P, stage=3)
    m._zero_shard_plan.stage = 1
    return m, dict(fetch_list=[loss.name])


def m_V203_zero3_gather(P):
    m, _, loss, _ = build_sharded(P, stage=3)
    blk = m.global_block()
    ag = next(op for op in blk.ops
              if op.attrs.get("zero_role") == "gather_fwd")
    out_v = blk.var(ag.outputs["Out"][0])
    out_v.shape = (int(out_v.shape[0]) // 2,)
    return m, dict(fetch_list=[loss.name])


def m_V201_zero2_orphan(P):
    m, _, loss, _ = build_sharded(P, stage=2, gm=2)
    blk = m.global_block()
    blk.ops = [op for op in blk.ops if op.type != "c_allgather"]
    return m, dict(fetch_list=[loss.name])


def m_V208(P):
    m, s, loss, _ = build_sharded(P, gm=4)
    return m, dict(startup=s, fetch_list=[loss.name])


MUTATIONS = {
    "V101": (m_V101, ("V101",)),
    "V102": (m_V102, ("V102",)),
    "V103": (m_V103, ("V103",)),
    "V104": (m_V104, ("V104",)),
    "V106": (m_V106, ("V106",)),
    "V107_feed_overwritten": (m_V107_feed, ("V107",)),
    "V107_missing_fetch": (m_V107_fetch, ("V107",)),
    "V109": (m_V109, ("V109",)),
    "V201_swapped": (m_V201_swapped, ("V201",)),
    "V201_orphan_rs": (m_V201_orphan, ("V201",)),
    "V202_ring": (m_V202_ring, ("V202",)),
    "V202_degree": (m_V202_degree, ("V202",)),
    "V203": (m_V203, ("V203",)),
    "V204": (m_V204, ("V204",)),
    "V205": (m_V205, ("V205",)),
    "V206": (m_V206, ("V206",)),
    "V207": (m_V207, ("V207",)),
    "V208": (m_V208, ("V208",)),
    "V301": (m_V301, ("V301",)),
    "V302": (m_V302, ("V302",)),
    "V303": (m_V303, ("V303",)),
    "V401_V402_V403": (m_V40x, ("V401", "V402", "V403")),
    "V501": (m_V501, ("V501",)),
    "V502": (m_V502, ("V502",)),
    "V503": (m_V503, ("V503",)),
    "V201_zero3_no_update": (m_V201_zero3_no_update, ("V201",)),
    "V201_zero3_replicated_gather": (m_V201_zero3_replicated_gather,
                                     ("V201",)),
    "V204_zero3_stamp": (m_V204_zero3_stamp, ("V204",)),
    "V204_zero3_plan": (m_V204_zero3_plan, ("V204",)),
    "V203_zero3_gather": (m_V203_zero3_gather, ("V203",)),
    "V201_zero2_orphan": (m_V201_zero2_orphan, ("V201",)),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutations_match(name):
    case, codes = MUTATIONS[name]
    jr, tr = _run_case(case)
    assert diag_keys(tr) == diag_keys(jr), (tr.render(), jr.render())
    for code in codes:
        assert tr.by_code(code), tr.render()


def test_levels_and_collective_schedule_match():
    """The cumulative levels, and the collective schedule with its wire
    bytes (ring 0 and by axis) on a ZeRO-1 / ZeRO-3 program."""
    jr, tr = _run_case(m_V205, level="graph")
    assert not tr.by_code("V205") and diag_keys(tr) == diag_keys(jr)
    for level in ("collective", "donation", "retrace", 4):
        jr, tr = _run_case(m_V205, level=level)
        assert tr.by_code("V205") and diag_keys(tr) == diag_keys(jr)
    for stage in (1, 3):
        (jm, _, _, _), (tm, _, _, _) = (build_sharded(JAX, stage=stage),
                                        build_sharded(PORT, stage=stage))
        assert PORT.verifier.collective_sequence(tm) == \
            JAX.verifier.collective_sequence(jm)
        for world in (1, 2, 8):
            assert PORT.verifier.collective_wire_bytes(tm, world) == \
                JAX.verifier.collective_wire_bytes(jm, world)
            assert PORT.verifier.collective_wire_bytes_by_axis(
                tm, world) == JAX.verifier.collective_wire_bytes_by_axis(
                    jm, world)
        assert PORT.verifier.program_ring_degrees(tm) == \
            JAX.verifier.program_ring_degrees(jm)
    with pytest.raises(ValueError):
        PORT.verifier.check_program(tm, level="bogus")


# --- the port's wiring ----------------------------------------------------
def test_env_gated_self_check(monkeypatch):
    V = PORT.verifier
    m, _, _ = build_train(PORT)
    m.global_block().ops.append(PORT.OpDesc("totally_fake_op", {}, {}, {}))
    monkeypatch.delenv("PADDLE_TPU_VERIFY", raising=False)
    assert V.verify_mode() == "" and V.self_check(m, "unit") is None
    monkeypatch.setenv("PADDLE_TPU_VERIFY", "warn")
    with pytest.warns(RuntimeWarning, match="V109"):
        V.self_check(m, "unit")
    monkeypatch.setenv("PADDLE_TPU_VERIFY", "strict")
    with pytest.raises(V.ProgramVerificationError, match="unit"):
        V.self_check(m, "unit")


def test_rewrite_passes_self_check_under_strict(monkeypatch):
    """Under strict every rewrite pass's epilogue verifies: the
    sanctioned rewrites (AMP, recompute, ZeRO, gradient merge, elastic)
    pass, and a pass applied to a broken program raises at the rewrite
    site, naming the pass."""
    monkeypatch.setenv("PADDLE_TPU_VERIFY", "strict")
    for case in (c_amp, c_recompute, c_zero1_gm, c_elastic, c_zero3):
        case(PORT)
    m, s, _ = build_train(PORT)
    m.global_block().ops.insert(0, PORT.OpDesc(
        "scale", {"X": ["never_defined"]}, {"Out": ["q"]},
        {"scale": 1.0, "op_uid": _uid(m)}))
    with pytest.raises(PORT.verifier.ProgramVerificationError,
                       match="gradient_merge"):
        PORT.static.gradient_merge(m, 2, s)
    m, s, _ = build_train(PORT)
    m.global_block().ops.append(PORT.OpDesc("totally_fake_op", {}, {}, {}))
    with pytest.raises(PORT.verifier.ProgramVerificationError,
                       match="zero1_sharding"):
        PORT.shard(m, s, dp_degree=2)


def _feed(batch=4):
    rng = np.random.RandomState(0)
    return {"x": rng.rand(batch, 8).astype(np.float32),
            "y": rng.rand(batch, 1).astype(np.float32)}


def test_first_run_verification_in_run_and_run_steps(monkeypatch):
    """verify_first_compile in Executor.run and run_steps: a clean
    program runs, a broken one raises before its first op, on every
    retry (only clean outcomes are memoized)."""
    monkeypatch.setenv("PADDLE_TPU_VERIFY", "strict")
    s_ = PORT.static
    exe = s_.Executor(s_.CPUPlace())
    m, s, loss = build_train(PORT)
    scope = s_.Scope()
    with s_.scope_guard(scope):
        exe.run(s)
        out = exe.run(m, feed=_feed(), fetch_list=[loss])
        assert np.isfinite(out[0]).all()
        stacked = {k: np.stack([v, v]) for k, v in _feed().items()}
        assert exe.run_steps(m, feed=stacked,
                             fetch_list=[loss])[0].shape[0] == 2
    m, s, loss = build_train(PORT)
    m.global_block().ops.insert(0, PORT.OpDesc(
        "scale", {"X": ["never_defined"]}, {"Out": ["q"]},
        {"scale": 1.0, "op_uid": _uid(m)}))
    m._fingerprint_cache = None
    with s_.scope_guard(s_.Scope()):
        exe.run(s)
        for _ in range(2):
            with pytest.raises(PORT.verifier.ProgramVerificationError,
                               match="first compile"):
                exe.run(m, feed=_feed(), fetch_list=[loss])
        with pytest.raises(PORT.verifier.ProgramVerificationError):
            exe.run_steps(m, feed={k: v[None] for k, v in _feed().items()},
                          fetch_list=[loss])


def test_compiled_program_verifies_each_fetch_set(monkeypatch):
    """CompiledProgram verifies a rank's program on its first run of each
    fetch set: a later fetch of a var the program does not hold raises
    V107 before the step runs."""
    monkeypatch.setenv("PADDLE_TPU_VERIFY", "strict")
    s_ = PORT.static
    m, s, loss = build_train(PORT)
    compiled = s_.CompiledProgram(m).with_data_parallel(loss_name=loss.name)
    exe = s_.Executor(s_.CPUPlace())
    with s_.scope_guard(s_.Scope()):
        exe.run(s)
        exe.run(compiled, feed=_feed(), fetch_list=[loss])
        with pytest.raises(PORT.verifier.ProgramVerificationError,
                           match="V107"):
            exe.run(compiled, feed=_feed(), fetch_list=["no_such_var"])
        stacked = {k: np.stack([v, v]) for k, v in _feed().items()}
        with pytest.raises(PORT.verifier.ProgramVerificationError,
                           match="V107"):
            exe.run_steps(compiled, feed=stacked, fetch_list=["nope"])


def test_predictor_post_pipeline_self_check(tmp_path, monkeypatch):
    """The Predictor self-checks the program its passes produced: clean
    under strict (the fp32 and the bf16 branch), and a model directory
    holding a broken program raises at load, naming the pipeline."""
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.io import save_inference_model
    s_ = PORT.static
    PORT.reset()
    m, s = s_.Program(), s_.Program()
    with s_.program_guard(m, s):
        x = PORT.layers.data("x", [-1, 8])
        out = PORT.layers.fc(PORT.layers.fc(x, 16, act="relu"), 4)
    exe = s_.Executor(s_.CPUPlace())
    with s_.scope_guard(s_.Scope()):
        exe.run(s)
        save_inference_model(str(tmp_path / "ok"), ["x"], [out], exe, m)
        # a declared dtype the kernel does not produce (V103)
        m.global_block().var(out.name).dtype = "int32"
        save_inference_model(str(tmp_path / "bad"), ["x"], [out], exe, m)
    monkeypatch.setenv("PADDLE_TPU_VERIFY", "strict")
    for bf16 in (False, True):
        cfg = Config(str(tmp_path / "ok"))
        cfg.disable_gpu()
        if bf16:
            cfg.enable_bfloat16()
        pred = create_predictor(cfg)
        res = pred.run([np.ones((2, 8), np.float32)])
        assert res[0].shape == (2, 4)
    cfg = Config(str(tmp_path / "bad"))
    cfg.disable_gpu()
    cfg.switch_ir_optim(False)
    with pytest.raises(PORT.verifier.ProgramVerificationError,
                       match="inference_pipeline"):
        create_predictor(cfg)
