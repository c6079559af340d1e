"""The port's sharding-propagation analyzer against the JAX package's.

The tensor-parallel programs of tests/test_layout_analysis.py and the V6xx
mutation matrix of tests/test_tensor_parallel.py are built in both
packages (equal program JSON); `propagate_shardings` must give the same
layout for every var (spec and partial axes), the same V6xx findings with
their provenance, and the same reshard table with its priced bytes.
"""
import pytest
import torch

from test_torch_verifier import JAX, PORT

torch.set_num_threads(2)

MESH = {"dp": 4, "mp": 2}


def _tp(P):
    from importlib import import_module
    return import_module(P.name + ".distributed.tensor_parallel")


def b_pair(P, tp=2, static_batch=False):
    tpm = _tp(P)
    P.reset()
    main, startup = P.static.Program(), P.static.Program()
    lead = 16 if static_batch else -1
    with P.static.program_guard(main, startup):
        x = P.layers.data("x", [lead, 8])
        y = P.layers.data("y", [lead, 1])
        h = tpm.col_parallel_fc(x, 16, act="relu", tp_degree=tp)
        pred = tpm.row_parallel_fc(h, 1, tp_degree=tp)
        loss = P.layers.mean(P.layers.square(
            P.layers.elementwise_sub(pred, y)))
        P.static.SGD(learning_rate=0.05).minimize(loss)
    return main


def b_attention(P):
    tpm = _tp(P)
    P.reset()
    main, startup = P.static.Program(), P.static.Program()
    with P.static.program_guard(main, startup):
        x = P.layers.data("x", [-1, 6, 16])
        y = P.layers.data("y", [-1, 6, 16])
        out = tpm.parallel_attention(x, 16, 4, tp_degree=2)
        loss = P.layers.mean(P.layers.square(
            P.layers.elementwise_sub(out, y)))
        P.static.SGD(learning_rate=0.05).minimize(loss)
    return main


def b_lm(P):
    from importlib import import_module
    P.reset()
    build = import_module(P.name + ".models").build_transformer_lm
    main, startup, loss, _ = build(vocab_size=64, hidden=32, num_layers=2,
                                   num_heads=4, seq_len=8,
                                   tensor_parallel_degree=2)
    with P.static.program_guard(main, startup):
        P.static.Adam(learning_rate=1e-2).minimize(loss)
    return main


def m_V602(P):
    main = b_pair(P)
    for op in main.global_block().ops:
        if op.type == "mp_allreduce_sum":
            op.type = "assign"
            op.attrs.pop("ring_id", None)
    return main


def m_V601(P):
    tpm = _tp(P)
    P.reset()
    main, startup = P.static.Program(), P.static.Program()
    with P.static.program_guard(main, startup):
        x = P.layers.data("x", [-1, 8])
        y = P.layers.data("y", [-1, 1])
        h = tpm.row_parallel_fc(x, 16, act="relu", tp_degree=2)
        pred = tpm.col_parallel_fc(h, 2, tp_degree=2)
        loss = P.layers.mean(P.layers.square(P.layers.elementwise_sub(
            P.layers.reduce_sum(pred, dim=[1], keep_dim=True), y)))
        P.static.SGD(learning_rate=0.05).minimize(loss)
    return main


def m_V604(P):
    main = b_pair(P)
    for op in main.global_block().ops:
        if op.type == "mp_allreduce_sum":
            op.attrs["ring_id"] = 0
    return main


def m_V603(P):
    main = b_pair(P)
    blk = main.global_block()
    blk.create_var(name="useless_gather", dtype="float32")
    blk.ops.append(P.OpDesc("c_concat", {"X": ["x"]},
                            {"Out": ["useless_gather"]},
                            {"ring_id": _tp(P).TP_RING_ID,
                             "op_uid": main._next_uid()}))
    return main


def _rules(P):
    from importlib import import_module
    return import_module(P.name + ".distributed.partition_spec") \
        .tensor_parallel_rules()


def _stripped_pair(P):
    main = b_pair(P)
    for v in main.all_parameters():
        v.attrs.pop("dist_attr", None)
    return main


# name -> (builder, propagate kwargs(P), expected V6xx codes)
CASES = {
    "pair": (b_pair, lambda P: dict(mesh_shape=MESH, batch=16), set()),
    "pair_mesh_from_stamps": (b_pair, lambda P: {}, set()),
    "pair_static_batch": (lambda P: b_pair(P, static_batch=True),
                          lambda P: dict(mesh_shape=MESH), set()),
    "attention": (b_attention, lambda P: dict(mesh_shape=MESH, batch=8),
                  set()),
    "lm": (b_lm, lambda P: dict(mesh_shape=MESH, batch=8), set()),
    "rules_recreate_layout": (
        _stripped_pair, lambda P: dict(mesh_shape=MESH, rules=_rules(P)),
        set()),
    "user_rule": (b_pair, lambda P: dict(
        mesh_shape=MESH,
        rules=[(r"^var:col_parallel_fc_0\.tmp_0$", (None, "tp"))]), set()),
    "V601_swapped_col_row": (m_V601, lambda P: dict(mesh_shape=MESH),
                             {"V601", "V602"}),
    "V602_dropped_allreduce": (m_V602, lambda P: dict(mesh_shape=MESH),
                               {"V602"}),
    "V603_redundant_gather": (m_V603, lambda P: dict(mesh_shape=MESH),
                              {"V603"}),
    "V604_misrung": (m_V604, lambda P: dict(mesh_shape=MESH), {"V604"}),
    "V605_indivisible": (b_pair, lambda P: dict(
        mesh_shape={"dp": 2, "mp": 3}), {"V605"}),
}


def _layout_keys(layout):
    specs = {n: (tuple(s.spec), tuple(sorted(s.partial)))
             for n, s in layout.specs.items()}
    diags = [(d.code, d.severity, d.block_idx, d.op_idx, d.op_type,
              d.op_uid, d.var) for d in layout.diagnostics]
    return specs, diags, layout.reshard_table, layout.mesh_shape


@pytest.mark.parametrize("name", sorted(CASES))
def test_layouts_findings_and_reshard_table_match(name):
    build, kw, codes = CASES[name]
    (jm, jl), (tm, tl) = [
        (m, P.static.propagate_shardings(m, **kw(P)))
        for P in (JAX, PORT) for m in (build(P),)]
    assert tm.to_dict() == jm.to_dict()
    assert _layout_keys(tl) == _layout_keys(jl)
    assert tl.wire_bytes_per_axis() == jl.wire_bytes_per_axis()
    assert tl.render_reshard_table() == jl.render_reshard_table()
    assert {d.code for d in tl.diagnostics} == codes, tl.codes()
    if name == "lm":
        # two Megatron g's a layer, each allreducing [B, S, H] fp32 over
        # the mp ring: 2 (g - 1) / g of the bytes
        assert tl.wire_bytes("mp") == 2 * 2 * int(
            2 * (2 - 1) / 2 * (8 * 8 * 32 * 4))
    # the same findings ride check_program(level="layout"), whose mesh
    # comes from the builders' stamps (mp 2)
    if codes and name != "V605_indivisible":
        rep = PORT.verifier.check_program(tm, level="layout")
        assert codes <= set(rep.codes())
