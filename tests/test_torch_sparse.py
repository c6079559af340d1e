"""SelectedRows sparse embedding gradients in the port, against the JAX
package on the CPU (mirrors tests/test_sparse_and_bucketing.py:42-131).

The embedding of `layers.embedding(..., is_sparse=True)` hands its
gradient on as a SelectedRows {rows, values, height}; sgd scatter-adds it
into the parameter, momentum densifies it, adam with `lazy_mode` moves
only the touched rows, `sum` concatenates two and `scale` scales the
values.  Tolerances: the port's sparse path against its dense one rtol
1e-5 / atol 1e-6 (SGD: the dense step subtracts lr times the summed
gradient, the sparse one adds each row's -lr g in turn) and 1e-4 / 1e-6
for Adam and Momentum (as the JAX test); the port against the JAX
package at the same paths atol 1e-6 (the same scatter order; XLA and
torch sum the fc reductions in other orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.static as jstatic
from paddle_tpu.core.program import _reset_unique_names as jax_reset_names
from paddle_tpu.core.selected_rows import SelectedRows as JRows
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core.program import (_reset_unique_names as
                                           torch_reset_names)
from paddle_tpu_torch.core.selected_rows import SelectedRows as TRows
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.ops.registry import OpContext as TCtx, run_kernel

VOCAB, DIM = 50, 8


def _embedding_program(static, is_sparse, opt_fn, padding_idx=None):
    layers = static.layers
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        ids = layers.data("ids", [-1, 4], dtype="int64")
        y = layers.data("y", [-1, 1])
        emb = layers.embedding(ids, size=[VOCAB, DIM], is_sparse=is_sparse,
                               padding_idx=padding_idx)
        pooled = layers.scale(layers.reduce_sum(emb, dim=1), 0.25)
        pred = layers.fc(pooled, size=1)
        loss = layers.mean(layers.square(layers.elementwise_sub(pred, y)))
        opt_fn(static).minimize(loss)
    return main, startup, loss


def build_pair(is_sparse, opt_fn, padding_idx=None):
    jax_reset_names()
    ref = _embedding_program(jstatic, is_sparse, opt_fn, padding_idx)
    torch_reset_names()
    port = _embedding_program(tstatic, is_sparse, opt_fn, padding_idx)
    return ref, port


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"ids": rng.randint(0, VOCAB, (8, 4)).astype(np.int64),
            "y": rng.rand(8, 1).astype(np.float32)}


def _init(ref):
    scope, exe = jstatic.Scope(), jstatic.Executor()
    with jstatic.scope_guard(scope):
        exe.run(ref[1])
    return {n: np.asarray(scope.find_var(n).get_tensor())
            for n in scope.vars
            if scope.find_var(n).get_tensor() is not None}


def _train_port(port, init, steps=5, feed=None):
    scope, exe = tstatic.Scope(), tstatic.Executor(tstatic.CPUPlace())
    feed = feed or _batch()
    with tstatic.scope_guard(scope):
        exe.run(port[1])
        load_params_from_numpy(scope, init, tstatic.CPUPlace())
        losses = [float(exe.run(port[0], feed=feed, fetch_list=[port[2]])[0])
                  for _ in range(steps)]
    return losses, scope


def _train_jax(ref, init, steps=5, feed=None):
    scope, exe = jstatic.Scope(), jstatic.Executor()
    feed = feed or _batch()
    with jstatic.scope_guard(scope):
        exe.run(ref[1])
        for n, v in init.items():
            scope.set(n, v)
        losses = [float(np.asarray(exe.run(ref[0], feed=feed,
                                           fetch_list=[ref[2]])[0]))
                  for _ in range(steps)]
    return losses, scope


def _emb(main):
    return next(p.name for p in main.all_parameters()
                if p.shape == (VOCAB, DIM))


def test_sparse_program_serializes_equal_and_emits_selected_rows():
    ref, port = build_pair(True, lambda s: s.SGD(0.1))
    assert port[0].to_dict() == ref[0].to_dict()
    assert port[1].to_dict() == ref[1].to_dict()
    grad_op = next(op for op in port[0].global_block().ops
                   if op.type == "lookup_table_v2_grad")
    assert grad_op.attrs["is_sparse"] is True
    ins = {"W": torch.zeros(VOCAB, DIM),
           "Ids": torch.tensor([[1, 3], [1, 7]]),
           "Out@GRAD": torch.ones(2, 2, DIM)}
    from paddle_tpu_torch.ops.registry import get_op_info
    out = get_op_info("lookup_table_v2_grad").kernel(
        ins, dict(grad_op.attrs), TCtx())["W@GRAD"]
    assert isinstance(out, TRows) and out.height == VOCAB
    assert out.rows.tolist() == [1, 3, 1, 7]


def test_sparse_sgd_matches_dense_and_reference():
    ref_d, dense = build_pair(False, lambda s: s.SGD(0.1))
    ref_s, sparse = build_pair(True, lambda s: s.SGD(0.1))
    init = _init(ref_d)
    l_d, s_d = _train_port(dense, init)
    l_s, s_s = _train_port(sparse, init)
    w_d, w_s = s_d.vars[_emb(dense[0])], s_s.vars[_emb(sparse[0])]
    np.testing.assert_allclose(l_s, l_d, rtol=1e-5)
    np.testing.assert_allclose(w_s.numpy(), w_d.numpy(), rtol=1e-5,
                               atol=1e-6)
    jl, jscope = _train_jax(ref_s, init)
    np.testing.assert_allclose(l_s, jl, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        w_s.numpy(), np.asarray(jscope.find_var(_emb(ref_s[0]))
                                .get_tensor()), rtol=0, atol=1e-6)
    # rows never looked up keep their initial values, bit for bit
    _, one = _train_port(sparse, init, steps=1)
    untouched = np.setdiff1d(np.arange(VOCAB), _batch()["ids"].ravel())
    assert untouched.size > 0
    np.testing.assert_array_equal(
        one.vars[_emb(sparse[0])].numpy()[untouched],
        init[_emb(sparse[0])][untouched])


@pytest.mark.parametrize("opt", ["adam", "momentum"])
def test_sparse_adam_and_momentum_match_dense_and_reference(opt):
    make = {"adam": lambda s: s.Adam(learning_rate=0.05),
            "momentum": lambda s: s.Momentum(learning_rate=0.05,
                                             momentum=0.9)}[opt]
    ref_d, dense = build_pair(False, make)
    ref_s, sparse = build_pair(True, make)
    init = _init(ref_d)
    _, s_d = _train_port(dense, init)
    l_s, s_s = _train_port(sparse, init)
    np.testing.assert_allclose(s_s.vars[_emb(sparse[0])].numpy(),
                               s_d.vars[_emb(dense[0])].numpy(),
                               rtol=1e-4, atol=1e-6)
    jl, jscope = _train_jax(ref_s, init)
    np.testing.assert_allclose(l_s, jl, rtol=0, atol=1e-6)
    for n in init:
        np.testing.assert_allclose(
            s_s.vars[n].numpy(), np.asarray(jscope.find_var(n).get_tensor()),
            rtol=0, atol=1e-6, err_msg=n)


def test_lazy_adam_program_trains_like_reference():
    """Adam(lazy_mode=True): the port's program is the JAX package's with
    `lazy_mode` on each adam op (the JAX class drops it; set here in
    memory on its program); 5 steps equal, and the rows and moments no id
    touched unchanged bit for bit."""
    ref, port = build_pair(True, lambda s: s.Adam(0.05, lazy_mode=True))
    adam = [op for op in ref[0].global_block().ops if op.type == "adam"]
    assert adam and all("lazy_mode" not in op.attrs for op in adam)
    for op in adam:
        op.attrs["lazy_mode"] = True
    assert port[0].to_dict() == ref[0].to_dict()
    init = _init(ref)
    l_s, scope = _train_port(port, init)
    jl, jscope = _train_jax(ref, init)
    np.testing.assert_allclose(l_s, jl, rtol=0, atol=1e-6)
    for n in init:
        np.testing.assert_allclose(
            scope.vars[n].numpy(), np.asarray(jscope.find_var(n).get_tensor()),
            rtol=0, atol=1e-6, err_msg=n)
    untouched = np.setdiff1d(np.arange(VOCAB), _batch()["ids"].ravel())
    emb = _emb(port[0])
    moments = [n for n in scope.vars if n.startswith(emb + "_moment")]
    assert len(moments) == 2
    for n in [emb] + moments:
        np.testing.assert_array_equal(scope.vars[n].numpy()[untouched],
                                      init[n][untouched], err_msg=n)
    touched = np.unique(_batch()["ids"])
    assert not np.array_equal(scope.vars[emb].numpy()[touched],
                              init[emb][touched])


def test_padding_idx_gradient_matches_reference():
    """is_sparse with padding_idx: the padded rows get no gradient, dense
    and sparse alike, equal to the JAX package's grad kernel."""
    rng = np.random.RandomState(2)
    w = rng.randn(VOCAB, DIM).astype(np.float32)
    ids = rng.randint(0, 6, (3, 4)).astype(np.int64)
    og = rng.randn(3, 4, DIM).astype(np.float32)
    from paddle_tpu_torch.ops.registry import get_op_info
    for op in ("lookup_table_v2", "lookup_table"):
        i = ids if op == "lookup_table_v2" else ids[..., None]
        o = og
        for sparse in (False, True):
            attrs = {"padding_idx": 2, "is_sparse": sparse}
            jg = jreg.get_op_info(op + "_grad").kernel(
                {"W": jnp.asarray(w), "Ids": jnp.asarray(i),
                 "Out@GRAD": jnp.asarray(o)}, dict(attrs),
                jreg.OpContext())["W@GRAD"]
            tg = get_op_info(op + "_grad").kernel(
                {"W": torch.from_numpy(w), "Ids": torch.from_numpy(i),
                 "Out@GRAD": torch.from_numpy(o)}, dict(attrs),
                TCtx())["W@GRAD"]
            if sparse:
                assert isinstance(tg, TRows) and isinstance(jg, JRows)
                jg, tg = jg.to_dense(), tg.to_dense()
            np.testing.assert_allclose(tg.numpy(), np.asarray(jg),
                                       rtol=0, atol=1e-6)
            assert not tg.numpy()[2].any()


def test_selected_rows_merge_and_mask():
    sr = TRows(torch.tensor([1, 3, 1]),
               torch.tensor([[1.0, 1], [2, 2], [3, 3]]), height=5)
    dense = sr.to_dense().numpy()
    np.testing.assert_allclose(dense[1], [4.0, 4.0])  # duplicates merged
    np.testing.assert_allclose(dense[3], [2.0, 2.0])
    np.testing.assert_allclose(dense[0], 0.0)
    assert sr.row_mask().tolist() == [False, True, False, True, False]


def test_adam_lazy_mode_touches_only_rows():
    """The kernel: lazy_mode leaves untouched rows' parameter and moments
    as they were; without it the moments decay everywhere.  Equal to the
    JAX kernel on the same inputs."""
    def ins(pkg):
        arr = torch.tensor if pkg == "torch" else jnp.asarray
        rows = (TRows if pkg == "torch" else JRows)(
            arr([0, 2]), arr(np.full((2, 3), 0.5, np.float32)), height=6)
        return {"Param": arr(np.ones((6, 3), np.float32)), "Grad": rows,
                "LearningRate": arr(np.asarray([0.1], np.float32)),
                "Moment1": arr(np.full((6, 3), 0.2, np.float32)),
                "Moment2": arr(np.full((6, 3), 0.3, np.float32)),
                "Beta1Pow": arr(np.asarray([0.9], np.float32)),
                "Beta2Pow": arr(np.asarray([0.999], np.float32))}
    for lazy in (True, False):
        out = run_kernel("adam", ins("torch"), {"lazy_mode": lazy}, TCtx())
        ref = jreg.run_kernel("adam", ins("jax"), {"lazy_mode": lazy},
                              jreg.OpContext())
        for slot in ("ParamOut", "Moment1Out", "Moment2Out"):
            np.testing.assert_allclose(out[slot].numpy(),
                                       np.asarray(ref[slot]), rtol=1e-6,
                                       err_msg=slot)
        p2, m1 = out["ParamOut"].numpy(), out["Moment1Out"].numpy()
        assert (p2[[0, 2]] != 1.0).all()
        if lazy:
            np.testing.assert_array_equal(p2[[1, 3, 4, 5]], 1.0)
            np.testing.assert_array_equal(m1[[1, 3, 4, 5]], np.float32(0.2))
        else:
            np.testing.assert_allclose(m1[1], 0.9 * 0.2, rtol=1e-6)


@pytest.mark.parametrize("op", ["sgd", "momentum", "adam"])
def test_sparse_update_leaves_its_inputs_unchanged(op):
    """An optimizer op given a SelectedRows gradient (duplicate rows
    included) returns new tensors and writes into none of its inputs: a
    captured step's warm-up call must change no state.  Its outputs equal
    the JAX kernel's on the same inputs (fp32, rtol 1e-6)."""
    def ins(pkg):
        arr = torch.tensor if pkg == "torch" else jnp.asarray
        rows = (TRows if pkg == "torch" else JRows)(
            arr([4, 1, 4]), arr(np.arange(6, dtype=np.float32).reshape(
                3, 2) + 0.5), height=6)
        out = {"Param": arr(np.linspace(-1, 1, 12, dtype=np.float32)
                            .reshape(6, 2)),
               "Grad": rows,
               "LearningRate": arr(np.asarray([0.1], np.float32))}
        if op == "momentum":
            out["Velocity"] = arr(np.full((6, 2), 0.25, np.float32))
        if op == "adam":
            out.update({"Moment1": arr(np.full((6, 2), 0.2, np.float32)),
                        "Moment2": arr(np.full((6, 2), 0.3, np.float32)),
                        "Beta1Pow": arr(np.asarray([0.9], np.float32)),
                        "Beta2Pow": arr(np.asarray([0.999], np.float32))})
        return out
    t_ins = ins("torch")
    before = {k: (v.values.clone() if isinstance(v, TRows) else v.clone())
              for k, v in t_ins.items()}
    out = run_kernel(op, t_ins, {}, TCtx())
    for k, v in t_ins.items():
        assert torch.equal(v.values if isinstance(v, TRows) else v,
                           before[k]), k
    ref = jreg.run_kernel(op, ins("jax"), {}, jreg.OpContext())
    for slot, v in out.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(ref[slot]),
                                   rtol=1e-6, err_msg=slot)
    assert not torch.equal(out["ParamOut"], before["Param"])


def test_sum_and_scale_of_selected_rows():
    a = TRows(torch.tensor([0]), torch.ones(1, 2), 4)
    b = TRows(torch.tensor([0, 2]), torch.ones(2, 2), 4)
    out = run_kernel("sum", {"X": [a, b]}, {}, TCtx())["Out"]
    assert isinstance(out, TRows)
    dense = out.to_dense().numpy()
    np.testing.assert_allclose(dense[0], 2.0)
    np.testing.assert_allclose(dense[2], 1.0)
    # mixed sparse and dense falls back to dense
    out2 = run_kernel("sum", {"X": [a, torch.ones(4, 2)]}, {}, TCtx())["Out"]
    np.testing.assert_allclose(out2.numpy()[0], 2.0)
    scaled = run_kernel("scale", {"X": b}, {"scale": 0.5}, TCtx())["Out"]
    assert isinstance(scaled, TRows)
    np.testing.assert_allclose(scaled.to_dense().numpy()[2], 0.5)
    with pytest.raises(ValueError, match="densify"):
        run_kernel("scale", {"X": b}, {"scale": 1.0, "bias": 1.0}, TCtx())


def test_run_steps_carries_selected_rows():
    """run_steps (the CPU loop) of the sparse Adam program equals run()
    calls bit for bit: the SelectedRows value travels through the
    environment and the release plan."""
    _, port = build_pair(True, lambda s: s.Adam(0.05, lazy_mode=True))
    ref, _ = build_pair(True, lambda s: s.Adam(0.05))
    init = _init(ref)
    feeds = [_batch(s) for s in range(3)]
    l_run, s_run = [], None
    scope, exe = tstatic.Scope(), tstatic.Executor(tstatic.CPUPlace())
    with tstatic.scope_guard(scope):
        exe.run(port[1])
        load_params_from_numpy(scope, init, tstatic.CPUPlace())
        for f in feeds:
            l_run.append(exe.run(port[0], feed=f, fetch_list=[port[2]])[0])
    scope2, exe2 = tstatic.Scope(), tstatic.Executor(tstatic.CPUPlace())
    with tstatic.scope_guard(scope2):
        exe2.run(port[1])
        load_params_from_numpy(scope2, init, tstatic.CPUPlace())
        (stacked,) = exe2.run_steps(port[0], feed={
            k: np.stack([f[k] for f in feeds]) for k in feeds[0]},
            fetch_list=[port[2]])
    np.testing.assert_array_equal(stacked, np.stack(l_run))
    for n, t in scope.vars.items():
        if t is not None:
            assert torch.equal(scope2.vars[n], t), n
