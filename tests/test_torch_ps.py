"""The port's parameter-server tier (paddle_tpu_torch/distributed/ps/ and
ops/kernels/distributed_ops.py) against the JAX package's, on the CPU,
mirroring tests/test_parameter_server.py and tests/test_sparse_adam_ps.py.

Servers run in-process (`KVServer.serve_in_thread`), as the JAX tests run
them.  A training comparison builds the same program in both packages
(both unique-name counters reset), transpiles each against servers of
its own, seeds those servers with the JAX startup weights before either
startup runs (the init push is first-writer-wins, so both trainers start
from the same values), and trains both on the same seeded numpy batches.

Tolerances: dense SGD / Adam programs within rtol 1e-5 / atol 1e-6
(fp32 on both sides, the server applies the same numpy update); the
server-side sparse Adam against the reference recipe within rtol 1e-5 /
atol 1e-6 (tests/test_sparse_adam_ps.py's); the op kernels within rtol
1e-5 / atol 1e-6, ids and masks exactly.
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.static as jstatic
import paddle_tpu_torch
import paddle_tpu_torch.static as tstatic
from paddle_tpu.core.program import _reset_unique_names as jax_reset_names
from paddle_tpu.distributed.ps import kv_server as jkv
from paddle_tpu.distributed.ps import ps_optimizer as jps
from paddle_tpu.ops.kernels import distributed_ops as jops
from paddle_tpu_torch.core.program import (_reset_unique_names as
                                           torch_reset_names)
from paddle_tpu_torch.distributed.ps import kv_server as tkv
from paddle_tpu_torch.distributed.ps import ps_optimizer as tps
from paddle_tpu_torch.ops.kernels import distributed_ops as tops

torch.set_num_threads(2)

PKGS = {"jax": (paddle_tpu, jstatic, jkv, jps, jops),
        "torch": (paddle_tpu_torch, tstatic, tkv, tps, tops)}


@pytest.fixture(autouse=True)
def _fresh_clients():
    yield
    jops._reset_clients()
    tops._reset_clients()


def _servers(kv, n=1, num_trainers=1, **kw):
    srvs = [kv.KVServer("127.0.0.1:0", num_trainers=num_trainers, **kw)
            for _ in range(n)]
    for s in srvs:
        s.serve_in_thread()
    return srvs


def _client(srvs, **kw):
    c = tkv.KVClient([s.endpoint for s in srvs], rpc_deadline=10.0, **kw)
    c.wait_server_ready()
    return c


# ---------------------------------------------------------------------------
# the KV service
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("server,client", [("torch", "torch"),
                                           ("jax", "torch"),
                                           ("torch", "jax")])
def test_kv_roundtrip_and_modes(server, client):
    """init (first writer wins), async, sync (one trainer) and geo pushes
    and the barrier; each package's client speaks to either package's
    server (one wire protocol)."""
    srv = _servers(PKGS[server][2])[0]
    try:
        c = PKGS[client][2].KVClient([srv.endpoint])
        c.wait_server_ready()
        w = np.arange(6, dtype=np.float32).reshape(2, 3)
        c.init_param("w", w)
        c.init_param("w", w * 100)
        np.testing.assert_allclose(c.pull("w"), w)
        g = np.ones_like(w)
        c.push_grad("w", g, lr=0.5, sync=False)
        np.testing.assert_allclose(c.pull("w"), w - 0.5)
        c.push_grad("w", g, lr=0.5, sync=True)
        np.testing.assert_allclose(c.pull("w"), w - 1.0)
        c.push_delta("w", np.full_like(w, 0.25))
        np.testing.assert_allclose(c.pull("w"), w - 0.75)
        c.barrier()
        if client == "torch":
            assert c.stats["calls"] == 11 and c.stats["bytes_sent"] > 0
            assert c.stats["bytes_recv"] > 0 and c.stats["seconds"] > 0
        c.close()
    finally:
        srv.stop()


def test_kv_sync_two_trainers_and_timeout():
    """Two trainers' sync pushes apply their mean once both arrive; a lone
    push times out with a TimeoutError and is withdrawn from the next
    round's mean."""
    srv = _servers(tkv, num_trainers=2, sync_timeout=0.4)[0]
    try:
        c = _client([srv])
        c.init_param("w", np.zeros(2, np.float32))
        with pytest.raises(TimeoutError):
            c.push_grad("w", np.full(2, 100.0, np.float32), lr=1.0,
                        sync=True)
        done = []

        def other(v):
            c2 = tkv.KVClient([srv.endpoint])
            c2.push_grad("w", np.full(2, v, np.float32), lr=1.0, sync=True)
            done.append(v)
            c2.close()

        t = threading.Thread(target=other, args=(3.0,))
        t.start()
        c.push_grad("w", np.ones(2, np.float32), lr=1.0, sync=True)
        t.join(10)
        assert done == [3.0]
        np.testing.assert_allclose(c.pull("w"), -2.0 * np.ones(2))
        c.close()
    finally:
        srv.stop()


def test_heartbeat_shrinks_sync_fanin():
    """A trainer whose heartbeat stops is dropped from the sync fanin: the
    survivor's push completes with its gradient alone."""
    srv = _servers(tkv, num_trainers=2, sync_timeout=30.0,
                   heartbeat_timeout=1.0)[0]
    try:
        alive, dead = _client([srv]), _client([srv])
        alive.start_heartbeat(0, interval=0.2)
        dead.start_heartbeat(1, interval=0.2)
        alive.init_param("w", np.ones(4, np.float32))
        time.sleep(0.4)
        dead.stop_heartbeat()
        t0 = time.time()
        alive.push_grad("w", np.ones(4, np.float32), lr=0.5, sync=True)
        assert time.time() - t0 < 10
        np.testing.assert_allclose(alive.pull("w"), np.full(4, 0.5))
        alive.close()
        dead.close()
    finally:
        srv.stop()


def test_client_retries_through_restart_and_deadline():
    """A pserver killed and restarted on its port (store carried over)
    is reached again by the client's retries; with no server at all the
    retry loop ends in a ConnectionError within its deadline; a sparse
    push to an absent table is a typed error."""
    srv = _servers(tkv)[0]
    port = int(srv.endpoint.rsplit(":", 1)[1])
    c = tkv.KVClient([srv.endpoint], sock_timeout=5.0, rpc_deadline=20.0)
    holder = {}
    try:
        c.wait_server_ready()
        w = np.arange(8, dtype=np.float32).reshape(2, 4)
        c.init_param("w", w)
        snapshot = {k: v.copy() for k, v in srv._store.items()}
        srv.stop()

        def restart():
            time.sleep(0.5)
            s2 = tkv.KVServer(f"127.0.0.1:{port}", num_trainers=1)
            s2._store.update(snapshot)
            s2.serve_in_thread()
            holder["srv"] = s2

        t = threading.Thread(target=restart)
        t.start()
        np.testing.assert_allclose(c.pull("w"), w)
        t.join()
        c.push_grad("w", np.ones_like(w), lr=0.5, sync=False)
        np.testing.assert_allclose(c.pull("w"), w - 0.5)
        with pytest.raises((TimeoutError, KeyError),
                           match="not on this server"):
            c.push_sparse("ghost", np.array([0, 1]),
                          np.ones((2, 4), np.float32), lr=0.1)
    finally:
        c.close()
        if "srv" in holder:
            holder["srv"].stop()
    dead = tkv.KVClient(["127.0.0.1:1"], sock_timeout=0.3,
                        rpc_deadline=1.0, max_retries=3)
    t0 = time.time()
    with pytest.raises(ConnectionError, match="failed after"):
        dead.pull("nope")
    assert time.time() - t0 < 10


def _lazy_adam_ref(tab, pushes, lr, b1=0.9, b2=0.999, eps=1e-8):
    m1, m2, t, tab = np.zeros_like(tab), np.zeros_like(tab), 0, tab.copy()
    for ids, vals in pushes:
        uids, inv = np.unique(ids, return_inverse=True)
        g = np.zeros((uids.size,) + vals.shape[1:], np.float32)
        np.add.at(g, inv, vals)
        t += 1
        m1[uids] = b1 * m1[uids] + (1 - b1) * g
        m2[uids] = b2 * m2[uids] + (1 - b2) * g * g
        lr_t = lr * np.sqrt(1 - b2 ** t) / (1 - b1 ** t)
        tab[uids] -= lr_t * m1[uids] / (np.sqrt(m2[uids]) + eps)
    return tab


def test_server_side_sparse_adam_and_sync_rows():
    """Server-resident sparse Adam over 2 shards against the reference
    recipe; a sync sparse push averages over the trainers on the server
    (grad_scale ignored), and an empty push still completes the fanin."""
    srvs = _servers(tkv, 2)
    try:
        c = _client(srvs)
        c.init_sparse_table("tab", np.zeros((6, 3), np.float32))
        c.config_sparse_optimizer("tab", "adam")
        rng = np.random.RandomState(0)
        pushes = [(rng.randint(0, 6, 5), rng.randn(5, 3).astype(np.float32))
                  for _ in range(4)]
        for ids, vals in pushes:
            c.push_sparse("tab", ids, vals, lr=0.1)
        got = c.pull_sparse("tab", np.arange(6))
        np.testing.assert_allclose(
            got, _lazy_adam_ref(np.zeros((6, 3), np.float32), pushes, 0.1),
            rtol=1e-5, atol=1e-6)
    finally:
        for s in srvs:
            s.stop()
    srv = _servers(tkv, num_trainers=2)[0]
    try:
        boot = _client([srv])
        boot.init_sparse_table("tab", np.zeros((4, 2), np.float32))
        done = []

        def push(ids):
            c = tkv.KVClient([srv.endpoint], rpc_deadline=10.0)
            c.push_sparse("tab", ids, np.ones((ids.size, 2), np.float32),
                          lr=1.0, grad_scale=7.0, sync=True)
            done.append(1)
            c.close()

        ts = [threading.Thread(target=push, args=(np.array([1]),)),
              threading.Thread(target=push,
                               args=(np.zeros((0,), np.int64),))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
        assert len(done) == 2
        np.testing.assert_allclose(boot.pull_sparse("tab", np.array([1])),
                                   -0.5 * np.ones((1, 2)), atol=1e-6)
        boot.close()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the op kernels
# ---------------------------------------------------------------------------

def _both_kernels(op, ins_np, attrs, selected=None):
    """Run `op` in both registries on the same numpy inputs; `selected`
    names a Grad slot given as (rows, values, height)."""
    from paddle_tpu.core.selected_rows import SelectedRows as JRows
    from paddle_tpu.ops.registry import OpContext as JCtx, run_kernel as jrun
    from paddle_tpu_torch.core.selected_rows import SelectedRows as TRows
    from paddle_tpu_torch.ops.registry import OpContext as TCtx, \
        run_kernel as trun
    jins = {k: jnp.asarray(v) for k, v in ins_np.items()}
    tins = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in ins_np.items()}
    if selected is not None:
        rows, vals, h = selected
        jins["Grad"] = JRows(jnp.asarray(rows), jnp.asarray(vals), h)
        tins["Grad"] = TRows(torch.from_numpy(rows), torch.from_numpy(vals),
                             h)
    j = jrun(op, jins, dict(attrs), JCtx())
    t = trun(op, tins, dict(attrs), TCtx())
    return ({k: np.asarray(v) for k, v in j.items()},
            {k: v.numpy() for k, v in t.items()})


def test_lookup_sparse_table_ops_match_jax():
    """The seven lookup_sparse_table_* kernels against the JAX package's
    on the same inputs (duplicate ids, the merge's -1 padding, lazy Adam's
    untouched rows)."""
    rng = np.random.RandomState(1)
    V, D = 6, 3
    w = rng.randn(V, D).astype(np.float32)
    ids = np.array([1, 4, 1, 0], np.int64)
    vals = rng.randn(4, D).astype(np.float32)
    cases = [
        ("lookup_sparse_table_init", {"W": w}, {}, None),
        ("lookup_sparse_table_read", {"W": w, "Ids": ids}, {}, None),
        ("lookup_sparse_table_write",
         {"W": w, "Ids": ids[:2], "Value": vals[:2]}, {}, None),
        ("lookup_sparse_table_merge", {"Ids": ids, "Value": vals}, {}, None),
        ("lookup_sparse_table_grad_split", {}, {},
         (ids.astype(np.int32), vals, V)),
        ("lookup_sparse_table_fuse_sgd",
         {"Param": w, "LearningRate": np.float32(0.1)}, {},
         (ids.astype(np.int32), vals, V)),
        ("lookup_sparse_table_fuse_adam",
         {"Param": w, "Moment1": np.zeros((V, D), np.float32),
          "Moment2": np.zeros((V, D), np.float32),
          "Beta1Pow": np.float32(0.9), "Beta2Pow": np.float32(0.999),
          "LearningRate": np.float32(0.1)},
         {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
         (ids.astype(np.int32), vals, V)),
    ]
    for op, ins, attrs, sel in cases:
        j, t = _both_kernels(op, ins, attrs, sel)
        assert j.keys() == t.keys(), op
        for k in j:
            if np.issubdtype(j[k].dtype, np.integer):
                np.testing.assert_array_equal(t[k], j[k], err_msg=op)
            else:
                np.testing.assert_allclose(t[k], j[k], rtol=1e-5,
                                           atol=1e-6, err_msg=f"{op}/{k}")
    ref = _lazy_adam_ref(w, [(ids, vals)], 0.1)
    np.testing.assert_allclose(t["ParamOut"], ref, rtol=1e-5, atol=1e-6)


def test_queue_ops_and_marker_ops():
    """queue_generator, enqueue and dequeue as graph ops over a KV queue,
    fetch_barrier and listen_and_serv as markers; the KV queue is FIFO
    and a pop times out."""
    srv = _servers(tkv)[0]
    try:
        c = _client([srv])
        c.q_push("q1", np.arange(3, dtype=np.float32))
        c.q_push("q1", np.arange(3, 6, dtype=np.float32))
        np.testing.assert_allclose(c.q_pop("q1"), [0, 1, 2])
        np.testing.assert_allclose(c.q_pop("q1"), [3, 4, 5])
        with pytest.raises(TimeoutError):
            c.q_pop("q1", timeout=0.5)
        main, startup = tstatic.Program(), tstatic.Program()
        with tstatic.program_guard(main, startup):
            tstatic.layers.data("x", [4], dtype="float32")
            blk = main.global_block()
            blk.append_op("queue_generator", {}, {}, {"names": ["opq"]})
            d = blk.create_var(shape=[1], dtype="float32")
            blk.append_op("enqueue", {"X": ["x"]}, {"Out": [d.name]},
                          {"queue_name": "opq", "endpoints": [srv.endpoint]})
            blk.append_op("fetch_barrier", {"X": [d.name]}, {}, {})
            blk.create_var(name="popped", shape=[4], dtype="float32")
            blk.append_op("dequeue", {"Dummy": [d.name]},
                          {"Out": ["popped"]},
                          {"queue_name": "opq", "shape": [4],
                           "dtype": "float32", "timeout": 10.0,
                           "endpoints": [srv.endpoint]})
            blk.append_op("listen_and_serv", {}, {}, {})
        exe = tstatic.Executor(tstatic.CPUPlace())
        xv = np.array([9, 8, 7, 6], np.float32)
        with tstatic.scope_guard(tstatic.Scope()):
            exe.run(startup)
            (got,) = exe.run(main, feed={"x": xv}, fetch_list=["popped"])
        np.testing.assert_allclose(got, xv)
        c.close()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# transpiled training, both packages
# ---------------------------------------------------------------------------

def linreg(pkg):
    static, layers = pkg.static, pkg.static.layers
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = layers.data("x", [-1, 8])
        y = layers.data("y", [-1, 1])
        pred = layers.fc(x, size=1)
        loss = layers.mean(layers.square(layers.elementwise_sub(pred, y)))
        static.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def ctr(pkg, V=20, D=8, adam=False, distributed=True):
    """A sparse CTR tower: a row-sharded embedding (is_distributed), a
    pooled fc with relu, a 2-way softmax, cross-entropy."""
    static, layers = pkg.static, pkg.static.layers
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        slots = layers.data("slots", [-1, 3], dtype="int64")
        label = layers.data("label", [-1, 1], dtype="int64")
        emb = layers.embedding(slots, size=[V, D], is_sparse=True,
                               is_distributed=distributed,
                               param_attr=static.ParamAttr(name="ctr_emb"))
        fc1 = layers.fc(layers.reduce_sum(emb, dim=1), 16, act="relu")
        pred = layers.fc(fc1, 2, act="softmax")
        loss = layers.mean(layers.cross_entropy(pred, label))
        (static.Adam(learning_rate=0.05) if adam
         else static.SGD(learning_rate=0.1)).minimize(loss)
    return main, startup, loss


def _cfg(pkg_ps, graph_ops=True, sync=True, geo=0):
    cfg = pkg_ps.DistributeTranspilerConfig()
    cfg.use_graph_ops = graph_ops
    cfg.sync_mode = sync
    if geo:
        cfg.geo_sgd_mode = True
        cfg.geo_sgd_need_push_nums = geo
    return cfg


def _jax_startup(js):
    scope, exe = jstatic.Scope(), jstatic.Executor()
    with jstatic.scope_guard(scope):
        exe.run(js)
    return {n: np.asarray(scope.get(n)) for n in scope.vars
            if scope.get(n) is not None}


def _wire_free(program, endpoints):
    """program.to_dict() with its servers' endpoints named by position
    (each package trains against servers of its own)."""
    import json
    text = json.dumps(program.to_dict(), sort_keys=True)
    for i, ep in enumerate(endpoints):
        text = text.replace(ep, f"server{i}")
    return text


def _ps_train(name, build, cfg_kw, n_servers, feeds, init, tables=()):
    """Transpile `build(pkg)` against fresh servers seeded with `init`,
    train on `feeds`: (losses, the trained program, the servers'
    parameters, the trainer scope's parameters); a graph-op program comes
    back as _wire_free's text."""
    pkg, static, kv, ps, ops = PKGS[name]
    (jax_reset_names if name == "jax" else torch_reset_names)()
    main, startup, loss = build(pkg)
    srvs = _servers(kv, n_servers)
    eps = ",".join(s.endpoint for s in srvs)
    try:
        seed = _client(srvs)
        params = [p.name for p in main.all_parameters()]
        for n in params:
            if n in tables:
                seed.init_sparse_table(n, init[n])
            else:
                seed.init_param(n, init[n])
        t = ps.DistributeTranspiler(_cfg(ps, **cfg_kw))
        t.transpile(trainer_id=0, program=main, pservers=eps, trainers=1,
                    startup_program=startup)
        prog = t.get_trainer_program()
        if name == "jax":
            scope, exe = jstatic.Scope(), jstatic.Executor()
        else:
            scope, exe = tstatic.Scope(), tstatic.Executor(
                tstatic.CPUPlace())
        with static.scope_guard(scope):
            exe.run(startup)
            losses = [float(np.asarray(exe.run(prog, feed=f,
                                               fetch_list=[loss])[0])
                            .reshape(-1)[0]) for f in feeds]
        on_server = {n: (seed.pull_sparse(n, np.arange(init[n].shape[0]))
                         if n in tables else seed.pull(n)) for n in params}
        local = {n: np.asarray(tstatic.as_numpy(scope.get(n))
                               if name == "torch" else scope.get(n))
                 for n in params if n not in tables}
        seed.close()
        if not isinstance(prog, ps.PSCompiledProgram):
            prog = _wire_free(prog, [s.endpoint for s in srvs])
        return losses, prog, on_server, local
    finally:
        ops._reset_clients()
        for s in srvs:
            s.stop()


def _linreg_feeds(n=4):
    rng = np.random.RandomState(0)
    xb = rng.rand(16, 8).astype(np.float32)
    return [{"x": xb, "y": xb.sum(1, keepdims=True).astype(np.float32)}] * n


@pytest.mark.parametrize("mode", ["graph_sync", "graph_async",
                                  "runtime_sync", "runtime_async", "geo"])
def test_transpiled_linreg_matches_jax(mode):
    """The linear regression through the PS tier, each mode: the losses,
    the trainer's parameters and the servers' equal the JAX package's;
    the graph-op trainer programs serialize equal and carry send ->
    fetch_barrier -> recv."""
    cfg = {"graph_sync": dict(), "graph_async": dict(sync=False),
           "runtime_sync": dict(graph_ops=False),
           "runtime_async": dict(graph_ops=False, sync=False),
           "geo": dict(graph_ops=False, geo=2)}[mode]
    jax_reset_names()
    init = _jax_startup(linreg(paddle_tpu)[1])
    feeds = _linreg_feeds(5)
    jl, jp, js, jloc = _ps_train("jax", linreg, cfg, 2, feeds, init)
    tl, tp, ts, tloc = _ps_train("torch", linreg, cfg, 2, feeds, init)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    assert tl[-1] < tl[0]
    for n in js:
        np.testing.assert_allclose(ts[n], js[n], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tloc[n], jloc[n], rtol=1e-5, atol=1e-6)
    if mode.startswith("graph"):
        assert tp == jp
        assert tp.index('"send"') < tp.index('"fetch_barrier"') < \
            tp.index('"recv"')
    else:
        assert isinstance(tp, tps.PSCompiledProgram)
        assert tp._mode == jp._mode == ("geo" if mode == "geo" else
                                        mode.split("_")[1])


def _ctr_feeds(n, V=20, B=16, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        s = rng.randint(0, V, (B, 3)).astype(np.int64)
        out.append({"slots": s,
                    "label": (s.sum(1) > 1.5 * V).astype(np.int64)[:, None]})
    return out


@pytest.mark.parametrize("adam", [False, True])
def test_distributed_lookup_table_two_pservers(adam):
    """The CTR tower with its table row-sharded over two pservers: the
    trainer program (distributed_lookup_table pulls, a sparse send, the
    dense send/recv round) serializes equal to the JAX package's, and
    sync training (SGD, or server-side sparse Adam for the table) gives
    the JAX package's losses, table and dense weights."""
    jax_reset_names()
    init = _jax_startup(ctr(paddle_tpu, adam=adam)[1])
    feeds = _ctr_feeds(4)
    build = lambda pkg: ctr(pkg, adam=adam)  # noqa: E731
    jl, jp, js, _ = _ps_train("jax", build, {}, 2, feeds, init,
                              tables=("ctr_emb",))
    tl, tp, ts, _ = _ps_train("torch", build, {}, 2, feeds, init,
                              tables=("ctr_emb",))
    assert tp == jp
    assert '"type": "distributed_lookup_table"' in tp
    assert '"type": "lookup_table_v2"' not in tp
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    for n in js:
        np.testing.assert_allclose(ts[n], js[n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)
    assert not np.allclose(ts["ctr_emb"], init["ctr_emb"])


def test_startup_rewrite_and_pserver_program_equal():
    """transpile() rewrites the startup program (sparse init with the
    table's server optimizer, the dense init send -> barrier -> recv) and
    get_pserver_program marks a listen_and_serv program, equal in both
    packages; an is_distributed table without use_graph_ops is refused
    in both."""
    progs = {}
    for name in ("jax", "torch"):
        pkg, static, kv, ps, ops = PKGS[name]
        (jax_reset_names if name == "jax" else torch_reset_names)()
        main, startup, _ = ctr(pkg, adam=True)
        t = ps.DistributeTranspiler(_cfg(ps))
        t.transpile(trainer_id=1, program=main,
                    pservers="127.0.0.1:1,127.0.0.1:2", trainers=2,
                    startup_program=startup)
        pp = t.get_pserver_program("127.0.0.1:2")
        progs[name] = (startup.to_dict(), pp.to_dict(),
                       pp._ps_server_config)
        (jax_reset_names if name == "jax" else torch_reset_names)()
        main, startup, _ = ctr(pkg)
        t = ps.DistributeTranspiler(_cfg(ps, graph_ops=False))
        t.transpile(trainer_id=0, program=main, pservers="127.0.0.1:1",
                    trainers=1)
        with pytest.raises(ValueError, match="use_graph_ops"):
            t.get_trainer_program()
    assert progs["torch"] == progs["jax"]


def test_training_survives_pserver_restart():
    """An async graph-op trainer keeps stepping while its pserver is
    killed and restarted on its port with the store carried over."""
    srv = _servers(tkv)[0]
    port = int(srv.endpoint.rsplit(":", 1)[1])
    torch_reset_names()
    main, startup, loss = linreg(paddle_tpu_torch)
    t = tps.DistributeTranspiler(_cfg(tps, sync=False))
    t.transpile(trainer_id=0, program=main, pservers=srv.endpoint,
                trainers=1, startup_program=startup)
    prog = t.get_trainer_program()
    exe = tstatic.Executor(tstatic.CPUPlace())
    feed = _linreg_feeds(1)[0]
    srv2 = None
    try:
        with tstatic.scope_guard(tstatic.Scope()):
            exe.run(startup)
            losses = [float(exe.run(prog, feed=feed, fetch_list=[loss])[0])
                      for _ in range(3)]
            snapshot = {k: v.copy() for k, v in srv._store.items()}
            srv.stop()
            time.sleep(0.2)
            srv2 = tkv.KVServer(f"127.0.0.1:{port}", num_trainers=1)
            srv2._store.update(snapshot)
            srv2.serve_in_thread()
            losses += [float(exe.run(prog, feed=feed,
                                     fetch_list=[loss])[0])
                       for _ in range(5)]
        assert losses[-1] < losses[0] * 0.8, losses
    finally:
        if srv2 is not None:
            srv2.stop()


def test_run_steps_runs_ps_programs_eagerly():
    """Executor.run_steps of a program holding PS ops loops over run()
    (no CUDA graph can hold a host round-trip): K stacked steps equal K
    run() calls against a second server; a PSCompiledProgram is run a
    step at a time (run_steps refuses it)."""
    feeds = _linreg_feeds(3)
    jax_reset_names()
    init = _jax_startup(linreg(paddle_tpu)[1])
    want, _, wsrv, _ = _ps_train("torch", linreg, {}, 1, feeds, init)
    torch_reset_names()
    main, startup, loss = linreg(paddle_tpu_torch)
    srv = _servers(tkv)[0]
    try:
        seed = _client([srv])
        for p in main.all_parameters():
            seed.init_param(p.name, init[p.name])
        t = tps.DistributeTranspiler(_cfg(tps))
        t.transpile(trainer_id=0, program=main, pservers=srv.endpoint,
                    trainers=1, startup_program=startup)
        prog = t.get_trainer_program()
        assert tops.has_host_ops(prog) and not tops.has_host_ops(main)
        exe = tstatic.Executor(tstatic.CPUPlace())
        with tstatic.scope_guard(tstatic.Scope()):
            exe.run(startup)
            got = exe.run_steps(prog, feed={
                k: np.stack([f[k] for f in feeds]) for k in feeds[0]},
                fetch_list=[loss])
        np.testing.assert_allclose(np.asarray(got[0]).reshape(-1), want,
                                   rtol=1e-6)
        for n, v in wsrv.items():
            np.testing.assert_allclose(seed.pull(n), v, rtol=1e-6)
        seed.close()
    finally:
        tops._reset_clients()
        srv.stop()
    t = tps.DistributeTranspiler(_cfg(tps, graph_ops=False))
    t.transpile(trainer_id=0, program=linreg(paddle_tpu_torch)[0],
                pservers="127.0.0.1:1", trainers=1)
    with pytest.raises(TypeError, match="run it a step at a time"):
        exe.run_steps(t.get_trainer_program(),
                      feed={"x": np.zeros((1, 2, 8), np.float32)})


@pytest.mark.parametrize("op", ["cross_entropy", "sigmoid", "log",
                                "reduce_mean"])
def test_ctr_ops_and_grads_match_jax(op):
    """The ops the CTR programs need, new in the port: forward and the
    derived `<op>_grad` against the JAX package's kernels on the same
    inputs (rtol 1e-5 / atol 1e-6, fp32); cross_entropy with a hard label
    column (one ignored) and with soft labels."""
    from paddle_tpu.ops.registry import OpContext as JCtx, run_kernel as jrun
    from paddle_tpu_torch.ops.registry import OpContext as TCtx, \
        run_kernel as trun
    rng = np.random.RandomState(7)
    p = rng.rand(6, 4).astype(np.float32) + 0.1
    cases = {
        "cross_entropy": [
            ({"X": p / p.sum(1, keepdims=True),
              "Label": np.array([[0], [3], [1], [-100], [2], [3]])},
             {"soft_label": False, "ignore_index": -100}, "Y"),
            ({"X": p / p.sum(1, keepdims=True),
              "Label": np.full((6, 4), 0.25, np.float32)},
             {"soft_label": True}, "Y")],
        "sigmoid": [({"X": rng.randn(6, 4).astype(np.float32)}, {}, "Out")],
        "log": [({"X": p}, {}, "Out")],
        "reduce_mean": [({"X": p}, {"dim": [1], "keep_dim": False,
                                    "reduce_all": False}, "Out"),
                        ({"X": p}, {"dim": [0], "keep_dim": True,
                                    "reduce_all": True}, "Out")],
    }[op]
    for ins, attrs, out in cases:
        j = jrun(op, {k: jnp.asarray(v) for k, v in ins.items()}, attrs,
                 JCtx())[out]
        t = trun(op, {k: torch.from_numpy(np.asarray(v))
                      for k, v in ins.items()}, attrs, TCtx())[out]
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
        g = rng.rand(*np.shape(j)).astype(np.float32)
        gins = dict(ins, **{out: np.asarray(j), out + "@GRAD": g})
        jg = jrun(op + "_grad", {k: jnp.asarray(v) for k, v in gins.items()},
                  attrs, JCtx())["X@GRAD"]
        tg = trun(op + "_grad", {k: torch.from_numpy(np.array(v))
                                 for k, v in gins.items()}, attrs,
                  TCtx())["X@GRAD"]
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-6)
