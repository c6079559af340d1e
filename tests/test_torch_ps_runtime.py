"""The port's parameter-server runtime on the CPU: fleet's PS mode
against the JAX package's, fleet's PS hooks in-process, a whole
`launch --run_mode ps` job, and heterogeneous PS training in two
processes (mirroring tests/test_parameter_server.py::test_fleet_ps_mode
and tests/test_heter_ps.py).

Tolerances: fleet's async PS mode and the heter sections against the JAX
package within rtol 1e-5 / atol 1e-6 (fp32 both sides, SGD); the
launched job (2 servers, 2 trainers, sync, the table row-sharded) against
one process of plain SGD on the concatenated batch within rtol 1e-5 /
atol 1e-7: the servers apply the mean of the two trainers' gradients,
which equals the concatenated batch's gradient up to the order of the
sums.
"""
import json
import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.static as jstatic
import paddle_tpu_torch
import paddle_tpu_torch.static as tstatic
from paddle_tpu.core.program import _reset_unique_names as jax_reset_names
from paddle_tpu_torch.core.program import (_reset_unique_names as
                                           torch_reset_names)
from paddle_tpu_torch.distributed.ps import kv_server as tkv
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.ops.kernels import distributed_ops as tops

import torch_ps_worker as wk

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")


def _fleet_linreg(pkg, fleet_cls, a_sync):
    static, layers = pkg.static, pkg.static.layers
    f = fleet_cls()
    f.init(is_collective=False)
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = layers.data("x", [-1, 8])
        y = layers.data("y", [-1, 1])
        pred = layers.fc(x, size=1)
        loss = layers.mean(layers.square(layers.elementwise_sub(pred, y)))
        strategy = pkg.distributed.fleet.DistributedStrategy()
        strategy.a_sync = a_sync
        f.distributed_optimizer(static.SGD(learning_rate=0.05), strategy)
        f.minimize(loss)
    return f, main, startup, loss


@pytest.mark.parametrize("a_sync", [True, False])
def test_fleet_ps_mode_matches_jax(monkeypatch, a_sync):
    """fleet.init off collective mode with a server in the env: both
    packages pick ParameterServerOptimizer, and 8 steps through the
    PSCompiledProgram (async or sync) give the JAX package's losses and
    server-side weights from the same start."""
    from paddle_tpu.distributed.fleet.base.fleet_base import Fleet as JF
    from paddle_tpu_torch.distributed.fleet.base.fleet_base import \
        Fleet as TF
    import paddle_tpu.distributed  # noqa: F401
    import paddle_tpu_torch.distributed  # noqa: F401
    rng = np.random.RandomState(1)
    xb = rng.rand(16, 8).astype(np.float32)
    feed = {"x": xb, "y": xb.sum(1, keepdims=True).astype(np.float32)}
    got, init = {}, None
    for name, pkg, fcls, reset in (("jax", paddle_tpu, JF, jax_reset_names),
                                   ("torch", paddle_tpu_torch, TF,
                                    torch_reset_names)):
        srv = tkv.KVServer("127.0.0.1:0", num_trainers=1)
        srv.serve_in_thread()
        try:
            monkeypatch.setenv("TRAINING_ROLE", "TRAINER")
            monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
            monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST", srv.endpoint)
            reset()
            f, main, startup, loss = _fleet_linreg(pkg, fcls, a_sync)
            assert f.applied_meta_list() == ["ParameterServerOptimizer"]
            if name == "jax":
                scope, exe = jstatic.Scope(), jstatic.Executor()
                with jstatic.scope_guard(scope):
                    exe.run(startup)
                init = {n: np.asarray(v) for n, v in scope.vars.items()
                        if v is not None}
            else:
                scope = tstatic.Scope()
                load_params_from_numpy(scope, init, tstatic.CPUPlace())
                exe = tstatic.Executor(tstatic.CPUPlace())
            static = pkg.static
            with static.scope_guard(scope):
                losses = [float(np.asarray(exe.run(
                    f.main_program, feed=feed, fetch_list=[loss])[0])
                    .reshape(-1)[0]) for _ in range(8)]
            got[name] = (losses, {p.name: srv.get(p.name).copy()
                                  for p in main.all_parameters()})
            f.main_program._client.close()
        finally:
            srv.stop()
    np.testing.assert_allclose(got["torch"][0], got["jax"][0], rtol=1e-5,
                               atol=1e-6)
    assert got["torch"][0][-1] < got["torch"][0][0] * 0.6
    for n, v in got["jax"][1].items():
        np.testing.assert_allclose(got["torch"][1][n], v, rtol=1e-5,
                                   atol=1e-6)


def test_fleet_ps_runtime_hooks(monkeypatch):
    """A server role's fleet.init_server / run_server serves its
    endpoint's KV store for the role maker's trainer count; a trainer's
    init_worker connects to the servers and stop_worker shuts them down
    (run_server returns)."""
    from paddle_tpu_torch.distributed.fleet import (Role,
                                                    UserDefinedRoleMaker)
    from paddle_tpu_torch.distributed.fleet.base.fleet_base import Fleet
    from paddle_tpu_torch.distributed.launch_utils import find_free_ports
    import paddle_tpu_torch.distributed.ps.the_one_ps as one
    monkeypatch.setattr(one, "_runtime", one.PSRuntime())
    eps = [f"127.0.0.1:{find_free_ports(1)[0]}"]
    server = Fleet()
    server.init(UserDefinedRoleMaker(role=Role.SERVER, current_id=0,
                                     worker_num=2, server_endpoints=eps))
    assert server.is_server() and server.server_num() == 1
    server.init_server()
    assert server._ps_server.num_trainers == 2
    assert server._ps_server.endpoint == eps[0]
    t = threading.Thread(target=server.run_server, daemon=True)
    t.start()
    w = Fleet()
    w.init(UserDefinedRoleMaker(role=Role.WORKER, current_id=0,
                                worker_num=2, server_endpoints=eps))
    w.init_worker()
    c = w._ps_client
    c.init_param("p", np.ones(3, np.float32))
    np.testing.assert_allclose(c.pull("p"), np.ones(3))
    w.stop_worker()
    t.join(10)
    assert not t.is_alive()


def test_launch_ps_job_matches_one_process(tmp_path):
    """python -m paddle_tpu_torch.distributed.launch --run_mode ps
    --server_num 2 --worker_num 2 (tests/torch_ps_worker.py): 3 sync
    steps of the CTR tower, the table row-sharded over the two servers,
    each trainer on its half of a global batch of 2 x 8 rows; both
    trainers end with the parameters of plain SGD on the whole batch in
    one process."""
    cfg = {"batch": 8, "steps": 3, "seed": 5, "out_dir": str(tmp_path)}
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    p = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--run_mode", "ps", "--server_num", "2", "--worker_num", "2",
         "--log_dir", str(tmp_path / "logs"), "--term_grace", "5",
         os.path.join(TESTS, "torch_ps_worker.py"), str(cfg_path)],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    logs = "".join(open(os.path.join(tmp_path, "logs", n)).read()
                   for n in sorted(os.listdir(tmp_path / "logs")))
    assert p.returncode == 0, p.stderr + logs
    ranks = [dict(np.load(tmp_path / f"trainer{i}.npz")) for i in range(2)]
    torch_reset_names()
    main, startup, loss = wk.ctr_program(distributed=False)
    exe = tstatic.Executor(tstatic.CPUPlace())
    scope = tstatic.Scope()
    with tstatic.scope_guard(scope):
        exe.run(startup)
        want = [float(np.asarray(exe.run(
            main, feed=wk.ctr_batch(cfg["seed"] + s, 16),
            fetch_list=[loss])[0]).reshape(-1)[0]) for s in range(3)]
    for r in ranks:
        for pv in main.all_parameters():
            np.testing.assert_allclose(
                r[pv.name], tstatic.as_numpy(scope.get(pv.name)),
                rtol=1e-5, atol=1e-7, err_msg=pv.name)
    # each trainer's loss is its half's mean: their mean is the batch's
    np.testing.assert_allclose((ranks[0]["losses"] + ranks[1]["losses"])
                               / 2, want, rtol=1e-5)


B, HV, HD, STEPS = 16, 32, 8, 4


def _heter_build(pkg, distributed):
    static, layers = pkg.static, pkg.static.layers
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        slots = layers.data("slots", [B, 3], dtype="int64")
        label = layers.data("label", [B, 1], dtype="int64")
        emb = layers.embedding(slots, size=[HV, HD], is_sparse=True,
                               is_distributed=distributed,
                               param_attr=static.ParamAttr(name="h_emb"))
        pooled = layers.reduce_sum(emb, dim=1)
        fc1 = layers.fc(pooled, 16, act="relu",
                        param_attr=static.ParamAttr(name="h_fc1_w"),
                        bias_attr=static.ParamAttr(name="h_fc1_b"))
        pred = layers.fc(fc1, 2, act="softmax",
                         param_attr=static.ParamAttr(name="h_fc2_w"),
                         bias_attr=static.ParamAttr(name="h_fc2_b"))
        loss = layers.mean(layers.cross_entropy(pred, label))
        static.SGD(learning_rate=0.2).minimize(loss)
    return pooled, loss, main, startup


def test_heter_two_process_matches_jax_local_run(tmp_path):
    """The heter-mode transpile split at the pooled embedding
    (split_heter_program, equal sections in both packages): the CPU
    section in a second process against the KV tier, the device section
    here; their losses equal the JAX package's one-process run of the
    unsplit program from the same weights."""
    from paddle_tpu.distributed.heter import split_heter_program as jsplit
    from paddle_tpu.distributed.ps import ps_optimizer as jps
    from paddle_tpu_torch.distributed.heter import split_heter_program
    from paddle_tpu_torch.distributed.ps import ps_optimizer as tps
    rng = np.random.RandomState(0)
    slots = rng.randint(0, HV, (B, 3)).astype(np.int64)
    y = (slots.sum(1) > 1.5 * HV).astype(np.int64)[:, None]
    # the JAX package's local baseline, and its startup weights
    jax_reset_names()
    _, jloss, jm, js = _heter_build(paddle_tpu, False)
    scope, exe = jstatic.Scope(), jstatic.Executor()
    with jstatic.scope_guard(scope):
        exe.run(js)
        init = {n: np.asarray(v) for n, v in scope.vars.items()
                if v is not None}
        want = [float(np.asarray(exe.run(jm, feed={"slots": slots,
                                                   "label": y},
                                         fetch_list=[jloss])[0]))
                for _ in range(STEPS)]
    # both packages' splits of the heter-mode transpile are the same
    sections = {}
    for name, pkg, ps, split, reset in (
            ("jax", paddle_tpu, jps, jsplit, jax_reset_names),
            ("torch", paddle_tpu_torch, tps, split_heter_program,
             torch_reset_names)):
        reset()
        pooled, loss, main, startup = _heter_build(pkg, True)
        cfg = ps.DistributeTranspilerConfig()
        cfg.use_graph_ops = cfg.heter_mode = cfg.sync_mode = True
        t = ps.DistributeTranspiler(cfg)
        t.transpile(trainer_id=0, program=main, pservers="127.0.0.1:1",
                    trainers=1, startup_program=startup)
        cpu, dev = split(t.get_trainer_program(), [pooled],
                         ["127.0.0.1:1"], batch_size=B)
        sections[name] = (cpu.program.to_dict(), dev.program.to_dict(),
                          cpu.feeds, dev.feeds)
    assert sections["torch"] == sections["jax"]
    assert sections["torch"][2:] == (["slots"], ["label"])

    srv = tkv.KVServer("127.0.0.1:0", num_trainers=1)
    srv.serve_in_thread()
    proc = None
    try:
        seed = tkv.KVClient([srv.endpoint])
        seed.init_sparse_table("h_emb", init["h_emb"])
        torch_reset_names()
        pooled, loss, main, startup = _heter_build(paddle_tpu_torch, True)
        cfg = tps.DistributeTranspilerConfig()
        cfg.use_graph_ops = cfg.heter_mode = cfg.sync_mode = True
        t = tps.DistributeTranspiler(cfg)
        t.transpile(trainer_id=0, program=main, pservers=srv.endpoint,
                    trainers=1, startup_program=startup)
        cpu, dev = split_heter_program(t.get_trainer_program(), [pooled],
                                       [srv.endpoint], batch_size=B)
        spec = {"startup": t.get_startup_program().to_dict(),
                "cpu_program": cpu.program.to_dict(),
                "feed": slots.tolist(), "feed_name": "slots",
                "steps": STEPS}
        spec_path = tmp_path / "heter.json"
        spec_path.write_text(json.dumps(spec))
        proc = subprocess.Popen(
            [sys.executable, os.path.join(TESTS, "torch_ps_worker.py"),
             "heter_cpu", str(spec_path)],
            env=dict(os.environ, PADDLE_TRAINER_ID="0"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        exe = tstatic.Executor(tstatic.CPUPlace())
        scope = tstatic.Scope()
        with tstatic.scope_guard(scope):
            exe.run(t.get_startup_program())
            load_params_from_numpy(
                scope, {n: init[n] for n in ("h_fc1_w", "h_fc1_b",
                                             "h_fc2_w", "h_fc2_b")},
                tstatic.CPUPlace())
            got = [float(np.asarray(exe.run(dev.program,
                                            feed={"label": y},
                                            fetch_list=[loss])[0]))
                   for _ in range(STEPS)]
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0, out.decode()
        assert b"CPU_WORKER_DONE" in out
        seed.close()
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
        tops._reset_clients()
        srv.stop()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got[-1] < got[0]
