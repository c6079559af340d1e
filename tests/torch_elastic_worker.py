"""Rank processes of the port's elastic CPU tests (no JAX import: every
spawned or launched rank imports this module).

`build_fc` builds the elastic fc regression of the JAX package's
tests/test_elastic.py from either package (`pkg` is `paddle_tpu` or
`paddle_tpu_torch`), so a test builds both sides with one function.

Two ways in:

  * `elastic_world(init_file, out_dir, cases)`, started by
    `paddle_tpu_torch.distributed.spawn`: a gloo group over a `file://`
    rendezvous, one run of each case (steps, mode "run" / "run_steps",
    ZeRO stage), `rank<r>.npz` with the global-step losses and the
    gathered parameters.
  * `python tests/torch_elastic_worker.py <dir> <total_steps>`, started by
    `python -m paddle_tpu_torch.distributed.launch [--elastic]`: the
    PADDLE_* and PADDLE_TPU_* env contract picks rank, world, restart and
    fleet; the rank resumes from `<dir>/ckpt` (rank-merged where the
    writer world differs), checkpoints every global step, and writes
    `<dir>/out_rank<r>_r<restart>.json` after every global step (a killed
    incarnation leaves its trace so far).  With the fleet env
    (`launch --fleet_dir`) each host's rank trains the whole schedule on
    its own and the hosts publish checkpoints through the fleet barrier,
    as the JAX package's fleet worker does.  PADDLE_TPU_CHAOS may kill it
    at any step: that is the point.
"""
import json
import os
import sys

import numpy as np

LOGICAL = 4
BATCH = 2  # rows a logical rank


def build_fc(pkg, logical=LOGICAL, zero_stage=0, elastic=True):
    """The fc regression (8 -> 16 relu -> 1, Adam 1e-2), optionally ZeRO
    sharded over the logical world, elasticized at `logical`."""
    import importlib
    static = importlib.import_module(pkg.__name__ + ".static")
    layers = static.layers
    importlib.import_module(pkg.__name__ + ".core.program") \
        ._reset_unique_names()
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = layers.data("x", [-1, 8])
        y = layers.data("y", [-1, 1])
        h = layers.fc(x, 16, act="relu")
        pred = layers.fc(h, 1)
        loss = layers.mean(layers.square(layers.elementwise_sub(pred, y)))
        static.Adam(learning_rate=1e-2).minimize(loss)
    if zero_stage:
        sharding = importlib.import_module(
            pkg.__name__ + ".distributed.sharding")
        sharding.shard_optimizer_states(main, startup, dp_degree=logical,
                                        stage=zero_stage)
    meta = None
    if elastic:
        el = importlib.import_module(pkg.__name__ + ".distributed.elastic")
        meta = el.elasticize(main, startup, logical_dp=logical,
                             loss_name=loss)
    return main, startup, loss, meta


def feeds_for(steps, logical=LOGICAL, seed=0):
    """`steps` global batches of logical x BATCH rows."""
    rng = np.random.RandomState(seed)
    return [{"x": rng.rand(logical * BATCH, 8).astype(np.float32),
             "y": rng.rand(logical * BATCH, 1).astype(np.float32)}
            for _ in range(steps)]


def _load_state(scope, path):
    import torch
    for n, v in np.load(path).items():
        scope.set(n, torch.from_numpy(v.copy()))


def elastic_world(init_file, out_dir, cases):
    """Every case of `cases` ({name: {"steps", "state" (npz of the start
    state), "mode" ("run" or "run_steps"), "zero" (stage)}}) on this rank,
    one process group for all; `rank<r>.npz` holds each case's
    global-step losses and gathered parameters under `<name>/`."""
    import torch
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist
    env = dist.init_parallel_env(backend="gloo",
                                 init_method="file://" + init_file)
    out = {}
    for name, cfg in cases.items():
        for k, v in _run_case(env.world_size, cfg).items():
            out[f"{name}/{k}"] = v
    torch.distributed.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{env.rank}.npz"), **out)


def _run_case(w, cfg):
    import paddle_tpu_torch
    from paddle_tpu_torch import static
    from paddle_tpu_torch.distributed.elastic import rebucket_feeds
    main, startup, loss, meta = build_fc(paddle_tpu_torch,
                                         zero_stage=cfg.get("zero", 0))
    exe = static.Executor(static.CPUPlace())
    scope = static.Scope()
    losses = []
    with static.scope_guard(scope):
        exe.run(startup)
        _load_state(scope, cfg["state"])
        cp = static.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
        for f in feeds_for(cfg["steps"]):
            micro = rebucket_feeds(f, LOGICAL, w)
            if cfg.get("mode") == "run_steps":
                out = exe.run_steps(cp, feed={
                    n: np.stack([m[n] for m in micro]) for n in f},
                    fetch_list=[meta["loss_avg"]])
                losses.append(np.asarray(out[0])[-1].reshape(-1)[0])
            else:
                for mf in micro:
                    out = exe.run(cp, feed=mf,
                                  fetch_list=[meta["loss_avg"]])
                losses.append(np.asarray(out[0]).reshape(-1)[0])
        state = cp.global_state(scope)
    res = {p.name: state[p.name].numpy() for p in main.all_parameters()}
    res["losses"] = np.asarray(losses, np.float32)
    return res


def launched(base, total):
    """Launcher mode (module docstring)."""
    import torch
    torch.set_num_threads(1)
    import paddle_tpu_torch
    from paddle_tpu_torch import static
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.elastic import LaunchedRank

    lr = LaunchedRank(barrier_timeout_s=60.0)
    if lr.fleet is None:
        # a fleet's hosts meet at the checkpoints (the fleet barrier), not
        # in a process group
        dist.init_parallel_env(backend="gloo")
    out_json = os.path.join(base, f"out_{lr.tag}.json")
    main, startup, loss, meta = build_fc(paddle_tpu_torch)
    exe = static.Executor(static.CPUPlace())
    scope = static.Scope()
    mgr = lr.checkpoint_manager(os.path.join(base, "ckpt"), keep_last_n=3)
    losses, g = {}, 0

    def report(done=False, params=None):
        rec = {"rank": lr.rank, "world": lr.world, "restart": lr.restart,
               "elastic_env": os.environ.get("PADDLE_TPU_ELASTIC"),
               "logical_env": os.environ.get(
                   "PADDLE_TPU_ELASTIC_LOGICAL_WORLD"),
               "resumed_global": g, "losses": losses, "done": done}
        if params is not None:
            rec["params"] = params
        with open(out_json + ".tmp", "w") as f:
            json.dump(rec, f)
        os.replace(out_json + ".tmp", out_json)

    def step_done(gi, loss_value):
        losses[gi] = loss_value
        report()

    with static.scope_guard(scope):
        exe.run(startup)
        _load_state(scope, os.path.join(base, "start.npz"))
        g = lr.resume(exe, mgr, main, scope)
        report()
        cp = static.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
        lr.train(lambda mf: exe.run(cp, feed=mf,
                                    fetch_list=[meta["loss_avg"]]),
                 feeds_for(total), LOGICAL, start=g,
                 on_global_step=step_done)
        params = {p.name: scope.get(p.name).numpy().tolist()
                  for p in main.all_parameters()}
        report(done=True, params=params)
    mgr.close()
    if lr.fleet is None and lr.world > 1:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(launched(sys.argv[1], int(sys.argv[2])))


def gloo_worker(out_path):
    """One rank of the gloo rendezvous test (the env names the FILE store,
    the rank and the world): a barrier and an all-gather through
    `gloo_from_env`, then the role maker's barrier and all-gather, which
    ride the same store; the gathered lists go to `out_path` as JSON."""
    from paddle_tpu_torch.distributed.gloo import gloo_from_env
    from paddle_tpu_torch.distributed.fleet.base.role_maker import \
        PaddleCloudRoleMaker
    g = gloo_from_env()
    r = g.rank()
    g.barrier()
    got = g.all_gather({"rank": r, "sq": r * r})
    total = g.all_reduce(np.array([r + 1.0]), "sum")
    # a Gloo of its own: its generation counters start again, so its
    # collectives take their own comm world on the shared store
    rm = PaddleCloudRoleMaker(is_collective=True)
    rm._barrier("roles")
    roles = rm._all_gather(f"worker{r}", "roles")
    with open(out_path, "w") as f:
        json.dump({"rank": r, "size": g.size(), "gathered": got,
                   "sum": total.tolist(), "roles": roles}, f)
