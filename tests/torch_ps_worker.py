"""Launched processes of the port's parameter-server CPU tests (no JAX).

As a script it is one process of `python -m
paddle_tpu_torch.distributed.launch --run_mode ps ... torch_ps_worker.py
<cfg.json>`: fleet's role maker reads the launcher's env contract; a
server serves its KV store (fleet.init_server / run_server) until a
trainer shuts it down, a trainer transpiles the CTR tower of
`ctr_program` against the servers (graph ops, sync mode, the table
row-sharded), trains its shard of each global batch and writes its
losses and the parameters it ends with to `<out_dir>/trainer<i>.npz`.
`heter_cpu <spec.json>` runs the CPU section of a heter split instead.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

V, D, SLOTS, DENSE = 101, 4, 3, 2


def ctr_program(distributed=True, lr=0.1):
    """CTR-DNN's shape, narrow: SLOTS sparse slots of one id into one
    [V, D] table, DENSE dense features, fc 8-4 with relu, a 2-way softmax
    and cross-entropy, SGD."""
    import paddle_tpu_torch.static as static
    from paddle_tpu_torch.static import layers
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        ids = layers.data("ids", [-1, SLOTS], dtype="int64")
        dense = layers.data("dense", [-1, DENSE])
        label = layers.data("label", [-1, 1], dtype="int64")
        emb = layers.embedding(ids, size=[V, D], is_sparse=True,
                               is_distributed=distributed,
                               param_attr=static.ParamAttr(name="ctr_emb"))
        h = layers.concat([layers.reshape(emb, [-1, SLOTS * D]), dense],
                          axis=1)
        for width in (8, 4):
            h = layers.fc(h, width, act="relu")
        pred = layers.fc(h, 2, act="softmax")
        loss = layers.mean(layers.cross_entropy(pred, label))
        static.SGD(learning_rate=lr).minimize(loss)
    return main, startup, loss


def ctr_batch(seed, rows):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, (rows, SLOTS)).astype(np.int64)
    dense = rng.rand(rows, DENSE).astype(np.float32)
    label = ((ids.sum(1) % 2) ^ (dense[:, 0] > 0.5)).astype(np.int64)
    return {"ids": ids, "dense": dense, "label": label[:, None]}


def trainer(cfg):
    import paddle_tpu_torch.static as static
    import paddle_tpu_torch.distributed.fleet as fleet
    from paddle_tpu_torch.distributed.ps.ps_optimizer import (
        DistributeTranspiler, DistributeTranspilerConfig)
    main, startup, loss = ctr_program()
    i, n = fleet.worker_index(), fleet.worker_num()
    fleet.init_worker()  # connects, waits for every server
    tc = DistributeTranspilerConfig()
    tc.use_graph_ops = True
    tc.sync_mode = True
    t = DistributeTranspiler(tc)
    t.transpile(trainer_id=i, program=main,
                pservers=fleet.server_endpoints(to_string=True),
                trainers=n, startup_program=startup)
    prog = t.get_trainer_program()
    exe = static.Executor(static.CPUPlace())
    scope = static.Scope()
    losses = []
    b = cfg["batch"]
    with static.scope_guard(scope):
        exe.run(startup)
        for step in range(cfg["steps"]):
            full = ctr_batch(cfg["seed"] + step, b * n)
            mine = {k: v[i * b:(i + 1) * b] for k, v in full.items()}
            (lv,) = exe.run(prog, feed=mine, fetch_list=[loss])
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
    client = fleet._fleet_singleton._ps_client  # init_worker's client
    out = {"losses": np.asarray(losses),
           "ctr_emb": client.pull_sparse("ctr_emb", np.arange(V))}
    for p in main.all_parameters():
        if p.name != "ctr_emb":
            out[p.name] = static.as_numpy(scope.get(p.name))
    np.savez(os.path.join(cfg["out_dir"], f"trainer{i}.npz"), **out)
    client.barrier()  # every trainer has read its parameters
    if i == 0:
        fleet.stop_worker()


def main(cfg_path):
    torch.set_num_threads(1)
    import paddle_tpu_torch.distributed.fleet as fleet
    with open(cfg_path) as f:
        cfg = json.load(f)
    fleet.init()  # PaddleCloudRoleMaker from the launcher's env
    if fleet.is_server():
        fleet.init_server()
        fleet.run_server()
        return
    trainer(cfg)


def heter_cpu(spec_path):
    """The CPU section of a heter split: the startup program, then the
    section's steps on the host against the KV tier."""
    torch.set_num_threads(1)
    import paddle_tpu_torch.static as static
    from paddle_tpu_torch.core.program import Program
    with open(spec_path) as f:
        spec = json.load(f)
    startup = Program.from_dict(spec["startup"])
    cpu = Program.from_dict(spec["cpu_program"])
    feeds = np.asarray(spec["feed"], np.int64)
    exe = static.Executor(static.CPUPlace())
    with static.scope_guard(static.Scope()):
        exe.run(startup)
        for _ in range(spec["steps"]):
            exe.run(cpu, feed={spec["feed_name"]: feeds}, fetch_list=[])
    print("CPU_WORKER_DONE")


if __name__ == "__main__":
    if sys.argv[1] == "heter_cpu":
        heter_cpu(sys.argv[2])
    else:
        main(sys.argv[1])
