"""Rank processes of the port's data-parallel CPU tests.

Each function runs in one process of a world started with
`paddle_tpu_torch.distributed.spawn` (the tests pass it by reference, so
this module is importable and imports no JAX): it forms a gloo process
group through `init_parallel_env` over a `file://` rendezvous, does its
part on its rank's inputs and writes `rank<r>.npz` (or `.json`) into
`out_dir` for the test process to hold against the JAX package.  Each
worker destroys its process group before returning.
"""
import json
import os

import numpy as np
import torch


def _init(init_file):
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist
    env = dist.init_parallel_env(backend="gloo",
                                 init_method="file://" + init_file)
    return env.rank, env.world_size


def _finish():
    import torch.distributed as tdist
    tdist.destroy_process_group()


def _kernel(op, ins, attrs):
    from paddle_tpu_torch.ops.registry import OpContext, run_kernel
    return run_kernel(op, ins, dict(attrs), OpContext(seed=0))


def collective_ops(init_file, in_path, out_dir, cases):
    """Every case of `cases` ({name: (op, attrs)}) on this rank's slice of
    the global input `in_path[name]` (dim 0 = ranks x rows); then the
    Python API (eager) and the fleet metrics on fixed rank values."""
    r, w = _init(init_file)
    data = np.load(in_path)
    out = {}

    def mine(name):
        a = data[name]
        n = a.shape[0] // w
        return torch.from_numpy(np.ascontiguousarray(a[r * n:(r + 1) * n]))

    from paddle_tpu_torch.core.selected_rows import SelectedRows
    for name, (op, attrs) in cases.items():
        if op == "sparse":
            x = SelectedRows(mine(name + "/rows"), mine(name + "/values"),
                             int(data[name + "/height"]))
            o = _kernel("c_allreduce_sum", {"X": x}, attrs)["Out"]
            o = _kernel("scale_by_world_size", {"X": o}, {})["Out"]
            out[name + "/rows"] = o.rows.numpy()
            out[name + "/values"] = o.values.numpy()
        elif op == "dgc":
            o = _kernel("dgc", {"U": mine(name + "/U"),
                                "Grad": mine(name + "/Grad")}, attrs)
            red = _kernel("c_allreduce_sum", {"X": o["EncodedGrad"]},
                          {})["Out"]
            out[name + "/UOut"] = o["UOut"].numpy()
            out[name + "/Encoded"] = o["EncodedGrad"].numpy()
            out[name + "/Reduced"] = red.numpy()
        else:
            x = mine(name)
            o = _kernel(op, {"X": x}, attrs)["Out"]
            out[name] = o.float().numpy()
            if not torch.equal(x, mine(name)):
                raise AssertionError(f"{op} wrote into its input")
    out.update(_api(r, w))
    _finish()
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **out)


def _api(r, w):
    """The eager collective API and fleet's metrics, on values made from
    the rank."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.fleet.metrics import metric
    out = {}
    t = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * r
    dist.all_reduce(t)
    out["api/all_reduce"] = t.numpy()
    t = torch.full((2,), float(r + 1))
    dist.all_reduce(t, op=dist.ReduceOp.PROD)
    out["api/all_reduce_prod"] = t.numpy()
    t = torch.full((2,), float(r))
    dist.reduce(t, dst=0, op=dist.ReduceOp.MAX)
    out["api/reduce_max"] = t.numpy()
    t = torch.full((3,), float(r))
    dist.broadcast(t, src=w - 1)
    out["api/broadcast"] = t.numpy()
    parts = []
    dist.all_gather(parts, torch.full((2, 2), float(r)))
    out["api/all_gather"] = np.stack([p.numpy() for p in parts])
    t = torch.zeros(2)
    dist.scatter(t, [torch.full((2,), float(10 * i)) for i in range(w)]
                 if r == 1 else None, src=1)
    out["api/scatter"] = t.numpy()
    got = []
    dist.alltoall([torch.full((1, 2), float(10 * r + j)) for j in range(w)],
                  got)
    out["api/alltoall"] = np.concatenate([g.numpy() for g in got])
    dist.barrier()
    g = dist.new_group([0, 2])
    t = torch.full((2,), float(r + 1))
    dist.all_reduce(t, group=g)
    out["api/sub_group"] = t.numpy()
    t = torch.full((4,), float(r) + 0.5, dtype=torch.bfloat16)
    dist.all_reduce(t)
    out["api/all_reduce_bf16"] = t.float().numpy()
    # the fleet metrics over the default group
    pos = np.array([r, 1, 2, 0], np.float64)
    neg = np.array([1, r, 0, 3], np.float64)
    out["metric/sum"] = np.asarray(metric.sum(np.array([r, 1.0])))
    out["metric/max"] = np.asarray(metric.max(np.array([r, -r])))
    out["metric/min"] = np.asarray(metric.min(np.array([r, -r])))
    out["metric/mae"] = np.asarray(metric.mae(np.array([r * 0.5]),
                                              np.array([r + 1])))
    out["metric/rmse"] = np.asarray(metric.rmse(np.array([r * 0.25]),
                                                np.array([2])))
    out["metric/acc"] = np.asarray(metric.acc(np.array([r]),
                                              np.array([w])))
    out["metric/auc"] = np.asarray(metric.auc(pos, neg))
    out.update(_comm_stats(w))
    # a ring of point-to-point sends: even ranks send first, odd ranks
    # receive first (gloo's send waits for its receiver)
    mine_t = torch.arange(3, dtype=torch.float32) + 10 * r
    got = torch.zeros(3)
    if r % 2 == 0:
        dist.send(mine_t, (r + 1) % w)
        dist.recv(got, (r - 1) % w)
    else:
        dist.recv(got, (r - 1) % w)
        dist.send(mine_t, (r + 1) % w)
    out["api/recv"] = got.numpy()
    return out


COMM_KINDS = ("all_reduce", "broadcast", "all_gather", "reduce_scatter",
              "all_to_all")


def _comm_stats(w):
    """COMM_STATS over one call of each collective from the eager API and
    the ops: the calls by kind (COMM_KINDS), then the calls and bytes in
    all."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.ops.kernels import collective as kc
    kc.reset_comm_stats()
    dist.all_reduce(torch.ones(2))
    dist.broadcast(torch.ones(3), src=0)
    dist.all_gather([], torch.ones(4))
    _kernel("c_reducescatter", {"X": torch.ones(w, 5)}, {})
    _kernel("alltoall", {"X": torch.ones(w, 6)}, {})
    by_kind = kc.COMM_STATS["calls_by_kind"]
    return {"comm/by_kind": np.array([by_kind.get(k, 0)
                                      for k in COMM_KINDS]),
            "comm/total": np.array([kc.COMM_STATS["calls"],
                                    kc.COMM_STATS["bytes"]])}


def static_dp(init_file, out_dir, cfg):
    """cfg: bert (build_bert_pretrain kwargs), weights (npz of the
    startup values), feed (npz of the global batch), run_steps (plain
    run() steps), k (then one run_steps call of k steps),
    fetch_aggregation, scramble (rank > 0 perturbs its start: the
    start broadcast must undo it).  Writes the fetched losses and every
    persistable."""
    r, w = _init(init_file)
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.io import load_params_from_numpy
    from paddle_tpu_torch.models import build_bert_pretrain
    from paddle_tpu_torch.ops import attention, fused_xent
    attention.enable_flash_attention(False)
    fused_xent.enable_fused_xent(False)
    _reset_unique_names()
    main, _, loss = build_bert_pretrain(use_amp=False, **cfg["bert"])
    scope = static.Scope()
    init = dict(np.load(cfg["weights"]))
    if cfg.get("scramble") and r > 0:
        init = {n: (v + 1 if v.dtype.kind == "f" else v)
                for n, v in init.items()}
    load_params_from_numpy(scope, init, static.CPUPlace())
    feed = dict(np.load(cfg["feed"]))
    bs = static.BuildStrategy()
    bs.fetch_aggregation = cfg["fetch_aggregation"]
    compiled = static.CompiledProgram(main, build_strategy=bs) \
        .with_data_parallel(loss_name=loss.name)
    exe = static.Executor(static.CPUPlace())
    fetched = []
    with static.scope_guard(scope):
        for _ in range(cfg["run_steps"]):
            fetched.append(exe.run(compiled, feed=feed,
                                   fetch_list=[loss])[0])
        if cfg["k"]:
            stacked = {n: np.stack([v] * cfg["k"]) for n, v in feed.items()}
            out = exe.run_steps(compiled, feed=stacked, fetch_list=[loss])
            fetched.extend(list(out[0]))
    _finish()
    res = {"loss/" + str(i): np.asarray(v) for i, v in enumerate(fetched)}
    prog = compiled._get_program()
    for n, v in scope.vars.items():
        if v is not None:
            res["var/" + n] = v.numpy()
    res["ops"] = np.array([op.type for op in prog.global_block().ops])
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **res)


def dygraph_dp(init_file, out_dir, data_path):
    """A Linear-Tanh-Linear MLP under DataParallel, Adam, one step a
    global batch (this rank's rows), from the weights in `data_path`."""
    r, w = _init(init_file)
    from paddle_tpu_torch import dygraph, nn, optimizer
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.core.place import CPUPlace
    from paddle_tpu_torch.core.program import _reset_unique_names
    data = np.load(data_path)
    _reset_unique_names()
    with dygraph.guard(CPUPlace()):
        net = dygraph.Sequential(nn.Linear(6, 8), nn.Tanh(),
                                 nn.Linear(8, 3))
        net.set_state_dict({k[len("w/"):]: data[k] for k in data.files
                            if k.startswith("w/")})
        model = dist.DataParallel(net)
        opt = optimizer.Adam(0.01, parameters=model.parameters())
    losses = []
    for i in range(int(data["steps"])):
        x, y = data[f"x{i}"], data[f"y{i}"]
        n = x.shape[0] // w
        xs = torch.from_numpy(x[r * n:(r + 1) * n])
        ys = torch.from_numpy(y[r * n:(r + 1) * n])
        loss = nn.functional.mse_loss(model(xs), ys)
        losses.append(float(loss))
        model.scale_loss(loss).backward()
        model.apply_collective_grads()
        opt.step()
        opt.clear_grad()
    _finish()
    res = {"param/" + k: v.detach().numpy()
           for k, v in net.state_dict().items()}
    res["losses"] = np.asarray(losses)
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **res)


def env_dump(out_dir):
    """The PADDLE_* contract as this process sees it."""
    keys = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
            "PADDLE_CURRENT_ENDPOINT", "PADDLE_TRAINER_ENDPOINTS",
            "FLAGS_selected_gpus")
    r = os.environ["PADDLE_TRAINER_ID"]
    with open(os.path.join(out_dir, f"env{r}.json"), "w") as f:
        json.dump({k: os.environ.get(k) for k in keys}, f)


def fail_or_wait(bad_rank, out_dir):
    """Rank `bad_rank` raises at once; the others wait (as a rank waits in
    a collective for a dead peer) and record that they were still
    running.  The failing rank first waits (30 s at most) until every
    other rank has written its file: under load a rank can take seconds
    to start, and one stopped before it writes leaves nothing to check."""
    import time
    r = int(os.environ["PADDLE_TRAINER_ID"])
    if r == bad_rank:
        w = int(os.environ["PADDLE_TRAINERS_NUM"])
        deadline = time.time() + 30
        while time.time() < deadline and not all(
                os.path.exists(os.path.join(out_dir, f"alive{i}"))
                for i in range(w) if i != r):
            time.sleep(0.05)
        raise RuntimeError(f"rank {r} fails on purpose")
    tmp = os.path.join(out_dir, f"alive{r}.tmp")
    with open(tmp, "w") as f:
        f.write(str(os.getpid()))
    os.replace(tmp, os.path.join(out_dir, f"alive{r}"))
    time.sleep(120)


def build_localsgd(k_steps):
    """A one-layer regression through fleet with strategy.localsgd (k
    steps, from step 1): (main, startup, loss, fc weight name)."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.static import layers
    _reset_unique_names()
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = layers.data("x", [-1, 4])
        y = layers.data("y", [-1, 1])
        loss = layers.mean(layers.square(
            layers.elementwise_sub(layers.fc(x, 1), y)))
        fleet.init(is_collective=True)
        strategy = fleet.DistributedStrategy()
        strategy.localsgd = True
        strategy.localsgd_configs = {"k_steps": k_steps, "begin_step": 1}
        fleet.distributed_optimizer(static.SGD(0.1), strategy) \
            .minimize(loss)
    return main, startup, loss


def localsgd_steps(data_path, rank):
    """Two steps of the LocalSGD program on rank `rank`'s batches: the
    persistables after each."""
    from paddle_tpu_torch import static
    data = np.load(data_path)
    main, startup, loss = build_localsgd(2)
    exe = static.Executor(static.CPUPlace())
    scope = static.Scope()
    out = {}
    with static.scope_guard(scope):
        exe.run(startup)
        for n in [p.name for p in main.all_parameters()]:
            scope.set(n, torch.from_numpy(data["w/" + n]))
        for i in range(2):
            exe.run(main, feed={"x": data[f"x{rank}_{i}"],
                                "y": data[f"y{rank}_{i}"]},
                    fetch_list=[loss])
            for p in main.all_parameters():
                out[f"step{i}/{p.name}"] = scope.vars[p.name].numpy().copy()
    return out


def localsgd_rank(init_file, out_dir, data_path):
    r, _ = _init(init_file)
    out = localsgd_steps(data_path, r)
    _finish()
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **out)


# ---------------------------------------------------------------------------
# ZeRO and tensor parallelism (tests/test_torch_sharding.py,
# tests/test_torch_tensor_parallel.py)
# ---------------------------------------------------------------------------
OPTIMIZERS = ("sgd", "momentum", "adam", "adamw", "lamb")


def build_zero_mlp(pkg, opt="adam", stage=1, dp=2, bucket=None, gm=1,
                   tp=1, amp=False, shard=True, fp16_allreduce=None):
    """The two-layer regression of tests/test_sharding.py from either
    package (`pkg` is paddle_tpu or paddle_tpu_torch): fc layers (col /
    row parallel at tp > 1), `opt`, optional bf16 AMP, ZeRO `stage` for
    `dp` ranks (with `shard`; `fp16_allreduce` casts the bucket
    reduce-scatter to bf16), then gradient merge over `gm` steps.
    Returns (main, startup, loss, plan or None)."""
    static = pkg.static
    layers = static.layers
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = layers.data("x", [-1, 8])
        y = layers.data("y", [-1, 1])
        if tp > 1:
            from importlib import import_module
            tpm = import_module(pkg.__name__ + ".distributed.tensor_parallel")
            h = tpm.col_parallel_fc(x, 16, act="relu", tp_degree=tp)
            pred = tpm.row_parallel_fc(h, 1, tp_degree=tp)
        else:
            h = layers.fc(x, 16, act="relu")
            h = layers.fc(h, 12, act="gelu")
            pred = layers.fc(h, 1)
        loss = layers.mean(layers.square(layers.elementwise_sub(pred, y)))
        o = {"sgd": lambda: static.SGD(0.05),
             "momentum": lambda: static.Momentum(0.05, 0.9),
             "adam": lambda: static.Adam(0.01),
             "adamw": lambda: static.AdamW(0.01),
             "lamb": lambda: static.Lamb(0.01)}[opt]()
        if amp:
            o = pkg.amp.decorate(o, init_loss_scaling=1.0,
                                 use_dynamic_loss_scaling=False,
                                 dest_dtype="bfloat16")
        _, params_grads = o.minimize(loss)
    return _shard_and_merge(pkg, main, startup, loss, params_grads, shard,
                            dp, stage, bucket, gm, fp16_allreduce)


def build_tp_lm(pkg, tp=2, dp=2, stage=0, vocab=64, hidden=32, layers=2,
                heads=4, seq=8):
    """models/static_lm.py's transformer LM at `tp`, trained by Adam,
    then ZeRO `stage` for `dp` ranks (0: none).  (main, startup, loss,
    plan or None)."""
    from importlib import import_module
    static = pkg.static
    lm = import_module(pkg.__name__ + ".models.static_lm")
    main, startup, loss, _ = lm.build_transformer_lm(
        vocab, hidden, layers, heads, seq, tensor_parallel_degree=tp)
    with static.program_guard(main, startup):
        _, params_grads = static.Adam(0.01).minimize(loss)
    return _shard_and_merge(pkg, main, startup, loss, params_grads,
                            stage > 0, dp, stage, None, 1)


def _shard_and_merge(pkg, main, startup, loss, params_grads, shard, dp,
                     stage, bucket, gm, fp16_allreduce=None):
    static = pkg.static
    plan = None
    if shard:
        from importlib import import_module
        sh = import_module(pkg.__name__ + ".distributed.sharding")
        plan = sh.shard_optimizer_states(main, startup, dp_degree=dp,
                                         stage=stage, bucket_bytes=bucket,
                                         fp16_allreduce=fp16_allreduce)
    if gm > 1:
        static.gradient_merge(main, gm, startup, params_grads=params_grads)
    return main, startup, loss, plan


def zero_train(init_file, out_dir, cases):
    """Every case of `cases` ({name: cfg}) on this rank: cfg holds the
    builder (`model`: "lm" for build_tp_lm, else build_zero_mlp) and its
    kwargs (`build`), `state` (npz of the GLOBAL persistables to start
    from, carried in through the program's placement), `feeds` (npz of
    <feed name><i>: the global batches) with `feed_names`, and
    `steps`.  Writes, per case, the fetched losses, the global state
    after the last step (CompiledProgram.global_state), the bytes of
    this rank's scope and the collective calls of the last step by op."""
    r, w = _init(init_file)
    import paddle_tpu_torch
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.distributed.compiled_program import (
        CompiledProgram, BuildStrategy)
    from paddle_tpu_torch.io import load_params_from_numpy
    from paddle_tpu_torch.ops.kernels import collective as kc
    out = {}
    for name, cfg in cases.items():
        _reset_unique_names()
        builder = build_tp_lm if cfg.get("model") == "lm" else \
            build_zero_mlp
        main, startup, loss, _ = builder(paddle_tpu_torch, **cfg["build"])
        bs = BuildStrategy()
        bs.tensor_parallel_degree = cfg["build"].get("tp", 1)
        cp = CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=bs)
        exe = static.Executor(static.CPUPlace())
        scope = static.Scope()
        feeds = np.load(cfg["feeds"])
        with static.scope_guard(scope):
            exe.run(startup)
            load_params_from_numpy(scope, dict(np.load(cfg["state"])),
                                   static.CPUPlace(), compiled=cp)
            losses = []
            for i in range(cfg["steps"]):
                kc.reset_comm_stats()
                lv, = exe.run(cp, feed={n: feeds[f"{n}{i}"]
                                        for n in cfg["feed_names"]},
                              fetch_list=[loss])
                losses.append(float(np.asarray(lv).reshape(-1)[0]))
            calls = dict(kc.COMM_STATS["calls_by_op"])
            out[name + "/scope_bytes"] = np.array(sum(
                t.numel() * t.element_size() for t in scope.vars.values()
                if t is not None))
            for n, v in cp.global_state(scope).items():
                out[name + "/state/" + n] = v.float().numpy()
        out[name + "/losses"] = np.asarray(losses)
        out[name + "/calls"] = np.array(json.dumps(calls, sort_keys=True))
    _finish()
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **out)


def tp_ops(init_file, in_path, out_dir):
    """The five tensor-parallel ops and their gradients on ring 102 bound
    to the world, on this rank's slice (dim 0) of the global inputs."""
    r, w = _init(init_file)
    from paddle_tpu_torch.ops.kernels import collective as kc
    import torch.distributed as tdist
    data = np.load(in_path)

    def mine(name):
        a = data[name]
        n = a.shape[0] // w
        return torch.from_numpy(np.ascontiguousarray(a[r * n:(r + 1) * n]))

    kc.register_ring(102, tdist.group.WORLD)
    a = {"ring_id": 102}
    out = {}
    x, g = mine("x"), mine("g")
    for op in ("c_identity", "mp_allreduce_sum", "c_concat", "c_split"):
        fwd = _kernel(op, {"X": x}, a)["Out"]
        gin = g if op != "c_concat" else mine("g_wide")
        if op == "c_split":
            gin = mine("g_narrow")
        grad = _kernel(op + "_grad", {"X": x, "Out": fwd, "Out@GRAD": gin},
                       a)["X@GRAD"]
        out[op + "/out"] = fwd.numpy()
        out[op + "/grad"] = grad.numpy()
    ea = dict(a, start_index=r * data["w"].shape[0] // w)
    wl, ids = mine("w"), torch.from_numpy(data["ids"])
    emb = _kernel("c_embedding", {"W": wl, "Ids": ids}, ea)["Out"]
    demb = _kernel("c_embedding_grad", {"W": wl, "Ids": ids, "Out": emb,
                                        "Out@GRAD": torch.from_numpy(
                                            data["g_emb"])}, ea)["W@GRAD"]
    out["c_embedding/out"] = emb.numpy()
    out["c_embedding/grad"] = demb.numpy()
    kc.clear_rings()
    _finish()
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **out)


def tp_decode(init_file, out_dir, cfg):
    """tp-sharded decode on this rank: the leader (rank 0) runs one
    forward per case of `cfg["step"]` (npz of ids / caches / offsets),
    then an engine with the tp pool, the radix cache and a 1-layer draft
    over `cfg["prompts"]`, first with fp32 weights, then with int8; the
    other ranks follow.  Writes the leader's logits, new caches, replies,
    counters and the ranks' scope and wire bytes."""
    r, w = _init(init_file)
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.core.place import CPUPlace
    from paddle_tpu_torch.models import (GPTConfig, GPTForGeneration,
                                         GPTModel)
    from paddle_tpu_torch.nn import MultiHeadAttention
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          PagedKVPool, RadixPrefixCache,
                                          SpeculativeDecoder,
                                          TPShardedDecoder, metrics,
                                          stamp_draft)
    with dygraph.guard(CPUPlace()):
        m = GPTForGeneration(GPTModel(GPTConfig(**cfg["model"])))
    m.gpt.set_state_dict({k: torch.from_numpy(v) for k, v in
                          np.load(cfg["weights"]).items()})
    m.eval()
    tp, out = cfg["tp"], {}
    for wd in ("float32", "int8"):
        dec = TPShardedDecoder(m, tp, weight_dtype=wd)
        if r:
            out[wd + "/followed"] = np.array(dec.follow())
            out[wd + "/bytes_received"] = np.array(dec.bytes_received)
            out[wd + "/shard_bytes"] = np.array(dec.shard_bytes()["sharded"])
            continue
        if wd == "float32":
            st = np.load(cfg["step"])
            for case in cfg["step_cases"]:
                ids = torch.from_numpy(st[case + "/ids"])
                cache = [MultiHeadAttention.Cache(
                    torch.from_numpy(st[f"{case}/k{li}"]),
                    torch.from_numpy(st[f"{case}/v{li}"]))
                    for li in range(cfg["model"]["num_layers"])]
                logits, caches = dec.forward(
                    ids, cache=cache,
                    pos_offset=torch.from_numpy(st[case + "/off"]),
                    attn_mask=torch.from_numpy(st[case + "/mask"]))
                out[case + "/logits"] = logits.numpy()
                out[case + "/sent"] = np.array(dec.last_step_bytes)
                for li, c in enumerate(caches):
                    out[f"{case}/k{li}"] = c.k.numpy()
                    out[f"{case}/v{li}"] = c.v.numpy()
        metrics.reset_serving_stats()
        plan = dict(cfg["plan"], tp_degree=tp, weight_dtype=wd)
        pool = PagedKVPool.from_plan(plan, device="cpu")
        radix = RadixPrefixCache(pool, low_watermark=2, high_watermark=4)
        spec = SpeculativeDecoder(stamp_draft(m, num_layers=1), k=2)
        eng = ContinuousBatchingEngine(dec, max_slots=2, kv_pool=pool,
                                       prefix_cache=radix,
                                       speculative=spec).start()
        try:
            replies = [np.asarray(eng.submit(np.asarray(p, np.int64),
                                             max_length=cfg["max_length"])
                                  .result(timeout=300))
                       for p in cfg["prompts"]]
        finally:
            eng.stop()
        pool.assert_drained()
        radix.clear()
        pool.assert_drained()
        dec.stop()
        for i, rep in enumerate(replies):
            out[f"{wd}/reply{i}"] = rep
        out[wd + "/counts"] = np.array(json.dumps({
            "tp_degree": eng.tp_degree, "weight_dtype": eng.weight_dtype,
            "radix_hits": radix.hits,
            "accepted": metrics.counter("spec.accepted"),
            "rollback_cols": metrics.counter("spec.rollback_cols"),
            "page_bytes": pool.page_bytes,
            "page_bytes_per_chip": pool.page_bytes_per_chip,
            "steps": dec.steps}))
        out[wd + "/shard_bytes"] = np.array(dec.shard_bytes()["sharded"])
    _finish()
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **out)


def scan_window_train(init_file, out_dir, cfg):
    """`run_steps` of the ZeRO x gradient-merge regression on this rank,
    hoisted and with PADDLE_TPU_SCAN_HOIST=0: for each mode the stacked
    losses of `cfg["calls"]` calls of K steps, the global state after
    them, whether the window was hoisted and the collectives by op."""
    r, w = _init(init_file)
    import paddle_tpu_torch
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.distributed.compiled_program import CompiledProgram
    from paddle_tpu_torch.io import load_params_from_numpy
    from paddle_tpu_torch.ops.kernels import collective as kc
    feeds = np.load(cfg["feeds"])
    out = {}
    for mode in ("hoisted", "unhoisted"):
        os.environ["PADDLE_TPU_SCAN_HOIST"] = "1" if mode == "hoisted" \
            else "0"
        _reset_unique_names()
        main, startup, loss, _ = build_zero_mlp(paddle_tpu_torch,
                                                **cfg["build"])
        cp = CompiledProgram(main).with_data_parallel(loss_name=loss.name)
        exe = static.Executor(static.CPUPlace())
        scope = static.Scope()
        with static.scope_guard(scope):
            exe.run(startup)
            load_params_from_numpy(scope, dict(np.load(cfg["state"])),
                                   static.CPUPlace(), compiled=cp)
            kc.reset_comm_stats()
            losses = [exe.run_steps(cp, feed={n: feeds[f"{n}{c}"]
                                              for n in ("x", "y")},
                                    fetch_list=[loss])[0]
                      for c in range(cfg["calls"])]
            out[mode + "/calls"] = np.array(json.dumps(
                kc.COMM_STATS["calls_by_op"], sort_keys=True))
            out[mode + "/hoisted"] = np.array(cp._last_hoisted)
            for n, v in cp.global_state(scope).items():
                out[f"{mode}/state/{n}"] = v.float().numpy()
        out[mode + "/losses"] = np.concatenate(losses)
    os.environ.pop("PADDLE_TPU_SCAN_HOIST", None)
    _finish()
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **out)


def build_sp_lm(pkg, vocab=64, hidden=32, layers=2, heads=2, seq=16):
    """models/static_lm.py's language model with sequence_parallel=True,
    trained by SGD (its update is linear in the gradient, so a state
    comparison stays as tight as the gradients'; Adam would turn the
    rounding noise of near-zero gradients into steps of the lr's
    order): (main, startup, loss)."""
    from importlib import import_module
    lm = import_module(pkg.__name__ + ".models.static_lm")
    main, startup, loss, _ = lm.build_transformer_lm(
        vocab, hidden, layers, heads, seq, sequence_parallel=True)
    with pkg.static.program_guard(main, startup):
        pkg.static.SGD(0.5).minimize(loss)
    return main, startup, loss


def build_sp_lm_fleet(pkg, sp=2):
    """`build_sp_lm` minimized through fleet's collective mode with
    `strategy.sequence_parallel` at degree `sp`: (fleet.main_program, the
    CompiledProgram, startup, loss)."""
    from importlib import import_module
    lm = import_module(pkg.__name__ + ".models.static_lm")
    fleet = import_module(pkg.__name__ + ".distributed.fleet")
    main, startup, loss, _ = lm.build_transformer_lm(
        64, 32, 2, 2, 16, sequence_parallel=True)
    with pkg.static.program_guard(main, startup):
        fleet.init(is_collective=True)
        strategy = fleet.DistributedStrategy()
        strategy.sequence_parallel = True
        strategy.sequence_parallel_configs = {"degree": sp,
                                              "ring_attention": True}
        fleet.distributed_optimizer(pkg.static.SGD(0.5),
                                    strategy).minimize(loss)
    return fleet.main_program, startup, loss


def build_ring_op(pkg, B=4, H=2, S=32, D=16):
    """tests/test_attention.py's one-op program: the ring_attention op
    (causal, ring 101) on q = k = v, loss the mean of its square."""
    from importlib import import_module
    static = pkg.static
    LayerHelper = import_module(pkg.__name__ +
                                ".static.layer_helper").LayerHelper
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        q = static.layers.data("q", [-1, S, H * D])
        helper = LayerHelper("ring_attention")
        out = helper.create_variable_for_type_inference("float32")
        out.shape = (-1, S, H * D)
        helper.append_op("ring_attention",
                         inputs={"Q": [q], "K": [q], "V": [q]},
                         outputs={"Out": [out]},
                         attrs={"causal": True, "ring_id": 101,
                                "num_heads": H})
        loss = static.layers.mean(static.layers.square(out))
    return main, startup, loss


def sp_ring(init_file, in_path, out_dir, cfg):
    """Sequence parallelism on this rank: `ring_attention` forward and
    gradients on its sequence shard of each case's global q, k, v, dO
    (the whole world one sp group); then `cfg["programs"]` ({name:
    {"model": "op" | "lm" | "fleet", "sp": n, "steps": k, "state": npz}})
    through a CompiledProgram with sequence_parallel_degree (fleet's, for
    "fleet"), writing the fetched
    losses (and the global state after the last step)."""
    r, w = _init(init_file)
    import paddle_tpu_torch
    import torch.distributed as tdist
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.distributed.compiled_program import (
        BuildStrategy, CompiledProgram)
    from paddle_tpu_torch.io import load_params_from_numpy
    from paddle_tpu_torch.ops.attention import RING_STATS, ring_attention
    data = np.load(in_path)
    out = {}
    for name in cfg["rings"]:
        causal = name.startswith("causal")
        n = data[name + "/q"].shape[2] // w

        def mine(key):
            a = data[f"{name}/{key}"][:, :, r * n:(r + 1) * n]
            return torch.from_numpy(np.ascontiguousarray(a))
        q, k, v = (mine(x).requires_grad_() for x in "qkv")
        o = ring_attention(q, k, v, tdist.group.WORLD, causal=causal)
        o.backward(mine("do"))
        out[name + "/out"] = o.detach().numpy()
        for x, t in zip("qkv", (q, k, v)):
            out[f"{name}/d{x}"] = t.grad.numpy()
    out["ring_bytes"] = np.array(RING_STATS["bytes_sent"])
    for name, pc in cfg["programs"].items():
        _reset_unique_names()
        if pc["model"] == "fleet":
            cp, startup, loss = build_sp_lm_fleet(paddle_tpu_torch,
                                                  pc["sp"])
        else:
            main, startup, loss = (build_ring_op if pc["model"] == "op"
                                   else build_sp_lm)(paddle_tpu_torch)
            bs = BuildStrategy()
            bs.sequence_parallel_degree = pc["sp"]
            cp = CompiledProgram(main, bs).with_data_parallel(
                loss_name=loss.name)
        exe, scope = static.Executor(static.CPUPlace()), static.Scope()
        feeds = np.load(pc["feeds"])
        with static.scope_guard(scope):
            exe.run(startup)
            if pc.get("state"):
                load_params_from_numpy(scope, dict(np.load(pc["state"])),
                                       static.CPUPlace(), compiled=cp)
            losses = []
            for i in range(pc["steps"]):
                lv, = exe.run(cp, feed={n: feeds[f"{n}{i}"]
                                        for n in pc["feed_names"]},
                              fetch_list=[loss])
                losses.append(np.asarray(lv, np.float32).reshape(()))
            for n, v in cp.global_state(scope).items():
                out[f"{name}/state/{n}"] = v.float().numpy()
        out[name + "/losses"] = np.asarray(losses)
    _finish()
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **out)


def moe_ep(init_file, in_path, out_dir):
    """Expert parallelism on this rank (the whole world one ep group):
    `incubate.moe.switch_moe` on its token shard (dim 0) with its expert
    shard of the global weights, forward and the gradients of
    mean(out ** 2); then the switch_moe op with `ep_ring_id` bound to the
    world through the ring registry.  Writes out, aux and the gradients,
    and the all-to-all calls by op."""
    r, w = _init(init_file)
    import torch.distributed as tdist
    from paddle_tpu_torch.incubate.moe import switch_moe
    from paddle_tpu_torch.ops.kernels import collective as kc
    data = np.load(in_path)
    n, e = data["x"].shape[0] // w, data["w1"].shape[0] // w

    def rows(a, m):
        return torch.from_numpy(np.ascontiguousarray(a[r * m:(r + 1) * m]))
    x = rows(data["x"], n).requires_grad_()
    gw = torch.from_numpy(data["gw"]).requires_grad_()
    ex = [rows(data[k], e).requires_grad_() for k in ("w1", "b1", "w2",
                                                      "b2")]
    kc.reset_comm_stats()
    out, aux = switch_moe(x, gw, *ex, capacity_factor=float(data["cf"]),
                          group=tdist.group.WORLD)
    (out ** 2).mean().backward()
    res = {"out": out.detach().numpy(), "aux": aux.detach().numpy(),
           "d_gw": gw.grad.numpy(), "d_x": x.grad.numpy()}
    x = x.detach()
    for k, t in zip(("w1", "b1", "w2", "b2"), ex):
        res["d_" + k] = t.grad.numpy()
    res["calls"] = np.array(json.dumps(kc.COMM_STATS["calls_by_op"]))
    kc.register_ring(7, tdist.group.WORLD)
    op = _kernel("switch_moe", {"X": x[None], "GateW": gw.detach(),
                                "W1": ex[0].detach(), "B1": ex[1].detach(),
                                "W2": ex[2].detach(), "B2": ex[3].detach()},
                 {"capacity_factor": float(data["cf"]), "ep_ring_id": 7})
    res["op_out"] = op["Out"][0].numpy()
    kc.clear_rings()
    _finish()
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **res)


def build_bn_program(pkg, shape):
    """x -> conv2d -> batch_norm -> loss = mean((y * ct)) and SGD, in
    either package (the sync_batch_norm tests)."""
    static = pkg.static
    layers = static.layers
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = layers.data("x", [-1] + list(shape[1:]))
        ct = layers.data("ct", [-1, 4] + list(shape[2:]))
        h = layers.conv2d(x, 4, 3, padding=1, bias_attr=False)
        y = layers.batch_norm(h, momentum=0.8)
        loss = layers.mean(layers.elementwise_mul(y, ct))
        static.SGD(learning_rate=0.5).minimize(loss)
    return main, startup, loss, y


def sync_bn(init_file, out_dir, data_path):
    """This rank's half of the global batch through (a) the
    sync_batch_norm kernel and its grad op, (b) the dygraph SyncBatchNorm
    layer (forward, backward, running stats) and (c) a static program
    with BuildStrategy.sync_batch_norm under a CompiledProgram (one SGD
    step: Y, the parameters and running stats after it, the rewritten op
    types)."""
    r, w = _init(init_file)
    import paddle_tpu_torch
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.io import load_params_from_numpy
    data = dict(np.load(data_path))

    def mine(a):
        n = a.shape[0] // w
        return torch.from_numpy(np.ascontiguousarray(a[r * n:(r + 1) * n]))

    out = {}
    ins = {"X": mine(data["x"]), "Scale": torch.from_numpy(data["scale"]),
           "Bias": torch.from_numpy(data["bias"]),
           "Mean": torch.from_numpy(data["mean"]),
           "Variance": torch.from_numpy(data["var"])}
    attrs = {"momentum": 0.8, "epsilon": 1e-5}
    fwd = _kernel("sync_batch_norm", ins, attrs)
    for k in ("Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        out["a/" + k] = fwd[k].numpy()
    gins = dict(ins, **fwd)
    gins["Y@GRAD"] = mine(data["ct"])
    grads = _kernel("sync_batch_norm_grad", gins, attrs)
    for k in ("X@GRAD", "Scale@GRAD", "Bias@GRAD"):
        out["a/" + k] = grads[k].numpy()
    # (b) the dygraph layer
    from paddle_tpu_torch import dygraph, nn
    with dygraph.guard(static.CPUPlace()):
        bn = nn.SyncBatchNorm(3, momentum=0.8)
        bn.set_state_dict({"weight": data["scale"], "bias": data["bias"],
                           "_mean": data["mean"], "_variance": data["var"]})
        x = mine(data["x"]).requires_grad_(True)
        y = bn(x)
        (y * mine(data["ct"])).sum().backward()
        out["b/Y"] = y.detach().numpy()
        out["b/X@GRAD"] = x.grad.numpy()
        out["b/Scale@GRAD"] = bn.weight.grad.numpy()
        out["b/mean"] = bn._mean.numpy()
        out["b/var"] = bn._variance.numpy()
    # (c) the static program, sync_batch_norm through the BuildStrategy
    _reset_unique_names()
    main, _, loss, yv = build_bn_program(paddle_tpu_torch,
                                         data["x"].shape)
    scope = static.Scope()
    load_params_from_numpy(scope, {k[5:]: v for k, v in data.items()
                                   if k.startswith("init/")},
                           static.CPUPlace())
    bs = static.BuildStrategy()
    bs.sync_batch_norm = True
    bs.fetch_aggregation = "concat"  # Y: the ranks' rows, in rank order
    cp = static.CompiledProgram(main, build_strategy=bs) \
        .with_data_parallel(loss_name=loss.name)
    exe = static.Executor(static.CPUPlace())
    with static.scope_guard(scope):
        (yo,) = exe.run(cp, feed={"x": data["x"], "ct": data["ct4"]},
                        fetch_list=[yv.name])
    out["c/Y"] = np.asarray(yo)
    for n, v in scope.vars.items():
        if v is not None and n in {k[5:] for k in data
                                   if k.startswith("init/")}:
            out["c/var/" + n] = v.numpy()
    out["c/ops"] = np.array([op.type for op in
                             cp._get_program().global_block().ops])
    _finish()
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **out)
