"""The port's dataset path (distributed/dataset.py, fleet/data_generator.py,
Executor.train_from_dataset / infer_from_dataset) against the JAX
package's, on the CPU, mirroring tests/test_dataset_path.py and
tests/test_downpour_dataset_ps.py.

Both packages read the same MultiSlot files (written from a seeded numpy
RNG), shuffle with the same seeds and train the same program from the
JAX startup weights.  Tolerances: parsed records, partitions and batch
order exactly; losses and parameters rtol 1e-5 / atol 1e-6 (fp32 SGD on
both sides).  The downpour case's table is updated by the KV server's
numpy Adam in both, from gradients that differ in the last bits: the
table within atol 2e-5 (test_torch_train.py's fp32 Adam tolerance: Adam
divides by sqrt(v), so a near-zero gradient's rounding shows as a share
of a ~lr step).
"""
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
from paddle_tpu_torch.io import load_params_from_numpy

torch.set_num_threads(2)


def write_multislot(path, n=64, seed=0, ids_len=4):
    """Each line: a sparse id slot (ids_len ids), a dense slot (2 floats)
    and a label slot (1 float)."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(n):
            ids = rng.randint(0, 50, ids_len)
            dense = rng.rand(2)
            parts = ([str(ids_len)] + [str(i) for i in ids]
                     + ["2"] + [f"{v:.4f}" for v in dense]
                     + ["1", f"{float(dense.mean()):.4f}"])
            f.write(" ".join(parts) + "\n")


def ctr_program(pkg):
    static, layers = pkg.static, pkg.static.layers
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        ids = layers.data("ids", [-1, 4], dtype="int64")
        dense = layers.data("dense", [-1, 2])
        label = layers.data("label", [-1, 1])
        emb = layers.embedding(ids, size=[50, 8], is_sparse=True)
        feat = layers.concat([layers.reduce_sum(emb, dim=1), dense], axis=1)
        pred = layers.fc(feat, size=1, act="sigmoid")
        loss = layers.mean(layers.square(layers.elementwise_sub(pred,
                                                                 label)))
        static.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _pkg(name):
    if name == "jax":
        return (paddle_tpu, jstatic, jax_reset_names, jstatic.Executor())
    return (paddle_tpu_torch, tstatic, torch_reset_names,
            tstatic.Executor(tstatic.CPUPlace()))


def _dataset(pkg, main, startup, files, kind="InMemoryDataset", batch=16,
             thread=2):
    static = pkg.static
    ds = pkg.distributed.DatasetFactory().create_dataset(kind)
    ds.set_batch_size(batch)
    ds.set_thread(thread)
    ds.set_filelist(files)
    with static.program_guard(main, startup):
        ds.set_use_var([main.global_block().var(n)
                        for n in ("ids", "dense", "label")])
    return ds


def _startup(pkg_name, startup, init):
    """A scope holding `init` (the JAX startup weights) for either
    package."""
    if pkg_name == "jax":
        scope, exe = jstatic.Scope(), jstatic.Executor()
        with jstatic.scope_guard(scope):
            exe.run(startup)
        return scope
    scope = tstatic.Scope()
    load_params_from_numpy(scope, init, tstatic.CPUPlace())
    return scope


def _jax_vars(scope):
    return {n: np.asarray(v) for n, v in scope.vars.items()
            if v is not None}


def _params(pkg_name, main, scope):
    return {p.name: np.asarray(tstatic.as_numpy(scope.get(p.name))
                               if pkg_name == "torch"
                               else scope.get(p.name))
            for p in main.all_parameters()}


def test_multislot_parse_and_generator_match_jax():
    """MultiSlotDataFeed parses a line into the same arrays (and refuses a
    truncated one) in both packages; the data generators emit the same
    text."""
    from paddle_tpu.distributed import MultiSlotDataFeed as J
    from paddle_tpu_torch.distributed import MultiSlotDataFeed as T
    for feed in (J(["ids", "dense"], ["int64", "float32"]),
                 T(["ids", "dense"], ["int64", "float32"])):
        rec = feed.parse_line("3 7 8 9 2 0.5 1.5")
        np.testing.assert_array_equal(rec[0], [7, 8, 9])
        assert rec[0].dtype == np.int64 and rec[1].dtype == np.float32
        np.testing.assert_allclose(rec[1], [0.5, 1.5])
        with pytest.raises(ValueError):
            feed.parse_line("5 1 2")
    from paddle_tpu.distributed.fleet import data_generator as jg
    from paddle_tpu_torch.distributed.fleet import data_generator as tg
    lines = [f"{i} {i * 0.5}" for i in range(7)]
    texts = []
    for mod in (jg, tg):
        class Gen(mod.MultiSlotDataGenerator):
            def generate_sample(self, line):
                a, b = line.split()

                def it():
                    yield [("ids", [int(a), int(a) + 1]),
                           ("dense", [float(b)])]
                return it

        g = Gen()
        g.set_batch(3)
        texts.append(g.run_from_memory(lines))
    assert texts[0] == texts[1] and texts[1].count("\n") == 7


def test_in_memory_train_matches_jax(tmp_path):
    """load_into_memory, local_shuffle and five passes of
    train_from_dataset: the port's losses and parameters equal the JAX
    package's; infer_from_dataset leaves the parameters as they were;
    release_memory empties the dataset."""
    files = [str(tmp_path / "a.txt"), str(tmp_path / "b.txt")]
    write_multislot(files[0], 64, seed=1)
    write_multislot(files[1], 64, seed=2)
    init, got = None, {}
    for name in ("jax", "torch"):
        pkg, static, reset, exe = _pkg(name)
        reset()
        main, startup, loss = ctr_program(pkg)
        ds = _dataset(pkg, main, startup, files)
        ds.load_into_memory()
        assert ds.get_memory_data_size() == 128
        scope = _startup(name, startup, init)
        if init is None:
            init = _jax_vars(scope)
        losses = []
        with static.scope_guard(scope):
            for _ in range(5):
                ds.local_shuffle()
                out = exe.train_from_dataset(main, ds, fetch_list=[loss])
                losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
            before = _params(name, main, scope)
            exe.infer_from_dataset(main, ds, fetch_list=[loss])
            after = _params(name, main, scope)
        for n in before:
            np.testing.assert_array_equal(after[n], before[n])
        got[name] = (losses, before)
        ds.release_memory()
        assert ds.get_memory_data_size() == 0
    np.testing.assert_allclose(got["torch"][0], got["jax"][0], rtol=1e-5,
                               atol=1e-6)
    for n, v in got["jax"][1].items():
        np.testing.assert_allclose(got["torch"][1][n], v, rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_global_shuffle_partitions_as_jax(tmp_path):
    """global_shuffle over 4 trainers: an exact partition (no record lost
    or doubled), each trainer's shard and its order equal to the JAX
    package's."""
    f1 = str(tmp_path / "g.txt")
    write_multislot(f1, 100, seed=3)

    class _Fleet:
        def __init__(self, rank, n):
            self._r, self._n = rank, n

        def worker_index(self):
            return self._r

        def worker_num(self):
            return self._n

    shards = {}
    for name in ("jax", "torch"):
        pkg, static, reset, _ = _pkg(name)
        reset()
        main, startup, _ = ctr_program(pkg)
        shards[name] = []
        for rank in range(4):
            ds = _dataset(pkg, main, startup, [f1], batch=10)
            ds.load_into_memory()
            ds.global_shuffle(fleet=_Fleet(rank, 4))
            shards[name].append([r[0].tolist() for r in ds._records])
    assert shards["torch"] == shards["jax"]
    assert sum(len(s) for s in shards["torch"]) == 100
    assert all(shards["torch"])


def test_queue_dataset_and_refusals(tmp_path):
    """QueueDataset streams its files through train_from_dataset (the
    loss equal to the JAX package's) and refuses the shuffles; a pipe
    command and an unknown dataset class are refused."""
    f1 = str(tmp_path / "q.txt")
    write_multislot(f1, 32, seed=4)
    init, losses = None, {}
    for name in ("jax", "torch"):
        pkg, static, reset, exe = _pkg(name)
        reset()
        main, startup, loss = ctr_program(pkg)
        ds = _dataset(pkg, main, startup, [f1], kind="QueueDataset",
                      batch=8)
        with pytest.raises(NotImplementedError):
            ds.local_shuffle()
        with pytest.raises(NotImplementedError):
            ds.global_shuffle()
        scope = _startup(name, startup, init)
        if init is None:
            init = _jax_vars(scope)
        with static.scope_guard(scope):
            out = exe.train_from_dataset(main, ds, fetch_list=[loss])
        losses[name] = float(np.asarray(out[0]).reshape(-1)[0])
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-5)
    main, startup, _ = ctr_program(paddle_tpu_torch)
    ds = _dataset(paddle_tpu_torch, main, startup, [f1])
    ds.set_pipe_command("cat")
    with pytest.raises(NotImplementedError):
        ds.load_into_memory()
    with pytest.raises(ValueError):
        paddle_tpu_torch.distributed.DatasetFactory().create_dataset("No")


def test_chunked_train_matches_per_step(tmp_path):
    """FLAGS_dataset_chunk_steps = 4 stacks four same-shape batches into
    one run_steps call: the trajectory equals the per-step one."""
    from paddle_tpu_torch.core.flags import set_flags
    f1 = str(tmp_path / "c.txt")
    write_multislot(f1, 64, seed=5)
    torch_reset_names()
    main, startup, loss = ctr_program(paddle_tpu_torch)
    exe = tstatic.Executor(tstatic.CPUPlace())
    scope0 = tstatic.Scope()
    with tstatic.scope_guard(scope0):
        exe.run(startup)
    init = {n: tstatic.as_numpy(v) for n, v in scope0.vars.items()
            if v is not None}
    res = []
    for chunk in (1, 4):
        ds = _dataset(paddle_tpu_torch, main, startup, [f1],
                      kind="QueueDataset", batch=16)
        scope = tstatic.Scope()
        load_params_from_numpy(scope, init, tstatic.CPUPlace())
        set_flags({"FLAGS_dataset_chunk_steps": chunk})
        try:
            with tstatic.scope_guard(scope):
                for _ in range(3):
                    last = exe.train_from_dataset(main, ds,
                                                  fetch_list=[loss])
        finally:
            set_flags({"FLAGS_dataset_chunk_steps": 1})
        res.append((float(np.asarray(last[0]).reshape(-1)[0]),
                    _params("torch", main, scope)))
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-6)
    for n in res[0][1]:
        np.testing.assert_allclose(res[1][1][n], res[0][1][n], rtol=1e-6)


def _downpour(pkg, V=32, D=8):
    static, layers = pkg.static, pkg.static.layers
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        ids = layers.data("ids", [-1, 3], dtype="int64")
        label = layers.data("label", [-1, 1], dtype="int64")
        emb = layers.embedding(ids, size=[V, D], is_sparse=True,
                               is_distributed=True,
                               param_attr=static.ParamAttr(name="dp_emb"))
        fc1 = layers.fc(layers.reduce_sum(emb, dim=1), 16, act="relu")
        pred = layers.fc(fc1, 2, act="softmax")
        loss = layers.mean(layers.cross_entropy(pred, label))
        static.Adam(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def test_downpour_dataset_through_ps_matches_jax(tmp_path):
    """The transpiled CTR program (distributed_lookup_table pulls, sparse
    sends, server-side Adam) under train_from_dataset: per pass, the
    port's loss and the server's table equal the JAX package's."""
    from paddle_tpu.distributed.ps import kv_server as jkv
    from paddle_tpu.distributed.ps import ps_optimizer as jps
    from paddle_tpu.ops.kernels import distributed_ops as jops
    from paddle_tpu_torch.distributed.ps import kv_server as tkv
    from paddle_tpu_torch.distributed.ps import ps_optimizer as tps
    from paddle_tpu_torch.ops.kernels import distributed_ops as tops
    V, B = 32, 16
    rng = np.random.RandomState(0)
    f1 = str(tmp_path / "part-0.txt")
    with open(f1, "w") as f:
        for _ in range(6 * B):
            ids = rng.randint(0, V, 3)
            f.write(" ".join(["3"] + [str(i) for i in ids]
                             + ["1", str(int(ids.sum() > 1.5 * V))]) + "\n")
    init, got = None, {}
    for name, kv, ps, ops in (("jax", jkv, jps, jops),
                              ("torch", tkv, tps, tops)):
        pkg, static, reset, exe = _pkg(name)
        reset()
        main, startup, loss = _downpour(pkg)
        srv = kv.KVServer("127.0.0.1:0", num_trainers=1)
        srv.serve_in_thread()
        try:
            if init is None:
                init = _jax_vars(_startup("jax", startup, None))
            seed = tkv.KVClient([srv.endpoint])
            for p in main.all_parameters():
                if p.name == "dp_emb":
                    seed.init_sparse_table(p.name, init[p.name])
                else:
                    seed.init_param(p.name, init[p.name])
            cfg = ps.DistributeTranspilerConfig()
            cfg.use_graph_ops = True
            t = ps.DistributeTranspiler(cfg)
            t.transpile(trainer_id=0, program=main, pservers=srv.endpoint,
                        trainers=1, startup_program=startup)
            prog = t.get_trainer_program()
            ds = pkg.distributed.DatasetFactory().create_dataset(
                "InMemoryDataset")
            ds.set_batch_size(B)
            ds.set_filelist([f1])
            with static.program_guard(main, startup):
                ds.set_use_var([main.global_block().var("ids"),
                                main.global_block().var("label")])
            ds.load_into_memory()
            scope = jstatic.Scope() if name == "jax" else tstatic.Scope()
            losses = []
            with static.scope_guard(scope):
                exe.run(startup)
                assert srv._sparse_opt["dp_emb"]["type"] == "adam"
                for _ in range(3):
                    ds.local_shuffle()
                    out = exe.train_from_dataset(prog, ds,
                                                 fetch_list=[loss])
                    losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
            got[name] = (losses, srv.get("dp_emb").copy())
            seed.close()
        finally:
            ops._reset_clients()
            srv.stop()
    np.testing.assert_allclose(got["torch"][0], got["jax"][0], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["torch"][1], got["jax"][1], atol=2e-5)
    assert not np.allclose(got["torch"][1], init["dp_emb"])
