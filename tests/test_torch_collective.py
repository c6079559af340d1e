"""The port's collective ops on 4 gloo ranks against the JAX package's
kernels under `shard_map` on 4 of the 8 virtual CPU devices.

One world of 4 processes (`paddle_tpu_torch.distributed.spawn`, a
`file://` rendezvous) runs every case on its rank's rows of one global
input (tests/torch_dist_worker.py); the JAX package runs the same kernel
over the same global input with the rows split over a "dp" mesh axis
bound to ring 0.  Gates: gathers, broadcasts, scatters, max and min
equal to the last bit; sums, the product, the scale and dgc within rtol
1e-6 (summation order: XLA's psum and gloo's ring differ).  The inputs
of the sums and the product are positive (0.5-1.5), so a relative
tolerance on the result is meaningful (no cancellation; measured: up to
1.1e-6 on normal inputs, one ulp of a cancelled sum); dgc's summed
encodings are signed, so they are held within 1e-6 of the sum of their
magnitudes.  The product is the exact product in the port (NCCL's and
the reference's ncclProd) and exp(psum(log x)) in the JAX package.
The same world also runs the eager Python API (all_reduce, reduce,
broadcast, all_gather, scatter, alltoall, barrier, a sub-group, a bf16
allreduce) and fleet's metrics, held against numpy, and counts its
collectives (COMM_STATS).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.core.selected_rows import SelectedRows as JRows
from paddle_tpu.distributed.fleet.metrics import metric as jmetric
from paddle_tpu.ops.registry import OpContext, run_kernel
from paddle_tpu.utils.shard_map_compat import shard_map_unchecked

import torch_dist_worker
from paddle_tpu_torch import distributed as tdist

W = 4
ROWS = 3  # per rank

CASES = {
    "allreduce_sum": ("c_allreduce_sum", {}),
    "allreduce_max": ("c_allreduce_max", {}),
    "allreduce_min": ("c_allreduce_min", {}),
    "allreduce_prod": ("c_allreduce_prod", {}),
    "legacy_allreduce": ("allreduce", {}),
    "reduce_sum": ("c_reduce_sum", {"root_id": 1}),
    "broadcast": ("c_broadcast", {"root": 2}),
    "legacy_broadcast": ("broadcast", {"root": 1}),
    "allgather": ("c_allgather", {}),
    "reducescatter": ("c_reducescatter", {}),
    "scatter": ("c_scatter", {"root": 3}),
    "alltoall": ("alltoall", {}),
    "scale": ("scale_by_world_size", {}),
    "barrier": ("barrier", {}),
    "sync_calc": ("c_sync_calc_stream", {}),
    "sparse": ("sparse", {}),
    "dgc": ("dgc", {"m": 0.9, "sparsity": 0.8}),
}
POSITIVE = {"allreduce_sum", "allreduce_prod", "legacy_allreduce",
            "reduce_sum", "reducescatter", "scale"}
EXACT = {"allreduce_max", "allreduce_min", "broadcast", "legacy_broadcast",
         "allgather", "scatter", "alltoall", "barrier", "sync_calc"}


def _inputs():
    rng = np.random.RandomState(0)
    data = {}
    for name, (op, _) in CASES.items():
        rows = 4 * W if op in ("c_reducescatter", "c_scatter",
                               "alltoall") else ROWS
        if op == "sparse":
            data[name + "/rows"] = rng.randint(0, 10, (W * 5,)) \
                .astype(np.int64)
            data[name + "/values"] = rng.randn(W * 5, 3).astype(np.float32)
            data[name + "/height"] = np.int64(10)
        elif op == "dgc":
            data[name + "/U"] = rng.randn(W * 20).astype(np.float32)
            data[name + "/Grad"] = rng.randn(W * 20).astype(np.float32)
        elif name in POSITIVE:
            data[name] = rng.uniform(0.5, 1.5, (W * rows, 5)) \
                .astype(np.float32)
        else:
            data[name] = rng.randn(W * rows, 5).astype(np.float32)
    return data


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("collective")
    data = _inputs()
    np.savez(d / "in.npz", **data)
    tdist.spawn(torch_dist_worker.collective_ops,
                args=(str(d / "rendezvous"), str(d / "in.npz"), str(d),
                      CASES), nprocs=W)
    return data, [dict(np.load(d / f"rank{r}.npz")) for r in range(W)]


def _mesh():
    return Mesh(np.array(jax.devices()[:W]), ("dp",))


def _jax_case(op, attrs, *xs):
    """The JAX kernel over the global inputs `xs`, rows split over dp;
    the per-rank outputs concatenated along dim 0."""
    def f(*parts):
        ctx = OpContext(mesh_axes=("dp",), dist_info={0: "dp"})
        if op == "sparse":
            rows, vals, height = parts[0], parts[1], xs[2]
            o = run_kernel("c_allreduce_sum",
                           {"X": JRows(rows, vals, height)}, {}, ctx)["Out"]
            o = run_kernel("scale_by_world_size", {"X": o}, {}, ctx)["Out"]
            return o.rows, o.values
        if op == "dgc":
            o = run_kernel("dgc", {"U": parts[0], "Grad": parts[1]},
                           dict(attrs), ctx)
            red = run_kernel("c_allreduce_sum", {"X": o["EncodedGrad"]},
                             {}, ctx)["Out"]
            return o["UOut"], o["EncodedGrad"], red
        return run_kernel(op, {"X": parts[0]}, dict(attrs), ctx)["Out"]
    args = xs[:2] if op == "sparse" else xs
    outs = 2 if op == "sparse" else 3 if op == "dgc" else 1
    spec = tuple(P("dp") for _ in range(outs))
    g = shard_map_unchecked(f, _mesh(), in_specs=tuple(P("dp") for _ in args),
                            out_specs=spec if outs > 1 else P("dp"))
    res = jax.jit(g)(*[jnp.asarray(a) for a in args])
    res = res if outs > 1 else (res,)
    return [np.asarray(r) for r in res]


def _per_rank(a):
    n = a.shape[0] // W
    return [a[i * n:(i + 1) * n] for i in range(W)]


@pytest.mark.parametrize("name", [n for n, (op, _) in CASES.items()
                                  if op not in ("sparse", "dgc")])
def test_collective_op_matches_jax(world, name):
    data, ranks = world
    op, attrs = CASES[name]
    (want,) = _jax_case(op, attrs, data[name])
    for r, part in enumerate(_per_rank(want)):
        got = ranks[r][name]
        assert got.shape == part.shape, (name, r)
        if name in EXACT:
            np.testing.assert_array_equal(got, part, err_msg=f"{name} {r}")
        else:
            np.testing.assert_allclose(got, part, rtol=1e-6, atol=0,
                                       err_msg=f"{name} {r}")


def test_sparse_allreduce_gathers_rows(world):
    """SelectedRows: rows and values all-gathered (never summed), the
    values then scaled by 1 / W; the densified sum equals the dense sum
    of every rank's gradient."""
    data, ranks = world
    rows, vals = _jax_case("sparse", {}, data["sparse/rows"],
                           data["sparse/values"], 10)
    for r, (pr, pv) in enumerate(zip(_per_rank(rows), _per_rank(vals))):
        np.testing.assert_array_equal(ranks[r]["sparse/rows"], pr)
        np.testing.assert_allclose(ranks[r]["sparse/values"], pv, rtol=1e-6,
                                   atol=0)
        np.testing.assert_array_equal(ranks[r]["sparse/rows"],
                                      data["sparse/rows"])
    dense = np.zeros((10, 3), np.float64)
    np.add.at(dense, data["sparse/rows"], data["sparse/values"] / W)
    got = np.zeros((10, 3), np.float64)
    np.add.at(got, ranks[0]["sparse/rows"], ranks[0]["sparse/values"])
    np.testing.assert_allclose(got, dense, rtol=1e-6, atol=1e-7)


def test_dgc_then_allreduce_matches_jax(world):
    data, ranks = world
    u, enc, red = _jax_case("dgc", CASES["dgc"][1], data["dgc/U"],
                            data["dgc/Grad"])
    for r in range(W):
        for key, want in (("UOut", u), ("Encoded", enc)):
            np.testing.assert_allclose(ranks[r]["dgc/" + key],
                                       _per_rank(want)[r], rtol=1e-6, atol=0,
                                       err_msg=f"dgc {key} rank {r}")
        mags = sum(np.abs(p) for p in _per_rank(enc))
        err = np.abs(ranks[r]["dgc/Reduced"] - _per_rank(red)[r])
        assert (err <= 1e-6 * mags).all(), err.max()
        kept = np.count_nonzero(ranks[r]["dgc/Encoded"])
        assert kept == int(20 * (1 - 0.8)), kept


def test_eager_api(world):
    _, ranks = world
    base = np.arange(6, dtype=np.float32).reshape(3, 2)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["api/all_reduce"],
                                      W * base + 10 * sum(range(W)))
        np.testing.assert_array_equal(got["api/all_reduce_prod"],
                                      np.full(2, 24.0))
        np.testing.assert_array_equal(got["api/reduce_max"],
                                      np.full(2, W - 1.0))
        np.testing.assert_array_equal(got["api/broadcast"],
                                      np.full(3, W - 1.0))
        np.testing.assert_array_equal(
            got["api/all_gather"],
            np.stack([np.full((2, 2), float(i)) for i in range(W)]))
        np.testing.assert_array_equal(got["api/scatter"],
                                      np.full(2, 10.0 * r))
        np.testing.assert_array_equal(
            got["api/alltoall"],
            np.stack([np.full(2, 10.0 * j + r) for j in range(W)]))
        # new_group([0, 2]): the members sum, the others keep their value
        want = 4.0 if r in (0, 2) else r + 1.0
        np.testing.assert_array_equal(got["api/sub_group"], np.full(2, want))
        # bf16 over gloo: 0.5 + 1.5 + 2.5 + 3.5 = 8 is exact in bf16
        np.testing.assert_array_equal(got["api/all_reduce_bf16"],
                                      np.full(4, 8.0))


def test_comm_stats_count_each_collective(world):
    """COMM_STATS counts every collective by kind, with its bytes: under
    gloo reduce-scatter is an allreduce and alltoall an all-gather."""
    _, ranks = world
    kinds = dict(zip(torch_dist_worker.COMM_KINDS, (2, 1, 2, 0, 0)))
    for got in ranks:
        assert dict(zip(torch_dist_worker.COMM_KINDS,
                        got["comm/by_kind"].tolist())) == kinds
        assert got["comm/total"].tolist() == [5, 4 * (2 + 3 + 4 + 5 * W
                                                      + 6 * W)]


def test_fleet_metrics(world):
    """fleet.metrics over the 4 ranks against the JAX package's functions
    on one process (a world of one) over the summed statistics."""
    _, ranks = world
    rs = np.arange(W)
    pos = sum(np.array([r, 1, 2, 0], np.float64) for r in rs)
    neg = sum(np.array([1, r, 0, 3], np.float64) for r in rs)
    want = {"sum": np.array([rs.sum(), W]), "max": np.array([W - 1, 0]),
            "min": np.array([0, -(W - 1)]),
            "mae": jmetric.mae(np.array([0.5 * rs.sum()]),
                               np.array([(rs + 1).sum()])),
            "rmse": jmetric.rmse(np.array([0.25 * rs.sum()]),
                                 np.array([2 * W])),
            "acc": jmetric.acc(np.array([rs.sum()]), np.array([W * W])),
            "auc": jmetric.auc(pos, neg)}
    for got in ranks:
        for k, v in want.items():
            np.testing.assert_allclose(got["metric/" + k], v, rtol=1e-12,
                                       err_msg=k)


def test_world_of_one_is_identity():
    """No process group: every collective returns its input (the JAX
    package's ops off a mesh), the API leaves tensors as they are."""
    import torch
    from paddle_tpu_torch.ops.registry import OpContext as TCtx, \
        run_kernel as trun
    x = torch.arange(4.0)
    for op in ("c_allreduce_sum", "c_broadcast", "c_allgather",
               "c_reducescatter", "alltoall", "scale_by_world_size"):
        assert trun(op, {"X": x}, {}, TCtx())["Out"] is x
    t = x.clone()
    tdist.all_reduce(t)
    assert torch.equal(t, x)
    assert tdist.get_world_size() == 1 and tdist.get_rank() == 0


def test_later_ops_raise():
    import torch
    from paddle_tpu_torch.ops.registry import OpContext as TCtx, \
        run_kernel as trun
    for op in ("p_recv", "partial_allgather"):
        with pytest.raises(NotImplementedError,
                           match="Queue 1, Distribution"):
            trun(op, {"X": torch.ones(2)}, {}, TCtx())
    for fn in (lambda: tdist.send(torch.ones(1)),
               lambda: tdist.recv(torch.ones(1))):
        with pytest.raises(NotImplementedError,
                           match="Queue 1, Distribution"):
            fn()
    # the tensor-parallel ops are ported: off a process group each is
    # the identity; split stays refused, as in the JAX package
    x = torch.ones(2)
    for op in ("c_identity", "mp_allreduce_sum", "c_concat", "c_split"):
        assert trun(op, {"X": x}, {"ring_id": 102}, TCtx())["Out"] is x
    with pytest.raises(NotImplementedError, match="tensor_parallel"):
        tdist.split(None, 4, "linear")
