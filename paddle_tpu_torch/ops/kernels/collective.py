"""Collective ops over torch.distributed.

Counterpart of paddle_tpu/ops/kernels/collective.py.  The JAX package
traces a program under `shard_map` over a mesh, and its collectives
become XLA collectives over the mesh axis a `ring_id` names.  The port
runs one process per rank: a `ring_id` names a torch.distributed process
group (ring 0 the default group, others registered by
`distributed.new_group`), and each op calls the group's collective
eagerly, NCCL for CUDA tensors where each rank has a device of its own,
gloo otherwise.  Outside an initialised process group the world is 1
and every collective is the identity, as the JAX package's ops are off
a mesh.  Inside a group of world 1 the op still calls the collective.

  * c_allreduce_{sum,max,min,prod}, allreduce and c_reduce_* are an
    allreduce (c_reduce_* too, as in the JAX package: every rank holds
    the root's value).  prod is the backend's exact product (NCCL's
    ncclProd, the reference's), not the JAX package's exp(psum(log x)),
    which differs for values <= 0.
  * A SelectedRows input (an `is_sparse` embedding gradient) is
    all-gathered, rows and values, never summed: summing would add the
    row indices; concatenation is the sum under scatter-add.
  * c_broadcast / broadcast copy `root`'s tensor to every rank;
    c_allgather concatenates along dim 0; c_reducescatter and c_scatter
    keep this rank's dim-0 slice; alltoall swaps dim-0 chunks; barrier
    adds 0 x an allreduced one.
  * scale_by_world_size divides by the group's size.

Under gloo some collectives are composed (gloo's CUDA path has allreduce
and broadcast): all-gather of a CUDA tensor goes through a host copy,
reduce-scatter is an allreduce and a `narrow`, alltoall an all-gather
and a `narrow`.  NCCL uses its native collective for each, so a step
captured as a CUDA graph (`Executor.run_steps`) holds them.

Every op returns a new tensor and never writes into its input (the
executor's rule: an input may be a scope buffer a captured step reads).

The sync, wait and comm-init ops are no-ops: torch.distributed orders
the collectives on the streams itself and forms its communicators at
`init_process_group`.  The point-to-point and elastic ops raise: they
belong to later slices.

The tensor-parallel ops (distributed/tensor_parallel.py's Megatron
layers) run on the group of their ring (TP_RING_ID, 102, under a
CompiledProgram with tensor_parallel_degree > 1): c_identity is the
identity with a sum over the ring as its gradient, mp_allreduce_sum the
sum with the identity as its gradient, c_concat gathers the last axis
(its gradient the sum's slice), c_split keeps this rank's last-axis
slice, and c_embedding looks up a vocabulary shard and sums.  Their
gradients that communicate are explicit: the derived gradient replays
the forward under torch.func.vjp, which would call the collective again
and could not differentiate it."""
from __future__ import annotations

import time
from typing import Any, Dict

import torch

from ..registry import register_op

__all__ = ["register_ring", "clear_rings", "ring_group", "bound_group",
           "world_of",
           "rank_of", "all_reduce", "gather_rows", "broadcast",
           "reduce_scatter", "all_to_all", "COMM_STATS", "reset_comm_stats",
           "time_collectives"]

_LATER = "ROADMAP.md Queue 1, Distribution"

# ring_id -> process group; ring 0 is the default group unless set
_RINGS: Dict[int, Any] = {}

# calls (in all, by collective and by the op or gradient that made them)
# and bytes of every collective since the last reset; with time_collectives(True), the seconds they took,
# each synchronised before and after (the host-side cost, overlap removed);
# "replayed_by_op": the collectives of captured steps' replays, by op
# (static/executor.py counts them from each capture)
COMM_STATS: Dict[str, Any] = {"calls": 0, "bytes": 0, "seconds": 0.0,
                              "calls_by_kind": {}, "calls_by_op": {},
                              "replayed_by_op": {}}
_TIMING = {"on": False}


def reset_comm_stats() -> None:
    COMM_STATS.update(calls=0, bytes=0, seconds=0.0, calls_by_kind={},
                      calls_by_op={}, replayed_by_op={})


def _count_op(name: str) -> None:
    """One call of the op `name` on a process group (its collectives are
    counted by kind too: under gloo a reduce-scatter is an allreduce)."""
    by_op = COMM_STATS["calls_by_op"]
    by_op[name] = by_op.get(name, 0) + 1


def time_collectives(on: bool):
    """Synchronise the device around each collective and add its time to
    COMM_STATS["seconds"] (off by default: it removes overlap)."""
    _TIMING["on"] = bool(on)


def register_ring(ring_id: int, group) -> None:
    _RINGS[int(ring_id)] = group


def clear_rings() -> None:
    _RINGS.clear()


def _dist():
    import torch.distributed as dist
    return dist


def ring_group(ring_id=0):
    """The process group of `ring_id`, or None when no process group is
    initialised or this rank is not in the ring's group (the op is then
    the identity)."""
    dist = _dist()
    if not dist.is_available() or not dist.is_initialized():
        return None
    rid = int(ring_id or 0)
    if rid not in _RINGS:
        if rid == 0:
            return dist.group.WORLD
        raise ValueError(f"ring_id {rid} has no process group: create it "
                         "with paddle_tpu_torch.distributed.new_group")
    g = _RINGS[rid]
    if g is None or g == dist.GroupMember.NON_GROUP_MEMBER:
        return None
    return g


def bound_group(ring_id):
    """The process group bound to `ring_id`, or None off a process group
    and where the ring is unregistered or bound to None: an op that
    degrades to its one-device form off a ring (ring attention, switch
    MoE) asks this, not `ring_group`, which refuses an unknown ring."""
    dist = _dist()
    if not dist.is_available() or not dist.is_initialized() or \
            int(ring_id) not in _RINGS:
        return None
    return ring_group(ring_id)


def world_of(group) -> int:
    return 1 if group is None else _dist().get_world_size(group)


def rank_of(group) -> int:
    return 0 if group is None else _dist().get_rank(group)


def _gloo(group) -> bool:
    return _dist().get_backend(group) == "gloo"


class _Comm:
    """Count (and with time_collectives, time) one collective."""

    def __init__(self, t, kind):
        self.t, self.kind = t, kind

    def __enter__(self):
        COMM_STATS["calls"] += 1
        by_kind = COMM_STATS["calls_by_kind"]
        by_kind[self.kind] = by_kind.get(self.kind, 0) + 1
        COMM_STATS["bytes"] += self.t.numel() * self.t.element_size()
        if _TIMING["on"]:
            if self.t.is_cuda:
                torch.cuda.synchronize(self.t.device)
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if _TIMING["on"]:
            if self.t.is_cuda:
                torch.cuda.synchronize(self.t.device)
            COMM_STATS["seconds"] += time.perf_counter() - self.t0


def _red_op(op: str):
    R = _dist().ReduceOp
    return {"sum": R.SUM, "max": R.MAX, "min": R.MIN,
            "prod": R.PRODUCT}[op]


def all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """A new tensor holding `op` of `x` over the group."""
    out = x.clone(memory_format=torch.contiguous_format)
    if group is None:
        return out
    with _Comm(out, "all_reduce"):
        _dist().all_reduce(out, op=_red_op(op), group=group)
    return out


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `x` concatenated along dim 0 in rank order (a 0-d
    `x` is stacked to [W]).  Under gloo a CUDA tensor is gathered through
    a host copy."""
    x = x.reshape(1) if x.dim() == 0 else x.contiguous()
    if group is None:
        return x.clone()
    dist, w = _dist(), world_of(group)
    with _Comm(x, "all_gather"):
        if _gloo(group):
            src = x.cpu() if x.is_cuda else x
            parts = [torch.empty_like(src) for _ in range(w)]
            dist.all_gather(parts, src, group=group)
            return torch.cat(parts).to(x.device)
        out = x.new_empty((w * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
    return out


def broadcast(x: torch.Tensor, root: int, group) -> torch.Tensor:
    """A new tensor holding the group rank `root`'s `x`."""
    out = x.clone(memory_format=torch.contiguous_format)
    if group is None:
        return out
    dist = _dist()
    with _Comm(out, "broadcast"):
        dist.broadcast(out, src=dist.get_global_rank(group, int(root)),
                       group=group)
    return out


def _row_chunk(x, w, r):
    if x.shape[0] % w:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not divide by "
                         f"the group's {w} ranks")
    n = x.shape[0] // w
    return x.narrow(0, r * n, n).clone()


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of `x`, this rank's dim-0 slice.  Under gloo
    an allreduce and a `narrow`; NCCL's native reduce-scatter."""
    if group is None:
        return x.clone()
    w, r = world_of(group), rank_of(group)
    if _gloo(group):
        return _row_chunk(all_reduce(x, "sum", group), w, r)
    x = x.contiguous()
    if x.shape[0] % w:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not divide by "
                         f"the group's {w} ranks")
    out = x.new_empty((x.shape[0] // w,) + tuple(x.shape[1:]))
    with _Comm(x, "reduce_scatter"):
        _dist().reduce_scatter_tensor(out, x, group=group)
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Dim 0 cut in W chunks; chunk j goes to rank j, and the result holds
    every rank's chunk for this rank in rank order.  Under gloo an
    all-gather and a `narrow`; NCCL's native all-to-all."""
    if group is None:
        return x.clone()
    w, r = world_of(group), rank_of(group)
    if x.shape[0] % w:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not divide by "
                         f"the group's {w} ranks")
    if _gloo(group):
        g = gather_rows(x, group)
        c = x.shape[0] // w
        return g.reshape((w, w, c) + tuple(x.shape[1:]))[:, r] \
            .reshape(x.shape).clone()
    x = x.contiguous()
    out = torch.empty_like(x)
    with _Comm(x, "all_to_all"):
        _dist().all_to_all_single(out, x, group=group)
    return out


def _gather_sparse(x, group):
    """All-gather a SelectedRows' rows and values (ranks may hold
    different numbers of rows: each is padded to the largest)."""
    from ...core.selected_rows import SelectedRows
    n = torch.tensor([x.rows.shape[0]], dtype=torch.int64,
                     device=x.rows.device)
    counts = gather_rows(n, group).tolist()
    top = max(counts)

    def pad(t):
        if t.shape[0] == top:
            return t
        fill = t.new_zeros((top - t.shape[0],) + tuple(t.shape[1:]))
        return torch.cat([t, fill])
    rows = gather_rows(pad(x.rows), group)
    vals = gather_rows(pad(x.values), group)
    keep = torch.cat([torch.arange(c, device=rows.device) + i * top
                      for i, c in enumerate(counts)])
    return SelectedRows(rows[keep], vals[keep], x.height)


def _c_allreduce(name, op):
    @register_op(name, inputs=["X"], outputs=["Out"], grad="auto",
                 side_effect=True)
    def kernel(ins, attrs, ctx, _op=op, _name=name):
        from ...core.selected_rows import SelectedRows
        x = ins["X"]
        group = ring_group(attrs.get("ring_id", 0))
        if group is None:
            return {"Out": x}
        _count_op(_name)
        if isinstance(x, SelectedRows):
            if _op != "sum":
                raise NotImplementedError(
                    f"{_op} allreduce over SelectedRows")
            return {"Out": _gather_sparse(x, group)}
        return {"Out": all_reduce(x, _op, group)}
    return kernel


_c_allreduce("c_allreduce_sum", "sum")
_c_allreduce("c_allreduce_max", "max")
_c_allreduce("c_allreduce_min", "min")
_c_allreduce("c_allreduce_prod", "prod")
_c_allreduce("allreduce", "sum")  # legacy distributed_ops/allreduce_op
_c_allreduce("c_reduce_sum", "sum")   # reduce to root as an allreduce:
_c_allreduce("c_reduce_max", "max")   # the root's value is the same
_c_allreduce("c_reduce_min", "min")
_c_allreduce("c_reduce_prod", "prod")


@register_op("c_broadcast", inputs=["X"], outputs=["Out"], side_effect=True)
def c_broadcast(ins, attrs, ctx):
    x = ins["X"]
    group = ring_group(attrs.get("ring_id", 0))
    if group is None:
        return {"Out": x}
    return {"Out": broadcast(x, attrs.get("root", 0), group)}


@register_op("broadcast", inputs=["X"], outputs=["Out"], side_effect=True)
def broadcast_legacy(ins, attrs, ctx):
    return c_broadcast(ins, attrs, ctx)


@register_op("c_allgather", inputs=["X"], outputs=["Out"], side_effect=True)
def c_allgather(ins, attrs, ctx):
    x = ins["X"]
    group = ring_group(attrs.get("ring_id", 0))
    if group is None:
        return {"Out": x}
    _count_op("c_allgather")
    return {"Out": gather_rows(x, group)}


@register_op("c_reducescatter", inputs=["X"], outputs=["Out"],
             side_effect=True)
def c_reducescatter(ins, attrs, ctx):
    x = ins["X"]
    group = ring_group(attrs.get("ring_id", 0))
    if group is None:
        return {"Out": x}
    _count_op("c_reducescatter")
    return {"Out": reduce_scatter(x, group)}


@register_op("c_scatter", inputs=["X"], outputs=["Out"], side_effect=True)
def c_scatter(ins, attrs, ctx):
    """Root's buffer (other ranks may hand in anything of its shape),
    this rank's dim-0 slice of it."""
    x = ins["X"]
    group = ring_group(attrs.get("ring_id", 0))
    if group is None:
        return {"Out": x}
    full = broadcast(x, attrs.get("root", 0), group)
    return {"Out": _row_chunk(full, world_of(group), rank_of(group))}


@register_op("alltoall", inputs=["X"], outputs=["Out"], side_effect=True)
def alltoall(ins, attrs, ctx):
    x = ins["X"]
    group = ring_group(attrs.get("ring_id", 0))
    if group is None:
        return {"Out": x}
    return {"Out": all_to_all(x, group)}


@register_op("barrier", inputs=["X?"], outputs=["Out?"], grad=None,
             side_effect=True)
def barrier(ins, attrs, ctx):
    """x + 0 x allreduce(1): every rank must reach it, and it stays a
    device op (a captured NCCL step can hold it)."""
    x = ins.get("X")
    if x is None:
        x = torch.zeros((1,), dtype=torch.float32, device=ctx.device)
    group = ring_group(attrs.get("ring_id", 0))
    if group is None:
        return {"Out": x}
    one = all_reduce(torch.ones((), dtype=x.dtype, device=x.device), "sum",
                     group)
    return {"Out": x + 0 * one}


@register_op("scale_by_world_size", inputs=["X"], outputs=["Out"], grad=None,
             side_effect=True)
def scale_by_world_size(ins, attrs, ctx):
    """Divide by the group's size (the gradient average after
    c_allreduce_sum), by a 0-d tensor on the device: a true division, as
    XLA's, and a fill a captured step can hold."""
    from ...core.selected_rows import SelectedRows
    x = ins["X"]
    group = ring_group(attrs.get("ring_id", 0))
    if group is None:
        return {"Out": x}
    w = world_of(group)
    if isinstance(x, SelectedRows):
        v = x.values
        return {"Out": SelectedRows(
            x.rows, v / torch.full((), w, dtype=v.dtype, device=v.device),
            x.height)}
    return {"Out": x / torch.full((), w, dtype=x.dtype, device=x.device)}


def _identity(name, ins_spec, outs_spec):
    @register_op(name, inputs=ins_spec, outputs=outs_spec, grad=None,
                 side_effect=True)
    def kernel(ins, attrs, ctx):
        x = ins.get("X")
        return {"Out": x} if x is not None else {}
    return kernel


# torch.distributed orders collectives on the streams and forms its
# communicators at init_process_group: nothing to sync or initialise
_identity("c_sync_calc_stream", ["X"], ["Out"])
_identity("c_sync_comm_stream", ["X"], ["Out"])
_identity("c_wait_comm", ["X"], ["Out"])
_identity("c_wait_compute", ["X"], ["Out"])
_identity("c_comm_init", ["X?"], [])
_identity("c_comm_init_all", [], [])
_identity("c_gen_nccl_id", [], ["Out?"])


def _tp_group(attrs, x):
    """The ring's group, or None (the op is then the identity).  Shape
    inference runs the kernels on meta tensors, which never communicate."""
    if x.device.type == "meta":
        return None
    return ring_group(attrs.get("ring_id", 0))


def _mp_allreduce_grad(ins, attrs, ctx):
    """The Megatron g-operator's backward: identity (the forward's sum
    leaves a replicated cotangent, and each shard's input contributed
    once)."""
    return {"X@GRAD": ins["Out@GRAD"]}


@register_op("mp_allreduce_sum", inputs=["X"], outputs=["Out"],
             grad=_mp_allreduce_grad, side_effect=True)
def mp_allreduce_sum(ins, attrs, ctx):
    """Sum of the partial products over the ring, identity backward."""
    x = ins["X"]
    group = _tp_group(attrs, x)
    if group is None:
        return {"Out": x}
    _count_op("mp_allreduce_sum")
    return {"Out": all_reduce(x, "sum", group)}


def _c_identity_grad(ins, attrs, ctx):
    """The Megatron f-operator's backward: the sum over the ring."""
    g = ins["Out@GRAD"]
    group = _tp_group(attrs, g)
    if group is None:
        return {"X@GRAD": g}
    _count_op("c_identity_grad")
    return {"X@GRAD": all_reduce(g, "sum", group)}


@register_op("c_identity", inputs=["X"], outputs=["Out"],
             grad=_c_identity_grad, side_effect=True)
def c_identity(ins, attrs, ctx):
    return {"Out": ins["X"]}


def _last_chunk(x, w, r):
    n = x.shape[-1] // w
    return x.narrow(x.dim() - 1, r * n, n)


@register_op("c_split", inputs=["X"], outputs=["Out"], side_effect=True)
def c_split(ins, attrs, ctx):
    """This rank's slice of the last axis (no communication; its derived
    gradient places the cotangent in that slice, zeros elsewhere, as the
    JAX package's derived gradient of its slice does)."""
    x = ins["X"]
    group = _tp_group(attrs, x)
    if group is None:
        return {"Out": x}
    return {"Out": _last_chunk(x, world_of(group), rank_of(group))}


def _gather_last(x, group):
    """Every rank's `x` concatenated along the last axis in rank order."""
    w = world_of(group)
    g = gather_rows(x.movedim(-1, 0), group)
    n = x.shape[-1]
    return torch.cat([g[i * n:(i + 1) * n] for i in range(w)]) \
        .movedim(0, -1).contiguous()


def _c_concat_grad(ins, attrs, ctx):
    """The transpose of the gather: this rank's last-axis slice of the
    cotangent summed over the ring (the JAX package's derived gradient of
    all_gather, a reduce-scatter)."""
    g = ins["Out@GRAD"]
    group = _tp_group(attrs, g)
    if group is None:
        return {"X@GRAD": g}
    _count_op("c_concat_grad")
    s = all_reduce(g, "sum", group)
    return {"X@GRAD": _last_chunk(s, world_of(group), rank_of(group))
            .contiguous()}


@register_op("c_concat", inputs=["X"], outputs=["Out"],
             grad=_c_concat_grad, side_effect=True)
def c_concat(ins, attrs, ctx):
    """The all-gather along the last axis (tensor-parallel output)."""
    x = ins["X"]
    group = _tp_group(attrs, x)
    if group is None:
        return {"Out": x}
    _count_op("c_concat")
    return {"Out": _gather_last(x, group)}


def _embedding_rows(w, ids, attrs):
    start = attrs.get("start_index", 0)
    local = ids.long() - start
    valid = (local >= 0) & (local < w.shape[0])
    return local.clamp(0, w.shape[0] - 1), valid


def _c_embedding_grad(ins, attrs, ctx):
    """Rows of this shard get the cotangent summed over the ring (the
    derived gradient of the JAX op, whose sum transposes to a sum)."""
    w, ids, g = ins["W"], ins["Ids"], ins["Out@GRAD"]
    group = _tp_group(attrs, g)
    if group is not None:
        _count_op("c_embedding_grad")
        g = all_reduce(g, "sum", group)
    rows, valid = _embedding_rows(w, ids, attrs)
    g = torch.where(valid[..., None], g, torch.zeros_like(g))
    dw = torch.zeros(w.shape, dtype=g.dtype, device=g.device)
    dw.index_add_(0, rows.reshape(-1), g.reshape(-1, w.shape[1]))
    return {"W@GRAD": dw.to(w.dtype)}


@register_op("c_embedding", inputs=["W", "Ids!"], outputs=["Out"],
             grad=_c_embedding_grad, side_effect=True)
def c_embedding(ins, attrs, ctx):
    """A vocabulary-sharded lookup: rows [start_index, start_index + n)
    live on this rank, ids outside give zeros, and the ring sums the
    ranks' lookups."""
    w, ids = ins["W"], ins["Ids"]
    rows, valid = _embedding_rows(w, ids, attrs)
    out = w[rows]
    out = torch.where(valid[..., None], out, torch.zeros_like(out))
    group = _tp_group(attrs, out)
    if group is not None:
        _count_op("c_embedding")
        out = all_reduce(out, "sum", group)
    return {"Out": out}


def _later(name, ins_spec, outs_spec):
    @register_op(name, inputs=ins_spec, outputs=outs_spec, grad=None,
                 side_effect=True)
    def kernel(ins, attrs, ctx, _name=name):
        raise NotImplementedError(
            f"op {_name!r} (point-to-point or elastic) is not ported yet "
            f"({_LATER})")
    return kernel


for _name, _ins, _outs in (
        ("p_send", ["X"], ["Out?"]),
        ("p_recv", ["X"], ["Out"]),
        ("partial_allgather", ["X"], ["Out"]),
        ("elastic_commit_mask", ["X"], ["Out"]),
        ("c_elastic_fold", ["X", "Acc"], ["Out"])):
    _later(_name, _ins, _outs)
