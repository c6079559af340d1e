"""paddle.distributed's collective API.

Counterpart of paddle_tpu/distributed/collective.py: `broadcast`,
`all_reduce`, `reduce`, `all_gather`, `scatter`, `barrier`,
`all_to_all` / `alltoall`, `send`, `recv`, `wait`, `split`, `ReduceOp`
and the groups (`new_group`, `get_group`).  Each function emits its
`c_*` op when handed a static variable (a VarDesc under program_guard),
and runs the op's kernel at once when handed a torch tensor (the port's
eager tensors), writing the result into the tensor where the reference
works in place.  The kernels (ops/kernels/collective.py) call
torch.distributed; outside an initialised process group the world is 1
and they are identities.

A group is a reference `ring_id`: `new_group(ranks)` makes a
`torch.distributed.new_group` (every rank must call it, in the same
order, as torch requires) and binds the next ring id to it; ring 0 is
the default group.  `send` / `recv` are point-to-point: eagerly
torch.distributed's send and recv, statically the p_send / p_recv ops.
`split` raises, as in the JAX package (the tensor-parallel layers are
distributed/tensor_parallel.py's).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..ops.kernels import collective as _kc
from ..ops.registry import OpContext, run_kernel

__all__ = [
    "ReduceOp", "Group", "broadcast", "all_reduce", "reduce", "all_gather",
    "scatter", "barrier", "all_to_all", "alltoall", "send", "recv",
    "new_group", "get_group", "wait", "split",
]


class ReduceOp:
    """Reduction kinds for all_reduce / reduce."""
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3


_RED_SUFFIX = {ReduceOp.SUM: "sum", ReduceOp.MAX: "max",
               ReduceOp.MIN: "min", ReduceOp.PROD: "prod"}


class Group:
    """A communicator group, the reference's ring_id (its torch.distributed
    group is registered with the collective ops under that id)."""

    def __init__(self, id: int, ranks: Optional[List[int]] = None):
        self.id = id
        self.ranks = ranks
        self.nranks = len(ranks) if ranks else _world_size()

    @property
    def name(self):
        return f"_default_group_{self.id}"

    def __repr__(self):
        return f"Group(id={self.id}, nranks={self.nranks})"


_groups = {0: None}  # ring id -> Group; the default group made lazily


def _world_size() -> int:
    from .parallel import get_world_size
    return get_world_size()


def _default_group() -> Group:
    if _groups[0] is None:
        _groups[0] = Group(0, list(range(_world_size())))
    return _groups[0]


def _reset_groups():
    """Forget every group (a new process group was initialised)."""
    _groups.clear()
    _groups[0] = None
    _kc.clear_rings()


def new_group(ranks=None, backend=None) -> Group:
    """A sub-communicator bound to the next ring id."""
    import torch.distributed as dist
    gid = max(k for k in _groups) + 1
    ranks = list(ranks) if ranks is not None else None
    if dist.is_available() and dist.is_initialized():
        _kc.register_ring(gid, dist.new_group(ranks=ranks, backend=backend))
    g = Group(gid, ranks)
    _groups[gid] = g
    return g


def get_group(gid: int = 0) -> Group:
    if gid == 0:
        return _default_group()
    return _groups[gid]


def _ring_id(group) -> int:
    if group is None:
        return 0
    if isinstance(group, Group):
        return group.id
    return int(group)


def _nranks(group) -> int:
    return _kc.world_of(_kc.ring_group(_ring_id(group)))


def _is_static(tensor) -> bool:
    from ..core.program import VarDesc
    return isinstance(tensor, VarDesc)


def _eager(op_type, tensor, attrs):
    ctx = OpContext(device=tensor.device)
    with torch.no_grad():
        return run_kernel(op_type, {"X": tensor}, attrs, ctx)["Out"]


def _static(op_type, tensor, attrs):
    from ..core.program import OpRole
    from ..static.layer_helper import LayerHelper
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype=tensor.dtype)
    attrs = dict(attrs)
    attrs[OpRole.KEY] = OpRole.Dist
    helper.append_op(op_type, inputs={"X": [tensor]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def _collective(op_type, tensor, group, extra_attrs=None):
    """Static: emit the op and return its output variable.  Eager: run
    it and write the result into `tensor` (returns None)."""
    attrs = {"ring_id": _ring_id(group), "use_calc_stream": True}
    if extra_attrs:
        attrs.update(extra_attrs)
    if _is_static(tensor):
        return _static(op_type, tensor, attrs)
    out = _eager(op_type, tensor, attrs)
    with torch.no_grad():
        tensor.copy_(out)
    return None


def all_reduce(tensor, op=ReduceOp.SUM, group=None, use_calc_stream=True):
    """In-place allreduce across the group."""
    return _collective("c_allreduce_" + _RED_SUFFIX[op], tensor, group)


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, use_calc_stream=True):
    """Reduce to rank `dst` (an allreduce: every rank holds the result)."""
    return _collective("c_reduce_" + _RED_SUFFIX[op], tensor, group,
                       {"root_id": dst})


def broadcast(tensor, src=0, group=None, use_calc_stream=True):
    """Broadcast rank `src`'s tensor to the group."""
    return _collective("c_broadcast", tensor, group, {"root": src})


def _split_rows(t, n):
    shard = t.shape[0] // n
    return [t[i * shard:(i + 1) * shard] for i in range(n)]


def all_gather(tensor_list, tensor, group=None, use_calc_stream=True):
    """Gather each rank's tensor: eagerly, one tensor per rank appended to
    `tensor_list`; statically, the c_allgather output (dim-0
    concatenation) appended and returned."""
    n = _nranks(group)
    attrs = {"ring_id": _ring_id(group), "use_calc_stream": True,
             "nranks": n}
    if _is_static(tensor):
        out = _static("c_allgather", tensor, attrs)
        if tensor_list is not None:
            tensor_list.append(out)
        return out
    out = _eager("c_allgather", tensor, attrs)
    if tensor.dim() == 0:
        tensor_list.extend(list(out))
    else:
        tensor_list.extend(_split_rows(out, n) if n > 1 else [out])
    return None


def scatter(tensor, tensor_list=None, src=0, group=None,
            use_calc_stream=True):
    """Rank `src` scatters `tensor_list`; every rank receives its part in
    `tensor` (other ranks may pass tensor_list=None)."""
    attrs = {"ring_id": _ring_id(group), "root": src,
             "use_calc_stream": True}
    if _is_static(tensor):
        return _static("c_scatter", tensor, attrs)
    n = _nranks(group)
    if tensor_list:
        stacked = torch.cat(list(tensor_list), dim=0)
    else:
        stacked = tensor.new_zeros((n * tensor.shape[0],)
                                   + tuple(tensor.shape[1:]))
    out = _eager("c_scatter", stacked, attrs)
    with torch.no_grad():
        tensor.copy_(out)
    return None


def barrier(group=None):
    """Block until every member of the group arrives (runs at once: the
    port's eager mode is always on)."""
    from ..core.place import default_place
    import torch.distributed as dist
    pg = _kc.ring_group(_ring_id(group))
    if pg is not None and dist.get_backend(pg) == "nccl":
        device = default_place().torch_device()
    else:
        device = torch.device("cpu")
    t = torch.zeros((1,), dtype=torch.float32, device=device)
    _eager("barrier", t, {"ring_id": _ring_id(group)})
    return None


def all_to_all(in_tensor_list, out_tensor_list=None, group=None,
               use_calc_stream=True):
    """All-to-all over the group: the inputs concatenated along dim 0,
    chunk j to rank j."""
    attrs = {"ring_id": _ring_id(group), "use_calc_stream": True}
    if isinstance(in_tensor_list, (list, tuple)):
        if _is_static(in_tensor_list[0]):
            from ..static import layers
            stacked = layers.concat(list(in_tensor_list), axis=0)
        else:
            stacked = torch.cat(list(in_tensor_list), dim=0)
    else:
        stacked = in_tensor_list
    if _is_static(stacked):
        return _static("alltoall", stacked, attrs)
    out = _eager("alltoall", stacked, attrs)
    n = _nranks(group)
    if out_tensor_list is not None:
        out_tensor_list.extend(_split_rows(out, n) if n > 1 else [out])
        return None
    return out


alltoall = all_to_all


def send(tensor, dst=0, group=None, use_calc_stream=True):
    """Point-to-point send to group rank `dst`.  Static: the p_send op (the
    identity; its p_recv moves the data, as in the JAX package).  Eager:
    torch.distributed's send of the tensor (a no-op off a process
    group); returns None."""
    if _is_static(tensor):
        return _static("p_send", tensor, {"ring_id": _ring_id(group),
                                          "use_calc_stream": True,
                                          "peer": dst})
    g = _kc.ring_group(_ring_id(group))
    if g is not None:
        _p2p(tensor, dst, g, send=True)
    return None


def recv(tensor, src=0, group=None, use_calc_stream=True):
    """Point-to-point receive from group rank `src` into `tensor`.  Static:
    the p_recv op (`peer` = src; its output var).  Eager:
    torch.distributed's recv into the tensor (a no-op off a process
    group); returns None."""
    if _is_static(tensor):
        return _static("p_recv", tensor, {"ring_id": _ring_id(group),
                                          "use_calc_stream": True,
                                          "peer": src})
    g = _kc.ring_group(_ring_id(group))
    if g is not None:
        _p2p(tensor, src, g, send=False)
    return None


def _p2p(tensor, peer, group, send):
    """send / recv of `tensor` with group rank `peer` (gloo's CUDA path has
    neither: a host copy)."""
    import torch.distributed as dist
    peer = dist.get_global_rank(group, int(peer))
    host = _kc._gloo(group) and tensor.is_cuda
    buf = tensor.detach().cpu() if host else tensor.detach()
    if not buf.is_contiguous():
        buf = buf.contiguous()
    with _kc._Comm(buf, "send" if send else "recv"):
        if send:
            dist.send(buf, peer, group=group)
        else:
            dist.recv(buf, peer, group=group)
    if not send and buf.data_ptr() != tensor.data_ptr():
        with torch.no_grad():
            tensor.copy_(buf)


def wait(tensor, group=None, use_calc_stream=True):
    """The reference's stream sync: torch.distributed orders collectives
    on the streams, nothing to wait for."""
    return None


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """paddle.distributed.split: refused, as the JAX package refuses it;
    the tensor-parallel layers are distributed/tensor_parallel.py's."""
    raise NotImplementedError(
        "paddle_tpu_torch: use the tensor-parallel layers of "
        "paddle_tpu_torch.distributed.tensor_parallel (mesh axis 'mp') "
        "instead of split()")
