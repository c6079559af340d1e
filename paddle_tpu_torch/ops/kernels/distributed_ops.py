"""The parameter-server graph ops: send / recv / fetch_barrier, the
row-sharded lookup, the named-queue and heter relay ops and the
lookup_sparse_table_* family.

Counterpart of paddle_tpu/ops/kernels/distributed_ops.py (the reference's
distributed_ops: a transpiled trainer program carries its PS traffic as
ops, gradients out through `send`, fresh parameters in through `recv`).
The JAX package reaches the KV plane from inside its jitted step through
an ordered `io_callback`.  The port's executor runs ops eagerly, so each
op here calls the KV client (distributed/ps/kv_server.py) directly: its
tensors go to the host for the wire and come back onto the op's device.
The wire protocol, the placement of names and rows on the servers and
the apply rules are the KV server's, shared with the JAX package.

Because they read tensors on the host and talk to other processes, no
program holding one of `HOST_OPS` can be captured as a CUDA graph:
`Executor.run_steps` runs such a program's steps eagerly, one `run` each
(static/executor.py).

The seven lookup_sparse_table_* ops compute the server-side table updates
(init, read, write, merge, grad split, fused SGD and lazy Adam) over a
table held as an ordinary tensor, with the JAX package's semantics: the
live KV server applies the same math natively.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..registry import register_op

__all__ = ["HOST_OPS", "has_host_ops"]

# ops that read tensors on the host and talk to the KV plane
HOST_OPS = frozenset(("send", "recv", "distributed_lookup_table", "enqueue",
                      "dequeue", "heter_send", "heter_recv"))

_CLIENTS: Dict[Tuple[str, ...], object] = {}


def has_host_ops(program) -> bool:
    """True when a block of `program` holds one of HOST_OPS, a control
    op that reads its predicate on the host (control.HOST_CONTROL_OPS) or
    an op whose output shape depends on the data
    (manip.DYNAMIC_SHAPE_OPS): no CUDA graph holds a host round-trip, and
    a captured shape would be frozen."""
    from .control import HOST_CONTROL_OPS
    from .manip import DYNAMIC_SHAPE_OPS
    return any(op.type in HOST_OPS or op.type in HOST_CONTROL_OPS
               or op.type in DYNAMIC_SHAPE_OPS
               for b in program.blocks for op in b.ops)


def _client(endpoints, trainer_id=None):
    key = tuple(endpoints)
    if key not in _CLIENTS:
        from ...distributed.ps.kv_server import KVClient
        c = KVClient(list(endpoints))
        c.wait_server_ready()
        if trainer_id is None:
            # the launcher's env contract when the program did not carry
            # the id (hand-built programs)
            trainer_id = os.environ.get("PADDLE_TRAINER_ID")
        if trainer_id is not None:
            c.start_heartbeat(int(trainer_id))
        _CLIENTS[key] = c
    return _CLIENTS[key]


def clients():
    """The live KV clients of this process, by endpoint tuple."""
    return dict(_CLIENTS)


def _reset_clients():
    for c in _CLIENTS.values():
        c.close()  # stops the heartbeat thread too
    _CLIENTS.clear()


def _host(t) -> np.ndarray:
    """A tensor as a numpy array on the host (bf16 / fp16 as float32,
    which is what the server stores)."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


def _device_tensor(a, device, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def _dummy(ctx):
    return torch.zeros((1,), dtype=torch.float32, device=ctx.device)


def _meta(shape, dtype=torch.float32):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# build-time shapes (core/infer_shape.py): these kernels talk to servers,
# so they never run on meta tensors
def _dummy_shape(ins, attrs):
    return {"Dummy": _meta((1,)), "Out": _meta((1,))}


def _attr_shapes(ins, attrs):
    from ...core.dtype import torch_dtype
    return {"Out": [_meta(s, torch_dtype(str(np.dtype(d))))
                    for s, d in zip(attrs["shapes"], attrs["dtypes"])]}


def _dequeue_shape(ins, attrs):
    from ...core.dtype import torch_dtype
    return {"Out": _meta(attrs["shape"], torch_dtype(
        str(np.dtype(attrs.get("dtype", "float32")))))}


def _lookup_shape(ins, attrs):
    ids, w = ins["Ids"], ins["W"]
    shape = tuple(ids.shape)
    if len(shape) > 1 and shape[-1] == 1:
        shape = shape[:-1]
    return {"Out": _meta(shape + (w.shape[1],), w.dtype)}


def _lr(ins, attrs):
    lr_in = ins.get("LearningRate")
    if lr_in is not None:
        return float(_host(lr_in).reshape(()))
    return float(attrs.get("lr", 0.01))


@register_op("send", inputs=["X*", "LearningRate?"], outputs=["Dummy?"],
             grad=None, side_effect=True, infer_shape=_dummy_shape)
def send(ins, attrs, ctx):
    """Push gradients (mode grad_sync / grad_async: the server applies
    SGD), initial parameters (mode init: the first writer wins), geo
    deltas (mode delta), or a row-sharded table's rows (init_sparse,
    sparse_grad)."""
    names = list(attrs["send_varnames"])
    endpoints = tuple(attrs["endpoints"])
    mode = attrs.get("mode", "grad_sync")
    trainer_id = attrs.get("trainer_id")
    xs = list(ins["X"] or [])
    lr = _lr(ins, attrs)
    c = _client(endpoints, trainer_id)
    if mode in ("sparse_grad", "init_sparse"):
        _send_sparse(c, names, mode, xs, lr,
                     grad_scale=float(attrs.get("grad_scale", 1.0)),
                     sync=bool(attrs.get("sync", False)),
                     sparse_opt=attrs.get("sparse_opt"))
        return {"Dummy": _dummy(ctx)}
    for n, x in zip(names, xs):
        a = _host(x)
        if mode == "init":
            c.init_param(n, a)
        elif mode == "delta":
            c.push_delta(n, a)
        else:
            c.push_grad(n, a, lr, sync=(mode == "grad_sync"))
    return {"Dummy": _dummy(ctx)}


def _send_sparse(c, names, mode, xs, lr, grad_scale=1.0, sync=False,
                 sparse_opt=None):
    """Row-sharded table traffic: init pushes the whole local table split
    over the servers (and installs the server-resident optimizer that
    sparse_opt = {type, beta1, beta2, epsilon} names); sparse_grad pushes
    the SelectedRows {rows, values} the embedding's backward made.  With
    sync the servers accumulate every live trainer's rows and apply
    their average once."""
    from ...core.selected_rows import SelectedRows
    for n, x in zip(names, xs):
        if mode == "init_sparse":
            c.init_sparse_table(n, _host(x))
            if sparse_opt:
                c.config_sparse_optimizer(
                    n, optimizer=sparse_opt.get("type", "sgd"),
                    beta1=float(sparse_opt.get("beta1", 0.9)),
                    beta2=float(sparse_opt.get("beta2", 0.999)),
                    epsilon=float(sparse_opt.get("epsilon", 1e-8)))
            continue
        if not isinstance(x, SelectedRows):
            # a dense gradient means the SelectedRows path was lost
            # (densified by a pass): dropping it would silently stop the
            # table from training
            raise TypeError(
                "sparse_grad send expects a SelectedRows gradient; got a "
                "dense tensor — build the embedding with is_sparse=True "
                "and keep its gradient un-densified")
        rows, vals = _host(x.rows), _host(x.values)
        if rows.size or sync:
            # sync: even an empty push reaches every shard, so the
            # server-side fanin completes
            c.push_sparse(n, rows, vals, lr, grad_scale=grad_scale,
                          sync=sync)


@register_op("recv", inputs=["Dummy?!"], outputs=["Out*"], grad=None,
             side_effect=True, infer_shape=_attr_shapes)
def recv(ins, attrs, ctx):
    """Pull fresh parameter values; the outputs write the parameters (the
    executor hands persistable outputs back to the scope)."""
    names = list(attrs["recv_varnames"])
    c = _client(tuple(attrs["endpoints"]), attrs.get("trainer_id"))
    dtypes = [np.dtype(d) for d in attrs["dtypes"]]
    shapes = [tuple(s) for s in attrs["shapes"]]
    return {"Out": [_device_tensor(np.asarray(c.pull(n), dtype=d)
                                   .reshape(s), ctx.device)
                    for n, d, s in zip(names, dtypes, shapes)]}


@register_op("distributed_lookup_table", inputs=["Ids!", "W!"],
             outputs=["Out"], grad=None, side_effect=True,
             infer_shape=_lookup_shape)
def distributed_lookup_table(ins, attrs, ctx):
    """An embedding forward whose table lives row-sharded on the servers:
    pull exactly the rows this batch touches.  The local W gives shape and
    dtype only; the gradient stays the ordinary lookup's SelectedRows,
    which the transpiler routes into a sparse `send`.  Padded positions
    (padding_idx) give zero rows and never reach the servers' sharding."""
    ids, w = ins["Ids"], ins["W"]
    c = _client(tuple(attrs["endpoints"]), attrs.get("trainer_id"))
    squeeze = ids.dim() > 1 and ids.shape[-1] == 1
    ids_eff = ids.squeeze(-1) if squeeze else ids
    ids_np = _host(ids_eff).astype(np.int64)
    dim = w.shape[1]
    padding_idx = attrs.get("padding_idx", -1)
    pad_mask = None
    if padding_idx is not None and padding_idx != -1:
        pid = padding_idx if padding_idx >= 0 else w.shape[0] + padding_idx
        pad_mask = ids_np == pid
        ids_np = np.where(pad_mask, 0, ids_np)
    flat = c.pull_sparse(attrs["table_name"], ids_np.reshape(-1)) \
        .astype(np.float32).reshape(ids_np.shape + (dim,))
    if pad_mask is not None:
        flat[pad_mask] = 0.0
    return {"Out": _device_tensor(flat, w.device, w.dtype)}


# ---------------------------------------------------------------------------
# named queues and the heter activation relay (queues on the KV server)
# ---------------------------------------------------------------------------

@register_op("queue_generator", inputs=[], outputs=[], grad=None,
             side_effect=True)
def queue_generator(ins, attrs, ctx):
    """Declares queue names (attrs[names]); a queue comes into being on
    the KV server at its first push, so this op only keeps the
    program's shape."""
    return {}


@register_op("enqueue", inputs=["X"], outputs=["Out?"], grad=None,
             side_effect=True, infer_shape=_dummy_shape)
def enqueue(ins, attrs, ctx):
    _client(tuple(attrs["endpoints"])).q_push(attrs["queue_name"],
                                              _host(ins["X"]))
    return {"Out": _dummy(ctx)}


@register_op("dequeue", inputs=["Dummy?!"], outputs=["Out"], grad=None,
             side_effect=True, infer_shape=_dequeue_shape)
def dequeue(ins, attrs, ctx):
    """Blocking pop; shape and dtype from attrs."""
    arr = _client(tuple(attrs["endpoints"])).q_pop(
        attrs["queue_name"], timeout=float(attrs.get("timeout", 60.0)))
    dtype = np.dtype(attrs.get("dtype", "float32"))
    arr = np.ascontiguousarray(arr, dtype=dtype).reshape(
        tuple(attrs["shape"]))
    return {"Out": _device_tensor(arr, ctx.device)}


@register_op("heter_send", inputs=["X*"], outputs=["Dummy?"], grad=None,
             side_effect=True, infer_shape=_dummy_shape)
def heter_send(ins, attrs, ctx):
    """Heter handoff, sending side: the boundary tensors (the CPU
    section's activations, or the device section's activation
    gradients) onto per-variable KV queues."""
    c = _client(tuple(attrs["endpoints"]))
    channel = attrs.get("channel", "heter")
    for n, x in zip(attrs["send_varnames"], ins["X"] or []):
        c.q_push(f"{channel}/{n}", _host(x))
    return {"Dummy": _dummy(ctx)}


@register_op("heter_recv", inputs=["Dummy?!"], outputs=["Out*"],
             grad=None, side_effect=True, infer_shape=_attr_shapes)
def heter_recv(ins, attrs, ctx):
    """Heter handoff, receiving side: blocking pops of the peer section's
    boundary tensors."""
    c = _client(tuple(attrs["endpoints"]))
    channel = attrs.get("channel", "heter")
    timeout = float(attrs.get("timeout", 60.0))
    outs = []
    for n, s, d in zip(attrs["recv_varnames"], attrs["shapes"],
                       attrs["dtypes"]):
        a = np.ascontiguousarray(c.q_pop(f"{channel}/{n}", timeout=timeout),
                                 dtype=np.dtype(d)).reshape(tuple(s))
        outs.append(_device_tensor(a, ctx.device))
    return {"Out": outs}


# ---------------------------------------------------------------------------
# the large-scale sparse-table op family, over an in-graph table
# ---------------------------------------------------------------------------

def _selected(ins, rows_key, vals_key):
    from ...core.selected_rows import SelectedRows
    g = ins.get("Grad")
    if isinstance(g, SelectedRows):
        return g.rows.long(), g.values
    return ins[rows_key].reshape(-1).long(), ins[vals_key]


def _merge_rows(rows, vals, height):
    """Duplicate row ids summed into a dense [height, ...] delta, and the
    mask of touched rows.  Negative ids (the -1 padding of
    lookup_sparse_table_merge) are left out."""
    valid = rows >= 0
    safe = torch.where(valid, rows, torch.zeros_like(rows))
    vmask = valid.reshape((-1,) + (1,) * (vals.dim() - 1))
    dense = torch.zeros((height,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                        device=vals.device)
    dense = dense.index_put((safe,), torch.where(vmask, vals,
                                                 torch.zeros_like(vals)),
                            accumulate=True)
    touched = torch.zeros((height,), dtype=torch.bool, device=vals.device)
    touched = touched.index_put((safe[valid],),
                                torch.ones((), dtype=torch.bool,
                                           device=vals.device))
    return dense, touched


@register_op("lookup_sparse_table_init", inputs=["W"], outputs=["Out"],
             grad=None)
def lookup_sparse_table_init(ins, attrs, ctx):
    """Zero-initialise the value table."""
    return {"Out": torch.zeros_like(ins["W"])}


@register_op("lookup_sparse_table_read", inputs=["W", "Ids!"],
             outputs=["Out"], grad=None)
def lookup_sparse_table_read(ins, attrs, ctx):
    return {"Out": ins["W"][ins["Ids"].reshape(-1).long()]}


@register_op("lookup_sparse_table_write", inputs=["W", "Ids!", "Value"],
             outputs=["Out"], grad=None)
def lookup_sparse_table_write(ins, attrs, ctx):
    ids = ins["Ids"].reshape(-1).long()
    return {"Out": ins["W"].index_put((ids,), ins["Value"])}


@register_op("lookup_sparse_table_merge", inputs=["Ids!", "Value"],
             outputs=["OutIds", "Out"], grad=None)
def lookup_sparse_table_merge(ins, attrs, ctx):
    """Duplicate row gradients summed, at a fixed shape: the sorted
    unique ids padded with -1, and the values summed into the row of
    their id's position (zeros in the padded rows)."""
    ids = ins["Ids"].reshape(-1).long()
    vals = ins["Value"]
    uids, inv = torch.unique(ids, sorted=True, return_inverse=True)
    n = ids.shape[0]
    out_ids = torch.full((n,), -1, dtype=torch.int32, device=ids.device)
    out_ids[:uids.shape[0]] = uids.to(torch.int32)
    merged = torch.zeros_like(vals).index_put((inv,), vals, accumulate=True)
    return {"OutIds": out_ids, "Out": merged}


@register_op("lookup_sparse_table_grad_split",
             inputs=["Grad?", "Row?!", "Value?"],
             outputs=["Row", "Value"], grad=None)
def lookup_sparse_table_grad_split(ins, attrs, ctx):
    """A SelectedRows gradient split into its (rows, values) wire parts."""
    rows, vals = _selected(ins, "Row", "Value")
    return {"Row": rows.long(), "Value": vals}


@register_op("lookup_sparse_table_fuse_sgd",
             inputs=["Grad?", "Rows?!", "Value?", "Param",
                     "LearningRate!"],
             outputs=["ParamOut"], grad=None, side_effect=True)
def lookup_sparse_table_fuse_sgd(ins, attrs, ctx):
    """Row SGD on the table that rides in ins[Param]."""
    rows, vals = _selected(ins, "Rows", "Value")
    w = ins["Param"]
    lr = ins["LearningRate"].reshape(())
    dense, _ = _merge_rows(rows, vals, w.shape[0])
    return {"ParamOut": w - lr * dense}


@register_op("lookup_sparse_table_fuse_adam",
             inputs=["Grad?", "Rows?!", "Value?", "Param", "Moment1",
                     "Moment2", "Beta1Pow!", "Beta2Pow!",
                     "LearningRate!"],
             outputs=["ParamOut", "Moment1Out", "Moment2Out",
                      "Beta1PowOut", "Beta2PowOut"],
             grad=None, side_effect=True)
def lookup_sparse_table_fuse_adam(ins, attrs, ctx):
    """Lazy sparse Adam: only the touched rows update their moments.  The
    bias correction uses the INPUT beta powers, as the reference and the
    dense adam kernel do (accumulators start at beta1 / beta2)."""
    rows, vals = _selected(ins, "Rows", "Value")
    w = ins["Param"]
    m1, m2 = ins["Moment1"], ins["Moment2"]
    b1p = ins["Beta1Pow"].reshape(())
    b2p = ins["Beta2Pow"].reshape(())
    lr = ins["LearningRate"].reshape(())
    b1 = float(attrs.get("beta1", 0.9))
    b2 = float(attrs.get("beta2", 0.999))
    eps = float(attrs.get("epsilon", 1e-8))
    g, touched = _merge_rows(rows, vals, w.shape[0])
    mask = touched[:, None]
    m1n = torch.where(mask, b1 * m1 + (1 - b1) * g, m1)
    m2n = torch.where(mask, b2 * m2 + (1 - b2) * g * g, m2)
    lr_t = lr * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
    wn = torch.where(mask, w - lr_t * m1n / (torch.sqrt(m2n) + eps), w)
    return {"ParamOut": wn, "Moment1Out": m1n, "Moment2Out": m2n,
            "Beta1PowOut": b1p * b1, "Beta2PowOut": b2p * b2}


@register_op("listen_and_serv", inputs=["X*"], outputs=[], grad=None,
             side_effect=True)
def listen_and_serv(ins, attrs, ctx):
    """The pserver program's marker op: the executor serves the KV store
    for a program carrying `_ps_server_config` before any op runs, so
    reaching this kernel does nothing."""
    return {}


@register_op("fetch_barrier", inputs=["X*!"], outputs=[], grad=None,
             side_effect=True)
def fetch_barrier(ins, attrs, ctx):
    """An ordering marker between send and recv: the eager executor runs
    the ops in program order, so it does nothing (the JAX package's
    ordered io_callback serializes them the same way)."""
    return {}
