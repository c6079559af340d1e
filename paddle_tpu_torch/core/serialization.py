"""Tensor codec: the half of paddle_tpu/core/serialization.py that model
directories and checkpoints need.

`encode_tensor` / `decode_tensor` are the checkpoint shards' payload
codec: a tensor lowers to a numpy-storable view plus a dtype tag, bf16 as
its uint16 bit pattern with the tag "bfloat16" (the JAX package's tags
and views, so the CRC of a payload is the same in both packages).  A bf16
payload decodes as a uint16 view reinterpreted as torch.bfloat16, never
through ml_dtypes, which the GPU machine does not have.

`tensor_to_bytes` / `tensor_from_bytes` write and read the same
self-describing record (magic + length-prefixed JSON header + raw buffer)
as the JAX package, so a bf16 parameter saved by either package (as a
`.npt` file, numpy having no bf16 dtype) loads in the other.  bf16 is
stored as its uint16 bit pattern, bit-exact.

The binary program container (the proto half of
paddle_tpu/core/serialization.py): `program_to_proto` /
`program_from_proto`, `serialize_program` / `deserialize_program` over the
framework.proto `ProgramDesc` messages of core/framework_pb2.py, whose
descriptor is the JAX package's, so the bytes of one package parse in the
other.  Attr values go through a typed oneof with a JSON fallback for
nested structures; loading goes through `Program.from_dict`, the JSON
format's path, op-version upgrades included.  google.protobuf is imported
inside these functions only: the port's other modules, and the GPU
machine, do without it.
"""
from __future__ import annotations

import json

import numpy as np
import torch

__all__ = ["encode_tensor", "decode_tensor", "tensor_to_bytes",
           "tensor_from_bytes", "program_to_proto", "program_from_proto",
           "serialize_program", "deserialize_program"]

_TENSOR_MAGIC = b"PTT1"


def _view(t: torch.Tensor):
    """(numpy view, logical dtype tag) of a CPU tensor."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, a.dtype.name


def encode_tensor(value):
    """(contiguous numpy view, logical dtype tag) of a tensor or an array:
    a bf16 tensor becomes its uint16 bit view tagged "bfloat16", every
    other dtype passes through with its numpy name as the tag.  A CUDA
    tensor is copied to the host first (synchronously)."""
    if isinstance(value, torch.Tensor):
        return _view(value)
    a = np.asarray(value)
    if not a.flags["C_CONTIGUOUS"]:
        # .reshape(a.shape) undoes ascontiguousarray's 0-d -> 1-d promotion
        a = np.ascontiguousarray(a).reshape(a.shape)
    if a.dtype.name == "bfloat16":  # an ml_dtypes array, where one exists
        return a.view(np.uint16), "bfloat16"
    return a, a.dtype.name


def decode_tensor(view, dtype_tag: str) -> torch.Tensor:
    """Inverse of `encode_tensor`: a CPU tensor of the logical dtype,
    bit-exact for bf16 (the uint16 view reinterpreted)."""
    a = np.asarray(view)
    if not a.flags["C_CONTIGUOUS"]:
        a = np.ascontiguousarray(a).reshape(a.shape)
    if dtype_tag == "bfloat16":
        if a.dtype != np.uint16:
            raise ValueError(
                f"bfloat16 payload must be a uint16 view, got {a.dtype}")
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype.name != dtype_tag:
        a = a.astype(np.dtype(dtype_tag))
    return torch.from_numpy(a)


def tensor_to_bytes(t: torch.Tensor) -> bytes:
    view, tag = _view(t)
    header = json.dumps({"dtype": tag, "vdtype": view.dtype.str,
                         "shape": list(view.shape)}).encode()
    return (_TENSOR_MAGIC + len(header).to_bytes(4, "little") + header
            + view.tobytes())


def tensor_from_bytes(data: bytes) -> torch.Tensor:
    if data[:4] != _TENSOR_MAGIC:
        raise ValueError("not a paddle_tpu tensor record (bad magic)")
    hlen = int.from_bytes(data[4:8], "little")
    meta = json.loads(data[8:8 + hlen].decode())
    # .copy(): a bytes-backed frombuffer view is read-only
    view = np.frombuffer(data[8 + hlen:],
                         dtype=np.dtype(meta["vdtype"])).copy()
    expect = int(np.prod(meta["shape"])) if meta["shape"] else 1
    if view.size != expect:
        raise ValueError(
            f"tensor record truncated: {view.size} elements, header "
            f"declares {expect}")
    return decode_tensor(view.reshape(meta["shape"]), meta["dtype"])


# ---------------------------------------------------------------------------
# the binary program container (framework.proto ProgramDesc)
# ---------------------------------------------------------------------------
def _pb():
    from . import framework_pb2
    return framework_pb2


def _set_attr(msg, value: Any) -> None:
    if isinstance(value, bool):
        msg.b = value
    elif isinstance(value, int):
        msg.i = value
    elif isinstance(value, float):
        msg.f = value
    elif isinstance(value, str):
        msg.s = value
    elif isinstance(value, (list, tuple)):
        vals = list(value)
        # homogeneous lists only — mixed types (e.g. [1, 2.5]) take the JSON
        # fallback so the proto format preserves exactly what JSON would
        if not vals:
            msg.strings.SetInParent()  # empty list, element type irrelevant
        elif all(type(v) is bool for v in vals):
            msg.bools.val.extend(vals)
        elif all(type(v) is int for v in vals):
            msg.ints.val.extend(vals)
        elif all(type(v) is float for v in vals):
            msg.floats.val.extend(vals)
        elif all(isinstance(v, str) for v in vals):
            msg.strings.val.extend(vals)
        else:
            msg.json = json.dumps(vals).encode()
    else:
        msg.json = json.dumps(value, default=_np_scalar_item).encode()


def _np_scalar_item(value):
    """json fallback encoder: numpy scalars round-trip as their python
    number; anything else raises LOUDLY (the old default=str silently
    stringified values, so numbers reloaded as strings — diverging from
    the JSON wire format which raises for the same case)."""
    import numpy as _np
    if isinstance(value, _np.generic):
        return value.item()
    raise TypeError(
        f"attr value of type {type(value).__name__!r} is not "
        "proto-serializable")


def _get_attr(msg) -> Any:
    kind = msg.WhichOneof("value")
    if kind == "ints":
        return list(msg.ints.val)
    if kind == "floats":
        return list(msg.floats.val)
    if kind == "strings":
        return list(msg.strings.val)
    if kind == "bools":
        return list(msg.bools.val)
    if kind == "json":
        return json.loads(msg.json.decode())
    if kind is None:
        return None
    return getattr(msg, kind)


def program_to_proto(program):
    """The `ProgramDesc` message of `program`."""
    from .op_version import saved_op_versions
    pb = _pb()
    var_types = {"DENSE_TENSOR": pb.VarDesc.DENSE_TENSOR,
                 "SELECTED_ROWS": pb.VarDesc.SELECTED_ROWS,
                 "READER": pb.VarDesc.READER}
    p = pb.ProgramDesc(version=program._version,
                       random_seed=program.random_seed,
                       role=program._role or "")
    for t, v in saved_op_versions().items():
        p.op_versions[t] = v
    for block in program.blocks:
        b = p.blocks.add(idx=block.idx, parent_idx=block.parent_idx)
        for var in block.vars.values():
            vd = b.vars.add(name=var.name, dtype=var.dtype or "",
                            persistable=var.persistable,
                            stop_gradient=var.stop_gradient,
                            is_parameter=var.is_parameter,
                            trainable=var.trainable,
                            lod_level=var.lod_level,
                            is_data=var.is_data)
            if var.shape is not None:
                vd.has_shape = True
                vd.shape.extend(int(s) for s in var.shape)
            if var.initializer is not None:
                vd.initializer_json = json.dumps(
                    var.initializer, default=str).encode()
            vd.type = var_types.get(
                var.attrs.get("var_type", "DENSE_TENSOR"),
                pb.VarDesc.DENSE_TENSOR)
            da = var.attrs.get("dist_attr")
            if da:
                vd.shard_axis = str(da[0])
                vd.shard_dim = int(da[1])
            if var.attrs.get("accum_of"):
                vd.accum_of = str(var.attrs["accum_of"])
        for op in block.ops:
            od = b.ops.add(type=op.type)
            for slot, names in op.inputs.items():
                od.inputs[slot].names.extend(names)
            for slot, names in op.outputs.items():
                od.outputs[slot].names.extend(names)
            for name, value in sorted(op.attrs.items()):
                _set_attr(od.attrs.add(name=name), value)
    return p


def _proto_to_dict(proto) -> dict:
    """Lower the proto to the to_dict() form; Program.from_dict does the
    actual reconstruction (single shared path with the JSON format)."""
    pb = _pb()
    d = {"version": proto.version, "random_seed": proto.random_seed,
         "op_versions": dict(proto.op_versions), "blocks": []}
    if proto.role:
        d["role"] = proto.role
    for bd in proto.blocks:
        vars_ = []
        for vd in bd.vars:
            v = {"name": vd.name,
                 "shape": list(vd.shape) if vd.has_shape else None,
                 "dtype": vd.dtype or None,
                 "persistable": vd.persistable,
                 "stop_gradient": vd.stop_gradient,
                 "is_parameter": vd.is_parameter,
                 "initializer": (json.loads(vd.initializer_json.decode())
                                 if vd.initializer_json else None),
                 "trainable": vd.trainable,
                 "lod_level": vd.lod_level,
                 "is_data": vd.is_data}
            if vd.type != pb.VarDesc.DENSE_TENSOR:
                v["var_type"] = pb.VarDesc.VarType.Name(vd.type)
            if vd.shard_axis:
                v["dist_attr"] = [vd.shard_axis, vd.shard_dim]
            if vd.accum_of:
                v["accum_of"] = vd.accum_of
            vars_.append(v)
        ops = [{"type": od.type,
                "inputs": {s: list(nl.names)
                           for s, nl in od.inputs.items()},
                "outputs": {s: list(nl.names)
                            for s, nl in od.outputs.items()},
                "attrs": {a.name: _get_attr(a) for a in od.attrs}}
               for od in bd.ops]
        d["blocks"].append({"idx": bd.idx, "parent_idx": bd.parent_idx,
                            "vars": vars_, "ops": ops})
    return d


def program_from_proto(proto):
    from .program import Program
    return Program.from_dict(_proto_to_dict(proto))


def serialize_program(program) -> bytes:
    return program_to_proto(program).SerializeToString()


def deserialize_program(data: bytes):
    return program_from_proto(_pb().ProgramDesc.FromString(data))
