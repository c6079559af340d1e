"""Parameter and inference-model serialization.

Counterpart of paddle_tpu/io/framework_io.py, writing the same files so
that a model directory moves between the two packages in either
direction:

  * per-var file : `<name>.npy` (np.save) for dtypes numpy can express;
                   bf16 as a `<name>.npt` tensor record
                   (core/serialization.py)
  * combined file: np.savez archive keyed by var name (`filename=`)
  * __model__    : JSON {"program": Program.to_dict(), "feed_names",
                   "fetch_names"} (`model_format="json"`, the default),
                   or with `model_format="proto"` the binary container:
                   b"PTIM", a 4-byte little-endian length, that many
                   bytes of JSON {"feed_names", "fetch_names"}, then the
                   framework.proto ProgramDesc bytes
                   (core/serialization.py; needs google.protobuf, imported
                   only then).  `load_inference_model` tells the two
                   apart by the magic.
"""
from __future__ import annotations

import copy
import json
import os
from collections import OrderedDict

import numpy as np
import torch

from ..core.place import Place, resolve_place

__all__ = ["save_vars", "save_params", "save_persistables", "load_vars",
           "load_params", "load_persistables", "save_inference_model",
           "load_inference_model", "load_params_from_numpy",
           "is_persistable"]


def is_persistable(var) -> bool:
    return bool(getattr(var, "persistable", False))


def _is_parameter(var) -> bool:
    return is_persistable(var) and bool(
        getattr(var, "is_parameter", False) or
        getattr(var, "trainable", False))


def _resolve(main_program, predicate, vars):
    from ..core.program import default_main_program
    prog = main_program or default_main_program()
    if vars is None:
        vars = [v for v in prog.list_vars() if predicate(v)]
    return prog, vars


def _scope():
    from ..static.executor import global_scope
    return global_scope()


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    _, vars = _resolve(main_program, predicate or is_persistable, vars)
    scope = _scope()
    os.makedirs(dirname, exist_ok=True)
    values = OrderedDict()
    for v in vars:
        val = scope.get(v.name)
        if val is None:
            raise RuntimeError(f"variable {v.name!r} has no value in scope "
                               "(run the startup program first)")
        values[v.name] = torch.as_tensor(val).detach().cpu()
    from ..core.serialization import tensor_to_bytes
    if filename is None:
        for name, val in values.items():
            if val.dtype == torch.bfloat16:
                with open(os.path.join(dirname, name + ".npt"), "wb") as f:
                    f.write(tensor_to_bytes(val))
                stale = os.path.join(dirname, name + ".npy")
            else:
                np.save(os.path.join(dirname, name + ".npy"), val.numpy())
                stale = os.path.join(dirname, name + ".npt")
            if os.path.exists(stale):
                # load prefers .npy: a re-save that switched dtype class
                # must not leave the other extension behind
                os.remove(stale)
    else:
        enc, tags = {}, {}
        for name, val in values.items():
            if val.dtype == torch.bfloat16:
                enc[name] = val.view(torch.int16).numpy().view(np.uint16)
                tags[name] = "bfloat16"
            else:
                enc[name] = val.numpy()
        if tags:
            enc["__tensor_dtypes__"] = np.frombuffer(
                json.dumps(tags).encode(), dtype=np.uint8)
        with open(os.path.join(dirname, filename), "wb") as f:
            np.savez(f, **enc)


def save_params(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=is_persistable, filename=filename)


def _from_stored(arr: np.ndarray, tag=None) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # torch tensors must own writable memory
        arr = arr.copy()
    if tag == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    from ..core.serialization import tensor_from_bytes
    _, vars = _resolve(main_program, predicate or is_persistable, vars)
    scope = _scope()
    device = executor.device
    src, tags = None, {}
    if filename is not None:
        archive = np.load(os.path.join(dirname, filename))
        src = {k: archive[k] for k in archive.files}
        if "__tensor_dtypes__" in src:
            tags = json.loads(src.pop("__tensor_dtypes__").tobytes())
    for v in vars:
        if src is not None:
            if v.name not in src:
                raise KeyError(f"{v.name!r} missing from {filename}")
            val = _from_stored(src[v.name], tags.get(v.name))
        else:
            p = os.path.join(dirname, v.name + ".npy")
            if os.path.exists(p):
                val = _from_stored(np.load(p))
            else:
                pt = os.path.join(dirname, v.name + ".npt")
                if not os.path.exists(pt):
                    raise FileNotFoundError(p)
                with open(pt, "rb") as f:
                    val = tensor_from_bytes(f.read())
        scope.set(v.name, val.to(device))


def load_params(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=is_persistable, filename=filename)


def load_params_from_numpy(scope, params, place: Place = None,
                           compiled=None):
    """Write parameters into `scope` on `place` (default CUDAPlace(0)).

    `params` is a {name: np.ndarray} mapping, or a directory of the
    per-variable `.npy` / `.npt` files that either package's
    `save_persistables` writes.  This is how weights cross from
    paddle_tpu into the port: the two packages' RNGs never draw the same
    numbers, so parity runs copy the reference scope's parameters.

    With `compiled` (a CompiledProgram), the arrays are the GLOBAL ones
    (as the JAX package's scope holds them) and each is cut to this
    rank's shard by the program's placement (a ZeRO bucket to the rank's
    dp slice, a tensor-parallel weight to its tp slice)."""
    from ..core.serialization import tensor_from_bytes
    device = resolve_place(place).torch_device()
    if isinstance(params, (str, os.PathLike)):
        d, loaded = os.fspath(params), {}
        for fn in sorted(os.listdir(d)):
            path = os.path.join(d, fn)
            if fn.endswith(".npy"):
                loaded[fn[:-4]] = _from_stored(np.load(path))
            elif fn.endswith(".npt"):
                with open(path, "rb") as f:
                    loaded.setdefault(fn[:-4], tensor_from_bytes(f.read()))
        params = loaded
    for name, val in params.items():
        t = val if isinstance(val, torch.Tensor) \
            else _from_stored(np.asarray(val))
        if compiled is not None:
            t = compiled.shard_of(name, t)
        scope.set(name, t.to(device))
    return sorted(params)


# ---------------------------------------------------------------------------
# inference model
# ---------------------------------------------------------------------------
def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         program_only=False, model_format="json"):
    from ..core.program import default_main_program, OpRole
    if model_format not in ("json", "proto"):
        raise ValueError(f"save_inference_model: unknown model_format "
                         f"{model_format!r} (json or proto)")
    prog = main_program or default_main_program()
    fetch_names = [t.name if hasattr(t, "name") else str(t)
                   for t in target_vars]
    # strip training-only ops (backward/optimize/lr-sched) before pruning
    fwd = copy.deepcopy(prog)
    blk = fwd.global_block()
    train_roles = (OpRole.Backward, OpRole.Optimize, OpRole.LRSched,
                   OpRole.Optimize | OpRole.LRSched)
    blk.ops = [op for op in blk.ops
               if op.attrs.get(OpRole.KEY, OpRole.Forward) not in train_roles]
    pruned = fwd._prune(fetch_names)
    inference = pruned.clone(for_test=True)
    inference._feed_names = list(feeded_var_names)
    inference._fetch_names = fetch_names
    os.makedirs(dirname, exist_ok=True)
    model_path = os.path.join(dirname, model_filename or "__model__")
    if model_format == "proto":
        header = json.dumps({"feed_names": list(feeded_var_names),
                             "fetch_names": fetch_names}).encode()
        body = inference.serialize_to_string(format="proto")
        with open(model_path, "wb") as f:
            f.write(b"PTIM" + len(header).to_bytes(4, "little") +
                    header + body)
    else:
        payload = {"program": inference.to_dict(),
                   "feed_names": list(feeded_var_names),
                   "fetch_names": fetch_names}
        with open(model_path, "w") as f:
            json.dump(payload, f, sort_keys=True)
    if not program_only:
        save_persistables(executor, dirname, inference,
                          filename=params_filename)
    return fetch_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    from ..core.program import Program
    with open(os.path.join(dirname, model_filename or "__model__"),
              "rb") as f:
        raw = f.read()
    if raw[:4] == b"PTIM":  # the binary container (model_format="proto")
        hlen = int.from_bytes(raw[4:8], "little")
        payload = json.loads(raw[8:8 + hlen].decode())
        prog = Program.parse_from_string(raw[8 + hlen:])
    else:
        payload = json.loads(raw.decode())
        prog = Program.from_dict(payload["program"])
    load_persistables(executor, dirname, prog, filename=params_filename)
    block = prog.global_block()
    fetch_targets = [block.var(n) for n in payload["fetch_names"]]
    return prog, payload["feed_names"], fetch_targets
