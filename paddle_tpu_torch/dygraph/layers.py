"""nn.Layer — the dygraph module base class, as a `torch.nn.Module`.

Counterpart of paddle_tpu/dygraph/layers.py (the reference's
fluid/dygraph/layers.py Layer).  Parameters are `torch.nn.Parameter`s,
so torch autograd, `.to()`, `train()` / `eval()` (which reach every
sublayer) and `parameters()` work as on any module; Paddle's names sit
beside them:

  * `create_parameter(shape, attr, dtype, is_bias, default_initializer)`
    keeps Paddle's shapes (`Linear.weight` is [in, out]) and initializers
    (Xavier for weights, 0 for biases unless the layer says otherwise).
    It runs the SAME initializer op a startup program would append, in a
    throwaway block, on the eager place, with a generator seeded from the
    global seed and a draw counter (core/generator.py).  The parameter
    carries its Paddle name (`paddle_name`, unique_name(layer + ".w")) and
    `need_clip` (the 2.0 optimizers' clip leaves it out when False);
  * `copy.deepcopy` of a layer names each copied parameter
    `<name>_deepcopy_<n>`, as Paddle's ParamBase.__deepcopy__ does (the
    JAX package's copies keep the original names, ROADMAP.md Queue 3);
  * `register_buffer(name, tensor, persistable=True)` keeps a tensor
    (a numpy array is converted, on the eager place) as a torch buffer:
    `.to()` moves it, and a persistable one is in `state_dict`, so
    batch_norm's running stats cross with `set_state_dict` as parameters
    do;
  * `register_forward_pre_hook(hook(layer, inputs))` and
    `register_forward_post_hook(hook(layer, inputs, outputs))` are torch's
    forward pre-hook and forward hook (a non-None return replaces the
    inputs or outputs); `clear_gradients()` drops every gradient;
  * `named_sublayers` / `sublayers` walk breadth-first as the JAX package
    does, and `state_dict()` lists parameters (then persistable buffers)
    under the JAX package's structured names in that same order;
  * `set_state_dict(state)` is the weight-carry function: it takes the
    JAX layer's `state_dict()` (its tensors, numpy arrays or torch
    tensors) and copies each value into the parameter of the same name,
    so both packages compute the same thing.
"""
from __future__ import annotations

import collections
import copy
from typing import Iterator, List, Tuple

import numpy as np
import torch

from ..core.dtype import convert_dtype, torch_dtype
from ..core.generator import global_seed, next_eager_uid
from ..core.program import Program, program_guard, unique_name
from ..ops.registry import OpContext
from ..static.initializer import Constant, XavierInitializer
from ..static.param_attr import ParamAttr

__all__ = ["Layer", "Sequential", "LayerList", "ParameterList",
           "materialize_initializer"]


def materialize_initializer(init, shape, dtype="float32", name=None,
                            device=None) -> torch.Tensor:
    """Run an initializer's op eagerly on `device` and return the value:
    the startup-program path's own kernels, so eager and static init
    draw the same way.  A fresh draw uid per call makes two layers built
    in a row draw different samples."""
    from ..static.executor import _run_op
    prog = Program()
    prog.random_seed = global_seed()
    with program_guard(prog, prog):
        var = prog.global_block().create_var(
            name=name or unique_name("param_init"), shape=list(shape),
            dtype=dtype, persistable=True)
        init(var, prog.global_block())
    env = {}
    ctx = OpContext(seed=global_seed() + next_eager_uid(), device=device)
    for op in prog.global_block().ops:
        _run_op(op, env, ctx)
    return env[var.name]


def _as_array(val):
    """A state_dict value as a CPU tensor: a torch tensor, or anything with
    `.numpy()` (the JAX package's tensors) or that numpy takes."""
    if isinstance(val, torch.Tensor):
        return val.detach()
    if hasattr(val, "numpy"):
        val = val.numpy()
    return torch.from_numpy(np.array(val))


class Layer(torch.nn.Module):
    """Base network module (a torch.nn.Module with Paddle's names)."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = convert_dtype(dtype) if dtype else "float32"
        self._full_name = unique_name(
            name_scope or type(self).__name__.lower())

    def full_name(self):
        return self._full_name

    # -- parameter creation -------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A new parameter of Paddle's `shape`, initialized on the eager
        place; None when `attr` is False (bias_attr=False)."""
        from .base import current_place
        dtype = convert_dtype(dtype or self._dtype)
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        init = (attr.initializer if attr.initializer is not None
                else default_initializer)
        if init is None:
            init = Constant(0.0) if is_bias else XavierInitializer()
        name = attr.name or unique_name(self._full_name + ".w")
        value = materialize_initializer(
            init, shape, dtype, name,
            device=current_place().torch_device())
        p = torch.nn.Parameter(value.to(torch_dtype(dtype)),
                               requires_grad=bool(attr.trainable))
        p.paddle_name = name
        p.need_clip = bool(attr.need_clip)
        return p

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        """Paddle's `register_buffer(name, tensor, persistable)` (torch's
        `persistent` keyword is accepted too); returns the buffer."""
        from .base import current_place
        if persistent is not None:
            persistable = persistent
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = _as_array(tensor).to(current_place().torch_device())
        super().register_buffer(name, tensor, persistent=bool(persistable))
        return tensor

    def __deepcopy__(self, memo):
        """A copy whose parameters keep `need_clip` and take new names
        (`<name>_deepcopy_<n>`; torch's Parameter.__deepcopy__ drops
        attributes)."""
        new = type(self).__new__(type(self))
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            new.__dict__[k] = copy.deepcopy(v, memo)
        for key, p in self._parameters.items():
            q = new._parameters.get(key)
            if p is None or q is None or hasattr(q, "paddle_name"):
                continue
            if hasattr(p, "need_clip"):
                q.need_clip = p.need_clip
            if hasattr(p, "paddle_name"):
                q.paddle_name = p.paddle_name + unique_name("_deepcopy")
        return new

    # -- Paddle's hook and gradient names -----------------------------------
    def register_forward_post_hook(self, hook):
        """hook(layer, inputs, outputs); a non-None return replaces the
        outputs.  Returns a handle with `.remove()`."""
        return self.register_forward_hook(hook)

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    # -- traversal (breadth-first, as the JAX package) ----------------------
    def named_sublayers(self, prefix="", include_self=False
                        ) -> Iterator[Tuple[str, "torch.nn.Module"]]:
        seen = set()
        queue = collections.deque([(prefix, self)])
        first = True
        while queue:
            name, lay = queue.popleft()
            if id(lay) in seen:
                continue
            seen.add(id(lay))
            if include_self or not first:
                yield name, lay
            first = False
            for cname, child in lay._modules.items():
                if child is not None:
                    queue.append((f"{name}.{cname}" if name else cname,
                                  child))

    def sublayers(self, include_self=False) -> List["torch.nn.Module"]:
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    # -- state dict ---------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix=""):
        """{structured name: tensor} of every parameter, then every
        persistable buffer, in the JAX package's breadth-first order."""
        dest = collections.OrderedDict() if destination is None \
            else destination
        layers = list(self.named_sublayers(
            prefix=structured_name_prefix.rstrip("."), include_self=True))
        if not include_sublayers:
            layers = layers[:1]
        seen = set()
        for name, lay in layers:
            for pname, p in lay._parameters.items():
                if p is not None and id(p) not in seen:
                    seen.add(id(p))
                    dest[f"{name}.{pname}" if name else pname] = p
        for name, lay in layers:
            for bname, b in lay._buffers.items():
                if b is not None and \
                        bname not in lay._non_persistent_buffers_set:
                    dest[f"{name}.{bname}" if name else bname] = b
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy every value of `state_dict` into the parameter or buffer of
        the same structured name (cast to its dtype, moved to its device).
        Returns (missing, unexpected) names, as the JAX package."""
        own = self.state_dict()
        missing, unexpected = [], []
        with torch.no_grad():
            for name, t in own.items():
                if name not in state_dict:
                    missing.append(name)
                    continue
                val = _as_array(state_dict[name])
                if tuple(val.shape) != tuple(t.shape):
                    raise ValueError(
                        f"set_state_dict: {name} has shape "
                        f"{tuple(t.shape)}, the value {tuple(val.shape)}")
                t.copy_(val.to(device=t.device, dtype=t.dtype))
        unexpected = [n for n in state_dict if n not in own]
        return missing, unexpected


class Sequential(Layer):
    """nn.Sequential: layers, or (name, layer) pairs, run in order."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], (list, tuple)):
            layers = layers[0]
        for i, l in enumerate(layers):
            if isinstance(l, (list, tuple)):
                self.add_sublayer(str(l[0]), l[1])
            else:
                self.add_sublayer(str(i), l)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def forward(self, x):
        for l in self._modules.values():
            x = l(x)
        return x


class ParameterList(Layer):
    """A list of parameters, registered under "0", "1", ..."""

    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or []):
            self.register_parameter(str(i), p)

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.register_parameter(str(len(self)), parameter)
        return self


class LayerList(Layer):
    """A list of sublayers, registered under "0", "1", ..."""

    def __init__(self, sublayers=None):
        super().__init__()
        for i, l in enumerate(sublayers or []):
            self.add_sublayer(str(i), l)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return list(self._modules.values())[idx]
        n = len(self._modules)
        if not -n <= idx < n:
            raise IndexError(
                f"index {idx} out of range for LayerList of length {n}")
        return self._modules[str(idx % n)]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def extend(self, layers):
        for l in layers:
            self.append(l)
        return self
