"""Operator registry & kernel dispatch (forward ops).

Counterpart of paddle_tpu/ops/registry.py.  A kernel is a plain function
`kernel(ins, attrs, ctx) -> {slot: tensor}` over torch tensors; the
executor calls it eagerly on the executor's device.  Slot declarations use
the same string spec ("X*" duplicable, "X?" optional, "X!" no-grad), so
op descriptions read the same in both packages.

Gradient ops are auto-derived as in the JAX package: registering `foo`
with grad="auto" also registers `foo_grad`, whose kernel is
`torch.func.vjp` of the forward kernel (the JAX package uses `jax.vjp`),
and one level of grad-of-grad (`foo_grad_grad`).  The grad kernel REPLAYS
the forward to get its vjp.  Inside the JAX package's whole-block jit,
XLA CSE merges the replay with the original forward; the eager port has
no such merge, so each grad op runs its forward a second time (PERF.md
records the cost).  Ops whose kernel is a hand-written CUDA kernel wrap it
in a `torch.autograd.Function`, so the vjp reaches their backward kernels.

RNG: a random draw is keyed by (the step seed, or the op's `seed` attr
when it sets `fix_seed` (dropout) or is not 0 (the initializers), and the
op's build-time uid), as the JAX package's threefry
`fold_in(PRNGKey(seed), uid)` is.  `OpContext.draw_key(attrs)` gives the
pair; the step seed is `OpContext.seed_tensor`, a one-element int64
tensor on the executor's device that a captured CUDA graph reads afresh
on every replay.  Every draw (dropout, `uniform_random`,
`gaussian_random`, dpsgd's noise) runs on one Philox-4x32-10 generator
(ops/dropout.py, ops/random.py) whose kernels read that seed through a
pointer.  None of it draws the JAX package's numbers, so parity tests
copy parameters, or inject the port's draws into the reference.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

__all__ = ["OpInfo", "register_op", "get_op_info", "all_ops", "OpContext",
           "Slot", "run_kernel"]


class Slot:
    """Input/output slot declaration."""

    def __init__(self, name: str, duplicable: bool = False,
                 optional: bool = False, no_grad: bool = False):
        self.name = name
        self.duplicable = duplicable
        self.optional = optional
        self.no_grad = no_grad

    @staticmethod
    def parse(spec) -> "Slot":
        if isinstance(spec, Slot):
            return spec
        # string spec: "X", "X*" (duplicable), "X?" (optional), "X!" (no_grad)
        name = spec
        dup = opt = ng = False
        while name and name[-1] in "*?!":
            c, name = name[-1], name[:-1]
            dup |= c == "*"
            opt |= c == "?"
            ng |= c == "!"
        return Slot(name, dup, opt, ng)


class OpContext:
    """Per-execution context handed to kernels: the step seed (a host
    integer and, for kernels that read it on the device, `seed_tensor`),
    the test-mode flag and the device that ops without tensor inputs
    (fill_constant, the random initializers) create their outputs on.

    `seed_tensor` is the one-element int64 tensor given (the seed buffer of
    a captured step), else one made from `seed` on `device` at first use."""

    def __init__(self, seed: int = 0, is_test: bool = False,
                 device=None, seed_tensor: Optional[torch.Tensor] = None):
        self.seed = int(seed)
        self.is_test = is_test
        self.device = torch.device("cpu") if device is None \
            else torch.device(device)
        self._seed_tensor = seed_tensor
        # the Program being run: where the sub-block ops (while, cond)
        # find their blocks; the executor sets it
        self.program = None

    @property
    def seed_tensor(self) -> torch.Tensor:
        if self._seed_tensor is None:
            self._seed_tensor = torch.tensor([self.seed], dtype=torch.int64,
                                             device=self.device)
        return self._seed_tensor

    def draw_key(self, attrs: Dict[str, Any], seed_input=None):
        """(seed, uid) of a draw: the `Seed` input tensor when the op has
        one, else the op's `seed` attr (a host int) when it sets
        `fix_seed` (dropout) or is not 0 (the initializers, dpsgd), else
        the step's `seed_tensor`; uid is the op's `fwd_uid` or `op_uid`."""
        uid = int(attrs.get("fwd_uid", attrs.get("op_uid", 0)))
        if seed_input is not None:
            return seed_input.reshape(1).to(torch.int64), uid
        seed = int(attrs.get("seed", 0) or 0)
        if attrs.get("fix_seed", False) or seed:
            return seed, uid
        return self.seed_tensor, uid


class OpInfo:
    def __init__(self, type: str, kernel: Callable,
                 inputs: Sequence, outputs: Sequence,
                 grad: Optional[Any] = "auto",
                 side_effect: bool = False,
                 infer_shape: Optional[Callable] = None):
        self.type = type
        self.kernel = kernel
        self.inputs: List[Slot] = [Slot.parse(s) for s in inputs]
        self.outputs: List[Slot] = [Slot.parse(s) for s in outputs]
        self.grad = grad
        self.side_effect = side_effect
        self.infer_shape = infer_shape

    @property
    def has_grad(self):
        return self.grad is not None

    def grad_op_type(self):
        return self.type + "_grad"


_REGISTRY: Dict[str, OpInfo] = {}


def get_op_info(type: str) -> Optional[OpInfo]:
    return _REGISTRY.get(type)


def run_kernel(op_type: str, ins: Dict[str, Any], attrs: Dict[str, Any],
               ctx: OpContext) -> Dict[str, Any]:
    """Run one registered kernel directly (the host-side decode loops'
    entry, as paddle_tpu.ops.registry.run_kernel)."""
    info = get_op_info(op_type)
    if info is None:
        raise NotImplementedError(f"no kernel registered for op {op_type!r}")
    return info.kernel(ins, attrs, ctx)


def all_ops() -> List[str]:
    return sorted(_REGISTRY)


def register_op(type: str, inputs: Sequence, outputs: Sequence,
                grad: Any = "auto", side_effect: bool = False,
                infer_shape: Optional[Callable] = None):
    """Decorator: register a forward kernel.

    grad: "auto"  -> derive `<type>_grad` via torch.func.vjp of this kernel
          None    -> op is non-differentiable
          callable-> explicit grad kernel(ins, attrs, ctx) following the
                     slot convention below."""

    def deco(fn):
        info = OpInfo(type, fn, inputs, outputs, grad, side_effect,
                      infer_shape)
        _REGISTRY[type] = info
        if grad is not None:
            _register_grad(info)
        return fn

    return deco


# ---------------------------------------------------------------------------
# auto-generated gradient ops (paddle_tpu/ops/registry.py:168-302)
# ---------------------------------------------------------------------------
# Grad op slot convention (the JAX package's, the reference's default
# GradOpMaker):
#   inputs : every forward input slot (same names), every forward output
#            slot, and "<out>@GRAD" for every forward output slot
#   outputs: "<in>@GRAD" for every forward input slot with no_grad=False
# `depth` registers grads-of-grads one level deep (foo_grad_grad).
def _register_grad(fwd: OpInfo, depth: int = 1):
    gtype = fwd.grad_op_type()
    g_inputs = ([Slot(s.name, s.duplicable, True, s.no_grad)
                 for s in fwd.inputs]
                + [Slot(s.name, s.duplicable, True, s.no_grad)
                   for s in fwd.outputs]
                + [Slot(s.name + "@GRAD", s.duplicable, True, s.no_grad)
                   for s in fwd.outputs])
    g_outputs = [Slot(s.name + "@GRAD", s.duplicable, True)
                 for s in fwd.inputs if not s.no_grad]
    kernel = fwd.grad if callable(fwd.grad) else _make_vjp_grad_kernel(fwd)
    ginfo = OpInfo(gtype, kernel, g_inputs, g_outputs,
                   grad=("auto" if depth > 0 else None),
                   infer_shape=_grad_infer_shape(fwd))
    _REGISTRY[gtype] = ginfo
    if depth > 0:
        _register_grad(ginfo, depth=depth - 1)


def _is_diff(x):
    return isinstance(x, torch.Tensor) and (x.is_floating_point()
                                            or x.is_complex())


def _grad_infer_shape(fwd: OpInfo):
    """Build-time shapes of a grad op: "<in>@GRAD" has the shape and dtype
    of the floating forward input <in> (what the JAX package's
    jax.eval_shape of the vjp gives), without replaying the forward.

    A tensor-parallel builder's op (stamped ``mp_axis``) may pair a local
    shard with a global declared shape (a row-parallel product of the
    local per-head context and the global weight); there the JAX
    package's eval of the replay fails and leaves the shapes unset, so
    the forward is tried on the meta inputs first and a failure sets
    none here too."""

    def infer(ins, attrs):
        if attrs.get("mp_axis") is not None:
            fwd_ins = {s.name: ins.get(s.name) for s in fwd.inputs}
            try:
                if fwd.infer_shape is not None:
                    fwd.infer_shape(fwd_ins, attrs)
                else:
                    fwd.kernel(fwd_ins, attrs, OpContext(seed=0))
            except Exception:  # noqa: BLE001 — as the eval's failure
                return {}
        outs = {}
        for slot in fwd.inputs:
            v = ins.get(slot.name)
            if slot.no_grad or v is None:
                continue
            if slot.duplicable:
                outs[slot.name + "@GRAD"] = [x if _is_diff(x) else None
                                             for x in v]
            elif _is_diff(v):
                outs[slot.name + "@GRAD"] = v
        return outs

    return infer


def _make_vjp_grad_kernel(fwd: OpInfo):
    """A grad kernel that replays the forward under torch.func.vjp.

    Primals are the floating inputs of slots without no_grad.  Cotangents
    flow only through floating outputs (integer outputs are left out of
    the vjp, as in the JAX package).  An output with no incoming gradient
    is left out of the vjp too: the JAX package feeds it a zero cotangent,
    which adds nothing, and leaving it out spares allocating one (the
    [tokens, vocab] Softmax output of the fused cross-entropy among them).
    """

    def grad_kernel(ins, attrs, ctx):
        fwd_vals = {slot.name: ins.get(slot.name) for slot in fwd.inputs}
        diff = {}
        for slot in fwd.inputs:
            v = fwd_vals[slot.name]
            if slot.no_grad or v is None:
                continue
            if slot.duplicable:
                sel = {str(i): x for i, x in enumerate(v) if _is_diff(x)}
                if sel:
                    diff[slot.name] = sel
            elif _is_diff(v):
                diff[slot.name] = v
        # the output cotangents given to this grad op, keyed like `flat`
        cts = {}
        for slot in fwd.outputs:
            g = ins.get(slot.name + "@GRAD")
            if g is None:
                continue
            if slot.duplicable:
                sel = {str(i): x for i, x in enumerate(g)
                       if x is not None and _is_diff(x)}
                if sel:
                    cts[slot.name] = sel
            elif _is_diff(g):
                cts[slot.name] = g

        attrs2 = dict(attrs)
        attrs2.setdefault("fwd_uid", attrs.get("op_uid", 0))

        def forward(diff_ins):
            merged = dict(fwd_vals)
            for name, v in diff_ins.items():
                if isinstance(v, dict):  # duplicable: realign by position
                    xs = list(fwd_vals[name])
                    for k, x in v.items():
                        xs[int(k)] = x
                    v = xs
                merged[name] = v
            outs = fwd.kernel(merged, attrs2, ctx)
            flat = {}
            for name, ct in cts.items():
                o = outs.get(name)
                if o is None:
                    continue
                if isinstance(ct, dict):
                    sel = {k: o[int(k)] for k in ct if _is_diff(o[int(k)])}
                    if sel:
                        flat[name] = sel
                elif _is_diff(o):
                    flat[name] = o
            return flat

        if not diff:
            return {}
        outs, vjp_fn = torch.func.vjp(forward, diff)
        if outs:
            (din,) = vjp_fn({
                name: ({k: cts[name][k] for k in o} if isinstance(o, dict)
                       else cts[name]) for name, o in outs.items()})
        else:  # no gradient reaches this op's outputs
            din = {n: ({k: torch.zeros_like(x) for k, x in v.items()}
                       if isinstance(v, dict) else torch.zeros_like(v))
                   for n, v in diff.items()}
        result = {}
        for name, g in din.items():
            if isinstance(g, dict):  # duplicable: back to a positional list
                full = [None] * len(fwd_vals[name])
                for k, x in g.items():
                    full[int(k)] = x
                g = full
            result[name + "@GRAD"] = g
        return result

    return grad_kernel

