"""Control-flow and graph-plumbing ops: the comparisons and logical ops,
`while`, `cond`, `conditional_block`, `select_input`, `print`, `assert`,
`equal_all`, `feed` / `fetch` and `optimization_barrier`.

Counterpart of paddle_tpu/ops/kernels/control.py.  The sub-block ops run
their block through the executor's own op loop
(`static.executor.run_block`, over `ctx.program`, which the executor sets),
as the JAX package's recurse through a BlockTracer.  What differs:

  * `while` and `cond` read their predicate on the host (one device read
    per iteration or branch), where the JAX package lowers them to
    `lax.while_loop` / `lax.scan` / `lax.cond`.  A program holding one is
    therefore never captured in a CUDA graph: `HOST_CONTROL_OPS` joins the
    executor's host-op check, and `Executor.run_steps` runs it one step at
    a time.
  * a bounded `while` (`max_iters` > 0) stops as soon as its condition is
    false.  The JAX package scans all `max_iters` steps with the body
    skipped once the condition drops, so results and gradients are the
    same.  Its gradient `while_grad` (`_while_grad`) replays the loop
    under torch autograd and differentiates the replay, explicitly, rather
    than through the registry's `torch.func.vjp` of a kernel that reads
    its predicate on the host.  An unbounded `while` refuses its gradient
    with the JAX package's message: in a program (`while_grad`) and under
    autograd (a dygraph replay of a recorded program), where its outputs
    raise on backward.
  * `print` prints when the op runs (the JAX package's `jax.debug.print`
    fires when the compiled step runs); `assert` raises AssertionError
    when it runs.
  * `conditional_block` computes its body and merges with
    `where(cond, new, old)`, as in the JAX package (no host read).

`static_rnn` / `dynamic_rnn` wait for the rnn tier (ROADMAP.md Queue 1,
The rest).
"""
from __future__ import annotations

import torch

from ..registry import register_op

__all__ = ["HOST_CONTROL_OPS"]

# ops that read a device value on the host each time they run
HOST_CONTROL_OPS = frozenset(("while", "cond", "print", "assert"))


def _binary(name, fn):
    @register_op(name, inputs=["X!", "Y!"], outputs=["Out"], grad=None)
    def kernel(ins, attrs, ctx):
        return {"Out": fn(ins["X"], ins["Y"])}
    return kernel


less_than = _binary("less_than", torch.lt)
less_equal = _binary("less_equal", torch.le)
greater_than = _binary("greater_than", torch.gt)
greater_equal = _binary("greater_equal", torch.ge)
equal = _binary("equal", torch.eq)
not_equal = _binary("not_equal", torch.ne)
logical_and = _binary("logical_and", torch.logical_and)
logical_or = _binary("logical_or", torch.logical_or)
logical_xor = _binary("logical_xor", torch.logical_xor)


@register_op("logical_not", inputs=["X!"], outputs=["Out"], grad=None)
def logical_not(ins, attrs, ctx):
    return {"Out": torch.logical_not(ins["X"])}


@register_op("equal_all", inputs=["X!", "Y!"], outputs=["Out"], grad=None)
def equal_all(ins, attrs, ctx):
    x, y = ins["X"], ins["Y"]
    if tuple(x.shape) != tuple(y.shape):
        return {"Out": torch.zeros((), dtype=torch.bool, device=x.device)}
    return {"Out": torch.all(torch.eq(x, y))}


@register_op("optimization_barrier", inputs=["X*"], outputs=["Out*"],
             grad=None, side_effect=True)
def optimization_barrier(ins, attrs, ctx):
    """The recompute rewrite routes a replayed segment's inputs through
    this op.  In the JAX package it is `jax.lax.optimization_barrier`, so
    that XLA cannot merge the replay with the original forward inside its
    whole-block jit.  The eager port runs every op as it comes and has no
    such merge, so here it is an identity.  It returns copies, not its
    inputs: an output never aliases a buffer that a captured step
    (`Executor.run_steps`) updates in place."""
    return {"Out": [x.clone() for x in ins["X"]]}


# ---------------------------------------------------------------------------
# sub-block ops
# ---------------------------------------------------------------------------
def _run_block(ctx, block_idx, env):
    from ...static.executor import run_block
    program = getattr(ctx, "program", None)
    if program is None:
        raise RuntimeError(
            "sub-block op executed without a Program on the OpContext — "
            "control-flow ops must run through the executor")
    return run_block(program, block_idx, env, ctx)


def _host_bool(x) -> bool:
    return bool(x.reshape(()).item())


def _env_map(names, vals, op_type):
    """zip names->values, refusing silent misalignment (the executor drops
    inputs missing from the env, which would shift everything after)."""
    if len(names) != len(vals):
        raise ValueError(
            f"{op_type}: expected values for {names}, got {len(vals)} — "
            "some referenced var is missing from the environment")
    return dict(zip(names, vals))


_UNBOUNDED_GRAD = (
    "while is not reverse-differentiable without an iteration "
    "bound: build it as While(cond, max_iters=N) / "
    "layers.while_loop(..., max_iters=N) (lowered to a masked "
    "lax.scan), or use StaticRNN for fixed-length recurrence")


class _RefuseGrad(torch.autograd.Function):
    """Identity on the unbounded loop's outputs whose backward raises the
    JAX package's refusal."""

    @staticmethod
    def forward(ctx, *xs):
        return tuple(x.clone() for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        raise ValueError(_UNBOUNDED_GRAD)


def _while_loop(ins, attrs, ctx):
    """The loop of a `while` op: {carry name: final value}."""
    x_names = attrs["x_names"]
    carry_names = attrs["carry_names"]
    cond_name = attrs["cond_name"]
    env0 = _env_map(x_names, ins["X"], "while")
    # carry inits may live under snapshot names (@PRELOOP, see
    # append_while_op) when the loop is differentiable
    carry_srcs = attrs.get("carry_srcs") or carry_names
    cond_src = (carry_srcs[carry_names.index(cond_name)]
                if cond_name in carry_names else cond_name)
    env0.setdefault(cond_src, ins["Condition"])
    missing = [s for s in carry_srcs if s not in env0 or env0[s] is None]
    if missing:
        raise ValueError(
            f"while: loop-carried vars {missing} have no value before the "
            "loop — assign them first (fluid requires this too)")
    carry = {n: env0[s] for n, s in zip(carry_names, carry_srcs)}
    max_iters = int(attrs.get("max_iters", 0) or 0)
    steps = 0
    while _host_bool(carry[cond_name]):
        if max_iters and steps >= max_iters:
            msg = (f"while(max_iters={max_iters}) truncated: the loop "
                   "condition was still true at the bound — raise "
                   "max_iters")
            if attrs.get("strict_truncation") or attrs.get("strict"):
                raise AssertionError(msg + " (strict_truncation=True)")
            print(f"WARNING: while(max_iters={max_iters}) stopped with its "
                  "condition still true — the loop was truncated; raise "
                  "max_iters")
            break
        e = dict(env0)
        e.update(carry)
        _run_block(ctx, attrs["sub_block"], e)
        carry = {n: e[n] for n in carry_names}
        steps += 1
    return carry


def _while_grad(ins, attrs, ctx):
    """WhileGradOp (while_op.cc:167): X@GRAD of a bounded loop, by
    replaying the loop under torch autograd from the op's inputs and
    differentiating the replay against Out@GRAD.  An unbounded loop
    refuses, as in the JAX package."""
    if int(attrs.get("max_iters", 0) or 0) <= 0:
        raise ValueError(_UNBOUNDED_GRAD)
    xs = ins["X"]
    diff = [i for i, x in enumerate(xs)
            if isinstance(x, torch.Tensor) and x.is_floating_point()]
    with torch.enable_grad():
        leaves = list(xs)
        for i in diff:
            leaves[i] = xs[i].detach().requires_grad_(True)
        carry = _while_loop({"X": leaves, "Condition": ins["Condition"]},
                            attrs, ctx)
        outs, cts = [], []
        for n, g in zip(attrs["carry_names"], ins.get("Out@GRAD") or []):
            o = carry[n]
            if g is None or not o.requires_grad:
                continue
            outs.append(o)
            cts.append(g)
        grads = torch.autograd.grad(outs, [leaves[i] for i in diff], cts,
                                    allow_unused=True) if outs else \
            [None] * len(diff)
    x_grad = [None] * len(xs)
    for i, g in zip(diff, grads):
        x_grad[i] = torch.zeros_like(xs[i]) if g is None else g
    return {"X@GRAD": x_grad}


def _no_shapes(ins, attrs):
    return {}


@register_op("while", inputs=["Condition!", "X*"], outputs=["Out*"],
             grad=_while_grad, side_effect=True, infer_shape=_no_shapes)
def while_op(ins, attrs, ctx):
    """while_op.cc — run the sub-block until the condition var (updated
    by the body) is false; with `max_iters` set, at most that many times
    (module docstring)."""
    carry = _while_loop(ins, attrs, ctx)
    outs = [carry[n] for n in attrs["carry_names"]]
    if int(attrs.get("max_iters", 0) or 0) <= 0 and \
            torch.is_grad_enabled() and any(
                isinstance(x, torch.Tensor) and x.requires_grad
                for x in ins["X"]):
        idx = [i for i, o in enumerate(outs) if o.is_floating_point()]
        refused = _RefuseGrad.apply(*[outs[i] for i in idx])
        for i, o in zip(idx, refused):
            outs[i] = o
    return {"Out": outs}


@register_op("cond", inputs=["Cond!", "Input*"], outputs=["Out*"],
             infer_shape=_no_shapes)
def cond_op(ins, attrs, ctx):
    """Two-branch conditional: the taken branch's block runs (the JAX
    package's `lax.cond`)."""
    env = _env_map(attrs["input_names"], ins["Input"], "cond")
    if attrs.get("cond_name"):
        env.setdefault(attrs["cond_name"], ins["Cond"])
    if _host_bool(ins["Cond"]):
        block, names = attrs["true_block"], attrs["true_outs"]
    else:
        block, names = attrs["false_block"], attrs["false_outs"]
    _run_block(ctx, block, env)
    return {"Out": [env[n] for n in names]}


@register_op("conditional_block", inputs=["Cond!", "Input*"],
             outputs=["Out*"], infer_shape=_no_shapes)
def conditional_block_op(ins, attrs, ctx):
    """Single-branch guarded block (conditional_block_op.cc), used by
    Switch: the body computes unconditionally and where(cond, new, old)
    merges, as in the JAX package."""
    env0 = _env_map(attrs["input_names"], ins["Input"], "conditional_block")
    pred = ins["Cond"].reshape(()).to(torch.bool)
    e = dict(env0)
    _run_block(ctx, attrs["sub_block"], e)
    outs = []
    for n in attrs["out_names"]:
        old = env0.get(n)
        if old is None:
            raise ValueError(
                f"conditional_block writes {n!r} which has no value before "
                "the block — initialize it first")
        outs.append(torch.where(pred, e[n], old))
    return {"Out": outs}


@register_op("select_input", inputs=["X*", "Mask!"], outputs=["Out"])
def select_input(ins, attrs, ctx):
    idx = ins["Mask"].reshape(()).to(torch.int32)
    xs = ins["X"]
    out = xs[0]
    for i in range(1, len(xs)):
        out = torch.where(idx == i, xs[i], out)
    return {"Out": out}


def _print_shape(ins, attrs):
    return {"Out": ins["In"]}


@register_op("print", inputs=["In"], outputs=["Out"], grad=None,
             side_effect=True, infer_shape=_print_shape)
def print_op(ins, attrs, ctx):
    from ...static.executor import as_numpy
    print(attrs.get("message", "") + " " + str(as_numpy(ins["In"])))
    return {"Out": ins["In"]}


@register_op("assert", inputs=["Cond!", "Data*?"], outputs=[], grad=None,
             side_effect=True, infer_shape=_no_shapes)
def assert_op(ins, attrs, ctx):
    """assert_op.cc: raise AssertionError(message) when the condition is
    false."""
    if not bool(torch.all(ins["Cond"]).item()):
        raise AssertionError(attrs.get("message", "Assert failed"))
    return {}


@register_op("feed", inputs=[], outputs=["Out"], grad=None, side_effect=True,
             infer_shape=_no_shapes)
def feed(ins, attrs, ctx):
    raise RuntimeError("feed op is handled by the executor")


@register_op("fetch", inputs=["X"], outputs=["Out"], grad=None,
             side_effect=True)
def fetch(ins, attrs, ctx):
    return {"Out": ins["X"]}


def _grads_leave_shapes_unset():
    """The JAX package's build-time shapes of a sub-block op's gradient
    come from an abstract eval of its vjp, which has no Program to run
    the sub-block in and leaves them unset: so do these."""
    from ..registry import get_op_info
    for op_type in ("while", "cond", "conditional_block"):
        get_op_info(op_type + "_grad").infer_shape = _no_shapes


_grads_leave_shapes_unset()
