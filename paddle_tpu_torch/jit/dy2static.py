"""Dygraph-to-static AST transformation: tensor-dependent `if` / `while`
/ `for` (with `break` / `continue`), `print`, `assert` and `int()` /
`float()` / `bool()` casts, and the `convert_*` runtime the rewritten
code calls.

Counterpart of paddle_tpu/jit/dy2static.py (the reference's
dygraph_to_static/ ifelse, loop, break_continue transformers and
convert_operators.py).  The AST transform is the JAX package's code; the
runtime records through the port's recorder (jit/__init__.py):

  * `convert_ifelse(pred, true_fn, false_fn)`: a Python predicate runs
    one branch; a tensor predicate outside a trace is read on the host;
    a tensor predicate INSIDE a `to_static` trace records both branches
    into fresh sub-blocks and a `cond` op (`_record_cond`), and the
    traced values merge with torch.where.  Python-scalar branch results
    that differ (a break flag) are lifted to fill_constant tensors;
  * `convert_while_loop(test_fn, body_fn, names, init)`: a Python
    condition runs a Python loop (unrolled under tracing); a tensor
    condition inside a trace records the body into a sub-block ending in
    assigns back to the loop-carried vars and a `while` op
    (`_record_while`), and the returned values come from an eager replay
    of the loop, so trace-time values stay exact;
  * `convert_print` / `convert_assert` / `convert_var_dtype` record the
    `print`, `assert` and `cast` ops under a trace.

Converting a tensor-dependent loop runs its body a few times at trace
time (discovery, record, eager replay): Python side effects in the body
may repeat.  Unsupported (the transformer raises, `to_static` falls back
to plain tracing): `return` inside a tensor branch or loop body,
`while` / `for` `else:` clauses.
"""
from __future__ import annotations

import ast
import inspect
import textwrap
from typing import List

import torch
from torch import Tensor

from ..core.dtype import dtype_name, torch_dtype
from ..dygraph import tracer as _tr

__all__ = ["ast_transform", "convert_ifelse", "Undefined", "Dy2StaticError"]


class Dy2StaticError(Exception):
    pass


class _UndefinedVar:
    """Placeholder for a name one branch assigns and the other doesn't
    (reference dygraph_to_static UndefinedVar).  Any use raises."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def _die(self):
        raise NameError(
            f"variable {self.name!r} has no defined value here: it is "
            "assigned only in one branch of a tensor-dependent `if` "
            "(assign it in both branches, or before the `if`) or only "
            "inside a tensor-dependent loop body (assign it before the "
            "loop so it becomes loop-carried)")

    def __getattr__(self, item):
        self._die()

    def __bool__(self):
        self._die()

    def __repr__(self):
        return f"Undefined({self.name})"


Undefined = _UndefinedVar


def _grab(thunk, name):
    """Evaluate a branch output, tolerating it being undefined."""
    try:
        return thunk()
    except NameError:
        return _UndefinedVar(name)


def _to_bool(pred):
    if isinstance(pred, Tensor):  # a tensor read on the host
        return bool(pred.item())
    return bool(pred)  # plain python truthiness, whatever the type


def _new(fn, *args, **kwargs):
    """A tensor made at trace time outside any op (the JAX package's
    `Tensor(...)`): it takes that constructor's eager name, and its torch
    ops are not recorded."""
    if _tr._PROGRAM_RECORDER is not None:
        _tr.eager_name()
    with _tr.quiet():
        return fn(*args, **kwargs)


def _where(pred_raw, tv, fv):
    return _new(torch.where, pred_raw, tv, fv)


def _device(rec):
    from ..dygraph.base import current_place
    return getattr(rec, "device", None) or current_place().torch_device()


def convert_ifelse(pred, true_fn, false_fn, env=()):
    """`env` carries the current values of every name either branch
    assigns (branch functions take them as parameters so Python's
    assignment-makes-local rule can't break read-before-write)."""

    rec = _tr.active_recorder()
    if not isinstance(pred, Tensor) or rec is None:
        return true_fn(*env) if _to_bool(pred) else false_fn(*env)
    return _record_cond(rec, pred, lambda: true_fn(*env),
                        lambda: false_fn(*env))


def _record_cond(rec, pred, true_fn, false_fn):
    from ..core.program import unique_name
    from ..static.control_flow import _analyze_block

    program = rec.program
    parent = rec.block
    pred_name = rec.name_of(pred)

    def run_branch(fn):
        sub = program.create_block(parent_idx=parent.idx)
        program.rollback()
        saved, rec.block = rec.block, sub
        try:
            ret = fn()
        finally:
            rec.block = saved
        return sub, ret

    tb, t_ret = run_branch(true_fn)
    fb, f_ret = run_branch(false_fn)
    t_list = list(t_ret) if isinstance(t_ret, tuple) else [t_ret]
    f_list = list(f_ret) if isinstance(f_ret, tuple) else [f_ret]
    if len(t_list) != len(f_list):
        raise Dy2StaticError(
            f"tensor-if branches return different arity ({len(t_list)} vs "
            f"{len(f_list)})")

    with _tr.quiet():
        pred_raw = pred.reshape(()).to(torch.bool)
    out_tensors, t_outs, f_outs = [], [], []
    for tv, fv in zip(t_list, f_list):
        if isinstance(tv, _UndefinedVar) or isinstance(fv, _UndefinedVar):
            # assigned in one branch only (or neither): the merged value
            # is undefined — any later USE raises NameError with the
            # assign-it-in-both-branches guidance; unused branch-local
            # temporaries (loop helpers, scratch names) stay harmless
            und = tv if isinstance(tv, _UndefinedVar) else fv
            out_tensors.append(und)
            t_outs.append(None)
            f_outs.append(None)
            continue
        if not isinstance(tv, Tensor) or not isinstance(fv, Tensor):
            # python-scalar results that DIFFER (a break/continue flag set
            # True in one branch) get lifted to fill_constant tensors in
            # each sub-block and merged like tensors
            # (break_continue_transformer.py makes the reference's flags
            # real bool variables for the same reason)
            if (not isinstance(tv, Tensor) and not isinstance(fv, Tensor)
                    and isinstance(tv, (bool, int, float))
                    and isinstance(fv, (bool, int, float)) and tv != fv):
                dt = _scalar_dtype(tv, fv)
                tv, tn = _lift_scalar(rec, tb, tv, dtype=dt)
                fv, fn_ = _lift_scalar(rec, fb, fv, dtype=dt)
                merged = _where(pred_raw, tv, fv)
                out_tensors.append(merged)
                t_outs.append(tn)
                f_outs.append(fn_)
                continue
            if isinstance(tv, Tensor) != isinstance(fv, Tensor) and \
                    isinstance(tv if not isinstance(tv, Tensor) else fv,
                               (bool, int, float)):
                # one side tensor, other a python scalar: lift the scalar
                # into its block with the tensor side's shape/dtype
                if isinstance(tv, Tensor):
                    fv, fname = _lift_scalar(rec, fb, fv, like=tv)
                    f_outs_name = fname
                    t_outs_name = rec.name_of(tv)
                else:
                    tv, tname = _lift_scalar(rec, tb, tv, like=fv)
                    t_outs_name = tname
                    f_outs_name = rec.name_of(fv)
                merged = _where(pred_raw, tv, fv)
                out_tensors.append(merged)
                t_outs.append(t_outs_name)
                f_outs.append(f_outs_name)
                continue
            # remaining non-tensor branch results must agree, stay python
            if tv is not fv and tv != fv:
                raise Dy2StaticError(
                    "non-tensor values returned from a tensor-dependent "
                    f"`if` must be equal in both branches, got {tv!r} vs "
                    f"{fv!r}")
            out_tensors.append(tv)
            t_outs.append(None)
            f_outs.append(None)
            continue
        if tuple(tv.shape) != tuple(fv.shape) or tv.dtype != fv.dtype:
            raise Dy2StaticError(
                f"tensor-if branch outputs disagree: {tuple(tv.shape)}/"
                f"{tv.dtype} vs {tuple(fv.shape)}/{fv.dtype}")
        merged = _where(pred_raw, tv, fv)
        out_tensors.append(merged)
        t_outs.append(rec.name_of(tv))
        f_outs.append(rec.name_of(fv))

    # free vars of both branches + branch outputs defined outside them
    t_free, _ = _analyze_block(tb)
    f_free, _ = _analyze_block(fb)
    defined = {n for blk in (tb, fb) for op in blk.ops
               for n in op.output_names()}
    extra_free = [n for n in t_outs + f_outs
                  if n is not None and n not in defined]
    free = [n for n in dict.fromkeys(t_free + f_free + extra_free)
            if n != pred_name]

    out_names = []
    for t, tn in zip(out_tensors, t_outs):
        if tn is None:
            continue
        name = unique_name("dy2st_cond_out")
        parent.create_var(name=name, shape=tuple(t.shape),
                          dtype=dtype_name(t.dtype),
                          stop_gradient=not t.requires_grad)
        rec.register(t, name)
        out_names.append(name)

    parent.append_op(
        "cond",
        inputs={"Cond": [pred_name], "Input": free},
        outputs={"Out": out_names},
        attrs={"true_block": tb.idx, "false_block": fb.idx,
               "input_names": free,
               "true_outs": [n for n in t_outs if n is not None],
               "false_outs": [n for n in f_outs if n is not None],
               "cond_name": pred_name})
    return tuple(out_tensors)


def _scalar_dtype(*vals):
    """fill_constant dtype for lifted python scalars."""
    if all(isinstance(v, bool) for v in vals):
        return "bool"
    if all(isinstance(v, (bool, int)) for v in vals):
        return "int64"
    return "float32"


def _lift_scalar(rec, block, value, dtype=None, like=None):
    """Materialize a python scalar as a fill_constant op inside an
    already-closed sub-block; returns (eager Tensor, var name)."""
    from ..core.program import unique_name
    if like is not None:
        shape, dtype = tuple(like.shape), dtype_name(like.dtype)
    else:
        shape, dtype = (), (dtype or _scalar_dtype(value, value))
    name = unique_name("dy2st_lift")
    block.create_var(name=name, shape=shape, dtype=dtype,
                     stop_gradient=True)
    block.append_op("fill_constant", inputs={}, outputs={"Out": [name]},
                    attrs={"shape": list(shape), "dtype": dtype,
                           "value": value})
    t = _new(torch.full, shape, value, dtype=torch_dtype(dtype),
             device=_device(rec))
    return t, name


# ---------------------------------------------------------------------------
# loop conversion (loop_transformer.py / convert_operators.py analogs)
# ---------------------------------------------------------------------------
def _is_tensor(v):
    return isinstance(v, Tensor)


def convert_logical_and(*operands):
    """Lazy tensor-aware `and` (convert_operators.py convert_logical_and).
    Operands may be values or thunks.  Pure-python operands keep python's
    value semantics (`a and b` returns the deciding operand, lazily);
    tensor operands combine via the logical_and op."""
    vals, last = [], True
    for f in operands:
        v = f() if callable(f) and not _is_tensor(f) else f
        if not _is_tensor(v):
            if not v:
                return v if not vals else False
            last = v
        else:
            vals.append(v)
    if not vals:
        return last
    out = vals[0]
    for v in vals[1:]:
        out = _tr.trace_op("logical_and", {"X": out, "Y": v}, {},
                                ["Out"])
    return out


def convert_logical_or(*operands):
    vals, last = [], False
    for f in operands:
        v = f() if callable(f) and not _is_tensor(f) else f
        if not _is_tensor(v):
            if v:
                return v if not vals else True
            last = v
        else:
            vals.append(v)
    if not vals:
        return last
    out = vals[0]
    for v in vals[1:]:
        out = _tr.trace_op("logical_or", {"X": out, "Y": v}, {},
                                ["Out"])
    return out


def convert_logical_not(x):
    if _is_tensor(x):
        return _tr.trace_op("logical_not", {"X": x}, {}, ["Out"])
    return not x


def convert_not_any(*flags):
    """not (f1 or f2 or ...) — the break/continue guard predicate."""
    return convert_logical_not(convert_logical_or(*flags))


def convert_lt(a, b):
    if _is_tensor(a):
        return a < b
    if _is_tensor(b):
        return b > a
    return a < b


def _recording():
    return _tr.active_recorder() is not None


def convert_print(*args, **kwargs):
    """print_transformer.py analog.  Under a to_static trace (program
    recorder active) tensor args record `print` ops so the print fires on
    EVERY execution of the cached program, not once at trace; plain
    eager/python values keep builtin print."""
    if _recording() and any(isinstance(a, Tensor) for a in args):
        # one print op per tensor, carrying the non-tensor text that
        # precedes it, so "a:", t1, "b:", t2 keeps its interleaving;
        # trailing text rides the last tensor's op
        sep = kwargs.get("sep", " ")
        pending = []
        ops = []
        for a in args:
            if isinstance(a, Tensor):
                ops.append([sep.join(str(p) for p in pending), a])
                pending = []
            else:
                pending.append(a)
        if pending and ops:
            ops[-1][0] += (" | trailing: " +
                           sep.join(str(p) for p in pending))
        for message, t in ops:
            _tr.trace_op("print", {"In": t},
                              {"message": message}, ["Out"])
        return
    from ..dygraph.tensor import numpy as _numpy
    print(*[_numpy(a) if isinstance(a, Tensor) else a
            for a in args], **kwargs)


def convert_assert(cond, msg=None):
    """assert_transformer.py analog.  Under a to_static trace a tensor
    condition records an `assert` op (host-side runtime check, the
    reference Assert op's abort contract); eager values assert
    immediately with python semantics."""
    if isinstance(cond, Tensor) and _recording():
        _tr.trace_op(
            "assert", {"Cond": cond},
            {"message": str(msg) if msg is not None else "Assert failed"},
            [])
        return
    if isinstance(cond, Tensor):
        assert bool(torch.all(cond).item()), msg
    else:
        assert cond, msg


def convert_var_dtype(x, kind):
    """cast_transformer.py analog.  Under a to_static trace int()/float()
    /bool() on a tensor becomes a cast op (stays in the program); in
    plain eager or on python values, python semantics."""
    py = {"int": int, "float": float, "bool": bool}[kind]
    if isinstance(x, Tensor):
        if _recording():
            dt = {"int": "int64", "float": "float32",
                  "bool": "bool"}[kind]
            return _tr.trace_op("cast", {"X": x},
                                     {"out_dtype": dt}, ["Out"])
        return py(x.item())
    return py(x)


def convert_idx_inc(i):
    return i + 1


def convert_range_setup(*args):
    """Normalize range(...) args into (("range", start, step), n) where n
    is a python int for static bounds or a Tensor for tensor bounds."""
    if len(args) == 1:
        start, stop, step = 0, args[0], 1
    elif len(args) == 2:
        start, stop, step = args[0], args[1], 1
    else:
        start, stop, step = args
    if not any(_is_tensor(v) for v in (start, stop, step)):
        return ("range", int(start), int(step)), len(
            range(int(start), int(stop), int(step)))
    # ceil((stop-start)/step) == -floor((start-stop)/step); floor-division
    # semantics match between python and torch for ints
    d = start - stop            # tensor arithmetic via op sugar
    q = d // step if _is_tensor(d) else _rsub_floordiv(d, step)
    n = 0 - q
    zero = _const_like(n, 0)
    n = _tr.trace_op("elementwise_max", {"X": n, "Y": zero}, {},
                          ["Out"])
    return ("range", start, step), n


def _rsub_floordiv(d, step):
    # d python, step tensor: route through the tensor's reverse op
    if not isinstance(step, Tensor):
        return d // step
    return _const_like(step, d) // step


def _const_like(t, value):
    return _new(torch.tensor, value, dtype=t.dtype, device=t.device)


def convert_for_setup(it):
    """(iterable, length) for the for→while rewrite.  Tensors iterate
    their leading axis (static length → the loop unrolls under tracing);
    plain python iterables are materialized if needed."""
    import collections.abc
    if _is_tensor(it):
        if not it.shape:
            raise Dy2StaticError("cannot iterate a 0-d tensor")
        return it, int(it.shape[0])
    if isinstance(it, range):
        return ("range", it.start, it.step), len(it)
    if isinstance(it, collections.abc.Sequence):
        return it, len(it)  # positionally indexable (list/tuple/str/...)
    # mappings iterate their KEYS; generators/sets/etc. materialize
    seq = list(it)
    return seq, len(seq)


def convert_iter_item(it, idx):
    if isinstance(it, tuple) and len(it) == 3 and it[0] == "range":
        _, start, step = it
        return start + idx * step
    if _is_tensor(it):
        idx_t = idx if _is_tensor(idx) else _new(
            torch.tensor, idx, dtype=torch.int32, device=it.device)
        return _tr.trace_op("gather", {"X": it, "Index": idx_t},
                                 {"axis": 0}, ["Out"])
    if _is_tensor(idx):
        raise Dy2StaticError(
            "tensor loop index over a plain python sequence — materialize "
            "the sequence as a tensor first")
    return it[idx]


def convert_while_loop(test_fn, body_fn, names, init):
    """convert_operators.py convert_while_loop analog.  `names` is the
    loop-variable union (assigned in body), `init` their current values
    (Undefined when not yet bound).  Dispatch: python condition → normal
    loop (unrolls under tracing); Tensor condition inside a to_static
    trace → record a real `while` op."""
    vals = list(init)
    pred = test_fn(*vals)
    rec = _tr.active_recorder()
    if rec is not None and _is_tensor(pred):
        return _record_while(rec, pred, test_fn, body_fn, names, vals)
    while _to_bool(pred):
        vals = list(_as_tuple(body_fn(*vals), len(names)))
        pred = test_fn(*vals)
        if _tr.active_recorder() is not None and _is_tensor(pred):
            # the condition became tensor-dependent mid-unroll (e.g. a
            # tensor break flag inside a python-bounded for): the unrolled
            # prefix was decided by python-only state, so it is
            # input-independent — record a `while` op for the remainder
            return _record_while(_tr.active_recorder(), pred,
                                 test_fn, body_fn, names, vals)
    return tuple(vals)


def _as_tuple(v, n):
    if n == 1 and not isinstance(v, tuple):
        return (v,)
    return v


def _record_while(rec, pred0, test_fn, body_fn, names, vals):
    """Trace the loop body into a sub-block ending in assigns back to the
    loop-carried parent vars, append a `while` op (while_op.cc:1 analog),
    and return eager-replay final values registered to the carried names."""

    program, parent = rec.program, rec.block
    pred_name = rec.name_of(pred0)

    # 1. discovery + eager replay: run the loop with true trace-time
    #    semantics (recorder off), tracking at EVERY iteration which
    #    python-scalar loop vars change or become tensors — a counter that
    #    only moves in iteration 3 still needs lifting.  A forced single
    #    body probe covers traces whose replay runs zero iterations.
    n_vars = len(names)
    tensor_like = [None] * n_vars    # tensor a python var became
    observed = [list() for _ in range(n_vars)]  # python values seen
    bad_type = [None] * n_vars

    def _track(prev, new):
        for i, (o, n) in enumerate(zip(prev, new)):
            if isinstance(o, _UndefinedVar) or _is_tensor(o):
                continue
            if _is_tensor(n):
                if tensor_like[i] is None:
                    tensor_like[i] = n
            elif isinstance(n, (bool, int, float)):
                if n != o:
                    observed[i].append(n)
            elif n is not o and n != o:
                bad_type[i] = type(o).__name__

    rec.replaying += 1  # ops run and take eager names, unrecorded
    try:
        cur = list(vals)
        p = pred0
        if not _to_bool(p):
            # zero-iteration trace: force ONE body probe so lift
            # discovery still observes the body (best effort — the body
            # may legitimately fail outside the loop's guard)
            try:
                _track(vals, list(_as_tuple(body_fn(*vals), n_vars)))
            except Exception:
                pass
        while _to_bool(p):
            new = list(_as_tuple(body_fn(*cur), n_vars))
            _track(cur, new)
            cur = new
            p = test_fn(*cur)
    finally:
        rec.replaying -= 1

    lifted = list(vals)
    for i, old in enumerate(vals):
        if isinstance(old, _UndefinedVar) or _is_tensor(old):
            continue
        if bad_type[i] is not None:
            raise Dy2StaticError(
                f"loop variable {names[i]!r} is a python {bad_type[i]} "
                "that changes across iterations of a tensor-dependent "
                "while — only scalars can be lifted to loop-carried "
                "tensors")
        if tensor_like[i] is None and not observed[i]:
            continue  # never changes — stays a python constant
        # a python scalar that changes across iterations (loop counter)
        # or becomes a tensor (break flag merged in a tensor-if) must
        # itself become loop-carried device state
        if not isinstance(old, (bool, int, float)):
            raise Dy2StaticError(
                f"loop variable {names[i]!r} starts as "
                f"{type(old).__name__} but becomes a Tensor")
        if tensor_like[i] is not None:
            dt = dtype_name(tensor_like[i].dtype)
            shape = tuple(tensor_like[i].shape)
        else:
            dt, shape = _scalar_dtype(old, *observed[i]), ()
        t = _tr.trace_op(
            "fill_constant", {},
            {"shape": list(shape), "dtype": dt, "value": old},
            ["Out"])
        lifted[i] = t

    # 2. record the body into a sub-block
    sub = program.create_block(parent_idx=parent.idx)
    program.rollback()
    saved_block = rec.block
    rec.block = sub
    try:
        new_vals = list(_as_tuple(body_fn(*lifted), len(names)))
        new_pred = test_fn(*new_vals)
    finally:
        rec.block = saved_block
    if not _is_tensor(new_pred):
        raise Dy2StaticError(
            "while condition is a Tensor on entry but not after one "
            "iteration — condition type must be stable")

    carried_ix = {}
    for i, (old, new) in enumerate(zip(lifted, new_vals)):
        if isinstance(old, _UndefinedVar) or not _is_tensor(old):
            continue
        if not _is_tensor(new):
            raise Dy2StaticError(
                f"loop variable {names[i]!r} is a Tensor before the loop "
                f"but {type(new).__name__} after one iteration")
        pname = rec.name_of(old)
        nname = rec.name_of(new)
        if nname == pname:
            continue  # unchanged — read-only free var
        if tuple(new.shape) != tuple(old.shape) or \
                str(new.dtype) != str(old.dtype):
            raise Dy2StaticError(
                f"loop variable {names[i]!r} changes shape/dtype across "
                f"iterations: {tuple(old.shape)}/{old.dtype} -> "
                f"{tuple(new.shape)}/{new.dtype}")
        sub.append_op("assign", inputs={"X": [nname]},
                      outputs={"Out": [pname]}, attrs={})
        carried_ix[i] = pname
    np_name = rec.name_of(new_pred)
    sub.append_op("assign", inputs={"X": [np_name]},
                  outputs={"Out": [pred_name]}, attrs={})

    if not carried_ix:
        raise Dy2StaticError(
            "tensor-dependent while body updates no loop variable — the "
            "loop would never terminate")
    from ..static.control_flow import append_while_op
    append_while_op(parent, sub, pred_name)

    # 3. outputs: the replay already produced the true trace-time finals
    outs = []
    for i, name in enumerate(names):
        init_v = lifted[i]
        if isinstance(init_v, _UndefinedVar) or not _is_tensor(init_v):
            # loop-local (no pre-loop value) or unchanged python value —
            # loop-locals would read stale trace values downstream, so any
            # later use raises via Undefined
            outs.append(_UndefinedVar(name)
                        if isinstance(init_v, _UndefinedVar) else init_v)
            continue
        if i in carried_ix:
            fin = cur[i]
            t = fin if _is_tensor(fin) else _const_like(init_v, fin)
            rec.register(t, carried_ix[i])
            outs.append(t)
        else:
            outs.append(init_v)
    return tuple(outs)


# ---------------------------------------------------------------------------
# AST transformer
# ---------------------------------------------------------------------------
def _assigned_names(stmts) -> List[str]:
    names = []

    class V(ast.NodeVisitor):
        def visit_Assign(self, node):
            for t in node.targets:
                self._target(t)
            self.generic_visit(node)

        def visit_AugAssign(self, node):
            self._target(node.target)
            self.generic_visit(node)

        def visit_AnnAssign(self, node):
            self._target(node.target)
            self.generic_visit(node)

        def visit_For(self, node):
            self._target(node.target)
            self.generic_visit(node)

        def visit_AsyncFor(self, node):
            self._target(node.target)
            self.generic_visit(node)

        def visit_With(self, node):
            for item in node.items:
                if item.optional_vars is not None:
                    self._target(item.optional_vars)
            self.generic_visit(node)

        visit_AsyncWith = visit_With

        def visit_NamedExpr(self, node):  # walrus :=
            self._target(node.target)
            self.generic_visit(node)

        def _target(self, t):
            if isinstance(t, ast.Name):
                names.append(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                for e in t.elts:
                    self._target(e)
            elif isinstance(t, ast.Starred):
                self._target(t.value)

        # don't descend into nested function/class scopes
        def visit_FunctionDef(self, node):
            pass

        def visit_AsyncFunctionDef(self, node):
            pass

        def visit_ClassDef(self, node):
            pass

    v = V()
    for s in stmts:
        v.visit(s)
    return list(dict.fromkeys(names))


def _has_flow_escape(stmts) -> bool:
    """True when a branch contains control flow that can't live inside a
    hoisted closure: `return` ANYWHERE (even in a nested loop — the
    closure would swallow it), or break/continue not enclosed by a loop
    within the branch."""
    class V(ast.NodeVisitor):
        found = False
        loop_depth = 0

        def visit_Return(self, node):
            self.found = True

        def visit_Break(self, node):
            if self.loop_depth == 0:
                self.found = True

        def visit_Continue(self, node):
            if self.loop_depth == 0:
                self.found = True

        def _loop(self, node):
            # a break/continue in the loop's else: clause binds to an
            # ENCLOSING loop, so orelse stays at the outer depth
            self.loop_depth += 1
            for child in node.body:
                self.visit(child)
            self.loop_depth -= 1
            for child in node.orelse:
                self.visit(child)

        visit_While = _loop
        visit_For = _loop
        visit_AsyncFor = _loop

        def visit_FunctionDef(self, node):
            pass

        def visit_AsyncFunctionDef(self, node):
            pass

    v = V()
    for s in stmts:
        v.visit(s)
    return v.found


def _jst_attr(name):
    return ast.Attribute(value=ast.Name(id="_ptpu_torch_jst", ctx=ast.Load()),
                         attr=name, ctx=ast.Load())


def _jst_call(name, args):
    return ast.Call(func=_jst_attr(name), args=args, keywords=[])


def _no_args():
    return ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                         kw_defaults=[], defaults=[])


def _lambda0(body_expr):
    return ast.Lambda(args=_no_args(), body=body_expr)


def _contains_return(stmts) -> bool:
    """Return anywhere in the subtree (nested functions excluded) — a
    loop containing one cannot be hoisted into a closure."""
    class V(ast.NodeVisitor):
        found = False

        def visit_Return(self, n):
            self.found = True

        def visit_FunctionDef(self, n):
            pass

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Lambda(self, n):
            pass

    v = V()
    for s in stmts:
        v.visit(s)
    return v.found


class _BCFinder(ast.NodeVisitor):
    """Break/Continue bound to the CURRENT loop level (nested loops own
    theirs)."""

    def __init__(self):
        self.brk = self.cont = False

    def visit_Break(self, n):
        self.brk = True

    def visit_Continue(self, n):
        self.cont = True

    def visit_While(self, n):
        pass

    def visit_For(self, n):
        pass

    visit_AsyncFor = visit_For

    def visit_FunctionDef(self, n):
        pass

    visit_AsyncFunctionDef = visit_FunctionDef


class _BCReplacer(ast.NodeTransformer):
    def __init__(self, bflag, cflag):
        self.bflag, self.cflag = bflag, cflag

    def _set(self, flag):
        return ast.Assign(
            targets=[ast.Name(id=flag, ctx=ast.Store())],
            value=ast.Constant(value=True))

    def visit_Break(self, n):
        return self._set(self.bflag)

    def visit_Continue(self, n):
        return self._set(self.cflag)

    def visit_While(self, n):
        return n

    def visit_For(self, n):
        return n

    visit_AsyncFor = visit_For

    def visit_FunctionDef(self, n):
        return n

    visit_AsyncFunctionDef = visit_FunctionDef


def _sets_flags(stmt, flags) -> bool:
    for n in ast.walk(stmt):
        if isinstance(n, (ast.While, ast.For, ast.FunctionDef,
                          ast.AsyncFunctionDef)) and n is not stmt:
            continue  # flags of THIS loop never live inside those
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name) and t.id in flags:
                    return True
    return False


def _guard_stmts(stmts, flags):
    """After any statement that may set a break/continue flag, wrap the
    remaining statements in `if not any(flags):`
    (break_continue_transformer.py's guard construction)."""
    out = []
    for k, s in enumerate(stmts):
        s = _guard_in_stmt(s, flags)
        out.append(s)
        if _sets_flags(s, flags) and k + 1 < len(stmts):
            rest = _guard_stmts(stmts[k + 1:], flags)
            out.append(ast.If(
                test=_jst_call("convert_not_any",
                               [ast.Name(id=f, ctx=ast.Load())
                                for f in flags]),
                body=rest, orelse=[]))
            break
    return out


def _guard_in_stmt(s, flags):
    if isinstance(s, ast.If):
        s.body = _guard_stmts(s.body, flags)
        s.orelse = _guard_stmts(s.orelse, flags) if s.orelse else []
    elif isinstance(s, (ast.With, ast.AsyncWith)):
        s.body = _guard_stmts(s.body, flags)
    elif isinstance(s, ast.Try):
        s.body = _guard_stmts(s.body, flags)
        s.orelse = _guard_stmts(s.orelse, flags) if s.orelse else []
        s.finalbody = (_guard_stmts(s.finalbody, flags)
                       if s.finalbody else [])
        for h in s.handlers:
            h.body = _guard_stmts(h.body, flags)
    return s


class _IfTransformer(ast.NodeTransformer):
    def __init__(self):
        self.count = 0
        self.loop_count = 0

    # -- print/assert/cast (print_transformer.py, assert_transformer.py,
    #    cast_transformer.py analogs) --------------------------------------
    def visit_Call(self, node):
        self.generic_visit(node)
        if isinstance(node.func, ast.Name) and not node.keywords and \
                len(node.args) == 1 and \
                node.func.id in ("int", "float", "bool") and \
                not isinstance(node.args[0], ast.Starred):
            return _jst_call("convert_var_dtype",
                             [node.args[0],
                              ast.Constant(value=node.func.id)])
        if isinstance(node.func, ast.Name) and node.func.id == "print" \
                and not any(isinstance(a, ast.Starred)
                            for a in node.args):
            return ast.Call(func=_jst_attr("convert_print"),
                            args=node.args, keywords=node.keywords)
        return node

    def visit_Assert(self, node):
        self.generic_visit(node)
        args = [node.test] + ([node.msg] if node.msg is not None else [])
        return ast.Expr(value=_jst_call("convert_assert", args))

    # -- loops (loop_transformer.py:367 LoopTransformer analog) -----------
    def _leave_untransformed(self, node):
        """A loop the transform can't hoist (return inside, else-clause)
        stays a plain python loop — trace-time unrolling, exactly the
        pre-transform behaviour — so the REST of the function (tensor-ifs,
        other loops) still converts instead of the whole transform
        aborting to the tracing fallback."""
        self.generic_visit(node)
        return node

    def visit_While(self, node):
        if node.orelse or _contains_return(node.body):
            return self._leave_untransformed(node)
        return self._transform_loop(node.test, node.body, [])

    def visit_For(self, node):
        if node.orelse or _contains_return(node.body):
            return self._leave_untransformed(node)
        i = self.loop_count
        self.loop_count += 1
        it_n, n_n, idx_n = (f"_ptpu_it_{i}", f"_ptpu_n_{i}",
                            f"_ptpu_idx_{i}")
        it = node.iter
        if (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and it.func.id == "range" and not it.keywords):
            setup_call = _jst_call("convert_range_setup", it.args)
        else:
            setup_call = _jst_call("convert_for_setup", [it])
        setup = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=it_n, ctx=ast.Store()),
                      ast.Name(id=n_n, ctx=ast.Store())],
                ctx=ast.Store())],
            value=setup_call)
        idx_init = ast.Assign(
            targets=[ast.Name(id=idx_n, ctx=ast.Store())],
            value=ast.Constant(value=0))
        target_assign = ast.Assign(
            targets=[node.target],
            value=_jst_call("convert_iter_item",
                            [ast.Name(id=it_n, ctx=ast.Load()),
                             ast.Name(id=idx_n, ctx=ast.Load())]))
        inc = ast.Assign(
            targets=[ast.Name(id=idx_n, ctx=ast.Store())],
            value=_jst_call("convert_idx_inc",
                            [ast.Name(id=idx_n, ctx=ast.Load())]))
        test = _jst_call("convert_lt",
                         [ast.Name(id=idx_n, ctx=ast.Load()),
                          ast.Name(id=n_n, ctx=ast.Load())])
        stmts = self._transform_loop(test, [target_assign] + node.body,
                                     [inc])
        return [setup, idx_init] + stmts

    def _transform_loop(self, test, body, post):
        test = self._rewrite_cond_boolops(test)
        # 1. this loop's break/continue -> flag vars + guard ifs
        finder = _BCFinder()
        for s in body:
            finder.visit(s)
        pre = []
        i = self.loop_count
        self.loop_count += 1
        if finder.brk or finder.cont:
            bflag, cflag = f"_ptpu_brk_{i}", f"_ptpu_cont_{i}"
            rep = _BCReplacer(bflag, cflag)
            body = [rep.visit(s) for s in body]
            flags = [f for f, on in ((bflag, finder.brk),
                                     (cflag, finder.cont)) if on]
            body = _guard_stmts(body, flags)
            if finder.cont:
                body.insert(0, ast.Assign(
                    targets=[ast.Name(id=cflag, ctx=ast.Store())],
                    value=ast.Constant(value=False)))
            if finder.brk:
                pre.append(ast.Assign(
                    targets=[ast.Name(id=bflag, ctx=ast.Store())],
                    value=ast.Constant(value=False)))
                # flag FIRST: after a python-level break fires, lazy
                # short-circuit must not re-evaluate the original test
                # (Python never evaluates the test after break)
                test = _jst_call(
                    "convert_logical_and",
                    [_lambda0(_jst_call("convert_logical_not",
                                        [ast.Name(id=bflag,
                                                  ctx=ast.Load())])),
                     _lambda0(test)])
        # 2. recurse (nested loops, ifs including the guard ifs)
        new_body = []
        for s in body + post:
            r = self.visit(s)
            if isinstance(r, list):
                new_body.extend(r)
            elif r is not None:
                new_body.append(r)
        test = self.visit(test)
        if _has_flow_escape(new_body):
            raise Dy2StaticError(
                "return inside a loop body is not supported by the "
                "dy2static loop transform")
        # 3. hoist into test/body closures over the loop-variable union
        names = _assigned_names(new_body)
        tname, bname = f"_ptpu_wtest_{i}", f"_ptpu_wbody_{i}"

        def make_fn(name, stmts, ret_expr):
            return ast.FunctionDef(
                name=name,
                args=ast.arguments(
                    posonlyargs=[],
                    args=[ast.arg(arg=n) for n in names],
                    kwonlyargs=[], kw_defaults=[], defaults=[]),
                body=stmts + [ast.Return(value=ret_expr)],
                decorator_list=[])

        test_def = make_fn(tname, [], test)
        body_def = make_fn(
            bname, new_body,
            ast.Tuple(elts=[ast.Name(id=n, ctx=ast.Load())
                            for n in names], ctx=ast.Load()))
        call = _jst_call(
            "convert_while_loop",
            [ast.Name(id=tname, ctx=ast.Load()),
             ast.Name(id=bname, ctx=ast.Load()),
             ast.Tuple(elts=[ast.Constant(value=n) for n in names],
                       ctx=ast.Load()),
             self._grab_env(names)])
        if names:
            assign = ast.Assign(
                targets=[ast.Tuple(
                    elts=[ast.Name(id=n, ctx=ast.Store())
                          for n in names], ctx=ast.Store())],
                value=call)
        else:
            assign = ast.Expr(value=call)
        return pre + [test_def, body_def, assign]

    @staticmethod
    def _grab_env(names):
        return ast.Tuple(
            elts=[ast.Call(
                func=_jst_attr("_grab"),
                args=[_lambda0(ast.Name(id=n, ctx=ast.Load())),
                      ast.Constant(value=n)],
                keywords=[]) for n in names],
            ctx=ast.Load())

    # -- boolean operators (logical_transformer.py analog) -----------------
    @classmethod
    def _rewrite_cond_boolops(cls, expr):
        """Rewrite `and`/`or`/`not` along the boolean SPINE of a condition
        expression into the lazy tensor-aware converters — `a and b` on
        traced tensors would otherwise concretize through __bool__ at
        trace time, baking the trace input's outcome into the program.
        Only condition positions are rewritten (value-context BoolOps like
        `y = x or default` keep exact python value semantics), and the
        rewrite does not descend past the spine (operands of comparisons,
        calls, etc. are left untouched)."""
        if isinstance(expr, ast.BoolOp):
            fn = ("convert_logical_and" if isinstance(expr.op, ast.And)
                  else "convert_logical_or")
            return _jst_call(fn, [
                _lambda0(cls._rewrite_cond_boolops(v))
                for v in expr.values])
        if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Not):
            return _jst_call("convert_logical_not",
                             [cls._rewrite_cond_boolops(expr.operand)])
        return expr

    def visit_If(self, node):
        node.test = self._rewrite_cond_boolops(node.test)
        self.generic_visit(node)
        if _has_flow_escape(node.body) or _has_flow_escape(node.orelse):
            # return (or unrewritten break/continue) in a branch can't be
            # hoisted into a closure — leave THIS if untransformed (plain
            # python: trace-time branch resolution, the pre-transform
            # behaviour) so the rest of the function still converts
            return node
        outs = _assigned_names(node.body + node.orelse)
        i = self.count
        self.count += 1
        tname, fname = f"_ptpu_true_{i}", f"_ptpu_false_{i}"

        def branch_fn(name, body):
            # branch takes the assigned-name union as PARAMETERS (so an
            # in-branch `x = x * 2` reads the parameter, not an unbound
            # local) and returns all of them
            rets = ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Load()) for n in outs],
                ctx=ast.Load())
            return ast.FunctionDef(
                name=name,
                args=ast.arguments(
                    posonlyargs=[],
                    args=[ast.arg(arg=n) for n in outs],
                    kwonlyargs=[], kw_defaults=[], defaults=[]),
                body=(body or [ast.Pass()]) +
                [ast.Return(value=rets)],
                decorator_list=[])

        # current values of the assigned names (UndefinedVar when a name
        # doesn't exist yet), evaluated lazily at the call site
        env = self._grab_env(outs)
        call = ast.Call(
            func=ast.Attribute(
                value=ast.Name(id="_ptpu_torch_jst", ctx=ast.Load()),
                attr="convert_ifelse", ctx=ast.Load()),
            args=[node.test,
                  ast.Name(id=tname, ctx=ast.Load()),
                  ast.Name(id=fname, ctx=ast.Load()),
                  env],
            keywords=[])
        if outs:
            assign = ast.Assign(
                targets=[ast.Tuple(
                    elts=[ast.Name(id=n, ctx=ast.Store()) for n in outs],
                    ctx=ast.Store())],
                value=call)
        else:
            assign = ast.Expr(value=call)
        return [branch_fn(tname, node.body),
                branch_fn(fname, node.orelse), assign]


def ast_transform(fn):
    """Rewrite `if` statements of `fn` into convert_ifelse calls; returns
    the new function, or raises Dy2StaticError when the source is
    unavailable or uses unsupported constructs (caller falls back to pure
    tracing)."""
    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError) as e:
        raise Dy2StaticError(f"source unavailable: {e}")
    try:
        tree = ast.parse(src)
    except SyntaxError as e:  # e.g. a lambda extracted mid-statement
        raise Dy2StaticError(f"unparseable source: {e}")
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        raise Dy2StaticError("not a plain function")
    # only the to_static/declarative decorators may be stripped — anything
    # else would silently vanish from the recompiled function
    for dec in fdef.decorator_list:
        names = {n.attr if isinstance(n, ast.Attribute) else
                 getattr(n, "id", None)
                 for n in ast.walk(dec) if isinstance(n, (ast.Attribute,
                                                          ast.Name))}
        if not names & {"to_static", "declarative"}:
            raise Dy2StaticError(
                "function carries decorators other than to_static; "
                "falling back to tracing")
    fdef.decorator_list = []
    def _convertible(n):
        if isinstance(n, (ast.If, ast.While, ast.For, ast.Assert)):
            return True
        return (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id in ("print", "int", "float", "bool"))

    if not any(_convertible(n) for n in ast.walk(fdef)):
        raise Dy2StaticError(
            "no if/while/for/assert/print/cast constructs — nothing to "
            "transform")
    _IfTransformer().visit(fdef)

    freevars = fn.__code__.co_freevars
    if freevars:
        # rebind the closure: wrap the transformed def in an outer function
        # taking the original CELL objects as args; the inner function
        # re-reads cell_contents on every call, so later rebinds of a free
        # variable stay visible (late binding, matching the untransformed
        # function)
        cell_params = [f"_ptpu_cell_{n}" for n in freevars]
        deref = [ast.Assign(
            targets=[ast.Name(id=n, ctx=ast.Store())],
            value=ast.Attribute(
                value=ast.Name(id=c, ctx=ast.Load()),
                attr="cell_contents", ctx=ast.Load()))
            for n, c in zip(freevars, cell_params)]
        fdef.body = deref + fdef.body
        outer = ast.FunctionDef(
            name="__dy2st_outer__",
            args=ast.arguments(
                posonlyargs=[], args=[ast.arg(arg=c) for c in cell_params],
                kwonlyargs=[], kw_defaults=[], defaults=[]),
            body=[fdef,
                  ast.Return(value=ast.Name(id=fdef.name, ctx=ast.Load()))],
            decorator_list=[])
        tree.body = [outer]
    ast.fix_missing_locations(tree)
    code = compile(tree, f"<dy2static {getattr(fn, '__qualname__', fn)}>",
                   "exec")
    from . import dy2static as _jst_mod
    # exec against the function's REAL globals (late binding preserved —
    # names defined or monkeypatched after decoration must resolve), with
    # one collision-safe helper injected
    glb = fn.__globals__
    glb.setdefault("_ptpu_torch_jst", _jst_mod)
    loc = {}
    exec(code, glb, loc)
    if freevars:
        cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
        new_fn = loc["__dy2st_outer__"](*[cells[n] for n in freevars])
    else:
        new_fn = loc[fdef.name]
    new_fn.__wrapped__ = fn
    return new_fn
