"""Control-flow builders: While / while_loop, cond / case / switch_case,
Switch, the tensor-array layers, and `append_while_op` /
`_analyze_block`, the sub-block analysis the dy2static recorder (jit/)
shares.

Counterpart of paddle_tpu/static/control_flow.py (the reference's
layers/control_flow.py), the same builders producing the same ops:

    while             -> ops/kernels/control.py `while`: the sub-block
                         runs until the condition (read on the host) is
                         false; with max_iters > 0 at most that many times
                         and reverse-differentiable (`while_grad`)
    cond              -> `cond`: the taken branch's block runs
    Switch            -> `conditional_block`: body computed, merged with
                         where(cond, new, old)
    tensor arrays     -> ops/kernels/tensor_array.py: a fixed-capacity
                         buffer [max_len, ...] plus a size

`StaticRNN`, `DynamicRNN` and the `lod_*` builders raise: they wait for
the rnn tier (ROADMAP.md Queue 1, The rest).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.program import (Block, OpDesc, Program, VarDesc,
                            default_main_program, unique_name)
from .layer_helper import LayerHelper

__all__ = ["While", "while_loop", "cond", "case", "switch_case", "Switch",
           "StaticRNN", "DynamicRNN",
           "increment", "less_than", "array_write", "array_read",
           "array_length", "create_array",
           "lod_rank_table", "max_sequence_len", "lod_tensor_to_array",
           "array_to_lod_tensor", "reorder_lod_tensor_by_rank",
           "shrink_memory", "split_lod_tensor", "merge_lod_tensor"]


# re-exported conveniences (reference keeps these in control_flow.py)
def increment(x, value=1.0, in_place=True):
    from . import layers
    return layers.increment(x, value=value, in_place=in_place)


def less_than(x, y, force_cpu=None, cond=None):
    from . import layers
    return layers.less_than(x, y, cond=cond)


# ---------------------------------------------------------------------------
# sub-block analysis
# ---------------------------------------------------------------------------
def _analyze_block(sub: Block) -> Tuple[List[str], List[str]]:
    """Return (free_vars, written_parent_vars) of a sub-block, in first-use
    order.

    free: names read before any op in the block writes them — their values
    must be supplied by the enclosing scope.
    written_parent: names written by the block that resolve to a variable of
    an ANCESTOR block (loop-carried / branch-assigned state) — everything
    else the block writes is a local temporary.
    """
    defined: set = set()
    free: List[str] = []
    written: List[str] = []
    for op in sub.ops:
        for n in op.input_names():
            if n and n not in defined and n not in free:
                free.append(n)
        for n in op.output_names():
            if n:
                defined.add(n)
                if n not in written:
                    written.append(n)

    def _in_ancestor(name: str) -> bool:
        b = (sub.program.blocks[sub.parent_idx]
             if sub.parent_idx >= 0 else None)
        while b is not None:
            if name in b.vars:
                return True
            b = (sub.program.blocks[b.parent_idx]
                 if b.parent_idx >= 0 else None)
        return False

    written_parent = [n for n in written
                      if n not in sub.vars and _in_ancestor(n)]
    return free, written_parent


@contextlib.contextmanager
def _sub_block(program: Program):
    sub = program.create_block()
    try:
        yield sub
    finally:
        program.rollback()


def append_while_op(parent: Block, sub: Block, cond_name: str,
                    is_test: bool = False, max_iters: int = 0,
                    strict_truncation: bool = False):
    """Analyze a closed while sub-block and append the `while` op to the
    parent (single producer of the op schema — While.block(), while_loop
    and the dy2static loop recorder all route here).  max_iters > 0 makes
    the loop reverse-differentiable (`while_grad`).  Returns
    (free, written)."""
    free, written = _analyze_block(sub)
    if cond_name not in written:
        raise ValueError(
            "While body never updates the loop condition "
            f"{cond_name!r}; the loop would not terminate")
    snap_of: Dict[str, str] = {}
    if max_iters:
        # The while op overwrites its carried vars IN PLACE (fluid
        # semantics), so by backward time their pre-loop values are gone
        # and the grad op's forward replay would start from the FINAL
        # state (condition already false → zero iterations → zero grads).
        # Snapshot each carried input through a differentiable assign;
        # the while reads its carry inits from the snapshots, and
        # assign_grad routes the init cotangent back to the real
        # producer.  (The reference preserves per-iteration scopes
        # instead — while_op.cc:167 WhileGradOp.)
        for c in written:
            try:
                v = parent.var(c)
            except KeyError:
                continue
            snap = unique_name(c + "@PRELOOP")
            parent.create_var(name=snap, shape=v.shape, dtype=v.dtype,
                              stop_gradient=v.stop_gradient)
            parent.append_op("assign", inputs={"X": [c]},
                             outputs={"Out": [snap]}, attrs={})
            snap_of[c] = snap
    x_names = list(dict.fromkeys(
        [snap_of.get(n, n) for n in free if n != cond_name]
        + [snap_of.get(n, n) for n in written]))
    carry_srcs = [snap_of.get(n, n) for n in written]
    parent.append_op(
        "while",
        inputs={"Condition": [snap_of.get(cond_name, cond_name)],
                "X": x_names},
        outputs={"Out": list(written)},
        attrs={"sub_block": sub.idx, "x_names": x_names,
               "carry_names": list(written), "carry_srcs": carry_srcs,
               "cond_name": cond_name,
               "is_test": is_test, "max_iters": int(max_iters or 0),
               "strict_truncation": bool(strict_truncation)})
    if max_iters and not is_test:
        # differentiable (bounded) loop: loop vars are usually created by
        # fill_constant, whose output carries stop_gradient=True — but the
        # while WRITES them with values that depend on its inputs, so the
        # float carried state must become gradient-bearing whenever any
        # input requires grad, or append_backward's requires-grad sweep
        # (backward.py _requires_grad_vars) never reaches past the loop.
        # Only vars produced by constant INITIALIZER ops are flipped — a
        # carried var the user computed and explicitly froze keeps its
        # stop_gradient=True.
        _init_ops = {"fill_constant", "fill_constant_batch_size_like",
                     "fill_zeros_like", "fill_any_like", "assign_value",
                     "zeros_like", "ones_like"}
        init_produced = {n for op in parent.ops if op.type in _init_ops
                         for n in op.output_names()}

        def _requires(name):
            try:
                v = parent.var(name)
            except KeyError:
                return False
            return (v.is_parameter and v.trainable) or not v.stop_gradient
        if any(_requires(n) for n in x_names):
            for n in written:
                if n not in init_produced:
                    continue
                try:
                    v = parent.var(n)
                except KeyError:
                    continue
                if v.dtype in ("float32", "float64", "float16", "bfloat16"):
                    v.stop_gradient = False
    return free, written


# ---------------------------------------------------------------------------
# While
# ---------------------------------------------------------------------------
class While:
    """while-loop over a sub-block (control_flow.py:1020 `While`).

        i = layers.fill_constant([1], "int64", 0)
        n = layers.fill_constant([1], "int64", 10)
        cond = layers.less_than(i, n)
        w = layers.While(cond)
        with w.block():
            ...body ops, must update `cond` (e.g. via layers.less_than
            with output into cond) or the loop never ends...

    Loop-carried variables are discovered automatically: every parent
    variable the body writes is carried (it must hold a value before the
    loop).  Without max_iters NOT differentiable (the gradient raises); with
    max_iters > 0 `while_grad` differentiates it.
    """

    def __init__(self, cond: VarDesc, is_test: bool = False, name=None,
                 max_iters: int = 0, strict_truncation: bool = False):
        if cond.dtype not in ("bool",):
            raise TypeError("While condition must be a bool variable, got "
                            f"{cond.dtype}")
        if cond.shape is not None and tuple(cond.shape) not in ((), (1,)):
            raise TypeError("While condition must be a scalar (shape [1]), "
                            f"got {cond.shape}")
        self.cond_var = cond
        self.program = (cond.block.program if cond.block is not None
                        else default_main_program())
        self.is_test = is_test
        self.max_iters = int(max_iters or 0)
        self.strict_truncation = bool(strict_truncation)

    @contextlib.contextmanager
    def block(self):
        parent = self.program.current_block()
        with _sub_block(self.program) as sub:
            yield
        # carried vars (written parent state incl. cond) need initial
        # values, so they are inputs too; append_while_op validates that
        # the body updates the condition
        append_while_op(parent, sub, self.cond_var.name, self.is_test,
                        self.max_iters,
                        strict_truncation=self.strict_truncation)


def while_loop(cond, body, loop_vars, is_test=False, name=None,
               max_iters: int = 0, strict_truncation: bool = False):
    """Functional while (reference layers/control_flow.py while_loop):
    `cond(*loop_vars) -> bool scalar var`, `body(*loop_vars) -> new vars`;
    returns the final loop vars.

        i, s = while_loop(lambda i, s: layers.less_than(i, n),
                          lambda i, s: (layers.increment(i, in_place=False),
                                        layers.elementwise_add(s, x)),
                          [i0, s0], max_iters=16)

    With max_iters > 0 the loop is reverse-differentiable —
    append_backward trains straight through it (the reference's
    WhileGradOp, while_op.cc:167: `while_grad` replays the loop under
    torch autograd).
    """
    if not loop_vars:
        raise ValueError("while_loop needs at least one loop var")
    if not callable(cond) or not callable(body):
        raise TypeError("while_loop cond and body must be callable")
    from . import layers
    init_cond = cond(*loop_vars)
    if init_cond.dtype != "bool":
        raise TypeError("while_loop cond must return a bool scalar var, "
                        f"got {init_cond.dtype}")
    w = While(init_cond, is_test=is_test, name=name, max_iters=max_iters,
              strict_truncation=strict_truncation)
    with w.block():
        new_vars = body(*loop_vars)
        if not isinstance(new_vars, (list, tuple)):
            new_vars = [new_vars]
        if len(new_vars) != len(loop_vars):
            raise ValueError(
                f"while_loop body returned {len(new_vars)} vars, expected "
                f"{len(loop_vars)}")
        for new, old in zip(new_vars, loop_vars):
            if new is not old:
                layers.assign(new, output=old)
        next_cond = cond(*loop_vars)
        layers.assign(next_cond, output=init_cond)
    return list(loop_vars)


# ---------------------------------------------------------------------------
# cond / case / switch_case
# ---------------------------------------------------------------------------
def _flatten_rets(ret):
    if ret is None:
        return [], None
    if isinstance(ret, (list, tuple)):
        return list(ret), type(ret)
    return [ret], "single"


def cond(pred: VarDesc, true_fn=None, false_fn=None, name=None):
    """Two-branch conditional (the reference's control_flow.py:1976), one `cond` op.  Both branches must return the same structure of
    same-shape/dtype variables; writes to enclosing-scope variables inside a
    branch are merged (the other branch keeps the incoming value)."""
    program = (pred.block.program if pred.block is not None
               else default_main_program())
    parent = program.current_block()

    with _sub_block(program) as tb:
        t_ret = true_fn() if true_fn is not None else None
    with _sub_block(program) as fb:
        f_ret = false_fn() if false_fn is not None else None

    t_list, t_kind = _flatten_rets(t_ret)
    f_list, f_kind = _flatten_rets(f_ret)
    if len(t_list) != len(f_list):
        raise ValueError(
            f"cond branches return different arity: true_fn -> "
            f"{len(t_list)} values, false_fn -> {len(f_list)}")

    t_free, t_written = _analyze_block(tb)
    f_free, f_written = _analyze_block(fb)
    # parent vars written by either branch are extra (merged) outputs
    extra = [n for n in dict.fromkeys(t_written + f_written)]
    free = list(dict.fromkeys(t_free + f_free + extra))
    free = [n for n in free if n != pred.name]

    true_outs = [v.name for v in t_list] + extra
    false_outs = [v.name for v in f_list] + extra

    out_vars = []
    for tv in t_list:
        ov = parent.create_var(name=unique_name("cond_out"),
                               shape=tv.shape, dtype=tv.dtype,
                               stop_gradient=tv.stop_gradient)
        out_vars.append(ov)
    out_names = [v.name for v in out_vars] + extra

    parent.append_op(
        "cond",
        inputs={"Cond": [pred.name], "Input": free},
        outputs={"Out": out_names},
        attrs={"true_block": tb.idx, "false_block": fb.idx,
               "input_names": free, "true_outs": true_outs,
               "false_outs": false_outs, "cond_name": pred.name})

    if t_kind is None:
        return None
    if t_kind == "single":
        return out_vars[0]
    return t_kind(out_vars)


def case(pred_fn_pairs, default=None, name=None):
    """if/elif/else chain (control_flow.py:2753) built from nested cond."""
    if not pred_fn_pairs:
        raise ValueError("case needs at least one (pred, fn) pair")
    (pred, fn), rest = pred_fn_pairs[0], pred_fn_pairs[1:]
    if not rest:
        if default is None:
            # reference: last fn doubles as the default when none is given
            return cond(pred, fn, fn)
        return cond(pred, fn, default)
    return cond(pred, fn, lambda: case(rest, default))


def switch_case(branch_index: VarDesc, branch_fns, default=None, name=None):
    """Indexed dispatch (control_flow.py:3331).  branch_fns: dict
    {index: fn} or list of (index, fn) / fns."""
    from . import layers
    if isinstance(branch_fns, dict):
        items = sorted(branch_fns.items())
    else:
        items = [(i, f) if not isinstance(f, (tuple, list)) else tuple(f)
                 for i, f in enumerate(branch_fns)]
        items = [it if isinstance(it[0], int) else (i, it[1])
                 for i, it in enumerate(items)]
    if default is None:
        default = items[-1][1]
    pairs = []
    for idx, fn in items:
        idx_c = layers.fill_constant([1], branch_index.dtype, idx)
        pairs.append((layers.equal(branch_index, idx_c), fn))
    return case(pairs, default)


# ---------------------------------------------------------------------------
# Switch (first-true-wins assignment chain; LR-schedule workhorse)
# ---------------------------------------------------------------------------
class Switch:
    """control_flow.py:1461 `Switch`: sequential cases, first true wins;
    case bodies assign enclosing-scope variables.

        with layers.Switch() as switch:
            with switch.case(step < warmup):
                layers.assign(warm_lr, lr)
            with switch.default():
                layers.assign(base_lr, lr)

    Lowering: each case becomes a conditional_block op whose effective
    predicate is `cond_i AND NOT any(cond_j, j<i)`; the kernel computes the
    body unconditionally and merges with where(pred, new, old) (no host
    branching).
    """

    def __init__(self, name=None):
        self.program = default_main_program()
        self._prior = None  # var: OR of all previous case conditions
        self._has_default = False

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    @contextlib.contextmanager
    def case(self, condition: VarDesc):
        from . import layers
        if self._has_default:
            raise ValueError("Switch: case() after default()")
        # effective predicate, built in the PARENT block
        if self._prior is None:
            eff = condition
            self._prior = condition
        else:
            eff = layers.logical_and(condition,
                                     layers.logical_not(self._prior))
            self._prior = layers.logical_or(self._prior, condition)
        yield from self._guarded_block(eff)

    @contextlib.contextmanager
    def default(self):
        from . import layers
        if self._prior is None:
            raise ValueError("Switch: default() before any case()")
        self._has_default = True
        eff = layers.logical_not(self._prior)
        yield from self._guarded_block(eff)

    def _guarded_block(self, eff: VarDesc):
        parent = self.program.current_block()
        with _sub_block(self.program) as sub:
            yield
        free, written = _analyze_block(sub)
        if not written:
            raise ValueError("Switch case body assigns no enclosing-scope "
                             "variable — nothing to merge")
        # incoming values of written vars are needed for the merge
        inputs = list(dict.fromkeys(free + written))
        parent.append_op(
            "conditional_block",
            inputs={"Cond": [eff.name], "Input": inputs},
            outputs={"Out": list(written)},
            attrs={"sub_block": sub.idx, "input_names": inputs,
                   "out_names": list(written)})


# ---------------------------------------------------------------------------
# the rnn tier: not ported yet
# ---------------------------------------------------------------------------
_RNN_QUEUE = "ROADMAP.md Queue 1, The rest"


def _rnn_tier(what):
    raise NotImplementedError(
        f"{what} needs the static_rnn / dynamic_rnn ops and the lod_* "
        f"ops of the rnn tier, not ported yet ({_RNN_QUEUE})")


class StaticRNN:
    def __init__(self, *args, **kwargs):
        _rnn_tier("StaticRNN")


class DynamicRNN:
    def __init__(self, *args, **kwargs):
        _rnn_tier("DynamicRNN")


def _lod_builder(name):
    def f(*args, **kwargs):
        _rnn_tier(name)
    f.__name__ = name
    return f


lod_rank_table = _lod_builder("lod_rank_table")
max_sequence_len = _lod_builder("max_sequence_len")
lod_tensor_to_array = _lod_builder("lod_tensor_to_array")
array_to_lod_tensor = _lod_builder("array_to_lod_tensor")
reorder_lod_tensor_by_rank = _lod_builder("reorder_lod_tensor_by_rank")
shrink_memory = _lod_builder("shrink_memory")
split_lod_tensor = _lod_builder("split_lod_tensor")
merge_lod_tensor = _lod_builder("merge_lod_tensor")


# ---------------------------------------------------------------------------
# tensor array (LoDTensorArray analog: fixed-capacity device buffer)
# ---------------------------------------------------------------------------
def create_array(dtype, initialized_list=None):
    """LoDTensorArray analog (layers/tensor.py create_array): a
    fixed-capacity device buffer (ops/kernels/tensor_array.py
    TensorArrayVal); capacity is taken at the first array_write."""
    helper = LayerHelper("create_array")
    out = helper.create_variable_for_type_inference(dtype, True)
    out.attrs["is_tensor_array"] = True
    helper.append_op("create_tensor_array", outputs={"Out": [out]},
                     attrs={"dtype": out.dtype})
    if initialized_list:
        from . import layers
        i = layers.fill_constant([1], "int64", 0)
        for x in initialized_list:
            array_write(x, i, array=out)
            i = layers.increment(i, in_place=False)
    return out


def array_write(x: VarDesc, i: VarDesc, array=None, max_len=None):
    """write x at index i (tensor_array_read_write ops).  max_len bounds the
    buffer capacity when the array is empty (default from
    FLAGS_tensor_array_max_len, 256)."""
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    helper.append_op("write_to_array",
                     inputs={"X": [x], "I": [i], "Array": [array]},
                     outputs={"Out": [array]},
                     attrs={"max_len": max_len or 0})
    return array


def array_read(array: VarDesc, i: VarDesc):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op("read_from_array",
                     inputs={"X": [array], "I": [i]},
                     outputs={"Out": [out]})
    return out


def array_length(array: VarDesc):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("lod_array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out
