"""Shared program-rewrite helpers for meta-optimizers.

Copy of paddle_tpu/distributed/fleet/meta_optimizers/rewrite_utils.py, so
both packages emit the same ops.  k-step behaviours (gradient merge,
LocalSGD) are MASKED UPDATES instead of conditional sub-blocks: every
step computes the update and `where(mask, new, old)` commits it, the mask a scalar derived
from a persistable step counter.  The step stays straight-line: no host
read decides anything, so the port's eager step and its captured CUDA
graph (`Executor.run_steps`) run the same ops every step.
"""
from __future__ import annotations

from typing import List

from ....core.program import Program, OpDesc, OpRole, unique_name

__all__ = ["append_masked_step_counter", "retarget_op_outputs_masked",
           "new_tmp_var"]


def _op(program, block, type, ins, outs, attrs=None):
    d = OpDesc(type, ins, outs, dict(attrs or {}))
    d.attrs.setdefault("op_uid", program._next_uid())
    d.attrs.setdefault(OpRole.KEY, OpRole.Optimize)
    block.ops.append(d)
    return d


def new_tmp_var(block, like=None, name_hint="tmp", dtype="float32",
                shape=(1,), stop_gradient=True):
    name = unique_name(name_hint)
    if like is not None:
        shape, dtype = like.shape, like.dtype
    block.create_var(name=name, shape=shape, dtype=dtype,
                     stop_gradient=stop_gradient)
    return name


def append_masked_step_counter(program: Program, startup: Program,
                               k_steps: int, begin_step: int = 0,
                               prefix: str = "gm") -> str:
    """Append a persistable step counter and return the name of a bool[1]
    mask var that is True every k-th step (past begin_step, LocalSGD's).

    Ops appended (all straight-line):
        step = step + 1                (persistable write-back)
        mask = (step % k == 0) [& step >= begin]

    Every op is stamped with a ``gm_role`` attr, as in the reference, so
    a commit-tail hoist (paddle_tpu's distributed/scan_window.py, not
    ported) can split the window: the
    increment is ``"counter_inc"`` (runs once per micro-step, scan
    BODY), the mask derivation is ``"mask"`` (pure function of the
    persistable counter — replayed in BOTH body and hoisted tail).
    """
    block = program.global_block()
    # int32 counter: a float32 counter stops advancing at 2**24 steps
    step = unique_name(f"@{prefix}_step")
    block.create_var(name=step, shape=(1,), dtype="int32",
                     persistable=True, stop_gradient=True)
    sb = startup.global_block()
    sb.create_var(name=step, shape=(1,), dtype="int32", persistable=True,
                  stop_gradient=True)
    d = OpDesc("fill_constant", {}, {"Out": [step]},
               {"shape": [1], "value": 0, "dtype": "int32",
                "op_uid": startup._next_uid()})
    sb.ops.append(d)

    # the return value is the mask, so the counter's name rides a program
    # attr (gradient merge records it in `_gm_meta`)
    program._last_masked_counter = step
    _op(program, block, "increment", {"X": [step]}, {"Out": [step]},
        {"step": 1, "gm_role": "counter_inc"})
    kconst = new_tmp_var(block, name_hint=f"@{prefix}_k", dtype="int32")
    _op(program, block, "fill_constant", {}, {"Out": [kconst]},
        {"shape": [1], "value": int(k_steps), "dtype": "int32",
         "gm_role": "mask"})
    rem = new_tmp_var(block, name_hint=f"@{prefix}_rem", dtype="int32")
    _op(program, block, "elementwise_mod", {"X": [step], "Y": [kconst]},
        {"Out": [rem]}, {"gm_role": "mask"})
    zero = new_tmp_var(block, name_hint=f"@{prefix}_zero", dtype="int32")
    _op(program, block, "fill_constant", {}, {"Out": [zero]},
        {"shape": [1], "value": 0, "dtype": "int32", "gm_role": "mask"})
    mask = new_tmp_var(block, name_hint=f"@{prefix}_mask", dtype="bool")
    _op(program, block, "equal", {"X": [rem], "Y": [zero]}, {"Out": [mask]},
        {"gm_role": "mask"})
    if begin_step > 0:
        beg = new_tmp_var(block, name_hint=f"@{prefix}_begin", dtype="int32")
        _op(program, block, "fill_constant", {}, {"Out": [beg]},
            {"shape": [1], "value": int(begin_step), "dtype": "int32",
             "gm_role": "mask"})
        past = new_tmp_var(block, name_hint=f"@{prefix}_past", dtype="bool")
        _op(program, block, "greater_equal", {"X": [step], "Y": [beg]},
            {"Out": [past]}, {"gm_role": "mask"})
        both = new_tmp_var(block, name_hint=f"@{prefix}_both", dtype="bool")
        _op(program, block, "logical_and", {"X": [mask], "Y": [past]},
            {"Out": [both]}, {"gm_role": "mask"})
        mask = both
    return mask


def retarget_op_outputs_masked(program: Program, op: OpDesc, mask: str,
                               insert_after: List[OpDesc],
                               rename: dict = None):
    """Rewrite `op` so its outputs land in temps, then append
    `out = where(mask, temp, out)` write-backs to `insert_after`.

    This is how a conditional_block around an optimizer op (reference
    Switch/cond) becomes straight-line dataflow: compute the update
    every step, commit it only on masked steps.

    `rename` (var -> temp) is updated so LATER ops in the same masked group
    read the freshly computed temps, keeping intra-group dataflow intact
    (e.g. AMP's update_loss_scaling consuming check_finite's FoundInfinite);
    the deferred write-backs commit the whole group atomically on the mask.
    """
    block = program.global_block()
    for slot, names in list(op.outputs.items()):
        new_names = []
        for n in names:
            tmp = new_tmp_var(block, like=block.var(n),
                              name_hint=n + "@MASKED")
            new_names.append(tmp)
            if rename is not None:
                rename[n] = tmp
            # only persistable state needs the masked commit; plain temps
            # have no prior value to preserve (readers go through `rename`)
            if block.var(n).persistable:
                sel = OpDesc("where", {"Condition": [mask], "X": [tmp],
                                       "Y": [n]}, {"Out": [n]},
                             {OpRole.KEY: OpRole.Optimize,
                              "op_uid": program._next_uid()})
                insert_after.append(sel)
        op.outputs[slot] = new_names
