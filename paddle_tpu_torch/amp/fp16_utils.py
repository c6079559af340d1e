"""Program rewriting for static-graph AMP: cast insertion.

Counterpart of paddle_tpu/amp/fp16_utils.py (`rewrite_program`): walks
the forward block, classifies each op white / black / gray and inserts
`cast` ops so white ops consume the low dtype and black ops fp32.
Parameters stay fp32 (master weights); casts are inserted per use.  The
rule set is the JAX package's, so both packages emit the same program.
`cast_model_to_fp16` is the pure low-precision mode (O2): the same
rewrite with every gray op taken as white, so all but the black list run
in the low dtype.
"""
from __future__ import annotations

from typing import Dict

from ..core.pass_framework import finish_pass
from ..core.program import Program, OpDesc, OpRole, unique_name
from .fp16_lists import AutoMixedPrecisionLists

__all__ = ["rewrite_program", "cast_model_to_fp16"]

_FLOAT = ("float32", "float64")

# output slots that stay fp32 whatever the op's precision decision (their
# kernels always emit fp32: statistics and loss values)
_FP32_OUT_SLOTS = {
    "softmax_with_cross_entropy": {"Loss"},
    "layer_norm": {"Mean", "Variance"},
}

# gray ops whose kernels upcast internally and take fp32 parameters beside
# low-precision activations: persistable float inputs stay fp32 masters
_PARAM_TOLERANT = {"layer_norm"}

# gray ops whose kernels FOLLOW one main operand's dtype under mixed
# operands instead of promoting (softmax_with_cross_entropy follows
# Logits): a black fp32 secondary operand does not force the op, and its
# [tokens, vocab] output, back to fp32.  When the main operand is already
# low-precision the op is decided low and black operands stay uncast;
# when the main operand is fp32, black-wins applies as usual.
_MIXED_FOLLOW = {"softmax_with_cross_entropy": "Logits"}


def _is_float_var(block, name):
    try:
        v = block.var(name)
    except KeyError:
        return False
    return v.dtype in _FLOAT or v.dtype in ("float16", "bfloat16")


def _insert_cast(block, name, src_dtype, dst_dtype, cache, new_ops, uid_fn):
    key = (name, dst_dtype)
    if key in cache:
        return cache[key]
    out = unique_name(f"{name}.cast_{dst_dtype}")
    block.create_var(name=out, shape=block.var(name).shape, dtype=dst_dtype,
                     stop_gradient=block.var(name).stop_gradient)
    op = OpDesc("cast", {"X": [name]}, {"Out": [out]},
                {"in_dtype": src_dtype, "out_dtype": dst_dtype,
                 OpRole.KEY: OpRole.Forward, "op_uid": uid_fn()})
    new_ops.append(op)
    cache[key] = out
    return out


def rewrite_program(main_program: Program, amp_lists=None,
                    dest_dtype: str = "bfloat16"):
    """Insert the AMP casts into the forward block (call BEFORE
    append_backward, as decorate() does)."""
    amp_lists = amp_lists or AutoMixedPrecisionLists()
    block = main_program.global_block()
    var_dtype: Dict[str, str] = {}  # rewritten dtype of each var
    black_out = set()  # vars produced by black ops: fp32 for a reason
    new_ops = []
    cache: Dict = {}
    uid_fn = main_program._next_uid

    def cur_dtype(n):
        return var_dtype.get(n, block.var(n).dtype)

    for op in block.ops:
        if op.op_role != OpRole.Forward and op.op_role != OpRole.Loss:
            new_ops.append(op)
            continue
        t = op.type
        if t in amp_lists.white_list and not (
                amp_lists.black_varnames &
                set(op.input_names() + op.output_names())):
            want = dest_dtype
        elif t in amp_lists.gray_list:
            # a black producer wins (its fp32 output is protected);
            # otherwise follow any low-precision producer, casting the
            # other float inputs; with neither, stay fp32.  A _MIXED_FOLLOW
            # kernel whose MAIN operand is low is decided low, with its
            # black operands left uncast.
            ins = [n for n in op.input_names() if _is_float_var(block, n)]
            low = any(cur_dtype(n) == dest_dtype for n in ins)
            follow_low = t in _MIXED_FOLLOW and any(
                cur_dtype(n) == dest_dtype
                for n in op.inputs.get(_MIXED_FOLLOW[t], [])
                if n and _is_float_var(block, n))
            if any(n in black_out for n in ins) and not follow_low:
                want = None
                black_out.update(n for n in op.output_names()
                                 if _is_float_var(block, n))
            elif low:
                want = dest_dtype
            else:
                want = None
        else:
            want = "float32"
            black_out.update(n for n in op.output_names()
                             if _is_float_var(block, n))

        if want is not None:
            for slot, names in op.inputs.items():
                out_names = []
                for n in names:
                    if not _is_float_var(block, n) or (
                            t in _PARAM_TOLERANT and
                            block.var(n).persistable) or (
                            t in amp_lists.gray_list and n in black_out):
                        # a black-produced fp32 operand of a low gray op
                        # stays protected; white ops cast everything down
                        out_names.append(n)
                        continue
                    cur = cur_dtype(n)
                    if cur in _FLOAT + ("float16", "bfloat16") and cur != want:
                        out_names.append(_insert_cast(
                            block, n, cur, want, cache, new_ops, uid_fn))
                    else:
                        out_names.append(n)
                op.inputs[slot] = out_names
            fp32_slots = _FP32_OUT_SLOTS.get(t, ())
            for slot, names in op.outputs.items():
                for n in names:
                    if not _is_float_var(block, n):
                        continue
                    dt = "float32" if slot in fp32_slots else want
                    block.var(n).dtype = dt
                    var_dtype[n] = dt
        new_ops.append(op)
    block.ops = new_ops
    main_program._fingerprint_cache = None
    finish_pass(main_program, "amp", dest_dtype=dest_dtype)
    return main_program


def cast_model_to_fp16(program: Program, amp_lists=None,
                       dest_dtype: str = "bfloat16"):
    """fp16_utils.py cast_model_to_fp16 (pure low precision, O2): every
    float var and op flipped to `dest_dtype` except the black list."""
    amp_lists = amp_lists or AutoMixedPrecisionLists()
    lists = AutoMixedPrecisionLists(
        custom_white_list=amp_lists.gray_list | amp_lists.white_list,
        custom_black_list=amp_lists.black_list)
    return rewrite_program(program, lists, dest_dtype)
