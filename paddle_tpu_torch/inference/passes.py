"""Inference optimization passes.

Copy of paddle_tpu/inference/passes.py: the same registry names and the
same DEFAULT_INFERENCE_PASSES pipeline, so a model loaded by either
package is rewritten identically.  The passes walk the IR; two of them
also touch the scope: `conv_bn_fuse_pass` writes the folded conv filter
and bias, and `quant_int8_pass` reads which weights are int8.  One
difference: `quant_int8_pass` also rewrites a mul / fc over a
higher-rank activation that contracts its last axis (see the pass).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core.program import Program, OpDesc, OpRole
# the framework core lives in core/pass_framework.py (shared with training
# passes); re-exported here for API compatibility
from ..core.pass_framework import (register_pass, get_pass, apply_passes,
                                   PassContext, all_passes)

__all__ = ["register_pass", "get_pass", "apply_passes", "PassContext",
           "all_passes", "DEFAULT_INFERENCE_PASSES"]


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------
@register_pass("is_test_pass")
def is_test_pass(program: Program, ctx: PassContext) -> Program:
    """ir/is_test_pass.cc: flip is_test on every op that has it."""
    program._set_test_mode()
    ctx.hit("is_test_pass")
    return program


@register_pass("simplify_with_basic_ops_pass")
def simplify_pass(program: Program, ctx: PassContext) -> Program:
    """ir/simplify_with_basic_ops_pass.cc: remove is_test dropout (becomes
    identity or scale) and scale(1.0, 0.0) no-ops by rewiring readers."""
    block = program.global_block()
    rename: Dict[str, str] = {}
    kept = []
    for op in block.ops:
        t = op.type
        if t == "dropout" and op.attrs.get("is_test"):
            impl = op.attrs.get("dropout_implementation", "downgrade_in_infer")
            x = op.inputs["X"][0]
            out = op.outputs["Out"][0]
            if impl == "upscale_in_train":
                rename[out] = rename.get(x, x)  # identity at inference
                ctx.hit("dropout_removed")
                continue
            # downgrade_in_infer: out = x * (1 - p)
            op2 = OpDesc("scale", {"X": [rename.get(x, x)]},
                         {"Out": [out]},
                         {"scale": 1.0 - op.attrs.get("dropout_prob", 0.5),
                          "bias": 0.0, "op_uid": program._next_uid(),
                          OpRole.KEY: OpRole.Forward})
            kept.append(op2)
            ctx.hit("dropout_lowered")
            continue
        if t == "scale" and float(op.attrs.get("scale", 1.0)) == 1.0 and \
                float(op.attrs.get("bias", 0.0)) == 0.0:
            rename[op.outputs["Out"][0]] = rename.get(
                op.inputs["X"][0], op.inputs["X"][0])
            ctx.hit("identity_scale_removed")
            continue
        for slot, names in op.inputs.items():
            op.inputs[slot] = [rename.get(n, n) for n in names]
        kept.append(op)
    block.ops = kept
    # fetch targets produced by a removed op follow the rename too
    fetches = getattr(program, "_fetch_names", None)
    if fetches:
        program._fetch_names = [rename.get(n, n) for n in fetches]
    return program


def _is_projection_bias(block, name):
    """A real bias addend: persistable, effectively 1-D (shared by the
    fc and multihead fusion passes)."""
    try:
        bvar = block.var(name)
    except KeyError:
        return False
    return bool(bvar.persistable and bvar.shape
                and len([s for s in bvar.shape if s != 1]) <= 1)


@register_pass("fc_fuse_pass")
def fc_fuse_pass(program: Program, ctx: PassContext) -> Program:
    """ir/fc_fuse_pass.cc: mul + elementwise_add(bias) → fc."""
    block = program.global_block()
    consumers: Dict[str, int] = {}
    for op in block.ops:
        for n in op.input_names():
            consumers[n] = consumers.get(n, 0) + 1
    kept: List[OpDesc] = []
    by_out = {}
    for op in block.ops:
        fused = False
        if op.type == "elementwise_add" and \
                op.attrs.get("axis", -1) in (1, -1):
            xin = op.inputs.get("X", [None])[0]
            prev = by_out.get(xin)
            if prev is not None and prev.type == "mul" and \
                    consumers.get(xin, 0) == 1:
                bias = op.inputs.get("Y", [None])[0]
                if _is_projection_bias(block, bias):
                    kept.remove(prev)
                    fc = OpDesc("fc",
                                {"Input": prev.inputs["X"],
                                 "W": prev.inputs["Y"], "Bias": [bias]},
                                {"Out": op.outputs["Out"]},
                                {"in_num_col_dims": prev.attrs.get(
                                    "x_num_col_dims", 1),
                                 "op_uid": program._next_uid(),
                                 OpRole.KEY: OpRole.Forward})
                    kept.append(fc)
                    by_out[fc.outputs["Out"][0]] = fc
                    ctx.hit("fc_fused")
                    fused = True
        if not fused:
            kept.append(op)
            for n in op.output_names():
                by_out[n] = op
    block.ops = kept
    return program


@register_pass("multihead_matmul_fuse_pass")
def multihead_matmul_fuse_pass(program: Program, ctx: PassContext) \
        -> Program:
    """ir/multihead_matmul_fuse_pass.cc analog: collapse the static-graph
    attention idiom

        q/k/v = transpose0213(reshape4d(mul(X, W) [+ bias]))
        scores = matmul(q, k, transpose_y=True, alpha)
        [scores = scores + mask]
        ctx = matmul(softmax(scores), v)
        out = reshape3d(transpose0213(ctx))

    into ONE multihead_matmul op on the shared attention core.  All
    three projections must read the same input; every fused intermediate
    must have exactly one consumer (otherwise the pattern is left
    alone)."""
    block = program.global_block()
    producer: Dict[str, OpDesc] = {}
    consumers: Dict[str, int] = {}
    for op in block.ops:
        for n in op.input_names():
            consumers[n] = consumers.get(n, 0) + 1
        for n in op.output_names():
            producer[n] = op

    def _single(name):
        return consumers.get(name, 0) == 1

    def _proj(name):
        """Trace name back through transpose([0,2,1,3]) <- reshape(4d)
        <- mul [+ elementwise_add].  Returns (x, w, b, heads, ops)."""
        t = producer.get(name)
        if t is None or t.type not in ("transpose", "transpose2") or \
                list(t.attrs.get("perm", t.attrs.get("axis", ()))) != \
                [0, 2, 1, 3] or \
                not _single(t.inputs["X"][0]):
            return None
        r = producer.get(t.inputs["X"][0])
        if r is None or r.type not in ("reshape", "reshape2"):
            return None
        shape = list(r.attrs.get("shape", ()))
        if len(shape) != 4 or not _single(r.inputs["X"][0]):
            return None
        heads = shape[2]
        p = producer.get(r.inputs["X"][0])
        matched = [t, r]
        bias = None
        if p is not None and p.type == "elementwise_add":
            bias = p.inputs["Y"][0]
            # only a real projection bias — a residual/positional add
            # is NOT one
            if not _is_projection_bias(block, bias) or \
                    not _single(p.inputs["X"][0]):
                return None
            matched.append(p)
            p = producer.get(p.inputs["X"][0])
        if p is None or p.type != "mul":
            return None
        matched.append(p)
        return (p.inputs["X"][0], p.inputs["Y"][0], bias, heads, matched)

    kept = list(block.ops)
    fused_any = True
    while fused_any:
        fused_any = False
        for sm in kept:
            if sm.type != "softmax" or \
                    int(sm.attrs.get("axis", -1)) not in (-1, 3):
                continue
            s_in = sm.inputs["X"][0]
            matched = [sm]
            mask = None
            qk = producer.get(s_in)
            if qk is not None and qk.type == "elementwise_add":
                add = qk
                qk = producer.get(add.inputs["X"][0])
                mask = add.inputs["Y"][0]
                if qk is None or not _single(add.inputs["X"][0]):
                    continue
                matched.append(add)
            if qk is None or qk.type not in ("matmul", "matmul_v2") or \
                    not (qk.attrs.get("transpose_Y")
                         or qk.attrs.get("trans_y")) or \
                    not _single(s_in):
                continue
            matched.append(qk)
            # the head tensors themselves must feed ONLY this attention —
            # deleting their producers while another consumer survives
            # would leave it reading a var nothing produces
            if not (_single(qk.inputs["X"][0])
                    and _single(qk.inputs["Y"][0])):
                continue
            pq = _proj(qk.inputs["X"][0])
            pk = _proj(qk.inputs["Y"][0])
            if pq is None or pk is None:
                continue
            # softmax output -> context matmul with v
            ctx_mm = None
            for op in kept:
                if op.type in ("matmul", "matmul_v2") and \
                        op.inputs.get("X", [None])[0] == \
                        sm.outputs["Out"][0]:
                    ctx_mm = op
                    break
            if ctx_mm is None or not _single(sm.outputs["Out"][0]) \
                    or float(ctx_mm.attrs.get("alpha", 1.0)) != 1.0 \
                    or not _single(ctx_mm.inputs["Y"][0]):
                continue
            pv = _proj(ctx_mm.inputs["Y"][0])
            if pv is None:
                continue
            if not (pq[0] == pk[0] == pv[0]) or \
                    not (pq[3] == pk[3] == pv[3]):
                continue
            matched.append(ctx_mm)
            # out chain: transpose0213 -> reshape back to 3d
            t_out = None
            for op in kept:
                if op.type in ("transpose", "transpose2") and \
                        op.inputs["X"][0] == ctx_mm.outputs["Out"][0]:
                    t_out = op
                    break
            if t_out is None or \
                    list(t_out.attrs.get("perm",
                                      t_out.attrs.get("axis", ()))) != \
                    [0, 2, 1, 3] or \
                    not _single(ctx_mm.outputs["Out"][0]):
                continue
            r_out = None
            for op in kept:
                if op.type in ("reshape", "reshape2") and \
                        op.inputs["X"][0] == t_out.outputs["Out"][0]:
                    r_out = op
                    break
            if r_out is None or not _single(t_out.outputs["Out"][0]) \
                    or len(list(r_out.attrs.get("shape", ()))) != 3:
                # the fused op emits [B, L, D]; any other merge shape
                # (e.g. flatten-to-2D) keeps the float pattern
                continue
            matched += [t_out, r_out]
            matched += pq[4] + pk[4] + pv[4]

            ins = {"Input": [pq[0]], "WQ": [pq[1]], "WK": [pk[1]],
                   "WV": [pv[1]]}
            if pq[2]:
                ins["BQ"] = [pq[2]]
            if pk[2]:
                ins["BK"] = [pk[2]]
            if pv[2]:
                ins["BV"] = [pv[2]]
            if mask:
                ins["BiasQK"] = [mask]
            fused = OpDesc(
                "multihead_matmul", ins,
                {"Out": r_out.outputs["Out"]},
                {"head_number": pq[3],
                 "alpha": float(qk.attrs.get("alpha", 1.0)),
                 "op_uid": program._next_uid(),
                 OpRole.KEY: OpRole.Forward})
            ids = set(map(id, matched))
            # insert at the LAST matched position: the fused op reads
            # vars (e.g. the mask) that may be produced between the
            # earliest matched op and the softmax — inserting early
            # would resolve BiasQK to None and silently drop the mask
            pos = max(i for i, op in enumerate(kept) if id(op) in ids)
            kept.insert(pos + 1, fused)
            kept = [op for op in kept if id(op) not in ids]
            ctx.hit("multihead_matmul_fused")
            fused_any = True
            break
    block.ops = kept
    program._fingerprint_cache = None
    return program


@register_pass("embedding_eltwise_layernorm_fuse_pass")
def embedding_eltwise_layernorm_fuse_pass(program: Program,
                                          ctx: PassContext) -> Program:
    """ir/embedding_eltwise_layernorm_fuse_pass.cc analog: collapse
    BERT's input block — N embedding lookups summed by elementwise_add
    then layer_norm — into ONE fused_embedding_eltwise_layernorm op
    (one HBM pass over the [B, L, D] activations)."""
    block = program.global_block()
    producer: Dict[str, OpDesc] = {}
    consumers: Dict[str, int] = {}
    for op in block.ops:
        for n in op.input_names():
            consumers[n] = consumers.get(n, 0) + 1
        for n in op.output_names():
            producer[n] = op

    lookup_types = ("lookup_table", "lookup_table_v2", "embedding")

    def _collect_lookups(name, matched):
        """Resolve `name` into a list of (ids, emb) lookup leaves through
        single-consumer elementwise_add chains; None if any leaf is not
        a lookup."""
        p = producer.get(name)
        if p is None or consumers.get(name, 0) != 1:
            return None
        if p.type in lookup_types:
            matched.append(p)
            pad = p.attrs.get("padding_idx", -1)
            return [(p.inputs["Ids"][0], p.inputs["W"][0], p.type,
                     -1 if pad is None else int(pad))]
        if p.type == "elementwise_add":
            left = _collect_lookups(p.inputs["X"][0], matched)
            right = _collect_lookups(p.inputs["Y"][0], matched)
            if left is None or right is None:
                return None
            matched.append(p)
            return left + right
        return None

    kept = list(block.ops)
    for ln in list(kept):
        if ln.type != "layer_norm":
            continue
        x = ln.inputs["X"][0]
        bna = int(ln.attrs.get("begin_norm_axis", 1))
        try:
            xv = block.var(x)
        except KeyError:
            continue
        # normalize over the LAST axis only (the fused kernel's contract)
        if xv.shape is None or bna != len(xv.shape) - 1:
            continue
        # the fused op emits only Out: a consumed Mean/Variance output
        # keeps the float pattern
        if any(consumers.get(ln.outputs.get(s, [None])[0] or "", 0)
               for s in ("Mean", "Variance")):
            continue
        matched: List[OpDesc] = []
        leaves = _collect_lookups(x, matched)
        if leaves is None or len(leaves) < 2:
            continue
        ins = {"Ids": [i for i, _, _, _ in leaves],
               "Embs": [w for _, w, _, _ in leaves]}
        if ln.inputs.get("Scale"):
            ins["Scale"] = ln.inputs["Scale"]
        if ln.inputs.get("Bias"):
            ins["Bias"] = ln.inputs["Bias"]
        fused = OpDesc(
            "fused_embedding_eltwise_layernorm", ins,
            {"Out": ln.outputs["Y"]},
            {"epsilon": float(ln.attrs.get("epsilon", 1e-5)),
             # per-leaf semantics the kernel must reproduce exactly
             "leaf_types": [t for _, _, t, _ in leaves],
             "padding_idxs": [pi for _, _, _, pi in leaves],
             "op_uid": program._next_uid(),
             OpRole.KEY: OpRole.Forward})
        matched.append(ln)
        ids = set(map(id, matched))
        pos = max(i for i, op in enumerate(kept) if id(op) in ids)
        kept.insert(pos + 1, fused)
        kept = [op for op in kept if id(op) not in ids]
        ctx.hit("embedding_eltwise_layernorm_fused")
    block.ops = kept
    program._fingerprint_cache = None
    return program


_DEQUANT_TYPES = ("fake_dequantize_max_abs",
                  "fake_channel_wise_dequantize_max_abs")


@register_pass("quant_int8_pass")
def quant_int8_pass(program: Program, ctx: PassContext) -> Program:
    """INT8 execution rewrite (the reference's cpu_quantize_pass role): in
    a QuantizationFreezePass-frozen program, collapse
    fake_dequantize_max_abs(w_int8) -> mul / matmul / fc into ONE
    int8_matmul op, so the frozen program runs an int8 product (int32
    accumulation) instead of dequantize-then-fp32-matmul.  Fires only
    where the dequant input var really is int8: float programs are left
    as they are."""
    block = program.global_block()
    producer: Dict[str, OpDesc] = {}
    consumers: Dict[str, int] = {}
    for op in block.ops:
        for n in op.input_names():
            consumers[n] = consumers.get(n, 0) + 1
        for n in op.output_names():
            producer[n] = op

    def _int8_weight(deq: OpDesc):
        wname = deq.inputs["X"][0]
        try:
            if block.var(wname).dtype != "int8":
                return None
        except KeyError:
            return None
        return wname

    kept: List[OpDesc] = []
    removed_deq: set = set()
    for op in block.ops:
        rewritten = False
        wslot = {"mul": "Y", "matmul": "Y", "matmul_v2": "Y",
                 "fc": "W"}.get(op.type)
        # int8_matmul computes plain X[..., K] @ W[K, N] only: any
        # transpose, alpha or non-default column flattening keeps the float
        # path (the float kernels honour those attrs)
        plain = (wslot is not None
                 and not op.attrs.get("transpose_Y")
                 and not op.attrs.get("trans_y")
                 and not op.attrs.get("transpose_X")
                 and not op.attrs.get("trans_x")
                 and float(op.attrs.get("alpha", 1.0)) == 1.0
                 and int(op.attrs.get("x_num_col_dims", 1)) == 1
                 and int(op.attrs.get("in_num_col_dims", 1)) == 1)
        if plain and op.type in ("mul", "fc"):
            # mul / fc flatten X at axis 1; int8_matmul contracts the LAST
            # axis: the same for 2-D activations only
            xn = op.inputs.get("Input" if op.type == "fc" else "X",
                               [None])[0]
            try:
                xshape = block.var(xn).shape
            except KeyError:
                xshape = None
            plain = xshape is not None and len(xshape) == 2
        if plain:
            wname = op.inputs.get(wslot, [None])[0]
            deq = producer.get(wname)
            if deq is not None and deq.type in _DEQUANT_TYPES \
                    and _int8_weight(deq) is not None:
                sc_slot = ("Scale" if deq.type ==
                           "fake_dequantize_max_abs" else "Scales")
                scales = deq.inputs[sc_slot]
                # channel-wise only on the out-channel axis of [K, N] with
                # single-level scales; anything else keeps the float path
                if deq.type.startswith("fake_channel_wise") and (
                        deq.attrs.get("quant_axis", 0) != 1
                        or len(scales) != 1):
                    kept.append(op)
                    continue
                xslot = "Input" if op.type == "fc" else "X"
                ins = {"X": op.inputs[xslot],
                       "W": [deq.inputs["X"][0]],
                       "WScale": [scales[0]]}
                if op.type == "fc" and op.inputs.get("Bias"):
                    ins["Bias"] = op.inputs["Bias"]
                kept.append(OpDesc(
                    "int8_matmul", ins, {"Out": op.outputs["Out"]},
                    {"max_range": float(deq.attrs.get("max_range",
                                                      127.0)),
                     "op_uid": program._next_uid(),
                     OpRole.KEY: OpRole.Forward}))
                if consumers.get(wname, 0) == 1:
                    removed_deq.add(id(deq))
                ctx.hit("int8_matmul_rewritten")
                rewritten = True
        if not rewritten:
            kept.append(op)
    block.ops = [op for op in kept if id(op) not in removed_deq]
    program._fingerprint_cache = None
    return program


def _host(value) -> np.ndarray:
    """A scope value as a host numpy array (the fold runs in numpy)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _set_like(scope, name, value: np.ndarray, like):
    """Write a host array into the scope on the device of `like`."""
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    scope.set(name, torch.from_numpy(np.ascontiguousarray(value)).to(dev))


@register_pass("conv_bn_fuse_pass")
def conv_bn_fuse_pass(program: Program, ctx: PassContext) -> Program:
    """ir/conv_bn_fuse_pass.cc: fold an inference batch_norm into the
    preceding conv2d's filter and bias (needs the loaded scope).  The fold
    runs on the host in fp32 numpy in the JAX package's order (alpha =
    scale / sqrt(var + eps)), so the folded weights are bitwise its own;
    they go back to the device the scope held them on."""
    if ctx.scope is None:
        return program
    block = program.global_block()
    by_out = {}
    kept: List[OpDesc] = []
    consumers: Dict[str, int] = {}
    for op in block.ops:
        for n in op.input_names():
            consumers[n] = consumers.get(n, 0) + 1
    for op in block.ops:
        if op.type == "batch_norm" and op.attrs.get("is_test"):
            xin = op.inputs.get("X", [None])[0]
            prev = by_out.get(xin)
            # pattern: bn(conv(x)) or bn(add(conv(x), conv_bias))
            conv = None
            conv_bias_name = None
            if prev is not None and consumers.get(xin, 0) == 1:
                if prev.type == "conv2d":
                    conv = prev
                elif prev.type == "elementwise_add":
                    maybe_conv = by_out.get(prev.inputs.get("X",
                                                            [None])[0])
                    if maybe_conv is not None and \
                            maybe_conv.type == "conv2d" and \
                            consumers.get(prev.inputs["X"][0], 0) == 1:
                        conv = maybe_conv
                        conv_bias_name = prev.inputs.get("Y", [None])[0]
            if conv is not None:
                s = ctx.scope
                w_dev = s.get(conv.inputs["Filter"][0])
                w = _host(w_dev)
                scale = _host(s.get(op.inputs["Scale"][0]))
                bn_bias = _host(s.get(op.inputs["Bias"][0]))
                mean = _host(s.get(op.inputs["Mean"][0]))
                var = _host(s.get(op.inputs["Variance"][0]))
                eps = float(op.attrs.get("epsilon", 1e-5))
                alpha = scale / np.sqrt(var + eps)
                _set_like(s, conv.inputs["Filter"][0],
                          w * alpha[:, None, None, None], w_dev)
                cb = (_host(s.get(conv_bias_name)).reshape(-1)
                      if conv_bias_name is not None
                      else np.zeros_like(mean))
                folded = alpha * (cb - mean) + bn_bias
                out_bias = conv_bias_name or op.inputs["Bias"][0]
                _set_like(s, out_bias, folded, w_dev)
                if conv_bias_name is not None:
                    # keep the existing add, rewire its output to bn's
                    kept.remove(prev)
                    kept.append(OpDesc(
                        "elementwise_add", dict(prev.inputs),
                        {"Out": op.outputs["Y"]},
                        {"axis": prev.attrs.get("axis", 1),
                         "op_uid": program._next_uid(),
                         OpRole.KEY: OpRole.Forward}))
                else:
                    kept.append(OpDesc(
                        "elementwise_add",
                        {"X": [xin], "Y": [out_bias]},
                        {"Out": op.outputs["Y"]},
                        {"axis": 1, "op_uid": program._next_uid(),
                         OpRole.KEY: OpRole.Forward}))
                ctx.hit("conv_bn_fused")
                continue
        kept.append(op)
        for n in op.output_names():
            by_out[n] = op
    block.ops = kept
    return program


@register_pass("prune_feed_fetch_pass")
def prune_pass(program: Program, ctx: PassContext) -> Program:
    """analysis ir_graph_clean: keep only ops needed for the fetches."""
    fetches = getattr(program, "_fetch_names", None)
    if fetches:
        pruned = program._prune(fetches)
        pruned._feed_names = getattr(program, "_feed_names", None)
        pruned._fetch_names = fetches
        ctx.hit("prune_feed_fetch_pass")
        return pruned
    return program


DEFAULT_INFERENCE_PASSES = [
    "is_test_pass",
    "simplify_with_basic_ops_pass",
    "embedding_eltwise_layernorm_fuse_pass",
    "multihead_matmul_fuse_pass",
    "fc_fuse_pass",
    # after fc_fuse so frozen fake_dequantize -> fc chains are seen fused;
    # leaves float programs alone (fires only on real int8 weight vars)
    "quant_int8_pass",
    "conv_bn_fuse_pass",
    "prune_feed_fetch_pass",
]
