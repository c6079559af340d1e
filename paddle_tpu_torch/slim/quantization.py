"""Quantization passes: QAT transform, freeze, weight-only int8 freeze and
post-training quantization (PTQ).

Counterpart of paddle_tpu/slim/quantization.py, with the same rewrites,
var names and op uids, so a program transformed by either package
serializes to the same string:

  * QuantizationTransformPass inserts fake quant-dequant ops on the
    inputs of quantizable ops (weights channel-wise, activations by a
    moving-average scale);
  * QuantizationFreezePass turns each fake-quantized weight into a real
    int8 var in the scope with a fake_dequantize op in front;
  * freeze_weights_int8 rewrites a float inference program's weight
    matmuls into int8_matmul (deterministic `w.int8` / `w.deq_scale`
    names);
  * PostTrainingQuantization calibrates per-tensor activation abs-max
    from sample batches (fetched to numpy, as the JAX package does),
    then transforms and freezes.

Weights are quantized through the registered kernels
(`fake_channel_wise_quantize_abs_max` / `fake_quantize_abs_max`) on the
device the weight lives on; the int8 tensors and fp32 scales the passes
write into the scope stay on that device.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from ..core.program import Program, OpDesc, OpRole, unique_name
from ..ops.registry import OpContext, run_kernel

__all__ = ["QuantizationTransformPass", "QuantizationFreezePass",
           "PostTrainingQuantization", "QUANTIZABLE_OPS",
           "freeze_weights_int8"]

# the reference QuantizationTransformPass._supported_quantizable_op_type
QUANTIZABLE_OPS = ("conv2d", "depthwise_conv2d", "mul", "matmul", "fc")

# op -> input slots that carry quantizable float tensors
_QUANT_SLOTS = {
    "conv2d": ("Input", "Filter"),
    "depthwise_conv2d": ("Input", "Filter"),
    "mul": ("X", "Y"),
    "matmul": ("X", "Y"),
    "fc": ("Input", "W"),
}

# weight slot per op (channel-wise axis 0 for conv filters, 1 for matmul W)
_WEIGHT_SLOTS = {"Filter": 0, "Y": 1, "W": 1}


def _is_param(block, name):
    try:
        return block.var(name).is_parameter
    except KeyError:
        return False


def _quantize_weight(w: torch.Tensor, op_type: str, attrs: Dict):
    """Quantize a weight through the registered kernel on its device:
    returns (int8 tensor, fp32 scale tensor)."""
    r = run_kernel(op_type, {"X": w.float()}, attrs,
                   OpContext(device=w.device))
    return r["Out"].to(torch.int8), r["OutScale"].float()


class QuantizationTransformPass:
    """Insert fake quant-dequant on the inputs of quantizable ops (QAT).

    Apply BEFORE minimize() / append_backward so the straight-through
    grad ops are generated for the inserted ops.  `startup_program`
    receives the fill_constant initializers of the activation-scale state
    vars."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 weight_quantize_type="channel_wise_abs_max",
                 activation_quantize_type="moving_average_abs_max",
                 moving_rate=0.9, quantizable_op_type=QUANTIZABLE_OPS,
                 skip_pattern="skip_quant"):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.weight_quantize_type = weight_quantize_type
        self.activation_quantize_type = activation_quantize_type
        self.moving_rate = moving_rate
        self.ops = tuple(quantizable_op_type)
        self.skip_pattern = skip_pattern

    def _quant_weight(self, block, name, axis, new_ops, cache):
        if name in cache:
            return cache[name]
        v = block.var(name)
        qname = unique_name(name + ".quantized.dequantized")
        block.create_var(name=qname, shape=v.shape, dtype=v.dtype,
                         stop_gradient=False)
        sname = unique_name(name + ".quant_scale")
        block.create_var(name=sname, stop_gradient=True)
        if self.weight_quantize_type == "channel_wise_abs_max":
            op_type = "fake_channel_wise_quantize_dequantize_abs_max"
            attrs = {"bit_length": self.weight_bits, "quant_axis": axis}
        else:
            op_type = "fake_quantize_dequantize_abs_max"
            attrs = {"bit_length": self.weight_bits}
        attrs[OpRole.KEY] = OpRole.Forward
        attrs["op_uid"] = block.program._next_uid()
        new_ops.append(OpDesc(op_type, {"X": [name]},
                              {"Out": [qname], "OutScale": [sname]}, attrs))
        cache[name] = qname
        return qname

    def _quant_act(self, block, startup, name, new_ops, cache):
        if name in cache:
            return cache[name]
        v = block.var(name)
        qname = unique_name(name + ".quantized.dequantized")
        block.create_var(name=qname, shape=v.shape, dtype=v.dtype,
                         stop_gradient=False)
        if self.activation_quantize_type == "abs_max":
            # dynamic per-batch quantization: no tracked state
            attrs = {"bit_length": self.activation_bits,
                     OpRole.KEY: OpRole.Forward,
                     "op_uid": block.program._next_uid()}
            sname = unique_name(name + ".quant_scale")
            block.create_var(name=sname, stop_gradient=True)
            new_ops.append(OpDesc("fake_quantize_dequantize_abs_max",
                                  {"X": [name]},
                                  {"Out": [qname], "OutScale": [sname]},
                                  attrs))
            cache[name] = qname
            return qname
        if self.activation_quantize_type != "moving_average_abs_max":
            raise ValueError(
                f"unsupported activation_quantize_type "
                f"{self.activation_quantize_type!r} (use 'abs_max' or "
                f"'moving_average_abs_max')")
        scale = unique_name(name + ".quant_scale")
        state = unique_name(name + ".quant_state")
        accum = unique_name(name + ".quant_accum")
        for n, init in ((scale, 0.001), (state, 1.0), (accum, 0.001)):
            block.create_var(name=n, shape=(1,), dtype="float32",
                             persistable=True, stop_gradient=True)
            if startup is not None:
                sb = startup.global_block()
                if not sb.has_var(n):
                    sb.create_var(name=n, shape=(1,), dtype="float32",
                                  persistable=True, stop_gradient=True)
                    sb.append_op("fill_constant", {}, {"Out": [n]},
                                 {"shape": [1], "dtype": "float32",
                                  "value": init})
        attrs = {"bit_length": self.activation_bits,
                 "moving_rate": self.moving_rate,
                 OpRole.KEY: OpRole.Forward,
                 "op_uid": block.program._next_uid()}
        new_ops.append(OpDesc(
            "fake_quantize_dequantize_moving_average_abs_max",
            {"X": [name], "InScale": [scale], "InState": [state],
             "InAccum": [accum]},
            {"Out": [qname], "OutScale": [scale], "OutState": [state],
             "OutAccum": [accum]}, attrs))
        cache[name] = qname
        return qname

    def apply(self, program: Program,
              startup_program: Optional[Program] = None) -> Program:
        block = program.global_block()
        cache: Dict[str, str] = {}
        new_ops: List[OpDesc] = []
        n_quant = 0
        for op in block.ops:
            if op.type in self.ops and \
                    not op.attrs.get(self.skip_pattern, False):
                for slot in _QUANT_SLOTS.get(op.type, ()):
                    names = op.inputs.get(slot, [])
                    if not names:
                        continue
                    name = names[0]
                    if _is_param(block, name):
                        q = self._quant_weight(
                            block, name, _WEIGHT_SLOTS.get(slot, 0),
                            new_ops, cache)
                    else:
                        q = self._quant_act(block, startup_program, name,
                                            new_ops, cache)
                    op.inputs[slot] = [q]
                    n_quant += 1
            new_ops.append(op)
        block.ops = new_ops
        program._fingerprint_cache = None
        program._n_quantized_inputs = n_quant
        return program


class QuantizationFreezePass:
    """Freeze a trained or calibrated QAT inference program: each
    fake-quantized weight becomes a real int8 var in the scope with a
    fake_dequantize_max_abs (or its channel-wise form) in front."""

    def __init__(self, weight_bits=8):
        self.weight_bits = weight_bits

    def apply(self, program: Program, scope) -> Program:
        block = program.global_block()
        b = float((1 << (self.weight_bits - 1)) - 1)
        new_ops: List[OpDesc] = []
        for op in block.ops:
            if op.type in ("fake_quantize_dequantize_abs_max",
                           "fake_channel_wise_quantize_dequantize_abs_max") \
                    and _is_param(block, op.inputs["X"][0]):
                wname = op.inputs["X"][0]
                out = op.outputs["Out"][0]
                w = torch.as_tensor(scope.get(wname))
                # through the registered kernel: the int8 grid is the one
                # QAT trained against
                if op.type.startswith("fake_channel_wise"):
                    axis = op.attrs.get("quant_axis", 0)
                    q, scale = _quantize_weight(
                        w, "fake_channel_wise_quantize_abs_max",
                        {"bit_length": self.weight_bits, "quant_axis": axis})
                    deq_type = "fake_channel_wise_dequantize_max_abs"
                    sc_slot = "Scales"
                    attrs = {"max_range": b, "quant_axis": axis}
                else:
                    q, scale = _quantize_weight(
                        w, "fake_quantize_abs_max",
                        {"bit_length": self.weight_bits})
                    deq_type = "fake_dequantize_max_abs"
                    sc_slot = "Scale"
                    attrs = {"max_range": b}
                iname = unique_name(wname + ".int8")
                sname = unique_name(wname + ".deq_scale")
                block.create_var(name=iname, shape=list(q.shape),
                                 dtype="int8", persistable=True,
                                 stop_gradient=True)
                block.create_var(name=sname, shape=list(scale.shape),
                                 dtype="float32", persistable=True,
                                 stop_gradient=True)
                scope.set(iname, q)
                scope.set(sname, scale)
                attrs[OpRole.KEY] = OpRole.Forward
                attrs["op_uid"] = block.program._next_uid()
                new_ops.append(OpDesc(
                    deq_type, {"X": [iname], sc_slot: [sname]},
                    {"Out": [out]}, attrs))
                # the float weight leaves the PROGRAM only (its persistables
                # shrink 4x); the scope keeps it for programs sharing it
                block.vars.pop(wname, None)
                continue
            new_ops.append(op)
        block.ops = new_ops
        program._fingerprint_cache = None
        return program


def freeze_weights_int8(program, scope, predicate=None,
                        weight_bits: int = 8) -> int:
    """Weight-only int8 freeze of an INFERENCE program: every
    mul / matmul / matmul_v2 whose weight is a 2-D persistable contracted
    over its input's LAST dim becomes one int8_matmul (int8 weights and
    per-out-channel fp32 scales in the scope, activations quantized per
    tensor inside the op).  Deterministic names (`w + ".int8"`,
    `w + ".deq_scale"`), so programs sharing one scope resolve to the same
    quantized copy.  `predicate(op, weight_name)` narrows the rewrite set.
    Returns the number of matmuls rewritten."""
    block = program.global_block()
    b = float((1 << (int(weight_bits) - 1)) - 1)
    new_ops: List[OpDesc] = []
    n_rewritten = 0
    for op in block.ops:
        if op.type == "mul":
            ok = int(op.attrs.get("y_num_col_dims", 1)) == 1
        elif op.type in ("matmul", "matmul_v2"):
            tx = any(op.attrs.get(k, False) for k in
                     ("transpose_X", "transpose_x", "trans_x"))
            ty = any(op.attrs.get(k, False) for k in
                     ("transpose_Y", "transpose_y", "trans_y"))
            ok = not tx and not ty \
                and float(op.attrs.get("alpha", 1.0)) == 1.0
        else:
            new_ops.append(op)
            continue
        wname = (op.inputs.get("Y") or [None])[0]
        xname = (op.inputs.get("X") or [None])[0]
        if not (ok and wname and xname and _is_param(block, wname)):
            new_ops.append(op)
            continue
        wvar = block.var(wname)
        if wvar.shape is None or len(wvar.shape) != 2:
            new_ops.append(op)
            continue
        xvar = block.var(xname) if block.has_var(xname) else None
        xshape = getattr(xvar, "shape", None)
        if op.type == "mul":
            # int8_matmul contracts the LAST dim; mul flattens X[m:]:
            # the same only when that tail is one dim
            m = int(op.attrs.get("x_num_col_dims", 1))
            if xshape is None or m != len(xshape) - 1:
                new_ops.append(op)
                continue
        if predicate is not None and not predicate(op, wname):
            new_ops.append(op)
            continue
        iname = wname + ".int8"
        sname = wname + ".deq_scale"
        if scope.get(iname) is None:
            w = scope.get(wname)
            if w is None:
                new_ops.append(op)
                continue
            q, scale = _quantize_weight(
                torch.as_tensor(w), "fake_channel_wise_quantize_abs_max",
                {"bit_length": int(weight_bits), "quant_axis": 1})
            scope.set(iname, q)
            scope.set(sname, scale)
        if not block.has_var(iname):
            iv = block.create_var(name=iname, shape=list(wvar.shape),
                                  dtype="int8", persistable=True,
                                  stop_gradient=True)
            sv = block.create_var(name=sname, shape=[wvar.shape[1]],
                                  dtype="float32", persistable=True,
                                  stop_gradient=True)
            dist = wvar.attrs.get("dist_attr")
            if dist is not None:
                iv.attrs["dist_attr"] = list(dist)
                if int(dist[1]) == 1:
                    # column-parallel: the per-channel scales shard with
                    # the out-channels
                    sv.attrs["dist_attr"] = [dist[0], 0]
        attrs = {"max_range": b, OpRole.KEY: OpRole.Forward,
                 "op_uid": block.program._next_uid()}
        for key in ("mp_axis", "tp_degree"):
            if key in op.attrs:
                attrs[key] = op.attrs[key]
        new_ops.append(OpDesc(
            "int8_matmul",
            {"X": [xname], "W": [iname], "WScale": [sname]},
            {"Out": op.outputs["Out"]}, attrs))
        # the fp32 weight leaves the PROGRAM; the scope keeps it for
        # programs sharing it
        block.vars.pop(wname, None)
        n_rewritten += 1
    block.ops = new_ops
    program._fingerprint_cache = None
    return n_rewritten


class PostTrainingQuantization:
    """PTQ: run calibration batches through a float inference program,
    record each quantized activation's abs-max, and return the
    transformed and frozen program (its int8 weights and calibrated
    scales in the scope).

        ptq = PostTrainingQuantization(exe, infer_prog, feed_names, scope)
        quant_prog = ptq.quantize(calib_feed_iter)
    """

    def __init__(self, executor, program: Program, feed_names: List[str],
                 scope=None, algo: str = "abs_max", weight_bits=8,
                 activation_bits=8,
                 quantizable_op_type=QUANTIZABLE_OPS):
        from ..static.executor import global_scope
        if algo != "abs_max":
            raise ValueError(f"unsupported PTQ algo {algo!r}")
        self.exe = executor
        self.program = program
        self.feed_names = list(feed_names)
        self.scope = scope or global_scope()
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.ops = tuple(quantizable_op_type)

    def _activation_targets(self) -> List[str]:
        block = self.program.global_block()
        targets = []
        for op in block.ops:
            if op.type not in self.ops:
                continue
            for slot in _QUANT_SLOTS.get(op.type, ()):
                for n in op.inputs.get(slot, []):
                    if n and not _is_param(block, n) and n not in targets:
                        targets.append(n)
        return targets

    def _scalar(self, value: float) -> torch.Tensor:
        return torch.tensor([value], dtype=torch.float32,
                            device=self.exe.device)

    def quantize(self, calib_feeds: Iterable[Dict[str, np.ndarray]],
                 max_batches: Optional[int] = None) -> Program:
        if any(op.type.startswith("fake_quantize")
               or op.type.startswith("fake_channel_wise_quantize")
               for op in self.program.global_block().ops):
            raise ValueError(
                "PostTrainingQuantization expects a FLOAT inference "
                "program; this one already contains fake-quant ops (QAT). "
                "Use QuantizationFreezePass on it directly instead.")
        targets = self._activation_targets()
        maxes = {n: 0.0 for n in targets}
        for i, feed in enumerate(calib_feeds):
            if max_batches is not None and i >= max_batches:
                break
            vals = self.exe.run(self.program, feed=feed,
                                fetch_list=targets, scope=self.scope)
            for n, v in zip(targets, vals):
                maxes[n] = max(maxes[n], float(np.abs(v).max()))

        quant = self.program.clone(for_test=True)
        QuantizationTransformPass(
            weight_bits=self.weight_bits,
            activation_bits=self.activation_bits,
            quantizable_op_type=self.ops).apply(quant, startup_program=None)
        # the calibrated scales go to the InScale vars, and the activation
        # quant ops flip to is_test so they read them
        for op in quant.global_block().ops:
            if op.type == "fake_quantize_dequantize_moving_average_abs_max":
                base = op.inputs["X"][0].split(".quantized.dequantized")[0]
                amax = max(maxes.get(base, 0.0), 1e-8)
                op.attrs["is_test"] = True
                self.scope.set(op.inputs["InScale"][0], self._scalar(amax))
                # the state vars have no initializer anywhere (the
                # transform ran without a startup program): give them
                # values so save_inference_model can persist them
                self.scope.set(op.inputs["InState"][0], self._scalar(1.0))
                self.scope.set(op.inputs["InAccum"][0], self._scalar(amax))
        QuantizationFreezePass(self.weight_bits).apply(quant, self.scope)
        quant._fingerprint_cache = None
        return quant
