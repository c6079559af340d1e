"""Compile-time per-op FLOPs accounting: the exact denominator for MFU
and the auto-parallel planner's third cost substrate.

Until now the framework could not OBSERVE its own north-star metric:
`bench.py` guessed FLOPs with the analytic ``6*params + 12*L*s*h``
formula, and the planner had per-op HBM (`static/memory_analysis.py`)
and per-op wire bytes (`static.collective_wire_bytes`) but no per-op
compute cost.  This module walks the program IR — the same op list the
executor jits — and prices every op from its resolved shapes:

  * `analyze_flops(program, batch=...)` — per-op table + per-class and
    per-phase (forward / backward / optimize) totals.  Shape resolution
    is the memory walker's machinery (`memory_analysis._Sizer`):
    symbolic -1 batch dims bind to `batch`, derived names
    (``@GRAD``/``@RC``/...) borrow the base var's shape.
  * `peak_flops_per_chip()` — the MFU denominator's denominator: chip
    peak from ``PADDLE_TPU_PEAK_FLOPS`` (env), defaulting to the H100
    SXM's dense bf16 tensor-core peak (NVIDIA's data sheet) on a CUDA
    device and 0 (=unknown, MFU unreported) elsewhere.

Accounting conventions (chosen to agree with the analytic estimate the
whole perf record is denominated in — bench cross-checks the two and
warns on >10% drift):

  * matmul-class ops (``mul``/``matmul``/``matmul_v2``/conv) cost
    2·M·K·N multiply-accumulate FLOPs from their resolved operand
    shapes; a ``*_grad`` op costs 2× its forward op (dX and dY are each
    one forward-sized matmul).
  * attention cores (``flash_attention``/``ring_attention``/
    ``multihead_matmul`` and the materialized matmul+softmax path) cost
    the QKᵀ + PV matmuls: 4·B·S²·H forward per layer.  Flash backward
    recomputes blocks on the fly (~2.5× fwd on the chip); the walker
    still charges 2× — MODEL flops, the MFU convention — so a flash run
    reports the same MFU arithmetic as the XLA path.
  * embeddings (``lookup_table[_v2]``) are charged their DENSE
    one-hot-matmul equivalent (2·tokens·V·H fwd, 2× bwd), matching the
    ``6·params`` convention the baseline record uses.  The per-class
    breakdown keeps them separable (``by_class["embedding"]``) for a
    consumer that wants gather-true chip flops instead.
  * elementwise/normalization/loss ops carry a small per-element cost
    table; optimizer ops a per-param-element cost; collectives cost 0
    FLOPs here (their cost is wire bytes — `collective_wire_bytes`).

The per-op table is the planner substrate: every candidate program
rewrite (remat replays, ZeRO buckets, elastic folds) shows up as op-list
changes, so re-walking the rewritten program prices the candidate.

Port notes (paddle_tpu_torch): a copy of
paddle_tpu/static/flops_analysis.py; the cost tables and the walk are
verbatim.  Only the peak differs: the JAX package's default is its TPU's
rate, the port's the H100's data-sheet figures (not measurements).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from ..core.program import Program

__all__ = ["analyze_flops", "estimate_step_flops", "peak_flops_per_chip",
           "INT8_MXU_RATE",
           "PEAK_FLOPS_ENV", "H100_BF16_DENSE_PEAK_FLOPS"]

PEAK_FLOPS_ENV = "PADDLE_TPU_PEAK_FLOPS"

# NVIDIA H100 SXM dense bf16 tensor-core peak, 989 TFLOP/s: a data-sheet
# figure for that card, not a measurement (the MFU of PERF.md divides by it)
H100_BF16_DENSE_PEAK_FLOPS = 989e12

# int8 tensor-core rate over the bf16 peak on the same card, from the same
# data sheet (1,979 dense int8 TOP/s against 989 bf16 TFLOP/s): the
# calibrated roofline divides int8_flops by INT8_MXU_RATE*peak
INT8_MXU_RATE = 2.0


def peak_flops_per_chip() -> float:
    """Card peak FLOPs/s the MFU gauge divides by.  Env override
    ``PADDLE_TPU_PEAK_FLOPS`` wins; else the H100's data-sheet dense
    bf16 peak when a CUDA device is present, and 0 (= unknown; MFU is
    not reported) without one."""
    raw = os.environ.get(PEAK_FLOPS_ENV, "")
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    import torch
    return H100_BF16_DENSE_PEAK_FLOPS if torch.cuda.is_available() \
        else 0.0


# ---------------------------------------------------------------------------
# per-class cost tables
# ---------------------------------------------------------------------------
_MATMUL_OPS = frozenset(("mul", "matmul", "matmul_v2", "bmm",
                         "int8_matmul"))

_ATTENTION_OPS = frozenset(("flash_attention", "ring_attention",
                            "multihead_matmul"))

_EMBEDDING_OPS = frozenset(("lookup_table", "lookup_table_v2"))

_CONV_OPS = frozenset(("conv2d", "depthwise_conv2d", "conv2d_transpose",
                       "conv3d"))

# optimizer update cost per PARAM element (reads+muls+adds of the update
# rule; master-weight AMP variants ride the same table)
_OPTIMIZER_FLOPS_PER_ELEM = {
    "sgd": 2, "momentum": 4, "lars_momentum": 6, "dgc_momentum": 6,
    "adam": 12, "adamw": 14, "lamb": 16, "adamax": 10, "adagrad": 6,
    "decayed_adagrad": 8, "adadelta": 8, "rmsprop": 8, "ftrl": 8,
    "dpsgd": 6,
}

# forward cost per OUTPUT element for the cheap (near-)elementwise tier;
# anything recognizably elementwise but unlisted costs the default 1
_ELEMENTWISE_FLOPS_PER_ELEM = {
    "softmax": 5, "log_softmax": 6, "softmax_with_cross_entropy": 7,
    "sigmoid_cross_entropy_with_logits": 6, "cross_entropy": 4,
    "layer_norm": 8, "batch_norm": 8, "sync_batch_norm": 8,
    "gelu": 10, "tanh": 4, "sigmoid": 4, "exp": 4, "log": 4,
    "sqrt": 2, "rsqrt": 2, "square": 1, "relu": 1, "relu6": 2,
    "dropout": 2, "mean": 1, "sum": 1, "scale": 1, "clip": 2,
    "pow": 4, "elementwise_pow": 4,
}

# zero-cost layout/bookkeeping ops: charging their numel would double-
# count buffers the memory walker already treats as aliases
_FREE_OPS = frozenset((
    "reshape", "reshape2", "squeeze", "squeeze2", "unsqueeze",
    "unsqueeze2", "flatten", "flatten2", "flatten_contiguous_range",
    "transpose", "transpose2", "assign", "share_data", "shape",
    "optimization_barrier", "fill_constant", "fill_any_like",
    "fill_zeros_like", "feed", "fetch", "increment", "seed", "print",
    "py_func",
))


def _collective_ops() -> frozenset:
    from .verifier import _COLLECTIVE_OPS
    return _COLLECTIVE_OPS


def _prod(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return int(n)


class _Shaper:
    """name -> concrete shape tuple via the memory walker's resolver
    (-1 dims bind to batch; @GRAD/@RC/... borrow the base var)."""

    def __init__(self, block, batch: int):
        from .memory_analysis import _Sizer
        self._sizer = _Sizer(block, batch)
        self.batch = self._sizer.batch
        self.unknown: List[str] = []

    def __call__(self, name: Optional[str]) -> Optional[Tuple[int, ...]]:
        if not name:
            return None
        var = self._sizer.var_of(name)
        shape = var.shape if var is not None else None
        if shape is None:
            self.unknown.append(name)
            return None
        return tuple(self.batch if d in (-1, None) else int(d)
                     for d in shape)


def _first(op, slot):
    names = op.inputs.get(slot, [])
    return names[0] if names else None


def _first_out(op, slot):
    names = op.outputs.get(slot, [])
    return names[0] if names else None


def _matmul_flops(op, shaper, base: str) -> int:
    if base == "mul":
        sx = shaper(_first(op, "X"))
        sy = shaper(_first(op, "Y"))
        if sx is None or sy is None:
            return 0
        a = int(op.attrs.get("x_num_col_dims", 1))
        b = int(op.attrs.get("y_num_col_dims", 1))
        m = _prod(sx[:a])
        k = _prod(sx[a:])
        n = _prod(sy[b:])
        return 2 * m * k * n
    if base == "int8_matmul":
        # weight-only int8: X [..., K] contracts its last dim against
        # the int8 W [K, N] slot (there is no Y)
        sx = shaper(_first(op, "X"))
        sw = shaper(_first(op, "W"))
        if sx is None or sw is None or len(sw) < 2 or not sx:
            return 0
        return 2 * _prod(sx[:-1]) * sx[-1] * sw[-1]
    # matmul / matmul_v2 / bmm: batched [..., m, k] x [..., k, n]
    sx = shaper(_first(op, "X"))
    sy = shaper(_first(op, "Y"))
    if sx is None or sy is None or len(sx) < 2 or len(sy) < 2:
        return 0
    tx = bool(op.attrs.get("transpose_X", op.attrs.get("trans_x", False)))
    ty = bool(op.attrs.get("transpose_Y", op.attrs.get("trans_y", False)))
    m, k = (sx[-1], sx[-2]) if tx else (sx[-2], sx[-1])
    n = sy[-2] if ty else sy[-1]
    batch = max(_prod(sx[:-2]), _prod(sy[:-2]))
    return 2 * batch * m * k * n


def _attention_flops(op, shaper, base: str) -> int:
    sq = shaper(_first(op, "Q")) if base != "multihead_matmul" \
        else shaper(_first(op, "Input"))
    if sq is None:
        return 0
    if base == "flash_attention":
        # Q [B, H, S, D]: QK^T + PV, 2*(B*H*S*S*D) MACs each
        if len(sq) < 4:
            return 0
        b, h, s, d = sq[-4], sq[-3], sq[-2], sq[-1]
        return 4 * b * h * s * s * d
    if base == "ring_attention":
        # Q [B, S, H*D]: head split preserves total MACs
        if len(sq) < 3:
            return 0
        b, s, hd = sq[-3], sq[-2], sq[-1]
        return 4 * b * s * s * hd
    # multihead_matmul: fused QKV projections + attention core over
    # Input [B, S, H] with weights [H, H]
    if len(sq) < 3:
        return 0
    b, s, h = sq[-3], sq[-2], sq[-1]
    return 3 * 2 * b * s * h * h + 4 * b * s * s * h


def _embedding_flops(op, shaper) -> int:
    """Dense one-hot-matmul equivalent (see module docstring): tokens ×
    table, 2 FLOPs per MAC."""
    sw = shaper(_first(op, "W"))
    ids = shaper(_first(op, "Ids"))
    if sw is None or len(sw) < 2:
        # grad ops keep the W slot; fall back to the minted W@GRAD
        sw = shaper(_first_out(op, "W@GRAD"))
    if sw is None or ids is None or len(sw) < 2:
        return 0
    return 2 * _prod(ids) * _prod(sw[-2:])


def _conv_flops(op, shaper) -> int:
    sf = shaper(_first(op, "Filter"))
    so = shaper(_first_out(op, "Output") or _first_out(op, "Out"))
    if so is None:
        so = shaper(_first(op, "Input"))
    if sf is None or so is None or not sf:
        return 0
    macs_per_out = _prod(sf) // max(1, int(sf[0]))
    return 2 * _prod(so) * macs_per_out


def _optimizer_flops(op, shaper) -> int:
    per = _OPTIMIZER_FLOPS_PER_ELEM[op.type]
    sp = shaper(_first(op, "Param") or _first(op, "param"))
    if sp is None:
        return 0
    return per * _prod(sp)


def _elementwise_flops(op, shaper, base_type: str) -> int:
    per = _ELEMENTWISE_FLOPS_PER_ELEM.get(base_type, 1)
    best = 0
    for slot, names in op.outputs.items():
        for n in names:
            s = shaper(n)
            if s is not None:
                best = max(best, _prod(s))
    if best == 0:
        for slot, names in op.inputs.items():
            for n in names:
                s = shaper(n)
                if s is not None:
                    best = max(best, _prod(s))
    if base_type == "sum":
        # n-way elementwise accumulate: (n-1) adds per element
        k = max(1, sum(len(v) for v in op.inputs.values()) - 1)
        return k * best
    return per * best


def _classify(op_type: str) -> Tuple[str, str]:
    """(class, base forward type) — a ``*_grad`` op inherits its forward
    op's class and is priced at 2× the forward cost."""
    base = op_type[:-len("_grad")] if op_type.endswith("_grad") else op_type
    if base in _MATMUL_OPS:
        return "matmul", base
    if base in _ATTENTION_OPS:
        return "attention", base
    if base in _EMBEDDING_OPS:
        return "embedding", base
    if base in _CONV_OPS:
        return "conv", base
    if base in _OPTIMIZER_FLOPS_PER_ELEM:
        return "optimizer", base
    if base in _collective_ops():
        return "collective", base
    if base in _FREE_OPS:
        return "free", base
    return "elementwise", base


def _op_flops(op, shaper) -> Tuple[int, str]:
    cls, base = _classify(op.type)
    grad = op.type.endswith("_grad")
    if cls == "free" or cls == "collective":
        return 0, cls
    if cls == "matmul":
        f = _matmul_flops(op, shaper, base)
    elif cls == "attention":
        f = _attention_flops(op, shaper, base)
    elif cls == "embedding":
        f = _embedding_flops(op, shaper)
    elif cls == "conv":
        f = _conv_flops(op, shaper)
    elif cls == "optimizer":
        f = _optimizer_flops(op, shaper)
    else:
        f = _elementwise_flops(op, shaper, base)
    if grad:
        f *= 2
    return int(f), cls


def analyze_flops(program: Program, batch: Optional[int] = None) -> Dict:
    """Per-op FLOPs report for `program`'s global block.

    Returns a dict with ``total_flops`` (one training step, all phases),
    ``phase_flops`` (forward / backward / optimize — fwd+bwd are the MFU
    numerator; the optimize slice is per-step, not per-token),
    ``by_class`` (matmul / attention / embedding / conv / elementwise /
    optimizer), the full ``per_op`` table (block, index, type, class,
    phase, flops — the planner substrate), ``matmul_fraction`` (how
    MXU-bound the step is), and bookkeeping (``batch``, ``n_ops``,
    ``n_unknown_vars``).

    `batch` binds symbolic -1 dims; defaults to ``FLAGS_hbm_assume_batch``
    when set, else 1 — pass the real batch for totals that mean anything
    (FLOPs scale linearly in it, unlike the HBM walk).
    """
    from ..core.flags import flag
    from .memory_analysis import _phase_of
    if batch is None:
        batch = int(flag("hbm_assume_batch", 0)) or 1
    block = program.global_block()
    shaper = _Shaper(block, batch)

    per_op: List[Dict] = []
    by_class: Dict[str, int] = {}
    phase_flops = {"forward": 0, "backward": 0, "optimize": 0}
    total = 0
    int8 = 0
    for i, op in enumerate(block.ops):
        if op.type in ("feed", "fetch"):
            continue
        f, cls = _op_flops(op, shaper)
        phase = _phase_of(op)
        per_op.append({"block": block.idx, "index": i, "type": op.type,
                       "class": cls, "phase": phase, "flops": int(f)})
        if f:
            by_class[cls] = by_class.get(cls, 0) + f
            phase_flops[phase] += f
            total += f
            if op.type == "int8_matmul":
                int8 += f
    matmul_like = (by_class.get("matmul", 0) + by_class.get("attention", 0)
                   + by_class.get("conv", 0))
    return {
        "batch": int(shaper.batch),
        "total_flops": int(total),
        # the slice running at the int8 MXU rate (INT8_MXU_RATE x peak);
        # roofline compute time = (total - int8)/peak + int8/(rate*peak)
        "int8_flops": int(int8),
        "phase_flops": {k: int(v) for k, v in phase_flops.items()},
        "by_class": {k: int(v) for k, v in sorted(by_class.items())},
        "per_op": per_op,
        "matmul_fraction": (matmul_like / total) if total else 0.0,
        "n_ops": len(per_op),
        "n_unknown_vars": len(set(shaper.unknown)),
    }


def estimate_step_flops(program: Program,
                        batch: Optional[int] = None) -> int:
    """Total FLOPs of one training step of `program` (forward + backward
    + optimizer; see `analyze_flops` for the breakdown)."""
    return analyze_flops(program, batch=batch)["total_flops"]
