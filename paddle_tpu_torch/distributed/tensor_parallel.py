"""Tensor (model) parallelism: Megatron-style column/row parallel layers.

Counterpart of paddle_tpu/distributed/tensor_parallel.py: the builders
emit the JAX package's ops, attrs and stamps, so a program builds equal
in both packages.  In the port a tp rank is a process: under
CompiledProgram(BuildStrategy.tensor_parallel_degree=tp) ring
TP_RING_ID is that rank's tp group, a `dist_attr` parameter lives in the
rank's scope as its own shard, and the two collectives are the group's
(ops/kernels/collective.py).  The text below is the JAX package's.

The reference has NO tensor parallelism (SURVEY.md §2.3 "NOT present");
this is the TPU-native extension the north star calls for: weights are
sharded over a "tp" mesh axis, shard_map splits/reassembles the global
arrays held in the scope (checkpointing sees full tensors), and the two
collectives are the classic conjugate pair:

  * column-parallel fc — weight [in, out/tp]; the input passes through
    `c_identity` (fwd identity, bwd allreduce over tp — the Megatron "f");
    output stays sharded on the feature dim unless `gather_output`.
  * row-parallel fc — weight [in/tp, out] consuming a feature-sharded
    input; the partial products `c_allreduce_sum` over tp (the "g"; its
    backward is the broadcast identity).

Sharding is declared on the VarDesc (`dist_attr = [axis_name, dim]`);
CompiledProgram turns the annotation into shard_map in/out specs for the
parameter state (optimizer moments inherit by name prefix + shape).

Static-analysis surface: every op a builder emits is stamped with
``mp_axis`` (+ ``tp_degree`` when the caller declared one) and each
builder call records itself in the applied-passes registry
(`core/pass_framework.record_applied`, pass name "tensor_parallel") —
so the sharding-propagation analyzer (`static/layout_analysis.py`), the
V50x composition checks and the per-ring wire pricer see tensor-parallel
structure instead of anonymous ops.

Composes as in Megatron MLP/attention blocks: col(fc) → activation →
row(fc) leaves activations replicated again at block boundaries.
"""
from __future__ import annotations

import numpy as np

from ..core.program import VarDesc
from ..static.layer_helper import LayerHelper

__all__ = ["col_parallel_fc", "row_parallel_fc", "parallel_attention",
           "tp_identity", "TP_RING_ID", "MP_AXIS", "shard_param"]

# reserved ring binding the tensor-parallel mesh axis (sp uses 101)
TP_RING_ID = 102

# the canonical model-parallel axis name the layout analyzer speaks
# (the runtime axis is spelled "tp" — same axis, CompiledProgram binds
# TP_RING_ID to it); both spellings come from the shared canonicalizer
# so the stamp and the runtime mesh can never drift
from ..core.mesh_axes import MP_AXIS_CANONICAL as MP_AXIS
from ..core.mesh_axes import MP_AXIS_RUNTIME as _TP_AXIS


def shard_param(var: VarDesc, dim: int, axis: str = _TP_AXIS) -> VarDesc:
    """Annotate a parameter as sharded over `axis` at `dim` (runtime
    spelling; the layout analyzer canonicalizes via core/mesh_axes)."""
    var.attrs["dist_attr"] = [axis, int(dim)]
    return var


def _stamp(op, tp_degree=None):
    """Mark a builder-emitted op as tensor-parallel structure: the mesh
    axis it rides and (when declared at build time) the tp degree the
    caller is planning for — the analyzer's axis resolution and the
    per-ring wire pricer both read these."""
    op.attrs["mp_axis"] = MP_AXIS
    if tp_degree:
        op.attrs["tp_degree"] = int(tp_degree)
    return op


def _record_build(helper, builder: str, tp_degree=None, params=()):
    from ..core.pass_framework import record_applied
    record_applied(helper.main_program, "tensor_parallel",
                   builder=builder, layer=helper.name,
                   tp_degree=int(tp_degree or 0),
                   params=[p.name for p in params if p is not None])


def tp_identity(input, name=None, tp_degree=None):
    """The Megatron f-operator standalone: identity forward, allreduce
    over tp backward.  Apply ONCE per replicated block input when several
    column-parallel projections share it (parallel_attention's q/k/v) —
    the autodiff then sums their input grads before a single allreduce."""
    helper = LayerHelper("tp_identity", name=name)
    xid = helper.create_variable_for_type_inference(input.dtype)
    _stamp(helper.append_op("c_identity", {"X": [input]}, {"Out": [xid]},
                            {"ring_id": TP_RING_ID}), tp_degree)
    return xid


def col_parallel_fc(input, size, num_flatten_dims=1, param_attr=None,
                    bias_attr=None, act=None, gather_output=False,
                    input_is_identity=False, tp_degree=None, name=None):
    """fc with the OUTPUT features split over tp.  `size` is the GLOBAL
    output width (must divide by the tp degree); the runtime shard is
    size/tp.  Output is feature-sharded unless gather_output.
    `input_is_identity`: the caller already applied tp_identity (shared
    block input) — skip the per-layer f-op.  `tp_degree` (optional) is a
    build-time declaration only — stamped onto the emitted ops for the
    static analyzers; the runtime degree still comes from the mesh."""
    helper = LayerHelper("col_parallel_fc", name=name)
    in_features = int(np.prod(input.shape[num_flatten_dims:]))
    w = helper.create_parameter(param_attr, [in_features, size],
                                input.dtype)
    shard_param(w, dim=1)
    # Megatron f: identity fwd, allreduce-over-tp bwd (grads of the
    # replicated input must sum the per-shard contributions)
    xid = input if input_is_identity else tp_identity(input,
                                                     tp_degree=tp_degree)
    out = helper.create_variable_for_type_inference(input.dtype)
    _stamp(helper.append_op("mul", {"X": [xid], "Y": [w]}, {"Out": [out]},
                            {"x_num_col_dims": num_flatten_dims,
                             "y_num_col_dims": 1}), tp_degree)
    b = helper.create_parameter(bias_attr, [size], input.dtype,
                                is_bias=True)
    if b is not None:
        shard_param(b, dim=0)
        tmp = helper.create_variable_for_type_inference(out.dtype)
        _stamp(helper.append_op("elementwise_add", {"X": [out], "Y": [b]},
                                {"Out": [tmp]},
                                {"axis": len(out.shape) - 1}), tp_degree)
        out = tmp
    if gather_output:
        g = helper.create_variable_for_type_inference(out.dtype)
        _stamp(helper.append_op("c_concat", {"X": [out]}, {"Out": [g]},
                                {"ring_id": TP_RING_ID}), tp_degree)
        out = g
    _record_build(helper, "col_parallel_fc", tp_degree, (w, b))
    return helper.append_activation(out, act)


def row_parallel_fc(input, size, num_flatten_dims=1, param_attr=None,
                    bias_attr=None, act=None, input_is_parallel=True,
                    in_features=None, tp_degree=None, name=None):
    """fc with the INPUT features split over tp (consumes a
    col_parallel_fc output); the partial results allreduce over tp, so
    the output is replicated.  Weight global shape is [in, size] with in
    = the GLOBAL feature width — inferred from the build-time input shape
    (which col_parallel_fc keeps global), or passed via `in_features`
    when the build-time shape is already the local shard (e.g. the
    reshaped per-head context in parallel_attention)."""
    helper = LayerHelper("row_parallel_fc", name=name)
    if not input_is_parallel:
        raise NotImplementedError(
            "row_parallel_fc expects a tp-sharded input "
            "(col_parallel_fc output); scatter-on-entry is not built")
    if in_features is None:
        in_features = int(np.prod(input.shape[num_flatten_dims:]))
    w = helper.create_parameter(param_attr, [in_features, size],
                                input.dtype)
    shard_param(w, dim=0)
    part = helper.create_variable_for_type_inference(input.dtype)
    _stamp(helper.append_op("mul", {"X": [input], "Y": [w]},
                            {"Out": [part]},
                            {"x_num_col_dims": num_flatten_dims,
                             "y_num_col_dims": 1}), tp_degree)
    if part.shape is None:
        # abstract eval can't reconcile a local-shard input width with the
        # global weight (e.g. parallel_attention's reshaped context) —
        # the out shape is known regardless
        part.shape = tuple(input.shape[:num_flatten_dims]) + (size,)
        part.dtype = input.dtype
    # Megatron g: sum the partial products; backward is identity
    out = helper.create_variable_for_type_inference(input.dtype)
    _stamp(helper.append_op("mp_allreduce_sum", {"X": [part]},
                            {"Out": [out]},
                            {"ring_id": TP_RING_ID}), tp_degree)
    if out.shape is None:
        out.shape = part.shape
        out.dtype = part.dtype
    b = helper.create_parameter(bias_attr, [size], input.dtype,
                                is_bias=True)
    if b is not None:  # replicated bias, added after the reduce
        tmp = helper.create_variable_for_type_inference(out.dtype)
        helper.append_op("elementwise_add", {"X": [out], "Y": [b]},
                         {"Out": [tmp]}, {"axis": len(out.shape) - 1})
        out = tmp
    _record_build(helper, "row_parallel_fc", tp_degree, (w, b))
    return helper.append_activation(out, act)


def parallel_attention(x, hidden, num_heads, tp_degree, dropout_rate=0.0,
                       param_attrs=None, name=None):
    """Megatron parallel self-attention block: three column-parallel
    q/k/v projections (each head shard lands whole on one tp rank — a
    fused qkv column shard would slice across q/k/v), local multi-head
    attention over num_heads/tp heads, row-parallel output projection.

    `tp_degree` is needed at BUILD time because the per-shard reshape
    dims (heads/tp) are static attrs; x is [batch, time, hidden]
    replicated, the return is [batch, time, hidden] replicated.
    """
    from ..static import layers
    if num_heads % tp_degree:
        raise ValueError(
            f"num_heads={num_heads} must divide by tp_degree={tp_degree}")
    if hidden % num_heads:
        raise ValueError("hidden must divide by num_heads")
    if x.shape[1] is None or x.shape[1] == -1:
        raise ValueError(
            "parallel_attention needs a static time dim (x.shape[1]) — "
            "the per-head reshape bakes it into the graph")
    if param_attrs is not None and len(param_attrs) != 4:
        raise ValueError(
            "param_attrs must hold exactly 4 entries (q, k, v, out "
            f"projections), got {len(param_attrs)}")
    pa = list(param_attrs) if param_attrs else [None] * 4
    pfx = (name + "_") if name else ""
    # ONE f-op for the shared block input: q/k/v input grads sum before a
    # single tp allreduce instead of three
    xid = tp_identity(x, name=pfx + "f" if pfx else None,
                      tp_degree=tp_degree)
    q = col_parallel_fc(xid, hidden, num_flatten_dims=2, param_attr=pa[0],
                        input_is_identity=True, tp_degree=tp_degree,
                        name=pfx + "q" if pfx else None)
    k = col_parallel_fc(xid, hidden, num_flatten_dims=2, param_attr=pa[1],
                        input_is_identity=True, tp_degree=tp_degree,
                        name=pfx + "k" if pfx else None)
    v = col_parallel_fc(xid, hidden, num_flatten_dims=2, param_attr=pa[2],
                        input_is_identity=True, tp_degree=tp_degree,
                        name=pfx + "v" if pfx else None)

    h_loc = num_heads // tp_degree
    d_key = hidden // num_heads
    t = x.shape[1]

    def _split(z):  # [b, t, h_loc*d] local -> [b, h_loc, t, d]
        z = layers.reshape(z, [-1, t, h_loc, d_key])
        # build-time shapes upstream are GLOBAL while these dims are the
        # local shard — abstract eval bails, but the target is known
        z.shape = (-1, t, h_loc, d_key)
        return layers.transpose(z, [0, 2, 1, 3])

    from ..static import nets
    ctx = nets.attention_core(_split(q), _split(k), _split(v), d_key,
                              dropout_rate,
                              merge_shape=(t, h_loc * d_key))
    out = row_parallel_fc(ctx, hidden, num_flatten_dims=2,
                          in_features=hidden, param_attr=pa[3],
                          tp_degree=tp_degree,
                          name=pfx + "out" if pfx else None)
    from ..core.pass_framework import record_applied
    from ..core.program import default_main_program
    record_applied(default_main_program(), "tensor_parallel",
                   builder="parallel_attention",
                   layer=name or "parallel_attention",
                   tp_degree=int(tp_degree), num_heads=int(num_heads))
    return out
