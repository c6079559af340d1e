"""Static-graph layer functions: the subset of the fluid.layers API that
the BERT encoder and its pretraining program (`models/bert_static.py`),
the BASELINE configs' programs (`models/baseline_static.py`: conv2d,
pool2d, batch_norm, relu, one_hot, label_smooth), the score-matrix
attention graph, dropout, the optimizers, gradient clipping, the
regularizers and the AMP rewrite use.

Each function is a copy of its namesake in paddle_tpu/static/layers.py, so
both packages append the same ops with the same attrs, parameter names
and initializers; a Program built here serializes equal to the one the
JAX package builds.  Layers outside this subset come with later slices.
"""
from __future__ import annotations

import numpy as np

from ..core.program import VarDesc, default_main_program
from .initializer import Constant, Normal, Xavier
from .layer_helper import LayerHelper
from .param_attr import ParamAttr

__all__ = ["data", "fc", "embedding", "conv2d", "pool2d", "batch_norm",
           "layer_norm", "dropout", "softmax", "matmul", "elementwise_add",
           "elementwise_sub", "elementwise_mul", "elementwise_div",
           "elementwise_max", "elementwise_mod", "equal", "assign",
           "ones_like", "uniform_random", "gaussian_random", "reduce_sum", "relu", "sqrt", "square",
           "clip", "clip_by_norm", "sums", "reshape", "transpose", "scale",
           "fill_constant", "softmax_with_cross_entropy", "label_smooth",
           "one_hot", "mean", "cast", "create_global_var", "_binary_op",
           "gelu", "concat", "switch_moe"]


def _current_block():
    return default_main_program().current_block()


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    from ..core.dtype import convert_dtype
    dtype = convert_dtype(dtype)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op("fill_constant", outputs={"Out": out},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value)})
    return out


def _to_var(x, block=None, dtype=None):
    """Coerce python scalars to vars via fill_constant."""
    if isinstance(x, VarDesc):
        return x
    if np.isscalar(x):
        dtype = dtype or ("int64" if isinstance(x, (int, np.integer))
                          else "float32")
        return fill_constant([1], dtype, float(x))
    raise TypeError(f"cannot use {type(x).__name__} as a graph operand "
                    "(array constants need assign_value, not ported yet)")


# ---------------------------------------------------------------------------
# data / feed
# ---------------------------------------------------------------------------
def data(name, shape, dtype="float32", lod_level=0, append_batch_size=False):
    """Declare an input var (fluid.data / fluid.layers.data). Dim -1 = batch,
    bound by the feed at Executor.run."""
    block = default_main_program().global_block()
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    v = block.create_var(name=name, shape=shape, dtype=dtype,
                         is_data=True, stop_gradient=True)
    v.lod_level = lod_level
    return v


# ---------------------------------------------------------------------------
# dense / norm / embedding
# ---------------------------------------------------------------------------
def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """fluid.layers.fc: flatten trailing dims, x @ W + b, then `act`.
    One input var (the list form sums several through the `sum` op of a
    later slice)."""
    if isinstance(input, (list, tuple)):
        raise NotImplementedError(
            "fc over a list of inputs needs the sum op, not ported yet")
    helper = LayerHelper("fc", name=name)
    x = input
    in_features = int(np.prod(x.shape[num_flatten_dims:]))
    w = helper.create_parameter(param_attr, [in_features, size], x.dtype)
    pre_bias = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mul", inputs={"X": x, "Y": w},
                     outputs={"Out": pre_bias},
                     attrs={"x_num_col_dims": num_flatten_dims,
                            "y_num_col_dims": 1})
    b = helper.create_parameter(bias_attr, [size], x.dtype, is_bias=True)
    if b is not None:
        pre_act = helper.create_variable_for_type_inference(pre_bias.dtype)
        helper.append_op("elementwise_add", inputs={"X": pre_bias, "Y": b},
                         outputs={"Out": pre_act},
                         attrs={"axis": len(pre_bias.shape) - 1})
    else:
        pre_act = pre_bias
    return helper.append_activation(pre_act, act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32", name=None):
    """fluid.layers.embedding / fluid.embedding (lookup_table_v2)."""
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(param_attr, list(size), dtype,
                                default_initializer=Xavier())
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "lookup_table_v2", inputs={"W": w, "Ids": input},
        outputs={"Out": out},
        attrs={"padding_idx": -1 if padding_idx is None else padding_idx,
               "is_sparse": bool(is_sparse),
               "is_distributed": bool(is_distributed)})
    return out


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [int(v)] * 2


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    """fluid.layers.conv2d: the conv2d op (filter Normal(0, sqrt(2 /
    fan_in))), the bias as an elementwise_add over the channel axis, then
    `act`."""
    helper = LayerHelper("conv2d", name=name)
    c_in = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    ks = _pair(filter_size)
    w_shape = [num_filters, c_in // groups] + ks
    fan_in = (c_in // groups) * ks[0] * ks[1]
    w = helper.create_parameter(
        param_attr, w_shape, input.dtype,
        default_initializer=Normal(0.0, float(np.sqrt(2.0 / fan_in))))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "conv2d", inputs={"Input": input, "Filter": w},
        outputs={"Output": out},
        attrs={"strides": _pair(stride), "paddings": _pair(padding),
               "dilations": _pair(dilation), "groups": groups,
               "data_format": data_format})
    b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                is_bias=True)
    if b is not None:
        pre_act = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("elementwise_add", inputs={"X": out, "Y": b},
                         outputs={"Out": pre_act},
                         attrs={"axis": 1 if data_format == "NCHW" else 3})
    else:
        pre_act = out
    return helper.append_activation(pre_act, act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, name=None, data_format="NCHW"):
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "pool2d", inputs={"X": input}, outputs={"Out": out},
        attrs={"pooling_type": pool_type, "ksize": _pair(pool_size),
               "strides": _pair(pool_stride), "paddings": _pair(pool_padding),
               "global_pooling": global_pooling, "ceil_mode": ceil_mode,
               "exclusive": exclusive, "data_format": data_format})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               moving_mean_name=None, moving_variance_name=None,
               use_global_stats=False, name=None):
    """fluid.layers.batch_norm.  The running stats are persistable
    non-trainable parameters that the op updates in the graph: MeanOut /
    VarianceOut are the Mean / Variance vars themselves.  The attr is
    `data_layout`, which the kernel does not read (it reads
    `data_format`), as in the reference."""
    helper = LayerHelper("batch_norm", name=name)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(param_attr, [c], "float32",
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(bias_attr, [c], "float32", is_bias=True)
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name, trainable=False), [c], "float32",
        default_initializer=Constant(0.0))
    var = helper.create_parameter(
        ParamAttr(name=moving_variance_name, trainable=False), [c], "float32",
        default_initializer=Constant(1.0))
    mean.stop_gradient = True
    var.stop_gradient = True
    y = helper.create_variable_for_type_inference(input.dtype)
    saved_mean = helper.create_variable_for_type_inference("float32", True)
    saved_var = helper.create_variable_for_type_inference("float32", True)
    helper.append_op(
        "batch_norm",
        inputs={"X": input, "Scale": scale, "Bias": bias, "Mean": mean,
                "Variance": var},
        outputs={"Y": y, "MeanOut": mean, "VarianceOut": var,
                 "SavedMean": saved_mean, "SavedVariance": saved_var},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "data_layout": data_layout, "is_test": is_test,
               "use_global_stats": use_global_stats})
    return helper.append_activation(y, act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", name=name)
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": input}
    if scale:
        s = helper.create_parameter(param_attr, norm_shape, "float32",
                                    default_initializer=Constant(1.0))
        inputs["Scale"] = s
    if shift:
        b = helper.create_parameter(bias_attr, norm_shape, "float32",
                                    is_bias=True)
        if b is not None:
            inputs["Bias"] = b
    y = helper.create_variable_for_type_inference(input.dtype)
    m = helper.create_variable_for_type_inference("float32", True)
    v = helper.create_variable_for_type_inference("float32", True)
    helper.append_op("layer_norm", inputs=inputs,
                     outputs={"Y": y, "Mean": m, "Variance": v},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(y, act)


def dropout(x, dropout_prob, is_test=False, seed=None,
            dropout_implementation="downgrade_in_infer", name=None):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference("uint8", True)
    helper.append_op(
        "dropout", inputs={"X": x}, outputs={"Out": out, "Mask": mask},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "seed": seed or 0, "fix_seed": seed is not None,
               "dropout_implementation": dropout_implementation})
    return out


def softmax(input, axis=-1, name=None):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("softmax", inputs={"X": input}, outputs={"Out": out},
                     attrs={"axis": axis})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("matmul", inputs={"X": x, "Y": y}, outputs={"Out": out},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y, "alpha": alpha})
    return out


def _binary_op(op_type, x, y, reverse=False, axis=-1):
    """Shared builder for VarDesc operator overloads and the elementwise_*
    functions."""
    block = _current_block()
    if not isinstance(x, VarDesc):
        x = _to_var(x, block, dtype=getattr(y, "dtype", None))
    if not isinstance(y, VarDesc):
        y = _to_var(y, block, dtype=x.dtype)
    if reverse:
        x, y = y, x
    helper = LayerHelper(op_type)
    cmp_ops = {"less_than", "less_equal", "greater_than", "greater_equal",
               "equal", "not_equal"}
    dtype = "bool" if op_type in cmp_ops else x.dtype
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(op_type, inputs={"X": x, "Y": y}, outputs={"Out": out},
                     attrs={"axis": axis})
    return out


def _make_elementwise(op_type):
    def f(x, y, axis=-1, act=None, name=None):
        out = _binary_op(op_type, x, y, axis=axis)
        if act:
            out = LayerHelper(op_type).append_activation(out, act)
        return out
    f.__name__ = op_type
    return f


elementwise_add = _make_elementwise("elementwise_add")
elementwise_sub = _make_elementwise("elementwise_sub")
elementwise_mul = _make_elementwise("elementwise_mul")
elementwise_div = _make_elementwise("elementwise_div")
elementwise_max = _make_elementwise("elementwise_max")
elementwise_mod = _make_elementwise("elementwise_mod")


def equal(x, y, cond=None, axis=-1, name=None):
    if cond is None:
        return _binary_op("equal", x, y, axis=axis)
    helper = LayerHelper("equal", name=name)
    helper.append_op("equal", inputs={"X": x, "Y": y},
                     outputs={"Out": cond}, attrs={"axis": axis})
    return cond


def assign(input, output=None):
    """Out = input (a var; array constants need assign_value, not
    ported)."""
    if not isinstance(input, VarDesc):
        raise TypeError("assign of an array constant needs assign_value, "
                        "not ported yet")
    helper = LayerHelper("assign")
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("assign", inputs={"X": input}, outputs={"Out": output})
    return output


def ones_like(x, out=None, name=None):
    helper = LayerHelper("fill_any_like", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fill_any_like", inputs={"X": x}, outputs={"Out": out},
                     attrs={"value": 1.0, "dtype": x.dtype})
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0,
                   name=None):
    helper = LayerHelper("uniform_random", name=name)
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op("uniform_random", outputs={"Out": out},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "min": min, "max": max, "seed": seed})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32",
                    name=None):
    helper = LayerHelper("gaussian_random", name=name)
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op("gaussian_random", outputs={"Out": out},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "mean": mean, "std": std, "seed": seed})
    return out


def _make_reduce(op_type):
    def f(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(input.dtype)
        if dim is None:
            attrs = {"reduce_all": True, "dim": [0], "keep_dim": keep_dim}
        else:
            d = dim if isinstance(dim, (list, tuple)) else [dim]
            attrs = {"reduce_all": False, "dim": list(d),
                     "keep_dim": keep_dim}
        helper.append_op(op_type, inputs={"X": input},
                         outputs={"Out": out}, attrs=attrs)
        return out
    f.__name__ = op_type
    return f


reduce_sum = _make_reduce("reduce_sum")
reduce_mean = _make_reduce("reduce_mean")


def _make_unary(op_type):
    def f(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_type, inputs={"X": x}, outputs={"Out": out})
        return out
    f.__name__ = op_type
    return f


relu = _make_unary("relu")
sigmoid = _make_unary("sigmoid")
sqrt = _make_unary("sqrt")
square = _make_unary("square")
log = _make_unary("log")


def cross_entropy(input, label, soft_label=False, ignore_index=-100,
                  name=None):
    """-log of the probability `input` gives the label (hard labels, a
    [N, 1] or [N] int tensor), or -sum(label * log(input)) (soft)."""
    helper = LayerHelper("cross_entropy", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("cross_entropy",
                     inputs={"X": input, "Label": label},
                     outputs={"Y": out},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("clip", inputs={"X": x}, outputs={"Out": out},
                     attrs={"min": min, "max": max})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("clip_by_norm", inputs={"X": x}, outputs={"Out": out},
                     attrs={"max_norm": max_norm})
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("sum", inputs={"X": input}, outputs={"Out": out})
    return out


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mean", inputs={"X": x}, outputs={"Out": out})
    return out


def cast(x, dtype):
    from ..core.dtype import convert_dtype
    helper = LayerHelper("cast")
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("cast", inputs={"X": x}, outputs={"Out": out},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, return_softmax=False,
                               axis=-1, name=None):
    helper = LayerHelper("softmax_with_cross_entropy", name=name)
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op("softmax_with_cross_entropy",
                     inputs={"Logits": logits, "Label": label},
                     outputs={"Softmax": softmax_out, "Loss": loss},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index, "axis": axis})
    if return_softmax:
        return loss, softmax_out
    return loss


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(label.dtype)
    ins = {"X": label}
    if prior_dist is not None:
        ins["PriorDist"] = prior_dist
    helper.append_op("label_smooth", inputs=ins, outputs={"Out": out},
                     attrs={"epsilon": epsilon})
    return out


def one_hot(input, depth, allow_out_of_range=False, name=None):
    helper = LayerHelper("one_hot_v2", name=name)
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("one_hot_v2", inputs={"X": input}, outputs={"Out": out},
                     attrs={"depth": depth,
                            "allow_out_of_range": allow_out_of_range})
    return out


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    helper = LayerHelper("global_var", name=name)
    v = helper.create_global_variable(shape, dtype, persistable=persistable,
                                      name=name)
    Constant(value)(v, helper.startup_program.global_block())
    return v


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", inputs={"X": x}, outputs={"Out": out},
                     attrs={"scale": scale, "bias": bias,
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("reshape2", inputs={"X": x},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out, act)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("transpose2", inputs={"X": x},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"axis": list(perm)})
    return out


def gelu(x, approximate=False, name=None):
    helper = LayerHelper("gelu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("gelu", inputs={"X": x}, outputs={"Out": out},
                     attrs={"approximate": approximate})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("concat", inputs={"X": list(input)},
                     outputs={"Out": out}, attrs={"axis": axis})
    return out


def switch_moe(x, num_experts, d_hidden, capacity_factor=1.25,
               ep_ring_id=None, param_attr=None, name=None):
    """Switch (top-1) Mixture-of-Experts feed-forward as a static-graph
    layer (incubate/moe.py's core through the switch_moe op); with
    `ep_ring_id` bound to a process group the experts are parallel over
    it.  x [..., D] -> (out [..., D], aux_loss scalar)."""
    from .param_attr import ParamAttr
    helper = LayerHelper("switch_moe", name=name)
    d_model = int(x.shape[-1])

    def _sub_attr(suffix):
        return ParamAttr.derive(param_attr, suffix)

    gate_w = helper.create_parameter(_sub_attr("_gate"),
                                     [d_model, num_experts], x.dtype)
    w1 = helper.create_parameter(_sub_attr("_w1"),
                                 [num_experts, d_model, d_hidden], x.dtype)
    b1 = helper.create_parameter(None, [num_experts, d_hidden], x.dtype,
                                 is_bias=True)
    w2 = helper.create_parameter(_sub_attr("_w2"),
                                 [num_experts, d_hidden, d_model], x.dtype)
    b2 = helper.create_parameter(None, [num_experts, d_model], x.dtype,
                                 is_bias=True)
    out = helper.create_variable_for_type_inference(x.dtype)
    aux = helper.create_variable_for_type_inference("float32")
    attrs = {"capacity_factor": capacity_factor}
    if ep_ring_id is not None:
        attrs["ep_ring_id"] = int(ep_ring_id)
    helper.append_op("switch_moe",
                     {"X": x, "GateW": gate_w, "W1": w1, "B1": b1,
                      "W2": w2, "B2": b2},
                     {"Out": out, "AuxLoss": aux}, attrs)
    return out, aux
