"""Static-graph layer functions: the subset of the fluid.layers API that
the BERT encoder and its pretraining program (`models/bert_static.py`),
the BASELINE configs' programs (`models/baseline_static.py`: conv2d,
pool2d, batch_norm, relu, one_hot, label_smooth), the score-matrix
attention graph, dropout, the optimizers, gradient clipping, the
regularizers and the AMP rewrite use.

Each function is a copy of its namesake in paddle_tpu/static/layers.py, so
both packages append the same ops with the same attrs, parameter names
and initializers; a Program built here serializes equal to the one the
JAX package builds.  The convolution, pooling, norm and resize builders
(conv3d, conv2d_transpose, conv3d_transpose, data_norm, pool3d,
adaptive_pool2d, group_norm, instance_norm, lrn, resize_bilinear,
resize_nearest, pad2d) came with the vision tier.  Layers outside this
subset come with later slices.
"""
from __future__ import annotations

import builtins

import numpy as np

from ..core.program import VarDesc, default_main_program, unique_name
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
           "gelu", "concat", "switch_moe", "increment", "not_equal",
           "less_than", "less_equal", "greater_than", "greater_equal",
           "logical_and", "logical_or", "logical_not", "Print",
           "While", "while_loop", "cond", "case", "switch_case", "Switch",
           "StaticRNN", "DynamicRNN", "array_write", "array_read",
           "array_length", "create_array", "crop_tensor",
           "get_tensor_from_selected_rows", "conv3d", "conv2d_transpose",
           "conv3d_transpose", "data_norm", "pool3d", "adaptive_pool2d",
           "group_norm", "instance_norm", "lrn", "resize_bilinear",
           "resize_nearest", "pad2d"]


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


def _make_compare(op_type, has_force_cpu=False):
    """Comparison layer; `cond=` writes the result into an existing bool
    var (the idiom While bodies use to update their loop condition).
    Only less_than takes force_cpu positionally, as the reference's
    less_than(x, y, force_cpu=None, cond=None)."""

    def _build(x, y, cond, axis, name):
        if cond is None:
            return _binary_op(op_type, x, y, axis=axis)
        helper = LayerHelper(op_type, name=name)
        helper.append_op(op_type, inputs={"X": x, "Y": y},
                         outputs={"Out": cond}, attrs={"axis": axis})
        return cond

    if has_force_cpu:
        def f(x, y, force_cpu=None, cond=None, axis=-1, name=None):
            return _build(x, y, cond, axis, name)
    else:
        def f(x, y, cond=None, axis=-1, name=None):
            return _build(x, y, cond, axis, name)
    f.__name__ = op_type
    return f


equal = _make_compare("equal")
not_equal = _make_compare("not_equal")
less_than = _make_compare("less_than", has_force_cpu=True)
less_equal = _make_compare("less_equal")
greater_than = _make_compare("greater_than")
greater_equal = _make_compare("greater_equal")
logical_and = _make_elementwise("logical_and")
logical_or = _make_elementwise("logical_or")


def logical_not(x, name=None):
    helper = LayerHelper("logical_not", name=name)
    out = helper.create_variable_for_type_inference("bool")
    helper.append_op("logical_not", inputs={"X": x}, outputs={"Out": out})
    return out


def increment(x, value=1.0, in_place=True, name=None):
    helper = LayerHelper("increment", name=name)
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype)
    helper.append_op("increment", inputs={"X": x}, outputs={"Out": out},
                     attrs={"step": value})
    return out


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """layers/control_flow.py Print: the print op, which prints each time
    the program runs."""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = tuple(input.shape) if input.shape is not None else None
    helper.append_op("print", inputs={"In": input},
                     outputs={"Out": out},
                     attrs={"message": message or "",
                            "first_n": first_n, "summarize": summarize})
    return out


def assign(input, output=None):
    """Out = input: a var through `assign`, an array constant through
    `assign_value` (its values in the op's attrs)."""
    helper = LayerHelper("assign")
    if isinstance(input, VarDesc):
        if output is None:
            output = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("assign", inputs={"X": input},
                         outputs={"Out": output})
    else:
        arr = np.asarray(input)
        if output is None:
            output = helper.create_variable_for_type_inference(
                str(arr.dtype))
        helper.append_op("assign_value", outputs={"Out": output},
                         attrs={"shape": list(arr.shape),
                                "dtype": str(arr.dtype),
                                "values": arr.ravel().tolist()})
    return output


def crop_tensor(x, shape=None, offsets=None, name=None):
    """fluid.layers.crop_tensor (crop_tensor_op.h)."""
    helper = LayerHelper("crop_tensor", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    ins = {"X": x}
    attrs = {}
    if isinstance(shape, (list, tuple)):
        attrs["shape"] = list(shape)
    elif shape is not None:
        ins["Shape"] = shape
    if isinstance(offsets, (list, tuple)):
        attrs["offsets"] = list(offsets)
    elif offsets is not None:
        ins["Offsets"] = offsets
    helper.append_op("crop_tensor", ins, {"Out": out}, attrs)
    return out


def get_tensor_from_selected_rows(x, name=None):
    """The dense [height, ...] tensor of a SelectedRows var (the JAX
    package's registry-generated layer)."""
    helper = LayerHelper("get_tensor_from_selected_rows", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("get_tensor_from_selected_rows", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={})
    return out


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


# ---------------------------------------------------------------------------
# control flow (fluid.layers.control_flow; see static/control_flow.py)
# ---------------------------------------------------------------------------
from .control_flow import (  # noqa: E402,F401
    While, while_loop, cond, case, switch_case, Switch, StaticRNN,
    DynamicRNN, array_write, array_read, array_length, create_array)


# ---------------------------------------------------------------------------
# the convolution, pooling, norm and resize builders (paddle_tpu/static/
# layers.py:182-555, 1107, 1422-1458)
# ---------------------------------------------------------------------------
def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("conv3d", name=name)
    c_in = input.shape[1]
    ks = _triple(filter_size)
    w = helper.create_parameter(param_attr,
                                [num_filters, c_in // groups] + ks,
                                input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("conv3d", inputs={"Input": input, "Filter": w},
                     outputs={"Output": out},
                     attrs={"strides": _triple(stride),
                            "paddings": _triple(padding),
                            "dilations": _triple(dilation), "groups": groups})
    b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                is_bias=True)
    if b is not None:
        pre = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("elementwise_add", inputs={"X": out, "Y": b},
                         outputs={"Out": pre}, attrs={"axis": 1})
        out = pre
    return helper.append_activation(out, act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("conv2d_transpose", name=name)
    c_in = input.shape[1]
    if filter_size is None:
        # derive kernel size from the requested output size, as the
        # reference does (layers/nn.py conv2d_transpose)
        if output_size is None:
            raise ValueError(
                "conv2d_transpose: one of output_size / filter_size required")
        osize = _pair(output_size)
        strides_, pads_, dils_ = _pair(stride), _pair(padding), _pair(dilation)
        ks = []
        for i in builtins.range(2):
            in_i = input.shape[2 + i]
            k = ((osize[i] - (in_i - 1) * strides_[i] + 2 * pads_[i] - 1)
                 // dils_[i] + 1)
            ks.append(int(k))
        filter_size = ks
    ks = _pair(filter_size)
    w = helper.create_parameter(param_attr, [c_in, num_filters // groups] + ks,
                                input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    attrs2 = {"strides": _pair(stride), "paddings": _pair(padding),
              "dilations": _pair(dilation), "groups": groups}
    if output_size is not None:
        attrs2["output_size"] = _pair(output_size)
    helper.append_op("conv2d_transpose",
                     inputs={"Input": input, "Filter": w},
                     outputs={"Output": out}, attrs=attrs2)
    b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                is_bias=True)
    if b is not None:
        pre = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("elementwise_add", inputs={"X": out, "Y": b},
                         outputs={"Out": pre}, attrs={"axis": 1})
        out = pre
    return helper.append_activation(out, act)


def _triple(v):
    return list(v) if isinstance(v, (list, tuple)) else [int(v)] * 3


def conv3d_transpose(input, num_filters, output_size=None,
                     filter_size=None, stride=1, padding=0, dilation=1,
                     groups=1, param_attr=None, bias_attr=None, act=None,
                     name=None):
    """layers/nn.py conv3d_transpose: NCDHW transpose conv; filter
    layout [Cin, Cout/groups, kd, kh, kw] like the reference."""
    helper = LayerHelper("conv3d_transpose", name=name)
    c_in = input.shape[1]
    if filter_size is None:
        # derive the kernel from the requested output size, like
        # conv2d_transpose (reference layers/nn.py)
        if output_size is None:
            raise ValueError(
                "conv3d_transpose: one of output_size / filter_size "
                "required")
        osize = _triple(output_size)
        strides_, pads_ = _triple(stride), _triple(padding)
        dils_ = _triple(dilation)
        ks = []
        for i in builtins.range(3):
            in_i = input.shape[2 + i]
            k = ((osize[i] - (in_i - 1) * strides_[i] + 2 * pads_[i] - 1)
                 // dils_[i] + 1)
            ks.append(int(k))
        filter_size = ks
    ks = _triple(filter_size)
    w = helper.create_parameter(
        param_attr, [c_in, num_filters // groups] + ks, input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    attrs3 = {"strides": _triple(stride), "paddings": _triple(padding),
              "dilations": _triple(dilation), "groups": groups}
    if output_size is not None:
        attrs3["output_size"] = _triple(output_size)
    helper.append_op("conv3d_transpose",
                     inputs={"Input": input, "Filter": w},
                     outputs={"Output": out}, attrs=attrs3)
    b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                is_bias=True)
    if b is not None:
        pre = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("elementwise_add", inputs={"X": out, "Y": b},
                         outputs={"Out": pre}, attrs={"axis": 1})
        out = pre
    return helper.append_activation(out, act)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=True, slot_dim=-1,
              sync_stats=False, summary_decay_rate=0.9999999,
              enable_scale_and_shift=False):
    """layers/nn.py data_norm: normalization by accumulated batch
    statistics (persistable BatchSize/BatchSum/BatchSquareSum), the CTR
    models' input normalizer."""
    helper = LayerHelper("data_norm", name=name)
    ndim = len(input.shape)
    c = input.shape[-1] if (data_layout == "NHWC" or ndim <= 2) \
        else input.shape[1]
    stats = {}
    for key, init in (("BatchSize", 1e4), ("BatchSum", 0.0),
                      ("BatchSquareSum", 1e4)):
        v = helper.main_program.global_block().create_var(
            name=unique_name(f"{helper.name}_{key}"), shape=(c,),
            dtype=input.dtype, persistable=True, stop_gradient=True)
        Constant(init)(v, helper.startup_program.global_block())
        stats[key] = v
    y = helper.create_variable_for_type_inference(input.dtype)
    means = helper.create_variable_for_type_inference(input.dtype)
    scales = helper.create_variable_for_type_inference(input.dtype)
    dn_inputs = {"X": input, "BatchSize": stats["BatchSize"],
                 "BatchSum": stats["BatchSum"],
                 "BatchSquareSum": stats["BatchSquareSum"]}
    if enable_scale_and_shift:
        dn_inputs["scale_w"] = helper.create_parameter(
            param_attr, [c], input.dtype,
            default_initializer=Constant(1.0))
        dn_inputs["bias"] = helper.create_parameter(
            param_attr, [c], input.dtype, is_bias=True,
            default_initializer=Constant(0.0))
    helper.append_op("data_norm", inputs=dn_inputs,
                     outputs={"Y": y, "Means": means, "Scales": scales},
                     attrs={"epsilon": epsilon,
                            "data_layout": data_layout})
    return helper.append_activation(y, act)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, name=None):
    helper = LayerHelper("pool3d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "pool3d", inputs={"X": input}, outputs={"Out": out},
        attrs={"pooling_type": pool_type, "ksize": _triple(pool_size),
               "strides": _triple(pool_stride),
               "paddings": _triple(pool_padding),
               "global_pooling": global_pooling})
    return out


def adaptive_pool2d(input, pool_size, pool_type="max", name=None):
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("pool2d", inputs={"X": input}, outputs={"Out": out},
                     attrs={"pooling_type": pool_type,
                            "ksize": _pair(pool_size), "adaptive": True})
    return out


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    helper = LayerHelper("group_norm", name=name)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    inputs = {"X": input}
    s = helper.create_parameter(param_attr, [c], "float32",
                                default_initializer=Constant(1.0))
    inputs["Scale"] = s
    b = helper.create_parameter(bias_attr, [c], "float32", is_bias=True)
    if b is not None:
        inputs["Bias"] = b
    y = helper.create_variable_for_type_inference(input.dtype)
    m = helper.create_variable_for_type_inference("float32", True)
    v = helper.create_variable_for_type_inference("float32", True)
    helper.append_op("group_norm", inputs=inputs,
                     outputs={"Y": y, "Mean": m, "Variance": v},
                     attrs={"groups": groups, "epsilon": epsilon,
                            "data_layout": data_layout})
    return helper.append_activation(y, act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    helper = LayerHelper("instance_norm", name=name)
    c = input.shape[1]
    inputs = {"X": input}
    s = helper.create_parameter(param_attr, [c], "float32",
                                default_initializer=Constant(1.0))
    inputs["Scale"] = s
    b = helper.create_parameter(bias_attr, [c], "float32", is_bias=True)
    if b is not None:
        inputs["Bias"] = b
    y = helper.create_variable_for_type_inference(input.dtype)
    sm = helper.create_variable_for_type_inference("float32", True)
    sv = helper.create_variable_for_type_inference("float32", True)
    helper.append_op("instance_norm", inputs=inputs,
                     outputs={"Y": y, "SavedMean": sm, "SavedVariance": sv},
                     attrs={"epsilon": epsilon})
    return y


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    helper = LayerHelper("pad2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("pad2d", inputs={"X": input}, outputs={"Out": out},
                     attrs={"paddings": list(paddings), "mode": mode,
                            "pad_value": pad_value,
                            "data_format": data_format})
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    mid = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("lrn", inputs={"X": input},
                     outputs={"Out": out, "MidOut": mid},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def resize_bilinear(input, out_shape=None, scale=None, align_corners=True,
                    align_mode=1, data_format="NCHW", name=None):
    helper = LayerHelper("bilinear_interp", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    attrs = {"interp_method": "bilinear", "align_corners": align_corners,
             "align_mode": align_mode, "data_layout": data_format}
    if out_shape is not None:
        attrs["out_h"], attrs["out_w"] = int(out_shape[0]), int(out_shape[1])
    if scale is not None:
        attrs["scale"] = float(scale)
    helper.append_op("bilinear_interp", inputs={"X": input},
                     outputs={"Out": out}, attrs=attrs)
    return out


def resize_nearest(input, out_shape=None, scale=None, align_corners=True,
                   data_format="NCHW", name=None):
    helper = LayerHelper("nearest_interp", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    attrs = {"interp_method": "nearest", "align_corners": align_corners,
             "data_layout": data_format}
    if out_shape is not None:
        attrs["out_h"], attrs["out_w"] = int(out_shape[0]), int(out_shape[1])
    if scale is not None:
        attrs["scale"] = float(scale)
    helper.append_op("nearest_interp", inputs={"X": input},
                     outputs={"Out": out}, attrs=attrs)
    return out
