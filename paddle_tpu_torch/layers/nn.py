"""Layers built on single ops (mirror of ``paddle_tpu/layers/nn.py``,
``layers/ops.py`` and ``layers/tensor.py`` for the slices' subset). Each
function is the JAX package's, so the programs they build are the same
op for op, name for name."""

from __future__ import annotations

from .. import initializer as init
from ..layer_helper import LayerHelper


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Fully-connected layer (reference nn.py:117)."""
    helper = LayerHelper("fc", **locals())
    dtype = input[0].dtype if isinstance(input, (list, tuple)) else input.dtype
    inputs = input if isinstance(input, (list, tuple)) else [input]
    param_attrs = param_attr if isinstance(param_attr, (list, tuple)) \
        else [param_attr] * len(inputs)
    mul_results = []
    for inp, pattr in zip(inputs, param_attrs):
        in_features = 1
        for d in inp.shape[num_flatten_dims:]:
            in_features *= d
        w = helper.create_parameter(pattr, [in_features, size], dtype)
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op("mul", inputs={"X": [inp.name], "Y": [w.name]},
                         outputs={"Out": [tmp.name]},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op("sum", inputs={"X": [m.name for m in mul_results]},
                         outputs={"Out": [pre_bias.name]})
    pre_act = _append_bias(helper, pre_bias, dim_start=num_flatten_dims)
    pre_act.lod_level = inputs[0].lod_level
    return helper.append_activation(pre_act)


def _append_bias(helper, input_var, dim_start=1):
    battr = helper.bias_attr
    if battr is False:
        return input_var
    size = input_var.shape[-1] if input_var.shape else 1
    b = helper.create_parameter(battr, [size], input_var.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(dtype=input_var.dtype)
    helper.append_op("elementwise_add",
                     inputs={"X": [input_var.name], "Y": [b.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": -1})
    out.lod_level = input_var.lod_level
    return out


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """Embedding lookup (reference nn.py:229). is_sparse maps to the same
    dense-table gather (its grad is a dense scatter-add)."""
    helper = LayerHelper("embedding", **locals())
    w = helper.create_parameter(param_attr, size, dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("lookup_table",
                     inputs={"W": [w.name], "Ids": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"padding_idx": -1 if padding_idx is None else padding_idx,
                            "is_sparse": is_sparse,
                            "is_distributed": is_distributed})
    out.lod_level = input.lod_level
    return out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    """2-D convolution, NCHW or NHWC (reference nn.py:1365). `use_cudnn` is
    accepted for API parity and ignored. Filters are stored OIHW either
    way, initialized from N(0, sqrt(2 / (kh * kw * C)))."""
    helper = LayerHelper("conv2d", **locals())
    dtype = input.dtype
    c_axis = 1 if data_format == "NCHW" else len(input.shape) - 1
    num_channels = input.shape[c_axis]
    fsize = filter_size if isinstance(filter_size, (list, tuple)) \
        else [filter_size, filter_size]
    filter_shape = [num_filters, num_channels // groups] + list(fsize)
    std = (2.0 / (fsize[0] * fsize[1] * num_channels)) ** 0.5
    w = helper.create_parameter(param_attr, filter_shape, dtype,
                                default_initializer=init.NormalInitializer(0.0, std))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op("conv2d",
                     inputs={"Input": [input.name], "Filter": [w.name]},
                     outputs={"Output": [pre_bias.name]},
                     attrs={"strides": _pair(stride), "paddings": _pair(padding),
                            "dilations": _pair(dilation), "groups": groups,
                            "data_format": data_format})
    pre_act = _append_bias_channel(helper, pre_bias, axis=c_axis)
    return helper.append_activation(pre_act)


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def _append_bias_channel(helper, input_var, axis=1):
    battr = helper.bias_attr
    if battr is False:
        return input_var
    size = input_var.shape[axis] if len(input_var.shape) > axis else 1
    b = helper.create_parameter(battr, [size], input_var.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(dtype=input_var.dtype)
    helper.append_op("elementwise_add",
                     inputs={"X": [input_var.name], "Y": [b.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, use_cudnn=True, ceil_mode=False,
           exclusive=True, name=None, data_format="NCHW", adaptive=False):
    helper = LayerHelper("pool2d", **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("pool2d", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"pooling_type": pool_type, "ksize": _pair(pool_size),
                            "strides": _pair(pool_stride),
                            "paddings": _pair(pool_padding),
                            "global_pooling": global_pooling,
                            "exclusive": exclusive, "adaptive": adaptive,
                            "data_format": data_format})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None, do_model_average_for_mean_and_var=False):
    """Batch normalization (reference nn.py:2000). The running mean and
    variance are non-trainable, stop-gradient parameters, and the op's
    `MeanOut` / `VarianceOut` are those same variables."""
    helper = LayerHelper("batch_norm", **locals())
    dtype = input.dtype
    c_axis = 1 if data_layout == "NCHW" else len(input.shape) - 1
    channels = input.shape[c_axis]
    scale = helper.create_parameter(param_attr, [channels], dtype,
                                    default_initializer=init.ConstantInitializer(1.0))
    bias = helper.create_parameter(helper.bias_attr, [channels], dtype, is_bias=True)
    mean = helper.create_parameter(
        moving_mean_name, [channels], dtype,
        default_initializer=init.ConstantInitializer(0.0), stop_gradient=True)
    variance = helper.create_parameter(
        moving_variance_name, [channels], dtype,
        default_initializer=init.ConstantInitializer(1.0), stop_gradient=True)
    mean.trainable = False
    variance.trainable = False
    y = helper.create_variable_for_type_inference(dtype)
    saved_mean = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op("batch_norm",
                     inputs={"X": [input.name], "Scale": [scale.name],
                             "Bias": [bias.name], "Mean": [mean.name],
                             "Variance": [variance.name]},
                     outputs={"Y": [y.name], "MeanOut": [mean.name],
                              "VarianceOut": [variance.name],
                              "SavedMean": [saved_mean.name],
                              "SavedVariance": [saved_var.name]},
                     attrs={"momentum": momentum, "epsilon": epsilon,
                            "is_test": is_test, "data_layout": data_layout})
    return helper.append_activation(y)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1, epsilon=1e-5,
               param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("layer_norm", **locals())
    dtype = input.dtype
    norm_shape = [1]
    for d in input.shape[begin_norm_axis:]:
        norm_shape[0] *= d
    inputs = {"X": [input.name]}
    if scale:
        s = helper.create_parameter(param_attr, norm_shape, dtype,
                                    default_initializer=init.ConstantInitializer(1.0))
        inputs["Scale"] = [s.name]
    if shift:
        b = helper.create_parameter(helper.bias_attr, norm_shape, dtype, is_bias=True)
        inputs["Bias"] = [b.name]
    y = helper.create_variable_for_type_inference(dtype)
    mean = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    var = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op("layer_norm", inputs=inputs,
                     outputs={"Y": [y.name], "Mean": [mean.name],
                              "Variance": [var.name]},
                     attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis})
    y.lod_level = input.lod_level
    return helper.append_activation(y)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    mask = helper.create_variable_for_type_inference(dtype=x.dtype, stop_gradient=True)
    helper.append_op("dropout", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "Mask": [mask.name]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "dropout_implementation": dropout_implementation})
    out.lod_level = x.lod_level
    return out


def softmax(input, axis=-1, use_cudnn=True, name=None):
    helper = LayerHelper("softmax", **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("softmax", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    out.lod_level = input.lod_level
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("cross_entropy",
                     inputs={"X": [input.name], "Label": [label.name]},
                     outputs={"Y": [out.name]},
                     attrs={"soft_label": soft_label, "ignore_index": ignore_index})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, return_softmax=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_variable_for_type_inference(dtype=logits.dtype)
    loss = helper.create_variable_for_type_inference(dtype=logits.dtype)
    # hidden log-sum-exp output ([rows, 1] f32 — tiny): the grad rule
    # rebuilds softmax as exp(logits - lse) from it, pure elementwise, so
    # the backward re-runs no [rows, V] reductions and no [rows, V]
    # probabilities tensor crosses the fwd/bwd boundary
    lse_out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op("softmax_with_cross_entropy",
                     inputs={"Logits": [logits.name], "Label": [label.name]},
                     outputs={"Softmax": [softmax_out.name], "Loss": [loss.name],
                              "LSE": [lse_out.name]},
                     attrs={"soft_label": soft_label, "ignore_index": ignore_index})
    lse_out.stop_gradient = True
    if return_softmax:
        return loss, softmax_out
    return loss


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("mean", inputs={"X": [x.name]}, outputs={"Out": [out.name]})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("reshape", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"shape": list(shape)})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("transpose", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": list(perm)})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("scale", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    out.lod_level = x.lod_level
    return helper.append_activation(out)


def _make_elementwise(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        """`{op}` with the reference broadcast semantics (`axis`); the
        JAX package's ``layers/ops.py`` wrapper."""
        helper = LayerHelper(op_type, name=name, act=act)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(op_type, inputs={"X": [x.name], "Y": [y.name]},
                         outputs={"Out": [out.name]}, attrs={"axis": axis})
        out.lod_level = max(x.lod_level, getattr(y, "lod_level", 0))
        return helper.append_activation(out)

    layer.__name__ = op_type
    layer.__doc__ = layer.__doc__.format(op=op_type)
    return layer


elementwise_add = _make_elementwise("elementwise_add")
elementwise_sub = _make_elementwise("elementwise_sub")
elementwise_mul = _make_elementwise("elementwise_mul")
elementwise_div = _make_elementwise("elementwise_div")
elementwise_max = _make_elementwise("elementwise_max")
elementwise_min = _make_elementwise("elementwise_min")
elementwise_pow = _make_elementwise("elementwise_pow")


def _make_act(op_type):
    def layer(x, name=None, **attrs):
        """Elementwise `{op}` (the JAX package's ``layers/ops.py``)."""
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(op_type, inputs={"X": [x.name]},
                         outputs={"Out": [out.name]}, attrs=attrs)
        out.lod_level = x.lod_level
        return out

    layer.__name__ = op_type
    layer.__doc__ = layer.__doc__.format(op=op_type)
    return layer


relu = _make_act("relu")
sigmoid = _make_act("sigmoid")
exp = _make_act("exp")
sqrt = _make_act("sqrt")
square = _make_act("square")


def _reduce_layer(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(dtype=input.dtype)
        if dim is None:
            attrs = {"reduce_all": True, "keep_dim": keep_dim}
        else:
            dims = dim if isinstance(dim, (list, tuple)) else [dim]
            attrs = {"dim": list(dims), "keep_dim": keep_dim,
                     "reduce_all": False}
        helper.append_op(op_type, inputs={"X": [input.name]},
                         outputs={"Out": [out.name]}, attrs=attrs)
        return out

    layer.__name__ = op_type
    return layer


reduce_sum = _reduce_layer("reduce_sum")


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x.name], "Label": [label.name]},
                     outputs={"Out": [out.name]},
                     attrs={"ignore_index": ignore_index})
    return out


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("clip", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                     attrs={"min": float(min), "max": float(max)})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("clip_by_norm", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"max_norm": float(max_norm)})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("matmul", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y,
                            "alpha": float(alpha)})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(dtype=input.dtype)
    indices = helper.create_variable_for_type_inference(dtype="int64",
                                                        stop_gradient=True)
    helper.append_op("top_k", inputs={"X": [input.name]},
                     outputs={"Out": [values.name], "Indices": [indices.name]},
                     attrs={"k": k})
    return values, indices


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype=str(dtype))
    helper.append_op("cast", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"out_dtype": str(dtype)})
    out.lod_level = x.lod_level
    return out
