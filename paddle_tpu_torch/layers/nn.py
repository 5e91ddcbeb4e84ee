"""Layers built on single ops (mirror of ``paddle_tpu/layers/nn.py``,
``layers/ops.py`` and ``layers/tensor.py`` for the slices' subset). Each
function is the JAX package's, so the programs they build are the same
op for op, name for name."""

from __future__ import annotations

from .. import initializer as init
from ..core import registry as _registry
from ..core.ir import seqlen_var_name
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


def squeeze(input, axes=None, name=None):
    helper = LayerHelper("squeeze", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("squeeze", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, attrs={"axes": axes or []})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("unsqueeze", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, attrs={"axes": list(axes)})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    if isinstance(num_or_sections, int):
        num = num_or_sections
        sections = []
    else:
        num = 0
        sections = list(num_or_sections)
    n_outs = num if num else len(sections)
    outs = [helper.create_variable_for_type_inference(dtype=input.dtype)
            for _ in range(n_outs)]
    helper.append_op("split", inputs={"X": [input.name]},
                     outputs={"Out": [o.name for o in outs]},
                     attrs={"num": num, "sections": sections, "axis": dim})
    return outs


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("slice", inputs={"Input": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


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
tanh = _make_act("tanh")
floor = _make_act("floor")
ceil = _make_act("ceil")


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


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("square_error_cost",
                     inputs={"X": [input.name], "Y": [label.name]},
                     outputs={"Out": [out.name]})
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


# -- recurrent layers --------------------------------------------------------

def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """LSTM over a variable-length batch (reference nn.py:293, with its
    use_peepholes=True default). `input` is the x-projection
    [B, T, 4 * hidden] (an `fc` first, as in the reference); `size` is
    4 * hidden. With peepholes the bias packs [4H gate biases | W_ic |
    W_if | W_oc] (lstm_op.cc)."""
    helper = LayerHelper("lstm", **locals())
    hidden_size = size // 4
    bias_cols = 7 * hidden_size if use_peepholes else 4 * hidden_size
    weight = helper.create_parameter(param_attr,
                                     [hidden_size, 4 * hidden_size], dtype)
    bias = helper.create_parameter(helper.bias_attr, [1, bias_cols], dtype,
                                   is_bias=True) \
        if bias_attr is not False else None
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input.name], "Weight": [weight.name]}
    if bias is not None:
        inputs["Bias"] = [bias.name]
    if h_0 is not None:
        inputs["H0"] = [h_0.name]
    if c_0 is not None:
        inputs["C0"] = [c_0.name]
    seq = helper.ensure_seqlen_var(input)
    if seq is not None:
        inputs["SeqLen"] = [seq.name]
    helper.append_op("lstm", inputs=inputs,
                     outputs={"Hidden": [hidden.name], "Cell": [cell.name]},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation})
    hidden.lod_level = cell.lod_level = input.lod_level
    return hidden, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, name=None):
    """GRU over a variable-length batch (reference nn.py:597). `input` is
    the x-projection [B, T, 3 * size]."""
    helper = LayerHelper("gru", **locals())
    dtype = input.dtype
    weight = helper.create_parameter(param_attr, [size, 3 * size], dtype)
    bias = helper.create_parameter(helper.bias_attr, [1, 3 * size], dtype,
                                   is_bias=True) \
        if bias_attr is not False else None
    hidden = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input.name], "Weight": [weight.name]}
    if bias is not None:
        inputs["Bias"] = [bias.name]
    if h_0 is not None:
        inputs["H0"] = [h_0.name]
    seq = helper.ensure_seqlen_var(input)
    if seq is not None:
        inputs["SeqLen"] = [seq.name]
    helper.append_op("gru", inputs=inputs, outputs={"Hidden": [hidden.name]},
                     attrs={"is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "activation": candidate_activation})
    hidden.lod_level = input.lod_level
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid"):
    """One GRU step (reference nn.py gru_unit); `size` is 3 * hidden."""
    helper = LayerHelper("gru_unit", **locals())
    dtype = input.dtype
    hidden_size = size // 3
    weight = helper.create_parameter(param_attr,
                                     [hidden_size, 3 * hidden_size], dtype)
    bias = helper.create_parameter(helper.bias_attr, [1, 3 * hidden_size],
                                   dtype, is_bias=True) \
        if bias_attr is not False else None
    out_hidden = helper.create_variable_for_type_inference(dtype)
    reset_h = helper.create_variable_for_type_inference(dtype)
    gate = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input.name], "HiddenPrev": [hidden.name],
              "Weight": [weight.name]}
    if bias is not None:
        inputs["Bias"] = [bias.name]
    helper.append_op("gru_unit", inputs=inputs,
                     outputs={"Hidden": [out_hidden.name],
                              "ResetHiddenPrev": [reset_h.name],
                              "Gate": [gate.name]},
                     attrs={"activation": activation,
                            "gate_activation": gate_activation})
    return out_hidden, reset_h, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step (reference nn.py lstm_unit:2819): `fc` on
    [x_t, h_prev], then the lstm_unit op."""
    helper = LayerHelper("lstm_unit", **locals())
    from .tensor import concat
    size = cell_t_prev.shape[-1]
    cat = concat([x_t, hidden_t_prev], axis=1)
    fc_out = fc(input=cat, size=4 * size, param_attr=param_attr,
                bias_attr=bias_attr)
    h = helper.create_variable_for_type_inference(dtype=x_t.dtype)
    c = helper.create_variable_for_type_inference(dtype=x_t.dtype)
    helper.append_op("lstm_unit",
                     inputs={"X": [fc_out.name], "C_prev": [cell_t_prev.name]},
                     outputs={"H": [h.name], "C": [c.name]},
                     attrs={"forget_bias": float(forget_bias)})
    return h, c


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None):
    """LSTM with a recurrent projection (reference nn.py dynamic_lstmp,
    with its use_peepholes=True default). `input`: [B, T, 4 * hidden]
    x-projections, as for dynamic_lstm."""
    helper = LayerHelper("lstmp", **locals())
    hidden_size = size // 4
    bias_cols = 7 * hidden_size if use_peepholes else 4 * hidden_size
    weight = helper.create_parameter(param_attr,
                                     [proj_size, 4 * hidden_size], dtype)
    proj_weight = helper.create_parameter(param_attr,
                                          [hidden_size, proj_size], dtype)
    bias = helper.create_parameter(helper.bias_attr, [1, bias_cols],
                                   dtype, is_bias=True) \
        if bias_attr is not False else None
    proj = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input.name], "Weight": [weight.name],
              "ProjWeight": [proj_weight.name]}
    if bias is not None:
        inputs["Bias"] = [bias.name]
    seq = helper.ensure_seqlen_var(input)
    if seq is not None:
        inputs["SeqLen"] = [seq.name]
    helper.append_op("lstmp", inputs=inputs,
                     outputs={"Projection": [proj.name], "Cell": [cell.name]},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation,
                            "proj_activation": proj_activation})
    proj.lod_level = cell.lod_level = input.lod_level
    return proj, cell


# -- sequence layers ----------------------------------------------------------

# layers whose op rules take nested (level-2) input; the others refuse it
# when the program is built
_NESTED_CAPABLE = {"sequence_pool", "sequence_softmax", "sequence_conv",
                   "sequence_reshape", "sequence_erase", "sequence_slice",
                   "sequence_expand", "sequence_concat"}


def _seq_inputs(helper, x, extra=None):
    """{"X": x, "SeqLen": its innermost companion} (+ `extra`): sequence
    ops act on the innermost level (reference lod_tensor.h:110), so a
    nested input wires its [B, S] inner lengths."""
    if (getattr(x, "lod_level", 0) >= 2
            and helper.layer_type not in _NESTED_CAPABLE):
        raise NotImplementedError(
            f"{helper.layer_type}: nested (level-2) LoD input is supported "
            f"by {sorted(_NESTED_CAPABLE)}; pool the inner level first")
    inputs = {"X": [x.name]}
    level = max(getattr(x, "lod_level", 0) - 1, 0)
    seq = helper.ensure_seqlen_var(x, level=level)
    if seq is not None:
        inputs["SeqLen"] = [seq.name]
    if extra:
        inputs.update(extra)
    return inputs


def _alias_seqlen(helper, src, dst):
    """A length-keeping sequence op's output takes its input's companions
    (every level) by an explicit `assign`: the sequence ops register
    propagate_seqlen=False, and a later sequence op reads the output's
    companion as an input."""
    dst.lod_level = max(dst.lod_level, src.lod_level)
    for level in range(dst.lod_level):
        seq_src = helper.ensure_seqlen_var(src, level=level)
        if seq_src is None:
            continue
        seq_dst = helper.ensure_seqlen_var(dst, level=level)
        helper.append_op("assign", inputs={"X": [seq_src.name]},
                         outputs={"Out": [seq_dst.name]})


def _assign_outer_levels(helper, src, dst, inner):
    """The outer levels' companions (doc counts) of `src` onto `dst`."""
    for level in range(inner):
        s = helper.ensure_seqlen_var(src, level=level)
        if s is not None:
            d = helper.ensure_seqlen_var(dst, level=level)
            helper.append_op("assign", inputs={"X": [s.name]},
                             outputs={"Out": [d.name]})


def sequence_pool(input, pool_type, is_test=False):
    """Pool each sequence to one row (reference nn.py sequence_pool):
    average, sum, sqrt, max, last or first. A nested input pools its
    innermost level and keeps the outer one."""
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    if input.lod_level >= 2:
        inner = helper.ensure_seqlen_var(input, level=1)
        helper.append_op("sequence_pool",
                         inputs={"X": [input.name], "SeqLen": [inner.name]},
                         outputs={"Out": [out.name]},
                         attrs={"pooltype": pool_type.upper()})
        out.lod_level = input.lod_level - 1
        outer_src = helper.ensure_seqlen_var(input, level=0)
        outer_dst = helper.ensure_seqlen_var(out, level=0)
        helper.append_op("assign", inputs={"X": [outer_src.name]},
                         outputs={"Out": [outer_dst.name]})
        return out
    helper.append_op("sequence_pool", inputs=_seq_inputs(helper, input),
                     outputs={"Out": [out.name]},
                     attrs={"pooltype": pool_type.upper()})
    return out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def sequence_softmax(input, use_cudnn=False, name=None):
    helper = LayerHelper("sequence_softmax", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("sequence_softmax", inputs=_seq_inputs(helper, input),
                     outputs={"Out": [out.name]})
    out.lod_level = input.lod_level
    _alias_seqlen(helper, input, out)
    return out


def sequence_concat(input, name=None):
    """Concatenate sequences row by row along time (reference
    sequence_concat_op.cc): row b is concat_i(x_i[b, :len_i[b]]),
    left-aligned, of length sum_i len_i. An input without lengths adds
    its full rows; nested inputs concatenate their innermost level and
    take the first input's doc counts."""
    helper = LayerHelper("sequence_concat", name=name)
    xs = list(input) if isinstance(input, (list, tuple)) else [input]
    levels = {getattr(x, "lod_level", 0) for x in xs}
    if len(levels) > 1:
        raise ValueError(
            f"sequence_concat: inputs must share one LoD level, got "
            f"{sorted(levels)} (reference sequence_concat_op.cc requires "
            f"matching LoD structure)")
    out = helper.create_variable_for_type_inference(dtype=xs[0].dtype)
    out.lod_level = max(levels)
    inputs = {"X": [x.name for x in xs]}
    seq_names, wired = [], False
    for x in xs:
        level = max(getattr(x, "lod_level", 0) - 1, 0)
        s = helper.ensure_seqlen_var(x, level=level)
        if s is None:
            seq_names.append(_registry.EMPTY_VAR)   # full-length rows
        else:
            seq_names.append(s.name)
            wired = True
    outputs = {"Out": [out.name]}
    if wired and out.lod_level:
        inputs["SeqLen"] = seq_names
        seq_out = helper.ensure_seqlen_var(out, level=out.lod_level - 1)
        outputs["OutLen"] = [seq_out.name]
        _assign_outer_levels(helper, xs[0], out, out.lod_level - 1)
    helper.append_op("sequence_concat", inputs=inputs, outputs=outputs)
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    """x's rows broadcast over y's time axis; the output takes y's
    lengths."""
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("sequence_expand",
                     inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]},
                     attrs={"ref_level": ref_level})
    out.lod_level = y.lod_level
    _alias_seqlen(helper, y, out)
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None):
    """A context-window conv over each sequence (reference nn.py
    sequence_conv), then the bias and `act`; the companions alias onto
    the final var, which later sequence ops read."""
    helper = LayerHelper("sequence_conv", **locals())
    dtype = input.dtype
    d = input.shape[-1]
    w = helper.create_parameter(param_attr, [filter_size * d, num_filters],
                                dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("sequence_conv",
                     inputs=_seq_inputs(helper, input, {"Filter": [w.name]}),
                     outputs={"Out": [out.name]},
                     attrs={"contextLength": filter_size,
                            "contextStart": -(filter_size // 2),
                            "contextStride": filter_stride})
    out.lod_level = input.lod_level
    final = helper.append_activation(_append_bias(helper, out))
    _alias_seqlen(helper, input, final)
    return final


def sequence_reshape(input, new_dim):
    """[B, T, D] -> [B, T * D / new_dim, new_dim]; the op writes the
    scaled innermost lengths (OutLen), the outer levels ride through."""
    helper = LayerHelper("sequence_reshape")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    out.lod_level = input.lod_level
    outputs = {"Out": [out.name]}
    if input.lod_level > 0:
        seq_out = helper.ensure_seqlen_var(out, level=input.lod_level - 1)
        outputs["OutLen"] = [seq_out.name]
    helper.append_op("sequence_reshape", inputs=_seq_inputs(helper, input),
                     outputs=outputs, attrs={"new_dim": new_dim})
    _assign_outer_levels(helper, input, out, input.lod_level - 1)
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Lookahead row convolution (reference nn.py row_conv)."""
    helper = LayerHelper("row_conv", **locals())
    d = input.shape[-1]
    w = helper.create_parameter(param_attr, [future_context_size + 1, d],
                                input.dtype)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("row_conv",
                     inputs=_seq_inputs(helper, input, {"Filter": [w.name]}),
                     outputs={"Out": [out.name]})
    out.lod_level = input.lod_level
    final = helper.append_activation(out)
    _alias_seqlen(helper, input, final)
    return final


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op("sequence_mask", inputs={"X": [x.name]},
                     outputs={"Y": [out.name]},
                     attrs={"maxlen": maxlen if maxlen else -1,
                            "out_dtype": dtype})
    return out


def _lengths_companion(helper, input, out, lens):
    """`lens` (an op's OutLen) as `out`'s innermost companion, the outer
    levels' from `input`; `out` is at least level 1."""
    out.lod_level = max(input.lod_level, 1)
    blk = helper.main_program.current_block()
    inner = out.lod_level - 1
    comp = blk.create_var(name=seqlen_var_name(out.name, inner),
                          shape=[-1] * (inner + 1), dtype="int32")
    helper.append_op("assign", inputs={"X": [lens.name]},
                     outputs={"Out": [comp.name]})
    _assign_outer_levels(helper, input, out, inner)


def sequence_slice(input, offset, length, name=None):
    """Per-sequence sub-slices (reference sequence_slice_op.cc): row b is
    input[b, offset_b : offset_b + length_b], left-aligned; the slice
    lengths are the output's companion. Offsets and lengths clamp to the
    padded bound."""
    helper = LayerHelper("sequence_slice", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    lens = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op("sequence_slice",
                     inputs={"X": [input.name], "Offset": [offset.name],
                             "Length": [length.name]},
                     outputs={"Out": [out.name], "OutLen": [lens.name]},
                     attrs={"nested": input.lod_level >= 2})
    _lengths_companion(helper, input, out, lens)
    return out


def sequence_erase(input, tokens, name=None):
    """Remove `tokens` from each sequence and compact it left (reference
    sequence_erase_op.cc); the new lengths are the output's companion."""
    helper = LayerHelper("sequence_erase", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    lens = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op("sequence_erase", inputs=_seq_inputs(helper, input),
                     outputs={"Out": [out.name], "OutLen": [lens.name]},
                     attrs={"tokens": [int(t) for t in tokens]})
    _lengths_companion(helper, input, out, lens)
    return out
