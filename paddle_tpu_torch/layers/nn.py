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


def elementwise_add(x, y, axis=-1, act=None, name=None):
    """`elementwise_add` with the reference broadcast semantics (`axis`);
    the JAX package's ``layers/ops.py`` wrapper."""
    helper = LayerHelper("elementwise_add", name=name, act=act)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("elementwise_add", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    out.lod_level = max(x.lod_level, getattr(y, "lod_level", 0))
    return helper.append_activation(out)




def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("matmul", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y,
                            "alpha": float(alpha)})
    return out


def relu(x, name=None):
    helper = LayerHelper("relu", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("relu", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={})
    out.lod_level = x.lod_level
    return out


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype=str(dtype))
    helper.append_op("cast", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"out_dtype": str(dtype)})
    out.lod_level = x.lod_level
    return out
