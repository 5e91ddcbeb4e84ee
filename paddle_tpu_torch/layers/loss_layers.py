"""Layers over the sampled and structured losses (mirror of
``paddle_tpu/layers/loss_layers.py``; reference nn.py nce, hsigmoid,
linear_chain_crf, crf_decoding, warpctc, edit_distance). The programs
they build are the JAX package's, op for op and name for name, but for
`nce`'s `SampleLabels`, int64, the port's index dtype."""

from __future__ import annotations

from .. import initializer as init
from ..layer_helper import LayerHelper


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None, name=None):
    helper = LayerHelper("nce", **locals())
    dim = input.shape[-1]
    w = helper.create_parameter(param_attr, [num_total_classes, dim],
                                input.dtype)
    inputs = {"Input": [input.name], "Label": [label.name], "Weight": [w.name]}
    if bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr, [num_total_classes],
                                    input.dtype, is_bias=True)
        inputs["Bias"] = [b.name]
    if sample_weight is not None:
        inputs["SampleWeight"] = [sample_weight.name]
    cost = helper.create_variable_for_type_inference(dtype=input.dtype)
    sl = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                   stop_gradient=True)
    slab = helper.create_variable_for_type_inference(dtype="int64",
                                                     stop_gradient=True)
    helper.append_op("nce", inputs=inputs,
                     outputs={"Cost": [cost.name], "SampleLogits": [sl.name],
                              "SampleLabels": [slab.name]},
                     attrs={"num_total_classes": num_total_classes,
                            "num_neg_samples": num_neg_samples or 10})
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    helper = LayerHelper("hierarchical_sigmoid", **locals())
    dim = input.shape[-1]
    w = helper.create_parameter(param_attr, [num_classes - 1, dim], input.dtype)
    inputs = {"X": [input.name], "W": [w.name], "Label": [label.name]}
    if bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr, [num_classes - 1, 1],
                                    input.dtype, is_bias=True)
        inputs["Bias"] = [b.name]
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    pre = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                    stop_gradient=True)
    helper.append_op("hierarchical_sigmoid", inputs=inputs,
                     outputs={"Out": [out.name], "PreOut": [pre.name]},
                     attrs={"num_classes": num_classes})
    return out


def linear_chain_crf(input, label, param_attr=None):
    """input [B,T,N] emissions (lod-aware), label [B,T,1]."""
    helper = LayerHelper("linear_chain_crf", **locals())
    num_tags = input.shape[-1]
    trans = helper.create_parameter(
        param_attr, [num_tags + 2, num_tags], input.dtype,
        default_initializer=init.NormalInitializer(0.0, 0.1))
    inputs = {"Emission": [input.name], "Transition": [trans.name],
              "Label": [label.name]}
    seq = helper.ensure_seqlen_var(input)
    if seq is not None:
        inputs["SeqLen"] = [seq.name]
    ll = helper.create_variable_for_type_inference(dtype=input.dtype)
    alpha = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                      stop_gradient=True)
    ee = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                   stop_gradient=True)
    te = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                   stop_gradient=True)
    helper.append_op("linear_chain_crf", inputs=inputs,
                     outputs={"LogLikelihood": [ll.name],
                              "Alpha": [alpha.name],
                              "EmissionExps": [ee.name],
                              "TransitionExps": [te.name]})
    return ll


def crf_decoding(input, param_attr, label=None):
    """The Viterbi path under the transition parameter that `param_attr`
    (a ParamAttr or a name) names."""
    helper = LayerHelper("crf_decoding", **locals())
    trans_name = param_attr.name if hasattr(param_attr, "name") else param_attr
    inputs = {"Emission": [input.name], "Transition": [trans_name]}
    if label is not None:
        inputs["Label"] = [label.name]
    seq = helper.ensure_seqlen_var(input)
    if seq is not None:
        inputs["SeqLen"] = [seq.name]
    path = helper.create_variable_for_type_inference(dtype="int64",
                                                     stop_gradient=True)
    helper.append_op("crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [path.name]})
    return path


def warpctc(input, label, blank=0, norm_by_times=False,
            input_length=None, label_length=None):
    """input [B,T,C] logits; label [B,U]."""
    helper = LayerHelper("warpctc", **locals())
    inputs = {"Logits": [input.name], "Label": [label.name]}
    seq = helper.ensure_seqlen_var(input)
    if seq is not None:
        inputs["LogitsLen"] = [seq.name]
    elif input_length is not None:
        inputs["LogitsLen"] = [input_length.name]
    lseq = helper.ensure_seqlen_var(label)
    if lseq is not None:
        inputs["LabelLen"] = [lseq.name]
    elif label_length is not None:
        inputs["LabelLen"] = [label_length.name]
    loss = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("warpctc", inputs=inputs, outputs={"Loss": [loss.name]},
                     attrs={"blank": blank, "norm_by_times": norm_by_times})
    return loss


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    helper = LayerHelper("edit_distance", **locals())
    inputs = {"Hyps": [input.name], "Refs": [label.name]}
    seq = helper.ensure_seqlen_var(input)
    if seq is not None:
        inputs["HypsLen"] = [seq.name]
    elif input_length is not None:
        inputs["HypsLen"] = [input_length.name]
    lseq = helper.ensure_seqlen_var(label)
    if lseq is not None:
        inputs["RefsLen"] = [lseq.name]
    elif label_length is not None:
        inputs["RefsLen"] = [label_length.name]
    dist = helper.create_variable_for_type_inference(dtype="float32",
                                                     stop_gradient=True)
    num = helper.create_variable_for_type_inference(dtype="int64",
                                                    stop_gradient=True)
    helper.append_op("edit_distance", inputs=inputs,
                     outputs={"Out": [dist.name], "SequenceNum": [num.name]},
                     attrs={"normalized": normalized})
    return dist, num
