"""Layers over the structured losses (mirror of `linear_chain_crf` and
`crf_decoding` in ``paddle_tpu/layers/loss_layers.py``). The programs
they build are the JAX package's, op for op and name for name."""

from __future__ import annotations

from .. import initializer as init
from ..layer_helper import LayerHelper


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
