"""Generated thin layer wrappers for the activation and elementwise ops
(reference: python/paddle/fluid/layers/ops.py via
layer_function_generator.py); a copy of ``paddle_tpu/layers/ops.py``, so
the programs they build are the JAX package's op for op."""

from __future__ import annotations

import sys

from ..layer_helper import LayerHelper

_ACTIVATIONS = [
    "sigmoid", "logsigmoid", "exp", "relu", "tanh", "tanh_shrink", "softshrink",
    "sqrt", "rsqrt", "abs", "ceil", "floor", "cos", "sin", "round", "reciprocal",
    "square", "softplus", "softsign", "brelu", "leaky_relu", "soft_relu", "elu",
    "relu6", "pow", "swish", "hard_sigmoid", "thresholded_relu", "hard_shrink",
    "gelu", "log", "sign",
]

_ELEMENTWISE = [
    "elementwise_add", "elementwise_sub", "elementwise_mul", "elementwise_div",
    "elementwise_max", "elementwise_min", "elementwise_pow", "elementwise_mod",
]


def _make_act(op_type):
    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(op_type, inputs={"X": [x.name]},
                         outputs={"Out": [out.name]}, attrs=attrs)
        out.lod_level = x.lod_level
        return out

    layer.__name__ = op_type
    layer.__doc__ = f"Elementwise `{op_type}` activation; attrs by keyword."
    return layer


def _make_elementwise(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, name=name, act=act)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(op_type, inputs={"X": [x.name], "Y": [y.name]},
                         outputs={"Out": [out.name]}, attrs={"axis": axis})
        out.lod_level = max(x.lod_level, getattr(y, "lod_level", 0))
        return helper.append_activation(out)

    layer.__name__ = op_type
    layer.__doc__ = f"`{op_type}` with reference broadcast semantics (axis attr)."
    return layer


_mod = sys.modules[__name__]
for _name in _ACTIVATIONS:
    setattr(_mod, _name, _make_act(_name))
for _name in _ELEMENTWISE:
    setattr(_mod, _name, _make_elementwise(_name))

__all__ = _ACTIVATIONS + _ELEMENTWISE
