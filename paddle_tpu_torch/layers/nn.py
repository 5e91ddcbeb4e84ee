"""Layers built on single ops (mirror of ``paddle_tpu/layers/nn.py``,
``layers/ops.py`` and ``layers/tensor.py`` for the slice's subset)."""

from __future__ import annotations

from ..layer_helper import LayerHelper


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
