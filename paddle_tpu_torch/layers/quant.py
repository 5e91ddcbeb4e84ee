"""Quantization layers (mirror of ``paddle_tpu/layers/quant.py``;
reference fake_quantize_op.cc wrappers used by the
quantization-aware-training passes)."""

from __future__ import annotations

from ..layer_helper import LayerHelper


def fake_quantize(x, bit_length=8, quantize_type="abs_max", name=None,
                  in_scale=None, is_test=False):
    """Quantize-dequantize in float with a straight-through gradient
    (reference fake_quantize_op.cc). Returns (out, scale)."""
    helper = LayerHelper("fake_quantize", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    scale = helper.create_variable_for_type_inference(dtype="float32")
    scale.stop_gradient = True
    if quantize_type == "abs_max":
        helper.append_op("fake_quantize_abs_max",
                         inputs={"X": [x.name]},
                         outputs={"Out": [out.name],
                                  "OutScale": [scale.name]},
                         attrs={"bit_length": bit_length})
    elif quantize_type == "range_abs_max":
        inputs = {"X": [x.name]}
        if in_scale is not None:
            # the running scale is REAL state: write OutScale back onto the
            # in_scale var so the range accumulates across steps (reference
            # updates the persistable InScale buffer in place)
            inputs["InScale"] = [in_scale.name]
            scale = in_scale
        helper.append_op("fake_quantize_range_abs_max",
                         inputs=inputs,
                         outputs={"Out": [out.name],
                                  "OutScale": [scale.name]},
                         attrs={"bit_length": bit_length,
                                "is_test": is_test})
    else:
        raise ValueError(f"unknown quantize_type {quantize_type!r}")
    return out, scale


def fake_dequantize(x, scale, max_range=127.0, name=None):
    helper = LayerHelper("fake_dequantize", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("fake_dequantize_max_abs",
                     inputs={"X": [x.name], "Scale": [scale.name]},
                     outputs={"Out": [out.name]},
                     attrs={"max_range": float(max_range)})
    return out
