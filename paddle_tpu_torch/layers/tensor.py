"""Tensor layers (mirror of ``paddle_tpu/layers/tensor.py`` for the
slices' subset: `fill_constant`, `fill_constant_batch_size_like`,
`assign`, `concat`, `sums`). `cast` is in ``layers/nn.py``."""

from __future__ import annotations

import numpy as np

from ..core import ir
from ..layer_helper import LayerHelper


def fill_constant(shape, dtype, value, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op("fill_constant", outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value)})
    return out


def fill_constant_batch_size_like(input, shape, dtype, value, input_dim_idx=0,
                                  output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op("fill_constant_batch_size_like",
                     inputs={"Input": [input.name]}, outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    return out


def assign(input, output=None):
    """Copy a Variable into `output` (a new variable when None), or a
    numpy value through the `assign_value` op (its values in the attrs)."""
    helper = LayerHelper("assign")
    if isinstance(input, ir.Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=input.dtype)
        helper.append_op("assign", inputs={"X": [input.name]},
                         outputs={"Out": [output.name]})
    else:
        arr = np.asarray(input)
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=str(arr.dtype))
        helper.append_op("assign_value", outputs={"Out": [output.name]},
                         attrs={"shape": list(arr.shape),
                                "dtype": str(arr.dtype),
                                "values": [float(v) for v in arr.reshape(-1)]})
    return output


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    helper.append_op("concat", inputs={"X": [v.name for v in input]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    out.lod_level = input[0].lod_level
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    helper.append_op("sum", inputs={"X": [v.name for v in input]},
                     outputs={"Out": [out.name]})
    return out
