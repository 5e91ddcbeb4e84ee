"""Tensor layers (mirror of ``paddle_tpu/layers/tensor.py`` for the
slices' subset: `fill_constant`, `assign`, `concat`, `sums`). `cast` is
in ``layers/nn.py``."""

from __future__ import annotations

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


def assign(input, output=None):
    """Copy a Variable into `output` (a new variable when None). The JAX
    package also assigns a numpy value through its `assign_value` op,
    which the port does not register yet."""
    if not isinstance(input, ir.Variable):
        raise NotImplementedError(
            "assign of a numpy value needs the assign_value op, which "
            "paddle_tpu_torch does not port yet; assign a Variable")
    helper = LayerHelper("assign")
    if output is None:
        output = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("assign", inputs={"X": [input.name]},
                     outputs={"Out": [output.name]})
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
