"""Tensor layers (mirror of ``paddle_tpu/layers/tensor.py``). `cast`
is in ``layers/nn.py``."""

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


def create_tensor(dtype="float32", name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.main_program.current_block().create_var(
        name=name, dtype=dtype, shape=(), persistable=persistable)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A global var initialized to `value` by the startup program
    (`force_cpu` is accepted and has no effect: a var lives on the
    executor's device)."""
    from .. import initializer as init
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(name=name, shape=shape, dtype=dtype,
                                        persistable=persistable)
    helper.set_variable_initializer(var, init.ConstantInitializer(value))
    return var


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A learnable Parameter, made as `fc` and `conv2d` make theirs."""
    from ..param_attr import ParamAttr
    helper = LayerHelper("create_parameter", name=name)
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias=is_bias,
                                   default_initializer=default_initializer)


def _single_out(op_type, x, attrs, dtype, lod_from=None):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(op_type, inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs=attrs)
    if lod_from is not None:
        out.lod_level = lod_from.lod_level
    return out


def argmax(x, axis=0):
    return _single_out("arg_max", x, {"axis": axis}, "int64")


def argmin(x, axis=0):
    return _single_out("arg_min", x, {"axis": axis}, "int64")


def argsort(x, axis=-1, name=None):
    """(sorted values, int64 indices) along `axis`, a stable sort."""
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    ids = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op("argsort", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "Indices": [ids.name]},
                     attrs={"axis": axis})
    return out, ids


def zeros(shape, dtype="float32"):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype="float32"):
    return fill_constant(shape, dtype, 1.0)


def reverse(x, axis):
    axis = [axis] if isinstance(axis, int) else list(axis)
    return _single_out("reverse", x, {"axis": axis}, x.dtype, lod_from=x)
