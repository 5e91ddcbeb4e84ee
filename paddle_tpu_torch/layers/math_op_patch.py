"""Operators on Variable (mirror of
``paddle_tpu/layers/math_op_patch.py``; reference
python/paddle/fluid/layers/math_op_patch.py): `a + b`, `a * 2.0`,
`2.0 ** a`, `a >= b`, ... append the elementwise or comparison op, a
Python number entering as a [1] `fill_constant`. The learning rate
schedules and per-parameter learning rates are built with them. `%`
waits for the op it appends (`elementwise_mod`), which the port does
not register yet."""

from __future__ import annotations

from ..core import ir
from ..layer_helper import LayerHelper


def _binary(op_type, reverse=False):
    def impl(self, other):
        from . import tensor as t
        helper = LayerHelper(op_type)
        if not isinstance(other, ir.Variable):
            # scalar -> fill_constant broadcastable tensor
            other = t.fill_constant([1], self.dtype, float(other))
        x, y = (other, self) if reverse else (self, other)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(op_type, inputs={"X": [x.name], "Y": [y.name]},
                         outputs={"Out": [out.name]}, attrs={"axis": -1})
        out.lod_level = max(self.lod_level, getattr(other, "lod_level", 0))
        return out

    return impl


def monkey_patch_variable():
    V = ir.Variable
    V.__add__ = _binary("elementwise_add")
    V.__radd__ = _binary("elementwise_add", reverse=True)
    V.__sub__ = _binary("elementwise_sub")
    V.__rsub__ = _binary("elementwise_sub", reverse=True)
    V.__mul__ = _binary("elementwise_mul")
    V.__rmul__ = _binary("elementwise_mul", reverse=True)
    V.__truediv__ = _binary("elementwise_div")
    V.__rtruediv__ = _binary("elementwise_div", reverse=True)
    V.__pow__ = _binary("elementwise_pow")
    V.__rpow__ = _binary("elementwise_pow", reverse=True)
    V.__lt__ = _binary("less_than")
    V.__le__ = _binary("less_equal")
    V.__gt__ = _binary("greater_than")
    V.__ge__ = _binary("greater_equal")
    V.__neg__ = lambda self: self * (-1.0)
