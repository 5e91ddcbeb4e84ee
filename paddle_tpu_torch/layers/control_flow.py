"""Control-flow layers (mirror of ``paddle_tpu/layers/control_flow.py``
for the slices' subset: `increment` and `less_than`, which the learning
rate schedules' step counter needs). `While`, `IfElse`, `Switch` and the
tensor arrays are not ported yet."""

from __future__ import annotations

from ..layer_helper import LayerHelper


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out_name = x.name if in_place else None
    if out_name is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        out_name = out.name
    helper.append_op("increment", inputs={"X": [x.name]},
                     outputs={"Out": [out_name]}, attrs={"step": float(value)})
    return x if in_place else out


def less_than(x, y, cond=None):
    helper = LayerHelper("less_than")
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype="bool")
    helper.append_op("less_than", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [cond.name]}, attrs={"axis": -1})
    return cond
