"""Standalone single-op construction and execution (reference
python/paddle/fluid/op.py: OperatorFactory / `Operator`, the low-level
handle the reference's OpTest unit tests drive ops with; mirror of
``paddle_tpu/op.py``).

The returned Operator binds scope variable names to the op's rule, and
`run(scope, place)` runs that rule eagerly on the scope's tensors, on
their device: the same rule the executor runs, so a value checked here
is the value a program computes."""

from __future__ import annotations

from typing import Dict, List

import torch

from .core import registry
from .core.executor import CUDAPlace, as_tensor


class Operator:
    """`Operator("scale", X="x", Out="y", scale=2.0)`; slots bind scope
    var NAMES (a list for multi-var slots), everything else is an attr.
    `run(scope, place)` reads the inputs from the scope, applies the op's
    rule and writes the outputs back as tensors (reference op.py usage).
    """

    def __init__(self, type, **kwargs):
        if not registry.is_registered(type):
            raise ValueError(f"The operator: {type} is not registered.")
        self.type = type
        in_slots = set(registry.get_op_def(type).input_slots)
        self.inputs: Dict[str, List[str]] = {}
        self.outputs: Dict[str, List[str]] = {}
        self.attrs: Dict[str, object] = {}
        for key, val in kwargs.items():
            names = list(val) if isinstance(val, (list, tuple)) else [val]
            if key in in_slots:
                self.inputs[key] = names
            elif key[:1].isupper():
                # a capitalized non-input slot binds output names (the
                # rule says which outputs it makes when it runs)
                self.outputs[key] = names
            else:
                self.attrs[key] = val

    def input_names(self):
        return list(self.inputs)

    def output_names(self):
        return list(self.outputs)

    def run(self, scope, place=None):
        """Run on `place`'s device; with no place, on the device of the
        inputs, and for an op without inputs on CUDAPlace(0). A random op
        draws from a `torch.Generator` seeded from its `seed` attr (0
        when unset)."""
        opdef = registry.get_op_def(self.type)
        ins = {}
        for slot, names in self.inputs.items():
            vals = []
            for n in names:
                v = scope.find_var(n)
                if v is None:
                    raise KeyError(f"op {self.type}: input var {n!r} not "
                                   f"found in scope")
                vals.append(v)
            ins[slot] = vals
        if place is not None:
            device = place.torch_device()
        else:
            device = next((v.device for vals in ins.values() for v in vals
                           if isinstance(v, torch.Tensor)),
                          None) or CUDAPlace(0).torch_device()
        ins = {slot: [as_tensor(v, device) for v in vals]
               for slot, vals in ins.items()}
        seed = int(self.attrs.get("seed") or 0) if opdef.needs_rng else None
        ctx = registry.LoweringContext(self.attrs, device, seed=seed)
        outs = registry.call_rule(opdef, ctx, ins)
        for slot, names in self.outputs.items():
            produced = outs.get(slot)
            if produced is None:
                continue
            if len(produced) != len(names):
                raise ValueError(
                    f"op {self.type}: slot {slot} produced {len(produced)} "
                    f"value(s) but {len(names)} name(s) were bound")
            for name, val in zip(names, produced):
                scope.set_var(name, val)
        return outs
