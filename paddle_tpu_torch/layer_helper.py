"""LayerHelper: shared plumbing for the layers DSL.

Mirror of ``paddle_tpu/layer_helper.py``: creates parameters
(appending their initializer ops to the startup program), temporary and
global variables, the length companions of variable-length vars and ops,
and runs build-time shape inference through the op registry (the rules
themselves, on meta tensors).
"""

from __future__ import annotations

from typing import Optional

from . import initializer as init
from . import unique_name
from .core import ir, registry
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name else unique_name.generate(layer_type)

    @property
    def main_program(self) -> ir.Program:
        return ir.default_main_program()

    @property
    def startup_program(self) -> ir.Program:
        return ir.default_startup_program()

    @property
    def block(self) -> ir.Block:
        return self.main_program.current_block()

    @property
    def bias_attr(self):
        battr = self.kwargs.get("bias_attr")
        if battr is False:
            return False
        return ParamAttr._to_attr(battr)

    # -- variable creation ----------------------------------------------
    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None,
                         stop_gradient=False) -> ir.Parameter:
        attr = ParamAttr._to_attr(attr)
        name = attr.name or unique_name.generate(f"{self.name}.w")
        gb = self.main_program.global_block()
        if name in gb.vars:
            return gb.vars[name]
        initializer = attr.initializer or default_initializer
        if initializer is None:
            initializer = (init._global_bias_initializer() if is_bias
                           else init._global_weight_initializer())
        param = gb.create_parameter(
            name, shape, dtype, trainable=attr.trainable,
            regularizer=attr.regularizer, gradient_clip=attr.gradient_clip,
            sharding=attr.sharding, stop_gradient=stop_gradient)
        param.optimize_attr = {"learning_rate": attr.learning_rate}
        # mirror into startup program + append its initializer op there
        sb = self.startup_program.global_block()
        if name not in sb.vars:
            svar = sb.create_parameter(name, shape, dtype,
                                       trainable=attr.trainable)
            initializer(svar, sb)
        return param

    def create_variable_for_type_inference(self, dtype="float32",
                                           stop_gradient=False) -> ir.Variable:
        return self.block.create_var(
            name=unique_name.generate(f"{self.name}.tmp"),
            shape=(), dtype=dtype, stop_gradient=stop_gradient)

    def create_global_variable(self, name=None, shape=(1,), dtype="float32",
                               persistable=False,
                               stop_gradient=True) -> ir.Variable:
        """A variable of the main program's global block (an `auc`
        histogram, a step counter), named after the layer when unnamed."""
        return self.main_program.global_block().create_var(
            name=name or unique_name.generate(f"{self.name}.global"),
            shape=shape, dtype=dtype, persistable=persistable,
            stop_gradient=stop_gradient)

    def set_variable_initializer(self, var, initializer):
        sb = self.startup_program.global_block()
        if var.name not in sb.vars:
            svar = sb.create_var(name=var.name, shape=var.shape,
                                 dtype=var.dtype, persistable=True)
            initializer(svar, sb)

    # -- op creation with shape inference --------------------------------
    def append_op(self, type: str, inputs=None, outputs=None,
                  attrs=None) -> ir.Operator:
        op = self.block.append_op(type, inputs, outputs, attrs)
        self._infer_shapes(op)
        return op

    def _infer_shapes(self, op: ir.Operator):
        if not registry.is_registered(op.type):
            return
        block = self.block
        try:
            ins = {slot: [(block.var(n).shape, block.var(n).dtype)
                          for n in names]
                   for slot, names in op.inputs.items()}
            result = registry.infer_op_shapes(op.type, op.attrs, ins)
        except NotImplementedError:
            raise
        except Exception:
            return  # runtime shapes remain authoritative
        for slot, names in op.outputs.items():
            for n, (shape, dtype) in zip(names, result.get(slot, ())):
                v = block.vars.get(n)
                if v is not None and not v.shape:
                    v.shape = shape
                    v.dtype = dtype

    # -- activation sugar -------------------------------------------------
    def append_activation(self, input_var: ir.Variable) -> ir.Variable:
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act_type = act.pop("type")
        out = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(act_type, inputs={"X": [input_var.name]},
                       outputs={"Out": [out.name]}, attrs=act)
        out.lod_level = input_var.lod_level
        return out

    # -- sequence plumbing -------------------------------------------------
    def ensure_seqlen_var(self, var: ir.Variable,
                          level: int = 0) -> Optional[ir.Variable]:
        """The lengths companion of LoD level `level` of a
        variable-length var, declared on first use, so that a sequence op
        can take it as an explicit input. Level 0 is the outermost
        (int32 [B]); level 1 the nested inner lengths (int32 [B, S]).
        None when `var` has no such level."""
        if var.lod_level <= level:
            return None
        name = ir.seqlen_var_name(var.name, level)
        blk = var.block
        if name in blk.vars:
            return blk.vars[name]
        return blk.create_var(name=name, shape=(-1,) * (level + 1),
                              dtype="int32", stop_gradient=True)
