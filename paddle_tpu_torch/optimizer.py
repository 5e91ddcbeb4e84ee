"""Optimizers: backward + per-parameter update ops appended to the program.

The slice's subset of ``paddle_tpu/optimizer.py`` (reference
python/paddle/fluid/optimizer.py: Optimizer base :36, accumulators,
`minimize` :245 = append_backward + regularization + clip + update ops;
Adam :452): the `Optimizer` base, `MomentumOptimizer` (alias
`Momentum`) and `AdamOptimizer` (alias `Adam`), copied with their
imports rewired, so `minimize` appends the same ops to the same program.
The other optimizers are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

from . import initializer as init
from . import unique_name
from .clip import append_gradient_clip_ops
from .core import ir
from .core.backward import append_backward
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self.regularization = regularization
        self._name = name
        self._learning_rate = learning_rate
        self._accumulators: Dict[str, Dict[str, ir.Variable]] = {}
        self._lr_var: Optional[ir.Variable] = None
        self.helper = None

    # -- learning rate ----------------------------------------------------
    def _create_lr_var(self, program) -> ir.Variable:
        if isinstance(self._learning_rate, ir.Variable):
            return self._learning_rate
        helper = LayerHelper("learning_rate")
        name = unique_name.generate("learning_rate")
        gb = program.global_block()
        var = gb.create_var(name=name, shape=(1,), dtype="float32",
                            persistable=True, stop_gradient=True)
        helper.set_variable_initializer(
            var, init.ConstantInitializer(float(self._learning_rate)))
        return var

    def _global_learning_rate(self):
        return self._lr_var

    # -- accumulators (reference optimizer.py:103-166) --------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if name in self._accumulators and param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        helper = LayerHelper(name)
        var_name = unique_name.generate(f"{param.name}_{name}")
        gb = param.block.program.global_block()
        var = gb.create_var(name=var_name, shape=shape or param.shape,
                            dtype=dtype or param.dtype, persistable=True,
                            stop_gradient=True)
        helper.set_variable_initializer(var, init.ConstantInitializer(fill_value))
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- hooks per optimizer ----------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block, parameters_and_grads):
        pass

    # -- the pass ----------------------------------------------------------
    def _create_optimization_pass(self, parameters_and_grads, loss,
                                  startup_program=None):
        program = loss.block.program
        self._lr_var = self._create_lr_var(program)
        block = program.global_block()
        self._create_accumulators(block,
                                  [p for p, g in parameters_and_grads if g is not None])
        optimize_ops = []
        for param_and_grad in parameters_and_grads:
            if param_and_grad[1] is None:
                continue
            optimize_ops.append(self._append_optimize_op(block, param_and_grad))
        self._finish_update(block, parameters_and_grads)
        # bump the LR-decay global step if a schedule created one
        if "@LR_DECAY_COUNTER@" in block.vars:
            ctr = block.vars["@LR_DECAY_COUNTER@"]
            block.append_op("increment", inputs={"X": [ctr.name]},
                            outputs={"Out": [ctr.name]}, attrs={"step": 1.0})
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """append_backward + regularization + clip + update ops
        (reference optimizer.py:245)."""
        block = loss.block.program.global_block()
        n0 = len(block.ops)
        params_grads = append_backward(loss, parameter_list=parameter_list,
                                       no_grad_set=no_grad_set)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        optimize_ops = self._create_optimization_pass(params_grads, loss,
                                                      startup_program)
        # role-tag everything minimize appended (clip/reg/lr/update ops);
        # grad ops were already tagged "backward" by append_backward. Eval
        # clones strip by role (ir._set_inference_mode).
        for op in block.ops[n0:]:
            op.attrs.setdefault("__role__", "optimize")
        return optimize_ops, params_grads

    def _lr_for_param(self, param):
        """Per-parameter lr multiplier (ParamAttr.learning_rate). Only the
        default 1.0 is ported: the JAX package scales the lr Variable by
        operator sugar (`layers/math_op_patch.py`) that the port lacks."""
        mult = getattr(param, "optimize_attr", {}).get("learning_rate", 1.0)
        if isinstance(mult, ir.Variable) or mult != 1.0:
            raise NotImplementedError(
                f"parameter {param.name!r}: a per-parameter learning rate "
                f"({mult!r}) is not ported to paddle_tpu_torch yet")
        return self._lr_var


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            inputs={"Param": [p.name], "Grad": [g.name], "Velocity": [v.name],
                    "LearningRate": [self._lr_for_param(p).name]},
            outputs={"ParamOut": [p.name], "VelocityOut": [v.name]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self.type = "adam"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1 = self._get_accumulator("beta1_pow_acc", p)
        b2 = self._get_accumulator("beta2_pow_acc", p)
        return block.append_op(
            "adam",
            inputs={"Param": [p.name], "Grad": [g.name], "Moment1": [m1.name],
                    "Moment2": [m2.name], "Beta1Pow": [b1.name],
                    "Beta2Pow": [b2.name],
                    "LearningRate": [self._lr_for_param(p).name]},
            outputs={"ParamOut": [p.name], "Moment1Out": [m1.name],
                     "Moment2Out": [m2.name], "Beta1PowOut": [b1.name],
                     "Beta2PowOut": [b2.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


Momentum = MomentumOptimizer
Adam = AdamOptimizer
