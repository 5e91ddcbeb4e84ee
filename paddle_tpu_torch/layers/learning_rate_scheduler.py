"""Learning-rate schedules as in-graph ops (mirror of
``paddle_tpu/layers/learning_rate_scheduler.py``; reference
python/paddle/fluid/layers/learning_rate_scheduler.py).

Each schedule builds a small subgraph over the persistable global step
counter ``@LR_DECAY_COUNTER@`` (float32 [1], 0 at startup), which the
optimizer pass increments once a step after its update ops. The
schedule's ops run on the device with the rest of the step: no value is
read back to the host. `staircase` rounds the decay's exponent down
(`floor`), polynomial decay's `cycle` rounds its period up (`ceil`).
"""

from __future__ import annotations

from .. import initializer as init
from ..layer_helper import LayerHelper
from . import nn, tensor


def _global_step(helper: LayerHelper):
    gb = helper.main_program.global_block()
    name = "@LR_DECAY_COUNTER@"
    if name in gb.vars:
        return gb.vars[name]
    var = gb.create_var(name=name, shape=(1,), dtype="float32",
                        persistable=True, stop_gradient=True)
    helper.set_variable_initializer(var, init.ConstantInitializer(0.0))
    return var


def global_learning_rate_counter():
    helper = LayerHelper("lr_counter")
    return _global_step(helper)


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    helper = LayerHelper("exponential_decay")
    step = _global_step(helper)
    div = step / float(decay_steps)
    if staircase:
        div = nn.floor(div)
    return learning_rate * (decay_rate ** div)


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    helper = LayerHelper("natural_exp_decay")
    step = _global_step(helper)
    div = step / float(decay_steps)
    if staircase:
        div = nn.floor(div)
    return learning_rate * nn.exp(div * (-decay_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    helper = LayerHelper("inverse_time_decay")
    step = _global_step(helper)
    div = step / float(decay_steps)
    if staircase:
        div = nn.floor(div)
    denom = div * decay_rate + 1.0
    return tensor.fill_constant([1], "float32", learning_rate) / denom


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    helper = LayerHelper("polynomial_decay")
    step = _global_step(helper)
    if cycle:
        ratio = nn.ceil(step / float(decay_steps))
        ratio = nn.elementwise_max(ratio, tensor.fill_constant(
            [1], "float32", 1.0))
        frac = step / (ratio * float(decay_steps))
    else:
        capped = nn.elementwise_min(step, tensor.fill_constant(
            [1], "float32", float(decay_steps)))
        frac = capped / float(decay_steps)
    one = tensor.fill_constant([1], "float32", 1.0)
    return (learning_rate - end_learning_rate) * ((one - frac) ** power) \
        + end_learning_rate


def piecewise_decay(boundaries, values):
    """Piecewise-constant lr as a sum of indicator windows, branch-free."""
    helper = LayerHelper("piecewise_decay")
    step = _global_step(helper)
    lr = tensor.fill_constant([1], "float32", 0.0)
    for i, v in enumerate(values):
        lo = boundaries[i - 1] if i > 0 else None
        hi = boundaries[i] if i < len(boundaries) else None
        ind = tensor.fill_constant([1], "float32", 1.0)
        if lo is not None:
            ind = ind * _ge_indicator(step, float(lo))
        if hi is not None:
            ind = ind * _lt_indicator(step, float(hi))
        lr = lr + ind * float(v)
    return lr


def _ge_indicator(step, bound):
    cmp = step >= tensor.fill_constant([1], "float32", bound)
    return nn.cast(cmp, "float32")


def _lt_indicator(step, bound):
    cmp = step < tensor.fill_constant([1], "float32", bound)
    return nn.cast(cmp, "float32")


def noam_decay(d_model, warmup_steps):
    """Transformer LR schedule (reference learning_rate_scheduler.py:44)."""
    helper = LayerHelper("noam_decay")
    step = _global_step(helper) + 1.0
    a = step ** -0.5
    b = step * (warmup_steps ** -1.5)
    return (d_model ** -0.5) * nn.elementwise_min(a, b)


def append_LARS(params_grads, learning_rate, weight_decay):
    """Layer-wise adaptive rate scaling (reference
    learning_rate_scheduler.py append_LARS): per-parameter
    lr = global_lr * ||w|| / (||g|| + weight_decay * ||w||), stored on the
    parameter's optimize_attr, where `Optimizer._lr_for_param` reads it."""

    def _balanced_weight(param_norm, grad_norm):
        if weight_decay == 1.0:
            return grad_norm + param_norm
        return grad_norm + weight_decay * param_norm

    for param, grad in params_grads:
        param_lr = param.optimize_attr.get("learning_rate", 1.0)
        param_norm = nn.sqrt(nn.reduce_sum(nn.square(param)))
        grad_norm = nn.sqrt(nn.reduce_sum(nn.square(grad)))
        if isinstance(param_lr, float) and param_lr == 1.0:
            decayed_lr = learning_rate * param_norm \
                / _balanced_weight(param_norm, grad_norm)
        else:
            decayed_lr = learning_rate * param_lr * param_norm \
                / _balanced_weight(param_norm, grad_norm)
        param.optimize_attr["learning_rate"] = decayed_lr
