"""Optimizer update op rules: `sgd`, `momentum`, `adam`, `adamax`,
`adagrad`, `decayed_adagrad`, `adadelta`, `rmsprop` (centered or not),
`ftrl`, `proximal_gd`, `proximal_adagrad`, and `average_accumulates`
(``ModelAverage``'s window sums).

Mirror of ``paddle_tpu/ops/optimizer_ops.py``, each rule the JAX rule's
arithmetic in its order. The JAX package writes each update as a pure
function and lets XLA donate the state buffers; here the update is in
place: `ParamOut` and every state output (`VelocityOut`, `Moment1Out`,
`MomentOut`, `MeanSquareOut`, the `Beta*PowOut` powers, the window sums
and counters, ...) are the input tensors themselves, updated, so a step
never holds a second copy of the parameters or their state (about 1.1 GB
at Transformer-base) and the scope keeps the same tensors. A rule that
reads a state's old value after computing its new one keeps the new one
in a temporary until the old one is read.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op


def _lr(LearningRate):
    return LearningRate.reshape(())


@register_op("sgd", propagate_seqlen=False)
def _sgd(ctx, Param, Grad, LearningRate):
    Param.sub_(_lr(LearningRate) * Grad.to(Param.dtype))
    return {"ParamOut": Param}


@register_op("momentum", propagate_seqlen=False)
def _momentum(ctx, Param, Grad, Velocity, LearningRate):
    """v <- mu * v + g; p <- p - lr * v, or with Nesterov
    p <- p - (g + mu * v) * lr (reference momentum_op.h)."""
    mu = ctx.attr("mu", 0.9)
    lr = _lr(LearningRate)
    Velocity.mul_(mu).add_(Grad)
    if ctx.attr("use_nesterov", False):
        Param.sub_((Grad + mu * Velocity) * lr)
    else:
        Param.sub_(lr * Velocity)
    return {"ParamOut": Param, "VelocityOut": Velocity}


@register_op("adam", propagate_seqlen=False)
def _adam(ctx, Param, Grad, Moment1, Moment2, Beta1Pow, Beta2Pow,
          LearningRate):
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    lr = _lr(LearningRate)
    Moment1.mul_(b1).add_((1 - b1) * Grad)
    Moment2.mul_(b2).add_((1 - b2) * Grad * Grad)
    lr_t = lr * torch.sqrt(1 - Beta2Pow.reshape(())) / (1 - Beta1Pow.reshape(()))
    Param.sub_(lr_t * Moment1 / (torch.sqrt(Moment2) + eps))
    Beta1Pow.mul_(b1)
    Beta2Pow.mul_(b2)
    return {"ParamOut": Param, "Moment1Out": Moment1, "Moment2Out": Moment2,
            "Beta1PowOut": Beta1Pow, "Beta2PowOut": Beta2Pow}


@register_op("adamax", propagate_seqlen=False)
def _adamax(ctx, Param, Grad, Moment, InfNorm, Beta1Pow, LearningRate):
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    lr = _lr(LearningRate)
    Moment.mul_(b1).add_((1 - b1) * Grad)
    torch.maximum(InfNorm.mul_(b2), torch.abs(Grad), out=InfNorm)
    Param.sub_((lr / (1 - Beta1Pow.reshape(()))) * Moment / (InfNorm + eps))
    Beta1Pow.mul_(b1)
    return {"ParamOut": Param, "MomentOut": Moment, "InfNormOut": InfNorm,
            "Beta1PowOut": Beta1Pow}


@register_op("adagrad", propagate_seqlen=False)
def _adagrad(ctx, Param, Grad, Moment, LearningRate):
    eps = ctx.attr("epsilon", 1e-6)
    Moment.add_(Grad * Grad)
    Param.sub_(_lr(LearningRate) * Grad / (torch.sqrt(Moment) + eps))
    return {"ParamOut": Param, "MomentOut": Moment}


@register_op("decayed_adagrad", propagate_seqlen=False)
def _decayed_adagrad(ctx, Param, Grad, Moment, LearningRate):
    decay = ctx.attr("decay", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    Moment.mul_(decay).add_((1 - decay) * Grad * Grad)
    Param.sub_(_lr(LearningRate) * Grad / (torch.sqrt(Moment) + eps))
    return {"ParamOut": Param, "MomentOut": Moment}


@register_op("adadelta", propagate_seqlen=False)
def _adadelta(ctx, Param, Grad, AvgSquaredGrad, AvgSquaredUpdate):
    rho = ctx.attr("rho", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    AvgSquaredGrad.mul_(rho).add_((1 - rho) * Grad * Grad)
    update = -torch.sqrt((AvgSquaredUpdate + eps) / (AvgSquaredGrad + eps)) \
        * Grad
    AvgSquaredUpdate.mul_(rho).add_((1 - rho) * update * update)
    Param.add_(update)
    return {"ParamOut": Param, "AvgSquaredGradOut": AvgSquaredGrad,
            "AvgSquaredUpdateOut": AvgSquaredUpdate}


@register_op("rmsprop", propagate_seqlen=False)
def _rmsprop(ctx, Param, Grad, MeanSquare, Moment, LearningRate,
             MeanGrad=None):
    rho = ctx.attr("decay", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    mu = ctx.attr("momentum", 0.0)
    lr = _lr(LearningRate)
    MeanSquare.mul_(rho).add_((1 - rho) * Grad * Grad)
    out = {"ParamOut": Param, "MeanSquareOut": MeanSquare,
           "MomentOut": Moment}
    if ctx.attr("centered", False) and MeanGrad is not None:
        MeanGrad.mul_(rho).add_((1 - rho) * Grad)
        denom = torch.rsqrt(MeanSquare - MeanGrad * MeanGrad + eps)
        out["MeanGradOut"] = MeanGrad
    else:
        denom = torch.rsqrt(MeanSquare + eps)
    Moment.mul_(mu).add_(lr * Grad * denom)
    Param.sub_(Moment)
    return out


@register_op("ftrl", propagate_seqlen=False)
def _ftrl(ctx, Param, Grad, SquaredAccumulator, LinearAccumulator,
          LearningRate):
    l1 = ctx.attr("l1", 0.0)
    l2 = ctx.attr("l2", 0.0)
    lr_power = ctx.attr("lr_power", -0.5)
    lr = _lr(LearningRate)
    new_sq = SquaredAccumulator + Grad * Grad
    if lr_power == -0.5:
        new_root = torch.sqrt(new_sq)
        sigma = (new_root - torch.sqrt(SquaredAccumulator)) / lr
    else:
        new_root = torch.pow(new_sq, -lr_power)
        sigma = (new_root - torch.pow(SquaredAccumulator, -lr_power)) / lr
    lin = LinearAccumulator + Grad - sigma * Param
    y = new_root / lr + 2 * l2
    pre_shrink = (-lin + torch.sign(lin) * l1) / y
    Param.copy_(torch.where(torch.abs(lin) > l1, pre_shrink,
                            torch.zeros_like(pre_shrink)))
    SquaredAccumulator.copy_(new_sq)
    LinearAccumulator.copy_(lin)
    return {"ParamOut": Param, "SquaredAccumOut": SquaredAccumulator,
            "LinearAccumOut": LinearAccumulator}


def _proximal(prox, lr, l1, l2):
    return torch.sign(prox) * torch.clamp(torch.abs(prox) - lr * l1, min=0.0) \
        / (1.0 + lr * l2)


@register_op("proximal_gd", propagate_seqlen=False)
def _proximal_gd(ctx, Param, Grad, LearningRate):
    lr = _lr(LearningRate)
    Param.copy_(_proximal(Param - lr * Grad, lr, ctx.attr("l1", 0.0),
                          ctx.attr("l2", 0.0)))
    return {"ParamOut": Param}


@register_op("proximal_adagrad", propagate_seqlen=False)
def _proximal_adagrad(ctx, Param, Grad, Moment, LearningRate):
    Moment.add_(Grad * Grad)
    lr = _lr(LearningRate) / torch.sqrt(Moment + 1e-12)
    Param.copy_(_proximal(Param - lr * Grad, lr, ctx.attr("l1", 0.0),
                          ctx.attr("l2", 0.0)))
    return {"ParamOut": Param, "MomentOut": Moment}


@register_op("average_accumulates", propagate_seqlen=False)
def _average_accumulates(ctx, param, in_sum_1, in_sum_2, in_sum_3,
                         in_num_accumulates, in_old_num_accumulates,
                         in_num_updates):
    """Sliding-window parameter sums for ModelAverage (reference
    average_accumulates_op.h:44-135), the JAX rule's selects: sum_1 rolls
    into sum_2 every 16384 updates; once the window passes
    min(max_average_window, int(num_updates * average_window)) (and
    min_average_window) both roll into sum_3 and the count restarts. The
    counters stay on the device: no branch reads them on the host."""
    avg_win = float(ctx.attr("average_window", 0.0))
    max_win = int(ctx.attr("max_average_window", 10000))
    min_win = int(ctx.attr("min_average_window", 10000))
    k_max = 16384  # kMaxNumAccumulates

    num_updates = in_num_updates + 1
    num_acc = in_num_accumulates + 1
    nu = num_updates.reshape(())
    na = num_acc.reshape(())
    zero = torch.zeros((), dtype=param.dtype, device=param.device)

    s1 = in_sum_1 + param
    roll = (nu % k_max) == 0
    s2 = torch.where(roll, in_sum_2 + s1, in_sum_2)
    s1 = torch.where(roll, zero, s1)
    win = torch.clamp((nu.float() * avg_win).to(nu.dtype), max=max_win)
    trigger = (na >= min_win) & (na >= win)
    in_sum_3.copy_(torch.where(trigger, s1 + s2, in_sum_3))
    in_sum_1.copy_(torch.where(trigger, zero, s1))
    in_sum_2.copy_(torch.where(trigger, zero, s2))
    in_old_num_accumulates.copy_(torch.where(trigger, num_acc,
                                             in_old_num_accumulates))
    in_num_accumulates.copy_(torch.where(trigger, torch.zeros_like(num_acc),
                                         num_acc))
    in_num_updates.copy_(num_updates)
    return {"out_sum_1": in_sum_1, "out_sum_2": in_sum_2,
            "out_sum_3": in_sum_3,
            "out_num_accumulates": in_num_accumulates,
            "out_old_num_accumulates": in_old_num_accumulates,
            "out_num_updates": in_num_updates}
