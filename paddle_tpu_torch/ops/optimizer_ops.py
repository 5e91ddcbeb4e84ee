"""Optimizer update op rules (the slice's subset): `adam`.

Mirror of ``paddle_tpu/ops/optimizer_ops.py``. The JAX package writes
each update as a pure function and lets XLA donate the state buffers;
here the update is in place: `ParamOut`, `Moment1Out`, `Moment2Out` and
the `Beta*PowOut` outputs are the input tensors themselves, updated, so a
step never holds a second copy of the parameters or the moments (about
1.1 GB at Transformer-base) and the scope keeps the same tensors.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op


def _lr(LearningRate):
    return LearningRate.reshape(())


@register_op("adam")
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
