"""Weight-decay regularizers (reference: python/paddle/fluid/regularizer.py);
copy of ``paddle_tpu/regularizer.py`` (IR only).

Appended per-parameter to the gradient before the update op, exactly as the
reference does (`append_regularization_ops`)."""

from __future__ import annotations

from .core import ir


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(
            name=f"{param.name}@l2decay_{len(block.ops)}",
            shape=param.shape, dtype=param.dtype, stop_gradient=True)
        block.append_op("scale", inputs={"X": [param.name]},
                        outputs={"Out": [decay.name]},
                        attrs={"scale": self._coeff})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = block.create_var(
            name=f"{param.name}@l1sign_{len(block.ops)}",
            shape=param.shape, dtype=param.dtype, stop_gradient=True)
        block.append_op("sign", inputs={"X": [param.name]},
                        outputs={"Out": [sign.name]})
        decay = block.create_var(
            name=f"{param.name}@l1decay_{len(block.ops)}",
            shape=param.shape, dtype=param.dtype, stop_gradient=True)
        block.append_op("scale", inputs={"X": [sign.name]},
                        outputs={"Out": [decay.name]},
                        attrs={"scale": self._coeff})
        return decay


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(parameters_and_grads, regularization=None):
    """Add decay terms onto each gradient (reference regularizer.py:24)."""
    params_and_grads = []
    for param, grad in parameters_and_grads:
        if grad is None:
            params_and_grads.append((param, grad))
            continue
        regularizer = param.regularizer or regularization
        if regularizer is None:
            params_and_grads.append((param, grad))
            continue
        block = grad.block
        decay = regularizer(param, grad, block)
        new_grad = block.create_var(
            name=f"{grad.name}@reg_{len(block.ops)}",
            shape=grad.shape, dtype=grad.dtype, stop_gradient=True)
        block.append_op("sum", inputs={"X": [grad.name, decay.name]},
                        outputs={"Out": [new_grad.name]})
        params_and_grads.append((param, new_grad))
    return params_and_grads
