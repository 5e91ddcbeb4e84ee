"""Parameter initializers appended as startup-program ops (mirror of
``paddle_tpu/initializer.py``: Constant, Uniform, Normal,
TruncatedNormal, Xavier, MSRA, Bilinear and NumpyArray, the global
defaults Xavier for weights and 0 for biases, and `init_on_cpu`)."""

from __future__ import annotations

import contextlib
import math

import numpy as np


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op("fill_constant", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op("uniform_random", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "min": float(self.low), "max": float(self.high),
                               "seed": self.seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op("gaussian_random", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "mean": float(self.loc),
                               "std": float(self.scale), "seed": self.seed})


class TruncatedNormalInitializer(Initializer):
    """`truncated_gaussian_random`: loc + scale * z, z the standard
    normal truncated to [-2, 2]."""

    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op("truncated_gaussian_random",
                        outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "mean": float(self.loc),
                               "std": float(self.scale), "seed": self.seed})


def _fan_in_out(var):
    shape = var.shape
    if len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
    elif len(shape) >= 3:
        receptive = math.prod(shape[2:])
        fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
    else:
        fan_in = fan_out = math.prod(shape)
    return fan_in, fan_out


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = (
            uniform, fan_in, fan_out, seed)

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    """He init from the fan-in: uniform in +-sqrt(6 / fan_in), or normal
    with std sqrt(2 / fan_in)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            NormalInitializer(0.0, math.sqrt(2.0 / fi), self.seed)(var, block)


class BilinearInitializer(Initializer):
    """The bilinear upsampling kernel for a 4-d `conv2d_transpose` weight
    (reference initializer.py), exact: an `assign_value` of the JAX
    package's values."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("bilinear init needs a 4-D weight")
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        weight = np.zeros(shape, dtype=np.float32)
        size = shape[2] * shape[3]
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            w = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
            weight.flat[i] = w if (i // size) % shape[1] == \
                (i // size // shape[1]) % shape[0] else 0
        block.append_op("assign_value", outputs={"Out": [var.name]},
                        attrs={"shape": list(shape), "dtype": var.dtype,
                               "values": [float(v)
                                          for v in weight.reshape(-1)]})


class NumpyArrayInitializer(Initializer):
    """The given array's values, exact (an `assign_value`)."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        block.append_op("assign_value", outputs={"Out": [var.name]},
                        attrs={"shape": list(self.value.shape),
                               "dtype": var.dtype,
                               "values": [float(v) for v in
                                          self.value.reshape(-1)]})


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer


def _global_weight_initializer():
    return XavierInitializer()


def _global_bias_initializer():
    return ConstantInitializer(0.0)


# Fluid pinned initializer ops to the CPU with these. In the JAX package
# the flag is kept and read by nothing: a startup program is one
# computation keyed on the program seed. Here too nothing reads it: a
# startup program runs on its executor's device, and each random op
# draws from its own generator seeded from (program seed, run, op
# index), so
# the values do not depend on where it runs. The API stays for source
# compatibility.
_force_init_on_cpu = False


def force_init_on_cpu():
    """Whether an `init_on_cpu` block is open (the flag is read by
    nothing, as in the JAX package)."""
    return _force_init_on_cpu


@contextlib.contextmanager
def init_on_cpu():
    """Set `force_init_on_cpu()` inside the block. As in the JAX package
    this moves no initializer: the startup program runs where its
    executor runs."""
    global _force_init_on_cpu
    prev = _force_init_on_cpu
    _force_init_on_cpu = True
    try:
        yield
    finally:
        _force_init_on_cpu = prev
