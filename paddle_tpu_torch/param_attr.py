"""ParamAttr (reference: python/paddle/fluid/param_attr.py); copy of
``paddle_tpu/param_attr.py``."""

from __future__ import annotations

from . import initializer as init


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 sharding=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        # kept for the shared program format (a PartitionSpec-like tuple)
        self.sharding = sharding

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, init.Initializer):
            return ParamAttr(initializer=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else False
        raise TypeError(f"cannot convert {arg!r} to ParamAttr")

