"""The layers DSL (the slices' subset of ``paddle_tpu/layers``)."""

from .io import data  # noqa: F401
from .metric_op import accuracy  # noqa: F401
from .nn import (batch_norm, cast, conv2d, cross_entropy,  # noqa: F401
                 dropout, elementwise_add, embedding, fc, layer_norm, matmul,
                 mean, pool2d, relu, reshape, scale, softmax,
                 softmax_with_cross_entropy, topk, transpose)
