"""The layers DSL (the slices' subset of ``paddle_tpu/layers``)."""

from .io import data  # noqa: F401
from .nn import (cast, dropout, elementwise_add, embedding, fc,  # noqa: F401
                 layer_norm, matmul, mean, relu, reshape, scale,
                 softmax_with_cross_entropy, transpose)
