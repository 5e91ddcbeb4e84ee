"""Math / elementwise / activation op rules (the slice's subset).

Mirror of ``paddle_tpu/ops/math.py``: `elementwise_add`, `matmul`,
`relu`, `cast`. Matrix products go to `torch.matmul`, as the JAX package
leaves them to XLA; in float32 on the card they run in full float32
(`torch.backends.cuda.matmul.allow_tf32` is False by default).
"""

from __future__ import annotations

import torch

from ..core import types
from ..core.registry import register_op


def _align_y(X, Y, axis):
    """Reference elementwise broadcast semantics (elementwise_op_function.h):
    Y's dims match a contiguous run of X's dims starting at `axis`."""
    if Y.ndim == 0 or X.shape == Y.shape or Y.ndim == X.ndim:
        return Y
    axis = int(axis)
    if axis < 0:
        axis = X.ndim - Y.ndim
    return Y.reshape([1] * axis + list(Y.shape)
                     + [1] * (X.ndim - axis - Y.ndim))


@register_op("elementwise_add")
def _elementwise_add(ctx, X, Y):
    return {"Out": X + _align_y(X, Y, ctx.attr("axis", -1))}


@register_op("matmul")
def _matmul(ctx, X, Y):
    a = X.transpose(-1, -2) if ctx.attr("transpose_X", False) else X
    b = Y.transpose(-1, -2) if ctx.attr("transpose_Y", False) else Y
    out = torch.matmul(a, b)
    alpha = ctx.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": out}


@register_op("relu")
def _relu(ctx, X):
    return {"Out": torch.relu(X)}


@register_op("cast")
def _cast(ctx, X):
    return {"Out": X.to(types.torch_dtype(ctx.attr("out_dtype", "float32")))}
