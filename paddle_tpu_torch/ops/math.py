"""Math / elementwise / activation op rules (the slices' subset).

Mirror of ``paddle_tpu/ops/math.py``: `elementwise_add`, `mul`,
`matmul`, `scale`, `sum`, `mean`, `relu`, `cast`, `softmax`, `top_k`.
Matrix products go to `torch.matmul`, as the JAX package leaves them to
XLA; in float32 on the card they run in full float32
(`torch.backends.cuda.matmul.allow_tf32` is False by default).
"""

from __future__ import annotations

import math

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


@register_op("mul")
def _mul(ctx, X, Y):
    """Flattening matmul (reference mul_op.cc): X flattened to 2-D at
    x_num_col_dims, Y at y_num_col_dims, one GEMM, the result shaped
    X.shape[:x_num_col_dims] + Y.shape[y_num_col_dims:]."""
    xd = ctx.attr("x_num_col_dims", 1)
    yd = ctx.attr("y_num_col_dims", 1)
    if X.dtype != Y.dtype:
        dt = torch.promote_types(X.dtype, Y.dtype)
        X, Y = X.to(dt), Y.to(dt)
    xs, ys = X.shape, Y.shape
    x2 = X.reshape(math.prod(xs[:xd]), math.prod(xs[xd:]))
    y2 = Y.reshape(math.prod(ys[:yd]), math.prod(ys[yd:]))
    return {"Out": torch.matmul(x2, y2).reshape(*xs[:xd], *ys[yd:])}


@register_op("matmul")
def _matmul(ctx, X, Y):
    a = X.transpose(-1, -2) if ctx.attr("transpose_X", False) else X
    b = Y.transpose(-1, -2) if ctx.attr("transpose_Y", False) else Y
    out = torch.matmul(a, b)
    alpha = ctx.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * types.scalar_as(alpha, out.dtype)
    return {"Out": out}


@register_op("relu")
def _relu(ctx, X):
    return {"Out": torch.relu(X)}


@register_op("cast")
def _cast(ctx, X):
    return {"Out": X.to(types.torch_dtype(ctx.attr("out_dtype", "float32")))}


@register_op("scale")
def _scale(ctx, X):
    s = types.scalar_as(ctx.attr("scale", 1.0), X.dtype)
    b = types.scalar_as(ctx.attr("bias", 0.0), X.dtype)
    if ctx.attr("bias_after_scale", True):
        return {"Out": X * s + b}
    return {"Out": (X + b) * s}


@register_op("sum")
def _sum(ctx, X):
    xs = X if isinstance(X, list) else [X]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


@register_op("mean")
def _mean(ctx, X):
    return {"Out": X.mean().reshape(1)}


@register_op("softmax")
def _softmax(ctx, X):
    return {"Out": torch.softmax(X, dim=ctx.attr("axis", -1))}


@register_op("top_k")
def _top_k(ctx, X):
    """The k largest along the last dim, in descending order. Indices are
    int64, the port's index dtype (``core/types.py``)."""
    vals, idx = torch.topk(X, ctx.attr("k", 1), dim=-1)
    return {"Out": vals, "Indices": idx}
