"""Tensor creation / shape / lookup op rules (the slices' subset).

Mirror of ``paddle_tpu/ops/tensor.py``: `fill_constant`,
`uniform_random`, `gaussian_random`, `reshape`, `transpose`,
`lookup_table`, `sinusoid_pos_encoding`. Random ops draw
from the op's own `torch.Generator` (``core/registry.py``), on the op's
device. `reshape` and `transpose` return views where PyTorch can.
"""

from __future__ import annotations

import torch

from ..core import types
from ..core.registry import register_op


@register_op("fill_constant")
def _fill_constant(ctx, X=None):
    shape = [int(s) for s in ctx.attr("shape", [1])]
    return {"Out": torch.full(shape, ctx.attr("value", 0.0),
                              dtype=types.torch_dtype(
                                  ctx.attr("dtype", "float32")),
                              device=ctx.device)}


@register_op("uniform_random", needs_rng=True)
def _uniform_random(ctx, X=None):
    shape = [int(s) for s in ctx.attr("shape")]
    out = torch.empty(shape, dtype=types.torch_dtype(
        ctx.attr("dtype", "float32")), device=ctx.device)
    out.uniform_(ctx.attr("min", -1.0), ctx.attr("max", 1.0),
                 generator=ctx.generator)
    return {"Out": out}


@register_op("gaussian_random", needs_rng=True)
def _gaussian_random(ctx, X=None):
    shape = [int(s) for s in ctx.attr("shape")]
    out = torch.empty(shape, dtype=types.torch_dtype(
        ctx.attr("dtype", "float32")), device=ctx.device)
    out.normal_(ctx.attr("mean", 0.0), ctx.attr("std", 1.0),
                generator=ctx.generator)
    return {"Out": out}


@register_op("lookup_table")
def _lookup_table(ctx, W, Ids):
    """Embedding lookup (reference lookup_table_op.cc). Ids has a trailing
    size-1 dim in the reference convention."""
    ids = Ids
    if ids.ndim and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    out = torch.nn.functional.embedding(ids.long(), W)
    pad = ctx.attr("padding_idx", -1)
    if pad is not None and pad >= 0:
        out = out * (ids != pad).unsqueeze(-1).to(out.dtype)
    return {"Out": out}


@register_op("reshape")
def _reshape(ctx, X, Shape=None):
    shape = [int(s) for s in ctx.attr("shape")]
    # reference reshape_op.cc: 0 means "copy this dim from input"
    shape = [X.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return {"Out": X.reshape(shape)}


@register_op("transpose")
def _transpose(ctx, X):
    return {"Out": X.permute(*ctx.attr("axis"))}


@register_op("sinusoid_pos_encoding")
def _sinusoid_pos_encoding(ctx):
    """Transformer sinusoidal position table [T, D], computed on the
    device (the JAX package's formula, in float32)."""
    t = int(ctx.attr("size"))
    d = int(ctx.attr("d_model"))
    pos = torch.arange(t, dtype=torch.float32, device=ctx.device)[:, None]
    i = torch.arange(d, dtype=torch.float32, device=ctx.device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=ctx.device),
                            (2.0 * torch.floor(i / 2.0)) / d)
    even = torch.arange(d, device=ctx.device)[None, :] % 2 == 0
    return {"Out": torch.where(even, torch.sin(angle), torch.cos(angle))}
