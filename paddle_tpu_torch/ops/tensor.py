"""Tensor creation / lookup op rules (the slice's subset).

Mirror of ``paddle_tpu/ops/tensor.py``: `fill_constant`,
`gaussian_random`, `lookup_table`. Random ops draw from the op's own
`torch.Generator` (``core/lowering.py``), on the op's device.
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
