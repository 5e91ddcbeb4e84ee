"""Tensor creation / shape / lookup op rules (the slices' subset).

Mirror of ``paddle_tpu/ops/tensor.py``: `fill_constant`,
`uniform_random`, `gaussian_random`, `assign`, `reshape`, `transpose`,
`concat`, `increment`, `lookup_table`, `sequence_mask`, `causal_mask`,
`sinusoid_pos_encoding`. Random ops draw from the op's own
`torch.Generator` (``core/registry.py``), on the op's device. `reshape`
and `transpose` return views where PyTorch can; `assign` copies, since
the optimizer rules update their state in place and an alias of a
parameter (``ModelAverage``'s backup) must keep its value.
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


@register_op("assign")
def _assign(ctx, X):
    return {"Out": X.clone()}


@register_op("concat")
def _concat(ctx, X):
    xs = X if isinstance(X, list) else [X]
    return {"Out": torch.cat(xs, dim=ctx.attr("axis", 0))}


@register_op("increment")
def _increment(ctx, X):
    """X + step in X's dtype (an integer counter stays an integer)."""
    return {"Out": X + torch.tensor(ctx.attr("step", 1.0)).to(
        dtype=X.dtype, device=X.device)}


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


@register_op("sequence_mask", propagate_seqlen=False)
def _sequence_mask(ctx, X):
    """Y[b, t] = t < X[b] for t < the static `maxlen`, in `out_dtype`
    (int64 by default; the JAX package's x32 mode makes it int32)."""
    maxlen = ctx.attr("maxlen", -1)
    if maxlen < 0:
        raise ValueError("sequence_mask needs a static maxlen")
    t = torch.arange(maxlen, device=X.device)
    return {"Y": (t[None, :] < X.reshape(-1, 1)).to(
        types.torch_dtype(ctx.attr("out_dtype", "int64")))}


@register_op("reshape")
def _reshape(ctx, X, Shape=None):
    shape = [int(s) for s in ctx.attr("shape")]
    # reference reshape_op.cc: 0 means "copy this dim from input"
    shape = [X.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return {"Out": X.reshape(shape)}


@register_op("transpose", propagate_seqlen=False)
def _transpose(ctx, X):
    return {"Out": X.permute(*ctx.attr("axis"))}


@register_op("causal_mask", propagate_seqlen=False)
def _causal_mask(ctx):
    """Additive float32 attention mask [1, 1, T, T]: `neg` above the
    diagonal, 0 on and below it, made on the device."""
    t = int(ctx.attr("size"))
    row = torch.arange(t, device=ctx.device)[:, None]
    col = torch.arange(t, device=ctx.device)[None, :]
    mask = torch.where(col > row,
                       torch.tensor(ctx.attr("neg", -1e9), dtype=torch.float32,
                                    device=ctx.device),
                       torch.zeros((), dtype=torch.float32, device=ctx.device))
    return {"Out": mask.reshape(1, 1, t, t)}


@register_op("sinusoid_pos_encoding", propagate_seqlen=False)
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
