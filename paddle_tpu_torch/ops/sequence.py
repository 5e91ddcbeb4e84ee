"""Sequence op rules over padded variable-length batches (mirror of
``paddle_tpu/ops/sequence.py``; reference
paddle/fluid/operators/sequence_{pool,softmax,expand,...}_op.cc).

A LoD batch is a padded dense [B, T, ...] tensor and an int32 length
vector, its `@SEQLEN` companion, which a sequence op takes in its
`SeqLen` slot. Every rule here is masking, reductions and gathers on
the whole batch: no rule reads a length back to the host, so the shapes
a rule makes depend on the padded shapes alone. Gathers index in int64
(the port's index dtype, ``core/types.py``); the lengths stay int32.

Nested (level-2) input, data [B, S, T, ...] with inner lengths [B, S]:
the rules that take it run their level-1 rule on the flattened (doc,
sentence) rows and restore the nesting (reference lod_tensor.h:110:
sequence ops act on the innermost level).
"""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .math import _sum_as_jnp


def _time_mask(SeqLen, T, dtype=torch.float32):
    """[B, T]: 1 where t < the row's length."""
    t = torch.arange(T, device=SeqLen.device)
    return (t[None, :] < SeqLen.reshape(-1, 1)).to(dtype)


def _full_lengths(X):
    """Every row full: int32 [B] of T."""
    return torch.full((X.shape[0],), X.shape[1], dtype=torch.int32,
                      device=X.device)


def _flat_rows(a):
    """[B, S, rest...] -> [B * S, rest...]."""
    return a.reshape((a.shape[0] * a.shape[1],) + tuple(a.shape[2:]))


def _unflat_rows(a, B, S):
    return a.reshape((B, S) + tuple(a.shape[1:]))


def _gather_time(X, idx):
    """X[b, idx[b, t], ...] for an index [B, T'] along the time axis."""
    B, T2 = idx.shape
    g = idx.long().reshape((B, T2) + (1,) * (X.ndim - 2))
    return torch.gather(X, 1, g.expand((B, T2) + tuple(X.shape[2:])))


def _bcast(v, ndim):
    """A [B] vector shaped to broadcast against a [B, ...] of `ndim`."""
    return v.reshape((-1,) + (1,) * (ndim - 1))


@register_op("sequence_pool", propagate_seqlen=False)
def _sequence_pool(ctx, X, SeqLen=None):
    """[B, T, D] and lengths -> [B, D]; pooltype average, sum, sqrt,
    max, last or first (reference sequence_pool_op.cc). Nested input
    [B, S, T, D] with inner lengths [B, S] pools the innermost level to
    [B, S, D]. `max` takes `amax`, whose grad splits evenly among tied
    maxima as `jnp.max`'s does."""
    ptype = ctx.attr("pooltype", "AVERAGE").lower()
    if SeqLen is not None and SeqLen.ndim == 2:
        B, S = X.shape[0], X.shape[1]
        out = _sequence_pool(ctx, _flat_rows(X), SeqLen.reshape(-1))["Out"]
        return {"Out": _unflat_rows(out, B, S)}
    T = X.shape[1]
    L = SeqLen if SeqLen is not None else _full_lengths(X)
    m = _time_mask(L, T, X.dtype)
    while m.ndim < X.ndim:
        m = m[..., None]
    if ptype in ("sum", "average", "sqrt"):
        out = _sum_as_jnp(X * m, (1,))
        if ptype != "sum":
            n = torch.clamp(L.to(X.dtype), min=1.0)
            if ptype == "sqrt":
                n = torch.sqrt(n)
            out = out / _bcast(n, out.ndim)
    elif ptype == "max":
        info = (torch.finfo if X.is_floating_point() else torch.iinfo)(
            X.dtype)
        neg = torch.tensor(info.min, dtype=X.dtype, device=X.device)
        out = torch.where(m > 0, X, neg).amax(dim=1)
    elif ptype == "last":
        idx = torch.clamp(L - 1, min=0).reshape(-1, 1)
        out = _gather_time(X, idx)[:, 0]
    elif ptype == "first":
        out = X[:, 0]
    else:
        raise ValueError(f"unknown pooltype {ptype}")
    return {"Out": out}


@register_op("sequence_softmax", propagate_seqlen=False)
def _sequence_softmax(ctx, X, SeqLen=None):
    """Softmax over the time axis within each row's valid prefix, in
    float32; padded positions are 0."""
    if SeqLen is not None and SeqLen.ndim == 2:
        B, S = X.shape[0], X.shape[1]
        out = _sequence_softmax(ctx, _flat_rows(X), SeqLen.reshape(-1))
        return {"Out": _unflat_rows(out["Out"], B, S)}
    T = X.shape[1]
    L = SeqLen if SeqLen is not None else _full_lengths(X)
    m = _time_mask(L, T, torch.float32)
    while m.ndim < X.ndim:
        m = m[..., None]
    neg = torch.tensor(torch.finfo(torch.float32).min, device=X.device)
    logits = torch.where(m > 0, X.float(), neg)
    out = torch.softmax(logits, dim=1) * m
    return {"Out": out.to(X.dtype)}


@register_op("sequence_expand", propagate_seqlen=False)
def _sequence_expand(ctx, X, Y, SeqLen=None):
    """Per-row features broadcast over Y's time axis (reference
    sequence_expand_op.cc, ref_level 0): X [B, D] or [B, 1, D] ->
    [B, T_y, D]; against a nested Y [B, S, T_y, ...], X [B, S, D] ->
    [B, S, T_y, D]."""
    if Y.ndim == 4:
        x = X if X.ndim == 4 else X[:, :, None, :]
        return {"Out": x.expand(x.shape[0], x.shape[1], Y.shape[2],
                                x.shape[-1])}
    x = X if X.ndim == 3 else X[:, None, :]
    return {"Out": x.expand(x.shape[0], Y.shape[1], x.shape[-1])}


@register_op("sequence_reshape", propagate_seqlen=False)
def _sequence_reshape(ctx, X, SeqLen=None):
    """[B, T, D] -> [B, T * D / new_dim, new_dim]; the lengths scale by
    D / new_dim (reference sequence_reshape_op.cc)."""
    new_dim = ctx.attr("new_dim")
    if SeqLen is not None and SeqLen.ndim == 2:
        B, S = X.shape[0], X.shape[1]
        sub = _sequence_reshape(ctx, _flat_rows(X), SeqLen.reshape(-1))
        return {"Out": _unflat_rows(sub["Out"], B, S),
                "OutLen": sub["OutLen"].reshape(B, S)}
    B, T, D = X.shape
    if (T * D) % new_dim:
        raise ValueError(f"sequence_reshape: T * D = {T * D} is not a "
                         f"multiple of new_dim {new_dim}")
    outs = {"Out": X.reshape(B, (T * D) // new_dim, new_dim)}
    if SeqLen is not None:
        outs["OutLen"] = (SeqLen * D) // new_dim
    return outs


@register_op("sequence_concat", propagate_seqlen=False)
def _sequence_concat(ctx, X, SeqLen=None):
    """Per-sequence concatenation (reference sequence_concat_op.cc): row
    b of the output is concat_i(x_i[b, :len_i[b]]), left-aligned in the
    padded layout, OutLen = sum_i len_i. The padded inputs are
    concatenated (static offsets P_i) and each output position gathered
    from segment i at P_i + (t - start_i[b]), start_i the running sum of
    the lengths. An input without lengths (None in `SeqLen`) is full."""
    xs = X if isinstance(X, list) else [X]
    lens = SeqLen if isinstance(SeqLen, list) else \
        [SeqLen] * (1 if SeqLen is not None else 0)
    lens = lens + [None] * (len(xs) - len(lens))
    if any(lv is not None and lv.ndim == 2 for lv in lens):
        B, S = xs[0].shape[0], xs[0].shape[1]
        sub = _sequence_concat(
            ctx, [_flat_rows(x) for x in xs],
            [None if lv is None else lv.reshape(-1) for lv in lens])
        return {"Out": _unflat_rows(sub["Out"], B, S),
                "OutLen": sub["OutLen"].reshape(B, S)}
    B = xs[0].shape[0]
    dev = xs[0].device
    Ts = [int(x.shape[1]) for x in xs]
    if all(lv is None for lv in lens):
        return {"Out": torch.cat(xs, dim=1),
                "OutLen": torch.full((B,), sum(Ts), dtype=torch.int32,
                                     device=dev)}
    L = torch.stack([torch.full((B,), t, dtype=torch.int32, device=dev)
                     if lv is None else lv.reshape(B).to(torch.int32)
                     for lv, t in zip(lens, Ts)], dim=1)        # [B, N]
    starts = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=dev),
                        torch.cumsum(L, dim=1, dtype=torch.int32)], dim=1)
    xcat = torch.cat(xs, dim=1)
    P = [0]
    for t_i in Ts:
        P.append(P[-1] + t_i)
    T_out = P[-1]
    t = torch.arange(T_out, dtype=torch.int32, device=dev)[None, :]
    src = torch.zeros((B, T_out), dtype=torch.int32, device=dev)
    for i in range(len(xs)):
        lo, hi = starts[:, i:i + 1], starts[:, i + 1:i + 2]
        src = torch.where((t >= lo) & (t < hi), P[i] + t - lo, src)
    out = _gather_time(xcat, src)
    total = starts[:, -1]
    mask = (t < total[:, None]).reshape((B, T_out) + (1,) * (xcat.ndim - 2))
    out = torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                             device=dev))
    return {"Out": out, "OutLen": total}


@register_op("sequence_slice", propagate_seqlen=False)
def _sequence_slice(ctx, X, Offset, Length):
    """Per-sequence sub-slices (reference sequence_slice_op.cc): row b is
    X[b, off_b : off_b + len_b], left-aligned, OutLen = len_b. With the
    `nested` attr each (doc, sentence) row is sliced."""
    if ctx.attr("nested", False):
        B, S = X.shape[0], X.shape[1]
        sub = _slice_rows(_flat_rows(X), Offset.reshape(-1),
                          Length.reshape(-1))
        return {"Out": _unflat_rows(sub["Out"], B, S),
                "OutLen": sub["OutLen"].reshape(B, S)}
    return _slice_rows(X, Offset, Length)


def _slice_rows(X, Offset, Length):
    """Offsets and lengths clamp to the padded bound, the offset first
    (the JAX rule's choice: a compiled step cannot raise on a value; the
    reference kernel asserts offset + length <= the row's length)."""
    B, T = X.shape[0], X.shape[1]
    off = torch.clamp(Offset.reshape(B).to(torch.int32), 0, T)
    ln = torch.minimum(torch.clamp(Length.reshape(B).to(torch.int32), min=0),
                       T - off)
    t = torch.arange(T, dtype=torch.int32, device=X.device)[None, :]
    idx = torch.clamp(off[:, None] + t, 0, T - 1)
    out = _gather_time(X, idx)
    mask = (t < ln[:, None]).reshape((B, T) + (1,) * (X.ndim - 2))
    out = torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                             device=X.device))
    return {"Out": out, "OutLen": ln}


@register_op("sequence_conv", propagate_seqlen=False)
def _sequence_conv(ctx, X, Filter, SeqLen=None, PaddingData=None):
    """Context-window conv over time (reference sequence_conv_op.cc):
    X [B, T, D], Filter [contextLength * D, M] -> [B, T, M]. Window
    position i reads row t + contextStart + i of the masked input, 0
    outside [0, T); the output is 0 past each row's length."""
    ctx_len = ctx.attr("contextLength", 3)
    ctx_start = ctx.attr("contextStart", -(ctx_len // 2))
    if SeqLen is not None and SeqLen.ndim == 2:
        B, S = X.shape[0], X.shape[1]
        sub = _sequence_conv(ctx, _flat_rows(X), Filter,
                             SeqLen.reshape(-1), PaddingData)
        return {"Out": _unflat_rows(sub["Out"], B, S)}
    T = X.shape[1]
    L = SeqLen if SeqLen is not None else _full_lengths(X)
    m = _time_mask(L, T, X.dtype)[..., None]
    xm = X * m
    t = torch.arange(T, device=X.device)
    cols = []
    for i in range(ctx_len):
        shift = ctx_start + i
        valid = ((t + shift >= 0) & (t + shift < T)).to(X.dtype)
        cols.append(torch.roll(xm, -shift, dims=1) * valid.reshape(1, T, 1))
    out = torch.cat(cols, dim=-1) @ Filter
    return {"Out": out * m}


@register_op("sequence_erase", propagate_seqlen=False)
def _sequence_erase(ctx, X, SeqLen=None):
    """Remove the attr `tokens` from each sequence and compact it left
    (reference sequence_erase_op.cc): a stable sort of the drop mask puts
    the kept ids first, in order; OutLen holds the new lengths. Ids of
    shape [B, T, 1] keep that shape."""
    tokens = [int(v) for v in (ctx.attr("tokens", []) or [])]
    if SeqLen is not None and SeqLen.ndim == 2:
        B, S = X.shape[0], X.shape[1]
        sub = _sequence_erase(ctx, _flat_rows(X), SeqLen.reshape(-1))
        return {"Out": _unflat_rows(sub["Out"], B, S),
                "OutLen": sub["OutLen"].reshape(B, S)}
    squeeze = X.ndim == 3 and X.shape[-1] == 1
    ids = X.reshape(X.shape[0], X.shape[1]) if squeeze else X
    B, T = ids.shape
    L = SeqLen.reshape(-1) if SeqLen is not None else _full_lengths(ids)
    t = torch.arange(T, dtype=torch.int32, device=X.device)[None, :]
    keep = t < L[:, None]
    for tok in tokens:
        keep = keep & (ids != tok)
    new_len = keep.sum(dim=1, dtype=torch.int32)
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    out = torch.where(t < new_len[:, None], torch.gather(ids, 1, order),
                      torch.zeros((), dtype=ids.dtype, device=X.device))
    if squeeze:
        out = out[..., None]
    return {"Out": out, "OutLen": new_len}


@register_op("sequence_expand_as", propagate_seqlen=False)
def _sequence_expand_as(ctx, X, Y):
    x = X if X.ndim == 3 else X[:, None, :]
    return {"Out": x.expand(x.shape[0], Y.shape[1], x.shape[-1])}


@register_op("row_conv", propagate_seqlen=False)
def _row_conv(ctx, X, Filter, SeqLen=None):
    """Lookahead row convolution (reference row_conv_op.cc): X [B, T, D],
    Filter [future + 1, D]; out[t] = sum_i X[t + i] * Filter[i] for
    t + i < T, then 0 past each row's length."""
    future, D = Filter.shape
    T = X.shape[1]
    t = torch.arange(T, device=X.device)
    out = torch.zeros_like(X)
    for i in range(future):
        valid = (t + i < T).to(X.dtype).reshape(1, T, 1)
        out = out + torch.roll(X, -i, dims=1) * valid \
            * Filter[i].reshape(1, 1, D)
    if SeqLen is not None:
        out = out * _time_mask(SeqLen, T, X.dtype)[..., None]
    return {"Out": out}
