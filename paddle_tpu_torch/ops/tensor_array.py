"""Tensor-array and rank-table op rules (the plumbing of dynamic RNNs).

Mirror of ``paddle_tpu/ops/tensor_array.py`` (reference
tensor_array_read_write_op.cc, lod_rank_table_op.cc,
lod_tensor_to_array_op.cc, array_to_lod_tensor_op.cc,
shrink_rnn_memory_op.cc, max_sequence_len_op.cc). A tensor array is a
fixed-capacity buffer [capacity, ...] plus an int32 `name@ALEN` length
companion; a write and a read index it with a device tensor, so a loop
never reads an index back to the host. The rank table is the lengths
vector [B], and `shrink_memory` masks finished rows instead of dropping
them.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op

# Capacity of an array written before its extent is known (a decode
# loop); lod_tensor_to_array sizes its buffer from T.
DEFAULT_ARRAY_CAPACITY = 128


def _as_index(i):
    return i.reshape(()).to(torch.int32)


def _mask_like(active, x):
    return active.reshape(active.shape + (1,) * (x.ndim - 1)).to(x.dtype)


@register_op("array_write", propagate_seqlen=False)
def _array_write(ctx, X, I, Array=None, ALen=None):
    """Write X at index I. With no Array yet (the first write) a zero
    buffer of `capacity` entries is made.

    Overflow contract: a write at I >= capacity leaves the buffer as it
    was while OutLen still records max(len, I + 1), so
    `array_length(arr) > capacity` tells of the overflow (a clamped
    write would silently overwrite entry capacity - 1)."""
    i = _as_index(I)
    if Array is None:
        cap = int(ctx.attr("capacity", DEFAULT_ARRAY_CAPACITY))
        Array = torch.zeros((cap,) + tuple(X.shape), dtype=X.dtype,
                            device=X.device)
    if ALen is None:
        ALen = torch.zeros((), dtype=torch.int32, device=X.device)
    cap = Array.shape[0]
    hit = (torch.arange(cap, device=Array.device) == i)
    hit = hit.reshape((cap,) + (1,) * (Array.ndim - 1))
    buf = torch.where(hit, X.to(Array.dtype).unsqueeze(0), Array)
    return {"Out": buf, "OutLen": torch.maximum(ALen, i + 1)}


@register_op("array_read", propagate_seqlen=False)
def _array_read(ctx, Array, I):
    """Array[I], I clamped into range as `lax.dynamic_index_in_dim`
    clamps it."""
    i = _as_index(I).long().clamp(0, Array.shape[0] - 1).reshape(1)
    return {"Out": torch.index_select(Array, 0, i)[0]}


@register_op("array_length", propagate_seqlen=False)
def _array_length(ctx, ALen):
    return {"Out": ALen.reshape(())}


@register_op("lod_rank_table", propagate_seqlen=False)
def _lod_rank_table(ctx, X, SeqLen=None):
    """The rank table is the lengths vector [B]; with no `@SEQLEN`
    companion every row has the full time extent."""
    if SeqLen is not None:
        return {"Out": SeqLen.to(torch.int32)}
    T = X.shape[1] if X.ndim > 1 else 1
    return {"Out": torch.full((X.shape[0],), T, dtype=torch.int32,
                              device=X.device)}


@register_op("max_sequence_len", propagate_seqlen=False)
def _max_sequence_len(ctx, RankTable):
    return {"Out": RankTable.max()}


@register_op("lod_tensor_to_array", propagate_seqlen=False)
def _lod_tensor_to_array(ctx, X, RankTable=None):
    """[B, T, ...] -> the time-major buffer [T, B, ...] of exactly T
    entries."""
    return {"Out": X.transpose(0, 1),
            "OutLen": torch.tensor(X.shape[1], dtype=torch.int32,
                                   device=X.device)}


@register_op("array_to_lod_tensor", propagate_seqlen=False)
def _array_to_lod_tensor(ctx, X, RankTable=None):
    """[T, B, ...] buffer -> [B, T, ...], zero past each row's length in
    the rank table."""
    out = X.transpose(0, 1)
    if RankTable is not None:
        T = out.shape[1]
        mask = torch.arange(T, device=out.device)[None, :] \
            < RankTable.reshape(-1, 1)
        m = mask.reshape(mask.shape + (1,) * (out.ndim - 2)).to(out.dtype)
        out = out * m
    return {"Out": out}


@register_op("shrink_memory", propagate_seqlen=False)
def _shrink_memory(ctx, X, I, RankTable):
    """X with the rows whose sequence ended by step I zeroed (the
    reference drops those rows)."""
    active = RankTable.reshape(-1) > _as_index(I)
    return {"Out": X * _mask_like(active, X)}


@register_op("reorder_lod_tensor_by_rank", propagate_seqlen=False)
def _reorder_lod_tensor_by_rank(ctx, X, RankTable):
    """Rows in rank-table order: longest first, ties in batch order."""
    order = torch.argsort(-RankTable.reshape(-1).long(), stable=True)
    return {"Out": torch.index_select(X, 0, order),
            "OutIndex": order.to(torch.int32)}
