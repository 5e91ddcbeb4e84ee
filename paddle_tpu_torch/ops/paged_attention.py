"""Ragged paged attention over a block-allocated KV cache (fp32 residency).

Counterpart of ``paddle_tpu/ops/paged_attention.py``; the layout and the
contract are the JAX package's:

- K/V live in fixed-size blocks ``[num_blocks, block_size, heads, dh]``
  held by persistable ``*@KV_CACHE`` scope vars;
- each sequence owns an ordered list of block ids (its row of the
  ``[slots, max_blocks_per_seq]`` int32 block table); attention reads K/V
  through the table and ignores positions at or past the sequence length;
- block 0 is the reserved TRASH block: inactive slots and the padding
  positions of a prefill write land there, and no read ever sees it;
- an inactive slot (seq_len 0) attends to nothing and returns exact zeros.

The cache writes update the cache tensors IN PLACE (`index_put_`), where
the JAX package returns new arrays from `.at[].set` and lets XLA donate
the buffers: a functional copy here would move the whole cache (about
200 MB at the serve-base configuration) on every step.

`paged_attention` dispatches like `flash_attention`: the hand-written
kernel of ``csrc/paged_decode.cu`` on a card (it replaces
``_paged_decode_kernel``), `paged_attention_reference` on the host, an
empty output for meta tensors.
"""

from __future__ import annotations

import math

import torch

from ..core.registry import register_op
from . import native
from .flash_attention import NEG_INF, flash_attention

_HEAD_DIMS = (32, 64, 128)


# ---------------------------------------------------------------------------
# cache scatter (append / prefill write), in place
# ---------------------------------------------------------------------------

def kv_cache_append(k_cache, v_cache, k_new, v_new, block_tables, seq_lens):
    """Write one new token's K/V per slot at position ``seq_len - 1``, in
    place. ``k_new``/``v_new``: [S, H, Dh]; caches [NB, BS, H, Dh].
    Inactive slots (seq_len 0) write into the trash block 0."""
    bs = k_cache.shape[1]
    seq = seq_lens.long()
    pos = (seq - 1).clamp_min(0)
    blk = torch.gather(block_tables.long(), 1, (pos // bs)[:, None])[:, 0]
    active = seq > 0
    blk = torch.where(active, blk, torch.zeros_like(blk))
    off = torch.where(active, pos % bs, torch.zeros_like(pos))
    k_cache.index_put_((blk, off), k_new.to(k_cache.dtype))
    v_cache.index_put_((blk, off), v_new.to(v_cache.dtype))
    return k_cache, v_cache


def kv_cache_prefill_write(k_cache, v_cache, k, v, block_tables, seq_lens):
    """Scatter a padded prompt's K/V ([B, T, H, Dh]) into each row's
    blocks, in place; positions at or past the row's seq_len land in the
    trash block 0."""
    bs = k_cache.shape[1]
    B, T = k.shape[0], k.shape[1]
    t = torch.arange(T, device=k.device)
    blk = torch.gather(block_tables.long(), 1,
                       (t // bs)[None, :].expand(B, T))
    valid = t[None, :] < seq_lens.long()[:, None]
    blk = torch.where(valid, blk, torch.zeros_like(blk)).reshape(-1)
    off = (t % bs)[None, :].expand(B, T).reshape(-1)
    k_cache.index_put_((blk, off),
                       k.reshape((B * T,) + k.shape[2:]).to(k_cache.dtype))
    v_cache.index_put_((blk, off),
                       v.reshape((B * T,) + v.shape[2:]).to(v_cache.dtype))
    return k_cache, v_cache


# ---------------------------------------------------------------------------
# plain version (the numerical contract)
# ---------------------------------------------------------------------------

def paged_attention_reference(q, k_cache, v_cache, block_tables, seq_lens,
                              sm_scale):
    """q: [S, H, Dh] (one token per slot). Gathers each slot's K/V through
    its block table into a dense [S, T, H, Dh] view (T = max_blocks_per_seq
    * block_size), masks positions >= seq_len, and runs one softmax(QK^T)V.
    Inactive slots return zeros."""
    S, H, Dh = q.shape
    nb, bs = k_cache.shape[0], k_cache.shape[1]
    T = block_tables.shape[1] * bs
    flat = (block_tables.long()[:, :, None] * bs
            + torch.arange(bs, device=q.device)[None, None, :]).reshape(S, T)
    k = k_cache.reshape(nb * bs, H, Dh)[flat]
    v = v_cache.reshape(nb * bs, H, Dh)[flat]
    s = torch.einsum("shd,sthd->sht", q.float(), k.float()) * sm_scale
    seq = seq_lens.long()
    mask = torch.arange(T, device=q.device)[None, :] < seq[:, None]
    s = s.masked_fill(~mask[:, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("sht,sthd->shd", p, v.float()) / l.clamp_min(1e-20)
    o = torch.where((seq > 0)[:, None, None], o, torch.zeros_like(o))
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _paged_attention_cuda(q, k_cache, v_cache, block_tables, seq_lens,
                          sm_scale):
    S, H, Dh = q.shape
    NB, BS = k_cache.shape[0], k_cache.shape[1]
    if Dh not in _HEAD_DIMS:
        raise ValueError(f"paged decode kernel takes head dim {_HEAD_DIMS}, "
                         f"got {Dh}")
    if S > native.MAX_GRID_Y:
        raise ValueError(f"paged decode kernel: {S} slots exceed the grid's "
                         f"y limit {native.MAX_GRID_Y}")
    dev = q.device
    max_b = block_tables.shape[1] if block_tables.ndim == 2 else -1
    native.check_operand(q, "q", torch.float32, dev)
    native.check_operand(k_cache, "k_cache", torch.float32, dev,
                         (NB, BS, H, Dh))
    native.check_operand(v_cache, "v_cache", torch.float32, dev,
                         (NB, BS, H, Dh))
    native.check_operand(block_tables, "block_tables", torch.int32, dev,
                         (S, max_b))
    native.check_operand(seq_lens, "seq_lens", torch.int32, dev, (S,))
    out = torch.empty_like(q)
    if S == 0:
        return out
    lib = native.lib()
    err = lib.ptt_paged_decode_f32(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        S, H, Dh, BS, max_b, float(sm_scale),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    native.check(err, "paged_decode launch")
    native.count_launch("paged_decode")
    return out


def paged_attention(q, k_cache, v_cache, block_tables, seq_lens,
                    sm_scale=None):
    """Decode attention for one token per slot: the kernel on a card, the
    plain version on the host."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _paged_attention_cuda(q, k_cache, v_cache, block_tables,
                                     seq_lens, sm_scale)
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_cache, v_cache, block_tables,
                                         seq_lens, sm_scale)
    raise ValueError(f"paged_attention: no path for device {q.device}")


# ---------------------------------------------------------------------------
# registered ops (the decode/prefill program building blocks)
# ---------------------------------------------------------------------------

@register_op("paged_attention")
def _paged_attention_op(ctx, Q, K, V, KCache, VCache, BlockTables, SeqLens):
    """One decode step. Q/K/V: [slots, d_model], this step's token per
    slot. Appends K/V at position seq_len-1 in place (KCacheOut/VCacheOut
    are the cache tensors themselves), then attends over [0, seq_len)
    through the block table. attrs: num_heads, sm_scale."""
    H = int(ctx.attr("num_heads", 1))
    S, D = Q.shape
    Dh = D // H
    sm_scale = float(ctx.attr("sm_scale", 1.0 / math.sqrt(Dh)))
    seq = SeqLens.to(torch.int32)
    bt = BlockTables.to(torch.int32)
    kc, vc = kv_cache_append(KCache, VCache, K.reshape(S, H, Dh),
                             V.reshape(S, H, Dh), bt, seq)
    out = paged_attention(Q.reshape(S, H, Dh).contiguous(), kc, vc,
                          bt.contiguous(), seq.contiguous(), sm_scale)
    return {"Out": out.reshape(S, D), "KCacheOut": kc, "VCacheOut": vc}


@register_op("prefill_attention")
def _prefill_attention_op(ctx, Q, K, V, KCache, VCache, BlockTables,
                          SeqLens):
    """Prompt phase. Q/K/V: [rows, T, d_model] at a bucket-ladder rung.
    Runs causal attention over the padded prompt (right-padding is
    invisible to valid positions under the causal mask) and scatters each
    row's K/V into its blocks, in place. attrs: num_heads, sm_scale."""
    H = int(ctx.attr("num_heads", 1))
    B, T, D = Q.shape
    Dh = D // H
    sm_scale = float(ctx.attr("sm_scale", 1.0 / math.sqrt(Dh)))
    seq = SeqLens.to(torch.int32)
    bt = BlockTables.to(torch.int32)
    k4 = K.reshape(B, T, H, Dh)
    v4 = V.reshape(B, T, H, Dh)

    def heads_first(x):
        return x.transpose(1, 2).contiguous()

    out = flash_attention(heads_first(Q.reshape(B, T, H, Dh)),
                          heads_first(k4), heads_first(v4), True, sm_scale)
    kc, vc = kv_cache_prefill_write(KCache, VCache, k4, v4, bt, seq)
    return {"Out": out.transpose(1, 2).reshape(B, T, D),
            "KCacheOut": kc, "VCacheOut": vc}


@register_op("gather_last_token")
def _gather_last_token(ctx, X, SeqLens):
    """X: [rows, T, D] -> Out: [rows, D], each row's position seq_len - 1
    (clamped into range; rows with seq_len 0 read position 0 — callers
    never use their output)."""
    B, T, D = X.shape
    idx = (SeqLens.long() - 1).clamp(0, T - 1)
    return {"Out": torch.gather(X, 1, idx[:, None, None].expand(B, 1, D))[:, 0]}
