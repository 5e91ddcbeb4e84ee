"""Ragged paged attention over a block-allocated KV cache (fp32 and int8
residency).

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
empty output for meta tensors. The kernel splits each slot's sequence into
chunks of `DECODE_SPLIT` positions, one block per (head, slot, chunk), and
merges the chunks in a second kernel; its launch plan
(`decode_split_plan`) comes from shapes alone, so the wrapper reads no
seq_lens value on the host and never synchronizes. Both kernels take
every head dim that is a multiple of 8 from 8 to 256 (`HEAD_DIMS`).

The int8 residency (`kv_dtype="int8"`): the cache tensors are int8 with
one float32 scale per block ([NB], separate K and V scales), value =
int8 * scale[block], symmetric +-127 bins.

- prefill OWNS its blocks: the write SETS each written block's scale to
  its group abs-max / 127 (a recycled block's stale scale is overwritten,
  never consulted);
- decode append GROWS a block: the first token written into a block sets
  its scale fresh; a later token may RAISE it (never lower), in which case
  the block's resident int8 values are requantized by old / new and the
  event is counted (`RequantCountOut`, metered by the serve engine as
  ``serve_kv_requant_events_total``);
- attention DEQUANTIZES at the read: Q and the in-flight K/V stay float32
  (prefill's own attention runs on the exact K/V, only RESIDENCY is
  quantized), so the first generated token is exact and quantization error
  enters through decode-step history reads only.

`paged_attention_q8` dispatches like `paged_attention`: the kernel of
``csrc/paged_decode_q8.cu`` on a card (it replaces
``_paged_decode_kernel_q8``, chunks of `DECODE_SPLIT_Q8` positions),
`paged_attention_q8_reference` on the host.
"""

from __future__ import annotations

import math

import torch

from ..core.registry import register_op
from . import native
from .flash_attention import (HEAD_DIMS, NEG_INF, flash_attention,
                              head_dim_error)


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

# Positions a split block reads (P), float32 and int8 cache: the kernels
# read each slot's sequence in chunks of P, one block per (head, slot,
# chunk), and merge the chunks' softmax states in a second kernel
# (csrc/paged_split.cuh). Multiples of the kernels' 64-position pass; the
# int8 chunk is twice as long, as its rows are a quarter of the bytes.
DECODE_SPLIT = 64
DECODE_SPLIT_Q8 = 128


def decode_split_plan(S, H, Dh, BS, max_b, split):
    """The split launch from shapes alone, never from seq_lens' values:
    (NSPLIT, workspace shape). NSPLIT = ceil(max_b * BS / split), at least
    1; the workspace [S, H, NSPLIT, Dh + 2] holds each chunk's (acc, m,
    l) in float32."""
    nsplit = max(1, -(-(max_b * BS) // split))
    return nsplit, (S, H, nsplit, Dh + 2)


def _check_split_launch(what, S, H, Dh, BS, max_b, split):
    """Refuse what the kernels do not take: grid (H, S, NSPLIT) puts the
    slots on y and the chunks on z. Returns `decode_split_plan`'s pair."""
    if Dh not in HEAD_DIMS:
        raise head_dim_error(what, Dh)
    if S > native.MAX_GRID_Y:
        raise ValueError(f"{what}: {S} slots exceed the grid's y limit "
                         f"{native.MAX_GRID_Y}")
    nsplit, ws_shape = decode_split_plan(S, H, Dh, BS, max_b, split)
    if nsplit > native.MAX_GRID_Z:
        raise ValueError(f"{what}: {nsplit} chunks of {split} positions "
                         f"exceed the grid's z limit {native.MAX_GRID_Z}")
    return nsplit, ws_shape


def _paged_attention_cuda(q, k_cache, v_cache, block_tables, seq_lens,
                          sm_scale):
    S, H, Dh = q.shape
    NB, BS = k_cache.shape[0], k_cache.shape[1]
    max_b = block_tables.shape[1] if block_tables.ndim == 2 else -1
    nsplit, ws_shape = _check_split_launch("paged decode kernel", S, H, Dh,
                                           BS, max_b, DECODE_SPLIT)
    dev = q.device
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
    part = torch.empty(ws_shape, dtype=torch.float32, device=dev)
    lib = native.lib()
    err = lib.ptt_paged_decode_f32(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), part.data_ptr(),
        out.data_ptr(), S, H, Dh, BS, max_b, DECODE_SPLIT, nsplit,
        float(sm_scale),
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
# int8 residency: cache writes, in place
# ---------------------------------------------------------------------------

_Q8_BINS = 127.0


def _q8_append_one(cache, scale, new, block_tables, seq_lens):
    """Append one token's values per slot into an int8 cache, in place.
    `new`: [S, H, Dh] float32. Returns (cache, scale, n_requant), the
    count a [] int32 tensor on the cache's device.

    Two ordered writes: first every slot's whole block is rewritten,
    requantized by old / new where its scale grew and by ratio 1 (an exact
    identity) elsewhere, then the token lands at its offset. Inactive
    slots all target the trash block 0 with ratio 1, so the duplicate
    indices of the block rewrite and of the scale write carry equal
    values; only the trash block's token row is written by several slots,
    and no read ever sees it."""
    bs = cache.shape[1]
    seq = seq_lens.long()
    pos = (seq - 1).clamp_min(0)
    blk = torch.gather(block_tables.long(), 1, (pos // bs)[:, None])[:, 0]
    active = seq > 0
    blk = torch.where(active, blk, torch.zeros_like(blk))
    off = torch.where(active, pos % bs, torch.zeros_like(pos))
    first = (pos % bs) == 0            # first token written into the block
    tok = new.float()
    needed = tok.abs().amax(dim=(1, 2)) / _Q8_BINS                # [S]
    old = scale[blk]                                              # [S]
    base = torch.where(first, torch.zeros_like(old), old)
    s_new = torch.maximum(base, needed)
    requant = active & ~first & (needed > old)
    ratio = torch.where(requant, old / s_new.clamp_min(1e-30),
                        torch.ones_like(old))
    # torch.round rounds half to even, as jnp.rint does
    adj = torch.round(cache[blk].float() * ratio[:, None, None, None])
    cache.index_put_((blk,), adj.to(cache.dtype))
    safe = torch.where(s_new > 0, s_new, torch.ones_like(s_new))
    q = torch.round((tok / safe[:, None, None]).clamp(-_Q8_BINS, _Q8_BINS))
    cache.index_put_((blk, off), q.to(cache.dtype))
    scale.index_put_((blk,), torch.where(active, s_new, old))
    return cache, scale, requant.sum().to(torch.int32)


def _q8_prefill_write_one(cache, scale, x, block_tables, seq_lens):
    """Scatter a padded prompt's values ([B, T, H, Dh]) into an int8
    cache, in place, setting each written block's scale to its group
    abs-max / 127. Positions at or past the row's seq_len quantize to 0
    and land in the trash block 0."""
    bs = cache.shape[1]
    B, T = x.shape[0], x.shape[1]
    n_ord = -(-T // bs)
    t = torch.arange(T, device=x.device)
    seq = seq_lens.long()
    valid = t[None, :] < seq[:, None]                             # [B, T]
    tables = block_tables.long()
    blk = torch.gather(tables, 1, (t // bs)[None, :].expand(B, T))
    blk = torch.where(valid, blk, torch.zeros_like(blk))
    off = (t % bs)[None, :].expand(B, T)
    xm = torch.where(valid[:, :, None, None], x.float(),
                     torch.zeros((), dtype=torch.float32, device=x.device))
    pad = n_ord * bs - T
    xp = torch.nn.functional.pad(xm, (0, 0, 0, 0, 0, pad)) if pad else xm
    grp = xp.reshape(B, n_ord, bs, x.shape[2], x.shape[3])
    needed = grp.abs().amax(dim=(2, 3, 4)) / _Q8_BINS             # [B, n_ord]
    safe = torch.where(needed > 0, needed, torch.ones_like(needed))
    per_pos = safe.repeat_interleave(bs, dim=1)[:, :T]            # [B, T]
    q = torch.round((xm / per_pos[:, :, None, None])
                    .clamp(-_Q8_BINS, _Q8_BINS))
    cache.index_put_((blk.reshape(-1), off.reshape(-1)),
                     q.reshape((B * T,) + x.shape[2:]).to(cache.dtype))
    # overwrite the scale of every block that received a valid position
    # (prefill owns the block); rows/ordinals past seq_len redirect to
    # trash block 0 where they rewrite its existing scale
    has = (torch.arange(n_ord, device=x.device)[None, :] * bs) < seq[:, None]
    blk_sc = torch.where(has, tables[:, :n_ord],
                         torch.zeros_like(tables[:, :n_ord]))
    scale.index_put_((blk_sc.reshape(-1),),
                     torch.where(has, needed, scale[blk_sc]).reshape(-1))
    return cache, scale


# ---------------------------------------------------------------------------
# int8 residency: the decode read
# ---------------------------------------------------------------------------

def paged_attention_q8_reference(q, k_cache, v_cache, k_scale, v_scale,
                                 block_tables, seq_lens, sm_scale):
    """Plain version of the quantized decode read: gather int8 blocks
    through the table, dequantize by per-block scale, then the same
    masked softmax as `paged_attention_reference`. Dead table entries
    point anywhere (their positions are masked), so a non-finite scale
    there must not reach the sums: dead positions dequantize to 0."""
    S, H, Dh = q.shape
    nb, bs = k_cache.shape[0], k_cache.shape[1]
    T = block_tables.shape[1] * bs
    tables = block_tables.long()
    flat = (tables[:, :, None] * bs
            + torch.arange(bs, device=q.device)[None, None, :]).reshape(S, T)
    seq = seq_lens.long()
    mask = torch.arange(T, device=q.device)[None, :] < seq[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    ks = torch.where(mask, k_scale[tables].repeat_interleave(bs, dim=1), zero)
    vs = torch.where(mask, v_scale[tables].repeat_interleave(bs, dim=1), zero)
    k = k_cache.reshape(nb * bs, H, Dh)[flat].float() * ks[:, :, None, None]
    v = v_cache.reshape(nb * bs, H, Dh)[flat].float() * vs[:, :, None, None]
    s = torch.einsum("shd,sthd->sht", q.float(), k) * sm_scale
    s = s.masked_fill(~mask[:, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("sht,sthd->shd", p, v) / l.clamp_min(1e-20)
    o = torch.where((seq > 0)[:, None, None], o, torch.zeros_like(o))
    return o.to(q.dtype)


def paged_attention_split_reference(q, k_cache, v_cache, block_tables,
                                    seq_lens, sm_scale, k_scale=None,
                                    v_scale=None, split=None):
    """The split kernels' arithmetic in plain PyTorch; only the tests use
    it. Each chunk of `split` positions gets its softmax state from the
    plain scores (m = max, l = sum of e^(score - m), acc = the same weights
    times V), and the live chunks (j * split < seq_len, clamped to the
    table row) merge in split order as the merge kernel does. With
    `k_scale`/`v_scale` the caches are int8 and dequantize per block, as in
    `paged_attention_q8_reference`. `split` is the kernel's own
    (DECODE_SPLIT, or DECODE_SPLIT_Q8 with scales) unless given. Positions
    a slot must not read are zeroed before any arithmetic, as the kernels
    never load them. Returns (out [S, H, Dh], partials [S, H, NSPLIT,
    Dh + 2]); a dead chunk's record is zeros here and never written by the
    kernel."""
    S, H, Dh = q.shape
    nb, bs = k_cache.shape[0], k_cache.shape[1]
    max_b = block_tables.shape[1]
    if split is None:
        split = DECODE_SPLIT if k_scale is None else DECODE_SPLIT_Q8
    nsplit, _ = decode_split_plan(S, H, Dh, bs, max_b, split)
    T = max_b * bs
    tables = block_tables.long()
    flat = (tables[:, :, None] * bs
            + torch.arange(bs, device=q.device)[None, None, :]).reshape(S, T)
    seq = seq_lens.long().clamp(max=T)
    mask = torch.arange(T, device=q.device)[None, :] < seq[:, None]  # [S, T]
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    k = k_cache.reshape(nb * bs, H, Dh)[flat].float()
    v = v_cache.reshape(nb * bs, H, Dh)[flat].float()
    if k_scale is not None:
        k = k * torch.where(mask, k_scale[tables].repeat_interleave(bs, dim=1),
                            zero)[:, :, None, None]
        v = v * torch.where(mask, v_scale[tables].repeat_interleave(bs, dim=1),
                            zero)[:, :, None, None]
    k = torch.where(mask[:, :, None, None], k, zero)
    v = torch.where(mask[:, :, None, None], v, zero)
    pad = nsplit * split - T
    s = torch.einsum("shd,sthd->sht", q.float(), k) * sm_scale
    s = torch.nn.functional.pad(s.masked_fill(~mask[:, None, :], NEG_INF),
                                (0, pad), value=NEG_INF)
    chunk_mask = torch.nn.functional.pad(mask, (0, pad), value=False) \
        .reshape(S, 1, nsplit, split)
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    s = s.reshape(S, H, nsplit, split)
    m = s.amax(dim=-1)                                      # [S, H, NSPLIT]
    p = torch.where(chunk_mask, torch.exp(s - m[..., None]), zero)
    l = p.sum(dim=-1)
    acc = torch.einsum("shjp,sjphd->shjd", p,
                       v.reshape(S, nsplit, split, H, Dh))
    live = (torch.arange(nsplit, device=q.device)[None, :] * split
            < seq[:, None])[:, None, :].expand(S, H, nsplit)
    M = torch.where(live, m, torch.full_like(m, NEG_INF)).amax(dim=-1)
    L = torch.zeros_like(M)
    o = torch.zeros_like(q, dtype=torch.float32)
    for j in range(nsplit):                   # split order, as the merge
        w = torch.where(live[..., j], torch.exp(m[..., j] - M), zero)
        L = L + l[..., j] * w
        o = o + acc[:, :, j] * w[..., None]
    o = o / L.clamp_min(1e-20)[..., None]
    o = torch.where((seq > 0)[:, None, None], o, torch.zeros_like(o))
    part = torch.cat([acc, m[..., None], l[..., None]], dim=-1)
    part = torch.where(live[..., None], part, zero)
    return o.to(q.dtype), part


def _paged_attention_q8_cuda(q, k_cache, v_cache, k_scale, v_scale,
                             block_tables, seq_lens, sm_scale):
    S, H, Dh = q.shape
    NB, BS = k_cache.shape[0], k_cache.shape[1]
    max_b = block_tables.shape[1] if block_tables.ndim == 2 else -1
    nsplit, ws_shape = _check_split_launch("int8 paged decode kernel", S, H,
                                           Dh, BS, max_b, DECODE_SPLIT_Q8)
    dev = q.device
    native.check_operand(q, "q", torch.float32, dev)
    native.check_operand(k_cache, "k_cache", torch.int8, dev,
                         (NB, BS, H, Dh))
    native.check_operand(v_cache, "v_cache", torch.int8, dev,
                         (NB, BS, H, Dh))
    native.check_operand(k_scale, "k_scale", torch.float32, dev, (NB,))
    native.check_operand(v_scale, "v_scale", torch.float32, dev, (NB,))
    native.check_operand(block_tables, "block_tables", torch.int32, dev,
                         (S, max_b))
    native.check_operand(seq_lens, "seq_lens", torch.int32, dev, (S,))
    out = torch.empty_like(q)
    if S == 0:
        return out
    part = torch.empty(ws_shape, dtype=torch.float32, device=dev)
    lib = native.lib()
    err = lib.ptt_paged_decode_q8(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), part.data_ptr(),
        out.data_ptr(), S, H, Dh, BS, max_b, DECODE_SPLIT_Q8, nsplit,
        float(sm_scale),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    native.check(err, "paged_decode_q8 launch")
    native.count_launch("paged_decode_q8")
    return out


def paged_attention_q8(q, k_cache, v_cache, k_scale, v_scale, block_tables,
                       seq_lens, sm_scale=None):
    """Quantized-residency decode read for one token per slot: the kernel
    on a card, the plain version on the host."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _paged_attention_q8_cuda(q, k_cache, v_cache, k_scale,
                                        v_scale, block_tables, seq_lens,
                                        sm_scale)
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return paged_attention_q8_reference(q, k_cache, v_cache, k_scale,
                                            v_scale, block_tables, seq_lens,
                                            sm_scale)
    raise ValueError(f"paged_attention_q8: no path for device {q.device}")


# ---------------------------------------------------------------------------
# registered ops (the decode/prefill program building blocks)
# ---------------------------------------------------------------------------

@register_op("paged_attention", propagate_seqlen=False)
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


@register_op("prefill_attention", propagate_seqlen=False)
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


@register_op("paged_attention_q8", propagate_seqlen=False)
def _paged_attention_q8_op(ctx, Q, K, V, KCache, VCache, KScale, VScale,
                           RequantCount, BlockTables, SeqLens):
    """One decode step over int8 caches. Same contract as paged_attention
    plus the per-block scale vars ([num_blocks] f32, updated in place
    alongside their cache) and a [1] int32 requant-event counter the
    serve engine meters."""
    H = int(ctx.attr("num_heads", 1))
    S, D = Q.shape
    Dh = D // H
    sm_scale = float(ctx.attr("sm_scale", 1.0 / math.sqrt(Dh)))
    seq = SeqLens.to(torch.int32)
    bt = BlockTables.to(torch.int32)
    kc, ks, n_k = _q8_append_one(KCache, KScale, K.reshape(S, H, Dh), bt, seq)
    vc, vs, n_v = _q8_append_one(VCache, VScale, V.reshape(S, H, Dh), bt, seq)
    out = paged_attention_q8(Q.reshape(S, H, Dh).contiguous(), kc, vc, ks, vs,
                             bt.contiguous(), seq.contiguous(), sm_scale)
    return {"Out": out.reshape(S, D), "KCacheOut": kc, "VCacheOut": vc,
            "KScaleOut": ks, "VScaleOut": vs,
            "RequantCountOut": RequantCount + (n_k + n_v)}


@register_op("prefill_attention_q8", propagate_seqlen=False)
def _prefill_attention_q8_op(ctx, Q, K, V, KCache, VCache, KScale, VScale,
                             BlockTables, SeqLens):
    """Prompt phase over int8 caches: attention runs on the exact K/V in
    flight (prefill logits, and therefore the first token, are those of
    the fp32 cache), quantization happens only at the residency write. No
    requant counter: prefill always owns the blocks it writes.

    Build-time shape inference runs this rule on meta tensors with a
    stand-in length for the dynamic T, longer than the block table is
    wide, and the residency write then refuses its shapes, exactly as in
    the JAX package: `Out` keeps no build-time shape in either, so both
    save the same Program."""
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
    kc, ks = _q8_prefill_write_one(KCache, KScale, k4, bt, seq)
    vc, vs = _q8_prefill_write_one(VCache, VScale, v4, bt, seq)
    return {"Out": out.transpose(1, 2).reshape(B, T, D),
            "KCacheOut": kc, "VCacheOut": vc,
            "KScaleOut": ks, "VScaleOut": vs}


@register_op("gather_last_token", propagate_seqlen=False)
def _gather_last_token(ctx, X, SeqLens):
    """X: [rows, T, D] -> Out: [rows, D], each row's position seq_len - 1
    (clamped into range; rows with seq_len 0 read position 0 — callers
    never use their output)."""
    B, T, D = X.shape
    idx = (SeqLens.long() - 1).clamp(0, T - 1)
    return {"Out": torch.gather(X, 1, idx[:, None, None].expand(B, 1, D))[:, 0]}
