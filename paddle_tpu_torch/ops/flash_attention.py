"""Fused (flash) attention: the CUDA kernels, their plain versions, the
autograd Function and the `fused_attention` op.

Counterpart of ``paddle_tpu/ops/pallas_attention.py``, its ring attention
included (`ring_attention`, plain PyTorch over the ranks of an 'sp' mesh
axis, as the JAX ring is jnp). Public layout is the JAX
package's: q, k, v and the output are [B, H, T, D].

`flash_attention` is a `torch.autograd.Function` (the JAX package's
`custom_vjp`): its forward launches the forward kernel and saves
(q, k, v, out, lse); its backward launches the delta kernel (delta =
rowsum(dO * O), which the JAX package computes in XLA), then the dQ and
dK/dV kernels. Each of them dispatches on where its tensors lie:

- CUDA: the hand-written kernels of ``csrc/flash_fwd.cu``,
  ``csrc/flash_delta.cu``, ``csrc/flash_bwd_f32.cuh`` (the float32 dQ
  and dK/dV, built from four sources) and ``csrc/flash_bwd_bf16.cu``
  (they replace ``_flash_fwd_kernel``, the XLA delta,
  ``_flash_dq_kernel`` and ``_flash_dkv_kernel``; see those files for
  what bounds them and how their designs answer it). They take float32 or bf16 (each dtype its
  own instantiation, counted under its own name: `flash_fwd` and
  `flash_fwd_bf16`, ...), any T, and as many keys as queries. Every one
  of them, the forward, dQ, dK/dV and the delta kernel in either dtype,
  takes every head dim D that is a multiple of 8 from 8 to 256
  (`HEAD_DIMS`, the JAX kernels' D <= 256): D 32, 64 and 128 in exact
  instantiations, any other D in the smallest padded width that covers
  it (the float32 flash kernels 8, 16, 32, 64, 96, 128 or 256; the bf16
  ones 32, 64, 128 or 256; the delta kernel a power of two), whose
  columns past D the kernel fills with zeros as it loads and never
  stores. Any other D raises, citing ROADMAP Queue 1 item 9.4 — there is
  no fallback. Past D 128 dK/dV runs as two grids, dV's and then dK's,
  and counts both (`dkv_grids`). The bf16 forward, dQ and dK/dV kernels load through TMA
  tensor maps, which want 16-byte-aligned bases, as every wrapper checks;
- CPU: the plain PyTorch versions (`_attention_reference`,
  `_lse_reference`, `_flash_delta_reference`,
  `_flash_backward_reference`), which write out the kernels' own
  formulas;
- meta: an empty output of the right shape (build-time shape inference).

In bf16 (under `Executor(amp=True)`) every kernel rounds where the TPU
kernel rounds, and so do the plain versions: products take bf16 operands
with float32 sums; S, the softmax statistics, lse, W, dP, delta and dS
are float32; the forward rounds its unnormalized P = exp(S - m) (dropped
in float32) to bf16 for P V and writes O = acc / l in bf16; dQ rounds dS,
dK/dV rounds W_drop and dS, for their products; dQ, dK and dV are
written in bf16. The kernels take m per K/V tile and rescale, the plain
forward takes the row's max at once: their P round from values that
differ by a float32 factor, within a bf16 ulp of each other.

Attention-weight dropout (training) keys each weight's keep bit on
(seed, bh, query row, key column) with a counter hash (`_attention_keep`,
the kernels' ``csrc/flash_common.cuh``), so the forward and both backward
kernels regenerate the same mask, and the plain versions compute the same
bits: kernel and plain version agree on the mask exactly. The TPU kernels
draw theirs per tile from the TPU's PRNG, which the card cannot
reproduce; the JAX package's own reference draws with
`jax.random.bernoulli`. The masks of the two packages therefore differ,
as their distributions agree.
"""

from __future__ import annotations

import math

import torch

from ..core import types
from ..core.registry import register_op
from . import native
from .nn import M32, _fmix32, _mul32, seed32

NEG_INF = -1e30

# Head dims every kernel takes (the flash forward, dQ, dK/dV and delta in
# either dtype, both paged decode kernels): every multiple of 8 from 8 to
# 256, as the JAX package's flash kernels take any D <= 256 and its paged
# kernels any D. ROADMAP Queue 1 item 9.4 holds the rest.
HEAD_DIMS = tuple(range(8, 257, 8))


# ---------------------------------------------------------------------------
# the dropout mask
# ---------------------------------------------------------------------------

def _dropout_threshold(rate: float) -> int:
    """Keep a weight when its 32-bit hash >= this (rate * 2**32)."""
    return min(max(int(rate * 2.0 ** 32), 0), M32)


def _drop_scale(rate: float) -> float:
    """1 / (1 - rate) rounded to float32, the value the kernels get (the
    attention weights are dropped in float32 in either dtype)."""
    return types.scalar_as(1.0 / (1.0 - rate), torch.float32)


def _attention_keep(seed: int, bh: int, Tq: int, Tk: int, rate: float,
                    device, bh0: int = 0):
    """[bh, Tq, Tk] bool keep mask, the kernels' bits (flash_common.cuh),
    for rows bh0 .. bh0 + bh of the whole batch's (batch, head) rows."""
    i64 = dict(dtype=torch.int64, device=device)
    bhs = torch.arange(int(bh0), int(bh0) + bh, **i64)[:, None]
    bk = _fmix32((int(seed) & M32) ^ _mul32(bhs, 0x9E3779B9))
    rk = _fmix32((bk + torch.arange(Tq, **i64)[None, :]) & M32)
    ck = _mul32(torch.arange(Tk, **i64), 0x85EBCA77)
    return _fmix32(rk[:, :, None] ^ ck) >= _dropout_threshold(rate)


def _keep_like(s, rate, seed, bh0=0):
    """The keep mask for a [B, H, Tq, Tk] score tensor."""
    B, H, Tq, Tk = s.shape
    return _attention_keep(seed, B * H, Tq, Tk, rate,
                           s.device, bh0).reshape(B, H, Tq, Tk)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _compute_dtype(t):
    """float32 at least: bf16 operands are upcast, so their products are
    exact and their sums float32 (float64 inputs stay float64, for
    gradient checks)."""
    return torch.promote_types(t.dtype, torch.float32)


def _masked_scores(q, k, causal, sm_scale):
    ct = _compute_dtype(q)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), k.to(ct)) * sm_scale
    if causal:
        Tq, Tk = s.shape[-2], s.shape[-1]
        above = torch.ones(Tq, Tk, dtype=torch.bool,
                           device=s.device).triu(1)
        s = s.masked_fill(above, NEG_INF)
    return s


def _attention_reference(q, k, v, causal, sm_scale, rate=0.0, seed=0,
                         bh0=0):
    """Plain PyTorch version, the kernels' formula: P = exp(S - m) with
    S = Q K^T * sm_scale causal-masked and m its row max, dropped and
    scaled by the kernels' mask, rounded to V's dtype for P V (a no-op in
    float32); O = (P V) / l, l the undropped row sum, in V's dtype."""
    s = _masked_scores(q, k, causal, sm_scale)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    if rate:
        p = torch.where(_keep_like(p, rate, seed, bh0), p * _drop_scale(rate),
                        torch.zeros((), dtype=p.dtype, device=p.device))
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).to(s.dtype),
                     v.to(s.dtype))
    return (o / l).to(v.dtype)


def _lse_reference(q, k, causal, sm_scale):
    """Row logsumexp of the masked scores, [B, H, T] (the forward kernel's
    second output)."""
    return torch.logsumexp(_masked_scores(q, k, causal, sm_scale), dim=-1)


def _flash_backward_reference(q, k, v, o, lse, do, causal, sm_scale,
                              rate=0.0, seed=0, bh0=0):
    """The backward kernels' formulas in PyTorch (not autograd):
    W = exp(S - lse), dW = drop(dO V^T), dS = W (dW - delta) sm_scale,
    dQ = dS K, dK = dS^T Q, dV = drop(W)^T dO. Returns (dq, dk, dv) in
    the inputs' dtype. In bf16, W_drop and dS are rounded to bf16 for
    their products, as the kernels round them; all else is float32."""
    lo, ct = q.dtype, _compute_dtype(q)
    q, k, v, o, do = (t.to(ct) for t in (q, k, v, o, do))

    def operand(x):       # rounded to the inputs' dtype for a product
        return x.to(lo).to(ct)

    w = torch.exp(_masked_scores(q, k, causal, sm_scale) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    if rate:
        keep = _keep_like(w, rate, seed, bh0)
        zero = torch.zeros((), dtype=w.dtype, device=w.device)
        w_drop = torch.where(keep, w * _drop_scale(rate), zero)
        dw = torch.where(keep, dp * _drop_scale(rate), zero)
    else:
        w_drop, dw = w, dp
    delta = _flash_delta_reference(o, do)
    ds = operand(w * (dw - delta[..., None]) * sm_scale)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k).to(lo),
            torch.einsum("bhqk,bhqd->bhkd", ds, q).to(lo),
            torch.einsum("bhqk,bhqd->bhkd", operand(w_drop), do).to(lo))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def head_dim_error(what, D):
    """The error of a kernel (either flash or paged kernel) refused head
    dim D."""
    return ValueError(f"{what} takes a head dim that is a multiple of 8 "
                      f"from 8 to 256, got {D} (ROADMAP Queue 1 item 9.4)")


def _check_head_dim(D, what):
    """Raise unless the flash `what` kernel takes head dim D (HEAD_DIMS)."""
    if D not in HEAD_DIMS:
        raise head_dim_error(f"flash attention {what} kernel", D)


def _check_shape(q, what):
    B, H, T, D = q.shape
    _check_head_dim(D, what)
    if B * H > native.MAX_GRID_Y:
        raise ValueError(f"flash attention {what}: B*H = {B * H} exceeds "
                         f"the grid's y limit {native.MAX_GRID_Y}")
    return B, H, T, D


def _device_args(dev):
    return (dev.index if dev.index is not None else torch.cuda.current_device(),
            torch.cuda.current_stream(dev).cuda_stream)


def _dropout_args(rate, seed, bh0=0):
    """(seed, bh0, thresh, drop_scale) as the kernels take them."""
    if not rate:
        return 0, 0, 0, 1.0
    return (int(seed) & M32, int(bh0) & M32, _dropout_threshold(rate),
            _drop_scale(rate))


# element dtype -> the C entry points' suffix and the launch counters'
_INSTANTIATIONS = {torch.float32: ("f32", ""), torch.bfloat16: ("bf16", "_bf16")}


def _instantiation(q, what):
    """(entry suffix, counter suffix) of the kernels for q's dtype."""
    if q.dtype not in _INSTANTIATIONS:
        raise ValueError(f"flash attention {what} kernel takes float32 or "
                         f"bfloat16, got dtype {q.dtype}")
    return _INSTANTIATIONS[q.dtype]


def _flash_forward(q, k, v, causal, sm_scale, rate=0.0, seed=0, bh0=0):
    """Launch the forward kernel of q's dtype: returns (out [B, H, T, D]
    in that dtype, lse [B, H, T] float32)."""
    B, H, T, D = _check_shape(q, "forward")
    entry, counter = _instantiation(q, "forward")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        native.check_operand(t, name, q.dtype, dev, (B, H, T, D))
    out = torch.empty_like(q)
    native.check_operand(out, "out", q.dtype, dev, (B, H, T, D))
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    if q.numel() == 0:
        return out, lse
    if q.dtype == torch.bfloat16 and sm_scale < 0:
        # the bf16 kernel keeps its running max before the scale, which
        # needs sm_scale >= 0; (-q) K^T is -(Q K^T) exactly
        q, sm_scale = -q, -sm_scale
    err = getattr(native.lib(), f"ptt_flash_fwd_{entry}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B * H, T, D, float(sm_scale), int(bool(causal)),
        *_dropout_args(rate, seed, bh0), *_device_args(dev))
    native.check(err, "flash_fwd launch")
    native.count_launch("flash_fwd" + counter)
    return out, lse


def _flash_dq(q, k, v, do, lse, delta, causal, sm_scale, rate=0.0, seed=0,
              bh0=0):
    """Launch the dQ kernel of q's dtype: returns dq [B, H, T, D]."""
    B, H, T, D = _check_shape(q, "dQ")
    entry, counter = _instantiation(q, "dQ")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        native.check_operand(t, name, q.dtype, dev, (B, H, T, D))
    for name, t in (("lse", lse), ("delta", delta)):
        native.check_operand(t, name, torch.float32, dev, (B, H, T))
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    err = getattr(native.lib(), f"ptt_flash_dq_{entry}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B * H, T, D,
        float(sm_scale), int(bool(causal)), *_dropout_args(rate, seed, bh0),
        *_device_args(dev))
    native.check(err, "flash_dq launch")
    native.count_launch("flash_dq" + counter)
    return dq


def dkv_grids(D):
    """Grids a dK/dV launch runs at head dim D, in either dtype: one, or at
    the width 256 (D > 128), where dK and dV together would take 256
    registers a thread, a dV grid and then a dK grid. Each is counted."""
    return 2 if D > 128 else 1


def _flash_dkv(q, k, v, do, lse, delta, causal, sm_scale, rate=0.0, seed=0,
               bh0=0):
    """Launch the dK/dV kernel of q's dtype: returns (dk, dv), each
    [B, H, T, D]."""
    B, H, T, D = _check_shape(q, "dK/dV")
    entry, counter = _instantiation(q, "dK/dV")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        native.check_operand(t, name, q.dtype, dev, (B, H, T, D))
    for name, t in (("lse", lse), ("delta", delta)):
        native.check_operand(t, name, torch.float32, dev, (B, H, T))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    err = getattr(native.lib(), f"ptt_flash_dkv_{entry}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B * H, T, D, float(sm_scale), int(bool(causal)),
        *_dropout_args(rate, seed, bh0), *_device_args(dev))
    native.check(err, "flash_dkv launch")
    native.count_launch("flash_dkv" + counter, dkv_grids(D))
    return dk, dv


def _flash_delta_reference(o, do):
    """delta = rowsum(dO * O), [B, H, T], in float32 at least (from bf16
    tensors too): the JAX package computes it so, outside its kernels.
    O enters the product in its own dtype: the multiply promotes it on the
    fly, so a bf16 O costs no float32 copy, and the products (exact in
    float32) and their sum are those of two upcast copies, bit for bit."""
    ct = _compute_dtype(o)
    return (do.to(ct) * o).sum(-1)


def flash_delta(o, do):
    """delta = rowsum(dO * O) over [..., D] tensors, float32: the delta
    kernel for CUDA tensors (float32 or bf16, D in HEAD_DIMS; it sums in
    float32, in another order than the plain version), the plain version
    on the CPU, an empty result on meta."""
    dev = o.device
    if dev.type == "cpu":
        return _flash_delta_reference(o, do)
    if dev.type == "meta":
        return torch.empty(o.shape[:-1], dtype=_compute_dtype(o), device=dev)
    if dev.type != "cuda":
        raise _no_path(o)
    D = o.shape[-1]
    _check_head_dim(D, "delta")
    entry, counter = _instantiation(o, "delta")
    for name, t in (("o", o), ("do", do)):
        native.check_operand(t, name, o.dtype, dev, o.shape)
    delta = torch.empty(o.shape[:-1], dtype=torch.float32, device=dev)
    if o.numel() == 0:
        return delta
    err = getattr(native.lib(), f"ptt_flash_delta_{entry}")(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(), o.numel() // D, D,
        *_device_args(dev))
    native.check(err, "flash_delta launch")
    native.count_launch("flash_delta" + counter)
    return delta


def _flash_backward(q, k, v, o, lse, do, causal, sm_scale, rate=0.0,
                    seed=0, bh0=0):
    """The delta kernel, then the dQ and dK/dV kernels: (dq, dk, dv)."""
    delta = flash_delta(o, do)
    dq = _flash_dq(q, k, v, do, lse, delta, causal, sm_scale, rate, seed,
                   bh0)
    dk, dv = _flash_dkv(q, k, v, do, lse, delta, causal, sm_scale, rate,
                        seed, bh0)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the autograd Function and its entry
# ---------------------------------------------------------------------------

def _no_path(t):
    return ValueError(f"flash_attention: no path for device {t.device}")


class FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v); its backward is the dQ and dK/dV
    kernels on a card, their plain version on the host."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, rate, seed, bh0):
        if q.device.type == "cuda":
            out, lse = _flash_forward(q, k, v, causal, sm_scale, rate, seed,
                                      bh0)
        elif q.device.type == "cpu":
            out = _attention_reference(q, k, v, causal, sm_scale, rate, seed,
                                       bh0)
            lse = _lse_reference(q, k, causal, sm_scale)
        else:
            raise _no_path(q)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, sm_scale, rate, seed, bh0)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        if q.device.type == "cuda":
            grads = _flash_backward(q, k, v, out, lse, do, *ctx.args)
        else:
            grads = _flash_backward_reference(q, k, v, out, lse, do,
                                              *ctx.args)
        return (*grads, None, None, None, None, None)


def flash_attention(q, k, v, causal=False, sm_scale=1.0, dropout_rate=0.0,
                    seed=0, bh0=0):
    """Attention over [B, H, T, D] tensors, differentiable; the kernels
    on a card, the plain versions on the host. `seed` (a host int) keys
    the attention-weight dropout mask when `dropout_rate` > 0; `bh0` is
    the first (batch, head) row's index in the whole batch when these
    tensors are one rank's rows of it, so the mask is one device's."""
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type not in ("cuda", "cpu"):
        raise _no_path(q)
    return FlashAttention.apply(q, k, v, bool(causal), float(sm_scale),
                                float(dropout_rate), int(seed), int(bh0))


# ---------------------------------------------------------------------------
# ring attention: sequence parallelism over an 'sp' mesh axis
# ---------------------------------------------------------------------------

def ring_attention(q, k, v, mesh, axis="sp", causal=False, sm_scale=None):
    """Exact attention with Q/K/V sequence-sharded over `axis`: each rank
    holds [B, H, T/sp, D] shards, and K/V shards rotate to the next rank
    of the ring (``parallel/spmd.py::ring_shift``, a point-to-point send
    and receive whose backward rotates the other way) while the online
    softmax (m, l, acc) accumulates, the JAX package's `ring_attention`.
    Plain PyTorch arithmetic, as the JAX ring is jnp outside any Pallas
    kernel: no flash kernel launches here. Causal masking compares global
    row and column positions."""
    from ..parallel import spmd
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    sp, idx = mesh.shape[axis], mesh.index(axis)
    B, H, Tl, D = q.shape
    ct = _compute_dtype(q)
    qs = q.to(ct)
    m = torch.full((B, H, Tl), NEG_INF, dtype=ct, device=q.device)
    l = torch.zeros((B, H, Tl), dtype=ct, device=q.device)
    acc = torch.zeros((B, H, Tl, D), dtype=ct, device=q.device)
    rows = idx * Tl + torch.arange(Tl, device=q.device)
    kc, vc = k, v
    for step in range(sp):
        src = (idx - step) % sp       # the global chunk held this step
        s = torch.einsum("bhqd,bhkd->bhqk", qs, kc.to(ct)) * sm_scale
        if causal:
            cols = src * Tl + torch.arange(Tl, device=q.device)
            s = s.masked_fill(cols[None, :] > rows[:, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p, vc.to(ct))
        m = m_new
        if step < sp - 1:
            kc = spmd.ring_shift(kc, mesh, axis)
            vc = spmd.ring_shift(vc, mesh, axis)
    return (acc / l.clamp_min(1e-20)[..., None]).to(q.dtype)


@register_op("fused_attention", needs_rng=True,
             propagate_seqlen=False)
def _fused_attention(ctx, Q, K, V):
    """Q/K/V: [B, H, T, Dh]. attrs: causal, sm_scale, dropout_rate,
    is_test. One O(T)-memory kernel in place of the reference's
    matmul+softmax+dropout+matmul composition (nets.py:329), with the
    attention-weight dropout inside it, keyed by the op's seed.

    Under a `ParallelExecutor` mesh (`ctx.mesh`, the JAX lowerer's
    `mesh`) with an 'sp' axis over more than one rank the sequence is
    sharded, and attention becomes `ring_attention`. Under a batch split
    the kernels take the rank's first (batch, head) row (`bh0`), so the
    dropout mask is the one device's."""
    sm_scale = ctx.attr("sm_scale", 1.0 / math.sqrt(Q.shape[-1]))
    causal = ctx.attr("causal", False)
    rate = 0.0 if ctx.attr("is_test", False) else ctx.attr("dropout_rate",
                                                           0.0)
    mesh = ctx.mesh
    shard = ctx.origin("Q")
    if mesh is not None and mesh.shape.get("sp", 1) > 1:
        if rate:
            raise NotImplementedError(
                "attention-weight dropout is not supported under sequence "
                "parallelism; build the model with dropout_rate=0 (or move "
                "dropout outside the attention op)")
        T = shard[0][2] if shard is not None else Q.shape[2]
        if T % mesh.shape["sp"] != 0:
            raise ValueError(
                f"sequence length {T} is not divisible by the "
                f"{mesh.shape['sp']}-way 'sp' mesh axis; pad the sequence "
                f"or choose an sp that divides it")
        return {"Out": ring_attention(Q, K, V, mesh, axis="sp",
                                      causal=causal, sm_scale=sm_scale)}
    bh0 = 0
    if shard is not None:
        gshape, offs = shard
        if tuple(gshape[1:]) != tuple(Q.shape[1:]):
            raise NotImplementedError(
                "fused_attention: only the batch dim may be split over "
                "ranks outside an 'sp' ring")
        bh0 = offs[0] * Q.shape[1]
    seed = seed32(ctx.seed) if rate else 0
    return {"Out": flash_attention(Q.contiguous(), K.contiguous(),
                                   V.contiguous(), causal, sm_scale,
                                   float(rate), seed, bh0)}
