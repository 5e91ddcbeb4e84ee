"""Fused (flash) attention: the CUDA kernels, their plain versions, the
autograd Function and the `fused_attention` op.

Counterpart of ``paddle_tpu/ops/pallas_attention.py`` (without its ring
attention: the port runs on one card). Public layout is the JAX
package's: q, k, v and the output are [B, H, T, D].

`flash_attention` is a `torch.autograd.Function` (the JAX package's
`custom_vjp`): its forward launches the forward kernel and saves
(q, k, v, out, lse); its backward computes delta = rowsum(dO * O) in
PyTorch (the JAX package does it in XLA) and launches the dQ and dK/dV
kernels. Each of the three dispatches on where its tensors lie:

- CUDA: the hand-written kernels of ``csrc/flash_fwd.cu`` and
  ``csrc/flash_bwd.cu`` (they replace ``_flash_fwd_kernel``,
  ``_flash_dq_kernel`` and ``_flash_dkv_kernel``; see those files for
  what bounds them and how their designs answer it). They take float32,
  D in {32, 64, 128}, any T, and as many keys as queries; anything else
  raises — there is no fallback;
- CPU: the plain PyTorch versions (`_attention_reference`,
  `_lse_reference`, `_flash_backward_reference`), which write out the
  kernels' own formulas;
- meta: an empty output of the right shape (build-time shape inference).

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

from ..core.registry import register_op
from . import native
from .nn import M32, _fmix32, _mul32, seed32

NEG_INF = -1e30

_HEAD_DIMS = (32, 64, 128)


# ---------------------------------------------------------------------------
# the dropout mask
# ---------------------------------------------------------------------------

def _dropout_threshold(rate: float) -> int:
    """Keep a weight when its 32-bit hash >= this (rate * 2**32)."""
    return min(max(int(rate * 2.0 ** 32), 0), M32)


def _drop_scale(rate: float) -> float:
    """1 / (1 - rate) rounded to float32, the value the kernels get."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def _attention_keep(seed: int, bh: int, Tq: int, Tk: int, rate: float,
                    device):
    """[bh, Tq, Tk] bool keep mask, the kernels' bits (flash_common.cuh)."""
    i64 = dict(dtype=torch.int64, device=device)
    bhs = torch.arange(bh, **i64)[:, None]
    bk = _fmix32((int(seed) & M32) ^ _mul32(bhs, 0x9E3779B9))
    rk = _fmix32((bk + torch.arange(Tq, **i64)[None, :]) & M32)
    ck = _mul32(torch.arange(Tk, **i64), 0x85EBCA77)
    return _fmix32(rk[:, :, None] ^ ck) >= _dropout_threshold(rate)


def _keep_like(s, rate, seed):
    """The keep mask for a [B, H, Tq, Tk] score tensor."""
    B, H, Tq, Tk = s.shape
    return _attention_keep(seed, B * H, Tq, Tk, rate,
                           s.device).reshape(B, H, Tq, Tk)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _masked_scores(q, k, causal, sm_scale):
    # float32 at least (float64 inputs stay float64, for gradient checks)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).to(
        torch.promote_types(q.dtype, torch.float32)) * sm_scale
    if causal:
        Tq, Tk = s.shape[-2], s.shape[-1]
        above = torch.ones(Tq, Tk, dtype=torch.bool,
                           device=s.device).triu(1)
        s = s.masked_fill(above, NEG_INF)
    return s


def _attention_reference(q, k, v, causal, sm_scale, rate=0.0, seed=0):
    """Plain PyTorch version: softmax(Q K^T * sm_scale), causal-masked,
    dropped and scaled by the kernels' mask, times V."""
    p = torch.softmax(_masked_scores(q, k, causal, sm_scale), dim=-1)
    if rate:
        p = torch.where(_keep_like(p, rate, seed), p * _drop_scale(rate),
                        torch.zeros((), dtype=p.dtype, device=p.device))
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def _lse_reference(q, k, causal, sm_scale):
    """Row logsumexp of the masked scores, [B, H, T] (the forward kernel's
    second output)."""
    return torch.logsumexp(_masked_scores(q, k, causal, sm_scale), dim=-1)


def _flash_backward_reference(q, k, v, o, lse, do, causal, sm_scale,
                              rate=0.0, seed=0):
    """The backward kernels' formulas in PyTorch (not autograd):
    W = exp(S - lse), dW = drop(dO V^T), dS = W (dW - delta) sm_scale,
    dQ = dS K, dK = dS^T Q, dV = drop(W)^T dO. Returns (dq, dk, dv)."""
    w = torch.exp(_masked_scores(q, k, causal, sm_scale) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    if rate:
        keep = _keep_like(w, rate, seed)
        zero = torch.zeros((), dtype=w.dtype, device=w.device)
        w_drop = torch.where(keep, w * _drop_scale(rate), zero)
        dw = torch.where(keep, dp * _drop_scale(rate), zero)
    else:
        w_drop, dw = w, dp
    delta = (do * o).sum(-1)
    ds = w * (dw - delta[..., None]) * sm_scale
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k),
            torch.einsum("bhqk,bhqd->bhkd", ds, q),
            torch.einsum("bhqk,bhqd->bhkd", w_drop, do))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_shape(q, what):
    B, H, T, D = q.shape
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head dim "
                         f"{_HEAD_DIMS}, got {D}")
    if B * H > native.MAX_GRID_Y:
        raise ValueError(f"flash attention {what}: B*H = {B * H} exceeds "
                         f"the grid's y limit {native.MAX_GRID_Y}")
    return B, H, T, D


def _device_args(dev):
    return (dev.index if dev.index is not None else torch.cuda.current_device(),
            torch.cuda.current_stream(dev).cuda_stream)


def _dropout_args(rate, seed):
    if not rate:
        return 0, 0, 1.0
    return int(seed) & M32, _dropout_threshold(rate), _drop_scale(rate)


def _flash_forward(q, k, v, causal, sm_scale, rate=0.0, seed=0):
    """Launch the forward kernel: returns (out [B, H, T, D], lse
    [B, H, T])."""
    B, H, T, D = _check_shape(q, "forward")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        native.check_operand(t, name, torch.float32, dev, (B, H, T, D))
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    if q.numel() == 0:
        return out, lse
    lib = native.lib()
    err = lib.ptt_flash_fwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B * H, T, D, float(sm_scale), int(bool(causal)),
        *_dropout_args(rate, seed), *_device_args(dev))
    native.check(err, "flash_fwd launch")
    native.count_launch("flash_fwd")
    return out, lse


def _flash_dq(q, k, v, do, lse, delta, causal, sm_scale, rate=0.0, seed=0):
    """Launch the dQ kernel: returns dq [B, H, T, D]."""
    B, H, T, D = _check_shape(q, "dQ")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        native.check_operand(t, name, torch.float32, dev, (B, H, T, D))
    for name, t in (("lse", lse), ("delta", delta)):
        native.check_operand(t, name, torch.float32, dev, (B, H, T))
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    err = native.lib().ptt_flash_dq_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B * H, T, D,
        float(sm_scale), int(bool(causal)), *_dropout_args(rate, seed),
        *_device_args(dev))
    native.check(err, "flash_dq launch")
    native.count_launch("flash_dq")
    return dq


def _flash_dkv(q, k, v, do, lse, delta, causal, sm_scale, rate=0.0, seed=0):
    """Launch the dK/dV kernel: returns (dk, dv), each [B, H, T, D]."""
    B, H, T, D = _check_shape(q, "dK/dV")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        native.check_operand(t, name, torch.float32, dev, (B, H, T, D))
    for name, t in (("lse", lse), ("delta", delta)):
        native.check_operand(t, name, torch.float32, dev, (B, H, T))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    err = native.lib().ptt_flash_dkv_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B * H, T, D, float(sm_scale), int(bool(causal)),
        *_dropout_args(rate, seed), *_device_args(dev))
    native.check(err, "flash_dkv launch")
    native.count_launch("flash_dkv")
    return dk, dv


def _flash_backward(q, k, v, o, lse, do, causal, sm_scale, rate=0.0,
                    seed=0):
    """delta in PyTorch, then the dQ and dK/dV kernels: (dq, dk, dv)."""
    delta = (do * o).sum(-1)
    dq = _flash_dq(q, k, v, do, lse, delta, causal, sm_scale, rate, seed)
    dk, dv = _flash_dkv(q, k, v, do, lse, delta, causal, sm_scale, rate,
                        seed)
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
    def forward(ctx, q, k, v, causal, sm_scale, rate, seed):
        if q.device.type == "cuda":
            out, lse = _flash_forward(q, k, v, causal, sm_scale, rate, seed)
        elif q.device.type == "cpu":
            out = _attention_reference(q, k, v, causal, sm_scale, rate, seed)
            lse = _lse_reference(q, k, causal, sm_scale)
        else:
            raise _no_path(q)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, sm_scale, rate, seed)
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
        return (*grads, None, None, None, None)


def flash_attention(q, k, v, causal=False, sm_scale=1.0, dropout_rate=0.0,
                    seed=0):
    """Attention over [B, H, T, D] tensors, differentiable; the kernels
    on a card, the plain versions on the host. `seed` (a host int) keys
    the attention-weight dropout mask when `dropout_rate` > 0."""
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type not in ("cuda", "cpu"):
        raise _no_path(q)
    return FlashAttention.apply(q, k, v, bool(causal), float(sm_scale),
                                float(dropout_rate), int(seed))


@register_op("fused_attention", needs_rng=True)
def _fused_attention(ctx, Q, K, V):
    """Q/K/V: [B, H, T, Dh]. attrs: causal, sm_scale, dropout_rate,
    is_test. One O(T)-memory kernel in place of the reference's
    matmul+softmax+dropout+matmul composition (nets.py:329), with the
    attention-weight dropout inside it, keyed by the op's seed."""
    sm_scale = ctx.attr("sm_scale", 1.0 / math.sqrt(Q.shape[-1]))
    rate = 0.0 if ctx.attr("is_test", False) else ctx.attr("dropout_rate",
                                                           0.0)
    seed = seed32(ctx.seed) if rate else 0
    return {"Out": flash_attention(Q.contiguous(), K.contiguous(),
                                   V.contiguous(), ctx.attr("causal", False),
                                   sm_scale, float(rate), seed)}
