"""Fused (flash) attention, forward: the CUDA kernel and its plain version.

Counterpart of ``paddle_tpu/ops/pallas_attention.py`` (forward path only;
the dQ and dK/dV kernels come with training). Public layout is the JAX
package's: q, k, v and the output are [B, H, T, D].

`flash_attention` dispatches on where its tensors lie:

- CUDA: the hand-written kernel of ``csrc/flash_fwd.cu`` (it replaces
  ``_flash_fwd_kernel``; see that file for what bounds it and how its
  design answers that). It takes float32, D in {32, 64, 128} and any T;
  anything else raises — there is no fallback;
- CPU: `_attention_reference`, the plain PyTorch version of the same
  function (the JAX package's ``_attention_reference``);
- meta: an empty output of the right shape (build-time shape inference).

Attention-weight dropout is training and is not ported: a rate > 0
raises.
"""

from __future__ import annotations

import torch

from . import native

NEG_INF = -1e30

_HEAD_DIMS = (32, 64, 128)


def _masked_scores(q, k, causal, sm_scale):
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * sm_scale
    if causal:
        Tq, Tk = s.shape[-2], s.shape[-1]
        above = torch.ones(Tq, Tk, dtype=torch.bool,
                           device=s.device).triu(1)
        s = s.masked_fill(above, NEG_INF)
    return s


def _attention_reference(q, k, v, causal, sm_scale):
    """Plain PyTorch version: softmax(Q K^T * sm_scale) V, causal-masked."""
    p = torch.softmax(_masked_scores(q, k, causal, sm_scale), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def _lse_reference(q, k, causal, sm_scale):
    """Row logsumexp of the masked scores, [B, H, T] (the kernel's second
    output)."""
    return torch.logsumexp(_masked_scores(q, k, causal, sm_scale), dim=-1)


def _flash_forward(q, k, v, causal, sm_scale):
    """Launch the kernel: returns (out [B, H, T, D], lse [B, H, T])."""
    B, H, T, D = q.shape
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head dim "
                         f"{_HEAD_DIMS}, got {D}")
    if B * H > native.MAX_GRID_Y:
        raise ValueError(f"flash attention kernel: B*H = {B * H} exceeds "
                         f"the grid's y limit {native.MAX_GRID_Y}")
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
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    native.check(err, "flash_fwd launch")
    native.count_launch("flash_fwd")
    return out, lse


def flash_attention(q, k, v, causal=False, sm_scale=1.0, dropout_rate=0.0):
    """Attention over [B, H, T, D] tensors; the kernel on a card, the plain
    version on the host."""
    if dropout_rate:
        raise NotImplementedError(
            "attention-weight dropout is training; it is not ported yet")
    if q.device.type == "cuda":
        return _flash_forward(q, k, v, causal, sm_scale)[0]
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return _attention_reference(q, k, v, causal, sm_scale)
    raise ValueError(f"flash_attention: no path for device {q.device}")
