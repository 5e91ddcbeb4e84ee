"""Structured losses: the linear-chain CRF and its Viterbi decode (mirror
of the `linear_chain_crf` and `crf_decoding` rules of
``paddle_tpu/ops/loss_extra.py``; reference linear_chain_crf_op.h,
crf_decoding_op.h).

A batch is padded [B, T, N] emissions plus the int32 `@SEQLEN` lengths.
The JAX package runs each recursion as a `lax.scan`; here it is a
Python loop over the T steps, each step a few PyTorch ops on the whole
batch, as ``ops/rnn.py`` runs its recurrences. A row past its length
keeps its carry (`alpha * (1 - m) + nxt * m`, m its 0/1 mask at that
step), so the loop never reads a length back to the host. Each op of a
step is the JAX rule's, in its order. The CRF's grad is the generic one
(the rule recomputed under autograd), the counterpart of the JAX
package's autodiff through its scan. Both rules run in float32 (the
emissions are upcast as the JAX rules upcast them; `linear_chain_crf`
is in the AMP policy's float32 set). On meta tensors (build-time shape
inference) no loop runs.

The transition matrix is [N + 2, N]: row 0 the start weights, row 1
the stop weights, rows 2.. the pairwise w[from + 2, to].
"""

from __future__ import annotations

import torch

from ..core.registry import register_op


def _lengths_and_mask(Emission, SeqLen):
    B, T, _ = Emission.shape
    L = (SeqLen.reshape(-1).long() if SeqLen is not None else
         torch.full((B,), T, dtype=torch.long, device=Emission.device))
    t = torch.arange(T, device=Emission.device)
    return L, (t[None, :] < L[:, None]).to(torch.float32)


@register_op("linear_chain_crf", propagate_seqlen=False)
def _linear_chain_crf(ctx, Emission, Transition, Label, SeqLen=None):
    """The negative log-likelihood of each row's gold path, [B, 1]:
    log Z from the alpha recursion with a float32 logsumexp, minus the
    gold path's emission, transition, start and stop scores (the stop
    weight of the tag at L - 1). `Label` is [B, T] or [B, T, 1]."""
    if Label.ndim == 3:
        Label = Label[..., 0]
    label = Label.long()
    B, T, N = Emission.shape
    L, mask = _lengths_and_mask(Emission, SeqLen)
    start, stop, trans = Transition[0], Transition[1], Transition[2:]
    e = Emission.to(torch.float32)

    alpha = start[None, :] + e[:, 0]
    if e.device.type != "meta":
        for t in range(1, T):
            nxt = torch.logsumexp(alpha[:, :, None] + trans[None, :, :],
                                  dim=1) + e[:, t]
            m = mask[:, t][:, None]
            alpha = alpha * (1 - m) + nxt * m
    log_z = torch.logsumexp(alpha + stop[None, :], dim=1)

    emit_score = torch.sum(
        torch.gather(e, 2, label[..., None])[..., 0] * mask, dim=1)
    if T > 1:
        trans_score = torch.sum(trans[label[:, :-1], label[:, 1:]]
                                * mask[:, 1:], dim=1)
    else:
        trans_score = e.new_zeros((B,))
    start_score = start[label[:, 0]]
    last_idx = torch.clamp_min(L - 1, 0)
    last_tag = torch.gather(label, 1, last_idx[:, None])[:, 0]
    stop_score = stop[last_tag]
    gold = emit_score + trans_score + start_score + stop_score
    return {"LogLikelihood": (log_z - gold)[:, None], "Alpha": alpha,
            "EmissionExps": torch.exp(e),
            "TransitionExps": torch.exp(Transition)}


@register_op("crf_decoding", propagate_seqlen=False)
def _crf_decoding(ctx, Emission, Transition, Label=None, SeqLen=None):
    """The Viterbi path, [B, T] in the port's index dtype (int64), zero
    past each row's length; with `Label`, 1 where the path differs from
    it and 0 elsewhere. Ties go to the first index, as `jnp.argmax`
    takes them (`torch.argmax` does the same). The backtrack keeps a
    row's tag while `t + 1 <= L - 1` is false, as the JAX rule does."""
    B, T, N = Emission.shape
    if Emission.device.type == "meta":
        return {"ViterbiPath": torch.empty((B, T), dtype=torch.int64,
                                           device="meta")}
    L, mask = _lengths_and_mask(Emission, SeqLen)
    start, stop, trans = Transition[0], Transition[1], Transition[2:]
    e = Emission.to(torch.float32)

    score = start[None, :] + e[:, 0]
    back = []
    for t in range(1, T):
        cand = score[:, :, None] + trans[None, :, :]     # [B, from, to]
        back.append(torch.argmax(cand, dim=1))
        nxt = torch.amax(cand, dim=1) + e[:, t]
        m = mask[:, t][:, None]
        score = score * (1 - m) + nxt * m
    last_tag = torch.argmax(score + stop[None, :], dim=1)

    tag, tags = last_tag, [last_tag]
    for t_rev in range(T - 2, -1, -1):
        prev_tag = torch.gather(back[t_rev], 1, tag[:, None])[:, 0]
        in_range = (t_rev + 1 <= L - 1).long()
        tag = prev_tag * in_range + tag * (1 - in_range)
        tags.append(tag)
    path = torch.stack(tags[::-1], dim=1)
    if Label is not None:
        lbl = Label[..., 0] if Label.ndim == 3 else Label
        path = (path != lbl.long()).long()
    return {"ViterbiPath": path * mask.long()}
