"""Beam-search op rules: `tile_beam`, `beam_search_step`,
`beam_backtrack`.

Mirror of ``paddle_tpu/ops/beam.py`` (reference beam_search_op.cc,
beam_search_decode_op.cc). Beams have a fixed width [B, beam]: a
finished beam is frozen by its scores (it can only emit end_id, at no
cost), a decode runs all max_len steps, and `beam_backtrack` gathers the
final sequences from the stacked (ids, parents) history. Nothing is read
back to the host.
"""

from __future__ import annotations

import torch

from ..core.ir import SEQLEN_SUFFIX
from ..core.registry import register_op

NEG_INF = -1e9


@register_op("tile_beam", propagate_seqlen=False)
def _tile_beam(ctx, X):
    """[B, ...] -> [B * beam, ...], each row repeated beam times
    (beam-major under reshape([B, beam, ...])). The `@SEQLEN` companion
    is repeated too, written through the env."""
    k = ctx.attr("beam_size")
    out = torch.repeat_interleave(X, k, dim=0)
    if ctx.env is not None and ctx.op is not None:
        comp = ctx.env.get(ctx.op.input("X")[0] + SEQLEN_SUFFIX)
        if comp is not None:
            for out_name in ctx.op.output("Out"):
                ctx.env[out_name + SEQLEN_SUFFIX] = \
                    torch.repeat_interleave(comp, k, dim=0)
    return {"Out": out}


@register_op("beam_search_step", propagate_seqlen=False)
def _beam_search_step(ctx, LogProbs, AccScores, Finished):
    """One expansion step. LogProbs [B, beam, V] (the next token's
    log-softmax), AccScores [B, beam], Finished [B, beam] bool. Takes the
    `beam` best continuations of each batch row over all its beams; a
    finished beam's only continuation is end_id, at its unchanged score,
    so it survives as it is."""
    beam = ctx.attr("beam_size")
    end_id = ctx.attr("end_id", 1)
    B, K, V = LogProbs.shape
    fin = Finished.to(torch.bool)[..., None]
    neg = torch.full((), NEG_INF, dtype=LogProbs.dtype,
                     device=LogProbs.device)
    cont = torch.where(fin, neg, LogProbs)
    end_col = torch.full((1, 1, V), NEG_INF, dtype=LogProbs.dtype,
                         device=LogProbs.device)
    end_col[..., end_id] = 0.0
    scores = AccScores[..., None] + torch.where(fin, end_col, cont)
    top_scores, top_idx = torch.topk(scores.reshape(B, K * V), beam, dim=1)
    parent = torch.div(top_idx, V, rounding_mode="floor")
    token = top_idx - parent * V
    parent_fin = torch.gather(Finished.to(torch.bool), 1, parent)
    return {"Ids": token.to(torch.int32), "Parents": parent.to(torch.int32),
            "AccScoresOut": top_scores,
            "FinishedOut": parent_fin | (token == end_id)}


@register_op("beam_backtrack", propagate_seqlen=False)
def _beam_backtrack(ctx, Ids, Parents, AccScores):
    """Sequences from the per-step selections (reference
    beam_search_decode_op.cc). Ids, Parents [B, T, beam]; AccScores
    [B, beam], the last step's. SentenceIds [B, beam, T] best first,
    SentenceScores [B, beam]. The walk back over T is a host loop of
    gathers on the device."""
    B, T, K = Ids.shape
    beam_idx = torch.arange(K, device=Ids.device).expand(B, K)
    rev = []
    for t in range(T - 1, -1, -1):
        rev.append(torch.gather(Ids[:, t], 1, beam_idx))
        beam_idx = torch.gather(Parents[:, t].long(), 1, beam_idx)
    seqs = torch.stack(rev[::-1], dim=-1)                   # [B, K, T]
    order = torch.argsort(-AccScores, dim=1, stable=True)
    seqs = torch.gather(seqs, 1, order[:, :, None].expand(B, K, T))
    return {"SentenceIds": seqs.to(torch.int32),
            "SentenceScores": torch.gather(AccScores, 1, order)}
