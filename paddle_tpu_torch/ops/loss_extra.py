"""Sampled and structured losses: NCE, the hierarchical sigmoid, the
linear-chain CRF and its Viterbi decode, CTC and the edit distance
(mirror of ``paddle_tpu/ops/loss_extra.py``; reference nce_op.cc,
hierarchical_sigmoid_op.cc, linear_chain_crf_op.h, crf_decoding_op.h,
warpctc_op.cc, edit_distance_op.cc).

`nce` draws its negatives uniformly from the op's generator
(`LoweringContext.generator`), a stream of the port's own (ROADMAP,
expected differences); its `SampleLabels` are int64, the port's index
dtype. `warpctc`'s alpha recursion is a loop over the frames that can
change a row (up to the longest `LogitsLen`, read back once), in log
space with the JAX rule's NEG = -1e30 for an impossible state (the grad
of `logaddexp` at -inf is NaN). `edit_distance` takes each row of the
Levenshtein table in closed form: cur[j] = j + min over k <= j of
(a[k] - k), where a[k] = min(up[k] + 1, diag[k] + sub[k]) and a[0] the
row's first value, so a row is one `torch.cummin`; the JAX rule's
column scan holds columns past `RefsLen` at the value of the length
column, and since no such column feeds one at or before it, the value
read at `RefsLen` is the same. The table holds small integers in
float32, exactly, so the result is bit for bit the JAX rule's.

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

import math

import torch

from ..core.registry import register_op
from .math import _softplus, jax_log_softmax


# ---------------------------------------------------------------------------
# NCE (noise-contrastive estimation)
# ---------------------------------------------------------------------------

def _sampled_logits(x, weight, bias, ids):
    """x [B, D] against the rows `ids` [B, k] of weight: [B, k]."""
    out = torch.einsum("bd,bkd->bk", x, weight[ids])
    if bias is not None:
        out = out + bias.reshape(-1)[ids]
    return out


@register_op("nce", needs_rng=True, propagate_seqlen=False)
def _nce(ctx, Input, Label, Weight, Bias=None, SampleWeight=None):
    """Input [B, D], Weight [V, D], Bias [V], Label [B, T_true]; uniform
    negative sampling (reference nce_op.cc sampler=uniform)."""
    num_neg = ctx.attr("num_neg_samples", 10)
    V = ctx.attr("num_total_classes", Weight.shape[0])
    B = Input.shape[0]
    label = Label.long()
    if label.ndim == 1:
        label = label[:, None]
    neg = torch.randint(0, V, (B, num_neg), generator=ctx.generator,
                        device=Input.device)
    true_logit = _sampled_logits(Input, Weight, Bias, label)
    neg_logit = _sampled_logits(Input, Weight, Bias, neg)
    # NCE with uniform noise: P_n = 1/V
    shift = math.log(num_neg) + math.log(1.0 / V)
    cost = (torch.sum(_softplus(-(true_logit - shift)), dim=1)
            + torch.sum(_softplus(neg_logit - shift), dim=1))
    if SampleWeight is not None:
        cost = cost * SampleWeight.reshape(-1)
    return {"Cost": cost[:, None],
            "SampleLogits": torch.cat([true_logit, neg_logit], 1),
            "SampleLabels": torch.cat([label, neg], 1)}


# ---------------------------------------------------------------------------
# Hierarchical sigmoid over a complete binary tree
# ---------------------------------------------------------------------------

def _bit_codes(label, num_classes):
    """Reference math/matrix_bit_code.h SimpleCode: the node index starts
    at label + num_classes and walks to the root of a complete binary
    tree; (internal node index clamped at 0, the bit, valid)."""
    depth = max(int(math.ceil(math.log2(max(num_classes, 2)))), 1)
    node = label + num_classes
    idxs, bits = [], []
    for _ in range(depth):
        bits.append((node & 1).float())
        node = torch.div(node, 2, rounding_mode="floor")
        idxs.append(node - 1)
    idx = torch.stack(idxs, dim=1)
    valid = (idx >= 0).float()
    return torch.clamp_min(idx, 0), torch.stack(bits, dim=1), valid


@register_op("hierarchical_sigmoid", propagate_seqlen=False)
def _hsigmoid(ctx, X, W, Label, Bias=None):
    """X [B, D], W [num_classes - 1, D], Bias [num_classes - 1, 1]
    (reference hierarchical_sigmoid_op.cc): the sigmoid cross entropy of
    each node on the label's path against its bit, summed."""
    idx, bit, valid = _bit_codes(Label.reshape(-1).long(),
                                 ctx.attr("num_classes"))
    logit = _sampled_logits(X, W, Bias, idx)
    loss = _softplus(logit) - bit * logit
    return {"Out": torch.sum(loss * valid, dim=1, keepdim=True),
            "PreOut": logit}


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


# ---------------------------------------------------------------------------
# CTC loss (reference warpctc_op.cc)
# ---------------------------------------------------------------------------

_NEG = -1e30


def _lengths(v, B, full, device):
    return (v.reshape(-1).long() if v is not None else
            torch.full((B,), full, dtype=torch.long, device=device))


@register_op("warpctc", propagate_seqlen=False)
def _warpctc(ctx, Logits, Label, LogitsLen=None, LabelLen=None):
    """Logits [B, T, C] (blank = attr), Label [B, U]: each row's CTC
    loss, [B, 1], from the alpha recursion in log space over the label
    sequence with interleaved blanks (blank, l1, blank, ..., blank)."""
    blank = ctx.attr("blank", 0)
    B, T, C = Logits.shape
    U = Label.shape[1]
    dev = Logits.device
    if dev.type == "meta":
        return {"Loss": Logits.new_empty((B, 1), dtype=torch.float32)}
    label = Label.long()
    t_len = _lengths(LogitsLen, B, T, dev)
    u_len = _lengths(LabelLen, B, U, dev)
    logp = jax_log_softmax(Logits.float())
    S = 2 * U + 1
    s = torch.arange(S, device=dev)
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = label
    ext_valid = s[None, :] < (2 * u_len + 1)[:, None]
    # a state may skip from s - 2 when ext[s] is no blank and not ext[s-2]
    can_skip = torch.cat([torch.zeros((B, 2), dtype=torch.bool, device=dev),
                          (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])],
                         1)
    neg = logp.new_full((), _NEG)
    # each state's log-probability at every frame, [B, T, S], by indexing:
    # its grad adds the blank's repeated reads in a sorted kernel on the
    # card (a `gather`'s grad adds them with atomics, in no fixed order)
    rows = torch.arange(B, device=dev)
    emit = logp[rows[:, None, None], torch.arange(T, device=dev)[None, :,
                                                                 None],
                ext[:, None, :]]
    alpha = torch.where(ext_valid & (s[None, :] < 2), emit[:, 0], neg)
    for t in range(1, min(int(t_len.max()), T)):
        prev1 = torch.cat([neg.expand(B, 1), alpha[:, :-1]], 1)
        prev2 = torch.where(can_skip, torch.cat([neg.expand(B, 2),
                                                 alpha[:, :-2]], 1), neg)
        tot = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        new = torch.where(ext_valid, tot + emit[:, t], neg)
        alpha = torch.where((t < t_len)[:, None], new, alpha)
    last = 2 * u_len                                   # the final blank
    a_last = alpha[rows, last]
    a_prev = alpha[rows, torch.clamp_min(last - 1, 0)]
    # a row with no label has only the all-blank path
    a_prev = torch.where(u_len > 0, a_prev, neg)
    return {"Loss": -torch.logaddexp(a_last, a_prev)[:, None]}


# ---------------------------------------------------------------------------
# Edit distance (reference edit_distance_op.cc)
# ---------------------------------------------------------------------------

@register_op("edit_distance", propagate_seqlen=False)
def _edit_distance(ctx, Hyps, Refs, HypsLen=None, RefsLen=None):
    """The Levenshtein distance of each row's hypothesis to its
    reference, [B, 1] float32 (over the reference's length when
    `normalized`), and the row count `SequenceNum` (module docstring)."""
    hyp = Hyps[..., 0] if Hyps.ndim == 3 else Hyps
    ref = Refs[..., 0] if Refs.ndim == 3 else Refs
    B, Th = hyp.shape
    Tr = ref.shape[1]
    dev = Hyps.device
    num = torch.tensor([B], dtype=torch.int64, device=dev)
    if dev.type == "meta":
        return {"Out": Hyps.new_empty((B, 1), dtype=torch.float32),
                "SequenceNum": num}
    hl = _lengths(HypsLen, B, Th, dev)
    rl = _lengths(RefsLen, B, Tr, dev)
    j = torch.arange(Tr + 1, dtype=torch.float32, device=dev)
    row = j[None, :].expand(B, Tr + 1)
    for i in range(1, min(int(hl.max()), Th) + 1):
        sub = (hyp[:, i - 1][:, None] != ref).float()
        a = torch.cat([row[:, :1] + 1,
                       torch.minimum(row[:, 1:] + 1, row[:, :-1] + sub)], 1)
        cur = torch.cummin(a - j, dim=1).values + j
        row = torch.where((i <= hl)[:, None], cur, row)
    dist = torch.gather(row, 1, rl[:, None])[:, 0]
    if ctx.attr("normalized", False):
        dist = dist / torch.clamp_min(rl.float(), 1.0)
    return {"Out": dist[:, None], "SequenceNum": num}
