"""Loss and metric op rules: `cross_entropy`,
`softmax_with_cross_entropy` and its hand-written grad,
`square_error_cost`, `sigmoid_cross_entropy_with_logits`, `accuracy`,
`smooth_l1_loss`, `huber_loss`, `log_loss`, `rank_loss`,
`margin_rank_loss`, `hinge_loss` and the streaming `auc`.

Mirror of ``paddle_tpu/ops/loss.py``. `cross_entropy` takes
probabilities and clamps them at 1e-8, so a loss stops at -log(1e-8) =
18.42; its grad is the generic one. `softmax_with_cross_entropy`'s
forward also outputs the
[rows, 1] float32 log-sum-exp (`LSE`, a hidden output the layer declares);
the grad rebuilds the softmax as exp(logits - lse) from it, so the
backward re-runs no [rows, V] reduction and no float32 [rows, V]
probabilities are kept from the forward for it.
"""

from __future__ import annotations

import torch

from ..core.registry import register_grad, register_op
from ..core import types
from .math import jax_abs


def _squeeze_label(Label):
    if Label.ndim >= 2 and Label.shape[-1] == 1:
        return Label.reshape(Label.shape[:-1])
    return Label


@register_op("cross_entropy")
def _cross_entropy(ctx, X, Label):
    """X is a probability distribution (post-softmax), reference
    cross_entropy_op.cc semantics; the output keeps a trailing 1-dim. A
    hard label equal to `ignore_index` gives a loss of 0."""
    eps = 1e-8
    if ctx.attr("soft_label", False):
        return {"Y": -(Label * torch.log(X.clamp_min(eps))).sum(
            dim=-1, keepdim=True)}
    ids = _squeeze_label(Label).long()[..., None]
    # an ignored id may lie outside [0, C): gather at a clamped index,
    # then zero that row's loss
    p = X.gather(-1, ids.clamp(0, X.shape[-1] - 1))
    loss = -torch.log(p.clamp_min(eps))
    return {"Y": loss.masked_fill(ids == ctx.attr("ignore_index", -100), 0.0)}


@register_op("square_error_cost")
def _square_error_cost(ctx, X, Y):
    d = X - Y
    return {"Out": d * d}


@register_op("sigmoid_cross_entropy_with_logits")
def _sigmoid_ce(ctx, X, Label):
    """max(x, 0) - x * label + log1p(exp(-|x|)), 0 where the label is
    `ignore_index`. The max and the absolute value take the JAX rule's
    grads at x = 0 (`torch.maximum` splits 0.5, `jax_abs` gives +1), so an
    exactly-zero logit gets the JAX package's grad, -label."""
    loss = torch.maximum(X, X.new_zeros(())) - X * Label \
        + torch.log1p(torch.exp(-jax_abs(X)))
    ignore = Label == ctx.attr("ignore_index", -100)
    return {"Out": torch.where(ignore, torch.zeros_like(loss), loss)}


@register_op("accuracy", propagate_seqlen=False)
def _accuracy(ctx, Out, Indices, Label):
    """Top-k accuracy (reference accuracy_op.cc): a row is correct when
    any of its `Indices` [N, k] (from top_k) is its label. `Accuracy` is
    float32 [1], `Correct` and `Total` int32 [1]."""
    label = _squeeze_label(Label).long()
    n = label.shape[0]
    correct = (Indices.long() == label[:, None]).any(dim=1).sum(
        dtype=torch.int32).reshape(1)
    return {"Accuracy": correct.float() / n, "Correct": correct,
            "Total": torch.full((1,), n, dtype=torch.int32,
                                device=Label.device)}


@register_op("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(ctx, Logits, Label):
    logits32 = Logits.float()
    lse = torch.logsumexp(logits32, dim=-1, keepdim=True)
    softmax = torch.exp(logits32 - lse)
    if ctx.attr("soft_label", False):
        loss = -(Label * (logits32 - lse)).sum(dim=-1, keepdim=True)
    else:
        ids = _squeeze_label(Label).long()[..., None]
        ignore = ctx.attr("ignore_index", -100)
        # an ignored id may lie outside [0, V): gather at a clamped index,
        # then zero that row's loss
        picked = logits32.gather(-1, ids.clamp(0, Logits.shape[-1] - 1))
        loss = (lse - picked).masked_fill(ids == ignore, 0.0)
    return {"Softmax": softmax.to(Logits.dtype),
            "Loss": loss.to(Logits.dtype), "LSE": lse}


@register_grad("softmax_with_cross_entropy")
def _swce_grad(ctx, ins, out_grads):
    """dLogits = (softmax - onehot) * dLoss (+ the Softmax output's own
    grad when it has one), with softmax = exp(logits - saved lse)."""
    Logits, Label = ins["Logits"][0], ins["Label"][0]
    gL = out_grads.get("Loss", [None])[0]
    gS = out_grads.get("Softmax", [None])[0]
    lse = getattr(ctx, "fwd_outs", {}).get("LSE", [None])[0]
    logits32 = Logits.float()
    if lse is None:
        lse = torch.logsumexp(logits32, dim=-1, keepdim=True)
    softmax = torch.exp(logits32 - lse)
    soft_label = ctx.attr("soft_label", False)
    d = None
    d_label = None
    if soft_label and Label.is_floating_point():
        # backward.py may declare Label@GRAD even when only Softmax is used
        d_label = torch.zeros_like(Label)
    if gS is not None:
        gS32 = gS.float()
        d = softmax * (gS32 - (gS32 * softmax).sum(-1, keepdim=True))
    if gL is not None:
        gL32 = gL.float()
        if soft_label:
            lab32 = Label.float()
            lsum = lab32.sum(-1, keepdim=True)
            contrib = (lsum * softmax - lab32) * gL32
            d_label = (-(logits32 - lse) * gL32).to(Label.dtype)
        else:
            ids = _squeeze_label(Label).long()[..., None]
            ignore = ctx.attr("ignore_index", -100)
            # softmax - onehot: subtract 1 at the label, in place (the
            # softmax is this rule's own tensor and not read again)
            softmax.scatter_add_(
                -1, ids.clamp(0, softmax.shape[-1] - 1),
                torch.full(ids.shape, -1.0, dtype=softmax.dtype,
                           device=softmax.device))
            contrib = softmax.mul_(gL32).masked_fill_(ids == ignore, 0.0)
        d = contrib if d is None else d + contrib
    if d is None:
        d = torch.zeros_like(logits32)
    out = {"Logits": d.to(Logits.dtype)}
    if d_label is not None:
        out["Label"] = d_label
    return out


def _s(value, x):
    """A Python scalar rounded to x's dtype, as JAX's weak typing does."""
    return types.scalar_as(value, x.dtype)


@register_op("smooth_l1_loss")
def _smooth_l1(ctx, X, Y, InsideWeight=None, OutsideWeight=None):
    """Per row, the sum of 0.5 (sigma d)^2 where |d| < 1 / sigma^2 and
    |d| - 0.5 / sigma^2 elsewhere, d = (X - Y) * InsideWeight; `Diff` is
    d. |d| is `jax_abs`, for the JAX rule's grad at d = 0."""
    sigma = ctx.attr("sigma", 1.0)
    s2 = sigma * sigma
    d = X - Y
    if InsideWeight is not None:
        d = d * InsideWeight
    ad = jax_abs(d)
    loss = torch.where(ad < _s(1.0 / s2, d), _s(0.5, d) * d * d * _s(s2, d),
                       ad - _s(0.5 / s2, d))
    if OutsideWeight is not None:
        loss = loss * OutsideWeight
    loss = loss.reshape(loss.shape[0], -1).sum(-1, keepdim=True)
    return {"Out": loss, "Diff": d}


@register_op("huber_loss")
def _huber(ctx, X, Y):
    """0.5 r^2 where |r| <= delta, delta (|r| - delta / 2) elsewhere,
    r = Y - X (`Residual`)."""
    delta = ctx.attr("delta", 1.0)
    r = Y - X
    ar = jax_abs(r)
    loss = torch.where(ar <= _s(delta, r), _s(0.5, r) * r * r,
                       _s(delta, r) * (ar - _s(0.5 * delta, r)))
    return {"Out": loss, "Residual": r}


@register_op("log_loss")
def _log_loss(ctx, Predicted, Labels):
    eps = _s(ctx.attr("epsilon", 1e-4), Predicted)
    p = Predicted
    return {"Loss": -Labels * torch.log(p + eps)
            - (1 - Labels) * torch.log(1 - p + eps)}


@register_op("rank_loss")
def _rank_loss(ctx, Label, Left, Right):
    d = Left - Right
    return {"Out": torch.log1p(torch.exp(d)) - Label * d}


@register_op("margin_rank_loss")
def _margin_rank_loss(ctx, Label, X1, X2):
    """max(0, -Label (X1 - X2) + margin), with `torch.maximum` (its grad
    splits at 0 as `jnp.maximum`'s); `Activated` marks the rows above 0."""
    act = torch.maximum(X1.new_zeros(()),
                        -Label * (X1 - X2) + _s(ctx.attr("margin", 0.0), X1))
    return {"Out": act, "Activated": (act > 0).to(X1.dtype)}


@register_op("hinge_loss")
def _hinge_loss(ctx, Logits, Labels):
    y = Labels * 2.0 - 1.0
    return {"Loss": torch.maximum(Logits.new_zeros(()), 1.0 - y * Logits)}


@register_op("auc", propagate_seqlen=False)
def _auc(ctx, Predict, Label, StatPos, StatNeg):
    """Streaming AUC over threshold buckets (reference auc_op.cc): each
    prediction's label adds into bucket clip(int(p * num_thresholds), 0,
    num_thresholds) of `StatPos` (1 - label into `StatNeg`), then the
    ROC's trapezoid over the reversed cumulative sums. The histograms are
    counts below 2^24, exact in float32, so `index_add`'s order on the
    card does not move them; `AUC` sums in torch's order, an ulp or so
    from the JAX rule's."""
    nt = ctx.attr("num_thresholds", 200)
    if Predict.ndim == 2 and Predict.shape[1] == 2:
        pos_prob = Predict[:, 1]
    else:
        pos_prob = Predict.reshape(-1)
    label = _squeeze_label(Label).to(torch.float32).reshape(-1)
    idx = (pos_prob * nt).to(torch.int64).clamp(0, nt)
    pos = StatPos.index_add(0, idx, label)
    neg = StatNeg.index_add(0, idx, 1.0 - label)
    tp = torch.cumsum(torch.flip(pos, (0,)), 0)
    fp = torch.cumsum(torch.flip(neg, (0,)), 0)
    one = tp.new_ones(())
    tpr = tp / torch.maximum(tp[-1], one)
    fpr = fp / torch.maximum(fp[-1], one)
    auc = 0.5 * (torch.diff(fpr) * (tpr[1:] + tpr[:-1])).sum()
    return {"AUC": auc.reshape(1), "StatPosOut": pos, "StatNegOut": neg}
