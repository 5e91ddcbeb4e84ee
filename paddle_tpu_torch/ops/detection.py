"""The detection op family (SSD and RPN support).

Mirror of ``paddle_tpu/ops/detection.py`` (reference
paddle/fluid/operators/detection/). The JAX package computes these in
XLA, outside any Pallas kernel; here they are PyTorch ops on whatever
device holds the inputs, with the JAX package's static, padded layouts:
`multiclass_nms` gives Out [B, keep_top_k, 6] padded with label -1 and
`Count` [B]; `mine_hard_examples` a [B, M] negative mask; `detection_map`
reads detections in that padded layout and ground truth [B, G, 6]
padded with label -1. Match indices and `Count` are int64, the port's
index dtype; the masks and `rpn_target_assign`'s labels stay int32.

The JAX rules lean on three orderings, kept here: `jnp.argsort` is
stable (`torch.argsort(..., stable=True)` on the same key), `jnp.argmax`
returns the first maximum (as `torch.argmax` does), and `lax.top_k` puts
the lower index first among ties (a stable ascending sort of the
negated key).

The JAX package runs its greedy loops over every element; on the card
each step of a Python loop costs several launches, so each loop here
runs only the steps that can change the result, batched over the images
and classes:
- `multiclass_nms`: the JAX rule walks all M sorted boxes of each class
  but keeps none at or past k = min(nms_top_k, M), so only the first k
  of each class are read, as a [B, C, k] problem. With `nms_eta` 1 the
  kept set solves keep_i = valid_i and no j < i has keep_j and IoU_ij >
  threshold, whose solution is unique; a Jacobi iteration from keep =
  valid reaches it in as many rounds as the longest chain of
  suppressions (a round that changes nothing is the solution). With
  `nms_eta` < 1 the threshold moves after each kept box, and the k steps
  run in order.
- `bipartite_match`: min(N, M) greedy steps, batched over the batch.
- `detection_map`: the JAX rule scans all B * D detections in one global
  score order with a matched mask as its state. Each detection's best
  ground truth and whether it reaches the threshold do not depend on
  that state; the state only decides that the first detection, in score
  order, to hit a ground truth is its true positive and every later one
  a false positive. Images never interact, and within an image the
  stable global order is the image's own. So no step runs in a loop:
  the first claim of each ground truth is a min over the image's
  detections, and the true and false positives go back into the global
  order for the cumulative sums.
"""

from __future__ import annotations

import math

import torch

from ..core.registry import register_op
from .math import jax_abs, jax_log_softmax


def _scalar(like, value):
    """A python attr as a 0-d tensor in `like`'s dtype: the JAX rules
    compare and scale by weakly typed scalars, rounded to the array's
    dtype."""
    return like.new_full((), value)


def _stable_rank(key):
    """Each element's position in a stable ascending sort of `key` along
    the last dim (the JAX rules' `zeros.at[argsort].set(arange)`)."""
    order = torch.argsort(key, dim=-1, stable=True)
    ar = torch.arange(key.shape[-1], device=key.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar)


# ---------------------------------------------------------------------------
# priors / anchors
# ---------------------------------------------------------------------------

def _expand_aspect_ratios(aspect_ratios, flip):
    """reference prior_box_op.h ExpandAspectRatios: dedup, keep 1.0
    first, add flipped ratios."""
    out = [1.0]
    for ar in aspect_ratios:
        if any(abs(ar - o) < 1e-6 for o in out):
            continue
        out.append(float(ar))
        if flip:
            out.append(1.0 / float(ar))
    return out


def _centres(n, offset, step, device):
    return (torch.arange(n, device=device) + offset) * step


def _grid_boxes(feat_h, feat_w, wh, offset, step_w, step_h, device):
    """(cx, cy, half_w, half_h) of every prior at every cell, each
    broadcast to [H, W, P]."""
    P = wh.shape[0]
    cx = _centres(feat_w, offset, step_w, device)[None, :, None].expand(
        feat_h, feat_w, P)
    cy = _centres(feat_h, offset, step_h, device)[:, None, None].expand(
        feat_h, feat_w, P)
    return cx, cy, wh[None, None, :, 0] / 2.0, wh[None, None, :, 1] / 2.0


@register_op("prior_box", propagate_seqlen=False)
def _prior_box(ctx, Input, Image):
    """SSD priors over a feature map (reference prior_box_op.h:57):
    Boxes / Variances [H, W, num_priors, 4] in normalized ltrb. Per
    min_size all aspect ratios (1 first) then the sqrt(min * max)
    square, or with `min_max_aspect_ratios_order` min, the square, then
    the other ratios."""
    min_sizes = [float(s) for s in ctx.attr("min_sizes")]
    max_sizes = [float(s) for s in ctx.attr("max_sizes", []) or []]
    flip = ctx.attr("flip", False)
    ars = _expand_aspect_ratios(ctx.attr("aspect_ratios", [1.0]), flip)
    variances = [float(v) for v in ctx.attr("variances",
                                            [0.1, 0.1, 0.2, 0.2])]
    offset = ctx.attr("offset", 0.5)
    img_h, img_w = Image.shape[2], Image.shape[3]
    feat_h, feat_w = Input.shape[2], Input.shape[3]
    step_w = ctx.attr("step_w", 0.0) or img_w / feat_w
    step_h = ctx.attr("step_h", 0.0) or img_h / feat_h
    mm_order = ctx.attr("min_max_aspect_ratios_order", False)
    wh = []
    for s, mins in enumerate(min_sizes):
        square = ([(math.sqrt(mins * max_sizes[s]),) * 2] if max_sizes
                  else [])
        ratios = [(mins * math.sqrt(ar), mins / math.sqrt(ar))
                  for ar in ars if not (mm_order and abs(ar - 1.0) < 1e-6)]
        wh += ([(mins, mins)] + square + ratios if mm_order
               else ratios + square)
    dev = Input.device
    wh = torch.tensor(wh, dtype=torch.float32, device=dev)
    cx, cy, half_w, half_h = _grid_boxes(feat_h, feat_w, wh, offset, step_w,
                                         step_h, dev)
    # XLA's jitted step multiplies by a constant divisor's float32
    # reciprocal; so does this rule, for the same bits
    rw, rh = 1.0 / img_w, 1.0 / img_h
    boxes = torch.stack([(cx - half_w) * rw, (cy - half_h) * rh,
                         (cx + half_w) * rw, (cy + half_h) * rh], -1)
    if ctx.attr("clip", False):
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.tensor(variances, dtype=torch.float32,
                       device=dev).expand_as(boxes)
    return {"Boxes": boxes, "Variances": var}


@register_op("anchor_generator", propagate_seqlen=False)
def _anchor_generator(ctx, Input):
    """RPN anchors in absolute pixels (reference anchor_generator_op.h):
    Anchors / Variances [H, W, num_anchors, 4]."""
    sizes = [float(s) for s in ctx.attr("anchor_sizes", [64.0, 128.0,
                                                         256.0])]
    ratios = [float(r) for r in ctx.attr("aspect_ratios", [0.5, 1.0, 2.0])]
    stride = [float(s) for s in ctx.attr("stride", [16.0, 16.0])]
    variances = [float(v) for v in ctx.attr("variances",
                                            [0.1, 0.1, 0.2, 0.2])]
    feat_h, feat_w = Input.shape[2], Input.shape[3]
    wh = []
    for r in ratios:
        for s in sizes:
            w = math.sqrt(s * s / r)
            wh.append((w, w * r))
    dev = Input.device
    wh = torch.tensor(wh, dtype=torch.float32, device=dev)
    cx, cy, half_w, half_h = _grid_boxes(
        feat_h, feat_w, wh, ctx.attr("offset", 0.5), stride[0], stride[1],
        dev)
    anchors = torch.stack([cx - half_w, cy - half_h, cx + half_w,
                           cy + half_h], -1)
    var = torch.tensor(variances, dtype=torch.float32,
                       device=dev).expand_as(anchors)
    return {"Anchors": anchors, "Variances": var}


# ---------------------------------------------------------------------------
# IoU / coding / matching
# ---------------------------------------------------------------------------

def _iou_matrix(x, y, normalized=True):
    """[..., N, 4] x [..., M, 4] -> [..., N, M] (reference
    iou_similarity_op.h), elementwise as the JAX rule computes it."""
    off = 0.0 if normalized else 1.0
    area_x = (x[..., 2] - x[..., 0] + off) * (x[..., 3] - x[..., 1] + off)
    area_y = (y[..., 2] - y[..., 0] + off) * (y[..., 3] - y[..., 1] + off)
    lt = torch.maximum(x[..., :, None, :2], y[..., None, :, :2])
    rb = torch.minimum(x[..., :, None, 2:], y[..., None, :, 2:])
    wh = torch.maximum(rb - lt + off, x.new_zeros(()))
    inter = wh[..., 0] * wh[..., 1]
    union = area_x[..., :, None] + area_y[..., None, :] - inter
    return torch.where(union > 0, inter / union, x.new_zeros(()))


@register_op("iou_similarity", propagate_seqlen=False)
def _iou_similarity(ctx, X, Y):
    if X.ndim == 3 and Y.ndim == 2:     # batched X against shared Y
        Y = Y.expand((X.shape[0],) + tuple(Y.shape))
    return {"Out": _iou_matrix(X, Y)}


# zero-size (padded) boxes must not produce -inf deltas
_ENC_EPS = 1e-9


def _center_size(boxes, off):
    """ltrb [..., 4] -> (cx, cy, w, h)."""
    w = boxes[..., 2] - boxes[..., 0] + off
    h = boxes[..., 3] - boxes[..., 1] + off
    cx = (boxes[..., 2] + boxes[..., 0]) / 2
    cy = (boxes[..., 3] + boxes[..., 1]) / 2
    return cx, cy, w, h


def _encode_deltas(tcx, tcy, tw, th, pcx, pcy, pw, ph, v):
    """Center-size encode (reference box_coder_op.h EncodeCenterSize),
    with the JAX rule's eps-guarded log."""
    eps = tw.new_full((), _ENC_EPS)
    dx = (tcx - pcx) / pw / v[..., 0]
    dy = (tcy - pcy) / ph / v[..., 1]
    dw = torch.log(torch.maximum(jax_abs(tw / pw), eps)) / v[..., 2]
    dh = torch.log(torch.maximum(jax_abs(th / ph), eps)) / v[..., 3]
    return torch.stack([dx, dy, dw, dh], -1)


@register_op("box_coder", propagate_seqlen=False)
def _box_coder(ctx, PriorBox, TargetBox, PriorBoxVar=None):
    """Center-size encode / decode (reference box_coder_op.h:40). encode:
    TargetBox [N, 4] against PriorBox [M, 4] -> [N, M, 4] deltas; decode:
    TargetBox [N, M, 4] deltas -> [N, M, 4] boxes."""
    code_type = ctx.attr("code_type", "encode_center_size")
    off = 0.0 if ctx.attr("box_normalized", True) else 1.0
    pcx, pcy, pw, ph = _center_size(PriorBox, off)
    v = PriorBoxVar if PriorBoxVar is not None else torch.ones_like(PriorBox)
    if code_type.startswith("encode"):
        tcx, tcy, tw, th = _center_size(TargetBox, off)
        return {"OutputBox": _encode_deltas(
            tcx[:, None], tcy[:, None], tw[:, None], th[:, None],
            pcx[None, :], pcy[None, :], pw[None, :], ph[None, :],
            v[None, :])}
    d = TargetBox
    cx = v[None, :, 0] * d[..., 0] * pw[None, :] + pcx[None, :]
    cy = v[None, :, 1] * d[..., 1] * ph[None, :] + pcy[None, :]
    w = torch.exp(v[None, :, 2] * d[..., 2]) * pw[None, :]
    h = torch.exp(v[None, :, 3] * d[..., 3]) * ph[None, :]
    return {"OutputBox": torch.stack([cx - w / 2, cy - h / 2,
                                      cx + w / 2 - off, cy + h / 2 - off],
                                     -1)}


def _bipartite_match(dist, threshold, match_type):
    """dist [B, N, M] (rows the ground truth, columns the priors): the
    greedy global-max matching (reference bipartite_match_op.cc
    BipartiteMatch), min(N, M) steps each over the whole batch, then,
    for `per_prediction`, each unmatched column whose best row reaches
    `threshold` takes that row."""
    B, N, M = dist.shape
    dev = dist.device
    row_used = torch.zeros((B, N), dtype=torch.bool, device=dev)
    col_to_row = torch.full((B, M), -1, dtype=torch.long, device=dev)
    col_dist = torch.zeros((B, M), dtype=dist.dtype, device=dev)
    rows = torch.arange(N, device=dev)
    cols = torch.arange(M, device=dev)
    unmatched = dist.new_full((), -1.0)
    for _ in range(min(N, M) if dev.type != "meta" else 0):
        free = (~row_used)[:, :, None] & (col_to_row < 0)[:, None, :]
        masked = torch.where(free, dist, unmatched).reshape(B, N * M)
        flat = torch.argmax(masked, dim=1)
        best = torch.gather(masked, 1, flat[:, None])[:, 0]
        i, j = torch.div(flat, M, rounding_mode="floor"), flat % M
        take = (best > 0)[:, None]
        row_used = row_used | ((rows[None, :] == i[:, None]) & take)
        hit = (cols[None, :] == j[:, None]) & take
        col_to_row = torch.where(hit, i[:, None], col_to_row)
        col_dist = torch.where(hit, best[:, None], col_dist)
    if match_type == "per_prediction":
        best_row = torch.argmax(dist, dim=1)
        best_val = dist.amax(dim=1)
        fill = (col_to_row < 0) & (best_val >= _scalar(best_val, threshold))
        col_to_row = torch.where(fill, best_row, col_to_row)
        col_dist = torch.where(fill, best_val, col_dist)
    return col_to_row, col_dist


@register_op("bipartite_match", propagate_seqlen=False)
def _bipartite_match_op(ctx, DistMat):
    dist = DistMat if DistMat.ndim == 3 else DistMat[None]
    idx, d = _bipartite_match(dist, ctx.attr("dist_threshold", 0.5),
                              ctx.attr("match_type", "bipartite"))
    if DistMat.ndim == 2:
        idx, d = idx[0], d[0]
    return {"ColToRowMatchIndices": idx, "ColToRowMatchDist": d}


@register_op("target_assign", propagate_seqlen=False)
def _target_assign(ctx, X, MatchIndices, NegMask=None):
    """Gather per-prior targets by match index (reference
    target_assign_op.h): X [B, N, K] per ground-truth values,
    MatchIndices [B, M] (-1: unmatched, which takes mismatch_value);
    NegMask [B, M] forces an entry to mismatch_value too."""
    mismatch = ctx.attr("mismatch_value", 0.0)
    B = X.shape[0]
    bidx = torch.arange(B, device=X.device)[:, None]
    out = X[bidx, MatchIndices.long().clamp_min(0)]
    matched = MatchIndices >= 0
    if NegMask is not None:
        matched = matched & (NegMask == 0)
    out = torch.where(matched[..., None], out,
                      torch.tensor(mismatch, device=X.device).to(out.dtype))
    return {"Out": out, "OutWeight": matched.to(X.dtype)[..., None]}


# ---------------------------------------------------------------------------
# NMS / mining / misc
# ---------------------------------------------------------------------------

def _nms_keep(iou, valid, nms_threshold, eta):
    """The JAX rule's NMSFast on each (image, class) row of sorted boxes:
    iou [B, C, k, k], valid [B, C, k] -> keep [B, C, k] (module
    docstring: a Jacobi iteration at eta 1, the steps in order below)."""
    B, C, k = valid.shape
    if eta >= 1.0:
        earlier = torch.ones((k, k), dtype=torch.bool,
                             device=iou.device).tril(-1)
        over = (iou > _scalar(iou, nms_threshold)) & earlier
        keep = valid
        for _ in range(k):
            nxt = valid & ~(over & keep[:, :, None, :]).any(-1)
            if torch.equal(nxt, keep):
                break
            keep = nxt
        return keep
    keep = torch.zeros_like(valid)
    th = iou.new_full((B, C), nms_threshold)
    eta_t = _scalar(th, eta)
    for i in range(k):
        sup = (keep[..., :i] & (iou[..., i, :i] > th[..., None])).any(-1)
        ki = valid[..., i] & ~sup
        th = torch.where(ki & (th > 0.5), th * eta_t, th)
        keep[..., i] = ki
    return keep


@register_op("multiclass_nms", propagate_seqlen=False)
def _multiclass_nms(ctx, BBoxes, Scores):
    """BBoxes [B, M, 4], Scores [B, C, M] -> Out [B, keep_top_k, 6]
    (label, score, ltrb) padded with label -1, and Count [B] (reference
    multiclass_nms_op.cc emits a LoD tensor). Per class the boxes are
    sorted by score, suppressed by IoU, and the kept scores of all
    classes (the rest -1) ranked by `lax.top_k`'s order; a padded row
    takes its box from that order among the -1 scores, as in the JAX
    rule."""
    score_threshold = ctx.attr("score_threshold", 0.01)
    nms_top_k = int(ctx.attr("nms_top_k", 400))
    keep_top_k = int(ctx.attr("keep_top_k", 200))
    nms_threshold = ctx.attr("nms_threshold", 0.3)
    eta = ctx.attr("nms_eta", 1.0)
    background = int(ctx.attr("background_label", 0))
    normalized = ctx.attr("normalized", True)
    B, C, M = Scores.shape
    dev = Scores.device
    if keep_top_k <= 0:
        keep_top_k = C * M
    classes = [c for c in range(C) if c != background]
    if dev.type == "meta":
        return {"Out": Scores.new_empty((B, keep_top_k, 6)),
                "Count": Scores.new_empty((B,), dtype=torch.int64)}
    k = min(nms_top_k, M) if nms_top_k > 0 else M
    sc = Scores[:, classes]                                  # [B, Cn, M]
    order = torch.argsort(-sc, dim=-1, stable=True)[..., :k]
    ss = torch.gather(sc, -1, order)
    bidx = torch.arange(B, device=dev)[:, None, None]
    boxes = BBoxes[bidx, order]                              # [B, Cn, k, 4]
    iou = _iou_matrix(boxes, boxes, normalized=normalized)
    keep = _nms_keep(iou, ss > _scalar(ss, score_threshold), nms_threshold,
                     eta)
    kept = torch.zeros_like(sc, dtype=torch.bool).scatter_(-1, order, keep)
    s = torch.where(kept, sc, sc.new_full((), -1.0)).reshape(B, -1)
    labels = torch.tensor(classes, dtype=torch.float32,
                          device=dev).repeat_interleave(M)
    kk = min(keep_top_k, s.shape[1])
    top_i = torch.argsort(-s, dim=1, stable=True)[:, :kk]
    top_s = torch.gather(s, 1, top_i)
    top_l = torch.where(top_s > -1.0, labels[top_i], top_s.new_full((), -1.0))
    top_b = BBoxes[torch.arange(B, device=dev)[:, None], top_i % M]
    out = torch.cat([top_l[..., None], top_s[..., None], top_b], -1)
    if kk < keep_top_k:
        out = torch.cat([out, out.new_full((B, keep_top_k - kk, 6), -1.0)],
                        1)
    return {"Out": out, "Count": (top_s > -1.0).sum(dim=1)}


@register_op("mine_hard_examples", propagate_seqlen=False)
def _mine_hard_examples(ctx, ClsLoss, MatchIndices, LocLoss=None,
                        MatchDist=None):
    """Hard-negative mining (reference mine_hard_examples_op.cc,
    max_negative mode): among unmatched priors whose best overlap lies
    below neg_dist_threshold, the neg_pos_ratio * num_pos highest-loss
    ones of each image. NegMask [B, M] int32 (the reference's
    variable-length NegIndices as a mask) and UpdatedMatchIndices."""
    neg_pos_ratio = ctx.attr("neg_pos_ratio", 3.0)
    neg_overlap = ctx.attr("neg_dist_threshold", 0.5)
    loss = ClsLoss if LocLoss is None else ClsLoss + LocLoss
    if MatchDist is None:
        MatchDist = torch.zeros_like(loss)
    pos = MatchIndices >= 0
    candidate = ~pos & (MatchDist < _scalar(MatchDist, neg_overlap))
    num_neg = torch.minimum((neg_pos_ratio * pos.sum(dim=1)).long(),
                            candidate.sum(dim=1))
    neg_loss = torch.where(candidate, loss, loss.new_full((), -math.inf))
    rank = _stable_rank(-neg_loss)
    neg_mask = candidate & (rank < num_neg[:, None])
    return {"NegMask": neg_mask.int(), "UpdatedMatchIndices": MatchIndices}


@register_op("polygon_box_transform", propagate_seqlen=False)
def _polygon_box_transform(ctx, Input):
    """reference polygon_box_transform_op.cc:44-46: even channels give
    id_w - in, odd channels id_h - in."""
    B, C, H, W = Input.shape
    xg = torch.arange(W, dtype=Input.dtype, device=Input.device)[
        None, :].expand(H, W)
    yg = torch.arange(H, dtype=Input.dtype, device=Input.device)[
        :, None].expand(H, W)
    grid = torch.stack([xg, yg] * (C // 2), 0)
    return {"Output": grid[None] - Input}


# ---------------------------------------------------------------------------
# ssd_loss building blocks
# ---------------------------------------------------------------------------

@register_op("box_encode_per_prior", propagate_seqlen=False)
def _box_encode_per_prior(ctx, TargetBox, PriorBox, PriorBoxVar=None):
    """Per-prior center-size encoding: TargetBox [B, M, 4] already
    gathered onto the priors, PriorBox [M, 4] -> deltas [B, M, 4]."""
    off = 0.0 if ctx.attr("box_normalized", True) else 1.0
    pcx, pcy, pw, ph = _center_size(PriorBox, off)
    v = PriorBoxVar if PriorBoxVar is not None else torch.ones_like(PriorBox)
    tcx, tcy, tw, th = _center_size(TargetBox, off)
    return {"OutputBox": _encode_deltas(tcx, tcy, tw, th, pcx[None],
                                        pcy[None], pw[None], ph[None],
                                        v[None])}


@register_op("greater_equal_scalar0", propagate_seqlen=False)
def _greater_equal_scalar0(ctx, X):
    return {"Out": (X >= 0).float()}


@register_op("smooth_l1_elementwise", propagate_seqlen=False)
def _smooth_l1_elementwise(ctx, X):
    """Elementwise Huber on |x| (reference smooth_l1 kernel body)."""
    sigma2 = ctx.attr("sigma", 1.0) ** 2
    a = jax_abs(X)
    return {"Out": torch.where(a < 1.0 / sigma2, 0.5 * sigma2 * a * a,
                               a - 0.5 / sigma2)}


@register_op("softmax_ce_no_reduce", propagate_seqlen=False)
def _softmax_ce_no_reduce(ctx, Logits, Label):
    """Per-position CE: Logits [B, M, C], Label [B, M, 1] -> [B, M]."""
    logp = jax_log_softmax(Logits.float())
    ids = Label.reshape(Label.shape[0], Label.shape[1]).long()
    ce = -torch.gather(logp, -1, ids[..., None])[..., 0]
    return {"Out": ce.to(Logits.dtype)}


@register_op("rpn_target_assign", propagate_seqlen=False)
def _rpn_target_assign(ctx, Anchor, GtBox, DistMat):
    """RPN anchor labeling (reference rpn_target_assign_op.cc) with the
    JAX package's deterministic subsample: the highest-IoU positives and
    the lowest-IoU negatives. Labels [B, M] int32 (1 positive, 0
    negative, -1 ignored) and MatchIndices [B, M] int64."""
    pos_th = ctx.attr("rpn_positive_overlap", 0.7)
    neg_th = ctx.attr("rpn_negative_overlap", 0.3)
    batch_size = int(ctx.attr("rpn_batch_size_per_im", 256))
    num_fg = int(batch_size * ctx.attr("rpn_fg_fraction", 0.5))
    dist = DistMat if DistMat.ndim == 3 else DistMat[None]
    B, N, M = dist.shape
    best_gt = torch.argmax(dist, dim=1)                      # [B, M]
    best_iou = dist.amax(dim=1)
    # the anchor of largest IoU for each ground truth is positive too
    forced = torch.zeros((B, M), dtype=torch.bool, device=dist.device)
    forced = forced.scatter(1, torch.argmax(dist, dim=2), True)
    pos = (best_iou >= _scalar(best_iou, pos_th)) | forced
    neg = (best_iou < _scalar(best_iou, neg_th)) & ~pos
    inf = best_iou.new_full((), math.inf)
    pos = pos & (_stable_rank(-torch.where(pos, best_iou, -inf)) < num_fg)
    n_neg = batch_size - torch.clamp_max(pos.sum(dim=1), num_fg)
    neg = neg & (_stable_rank(torch.where(neg, best_iou, inf))
                 < n_neg[:, None])
    labels = torch.where(pos, 1, torch.where(neg, 0, -1)).int()
    match = torch.where(pos, best_gt, -1)
    if DistMat.ndim == 2:
        labels, match = labels[0], match[0]
    return {"Labels": labels, "MatchIndices": match}


def _map_iou(box, boxes):
    """The JAX `detection_map`'s IoU of box [B, 4] against boxes
    [B, G, 4]: unnormalized widths, areas clamped at 0, the union at
    1e-10."""
    zero = box.new_zeros(())
    ix1 = torch.maximum(box[:, None, 0], boxes[..., 0])
    iy1 = torch.maximum(box[:, None, 1], boxes[..., 1])
    ix2 = torch.minimum(box[:, None, 2], boxes[..., 2])
    iy2 = torch.minimum(box[:, None, 3], boxes[..., 3])
    inter = torch.maximum(ix2 - ix1, zero) * torch.maximum(iy2 - iy1, zero)
    a1 = (torch.maximum(box[:, 2] - box[:, 0], zero)
          * torch.maximum(box[:, 3] - box[:, 1], zero))[:, None]
    a2 = (torch.maximum(boxes[..., 2] - boxes[..., 0], zero)
          * torch.maximum(boxes[..., 3] - boxes[..., 1], zero))
    return inter / torch.maximum(a1 + a2 - inter, box.new_full((), 1e-10))


@register_op("detection_map", propagate_seqlen=False)
def _detection_map(ctx, DetectRes, Label):
    """Batch mean average precision (reference detection_map_op.h).
    DetectRes [B, D, 6] rows (label, score, x1, y1, x2, y2) padded with
    label -1 (the `multiclass_nms` layout); Label [B, G, 6] rows (label,
    difficult, x1, y1, x2, y2) padded with label -1. Greedy VOC matching
    in score order, each ground-truth box claimed once; `ap_version`
    `integral` or `11point` (module docstring)."""
    class_num = int(ctx.attr("class_num"))
    background = int(ctx.attr("background_label", 0))
    thr = float(ctx.attr("overlap_threshold", 0.5))
    skip_difficult = not bool(ctx.attr("evaluate_difficult", True))
    ap_version = ctx.attr("ap_version", "integral")
    dev = DetectRes.device
    if dev.type == "meta":
        return {"MAP": DetectRes.new_empty((1,))}
    B, D, _ = DetectRes.shape
    det_label, det_score = DetectRes[:, :, 0], DetectRes[:, :, 1]
    det_box = DetectRes[:, :, 2:6]
    gt_label = Label[:, :, 0]
    gt_difficult = Label[:, :, 1] > 0.5
    gt_box = Label[:, :, 2:6]
    gt_valid = gt_label >= 0
    valid = det_label >= 0
    key = torch.where(valid, -det_score, det_score.new_full((), math.inf))
    order = torch.argsort(key, dim=1, stable=True)           # per image
    pos = torch.empty_like(order).scatter_(
        1, order, torch.arange(D, device=dev).expand(B, D))
    # every detection's best ground truth of its label (first among
    # ties) and whether it reaches the threshold: none depends on the
    # scan's state
    same = (gt_label[:, None, :] == det_label[:, :, None]) & gt_valid[:, None]
    ious = torch.where(same, _map_iou(det_box.reshape(B * D, 4),
                                      gt_box.repeat_interleave(D, 0))
                       .reshape(B, D, -1), gt_box.new_full((), -1.0))
    best = torch.argmax(ious, dim=2)                         # [B, D]
    hit = torch.gather(ious, 2, best[..., None])[..., 0] \
        >= _scalar(ious, thr)
    diff = torch.gather(gt_difficult, 1, best) & skip_difficult
    # the scan's state, the matched mask, only decides which candidate
    # claims a ground truth: the first in score order among those that
    # hit it; every later one is a false positive
    cand = valid & hit & ~diff
    claim = torch.where(cand, pos, D)
    G = gt_label.shape[1]
    first = torch.full((B, G), D, dtype=pos.dtype, device=dev).scatter_reduce(
        1, best, claim, reduce="amin")
    tp_img = cand & (pos == torch.gather(first, 1, best))
    fp_img = valid & ~(hit & diff) & ~tp_img
    glob = torch.argsort(key.reshape(-1), stable=True)
    tp, fp = tp_img.reshape(-1)[glob], fp_img.reshape(-1)[glob]
    det_label = det_label.reshape(-1)[glob]

    classes = torch.arange(class_num, device=dev)
    countable = gt_valid & ~(gt_difficult & skip_difficult)
    npos = ((gt_label[None] == classes[:, None, None])
            & countable[None]).sum(dim=(1, 2)).float()
    cls_mask = det_label[None, :] == classes[:, None]          # [C, N]
    tp_m = tp[None, :] & cls_mask
    tp_c = torch.cumsum(tp_m.int(), dim=1).float()
    fp_c = torch.cumsum((fp[None, :] & cls_mask).int(), dim=1).float()
    prec = tp_c / torch.clamp_min(tp_c + fp_c, 1e-10)
    n_safe = torch.clamp_min(npos, 1.0)[:, None]
    if ap_version == "11point":
        recall = tp_c / n_safe
        ts = torch.arange(11, dtype=torch.float32, device=dev) * 0.1
        at_t = torch.where((recall[:, None, :] >= ts[None, :, None])
                           & cls_mask[:, None, :], prec[:, None, :],
                           prec.new_zeros(())).amax(dim=2)
        ap = at_t.sum(dim=1) * (1.0 / 11)
    else:
        ap = torch.sum(prec * tp_m, dim=1) / n_safe[:, 0]
    has_pos = (npos > 0) & (classes != background)
    m = torch.sum(torch.where(has_pos, ap, ap.new_zeros(()))) / \
        torch.clamp_min(has_pos.float().sum(), 1.0)
    return {"MAP": m.reshape(1)}
