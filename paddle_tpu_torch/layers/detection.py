"""Detection layers (mirror of ``paddle_tpu/layers/detection.py``;
reference python/paddle/fluid/layers/detection.py: prior_box,
multi_box_head, bipartite_match, target_assign, ssd_loss,
detection_output, box_coder, iou_similarity, anchor_generator,
polygon_box_transform, detection_map). The programs they build are the
JAX package's, op for op and name for name, but for the index outputs,
int64 in the port (match indices and `multiclass_nms`'s `Count`).
``ops/detection.py`` documents the static, padded layouts (masks and
counts instead of LoD outputs)."""

from __future__ import annotations

from ..layer_helper import LayerHelper
from ..ops.detection import _expand_aspect_ratios
from . import nn as _nn
from . import tensor as _t


def _op(helper, type, inputs, out_slots, attrs=None, dtypes=None):
    outs = {}
    vars_ = []
    for i, slot in enumerate(out_slots):
        dt = (dtypes or {}).get(slot, "float32")
        v = helper.create_variable_for_type_inference(dtype=dt)
        outs[slot] = [v.name]
        vars_.append(v)
    helper.append_op(type, inputs=inputs, outputs=outs, attrs=attrs or {})
    return vars_


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None,
              min_max_aspect_ratios_order=False):
    helper = LayerHelper("prior_box", name=name)
    boxes, var = _op(helper, "prior_box",
                     {"Input": [input.name], "Image": [image.name]},
                     ("Boxes", "Variances"),
                     {"min_sizes": list(min_sizes),
                      "max_sizes": list(max_sizes or []),
                      "aspect_ratios": list(aspect_ratios),
                      "variances": list(variance), "flip": flip,
                      "clip": clip, "step_w": steps[0], "step_h": steps[1],
                      "offset": offset,
                      "min_max_aspect_ratios_order":
                          min_max_aspect_ratios_order})
    return boxes, var


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=(0.1, 0.1, 0.2, 0.2), stride=None, offset=0.5,
                     name=None):
    helper = LayerHelper("anchor_generator", name=name)
    anchors, var = _op(helper, "anchor_generator", {"Input": [input.name]},
                       ("Anchors", "Variances"),
                       {"anchor_sizes": list(anchor_sizes or [64, 128, 256]),
                        "aspect_ratios": list(aspect_ratios or [0.5, 1, 2]),
                        "variances": list(variance),
                        "stride": list(stride or [16.0, 16.0]),
                        "offset": offset})
    return anchors, var


def iou_similarity(x, y, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    out, = _op(helper, "iou_similarity", {"X": [x.name], "Y": [y.name]},
               ("Out",))
    return out


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None):
    helper = LayerHelper("box_coder", name=name)
    inputs = {"PriorBox": [prior_box.name], "TargetBox": [target_box.name]}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var.name]
    out, = _op(helper, "box_coder", inputs, ("OutputBox",),
               {"code_type": code_type, "box_normalized": box_normalized})
    return out


def bipartite_match(dist_matrix, match_type="bipartite",
                    dist_threshold=0.5, name=None):
    helper = LayerHelper("bipartite_match", name=name)
    idx, dist = _op(helper, "bipartite_match",
                    {"DistMat": [dist_matrix.name]},
                    ("ColToRowMatchIndices", "ColToRowMatchDist"),
                    {"match_type": match_type,
                     "dist_threshold": dist_threshold},
                    dtypes={"ColToRowMatchIndices": "int64"})
    return idx, dist


def target_assign(input, matched_indices, negative_mask=None,
                  mismatch_value=0.0, name=None):
    helper = LayerHelper("target_assign", name=name)
    inputs = {"X": [input.name], "MatchIndices": [matched_indices.name]}
    if negative_mask is not None:
        inputs["NegMask"] = [negative_mask.name]
    out, weight = _op(helper, "target_assign", inputs,
                      ("Out", "OutWeight"),
                      {"mismatch_value": float(mismatch_value)})
    return out, weight


def multiclass_nms(bboxes, scores, score_threshold=0.01, nms_top_k=400,
                   keep_top_k=200, nms_threshold=0.3, background_label=0,
                   nms_eta=1.0, normalized=True, name=None):
    """Static-shape NMS: Out [B, keep_top_k, 6] padded with label=-1 plus
    Count [B] int64 (reference emits LoD; see ops/detection.py)."""
    helper = LayerHelper("multiclass_nms", name=name)
    out, count = _op(helper, "multiclass_nms",
                     {"BBoxes": [bboxes.name], "Scores": [scores.name]},
                     ("Out", "Count"),
                     {"score_threshold": score_threshold,
                      "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
                      "nms_threshold": nms_threshold,
                      "background_label": background_label,
                      "nms_eta": nms_eta, "normalized": normalized},
                     dtypes={"Count": "int64"})
    return out, count


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0,
                     name=None):
    """Decode predicted deltas against priors, then NMS (reference
    detection.py detection_output = box_coder(decode_center_size) +
    multiclass_nms). loc [B,M,4], scores [B,M,C] (softmax-ed here, as the
    reference does), priors [M,4]."""
    from .. import layers as _layers
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    probs = _layers.transpose(_nn.softmax(scores), perm=[0, 2, 1])
    return multiclass_nms(decoded, probs,
                          score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold,
                          background_label=background_label,
                          nms_eta=nms_eta, name=name)


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD prediction head (reference detection.py multi_box_head): per
    feature map, a prior_box + 3x3 convs for location and confidence;
    outputs concatenated over maps. Returns (mbox_locs [B,M,4],
    mbox_confs [B,M,C], boxes [M,4], variances [M,4])."""
    from .. import layers as _layers

    n = len(inputs)
    if not min_sizes:
        # the reference's ratio schedule (detection.py multi_box_head):
        # sizes evenly spaced in [min_ratio, max_ratio]% of base_size,
        # with a fixed 10%/20% pair prepended for the first map
        if n <= 2 or min_ratio is None or max_ratio is None:
            raise ValueError("multi_box_head: give min_sizes or "
                             "min_ratio/max_ratio with >2 inputs")
        min_sizes, max_sizes = [], []
        step = int((max_ratio - min_ratio) / (n - 2))
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.10] + min_sizes
        max_sizes = [base_size * 0.20] + max_sizes

    locs, confs, boxes_l, vars_l = [], [], [], []
    for i, feat in enumerate(inputs):
        mins = min_sizes[i]
        maxs = max_sizes[i] if max_sizes else None
        mins_list = list(mins) if isinstance(mins, (list, tuple)) else [mins]
        if maxs is not None:
            maxs_list = (list(maxs) if isinstance(maxs, (list, tuple))
                         else [maxs])
            # prior_box pairs max_sizes[s] with min_sizes[s]; a length
            # mismatch would mis-split the loc/conf conv channels
            if len(maxs_list) != len(mins_list):
                raise ValueError(
                    "multi_box_head: layer %d supplies %d min_sizes but %d "
                    "max_sizes; they must pair one-to-one"
                    % (i, len(mins_list), len(maxs_list)))
        else:
            maxs_list = None
        ars = aspect_ratios[i] if isinstance(aspect_ratios[i], (list, tuple)) \
            else [aspect_ratios[i]]
        st = steps[i] if steps else [
            step_w[i] if step_w else 0.0, step_h[i] if step_h else 0.0]
        box, var = prior_box(
            feat, image, mins_list, maxs_list,
            ars, variance, flip, clip,
            st if isinstance(st, (list, tuple)) else [st, st], offset,
            min_max_aspect_ratios_order=min_max_aspect_ratios_order)
        # must match the prior_box op's count exactly for the conv channel
        # split to line up: the port's op's own expansion
        expanded = _expand_aspect_ratios(ars, flip)
        num_priors = (len(expanded) + (1 if maxs_list else 0)) * len(mins_list)
        loc = _nn.conv2d(input=feat, num_filters=num_priors * 4,
                         filter_size=kernel_size, padding=pad, stride=stride)
        loc = _layers.transpose(loc, perm=[0, 2, 3, 1])
        loc = _layers.reshape(loc, shape=[0, -1, 4])
        locs.append(loc)
        conf = _nn.conv2d(input=feat, num_filters=num_priors * num_classes,
                          filter_size=kernel_size, padding=pad, stride=stride)
        conf = _layers.transpose(conf, perm=[0, 2, 3, 1])
        conf = _layers.reshape(conf, shape=[0, -1, num_classes])
        confs.append(conf)
        boxes_l.append(_layers.reshape(box, shape=[-1, 4]))
        vars_l.append(_layers.reshape(var, shape=[-1, 4]))

    mbox_locs = _t.concat(locs, axis=1)
    mbox_confs = _t.concat(confs, axis=1)
    boxes = _t.concat(boxes_l, axis=0)
    variances = _t.concat(vars_l, axis=0)
    return mbox_locs, mbox_confs, boxes, variances


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.5, evaluate_difficult=True,
                  ap_version="integral", name=None):
    """Per-batch mean average precision (reference detection_map_op.cc).
    detect_res [B,D,6] (label, score, x1,y1,x2,y2; label=-1 padding, the
    multiclass_nms output layout), label [B,G,6] ground truth
    (label, difficult, x1,y1,x2,y2) padded with label=-1."""
    helper = LayerHelper("detection_map", name=name)
    out, = _op(helper, "detection_map",
               {"DetectRes": [detect_res.name], "Label": [label.name]},
               ("MAP",),
               {"class_num": class_num, "background_label": background_label,
                "overlap_threshold": overlap_threshold,
                "evaluate_difficult": evaluate_difficult,
                "ap_version": ap_version})
    return out


def polygon_box_transform(input, name=None):
    helper = LayerHelper("polygon_box_transform", name=name)
    out, = _op(helper, "polygon_box_transform", {"Input": [input.name]},
               ("Output",))
    return out


def mine_hard_examples(cls_loss, match_indices, loc_loss=None,
                       match_dist=None, neg_pos_ratio=3.0,
                       neg_dist_threshold=0.5, name=None):
    helper = LayerHelper("mine_hard_examples", name=name)
    inputs = {"ClsLoss": [cls_loss.name],
              "MatchIndices": [match_indices.name]}
    if loc_loss is not None:
        inputs["LocLoss"] = [loc_loss.name]
    if match_dist is not None:
        inputs["MatchDist"] = [match_dist.name]
    neg, upd = _op(helper, "mine_hard_examples", inputs,
                   ("NegMask", "UpdatedMatchIndices"),
                   {"neg_pos_ratio": neg_pos_ratio,
                    "neg_dist_threshold": neg_dist_threshold},
                   dtypes={"NegMask": "int32",
                           "UpdatedMatchIndices": "int64"})
    return neg, upd


def rpn_target_assign(anchor_box, gt_box, dist_matrix,
                      rpn_batch_size_per_im=256, rpn_fg_fraction=0.5,
                      rpn_positive_overlap=0.7, rpn_negative_overlap=0.3,
                      name=None):
    helper = LayerHelper("rpn_target_assign", name=name)
    labels, match = _op(helper, "rpn_target_assign",
                        {"Anchor": [anchor_box.name],
                         "GtBox": [gt_box.name],
                         "DistMat": [dist_matrix.name]},
                        ("Labels", "MatchIndices"),
                        {"rpn_batch_size_per_im": rpn_batch_size_per_im,
                         "rpn_fg_fraction": rpn_fg_fraction,
                         "rpn_positive_overlap": rpn_positive_overlap,
                         "rpn_negative_overlap": rpn_negative_overlap},
                        dtypes={"Labels": "int32", "MatchIndices": "int64"})
    return labels, match


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, loc_loss_weight=1.0, conf_loss_weight=1.0,
             mismatch_value=0.0, name=None):
    """SSD multibox loss (reference detection.py ssd_loss): match priors to
    gt (bipartite + per_prediction), mine hard negatives, localization
    smooth-L1 on matched priors + confidence cross-entropy on matched and
    mined-negative priors. gt_box [B, N, 4], gt_label [B, N, 1] (padded
    rows get label 0 = background), location [B, M, 4] deltas,
    confidence [B, M, C], prior_box [M, 4]."""
    from . import ops as lops

    helper = LayerHelper("ssd_loss", name=name)
    iou = iou_similarity(gt_box, prior_box)               # [B, N, M]
    match_idx, match_dist = bipartite_match(
        iou, match_type="per_prediction",
        dist_threshold=overlap_threshold)                 # [B, M]

    # encode gt boxes onto priors per image, gathered by the match
    gt_on_prior, loc_weight = target_assign(
        gt_box, match_idx, mismatch_value=mismatch_value)  # [B, M, 4]
    enc_gt = _encode_per_prior(helper, gt_on_prior, prior_box,
                               prior_box_var)

    loc_diff = lops.elementwise_sub(location, enc_gt)
    loc_l = _smooth_l1(loc_diff)
    loc_l = lops.elementwise_mul(
        _nn.reduce_sum(loc_l, dim=[2]), _squeeze_w(loc_weight))

    # confidence loss: softmax CE against assigned labels
    lbl_on_prior, _ = target_assign(gt_label, match_idx,
                                    mismatch_value=background_label)
    conf_l = _softmax_ce_per_prior(confidence, lbl_on_prior)   # [B, M]
    neg_mask, _ = mine_hard_examples(conf_l, match_idx,
                                     match_dist=match_dist,
                                     neg_pos_ratio=neg_pos_ratio,
                                     neg_dist_threshold=overlap_threshold)
    pos = _match_mask(helper, match_idx)
    keep = lops.elementwise_add(pos, _nn.cast(neg_mask, "float32"))
    conf_l = lops.elementwise_mul(conf_l, keep)

    total = lops.elementwise_add(
        _nn.scale(loc_l, scale=loc_loss_weight),
        _nn.scale(conf_l, scale=conf_loss_weight))
    return total


# --- small graph helpers used by ssd_loss ---------------------------------

def _encode_per_prior(helper, gt_on_prior, prior_box, prior_box_var):
    out, = _op(helper, "box_encode_per_prior",
               {"TargetBox": [gt_on_prior.name],
                "PriorBox": [prior_box.name]}
               | ({"PriorBoxVar": [prior_box_var.name]}
                  if prior_box_var is not None else {}),
               ("OutputBox",))
    return out


def _squeeze_w(w):
    return _nn.reduce_sum(w, dim=[2])


def _match_mask(helper, match_idx):
    ge = _op(helper, "greater_equal_scalar0",
             {"X": [match_idx.name]}, ("Out",), dtypes={"Out": "float32"})
    return ge[0]


def _smooth_l1(absdiff):
    helper = LayerHelper("smooth_l1_elem")
    out, = _op(helper, "smooth_l1_elementwise", {"X": [absdiff.name]},
               ("Out",))
    return out


def _softmax_ce_per_prior(confidence, labels):
    helper = LayerHelper("conf_ce")
    out, = _op(helper, "softmax_ce_no_reduce",
               {"Logits": [confidence.name], "Label": [labels.name]},
               ("Out",))
    return out
