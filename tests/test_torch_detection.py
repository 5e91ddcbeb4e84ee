"""paddle_tpu_torch's detection ops and layers against paddle_tpu, on the
CPU: each of the 15 ops of ops/detection.py on the same inputs (with the
ties its JAX rule orders: NMS among tied scores and in its padded rows,
bipartite matching among tied IoUs, hard-negative mining among tied
losses, the RPN subsample and mAP among tied scores), the SSD head of
tests/test_detection.py trained 12 steps by both packages from one state
(the losses within 1e-5 relative and the match indices and mined
negatives equal at every step), a two-map `multi_box_head` network, and
`detection_output` with `detection_map` and `evaluator.DetectionMAP`.
"""

import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core.backward import append_backward as jappend_backward

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.backward import append_backward as tappend_backward
from paddle_tpu_torch.ops import native

from test_torch_breadth import _close, _int64_as_port, _one_op_both

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from tools import torch_mobilenet_ssd as mssd  # noqa: E402

RNG = np.random.RandomState(41)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boxes(*lead, lo=0.0, hi=1.0):
    """Random ltrb boxes with x1 < x2 and y1 < y2."""
    pts = np.sort(RNG.uniform(lo, hi, lead + (2, 2)), axis=-2)
    return pts.reshape(lead + (4,))[..., [0, 2, 1, 3]].astype(np.float32)


def _fwd(op, inputs, attrs, outs):
    """The op alone in both packages (no backward); returns (fetch, JAX,
    port)."""
    return _one_op_both(op, inputs, attrs, outs=outs, grad=[])


def _equal(fetch, ref, got):
    for name, r, g in zip(fetch, ref, got):
        assert r.shape == g.shape, name
        np.testing.assert_array_equal(g, r, err_msg=name)


# ---------------------------------------------------------------------------
# each op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attrs", [
    dict(min_sizes=[16.0], max_sizes=[32.0], aspect_ratios=[2.0],
         flip=True),
    dict(min_sizes=[8.0, 20.0], max_sizes=[20.0, 40.0],
         aspect_ratios=[2.0, 3.0], flip=True, clip=True,
         min_max_aspect_ratios_order=True),
    dict(min_sizes=[10.0], aspect_ratios=[1.0, 0.5], flip=False,
         step_w=12.0, step_h=9.0, offset=0.25)])
def test_prior_box(attrs):
    fetch, ref, got = _fwd("prior_box", {
        "Input": np.zeros((1, 8, 5, 6), np.float32),
        "Image": np.zeros((1, 3, 60, 64), np.float32)}, attrs,
        ("Boxes", "Variances"))
    _equal(fetch, ref, got)


def test_anchor_generator():
    fetch, ref, got = _fwd("anchor_generator", {
        "Input": np.zeros((1, 8, 3, 4), np.float32)},
        dict(anchor_sizes=[32.0, 64.0], aspect_ratios=[0.5, 1.0, 2.0],
             stride=[16.0, 8.0], offset=0.5), ("Anchors", "Variances"))
    _close(fetch, ref, got, tol=1e-6)


@pytest.mark.parametrize("batched", [False, True])
def test_iou_similarity(batched):
    x = _boxes(3, 5) if batched else _boxes(5)
    fetch, ref, got = _fwd("iou_similarity", {"X": x, "Y": _boxes(7)}, {},
                           ("Out",))
    _close(fetch, ref, got, tol=1e-6)


@pytest.mark.parametrize("normalized", [True, False])
def test_box_coder_encode_and_decode(normalized):
    scale = 1.0 if normalized else 50.0
    prior, target = _boxes(6) * scale, _boxes(4) * scale
    var = RNG.uniform(0.1, 0.3, (6, 4)).astype(np.float32)
    fetch, ref, got = _fwd("box_coder", {
        "PriorBox": prior, "PriorBoxVar": var, "TargetBox": target},
        dict(code_type="encode_center_size", box_normalized=normalized),
        ("OutputBox",))
    _close(fetch, ref, got, tol=1e-5)
    fetch, ref, got = _fwd("box_coder", {
        "PriorBox": prior, "TargetBox": RNG.uniform(
            -1, 1, (4, 6, 4)).astype(np.float32)},
        dict(code_type="decode_center_size", box_normalized=normalized),
        ("OutputBox",))
    _close(fetch, ref, got, tol=1e-5)


@pytest.mark.parametrize("match_type", ["bipartite", "per_prediction"])
def test_bipartite_match_with_tied_ious(match_type):
    """Duplicated priors and ground-truth rows tie their IoUs: the flat
    argmax takes the first, row-major, as `jnp.argmax` does; a padded
    (zero) ground-truth row matches nothing."""
    rng = np.random.RandomState(3)
    gt = np.sort(rng.uniform(0, 1, (2, 4, 2, 2)), axis=-2).reshape(
        2, 4, 4)[..., [0, 2, 1, 3]].astype(np.float32)
    gt[:, 1] = gt[:, 0]                       # two equal ground truths
    gt[1, 3] = 0.0                            # a padded row
    # priors: each ground truth jittered, twice, and a duplicate prior
    prior = np.concatenate([gt[0], gt[1, :3]]) + rng.normal(
        0, 0.03, (7, 4)).astype(np.float32)
    prior = np.concatenate([prior, prior[2:3]])
    from paddle_tpu_torch.ops.detection import _iou_matrix
    dist = _iou_matrix(torch.from_numpy(gt), torch.from_numpy(prior)[None]
                       .expand(2, 8, 4)).numpy()
    dist = np.round(dist * 8) / 8             # more ties
    fetch, ref, got = _fwd("bipartite_match", {"DistMat": dist},
                           dict(match_type=match_type, dist_threshold=0.25),
                           ("ColToRowMatchIndices", "ColToRowMatchDist"))
    _equal(fetch, ref, got)
    assert (got[0] >= 0).sum() >= 4


def test_target_assign_with_a_negative_mask():
    x = RNG.uniform(size=(2, 3, 4)).astype(np.float32)
    match = np.array([[0, -1, 2, 1, -1], [2, 2, -1, 0, 1]], np.int32)
    neg = np.array([[0, 1, 0, 1, 0], [0, 0, 1, 0, 1]], np.int32)
    for inputs in ({"X": x, "MatchIndices": match},
                   {"X": x, "MatchIndices": match, "NegMask": neg}):
        fetch, ref, got = _fwd("target_assign", inputs,
                               dict(mismatch_value=-0.5),
                               ("Out", "OutWeight"))
        _equal(fetch, ref, got)


def _nms_inputs(B=2, C=4, M=12):
    boxes = _boxes(B, M)
    boxes[:, 5] = boxes[:, 3]                 # a duplicate box
    scores = np.round(RNG.uniform(0, 1, (B, C, M)) * 8) / 8   # tied scores
    scores[:, :, 0] = scores[:, :, 1]
    return boxes, scores.astype(np.float32)


@pytest.mark.parametrize("attrs", [
    dict(score_threshold=0.2, nms_top_k=8, keep_top_k=30, nms_threshold=0.3),
    dict(score_threshold=0.05, nms_top_k=-1, keep_top_k=-1,
         nms_threshold=0.5, background_label=2),
    dict(score_threshold=0.1, nms_top_k=10, keep_top_k=6,
         nms_threshold=0.8, nms_eta=0.7),
    dict(score_threshold=0.3, nms_top_k=400, keep_top_k=200,
         nms_threshold=0.45, normalized=False)],
    ids=["padded", "all_kept_bg2", "eta", "ssd_attrs"])
def test_multiclass_nms_with_ties_and_padding(attrs):
    """Out (labels, scores and boxes, the padded rows' boxes too, which
    follow `lax.top_k`'s order among the -1 scores) and Count equal the
    JAX package's bit for bit."""
    boxes, scores = _nms_inputs()
    fetch, ref, got = _fwd("multiclass_nms", {"BBoxes": boxes,
                                              "Scores": scores}, attrs,
                           ("Out", "Count"))
    _equal(fetch, ref, got)
    assert got[1].dtype == np.int64
    if attrs["keep_top_k"] == 30:           # more rows than kept boxes
        assert (got[0][:, :, 0] == -1).any()


def test_multiclass_nms_jacobi_equals_the_steps_in_order():
    """At nms_eta 1 the port solves the suppression by Jacobi rounds; the
    same rows run step by step (an eta just under 1 whose threshold never
    decays, at nms_threshold 0.5) keep the same boxes."""
    from paddle_tpu_torch.ops.detection import _iou_matrix, _nms_keep
    g = torch.Generator().manual_seed(5)
    pts = torch.rand(3, 4, 64, 2, 2, generator=g).sort(dim=-2).values
    boxes = pts.reshape(3, 4, 64, 4)[..., [0, 2, 1, 3]]
    iou = _iou_matrix(boxes, boxes)
    valid = torch.rand(3, 4, 64, generator=g) > 0.2
    for th in (0.1, 0.3, 0.5):
        assert torch.equal(_nms_keep(iou, valid, th, 1.0),
                           _nms_keep(iou, valid, th, 1.0 - 1e-7))


def test_mine_hard_examples_with_tied_losses():
    loss = np.round(RNG.uniform(0, 1, (3, 10)) * 4) / 4
    match = np.full((3, 10), -1, np.int32)
    match[0, [1, 4]] = 0
    match[1, 2] = 1
    dist = RNG.uniform(0, 0.8, (3, 10)).astype(np.float32)
    for inputs in ({"ClsLoss": loss.astype(np.float32),
                    "MatchIndices": match},
                   {"ClsLoss": loss.astype(np.float32),
                    "LocLoss": loss[::-1].copy().astype(np.float32),
                    "MatchIndices": match, "MatchDist": dist}):
        fetch, ref, got = _fwd("mine_hard_examples", inputs,
                               dict(neg_pos_ratio=2.0,
                                    neg_dist_threshold=0.5),
                               ("NegMask", "UpdatedMatchIndices"))
        _equal(fetch, ref, got)


def test_polygon_box_transform():
    fetch, ref, got = _fwd("polygon_box_transform",
                           {"Input": RNG.uniform(size=(2, 4, 3, 5))
                            .astype(np.float32)}, {}, ("Output",))
    _equal(fetch, ref, got)


@pytest.mark.parametrize("batched", [False, True])
def test_rpn_target_assign_with_ties(batched):
    dist = np.round(RNG.uniform(0, 1, (2, 3, 40)) * 5) / 5
    dist = dist.astype(np.float32)
    fetch, ref, got = _fwd("rpn_target_assign", {
        "Anchor": np.zeros((40, 4), np.float32),
        "GtBox": np.zeros((3, 4), np.float32),
        "DistMat": dist if batched else dist[0]},
        dict(rpn_batch_size_per_im=16, rpn_fg_fraction=0.25,
             rpn_positive_overlap=0.6, rpn_negative_overlap=0.3),
        ("Labels", "MatchIndices"))
    _equal(fetch, ref, got)


def _map_inputs(B=3, D=7, G=4, C=4):
    det = np.full((B, D, 6), -1.0, np.float32)
    gt = np.full((B, G, 6), -1.0, np.float32)
    for b in range(B):
        n_gt = RNG.randint(1, G + 1)
        gt[b, :n_gt, 0] = RNG.randint(1, C, n_gt)
        gt[b, :n_gt, 1] = RNG.rand(n_gt) < 0.3
        gt[b, :n_gt, 2:] = _boxes(n_gt)
        n_det = RNG.randint(0, D + 1)
        det[b, :n_det, 0] = RNG.randint(1, C, n_det)
        det[b, :n_det, 1] = np.round(RNG.rand(n_det) * 4) / 4   # ties
        # half the detections sit on a ground-truth box, jittered
        src = gt[b, RNG.randint(0, n_gt, n_det), 2:]
        det[b, :n_det, 2:] = np.where(RNG.rand(n_det, 1) < 0.5,
                                      src + RNG.normal(0, 0.02, (n_det, 4)),
                                      _boxes(n_det))
    return det, gt


@pytest.mark.parametrize("ap_version", ["integral", "11point"])
@pytest.mark.parametrize("evaluate_difficult", [True, False])
def test_detection_map(ap_version, evaluate_difficult):
    for _ in range(3):
        det, gt = _map_inputs()
        fetch, ref, got = _fwd("detection_map", {"DetectRes": det,
                                                 "Label": gt},
                               dict(class_num=4, overlap_threshold=0.5,
                                    evaluate_difficult=evaluate_difficult,
                                    ap_version=ap_version), ("MAP",))
        _close(fetch, ref, got, tol=1e-6)


def test_ssd_building_blocks():
    for op, inputs, attrs, outs in [
            ("greater_equal_scalar0", {"X": np.array(
                [[-1, 0, 2]], np.float32)}, {}, ("Out",)),
            ("smooth_l1_elementwise", {"X": np.array(
                [[-2, -1, -0.5, 0, 0.5, 1, 3]], np.float32)},
             {"sigma": 1.0}, ("Out",)),
            ("softmax_ce_no_reduce", {"Logits": RNG.normal(
                size=(2, 3, 4)).astype(np.float32), "Label": np.array(
                [[[0], [3], [1]], [[2], [2], [0]]], np.int64)}, {},
             ("Out",))]:
        fetch, ref, got = _one_op_both(op, inputs, attrs, outs=outs)
        _close(fetch, ref, got)


# ---------------------------------------------------------------------------
# programs: the SSD head, multi_box_head, detection_output and mAP
# ---------------------------------------------------------------------------

def _op_output(program, op_type, slot):
    return [op.output(slot)[0] for op in program.global_block().ops
            if op.type == op_type][0]


def _two_sides(build, backward=True):
    """Build with each package, hold the Programs equal, and return
    {name: (main, startup, result)}."""
    out = {}
    for name, pkg, app in (("jax", fluid, jappend_backward),
                           ("port", ptt, tappend_backward)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            out[name] = (main, startup, build(pkg))
    jmain, tmain = out["jax"][0], out["port"][0]
    assert tmain.to_dict() == _int64_as_port(jmain.to_dict(), tmain)
    assert out["port"][1].to_dict() == out["jax"][1].to_dict()
    return out


def _port_state(jscope):
    return ptt.io.state_from_numpy(
        {n: np.asarray(jscope.find_var(n)) for n in jscope.local_var_names()},
        ptt.CPUPlace())


def _ssd_head(pkg):
    """tests/test_detection.py's SSD head: a conv feature map, priors,
    loc / conf convs, `ssd_loss`, Adam."""
    L = pkg.layers
    det = L.detection
    M_GT, C = 2, 3
    img = L.data(name="img", shape=[3, 32, 32], dtype="float32")
    gt_box = L.data(name="gt_box", shape=[-1, M_GT, 4], dtype="float32",
                    append_batch_size=False)
    gt_label = L.data(name="gt_label", shape=[-1, M_GT, 1], dtype="int64",
                      append_batch_size=False)
    feat = L.conv2d(input=img, num_filters=8, filter_size=3, stride=4,
                    padding=1, act="relu")
    boxes, var = det.prior_box(feat, img, min_sizes=[8.0],
                               aspect_ratios=[1.0])
    n_priors = 8 * 8
    prior_flat = L.reshape(boxes, shape=[n_priors, 4])
    var_flat = L.reshape(var, shape=[n_priors, 4])
    loc = L.conv2d(input=feat, num_filters=4, filter_size=3, padding=1)
    loc = L.reshape(L.transpose(loc, perm=[0, 2, 3, 1]),
                    shape=[-1, n_priors, 4])
    conf = L.conv2d(input=feat, num_filters=C, filter_size=3, padding=1)
    conf = L.reshape(L.transpose(conf, perm=[0, 2, 3, 1]),
                     shape=[-1, n_priors, C])
    loss_map = det.ssd_loss(loc, conf, gt_box, gt_label, prior_flat,
                            var_flat)
    loss = L.mean(L.reduce_sum(loss_map, dim=[1]))
    pkg.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return loss


def test_ssd_head_trains_12_steps_like_paddle_tpu():
    """From the JAX startup's state, the same batch: at every step the
    losses within 1e-5 relative, and the match indices and the mined
    negatives equal."""
    sides = _two_sides(_ssd_head)
    np.random.seed(0)
    B, M_GT, C = 4, 2, 3
    imgs = np.random.rand(B, 3, 32, 32).astype(np.float32)
    gts = np.sort(np.random.rand(B, M_GT, 2, 2), axis=2).reshape(B, M_GT, 4)
    gts = gts[:, :, [0, 2, 1, 3]].astype(np.float32)
    lbls = np.random.randint(1, C, (B, M_GT, 1)).astype(np.int64)
    feed = {"img": imgs, "gt_box": gts, "gt_label": lbls}
    jmain, jstart, jloss = sides["jax"]
    tmain, _, tloss = sides["port"]
    fetch = [jloss.name, _op_output(jmain, "bipartite_match",
                                    "ColToRowMatchIndices"),
             _op_output(jmain, "mine_hard_examples", "NegMask")]
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    tscope, texe = _port_state(jscope), ptt.Executor(ptt.CPUPlace())
    native.reset_launches()
    losses = []
    for step in range(12):
        ref = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
        got = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
        r, g = float(np.asarray(ref[0]).reshape(-1)[0]), float(got[0][0])
        assert abs(g - r) <= 1e-5 * abs(r), (step, g, r)
        np.testing.assert_array_equal(got[1], ref[1], err_msg=str(step))
        np.testing.assert_array_equal(got[2], ref[2], err_msg=str(step))
        losses.append(g)
    assert not any(native.launches.values())
    assert losses[-1] < losses[0] and (got[1] >= 0).any() and got[2].any()


def _two_map_net(pkg):
    """Two feature maps under `multi_box_head` with explicit sizes,
    `ssd_loss`, Momentum."""
    L = pkg.layers
    img = L.data(name="img", shape=[3, 24, 24], dtype="float32")
    gt_box = L.data(name="gt_box", shape=[-1, 3, 4], dtype="float32",
                    append_batch_size=False)
    gt_label = L.data(name="gt_label", shape=[-1, 3, 1], dtype="int64",
                      append_batch_size=False)
    f1 = L.conv2d(img, num_filters=6, filter_size=3, stride=4, padding=1,
                  act="relu")                                  # 6 x 6
    f2 = L.conv2d(f1, num_filters=6, filter_size=3, stride=2, padding=1,
                  act="relu")                                  # 3 x 3
    locs, confs, boxes, var = L.multi_box_head(
        [f1, f2], img, base_size=24, num_classes=4,
        aspect_ratios=[[2.0], [2.0, 3.0]], min_sizes=[4.0, 10.0],
        max_sizes=[10.0, 20.0], flip=True, kernel_size=3, pad=1)
    loss = L.mean(L.reduce_sum(L.ssd_loss(locs, confs, gt_box, gt_label,
                                          boxes, var), dim=[1]))
    pkg.optimizer.Momentum(learning_rate=0.05, momentum=0.9).minimize(loss)
    return loss, locs, confs, boxes


def test_two_map_multi_box_head_trains_like_paddle_tpu():
    sides = _two_sides(_two_map_net)
    B = 3
    imgs = RNG.rand(B, 3, 24, 24).astype(np.float32)
    gts = _boxes(B, 3)
    lbls = RNG.randint(1, 4, (B, 3, 1)).astype(np.int64)
    lbls[0, 2] = 0                                   # a padded row
    feed = {"img": imgs, "gt_box": gts, "gt_label": lbls}
    jmain, jstart, (jloss, jlocs, jconfs, jboxes) = sides["jax"]
    tmain = sides["port"][0]
    fetch = [jloss.name, jlocs.name, jconfs.name, jboxes.name]
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    tscope, texe = _port_state(jscope), ptt.Executor(ptt.CPUPlace())
    for step in range(4):
        ref = [np.asarray(r) for r in jexe.run(jmain, feed=feed,
                                               fetch_list=fetch,
                                               scope=jscope)]
        got = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
        # (6 * 6 + 3 * 3) cells x 6 priors (ratios 1, 2, 1/2, 3, 1/3 and
        # the square; the first map has no 3)
        assert got[3].shape == (6 * 6 * 4 + 3 * 3 * 6, 4)
        _close(fetch, ref, got, tol=1e-5)


def _detect_net(pkg):
    """An inference SSD: loc / conf from a conv map, `detection_output`
    (decode + NMS) and `detection_map` on its padded output."""
    L = pkg.layers
    img = L.data(name="img", shape=[3, 16, 16], dtype="float32")
    gt = L.data(name="gt", shape=[-1, 4, 6], dtype="float32",
                append_batch_size=False)
    feat = L.conv2d(img, num_filters=4, filter_size=3, stride=4, padding=1,
                    act="relu")                                 # 4 x 4
    locs, confs, boxes, var = L.multi_box_head(
        [feat], img, base_size=16, num_classes=3, aspect_ratios=[[2.0]],
        min_sizes=[5.0], max_sizes=[9.0], flip=True, kernel_size=3, pad=1)
    nmsed, count = L.detection_output(locs, confs, boxes, var,
                                      nms_threshold=0.45, nms_top_k=20,
                                      keep_top_k=12, score_threshold=0.2)
    m = L.detection_map(nmsed, gt, class_num=3, ap_version="11point")
    ev = pkg.evaluator.DetectionMAP(nmsed, gt, class_num=3)
    return nmsed, count, m, ev


def test_detection_output_map_and_the_evaluator_like_paddle_tpu():
    sides = _two_sides(_detect_net)
    jmain, jstart, (jn, jc, jm, jev) = sides["jax"]
    tmain, _, (_, _, _, tev) = sides["port"]
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    tscope, texe = _port_state(jscope), ptt.Executor(ptt.CPUPlace())
    fetch = [jn.name, jc.name, jm.name, jev.metrics[0].name]
    for batch in range(3):
        gt = np.full((2, 4, 6), -1.0, np.float32)
        gt[:, :3, 0] = RNG.randint(1, 3, (2, 3))
        gt[:, :3, 1] = 0.0
        gt[:, :3, 2:] = _boxes(2, 3)
        feed = {"img": RNG.rand(2, 3, 16, 16).astype(np.float32) * 4,
                "gt": gt}
        ref = [np.asarray(r) for r in jexe.run(jmain, feed=feed,
                                               fetch_list=fetch,
                                               scope=jscope)]
        got = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_allclose(got[2:], ref[2:], rtol=1e-5, atol=1e-6)
        assert got[1].min() > 0
        jev.update(ref[3], 2)
        tev.update(got[3], 2)
    np.testing.assert_allclose(tev.eval(), jev.eval(), rtol=1e-6)


def test_small_mobilenet_ssd_steps_from_the_jax_state():
    """`tools/torch_mobilenet_ssd.py` (the card's network) at an eighth
    of its widths, batch 2, built by both packages: three RMSProp steps,
    the port's each from the JAX package's state (RMSProp's first
    updates are about lr * sign(grad), so a free run parts where a grad
    lies within rounding of 0): the losses within 1e-5 relative, the
    match indices and mined negatives equal, 2278 priors."""
    sides = _two_sides(lambda pkg: mssd.build(pkg, scale=0.125))
    jmain, jstart, jv = sides["jax"]
    assert tuple(jv["boxes"].shape) == (mssd.PRIORS, 4)
    fetch = [jv["loss"].name,
             mssd.op_output(jmain, "bipartite_match", "ColToRowMatchIndices"),
             mssd.op_output(jmain, "mine_hard_examples", "NegMask")]
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    texe = ptt.Executor(ptt.CPUPlace())
    for step in range(3):
        feed = mssd.batch(step, 2)[0]
        tscope = _port_state(jscope)
        got = texe.run(sides["port"][0], feed=feed, fetch_list=fetch,
                       scope=tscope)
        ref = [np.asarray(r) for r in jexe.run(jmain, feed=feed,
                                               fetch_list=fetch,
                                               scope=jscope)]
        assert abs(float(got[0][0]) - float(ref[0][0])) \
            <= 1e-5 * abs(float(ref[0][0])), step
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_array_equal(got[2], ref[2])
        assert (got[1] >= 0).any() and got[2].any()
