"""MobileNet-v1 SSD at 300 x 300 (PaddlePaddle/models,
fluid/object_detection/mobilenet_ssd.py), the detection network of the
Fluid era, built with either package's layers.

`build(fluid, ...)` takes the framework module (``paddle_tpu_torch``, or
``paddle_tpu`` where a CPU test holds the port against it) and builds
into the current default programs, NCHW:

- the backbone: conv-bn-relu 3 x 3 stride 2 to 32 channels, then
  depthwise-separable blocks (3 x 3 depthwise + bn + relu, 1 x 1 + bn +
  relu) of 64 s1, 128 s2, 128 s1, 256 s2, 256 s1, 512 s2, five of 512 s1
  (map 1, 19 x 19), 1024 s2 and 1024 s1 (map 2, 10 x 10), then four extra
  blocks (1 x 1 to half width, 3 x 3 stride 2, each with bn and relu) of
  256 -> 512, 128 -> 256, 128 -> 256 and 64 -> 128 (maps of 5, 3, 2, 1);
- the head: `multi_box_head` over the six maps, base_size 300, 21
  classes, min_ratio 20, max_ratio 90, aspect ratios [[2], [2, 3] x 5],
  offset 0.5, flip, 3 x 3 kernels with pad 1: 2278 priors;
- training: `ssd_loss`, then mean(reduce_sum(loss, dim=[1])) (as
  tests/test_detection.py reduces it), `RMSProp(0.001)` with
  `L2Decay(5e-5)`;
- testing (`is_test`): batch norm on its running stats,
  `detection_output` (nms_threshold 0.45, nms_top_k 400, keep_top_k 200,
  score_threshold 0.01) and `detection_map` (overlap 0.5, `11point` and
  `integral`).

`scale` multiplies every width (the published network is 1.0); the CPU
tests use a small one. `batch(...)` makes a synthetic batch from a
seed: noise images with one filled rectangle a ground-truth box, in a
colour of its class, 1 to `max_gt` boxes an image padded to `gt_rows`
with label 0 and an empty box. PASCAL VOC is not in the repository.
"""

from __future__ import annotations

import numpy as np

IMAGE, CLASSES, GT_ROWS, MAX_GT = 300, 21, 16, 8
NMS = dict(nms_threshold=0.45, nms_top_k=400, keep_top_k=200,
           score_threshold=0.01)
PRIORS = 2278


def _conv_bn(L, fluid, x, k, filters, stride, pad, groups=1, is_test=False):
    conv = L.conv2d(input=x, num_filters=filters, filter_size=k,
                    stride=stride, padding=pad, groups=groups,
                    param_attr=fluid.ParamAttr(
                        initializer=fluid.initializer.MSRA()),
                    bias_attr=False)
    return L.batch_norm(input=conv, act="relu", is_test=is_test)


def _separable(L, fluid, x, c_in, c_out, stride, scale, is_test):
    dw = _conv_bn(L, fluid, x, 3, int(c_in * scale), stride, 1,
                  groups=int(c_in * scale), is_test=is_test)
    return _conv_bn(L, fluid, dw, 1, int(c_out * scale), 1, 0,
                    is_test=is_test)


def _extra(L, fluid, x, c_mid, c_out, scale, is_test):
    pw = _conv_bn(L, fluid, x, 1, int(c_mid * scale), 1, 0, is_test=is_test)
    return _conv_bn(L, fluid, pw, 3, int(c_out * scale), 2, 1,
                    is_test=is_test)


def build(fluid, scale=1.0, image=IMAGE, num_classes=CLASSES,
          gt_rows=GT_ROWS, is_test=False, lr=0.001, decay=5e-5):
    """The network into the default programs; returns a dict of vars:
    img, gt_box, gt_label, locs, confs, boxes, variances and, training,
    loss (the optimizer appended), or, testing, gt (the [B, gt_rows, 6]
    detection_map layout), nmsed, count, map_11point, map_integral."""
    L = fluid.layers
    img = L.data(name="img", shape=[3, image, image], dtype="float32")
    v = dict(img=img)
    x = _conv_bn(L, fluid, img, 3, int(32 * scale), 2, 1, is_test=is_test)
    for c_in, c_out, stride in ((32, 64, 1), (64, 128, 2), (128, 128, 1),
                                (128, 256, 2), (256, 256, 1),
                                (256, 512, 2)) + ((512, 512, 1),) * 5:
        x = _separable(L, fluid, x, c_in, c_out, stride, scale, is_test)
    maps = [x]
    x = _separable(L, fluid, x, 512, 1024, 2, scale, is_test)
    x = _separable(L, fluid, x, 1024, 1024, 1, scale, is_test)
    maps.append(x)
    for c_mid, c_out in ((256, 512), (128, 256), (128, 256), (64, 128)):
        x = _extra(L, fluid, x, c_mid, c_out, scale, is_test)
        maps.append(x)
    locs, confs, boxes, variances = L.multi_box_head(
        inputs=maps, image=img, base_size=image, num_classes=num_classes,
        min_ratio=20, max_ratio=90,
        aspect_ratios=[[2.0]] + [[2.0, 3.0]] * 5, offset=0.5, flip=True,
        kernel_size=3, pad=1)
    v.update(locs=locs, confs=confs, boxes=boxes, variances=variances)
    if is_test:
        gt = L.data(name="gt", shape=[gt_rows, 6], dtype="float32")
        nmsed, count = L.detection_output(locs, confs, boxes, variances,
                                          **NMS)
        v.update(gt=gt, nmsed=nmsed, count=count)
        for ap in ("11point", "integral"):
            v["map_" + ap] = L.detection_map(nmsed, gt,
                                             class_num=num_classes,
                                             overlap_threshold=0.5,
                                             ap_version=ap)
        return v
    gt_box = L.data(name="gt_box", shape=[gt_rows, 4], dtype="float32")
    gt_label = L.data(name="gt_label", shape=[gt_rows, 1], dtype="int64")
    loss = L.ssd_loss(locs, confs, gt_box, gt_label, boxes, variances)
    loss = L.mean(L.reduce_sum(loss, dim=[1]))
    fluid.optimizer.RMSProp(
        learning_rate=lr,
        regularization=fluid.regularizer.L2Decay(decay)).minimize(loss)
    v.update(gt_box=gt_box, gt_label=gt_label, loss=loss)
    return v


def op_output(program, op_type, slot):
    """The var an op of `op_type` writes to `slot` (the first such op)."""
    return [op.output(slot)[0] for op in program.global_block().ops
            if op.type == op_type][0]


def batch(seed, size, image=IMAGE, num_classes=CLASSES, gt_rows=GT_ROWS,
          max_gt=MAX_GT):
    """A synthetic batch from `seed`: feeds for the training program
    (img, gt_box, gt_label) and the testing one (img, gt)."""
    rng = np.random.RandomState(seed)
    img = rng.normal(0.0, 0.3, (size, 3, image, image)).astype(np.float32)
    colours = np.random.RandomState(0).uniform(-1, 1, (num_classes, 3))
    box = np.zeros((size, gt_rows, 4), np.float32)
    label = np.zeros((size, gt_rows, 1), np.int64)
    for b in range(size):
        for g in range(rng.randint(1, max_gt + 1)):
            w, h = rng.uniform(0.1, 0.6, 2)
            x1, y1 = rng.uniform(0, 1 - w), rng.uniform(0, 1 - h)
            box[b, g] = (x1, y1, x1 + w, y1 + h)
            label[b, g, 0] = rng.randint(1, num_classes)
            px = np.round(box[b, g] * image).astype(int)
            img[b, :, px[1]:px[3], px[0]:px[2]] += colours[
                label[b, g, 0]][:, None, None]
    gt = np.full((size, gt_rows, 6), -1.0, np.float32)
    real = label[..., 0] > 0
    gt[..., 0] = np.where(real, label[..., 0], -1)
    gt[..., 1] = np.where(real, 0.0, -1.0)
    gt[..., 2:] = np.where(real[..., None], box, -1.0)
    return (dict(img=img, gt_box=box, gt_label=label),
            dict(img=img, gt=gt))
