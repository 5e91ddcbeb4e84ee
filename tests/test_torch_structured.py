"""paddle_tpu_torch's structured and extra ops against paddle_tpu, on the
CPU: the 3-D convs and pool, the resize layers (an upscale and a
downscale, bilinear with the JAX package's antialiasing and nearest),
crop, random_crop, label_smooth, multiplex, mean_iou, roi_pool,
ctc_greedy_decoder, lod_reset, chunk_eval and im2sequence (ops/extra_nn.py
and ops/nn.py), then nce, hsigmoid, warpctc and edit_distance
(ops/loss_extra.py), then `evaluator.ChunkEvaluator` and `EditDistance`.

Each layer is built with both packages' layers (the Programs held equal,
the port's int64 index outputs aside), started from the JAX startup's
state and run one step: every forward output and every grad var to
TOL (`test_torch_breadth.run_both`). The random ops draw from the port's
own generator, so they are held to what a draw must satisfy.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import registry as tregistry

from test_torch_breadth import _f, _loss, _one_op_both, _x, _close, run_both

RNG = np.random.RandomState(29)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seq(L, name, shape, dtype="float32"):
    """A lod_level 1 data var of per-step `shape`."""
    return L.data(name, shape=list(shape), dtype=dtype, lod_level=1)


# ---------------------------------------------------------------------------
# ops/extra_nn.py and im2sequence through their layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride,padding,dilation,groups", [
    (1, 1, 1, None), ([1, 2, 2], [0, 1, 1], 1, None), (1, 2, 2, 3)])
def test_conv3d_layer(stride, padding, dilation, groups):
    x = _f(2, 6, 5, 6, 6)

    def build(pkg):
        L = pkg.layers
        out = L.conv3d(_x(L, "x", x.shape), num_filters=6, filter_size=3,
                       stride=stride, padding=padding, dilation=dilation,
                       groups=groups, act="relu")
        return _loss(L, out), [out.name]
    run_both(build, {"x": x})


@pytest.mark.parametrize("kw", [
    dict(filter_size=3, stride=2, padding=1),
    dict(output_size=[7, 9, 9], stride=2, padding=1),
    dict(filter_size=[2, 3, 3], stride=1, padding=0, dilation=2)])
def test_conv3d_transpose_layer(kw):
    x = _f(2, 3, 4, 5, 5)

    def build(pkg):
        L = pkg.layers
        out = L.conv3d_transpose(_x(L, "x", x.shape), num_filters=2, **kw)
        return _loss(L, out), [out.name]
    run_both(build, {"x": x})


@pytest.mark.parametrize("kw", [
    dict(pool_size=2, pool_type="max", pool_stride=2),
    dict(pool_size=3, pool_type="avg", pool_stride=2, pool_padding=1),
    dict(pool_size=[2, 3, 3], pool_type="max", pool_stride=1,
         pool_padding=[1, 2, 2]),
    dict(pool_type="max", global_pooling=True),
    dict(pool_type="avg", global_pooling=True)])
def test_pool3d_layer(kw):
    x = _f(2, 3, 5, 6, 6)
    x[0, 0, 0, :2, :2] = 0.5            # a tie in the first window

    def build(pkg):
        L = pkg.layers
        out = L.pool3d(_x(L, "x", x.shape), **kw)
        return _loss(L, out), [out.name]
    run_both(build, {"x": x})


@pytest.mark.parametrize("ptype", ["max", "avg"])
def test_pool3d_over_an_input_smaller_than_its_window(ptype):
    """Depth 2 under a 3-deep window padded by 1: the JAX rule's
    reduce_window gives one output plane; torch's 3-D average refuses an
    input smaller than its window, so the rule pads it explicitly."""
    fetch, ref, got = _one_op_both(
        "pool3d", {"X": _f(2, 3, 2, 7, 7)},
        {"pooling_type": ptype, "ksize": [3, 3, 3], "strides": [2, 2, 2],
         "paddings": [1, 1, 1]}, grad=["X"])
    assert ref[0].shape == (2, 3, 1, 4, 4)
    _close(fetch, ref, got)


@pytest.mark.parametrize("layer,kw", [
    ("image_resize", dict(out_shape=[19, 25])),          # up
    ("image_resize", dict(out_shape=[5, 3])),            # down (antialias)
    ("image_resize", dict(out_shape=[6, 21])),           # down and up
    ("resize_bilinear", dict(scale=0.5)),
    ("resize_bilinear", dict(scale=2.0)),
    ("image_resize", dict(out_shape=[5, 13], resample="NEAREST")),
    ("image_resize", dict(out_shape=[24, 7], resample="NEAREST")),
    ("image_resize_short", dict(out_short_len=4)),
    ("image_resize_short", dict(out_short_len=20))],
    ids=["up", "down", "mixed", "half", "double", "nearest_down",
         "nearest_mixed", "short_down", "short_up"])
def test_resize_layers(layer, kw):
    """`jax.image.resize`: half-pixel centres, a kernel widened by the
    scale on a downscale; F.interpolate without antialias misses it."""
    x = _f(2, 3, 11, 13)

    def build(pkg):
        L = pkg.layers
        out = getattr(L, layer)(_x(L, "x", x.shape), **kw)
        return _loss(L, out), [out.name]
    run_both(build, {"x": x})


def test_bilinear_downscale_needs_the_antialias():
    """The plain F.interpolate is not the JAX rule on a downscale (the
    reason the port takes `jax.image.resize`'s antialiased weights), and
    is on an upscale."""
    x = _f(1, 2, 16, 16)
    for size, differs in ((7, True), (32, False)):
        fetch, ref, got = _one_op_both("bilinear_interp", {"X": x},
                                       {"out_h": size, "out_w": size})
        plain = torch.nn.functional.interpolate(
            torch.from_numpy(x), size=(size, size), mode="bilinear",
            align_corners=False).numpy()
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-6)
        assert (np.abs(plain - ref[0]).max() > 1e-2) == differs


def test_bilinear_interp_refuses_out_size():
    with pytest.raises(NotImplementedError, match="OutSize"):
        _one_op_both("bilinear_interp",
                     {"X": _f(1, 1, 4, 4),
                      "OutSize": np.array([8, 8], np.int32)}, {})


def test_crop_layers():
    x, y = _f(3, 6, 7), _f(2, 4, 3)

    def build(pkg):
        L = pkg.layers
        xv = _x(L, "x", x.shape)
        a = L.crop(xv, shape=[2, 3, 4], offsets=[1, 2, 3])
        b = L.crop(xv, shape=_x(L, "y", y.shape, stop_gradient=True),
                   offsets=[0, 1, 2])
        return L.mean(L.reduce_sum(a) + L.reduce_sum(b * 2.0)), [a.name,
                                                                  b.name]
    run_both(build, {"x": x, "y": y})


@pytest.mark.parametrize("offsets", [[1, 2, 0], [0, 9, 4]],
                         ids=["inside", "clamped"])
def test_crop_with_an_offsets_tensor(offsets):
    """Runtime offsets are `lax.dynamic_slice` starts: one that runs past
    the input clamps into it."""
    fetch, ref, got = _one_op_both(
        "crop", {"X": _f(3, 6, 7), "Offsets": np.array(offsets, np.int32)},
        {"shape": [2, 3, 4]}, grad=["X"])
    _close(fetch, ref, got)


def test_label_smooth_multiplex_mean_iou_layers():
    lab = np.eye(5, dtype=np.float32)[RNG.randint(0, 5, 6)]
    prior = RNG.dirichlet(np.ones(5)).astype(np.float32)[None]
    a, b, c = _f(6, 4), _f(6, 4), _f(6, 4)
    ids = np.array([[2], [0], [1], [2], [2], [0]], np.int32)
    pred = RNG.randint(-1, 5, (3, 8)).astype(np.int32)   # -1, 4: outside
    gt = RNG.randint(0, 5, (3, 8)).astype(np.int32)

    def build(pkg):
        L = pkg.layers
        lv = _x(L, "lab", lab.shape)
        s1 = L.label_smooth(lv, epsilon=0.1)
        s2 = L.label_smooth(lv, prior_dist=_x(L, "prior", prior.shape,
                                              stop_gradient=True),
                            epsilon=0.25)
        m = L.multiplex([_x(L, n, v.shape) for n, v in (("a", a), ("b", b),
                                                         ("c", c))],
                        _x(L, "ids", ids.shape, "int32", True))
        miou, wrong, right = L.mean_iou(_x(L, "pred", pred.shape, "int32",
                                           True),
                                        _x(L, "gt", gt.shape, "int32", True),
                                        num_classes=4)
        loss = L.mean(L.reduce_sum(s1 * s2) + L.reduce_sum(m * m))
        return loss, [s1.name, s2.name, m.name, miou.name, wrong.name,
                      right.name]
    run_both(build, {"lab": lab, "prior": prior, "a": a, "b": b, "c": c,
                     "ids": ids, "pred": pred, "gt": gt})


@pytest.mark.parametrize("scale,pooled", [(1.0, (2, 2)), (0.5, (3, 2)),
                                          (0.25, (2, 3))])
def test_roi_pool_layer(scale, pooled):
    """ROIs inside, across and past the map's edges, one of zero size
    (x1 > x2) and one wider than the map; ties in the feature map, whose
    grad splits equally among them as jnp.max's does."""
    x = np.round(_f(2, 3, 8, 10) * 2) / 2        # many ties
    rois = np.array([[0, 0, 0, 7, 5], [1, 2, 1, 9, 7], [0, 5, 5, 15, 12],
                     [1, -3, -2, 2, 3], [0, 6, 2, 4, 6],
                     [1, 0, 0, 40, 30]], np.float32)
    rois[:, 1:] /= scale                  # image coordinates

    def build(pkg):
        L = pkg.layers
        out = L.roi_pool(_x(L, "x", x.shape),
                         _x(L, "rois", rois.shape, stop_gradient=True),
                         pooled_height=pooled[0], pooled_width=pooled[1],
                         spatial_scale=scale)
        return _loss(L, out), [out.name]
    run_both(build, {"x": x, "rois": rois})


def test_roi_pool_bins_are_the_jitted_jax_steps():
    """At 7 x 7 bins many bounds fall on integers: the port rounds them
    as the JAX package's jitted step does on the CPU (`_bin_span`), so
    every output and grad matches. The rule as it reads, dividing first,
    gives another bound for a ROI from 0 to 6 (extent 7): its third bin
    ends at ceil(3 * (7 / 7)) = 3, the jitted step's at
    ceil(7 * 3.0000002) = 4 (3 * (1 / 7) folded into one float32
    constant)."""
    from paddle_tpu_torch.ops.extra_nn import _bin_span
    rng = np.random.RandomState(0)
    x = rng.randn(1, 2, 40, 40).astype(np.float32)
    xy = rng.randint(0, 10, (60, 2))
    wh = rng.randint(5, 30, (60, 2))
    rois = np.concatenate([np.zeros((60, 1)), xy, xy + wh], 1).astype(
        np.float32)
    fetch, ref, got = _one_op_both(
        "roi_pool", {"X": x, "ROIs": rois},
        {"pooled_height": 7, "pooled_width": 7, "spatial_scale": 1.0},
        grad=["X"])
    np.testing.assert_array_equal(got[0], ref[0])
    _close(fetch, ref, got)
    f32 = np.float32
    as_read = np.ceil(f32(0) + f32(3) * (f32(7) / f32(7)))
    _, hi = _bin_span(torch.zeros(1), torch.full((1,), 7.0), 7, 100)
    assert as_read == 3.0 and int(hi[0, 2]) == 4


def test_ctc_greedy_decoder_layer():
    """argmax ties (the first wins), repeats merged, blanks dropped, the
    decoded lengths on the output's `@SEQLEN` companion."""
    x = np.round(_f(3, 7, 5) * 2) / 2
    x[0, 2] = x[0, 1]                    # a repeat
    x[1, 3, :] = 0.5                     # a tie of every class: blank
    lens = np.array([7, 4, 1], np.int32)
    from paddle_tpu_torch.core.ir import seqlen_var_name

    def build(pkg):
        L = pkg.layers
        out, n = L.ctc_greedy_decoder(_seq(L, "x", [5]), blank=0)
        return None, [out.name, n.name, seqlen_var_name(out.name)]
    ref = run_both(build, {"x": (x, lens)})
    np.testing.assert_array_equal(ref[1], ref[2])
    assert (ref[0][2, 1:] == 0).all()


def test_lod_reset_layer():
    x = _f(4, 3)
    y = np.array([1, 3], np.int32)

    def build(pkg):
        L = pkg.layers
        xv = _x(L, "x", x.shape)
        a = L.lod_reset(xv, y=_x(L, "y", y.shape, "int32", True))
        b = L.lod_reset(xv, target_lod=[0, 2, 4])
        return L.mean(a + b), [a.name, b.name, a.name + "@SEQLEN",
                               b.name + "@SEQLEN"]
    run_both(build, {"x": x, "y": y})


@pytest.mark.parametrize("scheme,n_types,exclude", [
    ("IOB", 3, None), ("IOE", 3, None), ("plain", 4, None),
    ("IOB", 3, [1])])
def test_chunk_eval_layer(scheme, n_types, exclude):
    tags = {"IOB": 2, "IOE": 2, "plain": 1}[scheme] * n_types + 1
    inf = RNG.randint(0, tags, (4, 9, 1)).astype(np.int64)
    lab = inf.copy()
    flip = RNG.rand(4, 9, 1) < 0.3
    lab[flip] = RNG.randint(0, tags, flip.sum())
    lens = np.array([9, 5, 1, 7], np.int32)

    def build(pkg):
        L = pkg.layers
        outs = L.chunk_eval(_seq(L, "inf", [1], "int64"),
                            _seq(L, "lab", [1], "int64"),
                            chunk_scheme=scheme, num_chunk_types=n_types,
                            excluded_chunk_types=exclude)
        return None, [o.name for o in outs]
    ref = run_both(build, {"inf": (inf, lens), "lab": (lab, lens)})
    assert ref[3] > 0 and ref[5] > 0


@pytest.mark.parametrize("kw", [dict(filter_size=2, stride=2),
                                dict(filter_size=[3, 2], stride=[1, 2],
                                     padding=[1, 0]),
                                dict(filter_size=[6, 1], stride=1)])
def test_im2sequence_layer(kw):
    """`F.unfold`'s patch order is `conv_general_dilated_patches`'s."""
    x = _f(2, 3, 6, 8)

    def build(pkg):
        L = pkg.layers
        out = L.im2sequence(_x(L, "x", x.shape), **kw)
        return _loss(L, out), [out.name]
    run_both(build, {"x": x})


def test_random_crop_is_a_window_of_its_input():
    """Each run's output is a window of X at its own starts, drawn from
    the op's generator (seeded per program seed and run): every window
    position turns up over the runs."""
    x = _f(2, 3, 6, 5)
    main = ptt.Program()
    with ptt.program_guard(main, ptt.Program()):
        out = ptt.layers.random_crop(ptt.layers.data(
            "x", shape=list(x.shape), dtype="float32",
            append_batch_size=False), shape=[4, 4])
    exe, seen = ptt.Executor(ptt.CPUPlace()), set()
    for _ in range(40):
        o, = exe.run(main, feed={"x": x}, fetch_list=[out])
        at = [(i, j) for i in range(3) for j in range(2)
              if np.array_equal(o, x[..., i:i + 4, j:j + 4])]
        assert len(at) == 1
        seen.add(at[0])
    assert len(seen) == 6


# ---------------------------------------------------------------------------
# ops/loss_extra.py through its layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [True, False])
def test_hsigmoid_layer(bias):
    x = _f(5, 6)
    label = np.array([[0], [6], [3], [1], [5]], np.int64)

    def build(pkg):
        L = pkg.layers
        out = L.hsigmoid(_x(L, "x", x.shape), _x(L, "label", label.shape,
                                                 "int64", True),
                         num_classes=7, bias_attr=None if bias else False)
        return _loss(L, out), [out.name]
    run_both(build, {"x": x, "label": label})


@pytest.mark.parametrize("with_lengths", [True, False])
def test_warpctc_layer(with_lengths):
    """Repeated labels (a path must pass a blank between them), a row
    whose label is empty (u_len 0: the all-blank path only), frames past
    a row's length; the loss and the Logits grad."""
    logits = _f(4, 9, 5, lo=-2, hi=2)
    label = np.array([[1, 1, 2, 0], [3, 3, 3, 0], [2, 4, 1, 3],
                      [4, 0, 0, 0]], np.int64)
    t_len = np.array([9, 8, 9, 3], np.int64)
    u_len = np.array([3, 3, 4, 0], np.int64)

    def build(pkg):
        L = pkg.layers
        kw = {}
        if with_lengths:
            kw = dict(input_length=_x(L, "tl", t_len.shape, "int64", True),
                      label_length=_x(L, "ul", u_len.shape, "int64", True))
        loss = L.warpctc(_x(L, "logits", logits.shape),
                         _x(L, "label", label.shape, "int64", True),
                         blank=0, **kw)
        return _loss(L, loss), [loss.name]
    ref = run_both(build, {"logits": logits, "label": label, "tl": t_len,
                           "ul": u_len})
    assert np.isfinite(ref[0]).all() and (ref[0] > 0).all()


def test_warpctc_empty_label_is_the_all_blank_path():
    """u_len 0: -log of the product of the blank's probability over the
    row's frames."""
    logits = _f(1, 4, 3)
    fetch, ref, got = _one_op_both(
        "warpctc", {"Logits": logits, "Label": np.array([[2]], np.int64),
                    "LabelLen": np.array([0], np.int64)}, {"blank": 0},
        outs=("Loss",), grad=["Logits"])
    _close(fetch, ref, got)
    logp = torch.log_softmax(torch.from_numpy(logits), -1).numpy()
    np.testing.assert_allclose(got[0][0, 0], -logp[0, :, 0].sum(),
                               rtol=1e-6)


@pytest.mark.parametrize("normalized", [True, False])
def test_edit_distance_layer(normalized):
    hyp = RNG.randint(1, 5, (5, 7)).astype(np.int64)
    ref = RNG.randint(1, 5, (5, 6)).astype(np.int64)
    ref[1] = hyp[1, :6]                         # distance 0 at full length
    hl = np.array([7, 6, 3, 0, 5], np.int64)
    rl = np.array([6, 6, 0, 4, 2], np.int64)

    def build(pkg):
        L = pkg.layers
        d, n = L.edit_distance(
            _x(L, "hyp", hyp.shape, "int64", True),
            _x(L, "ref", ref.shape, "int64", True), normalized=normalized,
            input_length=_x(L, "hl", hl.shape, "int64", True),
            label_length=_x(L, "rl", rl.shape, "int64", True))
        return None, [d.name, n.name]
    out = run_both(build, {"hyp": hyp, "ref": ref, "hl": hl, "rl": rl})
    assert out[0][1, 0] == 0.0 and out[1][0] == 5
    # a row with nothing to match costs the other's length
    assert out[0][3, 0] == (1.0 if normalized else 4.0)


def test_edit_distance_matches_a_plain_levenshtein():
    def lev(a, b):
        d = list(range(len(b) + 1))
        for i, x in enumerate(a, 1):
            prev, d[0] = d[0], i
            for j, y in enumerate(b, 1):
                prev, d[j] = d[j], min(d[j] + 1, d[j - 1] + 1,
                                       prev + (x != y))
        return d[-1]

    hyp = RNG.randint(0, 3, (24, 6)).astype(np.int64)
    ref = RNG.randint(0, 3, (24, 5)).astype(np.int64)
    hl = RNG.randint(0, 7, 24).astype(np.int64)
    rl = RNG.randint(0, 6, 24).astype(np.int64)
    rule = tregistry.get_op_def("edit_distance").lower
    got = rule(tregistry.LoweringContext({}, "cpu"), torch.from_numpy(hyp),
               torch.from_numpy(ref), torch.from_numpy(hl),
               torch.from_numpy(rl))["Out"][:, 0].numpy()
    want = [lev(h[:a], r[:b]) for h, r, a, b in zip(hyp, ref, hl, rl)]
    np.testing.assert_array_equal(got, want)


def _nce_formula(x, w, b, labels, n_true, num_neg, V, sample_weight=None):
    """The JAX rule's Cost and SampleLogits, evaluated with jnp on the
    port's SampleLabels."""
    import jax
    import jax.numpy as jnp
    ids = jnp.asarray(labels.astype(np.int32))
    logit = jnp.einsum("bd,bkd->bk", x, jnp.take(w, ids, axis=0))
    if b is not None:
        logit = logit + jnp.take(b.reshape(-1), ids)
    shift = np.log(num_neg) + np.log(1.0 / V)
    cost = (jnp.sum(jax.nn.softplus(-(logit[:, :n_true] - shift)), 1)
            + jnp.sum(jax.nn.softplus(logit[:, n_true:] - shift), 1))
    if sample_weight is not None:
        cost = cost * sample_weight.reshape(-1)
    return np.asarray(cost)[:, None], np.asarray(logit)


def test_nce_layer_against_the_jax_formula():
    """Both packages build the same Program; the port's Cost and
    SampleLogits are the JAX formula's on its own SampleLabels (two true
    ids a row, a bias, sample weights), and the Weight grad reaches only
    the sampled rows."""
    from paddle_tpu_torch.core.backward import append_backward
    x = _f(6, 5)
    label = RNG.randint(0, 40, (6, 2)).astype(np.int64)
    sw = _f(6, 1, lo=0.5, hi=1.5)

    def build(pkg):
        L = pkg.layers
        cost = L.nce(_x(L, "x", x.shape), _x(L, "label", label.shape,
                                             "int64", True),
                     num_total_classes=40, num_neg_samples=7,
                     sample_weight=_x(L, "sw", sw.shape, stop_gradient=True),
                     param_attr=pkg.ParamAttr(name="nce_w"),
                     bias_attr=pkg.ParamAttr(name="nce_b"))
        return L.mean(cost), cost

    progs = {}
    for name, pkg in (("jax", fluid), ("port", ptt)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            loss, cost = build(pkg)
        progs[name] = (main, startup, loss, cost)
    jmain, jstart = progs["jax"][:2]
    tmain, tstart, tloss, tcost = progs["port"]
    from test_torch_breadth import _int64_as_port
    assert tmain.to_dict() == _int64_as_port(jmain.to_dict(), tmain)
    with ptt.program_guard(tmain, tstart):
        append_backward(tloss)
    op = [o for o in tmain.global_block().ops if o.type == "nce"][0]
    logits_v, labels_v = op.output("SampleLogits")[0], op.output(
        "SampleLabels")[0]
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(tstart, scope=scope)
    w = np.array(ptt.fetch_var("nce_w", scope))
    b = np.array(ptt.fetch_var("nce_b", scope))
    cost, logits, labels, gw = exe.run(
        tmain, feed={"x": x, "label": label, "sw": sw},
        fetch_list=[tcost, logits_v, labels_v, "nce_w@GRAD"], scope=scope)
    assert labels.dtype == np.int64
    np.testing.assert_array_equal(labels[:, :2], label)
    want_cost, want_logits = _nce_formula(x, w, b, labels, 2, 7, 40, sw)
    np.testing.assert_allclose(logits, want_logits, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cost, want_cost, rtol=1e-5, atol=1e-6)
    touched = np.zeros(40, bool)
    touched[labels.reshape(-1)] = True
    assert np.abs(gw[~touched]).max() == 0 and np.abs(gw[touched]).min() > 0


# ---------------------------------------------------------------------------
# the evaluators
# ---------------------------------------------------------------------------

def _evaluate(pkg, make, batches, fetch_of):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        ev = make(pkg)
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    for feed in batches:
        vals = exe.run(main, feed=feed, fetch_list=ev.metrics, scope=scope)
        ev.update(*fetch_of(vals))
    return ev.eval()


def test_chunk_evaluator():
    def make(pkg):
        L = pkg.layers
        return pkg.evaluator.ChunkEvaluator(
            _seq(L, "inf", [1], "int64"), _seq(L, "lab", [1], "int64"),
            chunk_scheme="IOB", num_chunk_types=3)

    batches = []
    for _ in range(3):
        inf = RNG.randint(0, 7, (4, 8, 1)).astype(np.int64)
        lab = np.where(RNG.rand(4, 8, 1) < 0.7, inf,
                       RNG.randint(0, 7, (4, 8, 1))).astype(np.int64)
        lens = RNG.randint(1, 9, 4).astype(np.int32)
        batches.append({"inf": (inf, lens), "lab": (lab, lens)})
    got = _evaluate(ptt, make, batches, lambda v: v)
    want = _evaluate(fluid, make, batches, lambda v: v)
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-6)
    assert 0 < got[2] < 1


def test_edit_distance_evaluator():
    def make(pkg):
        L = pkg.layers
        return pkg.evaluator.EditDistance(
            _x(L, "hyp", (4, 6), "int64", True),
            _x(L, "ref", (4, 6), "int64", True))

    batches = [{"hyp": RNG.randint(1, 4, (4, 6)).astype(np.int64),
                "ref": RNG.randint(1, 4, (4, 6)).astype(np.int64)}
               for _ in range(3)]
    got = _evaluate(ptt, make, batches, lambda v: v)
    want = _evaluate(fluid, make, batches, lambda v: v)
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-6)
