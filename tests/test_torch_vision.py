"""paddle_tpu_torch's vision slice against paddle_tpu, on the CPU.

The op rules that ResNet-50 and the MNIST CNN add to the port (`conv2d`,
`pool2d`, `batch_norm`, `softmax`, `cross_entropy`, `top_k`, `accuracy`,
`momentum`), their generic grads (each forward rule recomputed under
autograd), `optimizer.Momentum`, the layers, `nets.simple_img_conv_pool`
and both models are held against the JAX package on the same numpy
inputs and parameters. No Pallas kernel lies on this path; convs and
pools are torch's own here and XLA's in the JAX package. The card runs
them through cuDNN in tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: 1e-4 for one op and its grads in float32 (summation order
of the convs and reductions); after training steps, 1e-4 relative on
the losses and 1e-4 absolute on every persistable (and 1e-4 relative on
ResNet-50's, whose running variances reach the hundreds).

One documented difference: `top_k`'s `Indices` are int64 in the port
(``paddle_tpu_torch/core/types.py``), where the JAX package, in x32
mode, makes them int32. The programs' JSON differ in that var's dtype
and nowhere else (`test_programs_are_the_same_in_both_packages`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import registry as jregistry
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.models import resnet as jresnet

import paddle_tpu_torch as ptt
from paddle_tpu_torch import optimizer as toptimizer
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.core.executor import fetch_var
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.ops import native

TOL = 1e-4
# the op types this slice registers in the port; before it the port had 25
NEW_OPS = {"conv2d", "pool2d", "batch_norm", "softmax", "cross_entropy",
           "top_k", "accuracy", "momentum"}
EARLIER_OPS = {
    "adam", "cast", "dropout", "elementwise_add", "fill_constant",
    "fused_attention", "gather_last_token", "gaussian_random", "layer_norm",
    "lookup_table", "matmul", "mean", "mul", "paged_attention",
    "paged_attention_q8", "prefill_attention", "prefill_attention_q8",
    "relu", "reshape", "scale", "sinusoid_pos_encoding",
    "softmax_with_cross_entropy", "sum", "transpose", "uniform_random"}
# the op types later slices register (optimizers, schedules, clips, the
# rest of the non-recurrent zoo, the sequence and recurrent ops, control
# flow, tensor arrays and beam search, the data plane's `load` and
# `square_error_cost`, the book's `cos_sim`, `linear_chain_crf` and
# `crf_decoding`, and the common op breadth: activations, reductions,
# tensor, loss and vision ops and `auc`); each has its parity case in
# tests/test_torch_zoo.py, tests/test_torch_optim.py,
# tests/test_torch_seq.py, tests/test_torch_control.py,
# tests/test_torch_data.py, tests/test_torch_book.py,
# tests/test_torch_parity_table.py or tests/test_torch_breadth.py; the
# rest of the op families (structured ops, detection, quantization) in
# tests/test_torch_structured.py, tests/test_torch_detection.py and
# tests/test_torch_quant.py; fluid-wire's op in tests/test_torch_wire.py
LATER_OPS = {
    "elementwise_sub", "elementwise_mul", "elementwise_div",
    "elementwise_min", "elementwise_max", "elementwise_pow", "exp", "sqrt",
    "square", "sigmoid", "reduce_sum", "clip", "clip_by_norm", "less_than",
    "greater_equal", "concat", "increment", "assign", "causal_mask",
    "sigmoid_cross_entropy_with_logits", "sgd", "adamax", "adagrad",
    "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "proximal_gd",
    "proximal_adagrad", "average_accumulates",
    "sequence_pool", "sequence_softmax", "sequence_expand",
    "sequence_reshape", "sequence_concat", "sequence_slice",
    "sequence_conv", "sequence_erase", "sequence_expand_as", "row_conv",
    "sequence_mask", "lstm", "gru", "lstm_unit", "gru_unit", "lstmp",
    "while", "bounded_while", "static_rnn", "dynamic_rnn",
    "conditional_block", "if_else", "select_input", "array_write",
    "array_read", "array_length", "lod_rank_table", "max_sequence_len",
    "lod_tensor_to_array", "array_to_lod_tensor", "shrink_memory",
    "reorder_lod_tensor_by_rank", "tile_beam", "beam_search_step",
    "beam_backtrack", "fill_constant_batch_size_like", "assign_value",
    "squeeze", "unsqueeze", "split", "slice", "batch_gather", "is_empty",
    "print", "log_softmax", "tanh", "floor", "ceil", "equal", "not_equal",
    "less_equal", "greater_than", "logical_and", "logical_or",
    "logical_xor", "logical_not", "load", "square_error_cost", "cos_sim",
    "linear_chain_crf", "crf_decoding",
    "abs", "arg_max", "arg_min", "brelu", "cos", "cumsum",
    "elementwise_floordiv", "elementwise_mod", "elu", "gelu", "hard_shrink",
    "hard_sigmoid", "isfinite", "l2_normalize", "leaky_relu", "log",
    "logsigmoid", "maximum", "pow", "prelu", "reciprocal", "reduce_max",
    "reduce_mean", "reduce_min", "reduce_prod", "relu6", "round", "rsqrt",
    "sign", "sin", "soft_relu", "softplus", "softshrink", "softsign",
    "swish", "tanh_shrink", "thresholded_relu",
    "argsort", "expand", "expand_dims_tile", "flatten", "gather",
    "gather_nd", "one_hot", "pad", "pad2d", "range", "reverse", "scatter",
    "shape", "stack", "unstack", "truncated_gaussian_random",
    "uniform_random_batch_size_like",
    "smooth_l1_loss", "huber_loss", "log_loss", "rank_loss",
    "margin_rank_loss", "hinge_loss", "auc",
    "conv2d_transpose", "depthwise_conv2d", "grid_sampler", "lrn",
    "conv3d", "conv3d_transpose", "pool3d", "bilinear_interp", "crop",
    "random_crop", "label_smooth", "multiplex", "mean_iou", "roi_pool",
    "ctc_greedy_decoder", "lod_reset", "chunk_eval", "im2sequence", "nce",
    "hierarchical_sigmoid", "warpctc", "edit_distance",
    "prior_box", "anchor_generator", "iou_similarity", "box_coder",
    "bipartite_match", "target_assign", "multiclass_nms",
    "mine_hard_examples", "polygon_box_transform", "box_encode_per_prior",
    "greater_equal_scalar0", "smooth_l1_elementwise",
    "softmax_ce_no_reduce", "rpn_target_assign", "detection_map",
    "fake_quantize_abs_max", "fake_quantize_range_abs_max",
    "fake_dequantize_max_abs", "comm_quant_dequant"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small CPU ops run far faster on one thread than on a pool that
    several test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# op rules and their grads against paddle_tpu
# ---------------------------------------------------------------------------

def _build_jax(build):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss = build(fluid)
        fluid.backward.append_backward(loss)
    return main, startup


def _run_both(case):
    """Build `case` with paddle_tpu, append its backward, load the same
    Program JSON into the port, start both from the JAX startup's
    parameters (with the case's own values set into both), run one step
    of each and return both fetch lists (grads as `<name>@GRAD`)."""
    main, startup = _build_jax(case.build)
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(startup, scope=jscope)
    for n, v in case.params.items():
        jscope.set_var(n, jnp.asarray(v))
    arrays = {n: np.asarray(jscope.find_var(n))
              for n in jscope.local_var_names()}
    fetch = case.fetch(main)
    ref = jexe.run(main, feed=case.feed, fetch_list=fetch, scope=jscope)
    native.reset_launches()
    got = ptt.Executor(ptt.CPUPlace()).run(
        ptt.Program.from_dict(main.to_dict()), feed=case.feed,
        fetch_list=fetch, scope=ptt.io.state_from_numpy(arrays,
                                                         ptt.CPUPlace()))
    assert not any(native.launches.values())
    return fetch, [np.asarray(r) for r in ref], got


def _head(pkg, out):
    """mean(out @ w) for a Xavier-initialized w: a random cotangent."""
    return pkg.layers.mean(pkg.layers.fc(out, 1, num_flatten_dims=len(
        out.shape) - 1, bias_attr=False, param_attr="head_w"))


def _x(pkg, shape, name="x", stop_gradient=False, dtype="float32"):
    return pkg.layers.data(name, shape=list(shape), dtype=dtype,
                           append_batch_size=False,
                           stop_gradient=stop_gradient)


def _outputs(op_type, *slots):
    """Fetch names: the `slots` outputs of the program's first `op_type`
    op."""
    def fetch(main):
        op = next(o for o in main.global_block().ops if o.type == op_type)
        return [op.outputs[s][0] for s in slots]
    return fetch


class Case:
    """An op parity case: `build(pkg)` returns the loss, `fetch(main)`
    the names to compare, `params` values set over the startup's."""

    def __init__(self, build, feed, fetch, params=None):
        self.build, self.feed, self.fetch = build, feed, fetch
        self.params = params or {}


def _conv_case(fmt, bias):
    x = np.random.RandomState(1).randn(2, 4, 9, 9).astype(np.float32)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))

    def build(pkg):
        out = pkg.layers.conv2d(_x(pkg, x.shape), num_filters=6,
                                filter_size=3, stride=2, padding=1,
                                dilation=2, groups=2, param_attr="conv_w",
                                bias_attr="conv_b" if bias else False,
                                act="relu", data_format=fmt)
        return _head(pkg, out)

    grads = ["x@GRAD", "conv_w@GRAD"] + (["conv_b@GRAD"] if bias else [])
    params = {"conv_b": np.linspace(-0.5, 0.5, 6).astype(np.float32)} \
        if bias else {}
    return Case(build, {"x": x},
                lambda m: _outputs("conv2d", "Output")(m) + grads, params)


def _pool_case(fmt, kind):
    x = np.random.RandomState(2).randn(2, 3, 8, 8).astype(np.float32)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    kw = {"max": dict(pool_size=3, pool_type="max", pool_stride=2,
                      pool_padding=1),
          "avg_exclusive": dict(pool_size=3, pool_type="avg", pool_stride=2,
                                pool_padding=1, exclusive=True),
          "avg_inclusive": dict(pool_size=3, pool_type="avg", pool_stride=2,
                                pool_padding=1, exclusive=False),
          "global_avg": dict(pool_type="avg", global_pooling=True),
          "global_max": dict(pool_type="max", global_pooling=True),
          "adaptive_avg": dict(pool_size=2, pool_type="avg", adaptive=True),
          # pads wider than half the window: torch's pools refuse them,
          # the rule pads explicitly
          "max_wide_pad": dict(pool_size=2, pool_type="max", pool_stride=1,
                               pool_padding=2),
          "avg_wide_pad": dict(pool_size=2, pool_type="avg", pool_stride=1,
                               pool_padding=2, exclusive=True)}[kind]

    def build(pkg):
        out = pkg.layers.pool2d(_x(pkg, x.shape), data_format=fmt, **kw)
        return _head(pkg, out)

    return Case(build, {"x": x},
                lambda m: _outputs("pool2d", "Out")(m) + ["x@GRAD"])


def _batch_norm_case(fmt, is_test):
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 5, 6, 6) * 2.0 + 0.7).astype(np.float32)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    params = {"bn_s": rng.uniform(0.5, 1.5, 5).astype(np.float32),
              "bn_b": rng.randn(5).astype(np.float32),
              "bn_m": rng.randn(5).astype(np.float32),
              "bn_v": rng.uniform(0.5, 2.0, 5).astype(np.float32)}

    def build(pkg):
        y = pkg.layers.batch_norm(_x(pkg, x.shape), is_test=is_test,
                                  param_attr="bn_s", bias_attr="bn_b",
                                  moving_mean_name="bn_m",
                                  moving_variance_name="bn_v",
                                  data_layout=fmt)
        return _head(pkg, y)

    return Case(build, {"x": x},
                lambda m: _outputs("batch_norm", "Y", "MeanOut",
                                   "VarianceOut", "SavedMean",
                                   "SavedVariance")(m)
                + ["x@GRAD", "bn_s@GRAD", "bn_b@GRAD"], params)


def _softmax_case():
    x = np.random.RandomState(4).randn(2, 6, 8).astype(np.float32)

    def build(pkg):
        return _head(pkg, pkg.layers.softmax(_x(pkg, x.shape)))

    return Case(build, {"x": x},
                lambda m: _outputs("softmax", "Out")(m) + ["x@GRAD"])


def _cross_entropy_case(kind):
    rng = np.random.RandomState(5)
    p = rng.rand(8, 7).astype(np.float32) + 0.05
    p /= p.sum(-1, keepdims=True)
    label = rng.randint(0, 7, (8, 1)).astype(np.int64)
    p[0, label[0, 0]] = 1e-9            # below the 1e-8 clamp
    if kind == "ignore_index":
        label[[2, 5], 0] = -100
    feed = {"x": p, "label": label}
    if kind == "soft_label":
        soft = rng.rand(8, 7).astype(np.float32)
        feed["label"] = soft / soft.sum(-1, keepdims=True)

    def build(pkg):
        lab = _x(pkg, feed["label"].shape, "label", stop_gradient=True,
                 dtype="float32" if kind == "soft_label" else "int64")
        return _head(pkg, pkg.layers.cross_entropy(
            _x(pkg, p.shape), lab, soft_label=kind == "soft_label"))

    return Case(build, feed,
                lambda m: _outputs("cross_entropy", "Y")(m) + ["x@GRAD"])


def _top_k_accuracy_case(k):
    rng = np.random.RandomState(6)
    x = rng.randn(8, 10).astype(np.float32)
    label = rng.randint(0, 10, (8, 1)).astype(np.int64)
    label[:3, 0] = x[:3].argmax(-1)     # some rows right at k = 1

    def build(pkg):
        xv = _x(pkg, x.shape)
        vals, _ = pkg.layers.topk(xv, k)
        pkg.layers.accuracy(xv, _x(pkg, label.shape, "label", True,
                                   "int64"), k=k)
        return _head(pkg, vals)

    def fetch(main):
        return (_outputs("top_k", "Out", "Indices")(main)
                + _outputs("accuracy", "Accuracy", "Correct", "Total")(main)
                + ["x@GRAD"])

    return Case(build, {"x": x, "label": label}, fetch)


OP_CASES = {
    **{f"conv2d-{fmt}-{'bias' if b else 'nobias'}": _conv_case(fmt, b)
       for fmt in ("NCHW", "NHWC") for b in (True, False)},
    **{f"pool2d-{fmt}-{kind}": _pool_case(fmt, kind)
       for fmt in ("NCHW", "NHWC")
       for kind in ("max", "avg_exclusive", "avg_inclusive", "global_avg",
                    "global_max", "adaptive_avg", "max_wide_pad",
                    "avg_wide_pad")},
    **{f"batch_norm-{fmt}-{'test' if t else 'train'}": _batch_norm_case(fmt, t)
       for fmt in ("NCHW", "NHWC") for t in (False, True)},
    "softmax": _softmax_case(),
    **{f"cross_entropy-{kind}": _cross_entropy_case(kind)
       for kind in ("hard_label", "ignore_index", "soft_label")},
    **{f"top_k-accuracy-k{k}": _top_k_accuracy_case(k) for k in (1, 3)},
}


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_rule_and_grad_match_paddle_tpu(name):
    fetch, ref, got = _run_both(OP_CASES[name])
    for n, a, b in zip(fetch, got, ref):
        assert a.shape == b.shape, n
        if n.startswith("top_k") and n.endswith(".tmp_1"):     # Indices
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=n)
            assert a.dtype == np.int64 and b.dtype == np.int32
            continue
        assert a.dtype == b.dtype, n
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL, err_msg=n)


def test_batch_norm_updates_its_running_stats_once_and_in_place():
    """The forward op updates Mean and Variance in place by the biased
    batch variance; its grad op's recompute does not update them again."""
    case = _batch_norm_case("NHWC", is_test=False)
    main, startup = _build_jax(case.build)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(ptt.Program.from_dict(startup.to_dict()), scope=scope)
    ptt.io.state_from_numpy(case.params, ptt.CPUPlace(), scope)
    before = {n: scope.find_var(n) for n in ("bn_m", "bn_v")}
    prog = ptt.Program.from_dict(main.to_dict())
    assert "batch_norm_grad" in {op.type for op in prog.global_block().ops}
    exe.run(prog, feed=case.feed, scope=scope)
    x = case.feed["x"].reshape(-1, 5).astype(np.float64)
    for n, stat in (("bn_m", x.mean(0)), ("bn_v", x.var(0))):
        assert scope.find_var(n) is before[n]
        np.testing.assert_allclose(fetch_var(n, scope),
                                   0.9 * case.params[n] + 0.1 * stat,
                                   rtol=1e-5, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_update_matches_paddle_tpu(nesterov):
    x = np.random.RandomState(11).randn(4, 8).astype(np.float32)

    def build(pkg, opt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            loss = pkg.layers.mean(pkg.layers.fc(
                pkg.layers.data("x", shape=[8], dtype="float32"), 3))
            opt.Momentum(learning_rate=0.05, momentum=0.9,
                         use_nesterov=nesterov).minimize(loss)
        return main, startup

    jmain, jstartup = build(fluid, fluid.optimizer)
    tmain, _ = build(ptt, toptimizer)
    assert tmain.to_dict() == jmain.to_dict()
    assert "momentum" in {op.type for op in tmain.global_block().ops}
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    names = list(jscope.local_var_names())
    tscope = ptt.io.state_from_numpy(
        {n: np.asarray(jscope.find_var(n)) for n in names}, ptt.CPUPlace())
    before = {n: tscope.find_var(n) for n in names}
    texe = ptt.Executor(ptt.CPUPlace())
    for step in range(2):                  # the second reads a velocity
        jexe.run(jmain, feed={"x": x * (step + 1)}, scope=jscope)
        texe.run(tmain, feed={"x": x * (step + 1)}, scope=tscope)
    for n in names:
        assert tscope.find_var(n) is before[n]      # updated in place
        np.testing.assert_allclose(fetch_var(n, tscope),
                                   np.asarray(jscope.find_var(n)),
                                   atol=1e-5, rtol=1e-5, err_msg=n)


def test_every_port_op_is_a_reference_op_and_every_new_one_has_a_case():
    """The registry contract: the port registers only ops the JAX package
    registers, all 226 of them; the ops this slice adds are exactly NEW_OPS,
    and each one appears in a program of this file's parity cases."""
    ported = set(tregistry.registered_ops())
    assert ported <= set(jregistry.registered_ops())
    assert len(EARLIER_OPS) == 25 and len(LATER_OPS) == 193
    assert len(ported) == 226
    assert ported - EARLIER_OPS - LATER_OPS == NEW_OPS
    assert EARLIER_OPS | LATER_OPS <= ported
    covered = set()
    for case in OP_CASES.values():
        covered |= {op.type for op in _build_jax(case.build)[0]
                    .global_block().ops}
    covered.add("momentum")     # test_momentum_update_matches_paddle_tpu
    assert NEW_OPS <= covered


# ---------------------------------------------------------------------------
# the slice: the MNIST CNN with Adam, ResNet-50 with Momentum
# ---------------------------------------------------------------------------

def _model(pkg, model, opt, **kw):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, fetches = model.build(**kw)
        opt(pkg.optimizer).minimize(fetches["loss"])
    return main, startup, fetches


def _adam(o):
    return o.Adam(learning_rate=1e-3)


def _momentum(o):
    return o.Momentum(learning_rate=1e-3, momentum=0.9)


def _index_dtypes_as_port(program_dict):
    """The JAX package's program dict with its top_k `Indices` vars
    declared int64, as the port declares them (the module docstring)."""
    idx = {op["outputs"]["Indices"][0]
           for b in program_dict["blocks"] for op in b["ops"]
           if op["type"] == "top_k"}
    for b in program_dict["blocks"]:
        for v in b["vars"]:
            if v["name"] in idx:
                assert v["dtype"] == "int32"
                v["dtype"] = "int64"
    return program_dict


@pytest.mark.parametrize("name", ["mnist", "resnet50-NCHW", "resnet50-NHWC"])
def test_programs_are_the_same_in_both_packages(name):
    if name == "mnist":
        args = (jmnist, tmnist, _adam, {})
    else:
        args = (jresnet, tresnet, _momentum,
                dict(data_format=name.split("-")[1]))
    jmain, jstartup, _ = _model(fluid, args[0], args[2], **args[3])
    tmain, tstartup, _ = _model(ptt, args[1], args[2], **args[3])
    assert tmain.to_dict() == _index_dtypes_as_port(jmain.to_dict())
    assert tstartup.to_dict() == jstartup.to_dict()
    types = [op.type for op in tmain.global_block().ops]
    if name == "mnist":
        assert {"conv2d", "pool2d", "softmax", "cross_entropy", "top_k",
                "accuracy", "adam", "conv2d_grad", "pool2d_grad"} <= set(types)
    else:
        assert len(types) == 536
        assert types.count("conv2d") == 53 and types.count("batch_norm") == 53
        assert types.count("momentum") == 161
        assert "batch_norm_grad" in types


def _train_both(jprog, tprog, feeds, fetch_names):
    """Run the JAX program and the port's on the same feeds from the JAX
    startup's state; returns (ref, got) fetch lists a step and both
    scopes."""
    jmain, jstartup = jprog
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    arrays = {n: np.asarray(jscope.find_var(n))
              for n in jscope.local_var_names()}
    tscope = ptt.io.state_from_numpy(arrays, ptt.CPUPlace())
    texe = ptt.Executor(ptt.CPUPlace())
    steps = []
    native.reset_launches()
    for feed in feeds:
        ref = jexe.run(jmain, feed=feed, fetch_list=fetch_names, scope=jscope)
        got = texe.run(tprog, feed=feed, fetch_list=fetch_names, scope=tscope)
        steps.append(([np.asarray(r) for r in ref], got))
    assert not any(native.launches.values())
    return steps, arrays, jscope, tscope


def test_mnist_cnn_trains_like_paddle_tpu():
    """5 Adam steps at batch 8 from the JAX startup's parameters."""
    jmain, jstartup, jf = _model(fluid, jmnist, _adam)
    tmain, _, tf = _model(ptt, tmnist, _adam)
    rng = np.random.RandomState(12)
    feeds = [{"pixel": rng.rand(8, 1, 28, 28).astype(np.float32),
              "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}
             for _ in range(5)]
    steps, arrays, jscope, tscope = _train_both(
        (jmain, jstartup), tmain, feeds, [tf["loss"].name, tf["acc"].name])
    for ref, got in steps:
        assert got[0] > 0.1             # far from the clamp (module doc)
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-4, atol=0)
        np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-6)
    for n in arrays:
        np.testing.assert_allclose(fetch_var(n, tscope),
                                   np.asarray(jscope.find_var(n)),
                                   atol=1e-4, rtol=0, err_msg=n)


def test_resnet50_steps_like_paddle_tpu():
    """Depth 50 at 32 x 32, NHWC, batch 16, 100 classes, Momentum(1e-3,
    0.9): three steps, each from the JAX package's state after the one
    before (a teacher-forced run), against that package's same step.

    Why not batch 4 and a free run of 3 steps: ResNet-50 at 32 x 32 is
    ill-conditioned in float32. Its last stage is 1 x 1, so each batch
    norm there normalizes over the batch alone, and one ReLU whose input
    lies within rounding of 0 moves whole rows of the grads.
    `tools/resnet_float32_sensitivity.py` measures it on the JAX package
    alone, on a CPU: scaling the stem's filter by (1 + 1e-7) moves its
    own step-1 loss by 2.8e-4 at batch 4 (6.9e-6 at 16), its step-2 loss
    by 13 % (3.3 % at 16), and its grads by 1.7 % (median over the 161,
    relative L2, batch 16; the largest 3.1 %). So per step: the loss to
    1e-4 relative, every running mean and variance to 1e-4, and every
    velocity (the step's grad) within 0.1 relative L2 of the JAX one;
    the well-conditioned ResNet below holds every persistable to 1e-4
    over a free run."""
    kw = dict(class_dim=100, depth=50, image_shape=(3, 32, 32),
              data_format="NHWC")
    jmain, jstartup, jf = _model(fluid, jresnet, _momentum, **kw)
    tmain, _, tf = _model(ptt, tresnet, _momentum, **kw)
    stats = {op.inputs[s][0] for op in tmain.global_block().ops
             if op.type == "batch_norm" for s in ("Mean", "Variance")}
    rng = np.random.RandomState(13)
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    names = list(jscope.local_var_names())
    velocities = [n for n in names if "velocity" in n]
    assert len(stats) == 106 and stats <= set(names)
    assert len(velocities) == 161
    texe = ptt.Executor(ptt.CPUPlace())
    native.reset_launches()
    for _ in range(3):
        feed = {"image": rng.rand(16, 32, 32, 3).astype(np.float32),
                "label": rng.randint(0, 100, (16, 1)).astype(np.int64)}
        tscope = ptt.io.state_from_numpy(
            {n: np.asarray(jscope.find_var(n)) for n in names},
            ptt.CPUPlace())
        ref, = jexe.run(jmain, feed=feed, fetch_list=[jf["loss"]],
                        scope=jscope)
        got, = texe.run(tmain, feed=feed, fetch_list=[tf["loss"].name],
                        scope=tscope)
        assert got[0] > 0.1             # far from the clamp (module doc)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=0)
        for n in stats:
            np.testing.assert_allclose(fetch_var(n, tscope),
                                       np.asarray(jscope.find_var(n)),
                                       atol=1e-4, rtol=1e-4, err_msg=n)
        for n in velocities:
            want = np.asarray(jscope.find_var(n))
            err = np.linalg.norm(fetch_var(n, tscope) - want)
            assert err <= 0.1 * np.linalg.norm(want), n
    assert not any(native.launches.values())


def _resnet_cifar10(pkg, model):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        image = pkg.layers.data("image", shape=[32, 32, 3], dtype="float32")
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        predict = model.resnet_cifar10(image, class_dim=10, depth=8,
                                       data_format="NHWC")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(predict, label))
        _momentum(pkg.optimizer).minimize(loss)
    return main, startup, loss


def test_resnet_cifar10_trains_like_paddle_tpu():
    """`resnet_cifar10` at depth 8 (conv_bn_layer, shortcut, basicblock,
    layer_warp), NHWC, batch 8, Momentum(1e-3, 0.9): a free run of 3
    steps. Its last stage keeps 8 x 8 positions a channel for each of the
    8 images, so it is well conditioned: losses to 1e-4 relative, every
    parameter, velocity and running stat to 1e-4."""
    jmain, jstartup, jloss = _resnet_cifar10(fluid, jresnet)
    tmain, _, tloss = _resnet_cifar10(ptt, tresnet)
    assert tmain.to_dict() == jmain.to_dict()
    rng = np.random.RandomState(14)
    feeds = [{"image": rng.rand(8, 32, 32, 3).astype(np.float32),
              "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}
             for _ in range(3)]
    steps, arrays, jscope, tscope = _train_both(
        (jmain, jstartup), tmain, feeds, [tloss.name])
    for ref, got in steps:
        assert got[0] > 0.1
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-4, atol=0)
    assert sum("velocity" in n for n in arrays) == 29   # 9 convs, 9 BNs, fc
    for n in arrays:
        np.testing.assert_allclose(fetch_var(n, tscope),
                                   np.asarray(jscope.find_var(n)),
                                   atol=1e-4, rtol=1e-4, err_msg=n)
