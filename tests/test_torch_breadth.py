"""paddle_tpu_torch's common op breadth and API surface against
paddle_tpu, on the CPU.

The three grad repairs first: `clip`, `clip_by_norm` and
`sigmoid_cross_entropy_with_logits` give the JAX package's grads where
an input sits exactly on a kink (the inputs that showed the faults), and
their forward values are unchanged. Then every layer this slice adds is
built with each package's layers (the Programs held equal, the port's
int64 index outputs aside), started from the JAX startup's state
(`io.state_from_numpy`) and run one step: the forward and every grad to
TOL. Then the edges the parity table's spec inputs do not reach: `auc`
over several batches, `scatter` with repeated ids, `argsort` ties,
`one_hot` out of range, `elementwise_mod` / `floordiv` on negative
operands, `round` at halves, `reduce_prod` with zeros, `pad2d`'s three
modes, `grid_sampler` at and beyond the grid's edges, `cumsum`'s
`exclusive` and `reverse`, `prelu`'s modes, `conv2d_transpose` over the
sweep's k / p / s / d cases and `depthwise_conv2d` in NHWC. Then the rest
of the API: the random ops' and initializers' draws, the exact
initializers, `save_params` / `load_params`, `get_inference_program`,
`Operator`, `enforce`, `default_scope_funcs`, `graphviz` and
`net_drawer`, and the names both packages export.
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.layer_helper import LayerHelper as JLayerHelper

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.backward import append_backward as tappend_backward
from paddle_tpu_torch.layer_helper import LayerHelper as TLayerHelper
from paddle_tpu_torch.ops import native

from test_torch_parity_table import _run_port, one_op_program, sweep

TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# 0. the repaired grads at their kinks
# ---------------------------------------------------------------------------

def _one_op_both(op_type, inputs, attrs, outs=("Out",), grad=None):
    """The parity table's one-op program (op, cast, mean, backward) run by
    both packages; returns (fetch names, JAX results, port results)."""
    spec = sweep.Spec(inputs=inputs, attrs=attrs, outs=outs, grad=grad)
    main, feed, fetch, _ = one_op_program(op_type, spec)
    ref = [np.asarray(r) for r in fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch, scope=fluid.Scope())]
    return fetch, ref, _run_port(main.serialize_to_string(), feed, fetch)


def test_clip_grad_splits_at_its_bounds_as_jnp_clip():
    x = np.array([[0, 6, 3, -1], [7, 0, 6, 2]], np.float32)
    fetch, ref, got = _one_op_both("clip", {"X": x},
                                   {"min": 0.0, "max": 6.0})
    gx = fetch.index("in_X_0@GRAD")
    # 1/8 inside, half that at 0 and 6, 0 outside
    np.testing.assert_array_equal(
        ref[gx], np.array([[1, 1, 2, 0], [0, 1, 1, 2]], np.float32) / 16)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)


def test_clip_by_norm_grad_at_a_norm_of_max_norm():
    fetch, ref, got = _one_op_both("clip_by_norm",
                                   {"X": np.array([[3, 4]], np.float32)},
                                   {"max_norm": 5.0})
    gx = fetch.index("in_X_0@GRAD")
    np.testing.assert_allclose(ref[gx], [[0.29, 0.22]], atol=5e-3)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-7)


def test_sigmoid_cross_entropy_grad_at_zero_logits():
    fetch, ref, got = _one_op_both(
        "sigmoid_cross_entropy_with_logits",
        {"X": np.array([[0, 0.5], [0, -2]], np.float32),
         "Label": np.array([[1, 0], [0, 1]], np.float32)}, {}, grad=["X"])
    gx = fetch.index("in_X_0@GRAD")
    np.testing.assert_allclose(ref[gx], [[-0.25, 0.1556], [0, -0.2202]],
                               atol=1e-4)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("op_type,attrs", [
    ("clip", {"min": 0.0, "max": 6.0}),
    ("clip_by_norm", {"max_norm": 5.0}),
    ("sigmoid_cross_entropy_with_logits", {})])
def test_repaired_forward_values_did_not_move(op_type, attrs):
    """The repairs change grads only: each forward equals the rule as it
    was (torch.clamp and torch.abs), bit for bit, in float32 and bf16."""
    from paddle_tpu_torch.core import registry, types
    g = torch.Generator().manual_seed(3)
    x = torch.randn(64, 33, generator=g) * 4
    x[::3] = 0.0
    x[1::5] = 6.0
    label = (torch.rand(64, 33, generator=g) > 0.5).float()
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        ctx = registry.LoweringContext(attrs, "cpu")
        rule = registry.get_op_def(op_type).lower
        if op_type == "clip":
            got = rule(ctx, xd)["Out"]
            want = torch.clamp(xd, types.scalar_as(0.0, dt),
                               types.scalar_as(6.0, dt))
        elif op_type == "clip_by_norm":
            got = rule(ctx, xd)["Out"]
            norm = torch.sqrt((xd * xd).sum(dtype=torch.float32).to(dt)) \
                if dt == torch.bfloat16 else torch.sqrt((xd * xd).sum())
            want = xd * torch.clamp(types.scalar_as(5.0, dt) / torch.clamp(
                norm, min=types.scalar_as(1e-12, dt)), max=1.0)
        else:
            xd, ld = xd.float(), label
            got = rule(ctx, xd, ld)["Out"]
            want = torch.clamp(xd, min=0.0) - xd * ld + torch.log1p(
                torch.exp(-torch.abs(xd)))
        assert torch.equal(got, want), (op_type, dt)


# ---------------------------------------------------------------------------
# 1. the layers, built by both packages
# ---------------------------------------------------------------------------

def _int64_as_port(program_dict, tmain):
    """The JAX package's program dict with the vars the port declares
    int64 (the index outputs: arg_max, argsort, shape, ...) declared so;
    the x32 JAX package declares them int32."""
    tvars = tmain.global_block().vars
    for b in program_dict["blocks"]:
        for v in b["vars"]:
            if v["dtype"] == "int32" and v["name"] in tvars \
                    and tvars[v["name"]].dtype == "int64":
                v["dtype"] = "int64"
    return program_dict


def _build(pkg, build, backward):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss, fetch = build(pkg)
        grads = []
        if loss is not None:
            backward(loss)
            grads = sorted(n for n in main.global_block().vars
                           if n.endswith("@GRAD"))
    return main, startup, fetch + grads


def run_both(build, feed, tol=TOL):
    """Build with each package's layers, hold the Programs equal, start
    both from the JAX startup's state and run one step of each;
    every fetch (the forward outputs and every grad var of the Program)
    is compared at `tol`. Returns the JAX results, in fetch order."""
    main, startup, fetch = _build(fluid, build,
                                  fluid.backward.append_backward)
    tmain, tstartup, tfetch = _build(ptt, build, tappend_backward)
    assert tmain.to_dict() == _int64_as_port(main.to_dict(), tmain)
    assert tstartup.to_dict() == startup.to_dict()
    assert tfetch == fetch
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(startup, scope=jscope)
    tscope = ptt.io.state_from_numpy(
        {n: np.asarray(jscope.find_var(n))
         for n in jscope.local_var_names()}, ptt.CPUPlace())
    texe = ptt.Executor(ptt.CPUPlace())
    native.reset_launches()
    ref = [np.asarray(r) for r in jexe.run(main, feed=feed,
                                           fetch_list=fetch, scope=jscope)]
    got = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
    assert not any(native.launches.values())
    _close(fetch, ref, got, tol)
    return ref


RNG = np.random.RandomState(17)


def _f(*shape, lo=-1.0, hi=1.0):
    return RNG.uniform(lo, hi, shape).astype(np.float32)


def _x(L, name, shape, dtype="float32", stop_gradient=False):
    return L.data(name, shape=list(shape), dtype=dtype,
                  append_batch_size=False, stop_gradient=stop_gradient)


def _loss(L, out):
    """mean(out * w) for a parameter w of out's shape: a cotangent that
    differs element by element."""
    w = L.create_parameter(list(out.shape), "float32", name="cot_w")
    return L.mean(L.elementwise_mul(out, w))


X24 = _f(2, 4, lo=-2, hi=2)
X24[0, 0] = 0.0


# (layer, attrs) for every activation of layers/ops.py the port gains
ACT_CASES = [
    ("abs", {}), ("cos", {}), ("sin", {}), ("round", {}), ("sign", {}),
    ("logsigmoid", {}), ("tanh_shrink", {}), ("softplus", {}),
    ("softsign", {}), ("gelu", {}), ("softshrink", {"lambda": 0.5}),
    ("hard_shrink", {"threshold": 0.5}), ("thresholded_relu", {}),
    ("leaky_relu", {"alpha": 0.1}), ("elu", {"alpha": 0.7}),
    ("relu6", {"threshold": 1.5}), ("brelu", {"t_min": -1.0, "t_max": 1.0}),
    ("soft_relu", {"threshold": 1.0}), ("swish", {"beta": 1.5}),
    ("hard_sigmoid", {"slope": 0.3, "offset": 0.4}),
    ("log", {}), ("rsqrt", {}), ("reciprocal", {}), ("pow", {"factor": 2.5}),
]
_POSITIVE = {"log", "rsqrt", "reciprocal", "pow"}


@pytest.mark.parametrize("name,attrs", ACT_CASES,
                         ids=[c[0] for c in ACT_CASES])
def test_activation_layer(name, attrs):
    x = np.abs(X24) + 0.25 if name in _POSITIVE else X24

    def build(pkg):
        L = pkg.layers
        out = getattr(L, name)(_x(L, "x", x.shape), **attrs)
        return _loss(L, out), [out.name]
    run_both(build, {"x": x})


@pytest.mark.parametrize("name", ["reduce_mean", "reduce_max", "reduce_min",
                                  "reduce_prod"])
@pytest.mark.parametrize("dim,keep", [(None, False), (1, True),
                                      ([0, 2], False)])
def test_reduce_layer(name, dim, keep):
    x = _f(2, 3, 4, lo=0.5, hi=2)
    x[0, 1, :2] = x[0, 1, 2]          # a tie for max and min

    def build(pkg):
        L = pkg.layers
        out = getattr(L, name)(_x(L, "x", x.shape), dim=dim, keep_dim=keep)
        return _loss(L, out), [out.name]
    run_both(build, {"x": x})


def test_index_layers():
    x = _f(4, 6)
    x[1, :3] = 0.5                    # ties

    def build(pkg):
        L = pkg.layers
        xv = _x(L, "x", x.shape)
        amax, amin = L.argmax(xv, axis=1), L.argmin(xv, axis=0)
        srt, ids = L.argsort(xv, axis=1)
        rev = L.reverse(xv, axis=[0, 1])
        return _loss(L, L.elementwise_add(srt, rev)), [
            amax.name, amin.name, srt.name, ids.name, rev.name]
    run_both(build, {"x": x})


def test_tensor_layers():
    x, u = _f(5, 3), _f(2, 3)
    idx = np.array([4, 0, 2], np.int64)
    sid = np.array([3, 1], np.int64)
    oh = np.array([[1], [5], [0]], np.int64)

    def build(pkg):
        L = pkg.layers
        xv, uv = _x(L, "x", x.shape), _x(L, "u", u.shape)
        iv = _x(L, "idx", idx.shape, "int64", True)
        sv = _x(L, "sid", sid.shape, "int64", True)
        ov = _x(L, "oh", oh.shape, "int64", True)
        g = L.gather(xv, iv)
        s = L.scatter(xv, sv, uv)
        sa = L.scatter(xv, sv, uv, overwrite=False)
        e = L.expand(uv, [2, 3])
        st = L.stack([uv, uv * 2.0], axis=1)
        p = L.pad(uv, [1, 0, 0, 2], pad_value=0.5)
        n = L.l2_normalize(xv, axis=1)
        h = L.one_hot(ov, depth=6)
        z, o = L.zeros([2, 3]), L.ones([2, 3], "float32")
        total = L.elementwise_add(L.reduce_sum(g) + L.reduce_sum(s * 0.5),
                                  L.reduce_sum(sa) + L.reduce_sum(e))
        total = total + L.reduce_sum(st) + L.reduce_sum(p * p) \
            + L.reduce_sum(n * n * 3.0) + L.reduce_sum(z + o)
        return L.mean(total), [g.name, s.name, sa.name, e.name, st.name,
                               p.name, n.name, h.name, z.name, o.name]
    run_both(build, {"x": x, "u": u, "idx": idx, "sid": sid, "oh": oh})


@pytest.mark.parametrize("mode,shape", [("all", [1]), ("channel", [3]),
                                        ("element", [3, 2, 2])])
def test_prelu_layer(mode, shape):
    x = _f(2, 3, 2, 2)
    x[0, 0, 0, 0] = 0.0

    def build(pkg):
        L = pkg.layers
        out = L.prelu(_x(L, "x", x.shape), mode=mode)
        assert list(pkg.default_main_program().global_block()
                    .all_parameters()[0].shape) == shape
        return _loss(L, out), [out.name]
    run_both(build, {"x": x})


def test_loss_layers():
    x, y = _f(4, 3, lo=-2, hi=2), _f(4, 3)
    lab = (RNG.rand(4, 1) > 0.5).astype(np.float32)
    left, right = _f(4, 1), _f(4, 1)
    prob = RNG.uniform(0.05, 0.95, (4, 3, 3)).astype(np.float32)
    seg = (RNG.rand(4, 3, 3) > 0.5).astype(np.int64)

    def build(pkg):
        L = pkg.layers
        xv, yv = _x(L, "x", x.shape), _x(L, "y", y.shape)
        lv = _x(L, "lab", lab.shape, stop_gradient=True)
        lt, rt = _x(L, "left", left.shape), _x(L, "right", right.shape)
        pv = _x(L, "prob", prob.shape)
        sv = _x(L, "seg", seg.shape, "int64", True)
        s1 = L.smooth_l1(xv, yv, sigma=2.0)
        rk = L.rank_loss(lv, lt, rt)
        dc = L.dice_loss(pv, sv)
        total = L.reduce_sum(s1) + L.reduce_sum(rk) + dc
        return L.mean(total), [s1.name, rk.name, dc.name]
    run_both(build, {"x": x, "y": y, "lab": lab, "left": left,
                     "right": right, "prob": prob, "seg": seg})


def test_conv2d_transpose_and_lrn_layers():
    x = _f(2, 4, 5, 5)

    def build(pkg):
        L = pkg.layers
        xv = _x(L, "x", x.shape)
        a = L.conv2d_transpose(xv, num_filters=3, filter_size=3, stride=2,
                               padding=1)
        b = L.conv2d_transpose(xv, num_filters=2, output_size=[10, 10],
                               stride=2, act="relu")
        c = L.lrn(xv, n=3)
        return L.mean(L.reduce_sum(a) + L.reduce_sum(b * b)
                      + L.reduce_sum(c * c)), [a.name, b.name, c.name]
    run_both(build, {"x": x})


def test_parameter_and_global_var_layers():
    x = _f(3, 4)

    def build(pkg):
        L = pkg.layers
        xv = _x(L, "x", x.shape)
        w = L.create_parameter([4, 2], "float32", name="made_w",
                               default_initializer=pkg.initializer
                               .NumpyArrayInitializer(_W42))
        g = L.create_global_var([1], 2.5, "float32", persistable=True,
                                name="g")
        out = L.matmul(xv, w) * 1.0
        out = L.elementwise_mul(out, g)
        return L.mean(out), [out.name, g.name]
    ref = run_both(build, {"x": x})
    np.testing.assert_allclose(ref[0], x @ _W42 * 2.5, rtol=1e-5)


_W42 = np.arange(8, dtype=np.float32).reshape(4, 2) / 8


def test_step_counter_and_create_tensor():
    def build(pkg):
        L = pkg.layers
        c = L.autoincreased_step_counter(begin=3, step=2)
        assert L.autoincreased_step_counter() is c
        t = L.create_tensor("float32", name="t")
        assert t.name == "t"
        return None, [c.name]
    main, startup, fetch = _build(fluid, build, None)
    tmain, tstartup, _ = _build(ptt, build, None)
    assert tmain.to_dict() == main.to_dict()
    assert tstartup.to_dict() == startup.to_dict()
    exe, scope = ptt.Executor(ptt.CPUPlace()), ptt.Scope()
    exe.run(tstartup, scope=scope)
    seen = [int(exe.run(tmain, fetch_list=fetch, scope=scope)[0][0])
            for _ in range(3)]
    assert seen == [3, 5, 7]


def test_beam_search_layers_build_the_reference_programs():
    def build(pkg):
        L = pkg.layers
        probs = _x(L, "probs", (2, 3, 7))
        scores = _x(L, "scores", (2, 3))
        fin = _x(L, "fin", (2, 3), "bool", True)
        pre = _x(L, "pre", (2, 3), "int32", True)
        ids, parents, acc, done = L.beam_search(pre, scores, probs, 3, 0,
                                                finished=fin)
        hist_i = _x(L, "hist_i", (2, 4, 3), "int32", True)
        hist_p = _x(L, "hist_p", (2, 4, 3), "int32", True)
        sent, sc = L.beam_search_decode(hist_i, hist_p, scores)
        return None, [ids.name, parents.name, acc.name, done.name,
                      sent.name, sc.name]
    main, _, fetch = _build(fluid, build, None)
    tmain, _, tfetch = _build(ptt, build, None)
    assert tmain.to_dict() == main.to_dict() and tfetch == fetch
    feed = {"probs": np.log(RNG.dirichlet(np.ones(7), (2, 3)))
            .astype(np.float32),
            "scores": _f(2, 3), "fin": np.zeros((2, 3), bool),
            "pre": np.zeros((2, 3), np.int32),
            "hist_i": RNG.randint(0, 7, (2, 4, 3)).astype(np.int32),
            "hist_p": RNG.randint(0, 3, (2, 4, 3)).astype(np.int32)}
    ref = fluid.Executor(fluid.CPUPlace()).run(main, feed=feed,
                                               fetch_list=fetch,
                                               scope=fluid.Scope())
    got = ptt.Executor(ptt.CPUPlace()).run(tmain, feed=feed,
                                           fetch_list=fetch,
                                           scope=ptt.Scope())
    for name, r, g in zip(fetch, ref, got):
        np.testing.assert_allclose(g, np.asarray(r), rtol=TOL, atol=TOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# auc: the streaming metric over several batches
# ---------------------------------------------------------------------------

def test_auc_streams_over_five_batches():
    """DeepFM's head with `layers.auc`: after each of 5 batches the two
    histograms equal the JAX package's bit for bit and the AUC is within
    1e-6."""
    def build(pkg):
        L = pkg.layers
        x = _x(L, "x", (16, 5), stop_gradient=True)
        label = _x(L, "label", (16, 1), "int64", True)
        pred = L.fc(x, 1, act="sigmoid")
        auc, (pos, neg) = L.auc(pred, label, num_thresholds=50)
        return None, [auc.name, pos.name, neg.name]
    main, startup, fetch = _build(fluid, build, None)
    tmain, tstartup, _ = _build(ptt, build, None)
    assert tmain.to_dict() == main.to_dict()
    assert tstartup.to_dict() == startup.to_dict()
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(startup, scope=jscope)
    tscope = ptt.io.state_from_numpy(
        {n: np.asarray(jscope.find_var(n))
         for n in jscope.local_var_names()}, ptt.CPUPlace())
    texe = ptt.Executor(ptt.CPUPlace())
    for step in range(5):
        feed = {"x": RNG.randn(16, 5).astype(np.float32) * 3,
                "label": RNG.randint(0, 2, (16, 1)).astype(np.int64)}
        if step == 2:        # predictions on the bucket edges
            feed["x"][:, :] = 0.0
        ref = jexe.run(main, feed=feed, fetch_list=fetch, scope=jscope)
        got = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
        np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
        np.testing.assert_array_equal(got[2], np.asarray(ref[2]))
        assert got[1].sum() + got[2].sum() == 16 * (step + 1)
        assert abs(float(got[0][0]) - float(np.asarray(ref[0])[0])) <= 1e-6


# ---------------------------------------------------------------------------
# edges the spec inputs do not reach, op by op
# ---------------------------------------------------------------------------

def _op_both(op_type, inputs, attrs=None, outs=("Out",), backward=True):
    """One op appended with each package's LayerHelper on data vars, run
    by both from the same feed; returns both fetch lists (outputs, then
    the float inputs' grads of mean(first output) when `backward`)."""
    def build(pkg, helper_cls):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()), \
                pkg.unique_name.guard():
            blk = main.global_block()
            helper = helper_cls(op_type)
            ins = {}
            for slot, v in inputs.items():
                vs = v if isinstance(v, list) else [v]
                ins[slot] = []
                for k, a in enumerate(vs):
                    name = f"{slot}_{k}"
                    blk.create_var(name=name, shape=a.shape,
                                   dtype=str(a.dtype), is_data=True,
                                   stop_gradient=a.dtype.kind != "f")
                    ins[slot].append(name)
            out_names = {s: [helper.create_variable_for_type_inference(
                "float32").name] for s in outs}
            helper.append_op(op_type, inputs=ins, outputs=out_names,
                             attrs=dict(attrs or {}))
            fetch = [out_names[s][0] for s in outs]
            if backward:
                first = blk.var(fetch[0])
                loss = pkg.layers.mean(pkg.layers.cast(first, "float32"))
                pkg.backward.append_backward(loss)
                fetch += [n + "@GRAD" for slot in ins for n in ins[slot]
                          if n + "@GRAD" in blk.vars]
        return main, fetch
    main, fetch = build(fluid, JLayerHelper)
    tmain, tfetch = build(ptt, TLayerHelper)
    assert tfetch == fetch
    feed = {f"{slot}_{k}": a for slot, v in inputs.items()
            for k, a in enumerate(v if isinstance(v, list) else [v])}
    ref = [np.asarray(r) for r in fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch, scope=fluid.Scope())]
    got = ptt.Executor(ptt.CPUPlace()).run(tmain, feed=feed,
                                           fetch_list=fetch,
                                           scope=ptt.Scope())
    return fetch, ref, got


def _close(fetch, ref, got, tol=TOL):
    for name, r, g in zip(fetch, ref, got):
        assert r.shape == g.shape, name
        if r.dtype.kind == "f":
            np.testing.assert_allclose(g, r, rtol=tol, atol=tol,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)


@pytest.mark.parametrize("overwrite", [True, False])
def test_scatter_with_repeated_ids(overwrite):
    """ids [1, 1, 2, 1]: overwriting, row 1 is the fourth update (the
    last one wins, as on the JAX package's CPU) and only that update gets
    a grad; adding, row 1 sums three."""
    x = _f(4, 2)
    upd = np.arange(8, dtype=np.float32).reshape(4, 2)
    fetch, ref, got = _op_both(
        "scatter", {"X": x, "Ids": np.array([1, 1, 2, 1], np.int64),
                    "Updates": upd}, {"overwrite": overwrite})
    _close(fetch, ref, got)
    if overwrite:
        np.testing.assert_array_equal(got[0][1], upd[3])
        g_upd = got[fetch.index("Updates_0@GRAD")]
        assert not g_upd[:2].any() and g_upd[3].all()
    else:
        # added one at a time, in the ids' order
        np.testing.assert_array_equal(got[0][1],
                                      x[1] + upd[0] + upd[1] + upd[3])


def test_argsort_keeps_ties_in_order():
    fetch, ref, got = _op_both(
        "argsort", {"X": np.array([1, 0, 1, 0, 1], np.float32)},
        {"axis": -1}, outs=("Out", "Indices"), backward=False)
    np.testing.assert_array_equal(got[1], [1, 3, 0, 2, 4])
    _close(fetch, ref, got)


def test_one_hot_out_of_range_is_a_zero_row():
    fetch, ref, got = _op_both(
        "one_hot", {"X": np.array([[-1], [2], [7], [3]], np.int64)},
        {"depth": 4}, backward=False)
    np.testing.assert_array_equal(
        got[0], [[0, 0, 0, 0], [0, 0, 1, 0], [0, 0, 0, 0], [0, 0, 0, 1]])
    assert got[0].dtype == np.float32
    _close(fetch, ref, got)


@pytest.mark.parametrize("op_type", ["elementwise_mod",
                                     "elementwise_floordiv"])
@pytest.mark.parametrize("dtype", ["int64", "float32"])
def test_mod_and_floordiv_take_the_divisors_sign(op_type, dtype):
    x = np.array([-7, 7, -7, 7, 0, -1], dtype)
    y = np.array([3, -3, -3, 3, 5, 4], dtype)
    if dtype == "float32":
        x, y = x + 0.5, y * 1.5
    fetch, ref, got = _op_both(op_type, {"X": x, "Y": y}, backward=False)
    want = np.mod(x, y) if op_type == "elementwise_mod" \
        else np.floor_divide(x, y)
    np.testing.assert_array_equal(got[0], want)
    _close(fetch, ref, got)


def test_round_at_halves_goes_to_even():
    fetch, ref, got = _op_both(
        "round", {"X": np.array([0.5, 1.5, 2.5, -0.5, -1.5], np.float32)},
        backward=False)
    np.testing.assert_array_equal(got[0], [0, 2, 2, -0.0, -2])
    _close(fetch, ref, got)


@pytest.mark.parametrize("zeros", [0, 1, 2])
def test_reduce_prod_grad_with_zeros(zeros):
    x = _f(3, 4, lo=0.5, hi=2)
    x[1, :zeros] = 0.0
    x[2, 1:1 + zeros] = 0.0
    for attrs in ({"dim": [1]}, {"reduce_all": True}, {"dim": [0, 1],
                                                       "keep_dim": True}):
        fetch, ref, got = _op_both("reduce_prod", {"X": x}, attrs)
        _close(fetch, ref, got)


@pytest.mark.parametrize("mode", ["constant", "reflect", "edge"])
def test_pad2d_modes(mode):
    fetch, ref, got = _op_both("pad2d", {"X": _f(2, 3, 4, 5)},
                               {"paddings": [1, 2, 3, 1], "mode": mode,
                                "pad_value": 0.25})
    _close(fetch, ref, got)


def test_grid_sampler_at_and_beyond_the_edges():
    """Grid points on -1 and 1, inside, and past both: the JAX formula
    clamps each corner's index, not the coordinate."""
    g = np.array([-1.5, -1.0, -0.3, 0.0, 0.6, 1.0, 1.25], np.float32)
    gx, gy = np.meshgrid(g, g[::-1])
    grid = np.stack([gx, gy], -1)[None].repeat(2, 0)
    fetch, ref, got = _op_both("grid_sampler", {"X": _f(2, 3, 4, 5),
                                                "Grid": grid},
                               outs=("Output",))
    _close(fetch, ref, got)


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_cumsum_exclusive_and_reverse(exclusive, reverse):
    fetch, ref, got = _op_both("cumsum", {"X": _f(3, 5)},
                               {"axis": 1, "exclusive": exclusive,
                                "reverse": reverse})
    _close(fetch, ref, got)


def test_isfinite_over_a_list():
    a, b = _f(2, 3), _f(4)
    for bad in (None, np.inf, np.nan):
        bb = b.copy()
        if bad is not None:
            bb[2] = bad
        fetch, ref, got = _op_both("isfinite", {"X": [a, bb]},
                                   backward=False)
        assert got[0].shape == (1,) and bool(got[0][0]) == (bad is None)
        _close(fetch, ref, got)


def test_small_tensor_ops_beyond_the_specs():
    """shape, range, flatten, unstack, expand_dims_tile and gather_nd on
    inputs the sweep's specs leave out."""
    x = _f(3, 2, 4)
    _close(*_op_both("shape", {"Input": x}, backward=False))
    _close(*_op_both("range", {}, {"start": 2, "end": 11, "step": 3,
                                   "dtype": "int64"}, backward=False))
    _close(*_op_both("flatten", {"X": x}, {"axis": 2}))
    _close(*_op_both("unstack", {"X": x}, {"axis": 1}, outs=("Y",)))
    _close(*_op_both("expand_dims_tile", {"X": x}, {"times": [2, 1]}))
    _close(*_op_both("gather_nd", {"X": x, "Index": np.array(
        [[[0, 1], [2, 0]], [[1, 1], [0, 0]]], np.int64)}))


@pytest.mark.parametrize("k,p,s,d", [(3, 1, 2, 1), (4, 1, 2, 1),
                                     (4, 2, 2, 1), (2, 0, 2, 1),
                                     (5, 2, 1, 1), (3, 0, 1, 1),
                                     (3, 1, 1, 2), (3, 2, 2, 2)])
def test_conv2d_transpose_over_the_sweeps_cases(k, p, s, d):
    """The k / p / s / d cases on which tests/test_op_autosweep.py holds
    the JAX rule to torch in float64."""
    fetch, ref, got = _op_both(
        "conv2d_transpose", {"Input": _f(2, 4, 5, 5),
                             "Filter": _f(4, 3, k, k)},
        {"strides": [s, s], "paddings": [p, p], "dilations": [d, d]},
        outs=("Output",))
    _close(fetch, ref, got)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_depthwise_conv2d_layouts(fmt):
    x = _f(2, 3, 6, 6) if fmt == "NCHW" else _f(2, 6, 6, 3)
    fetch, ref, got = _op_both(
        "depthwise_conv2d", {"Input": x, "Filter": _f(3, 1, 3, 3),
                             "Bias": _f(3)},
        {"strides": [1, 1], "paddings": [1, 1], "groups": 1,
         "data_format": fmt}, outs=("Output",))
    _close(fetch, ref, got)


def test_lrn_default_k_and_midout():
    fetch, ref, got = _op_both("lrn", {"X": _f(2, 6, 3, 3)}, {"n": 5},
                               outs=("Out", "MidOut"))
    _close(fetch, ref, got)
    np.testing.assert_allclose(got[1].min(), 2.0 ** 0.75, rtol=1e-3)


# ---------------------------------------------------------------------------
# random draws and initializers
# ---------------------------------------------------------------------------

def _startup_values(pkg, make):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        make(pkg)
    scope = pkg.Scope()
    pkg.Executor(pkg.CPUPlace()).run(startup, scope=scope)
    return {n: np.asarray(scope.find_var(n))
            for n in scope.local_var_names()}


def test_truncated_gaussian_random_moments_and_bounds():
    def make(pkg):
        pkg.layers.create_parameter(
            [400, 250], "float32", name="w",
            default_initializer=pkg.initializer.TruncatedNormal(0.5, 2.0))
    for pkg in (fluid, ptt):
        w = _startup_values(pkg, make)["w"]
        assert -3.5 <= w.min() and w.max() <= 4.5
        assert abs(w.mean() - 0.5) < 0.02
        assert abs(w.std() - 0.880 * 2.0) < 0.02


@pytest.mark.parametrize("uniform", [True, False])
def test_msra_initializer(uniform):
    def make(pkg):
        pkg.layers.create_parameter(
            [64, 32, 3, 3], "float32", name="w",
            default_initializer=pkg.initializer.MSRA(uniform=uniform))
    fan_in = 32 * 9
    for pkg in (fluid, ptt):
        w = _startup_values(pkg, make)["w"]
        if uniform:
            assert np.abs(w).max() <= np.sqrt(6.0 / fan_in)
        assert abs(w.std() - np.sqrt(2.0 / fan_in)) < 0.05 * np.sqrt(
            2.0 / fan_in)


def test_bilinear_and_numpy_array_initializers_are_exact():
    arr = RNG.randn(3, 5).astype(np.float32)

    def make(pkg):
        L = pkg.layers
        L.create_parameter([4, 4, 4, 4], "float32", name="up",
                           default_initializer=pkg.initializer.Bilinear())
        L.create_parameter([3, 5], "float32", name="arr",
                           default_initializer=pkg.initializer
                           .NumpyArrayInitializer(arr))
    ref, got = _startup_values(fluid, make), _startup_values(ptt, make)
    for n in ("up", "arr"):
        np.testing.assert_array_equal(got[n], ref[n])
    np.testing.assert_array_equal(got["arr"], arr)


def test_init_on_cpu_flag():
    assert not ptt.initializer.force_init_on_cpu()
    with ptt.initializer.init_on_cpu():
        assert ptt.initializer.force_init_on_cpu()
    assert not ptt.initializer.force_init_on_cpu()


def test_weight_norm_param_attr_is_a_param_attr():
    a = ptt.WeightNormParamAttr(dim=1, name="w")
    assert isinstance(a, ptt.ParamAttr) and a.dim == 1 and a.name == "w"


# ---------------------------------------------------------------------------
# io, Operator, enforce, default_scope_funcs, graphviz, net_drawer
# ---------------------------------------------------------------------------

def _mlp(pkg):
    L = pkg.layers
    x = L.data("x", shape=[4], dtype="float32")
    h = L.fc(x, 3, act="relu")
    out = L.fc(h, 2)
    loss = L.mean(out)
    pkg.optimizer.Adam(learning_rate=0.1).minimize(loss)
    return out, loss


@pytest.mark.parametrize("filename", [None, "params"])
def test_save_params_and_load_params_round_trip(tmp_path, filename):
    """Parameters only (no Adam moments), one `.npy` each or one `.npz`;
    a dir the JAX package saved loads into the port to the same values."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        out, loss = _mlp(ptt)
    exe, scope = ptt.Executor(ptt.CPUPlace()), ptt.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed={"x": _f(5, 4)}, fetch_list=[loss], scope=scope)
    d = str(tmp_path / "port")
    ptt.io.save_params(exe, d, main, filename=filename, scope=scope)
    names = sorted(os.listdir(d))
    params = sorted(p.name for p in main.global_block().all_parameters())
    assert names == ([filename + ".npz"] if filename
                     else [n + ".npy" for n in params])
    fresh = ptt.Scope()
    ptt.io.load_params(exe, d, main, filename=filename, scope=fresh)
    assert sorted(fresh.local_var_names()) == params
    for n in params:
        assert torch.equal(fresh.find_var(n), scope.find_var(n))
    # persistables with a filename: the optimizer's state too
    ptt.io.save_persistables(exe, d, main, filename="all", scope=scope)
    full = ptt.Scope()
    ptt.io.load_persistables(exe, d, main, filename="all", scope=full)
    assert len(full.local_var_names()) > len(params)

    jmain, jstartup = fluid.Program(), fluid.Program()
    with fluid.program_guard(jmain, jstartup), fluid.unique_name.guard():
        _mlp(fluid)
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(jstartup, scope=jscope)
    jd = str(tmp_path / "jax")
    fluid.io.save_params(jexe, jd, jmain, filename=filename, scope=jscope)
    from_jax = ptt.Scope()
    ptt.io.load_params(exe, jd, main, filename=filename, scope=from_jax)
    for n in params:
        np.testing.assert_array_equal(from_jax.find_var(n).numpy(),
                                      np.asarray(jscope.find_var(n)))


def test_get_inference_program_prunes_to_the_targets():
    main, startup = ptt.Program(), ptt.Program()
    jmain, jstartup = fluid.Program(), fluid.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        out, _ = _mlp(ptt)
        prog = ptt.io.get_inference_program([out], main)
    with fluid.program_guard(jmain, jstartup), fluid.unique_name.guard():
        jout, _ = _mlp(fluid)
        jprog = fluid.io.get_inference_program([jout], jmain)
    assert prog.to_dict() == jprog.to_dict()
    assert "adam" not in {op.type for op in prog.global_block().ops}


def test_operator_runs_a_rule_on_the_scope():
    from paddle_tpu.op import Operator as JOperator
    x = _f(3, 4)
    scope, jscope = ptt.Scope(), fluid.Scope()
    scope.set_var("x", x)
    jscope.set_var("x", x)
    for op in (dict(type="scale", X="x", Out="y", scale=2.0, bias=0.5),
               dict(type="softplus", X="y", Out="z"),
               dict(type="reduce_max", X="z", Out="m", dim=[1])):
        o = ptt.Operator(**op)
        assert o.input_names() == ["X"] and o.output_names() == ["Out"]
        o.run(scope, ptt.CPUPlace())
        JOperator(**op).run(jscope, fluid.CPUPlace())
    for n in ("y", "z", "m"):
        assert isinstance(scope.find_var(n), torch.Tensor)
        np.testing.assert_allclose(scope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)),
                                   rtol=TOL)
    with pytest.raises(ValueError, match="not registered"):
        ptt.Operator("no_such_op")
    with pytest.raises(KeyError, match="not found in scope"):
        ptt.Operator("relu", X="missing", Out="o").run(scope, ptt.CPUPlace())


def test_enforce():
    from paddle_tpu_torch import enforce as E
    with pytest.raises(ptt.EnforceNotMet, match=r"got 3\s+\[enforced at "
                       r".*test_torch_breadth\.py:\d+ in test_enforce\]"):
        E.enforce(False, "got %d", 3)
    for fn, args in ((E.enforce_eq, (1, 2)), (E.enforce_ne, (1, 1)),
                     (E.enforce_gt, (1, 2)), (E.enforce_ge, (1, 2)),
                     (E.enforce_lt, (2, 1)), (E.enforce_le, (2, 1)),
                     (E.enforce_not_none, (None,)),
                     (E.enforce_shape_match, ((2, 3), (2, 4)))):
        with pytest.raises(E.EnforceNotMet):
            fn(*args)
    E.enforce_shape_match((5, 3), (-1, 3))
    assert E.enforce_not_none(4) == 4


def test_default_scope_funcs_and_scope_guard():
    from paddle_tpu_torch import default_scope_funcs as D
    outer = ptt.Scope()
    with ptt.scope_guard(outer):
        assert ptt.global_scope() is outer
        outer.set_var("a", torch.ones(1))
        D._tls.stack = []
        assert D.get_cur_scope() is outer
        D.enter_local_scope()
        assert D.get_cur_scope() is not outer
        assert D.find_var("a") is not None     # through the parent
        D.var("b")
        assert D.get_cur_scope().has_var("b") is False
        assert "b" in D.get_cur_scope().local_var_names()
        D.leave_local_scope()
        assert D.get_cur_scope() is outer and not outer._kids
        assert D.scoped_function(lambda: D.get_cur_scope()) is not outer
        D._tls.stack = []
    assert ptt.global_scope() is not outer


def test_graphviz_and_net_drawer_write_the_reference_dot(tmp_path):
    from paddle_tpu import graphviz as jg, net_drawer as jn
    from paddle_tpu_torch import graphviz as tg, net_drawer as tn
    text = {}
    for name, pkg, g, n in (("jax", fluid, jg, jn), ("port", ptt, tg, tn)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            _mlp(pkg)
        g.Node.counter, g.Graph.rank_counter = 1, 0
        graph = n.draw_graph(startup, main, graph_attr={"rankdir": "LR"},
                             filename=str(tmp_path / f"{name}.dot"))
        preview = g.GraphPreviewGenerator("preview")
        a = preview.add_param("w", "float32", highlight=True)
        b = preview.add_op("mul", rank=preview.graph.rank_group("same", 1))
        preview.add_edge(a, b, label="X")
        text[name] = (graph.code(), str(preview.graph),
                      open(tmp_path / f"{name}.dot").read())
    assert text["port"] == text["jax"]
    assert "digraph ProgramDesc" in text["port"][0]


# ---------------------------------------------------------------------------
# the names both packages export
# ---------------------------------------------------------------------------

# paddle_tpu.layers names whose ops or modules the port has not yet: none
LAYERS_WAITING = set()
# top-level names waiting: item 8 (the host planes and the
# parameter-server transpiler), and the TPU names, which the port does
# not take. A submodule the JAX package does not import itself
# (`quorum`, `capi_runtime`) is a name only once something imports it, so
# the lists say what may be missing, and the test that nothing else is
# and that no listed name has been ported
TOP_WAITING = {
    "wire", "pserver", "master",
    "haven", "fleet", "torrent", "quorum", "capi_runtime",
    "DistributeTranspiler", "DistributeTranspilerConfig",
    "TPUPlace", "tpu_device_count", "is_compiled_with_tpu",
}
# paddle_tpu.transpiler names waiting for the parameter-server plane
# (item 8.4)
TRANSPILER_WAITING = {"DistributeTranspiler", "DistributeTranspilerConfig",
                      "RoundRobin", "HashName", "distribute_transpiler",
                      "ps_dispatcher"}
# paddle_tpu.analysis names the port does not take: the planner's TPU
# profile, a TPU name as `TPUPlace` is (the port's planner has `H100`)
ANALYSIS_WAITING = {"TPU_CHIP"}
# cost_model's `xla_flops` asks XLA for a compiled step's FLOPs; the
# port's counterpart is `measured_flops`, torch's FLOP counter over one run
COST_MODEL_RENAMED = {"xla_flops": "measured_flops"}


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


@pytest.mark.parametrize("jmod,tmod,waiting", [
    (fluid.layers, ptt.layers, LAYERS_WAITING),
    (fluid, ptt, TOP_WAITING),
    (fluid.transpiler, ptt.transpiler, TRANSPILER_WAITING),
    (fluid.analysis, ptt.analysis, ANALYSIS_WAITING),
    (fluid.ir_pass, ptt.ir_pass, set())],
    ids=["layers", "top_level", "transpiler", "analysis", "ir_pass"])
def test_every_public_name_is_ported_or_waiting(jmod, tmod, waiting):
    import importlib.util
    missing = _public(jmod) - _public(tmod)
    assert missing <= waiting, sorted(missing - waiting)
    assert not waiting & _public(tmod), sorted(waiting & _public(tmod))
    assert all(hasattr(jmod, n) or importlib.util.find_spec(
        f"{jmod.__name__}.{n}") for n in waiting)


def test_cost_model_names_are_ported_or_renamed():
    from paddle_tpu.analysis import cost_model as jcost
    from paddle_tpu_torch.analysis import cost_model as tcost
    assert _public(jcost) - _public(tcost) == set(COST_MODEL_RENAMED)
    assert _public(tcost) - _public(jcost) == set(COST_MODEL_RENAMED.values())


def test_every_op_of_the_reference_is_ported_or_waiting():
    """225 of the JAX package's 226 ops; the one left, by file."""
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg
    left = set(jreg.registered_ops()) - set(treg.registered_ops())
    assert set(treg.registered_ops()) <= set(jreg.registered_ops())
    assert len(treg.registered_ops()) == 225
    by_file = {}
    for op in left:
        src = jreg.get_op_def(op).lower.__module__
        by_file.setdefault(src.rsplit(".", 1)[-1], set()).add(op)
    assert {k: len(v) for k, v in by_file.items()} == {"graph": 1}
    assert by_file["graph"] == {"comm_quant_dequant"}


def test_is_compiled_with_cuda_says_whether_a_card_is_present():
    assert ptt.is_compiled_with_cuda() == torch.cuda.is_available()
    main = ptt.Program()
    with ptt.program_guard(main, ptt.Program()):
        v = ptt.layers.data("x", shape=[2], dtype="float32")
    assert ptt.get_var("x", main) is v
    with pytest.raises(ValueError):
        ptt.get_var("nope", main)
