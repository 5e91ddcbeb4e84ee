"""paddle_tpu_torch's fake quantization against paddle_tpu, on the CPU:
the three ops (values on the rounding grid's halves, where both round
half to even, and the straight-through grads), the `range_abs_max`
scale as state that grows across steps and that `is_test` reads
unchanged, a small quantization-aware conv net trained 5 steps by both
packages from one state, and quantized inference after
`save_inference_model` / `load_inference_model` (a dir the JAX package
saved, and one the port saved), mirroring tests/test_detection.py.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.executor import fetch_var

from test_torch_breadth import _close, _one_op_both, run_both, _x

RNG = np.random.RandomState(53)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(fetch, ref, got):
    """Outputs and grads bit for bit; the case's loss, a float32 mean
    summed in another order, to 2e-6."""
    for name, r, g in zip(fetch, ref, got):
        if name == "sweep_loss":
            np.testing.assert_allclose(g, r, rtol=2e-6)
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)


def _on_halves(shape, scale=1.0, bins=127):
    """Values x with x / scale * bins on k + 0.5 (round half to even
    decides them), plus ordinary ones and the abs-max itself."""
    k = RNG.randint(-bins, bins, shape)
    x = ((k + 0.5) / bins * scale).astype(np.float32)
    x.reshape(-1)[::3] = RNG.uniform(-scale, scale, x.size)[::3]
    x.reshape(-1)[0] = scale
    return x


@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quantize_abs_max(bits):
    fetch, ref, got = _one_op_both(
        "fake_quantize_abs_max", {"X": _on_halves((6, 7), 1.5,
                                                  (1 << (bits - 1)) - 1)},
        {"bit_length": bits}, outs=("Out", "OutScale"), grad=["X"])
    _bits(fetch, ref, got)
    # the straight-through estimator: the grad of mean(Out) is 1 / n
    np.testing.assert_array_equal(got[-1], np.full((6, 7), 1 / 42,
                                                   np.float32))


@pytest.mark.parametrize("is_test", [False, True])
@pytest.mark.parametrize("in_scale", [0.5, 3.0])
def test_fake_quantize_range_abs_max(is_test, in_scale):
    fetch, ref, got = _one_op_both(
        "fake_quantize_range_abs_max",
        {"X": _on_halves((5, 8), 1.0),
         "InScale": np.array([in_scale], np.float32)},
        {"bit_length": 8, "is_test": is_test}, outs=("Out", "OutScale"),
        grad=["X"])
    _bits(fetch, ref, got)
    assert got[1][0] == (in_scale if is_test else max(in_scale, 1.0))


def test_fake_dequantize_max_abs():
    fetch, ref, got = _one_op_both(
        "fake_dequantize_max_abs",
        {"X": np.round(RNG.uniform(-127, 127, (4, 6))).astype(np.float32),
         "Scale": np.array([2.5], np.float32)}, {"max_range": 127.0},
        grad=["X"])
    _bits(fetch, ref, got)


def test_quant_layers_build_the_same_program():
    x = RNG.uniform(-2, 2, (4, 6)).astype(np.float32)

    def build(pkg):
        L = pkg.layers
        xv = _x(L, "x", x.shape)
        q, s = L.fake_quantize(xv, bit_length=8)
        q4, _ = L.fake_quantize(xv, bit_length=4)
        d = L.fake_dequantize(L.scale(q, scale=127.0), s, max_range=127.0)
        return L.mean(q * q4 + d), [q.name, s.name, q4.name, d.name]
    run_both(build, {"x": x})


def _range_scale_program(pkg, is_test=False):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[4], dtype="float32")
        scale_var = pkg.layers.create_global_var([1], 0.0, "float32",
                                                 persistable=True,
                                                 name="q_scale")
        out, _ = pkg.layers.fake_quantize(x, quantize_type="range_abs_max",
                                          in_scale=scale_var,
                                          is_test=is_test)
    return main, startup, out


def test_range_abs_max_scale_persists_across_steps():
    """The running scale is written back onto its persistable var: a
    smaller batch does not shrink it, a larger one grows it, and an
    `is_test` program reads it unchanged; the outputs equal the JAX
    package's at every step."""
    scales = {}
    for name, pkg in (("jax", fluid), ("port", ptt)):
        main, startup, out = _range_scale_program(pkg)
        test_main, _, test_out = _range_scale_program(pkg, is_test=True)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        seen = []
        for v in (3.0, 1.0, 4.5, 2.0):
            o, = exe.run(main, feed={"x": np.full((2, 4), v, np.float32)},
                         fetch_list=[out], scope=scope)
            seen.append((float(np.array(scope.find_var("q_scale")).reshape(
                -1)[0]), np.asarray(o)))
        t, = exe.run(test_main, feed={"x": np.full((2, 4), 9.0,
                                                   np.float32)},
                     fetch_list=[test_out], scope=scope)
        seen.append((float(np.array(scope.find_var("q_scale")).reshape(
            -1)[0]), np.asarray(t)))
        scales[name] = seen
    assert [s for s, _ in scales["port"]] == [3.0, 3.0, 4.5, 4.5, 4.5]
    for (sj, oj), (sp, op) in zip(scales["jax"], scales["port"]):
        assert sj == sp
        np.testing.assert_array_equal(op, oj)


def _qat_net(pkg):
    """A conv net with quantized input, conv output (range_abs_max with
    a persistable scale) and fc input, softmax cross entropy, Adam."""
    L = pkg.layers
    img = L.data(name="img", shape=[2, 8, 8], dtype="float32")
    label = L.data(name="label", shape=[1], dtype="int64")
    qi, _ = L.fake_quantize(img, bit_length=8)
    conv = L.conv2d(qi, num_filters=4, filter_size=3, padding=1, act="relu")
    scale = L.create_global_var([1], 0.0, "float32", persistable=True,
                                name="conv_scale")
    qc, _ = L.fake_quantize(conv, quantize_type="range_abs_max",
                            in_scale=scale)
    pool = L.pool2d(qc, pool_size=2, pool_stride=2)
    qp, _ = L.fake_quantize(pool, bit_length=6)
    logits = L.fc(qp, size=3)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    pkg.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return loss


def test_qat_conv_net_trains_5_steps_like_paddle_tpu():
    from test_torch_detection import _port_state, _two_sides
    sides = _two_sides(_qat_net)
    jmain, jstart, jloss = sides["jax"]
    tmain = sides["port"][0]
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    tscope, texe = _port_state(jscope), ptt.Executor(ptt.CPUPlace())
    losses = []
    for step in range(5):
        feed = {"img": RNG.uniform(-1, 1, (8, 2, 8, 8)).astype(np.float32)
                * (1 + step), "label": RNG.randint(0, 3, (8, 1))}
        r, = jexe.run(jmain, feed=feed, fetch_list=[jloss.name],
                      scope=jscope)
        g, = texe.run(tmain, feed=feed, fetch_list=[jloss.name],
                      scope=tscope)
        r = float(np.asarray(r).reshape(-1)[0])
        assert abs(float(g[0]) - r) <= 1e-5 * abs(r), (step, g, r)
        losses.append(r)
        for n in jscope.local_var_names():
            a, b = np.asarray(jscope.find_var(n)), fetch_var(n, tscope)
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{n} at step {step}")
    # the range grew with the inputs' scale, and the state holds it
    assert float(fetch_var("conv_scale", tscope)[0]) > 0


def _mlp(pkg):
    """tests/test_detection.py's quantized MLP (abs_max on the input and
    the hidden layer)."""
    L = pkg.layers
    x = L.data(name="x", shape=[8], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    qx, _ = L.fake_quantize(x, bit_length=8)
    h = L.fc(input=qx, size=16, act="relu", param_attr=pkg.ParamAttr(
        name="qw"))
    qh, _ = L.fake_quantize(h, bit_length=8)
    pred = L.fc(input=qh, size=1)
    loss = L.mean(L.square_error_cost(pred, y))
    pkg.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return pred, loss


def test_quantized_inference_after_save_and_load(tmp_path):
    """40 QAT steps in both packages from one state (the STE grads reach
    the weight, the loss halves), then each package saves an inference
    dir; the port loads both and its predictions equal the JAX
    package's own on the dir it saved."""
    from test_torch_detection import _port_state, _two_sides
    sides = _two_sides(_mlp)
    jmain, jstart, (jpred, jloss) = sides["jax"]
    tmain, _, (tpred, tloss) = sides["port"]
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    tscope, texe = _port_state(jscope), ptt.Executor(ptt.CPUPlace())
    rng = np.random.RandomState(0)
    w = rng.randn(8, 1).astype(np.float32)
    xs = rng.randn(64, 8).astype(np.float32)
    feed = {"x": xs, "y": (xs @ w).astype(np.float32)}
    w0 = fetch_var("qw", tscope).copy()
    losses = []
    for _ in range(40):
        r, = jexe.run(jmain, feed=feed, fetch_list=[jloss.name],
                      scope=jscope)
        g, = texe.run(tmain, feed=feed, fetch_list=[tloss.name],
                      scope=tscope)
        losses.append((float(np.asarray(r).reshape(-1)[0]), float(g[0])))
    assert not np.allclose(w0, fetch_var("qw", tscope))
    assert losses[-1][1] < losses[0][1] * 0.5, losses
    for r, g in losses:
        assert abs(g - r) <= 1e-4 * abs(r)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    fluid.io.save_inference_model(jdir, ["x"], [jpred], jexe,
                                  main_program=jmain, scope=jscope)
    ptt.io.save_inference_model(tdir, ["x"], [tpred], texe,
                                main_program=tmain, scope=tscope)
    probe = rng.randn(5, 8).astype(np.float32)
    loaded = fluid.Scope()
    jprog, jfeeds, jfetch = fluid.io.load_inference_model(jdir, jexe,
                                                          scope=loaded)
    want = np.asarray(jexe.run(jprog, feed={"x": probe}, fetch_list=jfetch,
                               scope=loaded)[0])
    for d in (jdir, tdir):
        scope = ptt.Scope()
        prog, feeds, fetches = ptt.io.load_inference_model(d, texe,
                                                           scope=scope)
        assert feeds == ["x"]
        assert [op.type for op in prog.global_block().ops].count(
            "fake_quantize_abs_max") == 2
        got, = texe.run(prog, feed={"x": probe}, fetch_list=fetches,
                        scope=scope)
        _close(["pred"], [want], [got], tol=1e-4 if d == tdir else 1e-6)
