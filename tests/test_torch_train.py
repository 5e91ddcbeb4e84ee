"""paddle_tpu_torch's training slice against paddle_tpu, on the CPU.

The port's training path (append_backward's grad ops run by recomputing
each forward rule under autograd, the op rules with their grads, Adam,
the flash attention backward and its dropout mask) is held against the
JAX package on the same numpy inputs and parameters, with the JAX
package's Pallas kernels run under the Pallas interpreter
(PADDLE_TPU_PALLAS_INTERPRET=1), as its own tests run them. The CUDA
kernels themselves are checked on the card by tests/test_torch_cuda.py.

Tolerances: 1e-5 for one op or one kernel in float32 (summation order);
1e-4 relative on losses and 1e-4 absolute on parameters after 5 Adam
steps of a whole Transformer (about 400 ops a step, each a few ulps apart,
and Adam's division by sqrt(v) amplifying the smallest grads' differences).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.layer_helper import LayerHelper as JLayerHelper
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.ops import nn as jnn
from paddle_tpu.ops import pallas_attention as jfa

import paddle_tpu_torch as ptt
from paddle_tpu_torch import optimizer as toptimizer
from paddle_tpu_torch.core import backward as tbackward
from paddle_tpu_torch.core.executor import fetch_var
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import native
from paddle_tpu_torch.ops import nn as tnn

TOL = 1e-5
SMALL = dict(src_vocab_size=64, trg_vocab_size=64, seq_len=128, n_layer=1,
             n_head=2, d_model=32, d_inner=64)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small CPU ops run far faster on one thread than on a pool that
    several test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret_kernels(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


# ---------------------------------------------------------------------------
# flash attention backward
# ---------------------------------------------------------------------------

def _qkvg(seed, B=2, H=2, T=128, D=16):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, T, D).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_plain_matches_pallas(interpret_kernels, causal):
    q, k, v, g = _qkvg(0)
    sm = q.shape[-1] ** -0.5
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o, lse = jfa._flash_forward(jq, jk, jv, causal, sm)
    ref = jfa._flash_backward(jq, jk, jv, o, lse, jg, causal, sm, 0.0, 0)
    B, H, T, _ = q.shape
    got = fa._flash_backward_reference(
        *map(torch.from_numpy, (q, k, v, np.array(o))),
        torch.from_numpy(np.array(lse).reshape(B, H, T)),
        torch.from_numpy(g), causal, sm)
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_autograd_function_matches_jax_grad(interpret_kernels, causal):
    q, k, v, g = _qkvg(1)
    sm = q.shape[-1] ** -0.5

    def f(a, b, c):
        return (jfa.flash_attention(a, b, c, jnp.int32(0), causal, sm, 0.0)
                * jnp.asarray(g)).sum()

    ref = jax.grad(f, (0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    native.reset_launches()
    out = fa.flash_attention(*leaves, causal, sm)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    assert not any(native.launches.values())     # plain versions on a host
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=TOL, err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# dropout: the attention mask and the dropout op
# ---------------------------------------------------------------------------

def _directional_fd(f, xs, us, eps=1e-6):
    plus = f(*[x + eps * u for x, u in zip(xs, us)])
    minus = f(*[x - eps * u for x, u in zip(xs, us)])
    return float((plus - minus) / (2 * eps))


@pytest.mark.parametrize("causal", [False, True])
def test_attention_dropout_mask_is_the_same_in_forward_and_backward(causal):
    """A finite difference of the plain forward at rate 0.1 (float64)
    equals the plain backward's directional derivative with the same
    seed, and not with another seed's mask."""
    rng = np.random.RandomState(2)
    B, H, T, D, sm, seed = 1, 2, 40, 8, 0.3, 99
    q, k, v, do, uq, uk, uv = (torch.from_numpy(rng.randn(B, H, T, D))
                               for _ in range(7))

    def loss(a, b, c):
        return (fa._attention_reference(a, b, c, causal, sm, 0.1, seed)
                * do).sum()

    fd = _directional_fd(loss, (q, k, v), (uq, uk, uv))
    out = fa._attention_reference(q, k, v, causal, sm, 0.1, seed)
    lse = fa._lse_reference(q, k, causal, sm)

    def directional(s):
        grads = fa._flash_backward_reference(q, k, v, out, lse, do, causal,
                                             sm, 0.1, s)
        return float(sum((g * u).sum() for g, u in zip(grads, (uq, uk, uv))))

    assert abs(directional(seed) - fd) < 1e-6 * max(1.0, abs(fd))
    assert abs(directional(seed + 1) - fd) > 1e-3


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_attention_keep_rate_within_4_sigma(rate):
    keep = fa._attention_keep(7, 4, 128, 128, rate, "cpu")
    n = keep.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(keep.double().mean().item() - (1 - rate)) < 4 * sigma
    # every row and column of every (b, h) gets its own bits
    assert not torch.equal(keep[0], keep[1])
    assert not torch.equal(keep[0, 0], keep[0, 1])


def test_attention_rate_zero_and_is_test_are_no_dropout():
    q, k, v, _ = map(torch.from_numpy, _qkvg(3))
    plain = fa._attention_reference(q, k, v, True, 0.25)
    assert torch.equal(fa.flash_attention(q, k, v, True, 0.25, 0.0, 5), plain)
    assert not torch.equal(fa.flash_attention(q, k, v, True, 0.25, 0.1, 5),
                           plain)
    ctx = ptt.core.registry.LoweringContext(
        {"causal": True, "sm_scale": 0.25, "dropout_rate": 0.1,
         "is_test": True}, "cpu", seed=5)
    out = fa._fused_attention(ctx, q, k, v)["Out"]
    assert torch.equal(out, plain)


def test_hash_bits_equal_paddle_tpu_bit_for_bit():
    """The dropout op's counter hash is the JAX package's: the port's seed
    folding of a 64-bit seed equals the JAX package's of the key with the
    same two words."""
    seed = 0x1234567890ABCDEF
    key = jax.random.wrap_key_data(np.array([seed & 0xFFFFFFFF, seed >> 32],
                                            np.uint32))
    shape = (3, 5, 7)
    ref = np.asarray(jnn._hash_bits8(key, shape))
    got = tnn._hash_bits8(tnn.seed32(seed), shape, "cpu").numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tnn._keep_bits(tnn.seed32(seed), shape, 0.3, "cpu").numpy(),
        np.asarray(jnn._keep_bits(key, shape, 0.3)))


def _dropout_program(p, is_test=False):
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        x = ptt.layers.data("x", shape=[64, 32], dtype="float32",
                            stop_gradient=False)
        y = ptt.layers.dropout(x, dropout_prob=p, is_test=is_test,
                               dropout_implementation="upscale_in_train")
        tbackward.append_backward(ptt.layers.mean(y))
    mask = [o for o in main.global_block().ops
            if o.type == "dropout"][0].outputs["Mask"][0]
    return main, y, mask


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_op_grad_reuses_the_forward_mask(p):
    main, y, mask = _dropout_program(p)
    x = np.random.RandomState(4).randn(4, 64, 32).astype(np.float32)
    exe = ptt.Executor(ptt.CPUPlace())
    out, m, gx = exe.run(main, feed={"x": x},
                         fetch_list=[y.name, mask, "x@GRAD"],
                         scope=ptt.Scope())
    scale = 1.0 / (1.0 - p)
    np.testing.assert_array_equal(out, np.where(m > 0, x * np.float32(scale),
                                                0))
    np.testing.assert_allclose(gx, m * np.float32(scale) / x.size, rtol=1e-6)
    sigma = (p * (1 - p) / m.size) ** 0.5
    # one byte decides: keep probability is (round((1 - p) * 256)) / 256
    assert abs(m.mean() - round((1 - p) * 256) / 256) < 4 * sigma


@pytest.mark.parametrize("p,is_test", [(0.0, False), (0.3, True)])
def test_dropout_op_rate_zero_and_is_test_are_identity(p, is_test):
    main, y, mask = _dropout_program(p, is_test)
    x = np.random.RandomState(5).randn(2, 64, 32).astype(np.float32)
    out, m = ptt.Executor(ptt.CPUPlace()).run(
        main, feed={"x": x}, fetch_list=[y.name, mask], scope=ptt.Scope())
    np.testing.assert_array_equal(out, x)
    np.testing.assert_array_equal(m, np.ones_like(x))


# ---------------------------------------------------------------------------
# op rules and their grads against paddle_tpu
# ---------------------------------------------------------------------------

def _run_both(build, feed, fetch):
    """Build with paddle_tpu (`build(fluid)` returns the loss), append its
    backward, load the same Program JSON into the port, start both from
    the JAX startup's parameters, run one step of each on `feed` and
    return both fetch lists (grads are fetched as `<name>@GRAD`)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss = build(fluid)
        fluid.backward.append_backward(loss)
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(startup, scope=jscope)
    arrays = {n: np.asarray(jscope.find_var(n))
              for n in jscope.local_var_names()}
    ref = jexe.run(main, feed=feed, fetch_list=fetch, scope=jscope)
    got = ptt.Executor(ptt.CPUPlace()).run(
        ptt.Program.from_dict(main.to_dict()), feed=feed, fetch_list=fetch,
        scope=ptt.io.state_from_numpy(arrays, ptt.CPUPlace()))
    return [np.asarray(r) for r in ref], got


def _head(pkg, out):
    """mean(out @ w) for a Xavier-initialized w: a random cotangent."""
    return pkg.layers.mean(pkg.layers.fc(out, 1, num_flatten_dims=len(
        out.shape) - 1, bias_attr=False, param_attr="head_w"))


def _x(pkg, shape, name="x"):
    return pkg.layers.data(name, shape=list(shape), dtype="float32",
                           append_batch_size=False, stop_gradient=False)


def _sum_op(pkg, a, b):
    helper = JLayerHelper("sum")
    out = helper.create_variable_for_type_inference(a.dtype)
    helper.append_op("sum", inputs={"X": [a.name, b.name]},
                     outputs={"Out": [out.name]})
    return out


def _pos_table(pkg, x):
    helper = JLayerHelper("pos_encoding")
    table = helper.create_variable_for_type_inference("float32")
    helper.append_op("sinusoid_pos_encoding", outputs={"Out": [table.name]},
                     attrs={"size": 6, "d_model": 8})
    return pkg.layers.elementwise_add(x, table, axis=-1)


_OPS = {
    "mul": lambda L, x: L.fc(x, 5, num_flatten_dims=2, act="relu"),
    "reshape": lambda L, x: L.reshape(x, shape=[0, 0, 2, 4]),
    "transpose": lambda L, x: L.transpose(L.reshape(x, [0, 0, 2, 4]),
                                          perm=[0, 2, 1, 3]),
    "layer_norm": lambda L, x: L.layer_norm(x, begin_norm_axis=2),
    "scale": lambda L, x: L.scale(x, scale=2.5, bias=0.5),
}


@pytest.mark.parametrize("op", sorted(_OPS))
def test_op_rule_and_grad_match_paddle_tpu(op):
    x = np.random.RandomState(6).randn(2, 6, 8).astype(np.float32)
    ref, got = _run_both(lambda pkg: _head(pkg, _OPS[op](pkg.layers,
                                                         _x(pkg, x.shape))),
                         {"x": x}, ["x@GRAD", "head_w@GRAD"])
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)


def test_sum_mean_and_sinusoid_table_match_paddle_tpu():
    x = np.random.RandomState(7).randn(2, 6, 8).astype(np.float32)

    def build(pkg):
        a = _x(pkg, x.shape)
        s = _sum_op(pkg, pkg.layers.scale(a, scale=3.0), _pos_table(pkg, a))
        return pkg.layers.mean(s)

    ref, got = _run_both(build, {"x": x}, ["x@GRAD"])
    np.testing.assert_allclose(got[0], ref[0], atol=TOL, rtol=TOL)
    table = fluid.Executor(fluid.CPUPlace())
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        t = _pos_table(fluid, _x(fluid, (6, 8)))
    jt, = table.run(main, feed={"x": np.zeros((6, 8), np.float32)},
                    fetch_list=[t], scope=fluid.Scope())
    tt, = ptt.Executor(ptt.CPUPlace()).run(
        ptt.Program.from_dict(main.to_dict()),
        feed={"x": np.zeros((6, 8), np.float32)}, fetch_list=[t.name],
        scope=ptt.Scope())
    np.testing.assert_allclose(tt, np.asarray(jt), atol=TOL, rtol=TOL)


def test_lookup_table_grad_matches_paddle_tpu():
    ids = np.random.RandomState(8).randint(0, 10, (2, 6)).astype(np.int64)
    ids[0, :3] = 4                      # repeated ids accumulate

    def build(pkg):
        i = pkg.layers.data("ids", shape=[2, 6], dtype="int64",
                            append_batch_size=False)
        return _head(pkg, pkg.layers.embedding(i, size=[10, 8],
                                               param_attr="emb"))

    ref, got = _run_both(build, {"ids": ids}, ["emb@GRAD"])
    np.testing.assert_allclose(got[0], ref[0], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("ignore", [False, True])
def test_softmax_with_cross_entropy_grad_matches_paddle_tpu(ignore):
    rng = np.random.RandomState(9)
    logits = rng.randn(2, 6, 11).astype(np.float32)
    label = rng.randint(0, 11, (2, 6)).astype(np.int64)
    if ignore:
        label[1, 2:4] = -100

    def build(pkg):
        lg = _x(pkg, logits.shape, "logits")
        lb = pkg.layers.data("label", shape=[2, 6], dtype="int64",
                             append_batch_size=False)
        loss = pkg.layers.softmax_with_cross_entropy(lg, lb)
        return _head(pkg, loss)

    ref, got = _run_both(build, {"logits": logits, "label": label},
                         ["logits@GRAD"])
    np.testing.assert_allclose(got[0], ref[0], atol=TOL, rtol=TOL)


def test_fused_attention_op_grad_matches_paddle_tpu(interpret_kernels):
    q, k, v, _ = _qkvg(10, B=1, H=2, T=128, D=16)

    def build(pkg):
        qv, kv, vv = (_x(pkg, a.shape, n) for a, n in ((q, "q"), (k, "k"),
                                                        (v, "v")))
        return _head(pkg, jtransformer._fused_attention(qv, kv, vv, 16, True,
                                                         0.0, False))

    ref, got = _run_both(build, {"q": q, "k": k, "v": v},
                         ["q@GRAD", "k@GRAD", "v@GRAD"])
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)


def test_adam_update_matches_paddle_tpu():
    x = np.random.RandomState(11).randn(4, 8).astype(np.float32)

    def build(pkg, opt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            loss = pkg.layers.mean(pkg.layers.fc(
                pkg.layers.data("x", shape=[8], dtype="float32"), 3))
            opt.Adam(learning_rate=0.01).minimize(loss)
        return main, startup

    jmain, jstartup = build(fluid, fluid.optimizer)
    tmain, _ = build(ptt, toptimizer)
    assert tmain.to_dict() == jmain.to_dict()
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    names = list(jscope.local_var_names())
    tscope = ptt.io.state_from_numpy(
        {n: np.asarray(jscope.find_var(n)) for n in names}, ptt.CPUPlace())
    before = {n: tscope.find_var(n) for n in names}
    jexe.run(jmain, feed={"x": x}, scope=jscope)
    ptt.Executor(ptt.CPUPlace()).run(tmain, feed={"x": x}, scope=tscope)
    for n in names:
        assert tscope.find_var(n) is before[n]      # updated in place
        np.testing.assert_allclose(fetch_var(n, tscope),
                                   np.asarray(jscope.find_var(n)),
                                   atol=TOL, rtol=TOL, err_msg=n)


# ---------------------------------------------------------------------------
# the slice: Transformer + Adam
# ---------------------------------------------------------------------------

def _transformer(pkg, model, opt, **kw):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, fetches = model.build(**dict(SMALL, **kw))
        opt.Adam(learning_rate=1e-3).minimize(fetches["loss"])
    return main, startup, fetches["loss"]


def test_transformer_programs_are_the_same_in_both_packages():
    jmain, jstartup, _ = _transformer(fluid, jtransformer, fluid.optimizer,
                                      dropout_rate=0.1)
    tmain, tstartup, _ = _transformer(ptt, ttransformer, toptimizer,
                                      dropout_rate=0.1)
    assert tmain.to_dict() == jmain.to_dict()
    assert tstartup.to_dict() == jstartup.to_dict()
    types = {op.type for op in tmain.global_block().ops}
    assert {"fused_attention", "fused_attention_grad", "adam",
            "dropout_grad", "sum"} <= types


def _batch(rng, B=2):
    return {n: rng.randint(0, 64, (B, 128)).astype(np.int64)
            for n in ("src_word", "trg_word", "lbl_word")}


def test_transformer_trains_like_paddle_tpu(interpret_kernels):
    """5 Adam steps at dropout 0 from the JAX startup's parameters:
    losses and parameters agree."""
    jmain, jstartup, jloss = _transformer(fluid, jtransformer,
                                          fluid.optimizer, dropout_rate=0.0)
    tmain, _, tloss = _transformer(ptt, ttransformer, toptimizer,
                                   dropout_rate=0.0)
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    arrays = {n: np.asarray(jscope.find_var(n))
              for n in jscope.local_var_names()}
    tscope = ptt.io.state_from_numpy(arrays, ptt.CPUPlace())
    texe = ptt.Executor(ptt.CPUPlace())
    rng = np.random.RandomState(12)
    native.reset_launches()
    for _ in range(5):
        feed = _batch(rng)
        ref, = jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)
        got, = texe.run(tmain, feed=feed, fetch_list=[tloss.name],
                        scope=tscope)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=0)
    assert not any(native.launches.values())
    for n in arrays:
        np.testing.assert_allclose(fetch_var(n, tscope),
                                   np.asarray(jscope.find_var(n)),
                                   atol=1e-4, rtol=0, err_msg=n)


def test_transformer_with_dropout_trains_in_the_port():
    main, startup, loss = _transformer(ptt, ttransformer, toptimizer,
                                       dropout_rate=0.1)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = _batch(np.random.RandomState(13), B=4)
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0][0]) for _ in range(10)]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_amp_is_not_ported_and_says_so():
    with pytest.raises(NotImplementedError, match="bf16"):
        ptt.Executor(ptt.CPUPlace(), amp=True)
