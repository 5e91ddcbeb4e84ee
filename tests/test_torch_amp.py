"""paddle_tpu_torch under bf16 mixed precision (`Executor(amp=True)`)
against paddle_tpu under its own, on the CPU.

Both packages get the same numpy inputs and the same parameters; the JAX
package runs its Pallas kernels under the Pallas interpreter
(PADDLE_TPU_PALLAS_INTERPRET=1). The port's bf16 CUDA kernels are held
against their plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py; here the plain versions are held against the JAX package.

Tolerances, and why:
- one op and its grads: the SPECS AMP tolerances of
  tests/test_op_autosweep.py (rtol 2e-2, atol 2e-3; convs 5e-2, 5e-3).
  Both packages sum bf16 products in float32 and round each op's output
  to bf16, but in another order, so an output can land one bf16 ulp
  (2^-8 relative) apart;
- the flash plain versions against the interpreted Pallas kernels: lse
  to 1e-4 (float32 from exact bf16 products), each element of O, dQ, dK
  and dV within one bf16 ulp of its reference value + 2^-6 of its row's
  largest reference magnitude + 2^-16 of the tensor's (the card check's
  rule, chip_smoke.py): the Pallas kernel rounds P against its per-tile
  max, the plain version against the row's, so an output sums terms
  half a bf16 ulp apart at its row's scale (largest share of the
  tolerance seen here 0.18);
- whole models, each step from the JAX package's state: losses within
  LOSS_RTOL relative (the largest seen: 4e-5 for the Transformer, 1.2e-3
  for the ResNet). The state after a step is held to bf16's own noise:
  bf16 moves the JAX package's own grads far from its float32 ones (the
  small ResNet's batch-norm bias grads by 13 % relative L2 at the median
  and 26 % at worst; an Adam step flips the sign of a bias's update
  wherever its grad is near 0, which moves a bias that starts at 0 by
  31 % at worst). So for each kind of state (the parameters and running
  stats, and each optimizer slot) the largest relative L2 distance
  between the port's step and the JAX package's lies within NOISE_FACTOR
  times the largest that bf16 puts between the JAX package's own AMP and
  float32 steps from the same state (the largest ratio seen: 1.5). A
  free run of the Transformer over the same steps is held to
  FREE_LOSS_RTOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import lowering as jlowering
from paddle_tpu.layer_helper import LayerHelper as JLayerHelper
from paddle_tpu.core import registry as jregistry
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.ops import nn as jnn
from paddle_tpu.ops import pallas_attention as jfa

import paddle_tpu_torch as ptt
from paddle_tpu_torch import optimizer as toptimizer
from paddle_tpu_torch.core import lowering as tlowering
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.core.executor import fetch_var
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.ops import dropout_kernel as dk
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import native
from paddle_tpu_torch.ops import nn as tnn

RTOL, ATOL = 2e-2, 2e-3             # SPECS' AMP tolerances
CONV_RTOL, CONV_ATOL = 5e-2, 5e-3
FLASH_ULPS, FLASH_ROW_TOL, FLASH_ATOL, LSE_TOL = 1, 2.0 ** -6, 2.0 ** -16, 1e-4
LOSS_RTOL = 5e-3
NOISE_FACTOR = 2.0
FREE_LOSS_RTOL = 1e-2
SMALL_TRANSFORMER = dict(src_vocab_size=64, trg_vocab_size=64, seq_len=128,
                         n_layer=2, n_head=4, d_model=64, d_inner=128,
                         dropout_rate=0.0, fused_attention=True)


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


def _f32(a):
    """A fetched value as float32 numpy (the JAX package returns bf16 as
    ml_dtypes arrays, the port as float32)."""
    return np.asarray(a).astype(np.float32)


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["AMP_BF16_OPS", "AMP_F32_OPS",
                                  "AMP_DOWNCAST_OPS"])
def test_policy_sets_are_the_jax_packages(name):
    assert getattr(tregistry, name) == getattr(jregistry, name)


def test_policy_casts_and_passes_through():
    """float32 -> bf16 into a bf16 op, bf16 -> float32 into a float32 op,
    the float32 side of a mixed elementwise op down; integers and float64
    pass; nothing is cast with amp off."""
    seen = {}

    def spy(name):
        def rule(ctx, X, Y=None):
            seen[name] = (X.dtype, None if Y is None else Y.dtype)
            return {"Out": X}
        return tregistry.OpDef(name, rule, False)

    f32 = torch.zeros(2, dtype=torch.float32)
    bf16 = torch.zeros(2, dtype=torch.bfloat16)
    i64 = torch.zeros(2, dtype=torch.int64)
    f64 = torch.zeros(2, dtype=torch.float64)
    ctx = tregistry.LoweringContext({}, "cpu", amp=True)
    for op, x, y, want in (("mul", f32, i64, (torch.bfloat16, torch.int64)),
                           ("mul", f64, None, (torch.float64, None)),
                           ("mean", bf16, None, (torch.float32, None)),
                           ("elementwise_add", bf16, f32,
                            (torch.bfloat16, torch.bfloat16)),
                           ("elementwise_add", f32, f32,
                            (torch.float32, torch.float32)),
                           ("relu", f32, bf16, (torch.float32,
                                                torch.bfloat16))):
        ins = {"X": [x]} if y is None else {"X": [x], "Y": [y]}
        tregistry.call_rule(spy(op), ctx, ins)
        assert seen[op] == want, (op, seen[op])
    tregistry.call_rule(spy("mul"), tregistry.LoweringContext({}, "cpu"),
                        {"X": [f32]})
    assert seen["mul"] == (torch.float32, None)


def test_scalars_round_to_the_tensors_dtype():
    """A Python scalar meets a bf16 tensor rounded to bf16 first, as JAX's
    weak typing rounds it; float32 results do not move."""
    x = np.linspace(0.5, 4, 1000).astype(np.float32)
    s = 1.0 / (1.0 - 0.1)
    want = np.asarray(jnp.asarray(x, jnp.bfloat16) * s).astype(np.float32)
    ctx = tregistry.LoweringContext({"scale": s, "bias": 0.0}, "cpu")
    got = tregistry.get_op_def("scale").lower(
        ctx, torch.from_numpy(x).to(torch.bfloat16))["Out"]
    np.testing.assert_array_equal(got.float().numpy(), want)
    got32 = tregistry.get_op_def("scale").lower(ctx, torch.from_numpy(x))
    np.testing.assert_array_equal(got32["Out"].numpy(),
                                  np.asarray(jnp.asarray(x) * s))


# ---------------------------------------------------------------------------
# per-op parity under AMP
# ---------------------------------------------------------------------------

def _run_both(build, feed):
    """Build with paddle_tpu (`build(fluid)` returns the loss and the names
    to fetch), append its backward, load the same Program JSON into the
    port; both start from the JAX startup's parameters and take one AMP
    step on `feed`. Returns both fetch lists as float32."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, fetch = build(fluid)
        fluid.backward.append_backward(loss)
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace(), amp=True)
    jexe.run(startup, scope=jscope)
    arrays = {n: np.asarray(jscope.find_var(n))
              for n in jscope.local_var_names()}
    ref = jexe.run(main, feed=feed, fetch_list=fetch, scope=jscope)
    got = ptt.Executor(ptt.CPUPlace(), amp=True).run(
        ptt.Program.from_dict(main.to_dict()), feed=feed, fetch_list=fetch,
        scope=ptt.io.state_from_numpy(arrays, ptt.CPUPlace()))
    return [_f32(r) for r in ref], [_f32(g) for g in got]


def _head(L, out):
    """mean(out @ w) for a Xavier-initialized w: a random cotangent."""
    return L.mean(L.fc(out, 1, num_flatten_dims=len(out.shape) - 1,
                       bias_attr=False, param_attr="head_w"))


def _x(L, shape, name="x"):
    return L.data(name, shape=list(shape), dtype="float32",
                  append_batch_size=False, stop_gradient=False)


def _fc(L, x, size=8, **kw):
    return L.fc(x, size, num_flatten_dims=len(x.shape) - 1, **kw)


def _conv(L, img, fmt="NHWC"):
    return L.conv2d(img, 4, 3, padding=1, bias_attr=False, data_format=fmt)


def _sum_op(L, a, b):
    helper = JLayerHelper("sum")
    out = helper.create_variable_for_type_inference(a.dtype)
    helper.append_op("sum", inputs={"X": [a.name, b.name]},
                     outputs={"Out": [out.name]})
    return out


X3 = (2, 6, 16)
IMG_NHWC, IMG_NCHW = (2, 8, 8, 3), (2, 3, 8, 8)

# op -> (input shape, a function making the op's output from the input `x`)
_OPS = {
    "mul": (X3, lambda L, x: _fc(L, x, 5)),
    "matmul": (X3, lambda L, x: L.matmul(_fc(L, x, 16), x, transpose_y=True,
                                         alpha=0.35)),
    "conv2d_nchw": (IMG_NCHW, lambda L, x: _conv(L, x, "NCHW")),
    "conv2d_nhwc": (IMG_NHWC, lambda L, x: _conv(L, x)),
    "softmax": (X3, lambda L, x: L.softmax(_fc(L, x))),
    "elementwise_add_mixed": (X3, lambda L, x: L.elementwise_add(
        _fc(L, x, 16, bias_attr=False), x)),
    "layer_norm": (X3, lambda L, x: L.layer_norm(_fc(L, x),
                                                 begin_norm_axis=2)),
    "batch_norm": (IMG_NHWC, lambda L, x: L.batch_norm(
        _conv(L, x), data_layout="NHWC")),
    "relu": (X3, lambda L, x: L.relu(_fc(L, x))),
    "pool2d_max": (IMG_NHWC, lambda L, x: L.pool2d(
        _conv(L, x), 3, "max", 2, 1, data_format="NHWC")),
    "pool2d_avg": (IMG_NHWC, lambda L, x: L.pool2d(
        _conv(L, x), 3, "avg", 2, 1, data_format="NHWC")),
    "pool2d_global": (IMG_NHWC, lambda L, x: L.pool2d(
        _conv(L, x), pool_type="avg", global_pooling=True,
        data_format="NHWC")),
    "reshape": (X3, lambda L, x: L.reshape(_fc(L, x), shape=[0, 0, 2, 4])),
    "transpose": (X3, lambda L, x: L.transpose(
        L.reshape(_fc(L, x), [0, 0, 2, 4]), perm=[0, 2, 1, 3])),
    "scale": (X3, lambda L, x: L.scale(_fc(L, x), scale=1.0 / 0.9,
                                       bias=0.3)),
    "sum": (X3, lambda L, x: _sum_op(L, _fc(L, x), _fc(L, x))),
}


@pytest.mark.parametrize("op", sorted(_OPS))
def test_op_and_grads_match_paddle_tpu_under_amp(op):
    shape, fn = _OPS[op]
    x = np.random.RandomState(len(op)).randn(*shape).astype(np.float32)

    def build(pkg):
        out = fn(pkg.layers, _x(pkg.layers, shape))
        return _head(pkg.layers, out), [out.name, "x@GRAD", "head_w@GRAD"]

    ref, got = _run_both(build, {"x": x})
    rtol, atol = (CONV_RTOL, CONV_ATOL) if "conv" in op or "pool" in op \
        or "batch_norm" in op else (RTOL, ATOL)
    for name, a, b in zip(("out", "x@GRAD", "head_w@GRAD"), got, ref):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"{op}: {name}")


def test_lookup_table_and_losses_match_paddle_tpu_under_amp():
    """An embedding (float32: no bf16 op reaches it) into a bf16 fc, then
    softmax_with_cross_entropy (float32-listed) and, through a softmax,
    cross_entropy (float32-listed); the embedding's grad."""
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 10, (2, 6)).astype(np.int64)
    label = rng.randint(0, 7, (2, 6, 1)).astype(np.int64)

    def build(pkg):
        L = pkg.layers
        i = L.data("ids", shape=[2, 6], dtype="int64",
                   append_batch_size=False)
        lb = L.data("label", shape=[2, 6, 1], dtype="int64",
                    append_batch_size=False)
        logits = _fc(L, L.embedding(i, size=[10, 16], param_attr="emb"), 7)
        a = L.mean(L.softmax_with_cross_entropy(logits, lb))
        b = L.mean(L.cross_entropy(L.softmax(logits), lb))
        return L.elementwise_add(a, b), ["emb@GRAD"]

    ref, got = _run_both(build, {"ids": ids, "label": label})
    np.testing.assert_allclose(got[0], ref[0], rtol=RTOL, atol=ATOL)


def test_top_k_and_accuracy_match_paddle_tpu_under_amp():
    """bf16 probabilities make ties common, and torch.topk and lax.top_k
    may order tied indices differently: the accuracy is compared."""
    rng = np.random.RandomState(4)
    x = rng.randn(16, 12).astype(np.float32)
    label = rng.randint(0, 10, (16, 1)).astype(np.int64)

    def build(pkg):
        L = pkg.layers
        lb = L.data("label", shape=[16, 1], dtype="int64",
                    append_batch_size=False)
        prob = L.fc(_x(L, x.shape), 10, act="softmax")
        acc = L.accuracy(prob, lb, k=3)
        return L.mean(L.cross_entropy(prob, lb)), [acc.name]

    ref, got = _run_both(build, {"x": x, "label": label})
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-6)


def test_fused_attention_matches_paddle_tpu_under_amp(interpret_kernels):
    """float32 q, k, v cast to bf16 by the policy: the port's bf16 plain
    versions against the JAX package's interpreted bf16 kernels."""
    rng = np.random.RandomState(10)
    q, k, v = (rng.randn(1, 2, 128, 16).astype(np.float32) for _ in range(3))

    def build(pkg):
        L = pkg.layers
        qv, kv, vv = (_x(L, a.shape, n) for a, n in ((q, "q"), (k, "k"),
                                                      (v, "v")))
        return (_head(L, jtransformer._fused_attention(qv, kv, vv, 16, True,
                                                        0.0, False)),
                ["q@GRAD", "k@GRAD", "v@GRAD", "head_w@GRAD"])

    ref, got = _run_both(build, {"q": q, "k": k, "v": v})
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the bf16 plain versions of the kernels
# ---------------------------------------------------------------------------

def _bf16_pair(a):
    """The same bf16 values in both packages, from float32 numpy."""
    return (jnp.asarray(a, jnp.bfloat16),
            torch.from_numpy(a).to(torch.bfloat16))


def _assert_flash_close(got, want, what):
    """Per element: FLASH_ULPS bf16 ulps of |want| + FLASH_ROW_TOL x the
    row's max |want| (a row: D values) + FLASH_ATOL x the max of all."""
    assert got.dtype == torch.bfloat16, what
    want = _f32(want)
    err = np.abs(got.float().numpy() - want)
    mag = np.abs(want)
    _, e = np.frexp(np.maximum(mag, 2.0 ** -126))   # mag = m 2^e, m in [.5, 1)
    tol = (FLASH_ULPS * np.ldexp(1.0, e - 8)
           + FLASH_ROW_TOL * mag.max(-1, keepdims=True)
           + FLASH_ATOL * mag.max())
    assert (err <= tol).all(), (what, (err / tol).max(), err.max())


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bf16_plain_versions_match_pallas(interpret_kernels, causal):
    rng = np.random.RandomState(20 + causal)
    B, H, T, D = 1, 2, 256, 64
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (
        _bf16_pair(rng.randn(B, H, T, D).astype(np.float32))
        for _ in range(4))
    sm = D ** -0.5
    o, lse = jfa._flash_forward(jq, jk, jv, causal, sm)
    assert o.dtype == jnp.bfloat16 and lse.dtype == jnp.float32
    _assert_flash_close(fa._attention_reference(tq, tk, tv, causal, sm),
                        o, "out")
    np.testing.assert_allclose(fa._lse_reference(tq, tk, causal, sm).numpy(),
                               np.asarray(lse).reshape(B, H, T),
                               atol=LSE_TOL, rtol=0)
    ref = jfa._flash_backward(jq, jk, jv, o, lse, jg, causal, sm, 0.0, 0)
    to = torch.from_numpy(_f32(o)).to(torch.bfloat16)
    tlse = torch.from_numpy(np.asarray(lse).reshape(B, H, T))
    got = fa._flash_backward_reference(tq, tk, tv, to, tlse, tg, causal, sm)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert b.dtype == jnp.bfloat16
        _assert_flash_close(a, b, name)


def test_flash_bf16_autograd_on_the_host_is_the_plain_versions():
    q, k, v, g = (torch.randn(1, 2, 128, 32).to(torch.bfloat16)
                  for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    native.reset_launches()
    out = fa.flash_attention(*leaves, True, 0.2, 0.1, 7)
    grads = torch.autograd.grad(out, leaves, g)
    assert not any(native.launches.values())
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, fa._attention_reference(q, k, v, True, 0.2, 0.1,
                                                    7))
    lse = fa._lse_reference(q, k, True, 0.2)
    for a, b in zip(grads, fa._flash_backward_reference(
            q, k, v, out.detach(), lse, g, True, 0.2, 0.1, 7)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


# ---------------------------------------------------------------------------
# bf16 rules bit for bit (ROADMAP Queue 3, and the elementwise, sigmoid,
# concat and reduce_sum rules)
# ---------------------------------------------------------------------------

def _bits(a):
    """bf16 values as their 16-bit patterns (NaN payloads aside, equal
    patterns are equal values)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _rules(op, attrs, jins, tins, amp=False):
    """The JAX rule (called op by op, each jnp op rounding to its dtype as
    the rule is written) and the port's (through `call_rule`, with the AMP
    policy when `amp`) on the same inputs."""
    ref = jregistry.get_op_def(op).lower(jregistry.LoweringContext(attrs),
                                         **jins)
    got = tregistry.call_rule(
        tregistry.get_op_def(op),
        tregistry.LoweringContext(attrs, "cpu", amp=amp),
        {k: v if isinstance(v, list) else [v] for k, v in tins.items()})
    return ref, {k: v[0] for k, v in got.items()}


def test_softmax_bf16_is_the_jax_rule_bit_for_bit():
    """ROADMAP Queue 3 item 1, on its input: X bf16 [8, 64] from
    RandomState(0).randn, axis -1. The JAX rule rounds exp(x - max), the
    sum and the quotient to bf16; torch's bf16 softmax rounds once (52.5 %
    of these outputs one ulp off before the repair)."""
    x = np.random.RandomState(0).randn(8, 64).astype(np.float32)
    jx, tx = _bf16_pair(x)
    ref, got = _rules("softmax", {"axis": -1}, {"X": jx}, {"X": tx})
    assert got["Out"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got["Out"]), _bits(ref["Out"]))
    assert not torch.equal(got["Out"], torch.softmax(tx, -1))
    # float32 is what it was: torch's softmax, bit for bit
    t32 = torch.from_numpy(x)
    _, got32 = _rules("softmax", {"axis": -1}, {"X": jnp.asarray(x)},
                      {"X": t32})
    assert torch.equal(got32["Out"], torch.softmax(t32, -1))


def test_softmax_bf16_max_takes_no_grad():
    """The bf16 rule's grad is the transpose of its rounding chain with
    the row max held constant, as `jax.nn.softmax` stops the max's grad:
    (dy / s - sum(dy * (1 / (s * s)) * e)) * e, the sum in float32
    rounded once."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(6, 40).astype(np.float32) * 3).to(
        torch.bfloat16).requires_grad_(True)
    dy = torch.from_numpy(rng.randn(6, 40).astype(np.float32)).to(
        torch.bfloat16)
    ctx = tregistry.LoweringContext({"axis": -1}, "cpu")
    got, = torch.autograd.grad(
        tregistry.get_op_def("softmax").lower(ctx, x)["Out"], x, dy)
    xd = x.detach()
    e = torch.exp(xd - xd.amax(-1, keepdim=True))
    s = e.sum(-1, keepdim=True, dtype=torch.float32).to(torch.bfloat16)
    ct_s = -(dy * (1.0 / (s * s)) * e).sum(
        -1, keepdim=True, dtype=torch.float32).to(torch.bfloat16)
    want = (dy / s + ct_s) * e
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_softmax_bf16_grad_over_two_entries_is_the_jax_rules_bit_for_bit():
    """Over an axis of two entries (the stacked LSTM's class head) the
    cotangent sum is one add, so the bf16 rule's grad is the JAX rule's
    vjp, op by op, bit for bit, where torch's autograd of the same
    chain is not (the control)."""
    rng = np.random.RandomState(8)
    x = rng.randn(64, 2).astype(np.float32) * 3
    dy = rng.randn(64, 2).astype(np.float32)
    rule = jregistry.get_op_def("softmax").lower
    with jax.disable_jit():
        _, vjp = jax.vjp(
            lambda a: rule(jregistry.LoweringContext({"axis": -1}),
                           X=a)["Out"], jnp.asarray(x, jnp.bfloat16))
        want, = vjp(jnp.asarray(dy, jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    dyt = torch.from_numpy(dy).to(torch.bfloat16)
    got, = torch.autograd.grad(
        tregistry.get_op_def("softmax").lower(
            tregistry.LoweringContext({"axis": -1}, "cpu"), xt)["Out"],
        xt, dyt)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    e = torch.exp(xt - xt.detach().amax(-1, keepdim=True))
    chain, = torch.autograd.grad(
        e / e.sum(-1, keepdim=True, dtype=torch.float32).to(torch.bfloat16),
        xt, dyt)
    assert not np.array_equal(_bits(chain), _bits(want))


_POOL_ATTRS = {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
               "paddings": [1, 1], "exclusive": True}


@pytest.mark.parametrize("case", ["roadmap", "inclusive", "nchw",
                                  "no_pad"])
def test_windowed_avg_pool_bf16_is_the_jax_rule_bit_for_bit(case):
    """ROADMAP Queue 3 item 2 on its input ("roadmap": X bf16 NHWC
    [2, 8, 8, 4] from randn, ksize 3, stride 2, pad 1, exclusive; 61.7 %
    of the outputs differed before the repair) and its neighbours. The
    JAX rule sums the window with `lax.reduce_window` in bf16, one add a
    window element, and divides by the count in bf16. (XLA's CPU emitter
    adds in row-major window order in each of these configurations and in
    column-major order where a pad reaches half the window, as in a 2 x 2
    window with pad 1; the port adds in row-major order.)"""
    attrs = dict(_POOL_ATTRS, data_format="NHWC")
    shape = (2, 8, 8, 4)
    if case == "inclusive":
        attrs["exclusive"] = False
    elif case == "nchw":
        attrs["data_format"], shape = "NCHW", (2, 4, 8, 8)
    elif case == "no_pad":
        attrs.update(ksize=[2, 3], strides=[1, 2], paddings=[0, 0])
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    jx, tx = _bf16_pair(x)
    ref, got = _rules("pool2d", attrs, {"X": jx}, {"X": tx})
    assert got["Out"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got["Out"]), _bits(ref["Out"]))
    if case == "roadmap":
        # float32 is what it was: torch's avg_pool2d on a contiguous NCHW
        # copy
        t32 = torch.from_numpy(x)
        _, got32 = _rules("pool2d", attrs, {"X": jnp.asarray(x)},
                          {"X": t32})
        want = torch.nn.functional.avg_pool2d(
            t32.permute(0, 3, 1, 2).contiguous(), 3, 2, 1,
            count_include_pad=False).permute(0, 2, 3, 1)
        assert torch.equal(got32["Out"], want)


def _one_op_step(pkg, op, x):
    """`op` over a bf16 `data` var of x's shape, run by `pkg`'s
    Executor on the CPU (the JAX package's jits the step)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        v = pkg.layers.data("x", shape=list(x.shape), dtype="bfloat16",
                            append_batch_size=False)
        out = pkg.layers.softmax(v) if op == "softmax" else pkg.layers.pool2d(
            v, pool_size=3, pool_type="avg", pool_stride=2, pool_padding=1,
            exclusive=True, data_format="NHWC")
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup)
    y, = exe.run(main, feed={"x": x}, fetch_list=[out], return_numpy=False)
    return _bits(y)


@pytest.mark.parametrize("case", ["softmax", "pool2d", "softmax-causal"])
def test_bf16_softmax_and_pool_against_the_jitted_executor(case):
    """The JAX package's Executor jits its step, and XLA may then keep an
    intermediate in float32. On ROADMAP Queue 3's two inputs ("softmax",
    "pool2d") the jitted step gives the bits of the rule called op by op,
    and so does the port's Executor; the one-rounding rules the port had
    before (torch's bf16 softmax, avg_pool2d on a bf16 copy) differ in
    52.5 % and 53.1 % of the elements. On causally masked scores
    ("softmax-causal") the jitted step leaves the op-by-op rule in a few
    elements: the port still gives the op-by-op rule's bits, and lies
    nearer the jitted step than the one-rounding softmax
    (tools/torch_bf16_rules_vs_jit.py prints these shares)."""
    op = case.split("-")[0]
    if case == "softmax":
        x = np.random.RandomState(0).randn(8, 64).astype(np.float32)
    elif case == "pool2d":
        x = np.random.RandomState(0).randn(2, 8, 8, 4).astype(np.float32)
    else:
        t = 256
        x = (np.random.RandomState(2).randn(4, t, t).astype(np.float32)
             + np.triu(np.full((t, t), -1e9, np.float32), 1))
    jx, tx = _bf16_pair(x)
    jit = _one_op_step(fluid, op, np.asarray(jx))
    got = _one_op_step(ptt, op, tx)
    if op == "softmax":
        before = torch.softmax(tx, -1)
    else:
        before = torch.nn.functional.avg_pool2d(
            tx.permute(0, 3, 1, 2).contiguous(), 3, 2, 1,
            count_include_pad=False).permute(0, 2, 3, 1).contiguous()
    before_share = float((_bits(before) != jit).mean())
    if case == "softmax-causal":
        eager = jregistry.get_op_def("softmax").lower(
            jregistry.LoweringContext({"axis": -1}), X=jx)["Out"]
        np.testing.assert_array_equal(got, _bits(eager))
        assert float((got != jit).mean()) < before_share
    else:
        np.testing.assert_array_equal(got, jit)
        assert before_share > 0.5


_ELEMENTWISE = ["elementwise_sub", "elementwise_mul", "elementwise_div",
                "elementwise_max", "elementwise_min", "elementwise_pow"]


@pytest.mark.parametrize("op", _ELEMENTWISE)
@pytest.mark.parametrize("axis", [-1, 1])
def test_elementwise_bf16_is_the_jax_rule_bit_for_bit(op, axis):
    rng = np.random.RandomState(31)
    x = rng.randn(4, 6, 16).astype(np.float32)
    if op == "elementwise_pow":
        x = np.abs(x) + 0.5
    y = rng.randn(*((4, 6, 16) if axis == -1 else (6,))).astype(np.float32)
    (jx, tx), (jy, ty) = _bf16_pair(x), _bf16_pair(y)
    ref, got = _rules(op, {"axis": axis}, {"X": jx, "Y": jy},
                      {"X": tx, "Y": ty})
    assert got["Out"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got["Out"]), _bits(ref["Out"]))


@pytest.mark.parametrize("op", _ELEMENTWISE)
def test_mixed_elementwise_under_the_policy(op):
    """bf16 X with a float32 Y through the AMP policy: the five ops of
    AMP_DOWNCAST_OPS cast Y down and give bf16, the JAX rule's result on
    (X, bf16(Y)) bit for bit; elementwise_pow is in no set and promotes
    to float32, as jnp.power promotes."""
    rng = np.random.RandomState(32)
    x = (np.abs(rng.randn(4, 16)) + 0.5).astype(np.float32)
    y = rng.randn(4, 16).astype(np.float32)
    jx, tx = _bf16_pair(x)
    down = op in tregistry.AMP_DOWNCAST_OPS
    assert down == (op != "elementwise_pow")
    jy = jnp.asarray(y, jnp.bfloat16) if down else jnp.asarray(y)
    ref, got = _rules(op, {"axis": -1}, {"X": jx, "Y": jy},
                      {"X": tx, "Y": torch.from_numpy(y)}, amp=True)
    if down:
        assert got["Out"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got["Out"]), _bits(ref["Out"]))
    else:
        assert got["Out"].dtype == torch.float32
        assert ref["Out"].dtype == jnp.float32
        np.testing.assert_allclose(got["Out"].numpy(), np.asarray(ref["Out"]),
                                   rtol=1e-6)


@pytest.mark.parametrize("case", ["sigmoid", "concat", "reduce_sum-dim",
                                  "reduce_sum-keep", "reduce_sum-all"])
def test_sigmoid_concat_reduce_sum_bf16_are_the_jax_rules_bit_for_bit(case):
    """sigmoid: 1 / (1 + exp(-x)) rounded at each step, as lax.logistic
    (torch's bf16 sigmoid rounds once: 29 % of these one ulp off);
    reduce_sum: added in float32 and rounded once, as jnp.sum."""
    rng = np.random.RandomState(33)
    (jx, tx), (jy, ty) = (_bf16_pair(rng.randn(4, 6, 16).astype(np.float32)
                                     * 3) for _ in range(2))
    op = case.split("-")[0]
    attrs, jins, tins = {}, {"X": jx}, {"X": tx}
    if op == "concat":
        attrs, jins, tins = {"axis": 1}, {"X": [jx, jy]}, {"X": [tx, ty]}
    elif case == "reduce_sum-dim":
        attrs = {"dim": [1], "keep_dim": False}
    elif case == "reduce_sum-keep":
        attrs = {"dim": [1, 2], "keep_dim": True}
    elif case == "reduce_sum-all":
        attrs = {"reduce_all": True}
    ref, got = _rules(op, attrs, jins, tins)
    assert got["Out"].dtype == torch.bfloat16
    assert tuple(got["Out"].shape) == tuple(ref["Out"].shape)
    np.testing.assert_array_equal(_bits(got["Out"]), _bits(ref["Out"]))


def test_sigmoid_bf16_grad_is_logistics():
    """The bf16 sigmoid's grad is g * y * (1 - y), finite where exp(-x)
    overflows."""
    x = torch.tensor([-100.0, -3.0, 0.0, 2.0, 100.0],
                     dtype=torch.bfloat16).requires_grad_(True)
    ctx = tregistry.LoweringContext({}, "cpu")
    y = tregistry.get_op_def("sigmoid").lower(ctx, x)["Out"]
    g, = torch.autograd.grad(y.sum(), x)
    assert torch.isfinite(g).all()
    yd = y.detach()
    assert torch.equal(g, yd * (1.0 - yd))


# ---------------------------------------------------------------------------
# dropout in bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [0.1, 0.3])
def test_bits_dropout_bf16_equals_paddle_tpu_bit_for_bit(p):
    seed = 0x1234567890ABCDEF
    key = jax.random.wrap_key_data(np.array([seed & 0xFFFFFFFF, seed >> 32],
                                            np.uint32))
    x = np.random.RandomState(5).randn(4, 64, 32).astype(np.float32)
    jx, tx = _bf16_pair(x)
    scale = 1.0 / (1.0 - p)
    ref = jnn._bits_dropout(jx, key, p, scale)
    got, _ = tnn._bits_dropout(tx, tnn.seed32(seed), p, scale)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(ref).view(np.int16))


def test_dropout_kernel_plain_bf16_keeps_the_f32_bits_and_rounds_the_scale():
    x = torch.randn(8, 256)
    xb = x.to(torch.bfloat16)
    out, mask = dk.dropout_reference(xb, 99, 0.1)
    out32, mask32 = dk.dropout_reference(x, 99, 0.1)
    assert out.dtype == mask.dtype == torch.bfloat16
    assert torch.equal(mask.float(), mask32)
    inv = dk.drop_scale(0.1, torch.bfloat16)
    assert inv == 1.109375 == float(jnp.asarray(1.0 / 0.9, jnp.bfloat16))
    assert dk.drop_scale(0.1, torch.float32) == fa._drop_scale(0.1)
    kept = mask.bool()
    assert torch.equal(out[kept], (xb[kept].float() * inv).to(torch.bfloat16))
    assert not out[~kept].any()


# ---------------------------------------------------------------------------
# the two models: dtype map and training steps
# ---------------------------------------------------------------------------

def _transformer(pkg, model, opt):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, fetches = model.build(**SMALL_TRANSFORMER)
        opt.Adam(learning_rate=1e-3).minimize(fetches["loss"])
    return main, startup, fetches["loss"]


def _resnet(pkg, model, opt):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        image = pkg.layers.data("image", shape=[32, 32, 3], dtype="float32")
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        predict = model.resnet_cifar10(image, class_dim=10, depth=8,
                                       data_format="NHWC")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(predict, label))
        opt.Momentum(learning_rate=1e-3, momentum=0.9).minimize(loss)
    return main, startup, loss


def _transformer_feeds(n, B=2):
    rng = np.random.RandomState(12)
    return [{k: rng.randint(0, 64, (B, 128)).astype(np.int64)
             for k in ("src_word", "trg_word", "lbl_word")}
            for _ in range(n)]


def _resnet_feeds(n, B=8):
    rng = np.random.RandomState(14)
    return [{"image": rng.rand(B, 32, 32, 3).astype(np.float32),
             "label": rng.randint(0, 10, (B, 1)).astype(np.int64)}
            for _ in range(n)]


_MODELS = {"transformer": (_transformer, jtransformer, ttransformer,
                           _transformer_feeds),
           "resnet_cifar10": (_resnet, jresnet, tresnet, _resnet_feeds)}


def _dtypes_of_both(model, feed):
    """One AMP step of `model` in each package: {var: dtype} of every var
    the step writes, spied on the JAX package's BlockLowerer._run_op and
    the port's op loop."""
    build, jmodel, tmodel, _ = _MODELS[model]
    jmain, jstartup, jloss = build(fluid, jmodel, fluid.optimizer)
    tmain, _, tloss = build(ptt, tmodel, toptimizer)
    jseen, tseen = {}, {}
    jrun = jlowering.BlockLowerer._run_op

    def jspy(self, block, op, op_idx, env, key):
        jrun(self, block, op, op_idx, env, key)
        for n in op.output_arg_names:
            if hasattr(env.get(n), "dtype"):
                jseen[n] = str(env[n].dtype)

    trun, tgrad = tlowering._run_op, tlowering._run_grad_op

    def record(op, env):
        for n in op.output_arg_names:
            if isinstance(env.get(n), torch.Tensor):
                tseen[n] = str(env[n].dtype).replace("torch.", "")

    def tspy(op, op_idx, env, *a, **kw):
        trun(op, op_idx, env, *a, **kw)
        record(op, env)

    def tgspy(op, env, *a, **kw):
        tgrad(op, env, *a, **kw)
        record(op, env)

    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace(), amp=True)
    jexe.run(jstartup, scope=jscope)
    arrays = {n: np.asarray(jscope.find_var(n))
              for n in jscope.local_var_names()}
    tscope = ptt.io.state_from_numpy(arrays, ptt.CPUPlace())
    jlowering.BlockLowerer._run_op = jspy
    tlowering._run_op, tlowering._run_grad_op = tspy, tgspy
    try:
        jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)
        ptt.Executor(ptt.CPUPlace(), amp=True).run(
            tmain, feed=feed, fetch_list=[tloss.name], scope=tscope)
    finally:
        jlowering.BlockLowerer._run_op = jrun
        tlowering._run_op, tlowering._run_grad_op = trun, tgrad
    return jseen, tseen


# top_k's Indices: int64 in the port, int32 in the x32 JAX package
_INDEX_DTYPES = {("int32", "int64")}


@pytest.mark.parametrize("model", sorted(_MODELS))
def test_every_var_has_the_jax_packages_dtype(interpret_kernels, model):
    jseen, tseen = _dtypes_of_both(model, _MODELS[model][3](1)[0])
    assert set(jseen) == set(tseen)
    differ = {n: (jseen[n], tseen[n]) for n in jseen
              if jseen[n] != tseen[n]
              and (jseen[n], tseen[n]) not in _INDEX_DTYPES}
    assert not differ, differ
    assert "bfloat16" in set(tseen.values())
    assert "float32" in set(tseen.values())


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _state_kind(name):
    for slot in ("moment1", "moment2", "velocity", "pow_acc"):
        if slot in name:
            return slot
    return "parameters and running stats"


@pytest.mark.parametrize("model", sorted(_MODELS))
def test_amp_steps_match_paddle_tpu_from_its_state(interpret_kernels, model):
    """3 AMP steps, each from the JAX package's AMP state after the step
    before: the losses within LOSS_RTOL; after each step, for each kind of
    state, the largest relative L2 distance to the JAX package within
    NOISE_FACTOR times the largest between the JAX package's AMP and
    float32 steps from the same state (module doc)."""
    build, jmodel, tmodel, feeds_of = _MODELS[model]
    jmain, jstartup, jloss = build(fluid, jmodel, fluid.optimizer)
    tmain, _, tloss = build(ptt, tmodel, toptimizer)
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace(), amp=True)
    jexe32 = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    names = list(jscope.local_var_names())
    texe = ptt.Executor(ptt.CPUPlace(), amp=True)
    native.reset_launches()
    for feed in feeds_of(3):
        state = {n: np.asarray(jscope.find_var(n)) for n in names}
        tscope = ptt.io.state_from_numpy(state, ptt.CPUPlace())
        scope32 = fluid.Scope()
        for n, v in state.items():
            scope32.set_var(n, v.copy())
        jexe32.run(jmain, feed=feed, fetch_list=[jloss], scope=scope32)
        ref, = jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)
        got, = texe.run(tmain, feed=feed, fetch_list=[tloss.name],
                        scope=tscope)
        assert got.dtype == np.float32 and got[0] > 0.1
        np.testing.assert_allclose(got, _f32(ref), rtol=LOSS_RTOL, atol=0)
        dist, noise = {}, {}
        for n in names:
            want = np.asarray(jscope.find_var(n))
            if not np.issubdtype(want.dtype, np.floating):
                continue
            got_n = fetch_var(n, tscope)
            assert got_n.dtype == np.float32, n
            kind = _state_kind(n)
            dist[kind] = max(dist.get(kind, 0.0), _rel_l2(got_n, want))
            noise[kind] = max(noise.get(kind, 0.0), _rel_l2(
                np.asarray(scope32.find_var(n)), want))
        for kind, d in dist.items():
            assert d <= NOISE_FACTOR * noise[kind], (kind, d, noise[kind])
    assert not any(native.launches.values())


def test_transformer_free_run_under_amp(interpret_kernels):
    """The same 3 steps as a free run: the two packages' bf16 roundings
    compound, so the losses are held to FREE_LOSS_RTOL."""
    jmain, jstartup, jloss = _transformer(fluid, jtransformer,
                                          fluid.optimizer)
    tmain, _, tloss = _transformer(ptt, ttransformer, toptimizer)
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace(), amp=True)
    jexe.run(jstartup, scope=jscope)
    tscope = ptt.io.state_from_numpy(
        {n: np.asarray(jscope.find_var(n))
         for n in jscope.local_var_names()}, ptt.CPUPlace())
    texe = ptt.Executor(ptt.CPUPlace(), amp=True)
    for feed in _transformer_feeds(3):
        ref, = jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)
        got, = texe.run(tmain, feed=feed, fetch_list=[tloss.name],
                        scope=tscope)
        np.testing.assert_allclose(got, _f32(ref), rtol=FREE_LOSS_RTOL,
                                   atol=0)


def test_amp_executor_on_the_host_leaves_cublas_alone():
    """Only an AMP executor on a card changes cuBLAS's process-wide bf16
    reduction setting (tests/test_torch_cuda.py holds that side)."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    ptt.Executor(ptt.CPUPlace(), amp=True)
    assert matmul.allow_bf16_reduced_precision_reduction == before
