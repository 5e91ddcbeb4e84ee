"""The training kernels' plain versions at every head dim the JAX kernels
take, against paddle_tpu, on the CPU.

The port's flash kernels (the forward, dQ, dK/dV and delta, in float32
and bf16) take every head dim D that is a multiple of 8 from 8 to 256, as
the JAX package trains through its Pallas forward and backward for any
D <= 256 (`_pallas_ok`). On the host the port's wrappers run their plain
versions; here those are held against the JAX package on the same numpy
inputs at D 8, 16, 24, 80, 96 and 256 (the CUDA instantiations' widths
and head dims padded into one): the float32 backward and the bf16
forward and backward against the Pallas kernels under the interpreter
(PADDLE_TPU_PALLAS_INTERPRET=1), the delta against the JAX package's,
the autograd Function against `jax.grad`, and a fused-attention
Transformer trained a few steps at head dims 8 and 256 in float32 and
under AMP. The CUDA kernels are held against the plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances, and why:
- one kernel in float32: TOL (1e-5, absolute and relative), float32
  summation order, as tests/test_torch_train.py holds D 16;
- one kernel in bf16: tests/test_torch_amp.py's rule, lse to 1e-4 and
  each element of O, dQ, dK and dV within one bf16 ulp of the JAX value
  + 2^-6 of its row's largest magnitude + 2^-16 of the tensor's (the
  Pallas kernel rounds P against its tile's running max, the plain
  version against the row's);
- the delta: each row within DELTA_TOL (1e-5) of its sum of |dO O|, the
  card check's rule: the same float32 sum of exact (bf16) or once rounded
  (float32) products, in another order, where a row's terms may cancel;
- a Transformer: float32 losses to 1e-4 relative and parameters to 1e-4
  absolute over a free run (tests/test_torch_train.py's); under AMP each
  step from the JAX package's AMP state, losses to 5e-3 relative
  (tests/test_torch_amp.py's LOSS_RTOL).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.ops import pallas_attention as jfa

import paddle_tpu_torch as ptt
from paddle_tpu_torch import optimizer as toptimizer
from paddle_tpu_torch.core.executor import fetch_var
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import native

TOL = 1e-5
FLASH_ULPS, FLASH_ROW_TOL, FLASH_ATOL, LSE_TOL = 1, 2.0 ** -6, 2.0 ** -16, 1e-4
DELTA_TOL = 1e-5
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-4
AMP_LOSS_RTOL = 5e-3
HEAD_DIMS = [8, 16, 24, 80, 96, 256]
# the Transformers at the two ends: the JAX package's tiny configurations
# (d_model 16 over 2 heads) and Gemma's head dim (one head of 256)
MODELS = {8: dict(d_model=16, n_head=2, d_inner=32),
          256: dict(d_model=256, n_head=1, d_inner=64)}
MODEL_KW = dict(src_vocab_size=64, trg_vocab_size=64, seq_len=128,
                n_layer=1, dropout_rate=0.0, fused_attention=True)
STEPS = 3


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


def _arrays(seed, D, T, n=4, B=1, H=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, T, D).astype(np.float32) for _ in range(n)]


def _f32(a):
    return np.asarray(a).astype(np.float32)


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


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [128, 256])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_flash_backward_plain_matches_pallas(interpret_kernels, D, T,
                                             causal):
    q, k, v, g = _arrays(D * 11 + T + causal, D, T)
    sm = D ** -0.5
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    assert jfa._pallas_ok(jq)
    o, lse = jfa._flash_forward(jq, jk, jv, causal, sm)
    ref = jfa._flash_backward(jq, jk, jv, o, lse, jg, causal, sm, 0.0, 0)
    native.reset_launches()
    got = fa._flash_backward_reference(
        *map(torch.from_numpy, (q, k, v, np.array(o))),
        torch.from_numpy(np.array(lse).reshape(1, 2, T)),
        torch.from_numpy(g), causal, sm)
    assert not any(native.launches.values())
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=TOL, err_msg=f"d{name}")


def _bf16_pair(a):
    """The same bf16 values in both packages, from float32 numpy."""
    return (jnp.asarray(a, jnp.bfloat16),
            torch.from_numpy(a).to(torch.bfloat16))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_flash_bf16_plain_versions_match_pallas(interpret_kernels, D, causal):
    T = 128
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (
        _bf16_pair(a) for a in _arrays(D * 13 + causal, D, T))
    sm = D ** -0.5
    o, lse = jfa._flash_forward(jq, jk, jv, causal, sm)
    assert o.dtype == jnp.bfloat16 and lse.dtype == jnp.float32
    _assert_flash_close(fa._attention_reference(tq, tk, tv, causal, sm),
                        o, "out")
    np.testing.assert_allclose(fa._lse_reference(tq, tk, causal, sm).numpy(),
                               np.asarray(lse).reshape(1, 2, T),
                               atol=LSE_TOL, rtol=0)
    ref = jfa._flash_backward(jq, jk, jv, o, lse, jg, causal, sm, 0.0, 0)
    to = torch.from_numpy(_f32(o)).to(torch.bfloat16)
    tlse = torch.from_numpy(np.array(lse).reshape(1, 2, T))
    got = fa._flash_backward_reference(tq, tk, tv, to, tlse, tg, causal, sm)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert b.dtype == jnp.bfloat16
        _assert_flash_close(a, b, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_flash_delta_matches_the_jax_packages_delta(D, dtype):
    """paddle_tpu/ops/pallas_attention.py computes delta as
    sum(f32(dO) * f32(O)) over D, outside its kernels; `flash_delta` on a
    host tensor is the plain version, launching nothing."""
    o, do = _arrays(D + 5, D, 200, n=2, B=2, H=3)
    jo, jdo = (jnp.asarray(x).astype(dtype) for x in (o, do))
    to, tdo = (torch.from_numpy(x).to(getattr(torch, dtype))
               for x in (o, do))
    want = np.asarray(jnp.sum(jdo.astype(jnp.float32)
                              * jo.astype(jnp.float32), axis=-1))
    native.reset_launches()
    got = fa.flash_delta(to, tdo)
    assert not any(native.launches.values())
    assert got.dtype == torch.float32 and got.shape == (2, 3, 200)
    scale = np.abs(_f32(jdo) * _f32(jo)).sum(-1)
    assert (np.abs(got.numpy() - want) <= DELTA_TOL * scale).all(), \
        (np.abs(got.numpy() - want) / scale).max()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [8, 256])
def test_flash_autograd_function_matches_jax_grad(interpret_kernels, D,
                                                  causal):
    q, k, v, g = _arrays(D + causal, D, 128)
    sm = D ** -0.5

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


def test_every_kernel_takes_exactly_the_head_dims_of_the_jax_kernels():
    """One set for every kernel: each multiple of 8 from 8 to 256, and a
    refusal citing ROADMAP Queue 1 item 9.4 for any other head dim."""
    assert fa.HEAD_DIMS == tuple(range(8, 257, 8))
    for what in ("forward", "dQ", "dK/dV", "delta"):
        for D in range(1, 300):
            if D in fa.HEAD_DIMS:
                fa._check_head_dim(D, what)
            else:
                with pytest.raises(ValueError, match="9.4"):
                    fa._check_head_dim(D, what)
        for D in (12, 264):
            with pytest.raises(ValueError, match=f"got {D} "):
                fa._check_head_dim(D, what)


# ---------------------------------------------------------------------------
# a Transformer trained at head dims 8 and 256
# ---------------------------------------------------------------------------

def _transformer(pkg, model, opt, head_dim):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, fetches = model.build(**dict(MODEL_KW, **MODELS[head_dim]))
        opt.Adam(learning_rate=1e-3).minimize(fetches["loss"])
    return main, startup, fetches["loss"]


def _feeds(n, B=2):
    rng = np.random.RandomState(12)
    return [{k: rng.randint(0, 64, (B, 128)).astype(np.int64)
             for k in ("src_word", "trg_word", "lbl_word")}
            for _ in range(n)]


def _attention_head_dims(program):
    """The head dims of the program's fused attentions (Q's last dim)."""
    block = program.global_block()
    return {block.var(op.input("Q")[0]).shape[-1]
            for op in block.ops if op.type == "fused_attention"}


@pytest.mark.parametrize("head_dim", [8, 256])
def test_transformer_trains_like_paddle_tpu_at_a_head_dim(interpret_kernels,
                                                          head_dim):
    """STEPS Adam steps at dropout 0 from the JAX startup's parameters, a
    free run: losses and parameters agree."""
    jmain, jstartup, jloss = _transformer(fluid, jtransformer,
                                          fluid.optimizer, head_dim)
    tmain, _, tloss = _transformer(ptt, ttransformer, toptimizer, head_dim)
    assert _attention_head_dims(tmain) == {head_dim}
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    arrays = {n: np.asarray(jscope.find_var(n))
              for n in jscope.local_var_names()}
    tscope = ptt.io.state_from_numpy(arrays, ptt.CPUPlace())
    texe = ptt.Executor(ptt.CPUPlace())
    native.reset_launches()
    losses = []
    for feed in _feeds(STEPS):
        ref, = jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)
        got, = texe.run(tmain, feed=feed, fetch_list=[tloss.name],
                        scope=tscope)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=LOSS_RTOL,
                                   atol=0)
        losses.append(float(got[0]))
    assert not any(native.launches.values())
    assert all(np.isfinite(losses))
    for n in arrays:
        np.testing.assert_allclose(fetch_var(n, tscope),
                                   np.asarray(jscope.find_var(n)),
                                   atol=PARAM_ATOL, rtol=0, err_msg=n)


@pytest.mark.parametrize("head_dim", [8, 256])
def test_amp_steps_match_paddle_tpu_at_a_head_dim(interpret_kernels,
                                                  head_dim):
    """STEPS AMP steps, each from the JAX package's AMP state after the
    step before: the losses within AMP_LOSS_RTOL, every fetched loss
    float32."""
    jmain, jstartup, jloss = _transformer(fluid, jtransformer,
                                          fluid.optimizer, head_dim)
    tmain, _, tloss = _transformer(ptt, ttransformer, toptimizer, head_dim)
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace(), amp=True)
    jexe.run(jstartup, scope=jscope)
    names = list(jscope.local_var_names())
    texe = ptt.Executor(ptt.CPUPlace(), amp=True)
    native.reset_launches()
    for feed in _feeds(STEPS):
        state = {n: np.asarray(jscope.find_var(n)) for n in names}
        tscope = ptt.io.state_from_numpy(state, ptt.CPUPlace())
        ref, = jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)
        got, = texe.run(tmain, feed=feed, fetch_list=[tloss.name],
                        scope=tscope)
        assert got.dtype == np.float32 and np.isfinite(got).all()
        np.testing.assert_allclose(got, _f32(ref), rtol=AMP_LOSS_RTOL,
                                   atol=0)
    assert not any(native.launches.values())
