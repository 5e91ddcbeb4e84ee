"""The serving kernels' plain versions at every head dim the JAX kernels
take, against paddle_tpu, on the CPU.

The port's float32 flash forward and both paged decode kernels take every
head dim D that is a multiple of 8 from 8 to 256 (the JAX flash kernel
runs for any D <= 256, its paged kernels for any D). On the host the
port's wrappers run their plain versions; here those are held against the
JAX package on the same numpy inputs, at D 8, 16, 24, 80, 96 and 256 (the
CUDA instantiations' widths and the padded head dims between them): the
flash forward against the Pallas kernel under the interpreter
(PADDLE_TPU_PALLAS_INTERPRET=1) at T 128 and 256, and against the JAX
reference at a ragged T 200 (where the JAX package runs no kernel); the
paged decode kernels against theirs under the interpreter; and a tiny
LM's greedy tokens at head dims 8 and 256 with fp32 and int8 caches. The
CUDA kernels are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as ptt
from paddle_tpu import serve as jserve
from paddle_tpu.models import tiny_lm as jtiny
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.ops import pallas_attention as jfa
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import native
from paddle_tpu_torch.ops import paged_attention as pa

# float32 summation order: a D-term dot and a T-term weighted sum, taken
# in another order by each package
TOL = 1e-5
HEAD_DIMS = [8, 16, 24, 80, 96, 256]


@pytest.fixture
def interpret_kernels(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


def _qkv(seed, B, H, T, D):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, T, D).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [128, 256, 200])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_flash_forward_matches_paddle_tpu(interpret_kernels, D, T, causal):
    """The JAX package's kernel at T 128 and 256 (its `_pallas_ok`: T a
    multiple of 128 and D <= 256), its reference at T 200."""
    q, k, v = _qkv(D * 7 + T + causal, 1, 2, T, D)
    sm = D ** -0.5
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    if T % 128 == 0:
        assert jfa._pallas_ok(jq)
        ref, ref_lse = jfa._flash_forward(jq, jk, jv, causal, sm)
        ref_lse = np.asarray(ref_lse).reshape(1, 2, T)
    else:
        ref, ref_lse = jfa._attention_reference(jq, jk, jv, causal, sm), None
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    native.reset_launches()
    out = fa.flash_attention(tq, tk, tv, causal, sm)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    if ref_lse is not None:
        np.testing.assert_allclose(
            fa._lse_reference(tq, tk, causal, sm).numpy(), ref_lse,
            atol=TOL, rtol=TOL)
    assert not any(native.launches.values())


def _paged_case(rng, Dh, S=5, H=2, BS=4, max_b=5):
    """Block tables from a shuffled pool; ragged seq_lens with 0, 1 and the
    full context among them."""
    NB = 1 + S * max_b
    kc = rng.randn(NB, BS, H, Dh).astype(np.float32)
    vc = rng.randn(NB, BS, H, Dh).astype(np.float32)
    bt = rng.permutation(np.arange(1, NB)).astype(np.int32).reshape(S, max_b)
    seq = np.array([0, max_b * BS, 7, 1, 13], np.int32)[:S]
    q = rng.randn(S, H, Dh).astype(np.float32)
    return q, kc, vc, bt, seq


@pytest.mark.parametrize("Dh", HEAD_DIMS)
def test_paged_decode_matches_paddle_tpu(interpret_kernels, Dh):
    q, kc, vc, bt, seq = _paged_case(np.random.RandomState(Dh), Dh)
    sm = Dh ** -0.5
    ref = np.asarray(jpa._paged_attention_pallas(
        *(jnp.asarray(x) for x in (q, kc, vc, bt, seq)), sm))
    out = pa.paged_attention(*(torch.from_numpy(x)
                               for x in (q, kc, vc, bt, seq)), sm)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    assert np.array_equal(out.numpy()[0], np.zeros_like(ref[0]))


@pytest.mark.parametrize("Dh", HEAD_DIMS)
def test_paged_decode_q8_matches_paddle_tpu(interpret_kernels, Dh):
    rng = np.random.RandomState(300 + Dh)
    q, _, _, bt, seq = _paged_case(rng, Dh)
    NB = 1 + bt.size
    kc, vc = (rng.randint(-127, 128, size=(NB, 4, 2, Dh)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.002, 0.02, size=NB).astype(np.float32)
              for _ in range(2))
    args = (q, kc, vc, ks, vs, bt, seq)
    sm = Dh ** -0.5
    ref = np.asarray(jpa._paged_attention_q8_pallas(
        *(jnp.asarray(x) for x in args), sm))
    out = pa.paged_attention_q8(*(torch.from_numpy(x) for x in args), sm)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    assert np.array_equal(out.numpy()[0], np.zeros_like(ref[0]))


# one or two layers, narrow: head dim 8 is d_model 64 over 8 heads, head
# dim 256 one head of 256
LM_GEOMETRY = {8: dict(d_model=64, n_heads=8, n_layers=2),
               256: dict(d_model=256, n_heads=1, n_layers=1)}
LM_KW = dict(max_slots=4, block_size=4, max_context=32,
             prefill_rows=(1, 2), prefill_seq_rungs=(8, 16))
PROMPTS = [[3, 1, 4, 1, 5], [2, 7, 1], [9, 9, 8, 2, 6, 5, 3], [1]]


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("head_dim", [8, 256])
def test_tiny_lm_greedy_tokens_equal_paddle_tpu(tmp_path, interpret_kernels,
                                                head_dim, kv_dtype):
    """One dir saved by paddle_tpu, served by both packages'
    `InferenceServer(CPUPlace())`: the same greedy tokens."""
    mdir = str(tmp_path / "lm")
    sig = jtiny.save_tiny_lm(mdir, kv_dtype=kv_dtype,
                             **LM_GEOMETRY[head_dim], **LM_KW)
    assert sig["head_dim"] == head_dim
    tokens = {}
    for name, srv in (("jax", jserve.InferenceServer(fluid.CPUPlace())),
                      ("torch", ptt.serve.InferenceServer(ptt.CPUPlace()))):
        try:
            srv.add_model(name, mdir)
            tokens[name] = [srv.generate(name, p, max_new_tokens=6).tokens
                            for p in PROMPTS]
        finally:
            srv.close()
    assert [len(t) for t in tokens["torch"]] == [6] * len(PROMPTS)
    assert tokens["torch"] == tokens["jax"]


def test_the_serving_kernels_take_every_multiple_of_8_up_to_256():
    """The shape checks of the float32 forward and both paged decode
    kernels, which run here on CPU tensors before any launch: every
    multiple of 8 from 8 to 256 passes them; 12 and 264 raise, naming the
    ROADMAP item that holds them. The training kernels' check is the same
    one (tests/test_torch_headdims_train.py holds it for each), and so
    the bf16 forward refuses 12 as the float32 one does."""
    for D in range(8, 257, 8):
        fa._check_shape(torch.empty(1, 1, 1, D), "forward")
        fa._check_shape(torch.empty(1, 1, 1, D), "dQ")
        assert pa._check_split_launch("paged", 1, 1, D, 4, 2,
                                      pa.DECODE_SPLIT)[1][-1] == D + 2
    for D in (12, 264):
        with pytest.raises(ValueError, match="head dim.*ROADMAP"):
            fa._check_shape(torch.empty(1, 1, 1, D), "forward")
        for what in ("paged decode kernel", "int8 paged decode kernel"):
            with pytest.raises(ValueError, match="head dim.*ROADMAP"):
                pa._check_split_launch(what, 1, 1, D, 4, 2, pa.DECODE_SPLIT)
        with pytest.raises(ValueError, match="head dim.*ROADMAP"):
            fa._check_shape(torch.empty(1, 1, 1, D), "dQ")
    with pytest.raises(ValueError, match="head dim"):
        fa._flash_forward(*(torch.empty(1, 1, 4, 12, dtype=torch.bfloat16),)
                          * 3, True, 0.25)
    assert not any(native.launches.values())
