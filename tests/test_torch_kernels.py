"""paddle_tpu_torch kernel modules against paddle_tpu, on the CPU.

On the host the port's attention wrappers run their plain PyTorch
versions; here those are held against the JAX package's Pallas kernels
run under the Pallas interpreter (PADDLE_TPU_PALLAS_INTERPRET=1, the way
tests/test_flash_attention.py and tests/test_decode.py run them), on the
same numpy inputs. The CUDA kernels themselves are checked on the card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.ops import pallas_attention as jfa
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import native
from paddle_tpu_torch.ops import paged_attention as pa

TOL = 1e-5  # f32 summation order


@pytest.fixture
def interpret_kernels(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_pallas_forward(interpret_kernels, causal):
    rng = np.random.RandomState(0)
    B, H, T, D = 2, 2, 128, 16
    q, k, v = (rng.randn(B, H, T, D).astype(np.float32) for _ in range(3))
    sm = D ** -0.5
    ref_out, ref_lse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal, sm)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal, sm)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               atol=TOL, rtol=TOL)
    # the kernel's second output, in the port's [B, H, T] layout
    np.testing.assert_allclose(
        fa._lse_reference(tq, tk, causal, sm).numpy(),
        np.asarray(ref_lse).reshape(B, H, T), atol=TOL, rtol=TOL)


def test_flash_wrapper_paths_without_a_card():
    q = torch.randn(1, 2, 8, 16)
    native.reset_launches()
    out = fa.flash_attention(q, q, q, True, 0.25)
    torch.testing.assert_close(out, fa._attention_reference(q, q, q, True,
                                                            0.25))
    meta = fa.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"), True,
                              0.25)
    assert meta.device.type == "meta" and meta.shape == q.shape
    # attention-weight dropout on the host: the plain version, with the
    # kernels' mask (tests/test_torch_train.py checks the mask itself)
    dropped = fa.flash_attention(q, q, q, True, 0.25, dropout_rate=0.1,
                                 seed=3)
    torch.testing.assert_close(
        dropped, fa._attention_reference(q, q, q, True, 0.25, 0.1, 3))
    assert not any(native.launches.values())


def test_kernel_wrappers_refuse_grids_past_the_y_limit():
    n = native.MAX_GRID_Y + 1
    q = torch.empty(n, 1, 1, 32)
    with pytest.raises(ValueError, match="y limit"):
        fa._flash_forward(q, q, q, True, 1.0)
    q = torch.empty(n, 1, 32)
    c = torch.empty(2, 4, 1, 32)
    with pytest.raises(ValueError, match="y limit"):
        pa._paged_attention_cuda(q, c, c, torch.zeros(n, 1, dtype=torch.int32),
                                 torch.zeros(n, dtype=torch.int32), 1.0)
    q = torch.empty(n, 1, 1, 32)
    lse = torch.empty(n, 1, 1)
    with pytest.raises(ValueError, match="y limit"):
        fa._flash_dq(q, q, q, q, lse, lse, True, 1.0)
    with pytest.raises(ValueError, match="y limit"):
        fa._flash_dkv(q, q, q, q, lse, lse, True, 1.0)
    assert not any(native.launches.values())


def _random_cache(rng, S=4, H=2, Dh=8, BS=4, max_b=4):
    """Block tables drawn from a shuffled pool; seq_lens include 0 and the
    full context (max_b * BS)."""
    NB = 1 + S * max_b
    kc = rng.randn(NB, BS, H, Dh).astype(np.float32)
    vc = rng.randn(NB, BS, H, Dh).astype(np.float32)
    pool = rng.permutation(np.arange(1, NB)).astype(np.int32)
    bt = pool.reshape(S, max_b)
    seq = np.array([0, max_b * BS, 5, 1], np.int32)[:S]
    q = rng.randn(S, H, Dh).astype(np.float32)
    return q, kc, vc, bt, seq


def test_paged_plain_matches_pallas_kernel(interpret_kernels):
    rng = np.random.RandomState(2)
    q, kc, vc, bt, seq = _random_cache(rng)
    sm = 1.0 / np.sqrt(q.shape[-1])
    ref = np.asarray(jpa._paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(bt),
        jnp.asarray(seq), sm))
    native.reset_launches()
    out = pa.paged_attention(*(torch.from_numpy(x)
                               for x in (q, kc, vc, bt, seq)), sm)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    assert np.array_equal(out.numpy()[0], np.zeros_like(ref[0]))
    assert native.launches["paged_decode"] == 0


def test_paged_wrapper_meta_is_shape_only():
    q = torch.empty(4, 2, 8, device="meta")
    c = torch.empty(9, 4, 2, 8, device="meta")
    out = pa.paged_attention(q, c, c, torch.empty(4, 2, dtype=torch.int32,
                                                  device="meta"),
                             torch.empty(4, dtype=torch.int32, device="meta"))
    assert out.device.type == "meta" and out.shape == q.shape


def test_kv_cache_append_matches_reference_in_place():
    rng = np.random.RandomState(3)
    NB, BS, H, Dh = 6, 4, 2, 8
    kc = rng.randn(NB, BS, H, Dh).astype(np.float32)
    vc = rng.randn(NB, BS, H, Dh).astype(np.float32)
    bt = np.array([[2, 5], [0, 0], [1, 3]], np.int32)
    seq = np.array([6, 0, 4], np.int32)   # slot 1 inactive -> trash block
    k_new = rng.randn(3, H, Dh).astype(np.float32)
    v_new = rng.randn(3, H, Dh).astype(np.float32)
    rk, rv = jpa.kv_cache_append(*(jnp.asarray(x) for x in
                                   (kc, vc, k_new, v_new, bt, seq)))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    ok, ov = pa.kv_cache_append(tk, tv, *(torch.from_numpy(x) for x in
                                          (k_new, v_new, bt, seq)))
    assert ok is tk and ov is tv       # in place, no copy of the cache
    np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


def test_kv_cache_prefill_write_matches_reference_in_place():
    rng = np.random.RandomState(4)
    NB, BS, H, Dh, B, T = 9, 4, 2, 8, 2, 8
    kc = rng.randn(NB, BS, H, Dh).astype(np.float32)
    vc = rng.randn(NB, BS, H, Dh).astype(np.float32)
    bt = np.array([[3, 7, 0], [5, 1, 2]], np.int32)
    seq = np.array([6, 8], np.int32)   # row 0's last 2 positions are padding
    k = rng.randn(B, T, H, Dh).astype(np.float32)
    v = rng.randn(B, T, H, Dh).astype(np.float32)
    rk, rv = jpa.kv_cache_prefill_write(*(jnp.asarray(x) for x in
                                          (kc, vc, k, v, bt, seq)))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    ok, ov = pa.kv_cache_prefill_write(tk, tv, *(torch.from_numpy(x) for x in
                                                 (k, v, bt, seq)))
    assert ok is tk and ov is tv
    # block 0 takes the padding positions' writes in an unspecified order
    # on both sides (duplicate scatter indices); every other block is exact
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(rk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(rv)[1:])
    np.testing.assert_array_equal(tk.numpy()[3, :], k[0, :4])
    np.testing.assert_array_equal(tk.numpy()[7, :2], k[0, 4:6])
