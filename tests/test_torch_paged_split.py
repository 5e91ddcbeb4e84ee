"""The split arithmetic of the paged decode kernels against paddle_tpu, on
the CPU.

The CUDA kernels of ``csrc/paged_decode.cu`` and ``csrc/paged_decode_q8.cu``
read each slot's sequence in chunks of P positions, one block per (head,
slot, chunk), and merge the chunks' softmax states (m, l, acc) in a second
kernel. `paged_attention_split_reference` computes exactly those partials
and that merge with plain PyTorch arithmetic; here it is held against the
JAX package's Pallas kernels `_paged_attention_pallas` and
`_paged_attention_q8_pallas`, run under the Pallas interpreter
(PADDLE_TPU_PALLAS_INTERPRET=1), on the same numpy inputs, and the launch
plan (NSPLIT and the workspace shape) is checked for the serve
configurations' widths. The kernels themselves are held against the plain
version on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch.models import tiny_lm
from paddle_tpu_torch.ops import native
from paddle_tpu_torch.ops import paged_attention as pa

TOL = 1e-5  # f32 summation order


@pytest.fixture
def interpret_kernels(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


# (S, H, Dh, BS, max_b, split, seq_lens): split 8 over a 32-position table
# row unless the case says otherwise
CASES = {
    # chunks past a short seq_len are dead; seq_len 0 slots among them
    "empty_chunks": (4, 2, 32, 4, 8, 8, [5, 0, 12, 1]),
    "seq_len_0": (3, 2, 32, 4, 8, 8, [0, 0, 9]),
    # seq_len at P - 1, P, P + 1, 2P and the full row
    "chunk_boundaries": (5, 2, 32, 4, 8, 8, [7, 8, 9, 16, 32]),
    # a table row of 20 positions: the last chunk of 8 is partial
    "ragged_last_chunk": (3, 2, 32, 4, 5, 8, [20, 17, 3]),
    # P past the whole row: one chunk per slot, the merge is acc / l
    "one_chunk_per_slot": (4, 2, 32, 4, 8, 64, [32, 5, 0, 31]),
    # the float32 kernel's own P at a row of 128 positions
    "kernel_split": (3, 2, 64, 16, 8, pa.DECODE_SPLIT, [128, 65, 64]),
    # the int8 kernel's own P at a row of 320 positions
    "kernel_split_q8": (3, 2, 64, 16, 20, pa.DECODE_SPLIT_Q8,
                        [320, 129, 128]),
}


def _tables(rng, S, BS, max_b, seq):
    """Block tables from a shuffled pool; entries past ceil(seq_len / BS)
    are 0, as the serve engine leaves them."""
    NB = 1 + S * max_b
    pool = rng.permutation(np.arange(1, NB)).astype(np.int32)
    bt = np.zeros((S, max_b), np.int32)
    for s in range(S):
        n = -(-int(seq[s]) // BS)
        bt[s, :n] = pool[s * max_b: s * max_b + n]
    return NB, bt


def _fp32_case(name):
    S, H, Dh, BS, max_b, split, seq = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    NB, bt = _tables(rng, S, BS, max_b, seq)
    kc = rng.randn(NB, BS, H, Dh).astype(np.float32)
    vc = rng.randn(NB, BS, H, Dh).astype(np.float32)
    q = rng.randn(S, H, Dh).astype(np.float32)
    return (q, kc, vc, bt, np.asarray(seq, np.int32)), split


def _q8_case(name):
    S, H, Dh, BS, max_b, split, seq = CASES[name]
    rng = np.random.RandomState(1 + sum(map(ord, name)))
    NB, bt = _tables(rng, S, BS, max_b, seq)
    kc = rng.randint(-127, 128, size=(NB, BS, H, Dh)).astype(np.int8)
    vc = rng.randint(-127, 128, size=(NB, BS, H, Dh)).astype(np.int8)
    ks = rng.uniform(0.002, 0.03, size=NB).astype(np.float32)
    vs = rng.uniform(0.002, 0.03, size=NB).astype(np.float32)
    q = rng.randn(S, H, Dh).astype(np.float32)
    return (q, kc, vc, ks, vs, bt, np.asarray(seq, np.int32)), split


def _torch(arrays):
    return [torch.from_numpy(x) for x in arrays]


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_arithmetic_matches_pallas_kernel(interpret_kernels, name):
    args, split = _fp32_case(name)
    sm = 1.0 / np.sqrt(args[0].shape[-1])
    ref = np.asarray(jpa._paged_attention_pallas(
        *(jnp.asarray(x) for x in args), sm))
    native.reset_launches()
    out, _ = pa.paged_attention_split_reference(*_torch(args), sm,
                                                split=split)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    for s, n in enumerate(args[-1]):
        if n == 0:
            assert np.array_equal(out.numpy()[s], np.zeros_like(ref[s]))
    assert not any(native.launches.values())


@pytest.mark.parametrize("name", sorted(CASES))
def test_q8_split_arithmetic_matches_pallas_kernel(interpret_kernels, name):
    args, split = _q8_case(name)
    sm = 1.0 / np.sqrt(args[0].shape[-1])
    ref = np.asarray(jpa._paged_attention_q8_pallas(
        *(jnp.asarray(x) for x in args), sm))
    q, kc, vc, ks, vs, bt, seq = _torch(args)
    out, _ = pa.paged_attention_split_reference(
        q, kc, vc, bt, seq, sm, k_scale=ks, v_scale=vs, split=split)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    for s, n in enumerate(args[-1]):
        if n == 0:
            assert np.array_equal(out.numpy()[s], np.zeros_like(ref[s]))


@pytest.mark.parametrize("name", ["chunk_boundaries", "empty_chunks",
                                  "one_chunk_per_slot"])
def test_split_partials_are_the_chunks_softmax_state(name):
    """Each live record is (acc, m, l) of its chunk alone; dead records
    stay out of the merge; one live chunk merges to acc / l exactly."""
    args, split = _fp32_case(name)
    q, kc, vc, bt, seq = _torch(args)
    S, H, Dh = q.shape
    BS = kc.shape[1]
    sm = 0.3
    out, part = pa.paged_attention_split_reference(q, kc, vc, bt, seq, sm,
                                                   split=split)
    assert part.shape == pa.decode_split_plan(S, H, Dh, BS, bt.shape[1],
                                              split)[1]
    for s in range(S):
        n = int(seq[s])
        for j in range(part.shape[2]):
            rec = part[s, :, j]
            lo, hi = j * split, min(n, (j + 1) * split)
            if lo >= n:
                assert not rec.any()
                continue
            pos = torch.arange(lo, hi)
            blk = bt[s].long()[pos // BS]
            k = kc[blk, pos % BS]                          # [P, H, Dh]
            v = vc[blk, pos % BS]
            sc = torch.einsum("hd,phd->hp", q[s], k) * sm
            m = sc.amax(dim=-1)
            w = torch.exp(sc - m[:, None])
            # f32 summation order: the dots are taken over another gather
            torch.testing.assert_close(rec[:, Dh], m, atol=1e-6, rtol=1e-6)
            torch.testing.assert_close(rec[:, Dh + 1], w.sum(-1), atol=1e-5,
                                       rtol=1e-5)
            torch.testing.assert_close(rec[:, :Dh],
                                       torch.einsum("hp,phd->hd", w, v),
                                       atol=1e-5, rtol=1e-5)
        if 0 < n <= split:
            assert torch.equal(out[s], part[s, :, 0, :Dh]
                               / part[s, :, 0, Dh + 1:Dh + 2])


def test_split_arithmetic_never_touches_what_a_slot_must_not_read():
    """NaN in every row past a slot's seq_len, in the trash block and in
    every dead block's scale: the split partials and their merge stay
    finite and equal the plain version on the clean caches."""
    rng = np.random.RandomState(5)
    S, H, Dh, BS, max_b, seq = 4, 2, 32, 4, 8, [13, 0, 32, 8]
    NB, bt = _tables(rng, S, BS, max_b, seq)
    kc = np.full((NB, BS, H, Dh), np.nan, np.float32)
    vc = np.full((NB, BS, H, Dh), np.nan, np.float32)
    for s in range(S):
        for p in range(seq[s]):
            kc[bt[s, p // BS], p % BS] = rng.randn(H, Dh)
            vc[bt[s, p // BS], p % BS] = rng.randn(H, Dh)
    q = rng.randn(S, H, Dh).astype(np.float32)
    q_, kc_, vc_, bt_, seq_ = _torch((q, kc, vc, bt,
                                      np.asarray(seq, np.int32)))
    out, part = pa.paged_attention_split_reference(q_, kc_, vc_, bt_, seq_,
                                                   0.2, split=8)
    assert torch.isfinite(out).all() and torch.isfinite(part).all()
    torch.testing.assert_close(
        out, pa.paged_attention_reference(q_, torch.nan_to_num(kc_),
                                          torch.nan_to_num(vc_), bt_, seq_,
                                          0.2), atol=TOL, rtol=TOL)
    # int8: dead blocks' scales NaN
    live = {int(b) for s in range(S) for b in bt[s, :-(-seq[s] // BS)]}
    kq = rng.randint(-127, 128, size=(NB, BS, H, Dh)).astype(np.int8)
    sc = rng.uniform(0.002, 0.03, size=NB).astype(np.float32)
    poisoned = sc.copy()
    poisoned[[b for b in range(NB) if b not in live]] = np.nan
    kq_, sc_, poisoned_ = _torch((kq, sc, poisoned))
    out8, _ = pa.paged_attention_split_reference(
        q_, kq_, kq_, bt_, seq_, 0.2, k_scale=poisoned_, v_scale=poisoned_,
        split=8)
    assert torch.isfinite(out8).all()
    torch.testing.assert_close(
        out8, pa.paged_attention_q8_reference(q_, kq_, kq_, sc_, sc_, bt_,
                                              seq_, 0.2), atol=TOL, rtol=TOL)


def test_split_clamps_seq_len_to_the_table_row():
    args, split = _fp32_case("chunk_boundaries")
    q, kc, vc, bt, seq = _torch(args)
    out, part = pa.paged_attention_split_reference(q, kc, vc, bt, seq + 7,
                                                   0.25, split=split)
    full = seq + 7 >= bt.shape[1] * kc.shape[1]
    want, _ = pa.paged_attention_split_reference(
        q, kc, vc, bt, torch.where(full, bt.shape[1] * kc.shape[1], seq + 7),
        0.25, split=split)
    assert torch.equal(out, want)
    torch.testing.assert_close(
        out, pa.paged_attention_reference(q, kc, vc, bt, seq + 7, 0.25),
        atol=TOL, rtol=TOL)


@pytest.mark.parametrize("config,slots,kv_dtype,nsplit", [
    # serve-base and serve-base-int8 (PERF.md section 4): Transformer-base
    # widths, block 16, context 1024
    ("serve-base", 8, "fp32", 16),
    ("serve-base-int8", 32, "int8", 8),
    # the card tests' small generations: block 4, context 96
    ("tiny", 4, "fp32", 2),
    ("tiny", 4, "int8", 1),
])
def test_split_plan_for_the_serve_configurations(config, slots, kv_dtype,
                                                 nsplit):
    """The launch plan comes from shapes alone: NSPLIT = ceil(max_b * BS /
    P) chunks on the grid's z, P 64 over a float32 cache and 128 over an
    int8 one, the workspace [S, H, NSPLIT, Dh + 2] in float32."""
    if config == "tiny":
        sig = tiny_lm.default_signature(d_model=64, n_heads=2, max_slots=4,
                                        block_size=4, max_context=96,
                                        kv_dtype=kv_dtype)
    else:
        sig = tiny_lm.default_signature(vocab=30000, d_model=512, n_heads=8,
                                        n_layers=6, max_slots=slots,
                                        block_size=16, max_context=1024,
                                        kv_dtype=kv_dtype)
    S, H, Dh = sig["max_slots"], sig["num_heads"], sig["head_dim"]
    BS, max_b = sig["block_size"], sig["max_blocks_per_seq"]
    split = pa.DECODE_SPLIT if kv_dtype == "fp32" else pa.DECODE_SPLIT_Q8
    got, shape = pa.decode_split_plan(S, H, Dh, BS, max_b, split)
    assert got == nsplit == -(-max_b * BS // split)
    assert shape == (S, H, nsplit, Dh + 2)
    assert split % 64 == 0   # a whole number of the kernels' passes
    if config != "tiny":
        # 270,336 B at serve-base, 540,672 B at serve-base-int8
        assert int(np.prod(shape)) * 4 == {"fp32": 270336,
                                           "int8": 540672}[kv_dtype]


def test_split_plan_edges_and_the_z_limit():
    assert pa.decode_split_plan(2, 1, 32, 16, 0, 64) == (1, (2, 1, 1, 34))
    assert pa.decode_split_plan(2, 1, 32, 16, 4, 64) == (1, (2, 1, 1, 34))
    assert pa.decode_split_plan(2, 1, 32, 16, 5, 64) == (2, (2, 1, 2, 34))
    assert pa.decode_split_plan(2, 1, 32, 16, 9, 128) == (2, (2, 1, 2, 34))
    # table rows so long that their chunks overflow the grid's z
    q = torch.empty(1, 1, 32)
    c = torch.empty(2, 16, 1, 32)
    sl = torch.zeros(1, dtype=torch.int32)
    native.reset_launches()
    bt = torch.zeros(1, native.MAX_GRID_Z * pa.DECODE_SPLIT // 16 + 1,
                     dtype=torch.int32)
    with pytest.raises(ValueError, match="z limit"):
        pa._paged_attention_cuda(q, c, c, bt, sl, 1.0)
    bt = torch.zeros(1, native.MAX_GRID_Z * pa.DECODE_SPLIT_Q8 // 16 + 1,
                     dtype=torch.int32)
    with pytest.raises(ValueError, match="z limit"):
        pa._paged_attention_q8_cuda(q, c.to(torch.int8), c.to(torch.int8),
                                    torch.ones(2), torch.ones(2), bt, sl, 1.0)
    assert not any(native.launches.values())
