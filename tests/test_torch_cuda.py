"""paddle_tpu_torch on the card: the CUDA kernels against their plain
PyTorch versions, small generations (fp32 and int8 cache) on the card
against the host, training steps of a one-layer Transformer-base on
the card, with the bits dropout and with the flag-selected dropout kernel,
and the vision slice's conv, pool and batch-norm rules (cuDNN, NHWC) and
a ResNet-50 step on the card against the host, and the sequence slice's
bf16 `lstm` rule at the stacked LSTM's widths against the host (chip_smoke.py
holds every sequence op and a small stacked LSTM on the card against the
host), and one-shot serving (an MLP and a small ResNet, card against host)
with a hot swap under traffic, and the data plane: AsyncFeeder's pinned
ring and side-stream copy, py_reader's double buffer on the card against
the host, py_reader and AsyncFeeder landing on the card when no place is
named, the Preprocessor on the card against the host, and the profiler's
CUDA kernels, and the book's ops (`cos_sim`, `linear_chain_crf` with its
grads, `crf_decoding`) and two steps of its label_semantic_roles chapter
on the card against the host, and the op breadth's rules that depend on
repeats, ties and kinks (`scatter` with repeated ids in both modes,
`argsort` ties, `one_hot` out of range, the three repaired grads) and
`depthwise_conv2d` / `conv2d_transpose` on the card against the host,
and the rest of the op families: `multiclass_nms` (tied scores, padded
rows), `detection_map`, `warpctc`, `bilinear_interp` with its
antialiasing and `fake_quantize_range_abs_max` on the card against the
host, and the transpilers on a card scope: `InferenceTranspiler` and
`Float16Transpiler` leave every parameter on the card (folded, or in its
new dtype), a bf16-transpiled attention launches the flash forward's
bf16 instantiation only, and a float16-transpiled one raises.

Every test here needs an NVIDIA card (sm_90a) and skips without one. On
the card, run (this file imports neither jax nor paddle_tpu, so the repo
conftest, which imports jax, is left out):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.ops import dropout_kernel as dk
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import native
from paddle_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda

TOL = 1e-4  # f32 summation order + expf
# backward kernels vs their plain version: dQ, dK and dV are sums over T
# of products of f32 terms that are themselves sums over D, taken in
# another order than cuBLAS takes the plain version's (full f32, TF32 off),
# and by the kernels in 3xTF32 (about 2^-22 relative a product)
BWD_TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("B,H,T,D,causal", [
    (1, 2, 128, 64, True), (2, 8, 256, 64, True), (4, 8, 512, 64, True),
    (1, 2, 200, 64, True), (2, 3, 77, 32, False), (1, 2, 130, 128, True),
    (1, 1, 1, 64, True), (2, 2, 64, 128, False)])
def test_flash_kernel_matches_plain(dev, B, H, T, D, causal):
    g = torch.Generator(device=dev).manual_seed(T * 7 + D)
    q, k, v = (torch.randn(B, H, T, D, device=dev, generator=g)
               for _ in range(3))
    sm = D ** -0.5
    out, lse = fa._flash_forward(q, k, v, causal, sm)
    ref = fa._attention_reference(q, k, v, causal, sm)
    torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, fa._lse_reference(q, k, causal, sm),
                               atol=TOL, rtol=TOL)


def test_flash_wrapper_raises_instead_of_falling_back(dev):
    q = torch.randn(1, 2, 128, 48, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q, True, 0.1)
    q = torch.randn(1, 2, 128, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, q, q, True, 0.1)
    q = torch.randn(1, 128, 2, 64, device=dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q, q, True, 0.1)


def _paged_case(dev, S, H, Dh, BS, max_b, seq, seed):
    rng = np.random.RandomState(seed)
    NB = 1 + S * max_b
    pool = rng.permutation(np.arange(1, NB)).astype(np.int32)
    bt = np.zeros((S, max_b), np.int32)
    for s in range(S):
        n = -(-int(seq[s]) // BS)
        bt[s, :n] = pool[s * max_b: s * max_b + n]
    # NaN wherever a slot must not read: past its seq_len and block 0
    kc = np.full((NB, BS, H, Dh), np.nan, np.float32)
    vc = np.full((NB, BS, H, Dh), np.nan, np.float32)
    for s in range(S):
        for p in range(int(seq[s])):
            kc[bt[s, p // BS], p % BS] = rng.randn(H, Dh)
            vc[bt[s, p // BS], p % BS] = rng.randn(H, Dh)
    q = rng.randn(S, H, Dh).astype(np.float32)
    t = [torch.from_numpy(x).to(dev) for x in (q, kc, vc, bt,
                                               np.asarray(seq, np.int32))]
    return t


@pytest.mark.parametrize("S,H,Dh,BS,max_b,seq", [
    (8, 8, 64, 16, 64, [0, 1, 17, 300, 555, 777, 1000, 1024]),
    (3, 2, 32, 4, 5, [20, 0, 7]),
    (2, 4, 128, 8, 3, [24, 9])])
def test_paged_kernel_matches_plain_and_reads_only_live_rows(
        dev, S, H, Dh, BS, max_b, seq):
    q, kc, vc, bt, sl = _paged_case(dev, S, H, Dh, BS, max_b, seq, seed=S)
    sm = Dh ** -0.5
    out = pa.paged_attention(q, kc, vc, bt, sl, sm)
    assert torch.isfinite(out).all(), "kernel read a position it must not"
    ref = pa.paged_attention_reference(q, torch.nan_to_num(kc),
                                       torch.nan_to_num(vc), bt, sl, sm)
    torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL)
    for s in range(S):
        if seq[s] == 0:
            assert bool((out[s] == 0).all())


def test_paged_kernel_clamps_seq_len_to_the_table_row(dev):
    """A seq_len past max_b * block_size reads no further than the slot's
    own table row, as in the plain version's dense view."""
    q, kc, vc, bt, sl = _paged_case(dev, 2, 2, 64, 4, 3, [12, 12], seed=9)
    out = pa.paged_attention(q, kc, vc, bt, sl + 5)
    torch.testing.assert_close(out, pa.paged_attention(q, kc, vc, bt, sl),
                               atol=0, rtol=0)
    torch.testing.assert_close(
        out, pa.paged_attention_reference(q, kc, vc, bt, sl + 5, 64 ** -0.5),
        atol=TOL, rtol=TOL)


def test_generation_on_card_equals_host_and_runs_both_kernels(dev, tmp_path):
    from paddle_tpu_torch.models import tiny_lm
    mdir = str(tmp_path / "lm")
    sig = tiny_lm.save_tiny_lm(mdir, vocab=64, d_model=64, n_heads=2,
                               n_layers=2, max_slots=4, block_size=4,
                               max_context=96, prefill_seq_rungs=(32, 64))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, sig["vocab"], size=n).tolist()
               for n in (3, 30, 50)]
    out = {}
    for name, place in (("card", ptt.CUDAPlace(0)), ("host", ptt.CPUPlace())):
        srv = ptt.serve.InferenceServer(place)
        try:
            srv.add_model(name, mdir)
            native.reset_launches()
            futs = [srv.submit_generate(name, p, max_new_tokens=6)
                    for p in prompts]
            out[name] = [f.result(timeout=120).tokens for f in futs]
            launched = dict(native.launches)
        finally:
            srv.close()
        if name == "card":
            assert launched["flash_fwd"] > 0 and launched["paged_decode"] > 0
        else:
            assert not any(launched.values()), launched
    assert out["card"] == out["host"]


# ---------------------------------------------------------------------------
# training: the dropout forward and the backward kernels
# ---------------------------------------------------------------------------

def _qkv(dev, B, H, T, D, seed, n=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(B, H, T, D, device=dev, generator=g)
            for _ in range(n)]


TRAIN_CASES = [
    (2, 8, 256, 64, False, 0.1), (2, 8, 256, 64, True, 0.1),
    (2, 8, 256, 64, True, 0.0), (1, 2, 200, 64, True, 0.1),
    (2, 3, 77, 32, False, 0.1), (1, 2, 130, 128, True, 0.1),
    (1, 1, 1, 64, False, 0.0)]


@pytest.mark.parametrize("B,H,T,D,causal,rate", TRAIN_CASES)
def test_flash_dropout_forward_matches_plain(dev, B, H, T, D, causal, rate):
    q, k, v = _qkv(dev, B, H, T, D, seed=T + D)
    sm = D ** -0.5
    out, lse = fa._flash_forward(q, k, v, causal, sm, rate, seed=77)
    torch.testing.assert_close(
        out, fa._attention_reference(q, k, v, causal, sm, rate, 77),
        atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, fa._lse_reference(q, k, causal, sm),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("B,H,T,D,causal,rate", TRAIN_CASES)
def test_flash_backward_kernels_match_plain(dev, B, H, T, D, causal, rate):
    q, k, v, do = _qkv(dev, B, H, T, D, seed=3 * T + D, n=4)
    sm = D ** -0.5
    out, lse = fa._flash_forward(q, k, v, causal, sm, rate, seed=5)
    native.reset_launches()
    got = fa._flash_backward(q, k, v, out, lse, do, causal, sm, rate, 5)
    assert (native.launches["flash_dq"], native.launches["flash_dkv"]) \
        == (1, 1)
    ref = fa._flash_backward_reference(q, k, v, out, lse, do, causal, sm,
                                       rate, 5)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        torch.testing.assert_close(a, b, atol=BWD_TOL, rtol=BWD_TOL,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("B,H,T,D,causal,rate", TRAIN_CASES)
def test_flash_forward_repeats_bit_for_bit(dev, B, H, T, D, causal, rate):
    """No atomics and a fixed summation order: two launches of the
    forward on the same inputs give the same bits."""
    q, k, v = _qkv(dev, B, H, T, D, seed=T + 2 * D)
    sm = D ** -0.5
    first = fa._flash_forward(q, k, v, causal, sm, rate, 21)
    second = fa._flash_forward(q, k, v, causal, sm, rate, 21)
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_forward_on_peaked_scores(dev, causal):
    """q and k scaled by 4: W near one-hot, the scores 16 times wider; the
    3xTF32 scores (small terms in their own accumulator) still give out
    and lse within the fp32 tolerance."""
    q, k, v = _qkv(dev, 2, 4, 256, 64, seed=43)
    q, k = q * 4.0, k * 4.0
    sm = 64 ** -0.5
    assert float(torch.softmax(q @ k.transpose(-1, -2) * sm, -1)
                 .amax(-1).median()) > 0.5
    out, lse = fa._flash_forward(q, k, v, causal, sm, 0.1, 5)
    torch.testing.assert_close(
        out, fa._attention_reference(q, k, v, causal, sm, 0.1, 5),
        atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, fa._lse_reference(q, k, causal, sm),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_forward_ragged_tile(dev, D, causal):
    """T 100 is a multiple of neither the 64-row query tile nor the 32-row
    K/V tile, for every head dim (D 128 keeps Q's split in shared
    memory)."""
    q, k, v = _qkv(dev, 2, 3, 100, D, seed=D + 7)
    sm = D ** -0.5
    out, lse = fa._flash_forward(q, k, v, causal, sm, 0.1, 5)
    torch.testing.assert_close(
        out, fa._attention_reference(q, k, v, causal, sm, 0.1, 5),
        atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, fa._lse_reference(q, k, causal, sm),
                               atol=TOL, rtol=TOL)


def _backward_inputs(dev, B, H, T, D, causal, rate, seed, qk_scale=1.0):
    q, k, v, do = _qkv(dev, B, H, T, D, seed=seed, n=4)
    q, k = q * qk_scale, k * qk_scale
    sm = D ** -0.5
    out, lse = fa._flash_forward(q, k, v, causal, sm, rate, seed=5)
    return q, k, v, do, out, lse, sm


def _assert_within_bwd_tol(got, ref):
    """|kernel - plain| <= BWD_TOL * (1 + |plain|) for dq, dk and dv."""
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        excess = float(((a - b).abs() - BWD_TOL * (1 + b.abs())).max())
        assert excess <= 0, (name, float((a - b).abs().max()))


@pytest.mark.parametrize("B,H,T,D,causal,rate",
                         [TRAIN_CASES[0], TRAIN_CASES[3]])
def test_flash_backward_kernels_repeat_bit_for_bit(dev, B, H, T, D, causal,
                                                   rate):
    """No atomics and a fixed summation order: two launches on the same
    inputs give the same bits."""
    q, k, v, do, out, lse, sm = _backward_inputs(dev, B, H, T, D, causal,
                                                 rate, seed=T + 11)
    first = fa._flash_backward(q, k, v, out, lse, do, causal, sm, rate, 5)
    second = fa._flash_backward(q, k, v, out, lse, do, causal, sm, rate, 5)
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_kernels_on_peaked_scores(dev, causal):
    """q and k scaled by 4: the scores spread 16 times wider, W is near
    one-hot and dS large; the 3xTF32 products still meet the fp32
    tolerance."""
    args = (2, 4, 256, 64, causal, 0.1)
    q, k, v, do, out, lse, sm = _backward_inputs(dev, *args, seed=41,
                                                 qk_scale=4.0)
    assert float(torch.softmax(q @ k.transpose(-1, -2) * sm, -1)
                 .amax(-1).median()) > 0.5
    got = fa._flash_backward(q, k, v, out, lse, do, causal, sm, 0.1, 5)
    _assert_within_bwd_tol(got, fa._flash_backward_reference(
        q, k, v, out, lse, do, causal, sm, 0.1, 5))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_backward_kernels_ragged_tile(dev, D, causal):
    """T 100 is a multiple of neither the 64-row resident tile nor the
    32- or 64-row streamed tile, for every head dim."""
    q, k, v, do, out, lse, sm = _backward_inputs(dev, 2, 3, 100, D, causal,
                                                 0.1, seed=D + 100)
    got = fa._flash_backward(q, k, v, out, lse, do, causal, sm, 0.1, 5)
    _assert_within_bwd_tol(got, fa._flash_backward_reference(
        q, k, v, out, lse, do, causal, sm, 0.1, 5))


def test_autograd_function_runs_the_three_kernels(dev):
    q, k, v, do = _qkv(dev, 2, 2, 128, 64, seed=1, n=4)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    native.reset_launches()
    out = fa.flash_attention(*leaves, True, 0.125, 0.1, 9)
    grads = torch.autograd.grad(out, leaves, do)
    assert {n: native.launches[n] for n in ("flash_fwd", "flash_dq",
                                            "flash_dkv", "flash_delta")} == \
        {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1, "flash_delta": 1}
    lse = fa._lse_reference(q, k, True, 0.125)
    for a, b in zip(grads, fa._flash_backward_reference(
            q, k, v, out.detach(), lse, do, True, 0.125, 0.1, 9)):
        torch.testing.assert_close(a, b, atol=BWD_TOL, rtol=BWD_TOL)


@pytest.mark.parametrize("T", [32, 128])
def test_kernels_drop_exactly_the_plain_mask(dev, T):
    """With T == D, identity matrices expose each kernel's mask: the
    forward's out with V = I, dQ with K = I and delta = 0, and dV with
    dO = I are zero exactly where a weight was dropped (every undropped
    weight is > 0, the scores being finite and unmasked)."""
    B, H, D, rate, seed = 1, 3, T, 0.5, 4242
    q, k, v, do = _qkv(dev, B, H, T, D, seed=T, n=4)
    eye = torch.eye(T, device=dev).expand(B, H, T, T).contiguous()
    dropped = ~fa._attention_keep(seed, B * H, T, T, rate, dev).reshape(
        B, H, T, T)
    assert 0.4 < dropped.float().mean().item() < 0.6
    out, lse = fa._flash_forward(q, k, eye, False, 0.1, rate, seed)
    assert torch.equal(out == 0, dropped)
    zero = torch.zeros(B, H, T, device=dev)
    dq = fa._flash_dq(q, eye, v, do, lse, zero, False, 0.1, rate, seed)
    assert torch.equal(dq == 0, dropped)
    _, dv = fa._flash_dkv(q, k, v, eye, lse, zero, False, 0.1, rate, seed)
    assert torch.equal(dv == 0, dropped.transpose(-1, -2))


def _nan_padded(t):
    """A copy of `t` whose storage continues with NaN past its end."""
    buf = torch.full((t.numel() + 4096,), float("nan"), device=t.device)
    buf[:t.numel()] = t.reshape(-1)
    return buf[:t.numel()].view(t.shape)


@pytest.mark.parametrize("T,causal", [(200, True), (77, False)])
def test_kernels_never_read_past_T(dev, T, causal):
    B, H, D, rate = 1, 2, 64, 0.1
    q, k, v, do = _qkv(dev, B, H, T, D, seed=T, n=4)
    sm = D ** -0.5
    out, lse = fa._flash_forward(q, k, v, causal, sm, rate, 3)
    delta = (do * out).sum(-1)
    clean = (out, lse, fa._flash_dq(q, k, v, do, lse, delta, causal, sm,
                                    rate, 3),
             *fa._flash_dkv(q, k, v, do, lse, delta, causal, sm, rate, 3))
    pq, pk, pv, pdo, plse, pdelta = map(_nan_padded,
                                        (q, k, v, do, lse, delta))
    pout, plse2 = fa._flash_forward(pq, pk, pv, causal, sm, rate, 3)
    padded = (pout, plse2, fa._flash_dq(pq, pk, pv, pdo, plse, pdelta,
                                        causal, sm, rate, 3),
              *fa._flash_dkv(pq, pk, pv, pdo, plse, pdelta, causal, sm,
                             rate, 3))
    for a, b in zip(clean, padded):
        assert torch.isfinite(b).all()
        assert torch.equal(a, b)


def test_train_base_one_layer_two_steps_on_card(dev):
    """Transformer-base widths at one layer, batch 2: two Adam steps on
    the card, each launching the forward kernel twice per attention (the
    forward op and its grad op's recompute) and each backward kernel
    once, and the delta kernel once; 3 attentions a layer."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models import transformer
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, fetches = transformer.build(n_layer=1, dropout_rate=0.1)
        optimizer.Adam(learning_rate=1e-3).minimize(fetches["loss"])
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {n: rng.randint(0, 30000, (2, 256)).astype(np.int64)
            for n in ("src_word", "trg_word", "lbl_word")}
    for _ in range(2):
        native.reset_launches()
        loss, = exe.run(main, feed=feed, fetch_list=[fetches["loss"]],
                        scope=scope)
        assert np.isfinite(loss).all()
        assert {n: native.launches[n] for n in ("flash_fwd", "flash_dq",
                                                "flash_dkv",
                                                "flash_delta")} == \
            {"flash_fwd": 6, "flash_dq": 3, "flash_dkv": 3, "flash_delta": 3}


# ---------------------------------------------------------------------------
# int8 KV residency: the quantized decode read
# ---------------------------------------------------------------------------

def _q8_case(dev, S, H, Dh, BS, max_b, seq, seed):
    """Random int8 caches and positive scales; block tables from a shuffled
    pool. Everything a slot must not read is poisoned: table entries past
    ceil(seq_len / BS) point at block 0, and the scale of every block that
    no live entry names (block 0 included) is NaN."""
    rng = np.random.RandomState(seed)
    NB = 1 + S * max_b
    pool = rng.permutation(np.arange(1, NB)).astype(np.int32)
    bt = np.zeros((S, max_b), np.int32)
    live = set()
    for s in range(S):
        n = -(-int(seq[s]) // BS)
        bt[s, :n] = pool[s * max_b: s * max_b + n]
        live |= set(bt[s, :n].tolist())
    kc = rng.randint(-127, 128, size=(NB, BS, H, Dh)).astype(np.int8)
    vc = rng.randint(-127, 128, size=(NB, BS, H, Dh)).astype(np.int8)
    ks = rng.uniform(0.002, 0.03, size=NB).astype(np.float32)
    vs = rng.uniform(0.002, 0.03, size=NB).astype(np.float32)
    dead = [b for b in range(NB) if b not in live]
    ks[dead] = np.nan
    vs[dead] = np.nan
    q = rng.randn(S, H, Dh).astype(np.float32)
    return [torch.from_numpy(x).to(dev)
            for x in (q, kc, vc, ks, vs, bt, np.asarray(seq, np.int32))]


def _spread(S, full):
    """S seq_lens over [0, full], with one 0 and one `full` when S > 1."""
    if S == 1:
        return [full]
    return [0, full] + [int(x) for x in
                        np.linspace(1, full - 1, S - 2).astype(int)]


@pytest.mark.parametrize("S", [1, 32])
@pytest.mark.parametrize("BS", [8, 16, 32])
@pytest.mark.parametrize("Dh", [32, 64, 128])
def test_paged_q8_kernel_matches_plain_and_reads_only_live_blocks(
        dev, Dh, BS, S):
    max_b = 6
    seq = _spread(S, max_b * BS)
    args = _q8_case(dev, S, 4, Dh, BS, max_b, seq, seed=Dh + BS + S)
    sm = Dh ** -0.5
    native.reset_launches()
    out = pa.paged_attention_q8(*args, sm)
    assert native.launches["paged_decode_q8"] == 1
    assert torch.isfinite(out).all(), "kernel read a dead block or scale"
    ref = pa.paged_attention_q8_reference(*args, sm)
    torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL)
    for s in range(S):
        if seq[s] == 0:
            assert bool((out[s] == 0).all())


def test_paged_q8_kernel_walks_a_table_longer_than_one_staging_chunk(dev):
    """max_b 150 at block 4: three chunks of staged table entries, the
    last one partial."""
    seq = [600, 0, 257, 1, 599]
    args = _q8_case(dev, 5, 2, 64, 4, 150, seq, seed=31)
    out = pa.paged_attention_q8(*args, 0.125)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(
        out, pa.paged_attention_q8_reference(*args, 0.125), atol=TOL,
        rtol=TOL)


def test_paged_q8_kernel_clamps_seq_len_to_the_table_row(dev):
    q, kc, vc, ks, vs, bt, sl = _q8_case(dev, 2, 2, 64, 4, 3, [12, 12], 9)
    out = pa.paged_attention_q8(q, kc, vc, ks, vs, bt, sl + 5)
    torch.testing.assert_close(
        out, pa.paged_attention_q8(q, kc, vc, ks, vs, bt, sl), atol=0, rtol=0)


def test_paged_q8_wrapper_raises_instead_of_falling_back(dev):
    q, kc, vc, ks, vs, bt, sl = _q8_case(dev, 2, 2, 64, 4, 3, [12, 5], 3)
    with pytest.raises(ValueError, match="dtype"):
        pa.paged_attention_q8(q, kc.float(), vc, ks, vs, bt, sl)
    with pytest.raises(ValueError, match="shape"):
        pa.paged_attention_q8(q, kc, vc, ks[:-1], vs, bt, sl)
    with pytest.raises(ValueError, match="is on"):
        pa.paged_attention_q8(q, kc, vc, ks.cpu(), vs, bt, sl)


def test_int8_generation_on_card_equals_host_and_runs_the_q8_kernel(
        dev, tmp_path):
    from paddle_tpu_torch.models import tiny_lm
    mdir = str(tmp_path / "lm8")
    sig = tiny_lm.save_tiny_lm(mdir, vocab=64, d_model=64, n_heads=2,
                               n_layers=2, max_slots=4, block_size=4,
                               max_context=96, prefill_seq_rungs=(32, 64),
                               kv_dtype="int8")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, sig["vocab"], size=n).tolist()
               for n in (3, 30, 50)]
    out, requants = {}, {}
    for name, place in (("card8", ptt.CUDAPlace(0)),
                        ("host8", ptt.CPUPlace())):
        srv = ptt.serve.InferenceServer(place)
        try:
            srv.add_model(name, mdir)
            native.reset_launches()
            futs = [srv.submit_generate(name, p, max_new_tokens=6)
                    for p in prompts]
            out[name] = [f.result(timeout=120).tokens for f in futs]
            launched = dict(native.launches)
            requants[name] = srv.stats()["models"][name]["kv_requant_events"]
        finally:
            srv.close()
        if name == "card8":
            assert launched["flash_fwd"] > 0
            assert launched["paged_decode_q8"] > 0
            assert launched["paged_decode"] == 0
        else:
            assert not any(launched.values()), launched
    assert out["card8"] == out["host8"]
    assert requants["card8"] == requants["host8"]


# ---------------------------------------------------------------------------
# the split paged decode kernels: chunk edges, widths, many slots, reruns
# ---------------------------------------------------------------------------

def _split_case(dev, kind, S, H, Dh, BS, max_b, seq, seed):
    """(kernel arguments, the plain version's arguments): float32 caches
    with NaN in every row a slot must not read (the plain version gets the
    NaN-free copy), or int8 caches with every dead block's scale NaN."""
    if kind == "q8":
        args = _q8_case(dev, S, H, Dh, BS, max_b, seq, seed)
        return args, args
    q, kc, vc, bt, sl = _paged_case(dev, S, H, Dh, BS, max_b, seq, seed)
    return ((q, kc, vc, bt, sl),
            (q, torch.nan_to_num(kc), torch.nan_to_num(vc), bt, sl))


def _decode(kind):
    return pa.paged_attention_q8 if kind == "q8" else pa.paged_attention


def _decode_reference(kind):
    return (pa.paged_attention_q8_reference if kind == "q8"
            else pa.paged_attention_reference)


def _assert_split_launch(dev, kind, S, H, Dh, BS, max_b, seq, seed):
    """The kernel against the plain version within TOL, finite under the
    NaN poison, exact zeros for seq_len 0, one launch counted per call, and
    a second launch on the same inputs bit-equal."""
    args, ref_args = _split_case(dev, kind, S, H, Dh, BS, max_b, seq, seed)
    sm = Dh ** -0.5
    native.reset_launches()
    out = _decode(kind)(*args, sm)
    assert native.launches[f"paged_decode{'_q8' if kind == 'q8' else ''}"] \
        == 1
    assert torch.isfinite(out).all(), "kernel read what a slot must not"
    torch.testing.assert_close(out, _decode_reference(kind)(*ref_args, sm),
                               atol=TOL, rtol=TOL)
    for s in range(S):
        if seq[s] == 0:
            assert bool((out[s] == 0).all())
    again = _decode(kind)(*args, sm)
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("kind", ["f32", "q8"])
@pytest.mark.parametrize("Dh", [32, 64, 128])
def test_split_kernels_at_chunk_edges(dev, kind, Dh):
    """seq_len at P - 1, P, P + 1, 3P, the whole row and 1 (and 0), on a
    table row of 29 blocks of 16 = 464 positions, a multiple of neither
    P (64 over float32, 128 over int8): the last chunk is partial."""
    P = pa.DECODE_SPLIT_Q8 if kind == "q8" else pa.DECODE_SPLIT
    BS, max_b = 16, 29
    seq = [P - 1, P, P + 1, 3 * P, max_b * BS, 1, 0]
    assert (max_b * BS) % P != 0 and 3 * P < max_b * BS
    _assert_split_launch(dev, kind, len(seq), 4, Dh, BS, max_b, seq,
                         seed=Dh + len(kind))


@pytest.mark.parametrize("kind", ["f32", "q8"])
def test_split_kernels_at_256_slots(dev, kind):
    """256 slots spread over [0, 144] positions (block 16, 9 blocks a row:
    NSPLIT 3 over float32 and 2 over int8, the last chunk partial)."""
    seq = _spread(256, 144)
    _assert_split_launch(dev, kind, 256, 2, 64, 16, 9, seq, seed=256)


@pytest.mark.parametrize("kind", ["f32", "q8"])
def test_split_kernels_with_one_long_slot(dev, kind):
    """One slot at the full 1024-position context: 16 chunks of P (8 over
    int8)."""
    _assert_split_launch(dev, kind, 1, 8, 64, 16, 64, [1024], seed=1024)


@pytest.mark.parametrize("kind", ["f32", "q8"])
def test_split_launches_capture_in_a_cuda_graph(dev, kind):
    """The wrapper reads no seq_lens value on the host and never
    synchronizes, so both launches (split and merge) capture into a CUDA
    graph; a replay after seq_lens changed on the card reads the new
    lengths (each no longer than before: past that lie the poisoned
    rows and scales)."""
    seq = [100, 0, 128, 7]
    args, _ = _split_case(dev, kind, 4, 2, 64, 16, 8, seq, seed=4)
    sl = args[-1]
    fn = _decode(kind)
    fn(*args)                                   # build, and warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    for lengths in (seq, [64, 0, 100, 1]):
        sl.copy_(torch.tensor(lengths, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        ref_args = [torch.nan_to_num(t) if t.is_floating_point() else t
                    for t in args]
        torch.testing.assert_close(
            out, _decode_reference(kind)(*ref_args, 64 ** -0.5), atol=TOL,
            rtol=TOL)


# ---------------------------------------------------------------------------
# the flag-selected dropout kernel
# ---------------------------------------------------------------------------

def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("shape", [
    (32, 256, 512),      # the train path's shapes
    (4, 256, 2048),
    (3, 128),            # one block, no tail
    (1031,),             # 257 vectors and a scalar tail of 3
    (5, 7, 3),           # 105 elements: 26 vectors and a tail of 1
    (2,)])               # tail only
def test_dropout_kernel_equals_plain_bit_for_bit(dev, shape, rate):
    g = torch.Generator(device=dev).manual_seed(len(shape) * 31 + shape[0])
    x = torch.randn(*shape, device=dev, generator=g)
    seed = 0xC0FFEE12
    native.reset_launches()
    out, mask = dk.dropout_forward(x, seed, rate, want_mask=True)
    out_only, none = dk.dropout_forward(x, seed, rate)
    assert native.launches["dropout"] == 2 and none is None
    ref_out, ref_mask = dk.dropout_reference(x, seed, rate)
    assert torch.equal(_bits(out), _bits(ref_out))
    assert torch.equal(_bits(mask), _bits(ref_mask))
    assert torch.equal(_bits(out_only), _bits(ref_out))


def test_dropout_kernel_backward_is_the_kernel_on_dy(dev):
    x = torch.randn(8, 256, 512, device=dev, requires_grad=True)
    dy = torch.randn(8, 256, 512, device=dev)
    native.reset_launches()
    y = dk.dropout_kernel(x, 99, 0.1)
    y.backward(dy)
    assert native.launches["dropout"] == 2
    ref_out, _ = dk.dropout_reference(x.detach(), 99, 0.1)
    ref_dx, _ = dk.dropout_reference(dy, 99, 0.1)
    assert torch.equal(_bits(y.detach()), _bits(ref_out))
    assert torch.equal(_bits(x.grad), _bits(ref_dx))


def test_dropout_kernel_takes_an_unaligned_view_by_its_scalar_loop(dev):
    """A contiguous view that starts 4 bytes into its storage cannot be
    read as 16-byte vectors; the mask is the same as for an aligned copy."""
    buf = torch.randn(4 * 128 + 1, device=dev)
    x = buf[1:].view(4, 128)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    out, mask = dk.dropout_forward(x, 5, 0.5, want_mask=True)
    ref_out, ref_mask = dk.dropout_reference(x.clone(), 5, 0.5)
    assert torch.equal(_bits(out), _bits(ref_out))
    assert torch.equal(_bits(mask), _bits(ref_mask))


def test_dropout_kernel_indexes_past_32_bits(dev):
    """2**32 + 4099 elements (17 GB in, 17 GB out): the element index needs
    64 bits and its high word enters the hash. Windows at the start, across
    2**31, across 2**32 and at the end (the scalar tail) equal the plain
    version's for the same linear indices."""
    n = (1 << 32) + 4099
    free, _ = torch.cuda.mem_get_info()
    if free < 2.2 * 4 * n:
        pytest.skip(f"needs {2.2 * 4 * n / 2**30:.0f} GiB of free device "
                    f"memory, {free / 2**30:.0f} GiB are free")
    x = torch.empty(n, device=dev)
    windows = [(0, 4096), ((1 << 31) - 2048, (1 << 31) + 2048),
               ((1 << 32) - 2048, (1 << 32) + 2048), (n - 4099, n)]
    for a, b in windows:
        x[a:b] = torch.randn(b - a, device=dev)
    out, _ = dk.dropout_forward(x, 77, 0.5)
    torch.cuda.synchronize()
    inv = fa._drop_scale(0.5)
    for a, b in windows:
        keep = dk._keep_range(77, a, b, 0.5, dev)
        want = torch.where(keep, x[a:b] * inv, torch.zeros((), device=dev))
        assert torch.equal(_bits(out[a:b]), _bits(want)), (a, b)
        assert 0.4 < keep.float().mean().item() < 0.6


def test_dropout_wrapper_raises_instead_of_falling_back(dev):
    with pytest.raises(ValueError, match="float32"):
        dk.dropout_forward(torch.ones(4, 128, device=dev,
                                      dtype=torch.float16), 1, 0.5)


def test_train_one_layer_under_the_dropout_flag_on_card(dev):
    """Transformer-base widths at one layer, batch 2, under
    FLAGS_dropout_impl=pallas: every dropout op passes the gate and
    launches the kernel once in its forward and once in its grad; card and
    host take the same three steps (the kernel's mask and the flash
    kernels' masks are their plain versions' bit for bit)."""
    from paddle_tpu_torch import flags, optimizer
    from paddle_tpu_torch.core.executor import fetch_var
    from paddle_tpu_torch.models import transformer
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, fetches = transformer.build(n_layer=1, dropout_rate=0.1)
        optimizer.Adam(learning_rate=1e-3).minimize(fetches["loss"])
    n_sites = sum(op.type == "dropout" for op in main.global_block().ops)
    assert n_sites > 0
    scope0 = ptt.Scope()
    ptt.Executor(ptt.CUDAPlace(0)).run(startup, scope=scope0)
    arrays = {n: fetch_var(n, scope0) for n in scope0.local_var_names()}
    rng = np.random.RandomState(0)
    feed = {n: rng.randint(0, 30000, (2, 256)).astype(np.int64)
            for n in ("src_word", "trg_word", "lbl_word")}
    flags.set_flag("dropout_impl", "pallas")
    losses = {}
    try:
        for name, place in (("card", ptt.CUDAPlace(0)),
                            ("host", ptt.CPUPlace())):
            scope = ptt.io.state_from_numpy(arrays, place)
            exe = ptt.Executor(place)
            losses[name] = []
            for _ in range(3):
                native.reset_launches()
                loss, = exe.run(main, feed=feed, fetch_list=[fetches["loss"]],
                                scope=scope)
                losses[name].append(float(np.asarray(loss).reshape(-1)[0]))
                want = 2 * n_sites if name == "card" else 0
                assert native.launches["dropout"] == want
                # nothing reads Mask in a training step: no launch writes it
                assert native.launches["dropout_mask"] == 0
    finally:
        flags.set_flag("dropout_impl", "auto")
    np.testing.assert_allclose(losses["card"], losses["host"], rtol=1e-3)


def test_fetched_dropout_mask_on_card_equals_plain(dev):
    """Under FLAGS_dropout_impl=pallas a fetched Mask is written by the
    forward's launch, in the same pass, and equals the plain version's bit
    for bit; without the fetch no launch writes it."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.core.lowering import op_seed
    from paddle_tpu_torch.ops.nn import seed32
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        x = ptt.layers.data("x", shape=[16, 256], dtype="float32")
        y = ptt.layers.dropout(x, dropout_prob=0.3,
                               dropout_implementation="upscale_in_train")
    main.random_seed = 5
    ops = main.global_block().ops
    idx = [o.type for o in ops].index("dropout")
    mask = ops[idx].outputs["Mask"][0]
    xv = np.random.RandomState(2).randn(4, 16, 256).astype(np.float32)
    exe = ptt.Executor(ptt.CUDAPlace(0))
    flags.set_flag("dropout_impl", "pallas")
    try:
        native.reset_launches()
        out, m = exe.run(main, feed={"x": xv}, fetch_list=[y.name, mask],
                         scope=ptt.Scope())
        assert (native.launches["dropout"],
                native.launches["dropout_mask"]) == (1, 1)
        native.reset_launches()
        # a new executor: its first run draws the same op seed
        out2, = ptt.Executor(ptt.CUDAPlace(0)).run(
            main, feed={"x": xv}, fetch_list=[y.name], scope=ptt.Scope())
        assert (native.launches["dropout"],
                native.launches["dropout_mask"]) == (1, 0)
    finally:
        flags.set_flag("dropout_impl", "auto")
    ref_out, ref_mask = dk.dropout_reference(
        torch.from_numpy(xv), seed32(op_seed(5, 0, idx)), 0.3)
    assert np.array_equal(m.view(np.int32), ref_mask.numpy().view(np.int32))
    assert np.array_equal(out.view(np.int32), ref_out.numpy().view(np.int32))
    assert np.array_equal(out2.view(np.int32), out.view(np.int32))


# ---------------------------------------------------------------------------
# the vision slice: conv, pool and batch norm through cuDNN in NHWC
# ---------------------------------------------------------------------------

def _rule(op_type, attrs, recompute=False, **ins):
    from paddle_tpu_torch.core.registry import (LoweringContext, call_rule,
                                                get_op_def)
    dev = next(iter(ins.values())).device
    return call_rule(get_op_def(op_type),
                     LoweringContext(attrs, dev, recompute=recompute),
                     {k: [v] for k, v in ins.items()})


def _on_both(dev, op_type, attrs, outs, wrt, **ins):
    """Run the rule on the card and on the host from the same values, with
    the grads of `outs[0]` w.r.t. `wrt` for one random cotangent; returns
    both (outputs + grads) lists."""
    res = []
    for d in (dev, torch.device("cpu")):
        vals = {k: v.to(d).clone().requires_grad_(k in wrt)
                for k, v in ins.items()}
        got = _rule(op_type, attrs, **vals)
        ys = [got[o][0] for o in outs]
        cot = torch.from_numpy(np.random.RandomState(9).randn(
            *ys[0].shape).astype(np.float32)).to(d)
        grads = torch.autograd.grad(ys[0], [vals[k] for k in wrt], cot)
        res.append(ys + list(grads))
    return res


def _close(a, b):
    """Card against host: a conv's grads are sums over N * H * W
    products, and cuDNN's algorithms (FFT, Winograd, implicit GEMM) err
    in proportion to the sum's scale, so the absolute tolerance is TOL of
    the tensor's largest magnitude (at least TOL)."""
    a, b = a.detach().cpu(), b.detach()
    torch.testing.assert_close(a, b, rtol=TOL,
                               atol=TOL * max(1.0, float(b.abs().max())))


def _assert_nhwc(t):
    """An NHWC tensor laid out as NHWC: its NCHW view is channels-last,
    so no layout copy was made on the way in or out of cuDNN."""
    assert t.is_contiguous(), t.stride()
    assert t.permute(0, 3, 1, 2).is_contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("stride,pad,dil,groups", [(1, 1, 1, 1), (2, 3, 1, 1),
                                                   (2, 1, 2, 2)])
def test_conv2d_nhwc_on_card_equals_host_without_copies(dev, stride, pad,
                                                         dil, groups):
    rng = np.random.RandomState(stride * 10 + pad)
    x = torch.from_numpy(rng.randn(4, 17, 17, 32).astype(np.float32))
    w = torch.from_numpy(rng.randn(64, 32 // groups, 3, 3).astype(
        np.float32) * 0.1)
    attrs = {"strides": [stride, stride], "paddings": [pad, pad],
             "dilations": [dil, dil], "groups": groups, "data_format": "NHWC"}
    card, host = _on_both(dev, "conv2d", attrs, ["Output"],
                          ["Input", "Filter"], Input=x, Filter=w)
    _assert_nhwc(card[0])
    _assert_nhwc(card[1])           # dX
    for a, b in zip(card, host):
        _close(a, b)


@pytest.mark.parametrize("attrs", [
    {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
     "paddings": [1, 1]},
    {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
     "paddings": [1, 1], "exclusive": True},
    {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
     "paddings": [1, 1], "exclusive": False}])
def test_pool2d_nhwc_on_card_equals_host(dev, attrs):
    """Max pooling keeps NHWC without a copy; an average over windows
    pools a contiguous NCHW copy (torch's CUDA avg_pool2d backward is
    wrong for a channels-last input: `ops/nn.py::_window_pool`), and its
    grads equal the host's."""
    x = torch.from_numpy(np.random.RandomState(3).randn(4, 28, 28, 64)
                         .astype(np.float32))
    card, host = _on_both(dev, "pool2d", dict(attrs, data_format="NHWC"),
                          ["Out"], ["X"], X=x)
    if attrs["pooling_type"] == "max":
        _assert_nhwc(card[0])
        _assert_nhwc(card[1])
    for a, b in zip(card, host):
        _close(a, b)


def test_global_pool_nhwc_on_card_equals_host(dev):
    x = torch.from_numpy(np.random.RandomState(4).randn(4, 7, 7, 256)
                         .astype(np.float32))
    card, host = _on_both(dev, "pool2d", {
        "pooling_type": "avg", "global_pooling": True,
        "data_format": "NHWC"}, ["Out"], ["X"], X=x)
    assert card[0].shape == (4, 1, 1, 256)
    for a, b in zip(card, host):
        _close(a, b)


def test_batch_norm_nhwc_on_card_equals_host_and_updates_once(dev):
    """Training mode: Y, SavedMean, SavedVariance and the grads of X,
    Scale and Bias equal the host's; the running stats are updated in
    place by the biased variance, and a recompute leaves them alone."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy((rng.randn(8, 14, 14, 64) * 3 + 1).astype(
        np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 64).astype(np.float32))
    bias = torch.from_numpy(rng.randn(64).astype(np.float32))
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
             "data_layout": "NHWC"}
    res = []
    for d in (dev, torch.device("cpu")):
        mean, var = torch.zeros(64, device=d), torch.ones(64, device=d)
        vals = {"X": x.to(d).requires_grad_(True),
                "Scale": scale.to(d).requires_grad_(True),
                "Bias": bias.to(d).requires_grad_(True)}
        got = _rule("batch_norm", attrs, Mean=mean, Variance=var, **vals)
        assert got["MeanOut"][0] is mean and got["VarianceOut"][0] is var
        cot = torch.from_numpy(rng.randn(*x.shape).astype(np.float32)).to(d) \
            if not res else res[0][-1].to(d)
        grads = torch.autograd.grad(got["Y"][0], list(vals.values()), cot)
        stats = (mean.clone(), var.clone())
        _rule("batch_norm", attrs, recompute=True, Mean=mean, Variance=var,
              **vals)
        assert torch.equal(mean, stats[0]) and torch.equal(var, stats[1])
        res.append([got["Y"][0], got["SavedMean"][0], got["SavedVariance"][0],
                    *grads, mean, var, cot])
    card, host = res
    _assert_nhwc(card[0])
    _assert_nhwc(card[3])           # dX
    x64 = x.double().reshape(-1, 64)
    torch.testing.assert_close(host[-2], (0.9 + 0.1 * x64.var(0, unbiased=False))
                               .float(), atol=1e-5, rtol=1e-5)
    for a, b in zip(card[:-1], host[:-1]):
        _close(a, b)


def test_resnet50_step_on_card_equals_host(dev):
    """One Momentum step of ResNet-50 at 32 x 32, NHWC, batch 16 (the CPU
    parity test's size) from one startup state on the card and on the
    host: the loss to 1e-4 relative, the running stats to 1e-4, every
    velocity (the step's grad) within 0.1 relative L2, as that test holds
    the port against the JAX package (see its docstring for why), and no
    kernel of the attention or dropout paths launched."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.core.executor import fetch_var
    from paddle_tpu_torch.models import resnet
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, fetches = resnet.build(class_dim=100, depth=50,
                                  image_shape=(3, 32, 32), data_format="NHWC")
        optimizer.Momentum(learning_rate=1e-3, momentum=0.9).minimize(
            fetches["loss"])
    scope0 = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope0)
    arrays = {n: fetch_var(n, scope0) for n in scope0.local_var_names()}
    rng = np.random.RandomState(13)
    feed = {"image": rng.rand(16, 32, 32, 3).astype(np.float32),
            "label": rng.randint(0, 100, (16, 1)).astype(np.int64)}
    out = {}
    for side, place in (("card", ptt.CUDAPlace(0)), ("host", ptt.CPUPlace())):
        scope = ptt.io.state_from_numpy(arrays, place)
        native.reset_launches()
        loss, = ptt.Executor(place).run(main, feed=feed,
                                        fetch_list=[fetches["loss"]],
                                        scope=scope)
        assert not any(native.launches.values())
        out[side] = (loss, {n: fetch_var(n, scope) for n in arrays})
    assert np.isfinite(out["card"][0]).all()
    np.testing.assert_allclose(out["card"][0], out["host"][0], rtol=1e-4)
    stats = {op.inputs[s][0] for op in main.global_block().ops
             if op.type == "batch_norm" for s in ("Mean", "Variance")}
    for n in arrays:
        a, b = out["card"][1][n], out["host"][1][n]
        if n in stats:
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=n)
        elif "velocity" in n:
            assert np.linalg.norm(a - b) <= 0.1 * np.linalg.norm(b), n


# ---------------------------------------------------------------------------
# bf16 mixed precision: the bf16 instantiations and an AMP step
# ---------------------------------------------------------------------------

# bf16 kernels vs their bf16 plain versions, per element (chip_smoke.py's
# check and the reasons given there): the kernel rounds P against its key
# tile's running max, the plain version against the row's, so an output
# sums terms half a bf16 ulp apart at its row's scale. An element lies
# within BF16_ULPS bf16 ulps of |plain| + BF16_ROW_TOL x its row's max
# |plain| (a row: D values) + BF16_ATOL x the tensor's max |plain| (float32
# cancellation where the plain value is 0). lse is float32.
BF16_ULPS, BF16_ROW_TOL, BF16_ATOL = 1, 2.0 ** -6, 2.0 ** -16
LSE_TOL = 1e-4

BF16_CASES = [
    (2, 8, 256, 64, False, 0.1), (2, 8, 256, 64, True, 0.1),
    (2, 8, 256, 64, False, 0.0), (1, 2, 200, 64, True, 0.1),
    (2, 3, 77, 32, False, 0.1), (1, 2, 130, 128, True, 0.1),
    (1, 1, 1, 64, False, 0.0),
    # the backward kernels' tile and TMA edges: 64-row resident tiles in
    # 128-row work items, 64-row streamed tiles (32 for dK/dV at D 128),
    # rows past T zero-filled by TMA; D 32 takes the 64-byte swizzle
    (1, 2, 63, 64, True, 0.1), (1, 2, 64, 32, False, 0.1),
    (1, 2, 65, 128, True, 0.0), (1, 2, 127, 32, True, 0.1),
    (1, 2, 129, 128, False, 0.1), (1, 2, 257, 64, True, 0.1),
    (1, 2, 257, 128, False, 0.0),
    # 300 work items: more than one persistent block an SM can take at once
    (2, 150, 128, 64, True, 0.1)]


def _bf16_close(a, b, what):
    assert a.dtype == b.dtype == torch.bfloat16, (what, a.dtype, b.dtype)
    err = (a.float() - b.float()).abs()
    mag = b.float().abs()
    _, e = torch.frexp(mag.clamp_min(2.0 ** -126))  # |b| = m 2^e, m in [.5, 1)
    ulp = torch.ldexp(torch.ones_like(mag), e - 8)
    tol = (BF16_ULPS * ulp + BF16_ROW_TOL * mag.amax(-1, keepdim=True)
           + BF16_ATOL * mag.max())
    assert bool((err <= tol).all()), (what, float((err / tol).max()),
                                      float(err.max()))


def _qkv_bf16(dev, B, H, T, D, seed, n=3):
    return [t.to(torch.bfloat16) for t in _qkv(dev, B, H, T, D, seed, n)]


@pytest.mark.parametrize("B,H,T,D,causal,rate", BF16_CASES)
def test_flash_bf16_kernels_match_plain(dev, B, H, T, D, causal, rate):
    q, k, v, do = _qkv_bf16(dev, B, H, T, D, seed=5 * T + D, n=4)
    sm = D ** -0.5
    native.reset_launches()
    out, lse = fa._flash_forward(q, k, v, causal, sm, rate, 17)
    got = fa._flash_backward(q, k, v, out, lse, do, causal, sm, rate, 17)
    assert {n: native.launches[n] for n in (
        "flash_fwd", "flash_dq", "flash_dkv", "flash_delta", "flash_fwd_bf16",
        "flash_dq_bf16", "flash_dkv_bf16", "flash_delta_bf16")} == {
        "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0, "flash_delta": 0,
        "flash_fwd_bf16": 1, "flash_dq_bf16": 1, "flash_dkv_bf16": 1,
        "flash_delta_bf16": 1}
    assert lse.dtype == torch.float32
    _bf16_close(out, fa._attention_reference(q, k, v, causal, sm, rate, 17),
                "out")
    torch.testing.assert_close(lse, fa._lse_reference(q, k, causal, sm),
                               atol=LSE_TOL, rtol=0)
    ref = fa._flash_backward_reference(q, k, v, out, lse, do, causal, sm,
                                       rate, 17)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        _bf16_close(a, b, name)


@pytest.mark.parametrize("B,H,T,D,causal,rate",
                         [BF16_CASES[0], BF16_CASES[3]])
def test_flash_bf16_kernels_repeat_bit_for_bit(dev, B, H, T, D, causal,
                                               rate):
    q, k, v, do = _qkv_bf16(dev, B, H, T, D, seed=T + 13, n=4)
    sm = D ** -0.5
    runs = []
    for _ in range(2):
        out, lse = fa._flash_forward(q, k, v, causal, sm, rate, 5)
        runs.append((out, lse, *fa._flash_backward(q, k, v, out, lse, do,
                                                   causal, sm, rate, 5)))
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16
                                  else torch.int32),
                           b.view(torch.int16 if b.dtype == torch.bfloat16
                                  else torch.int32))


def test_flash_bf16_backward_refuses_a_misaligned_view(dev):
    """The bf16 backward kernels load through TMA tensor maps, which need
    16-byte-aligned bases: a bf16 view 2 bytes into its storage raises
    before any launch."""
    q, k, v, do = _qkv_bf16(dev, 1, 2, 64, 64, seed=9, n=4)
    out, lse = fa._flash_forward(q, k, v, False, 0.125)
    delta = fa.flash_delta(out, do)
    buf = torch.empty(q.numel() + 8, dtype=torch.bfloat16, device=dev)
    odd = buf[1:1 + q.numel()].view(q.shape)
    odd.copy_(q)
    native.reset_launches()
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._flash_dq(odd, k, v, do, lse, delta, False, 0.125)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._flash_dkv(q, k, odd, do, lse, delta, False, 0.125)
    assert native.launches["flash_dq_bf16"] == 0
    assert native.launches["flash_dkv_bf16"] == 0


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [32, 128])
@pytest.mark.parametrize("T", [1, 63, 65, 127, 129, 257, 300])
def test_flash_fwd_bf16_at_ragged_T(dev, T, D, causal):
    """The bf16 forward's edges: 64-row query tiles in 128-row work items,
    128-key K/V tiles (64 at D 128), rows past T zero-filled by TMA and
    clipped from the store, columns past T masked; D 32 takes the 64-byte
    swizzle, D 128 two 64-column panels."""
    q, k, v = _qkv_bf16(dev, 2, 3, T, D, seed=11 * T + D)
    sm = D ** -0.5
    native.reset_launches()
    out, lse = fa._flash_forward(q, k, v, causal, sm, 0.1, 19)
    assert native.launches["flash_fwd_bf16"] == 1
    _bf16_close(out, fa._attention_reference(q, k, v, causal, sm, 0.1, 19),
                "out")
    torch.testing.assert_close(lse, fa._lse_reference(q, k, causal, sm),
                               atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_bf16_on_peaked_scores(dev, causal):
    """q and k scaled by 4 before the cast to bf16: W near one-hot and
    the scores 16 times wider, so the running max moves far between key
    tiles and O is rescaled by factors far from 1."""
    q, k, v = _qkv(dev, 2, 4, 256, 64, seed=43)
    q, k, v = (t.to(torch.bfloat16) for t in (q * 4.0, k * 4.0, v))
    sm = 64 ** -0.5
    assert float(torch.softmax(q.float() @ k.float().transpose(-1, -2) * sm,
                               -1).amax(-1).median()) > 0.5
    out, lse = fa._flash_forward(q, k, v, causal, sm, 0.1, 5)
    _bf16_close(out, fa._attention_reference(q, k, v, causal, sm, 0.1, 5),
                "out")
    torch.testing.assert_close(lse, fa._lse_reference(q, k, causal, sm),
                               atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_bf16_past_one_persistent_round(dev, causal):
    """600 work items (300 heads of two 128-row blocks): more than three
    rounds of a grid of one block an SM (132 on an H100), so each block
    walks several items and reuses its Q buffers and ring stages; two
    launches give equal bits."""
    q, k, v = _qkv_bf16(dev, 2, 150, 256, 64, seed=29 + int(causal))
    sm = 64 ** -0.5
    out, lse = fa._flash_forward(q, k, v, causal, sm, 0.1, 8)
    _bf16_close(out, fa._attention_reference(q, k, v, causal, sm, 0.1, 8),
                "out")
    torch.testing.assert_close(lse, fa._lse_reference(q, k, causal, sm),
                               atol=LSE_TOL, rtol=0)
    again = fa._flash_forward(q, k, v, causal, sm, 0.1, 8)
    assert torch.equal(out.view(torch.int16), again[0].view(torch.int16))
    assert torch.equal(lse, again[1])


def test_flash_fwd_bf16_refuses_a_misaligned_view(dev):
    """The bf16 forward loads q, k and v through TMA tensor maps, which
    need 16-byte-aligned bases: a view 2 bytes into its storage raises
    before any launch."""
    q, k, v = _qkv_bf16(dev, 1, 2, 64, 64, seed=9)
    buf = torch.empty(q.numel() + 8, dtype=torch.bfloat16, device=dev)
    odd = buf[1:1 + q.numel()].view(q.shape)
    odd.copy_(k)
    native.reset_launches()
    for args in ((odd, k, v), (q, odd, v), (q, k, odd)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa._flash_forward(*args, False, 0.125)
    assert native.launches["flash_fwd_bf16"] == 0


def test_flash_fwd_bf16_takes_a_negative_scale(dev):
    """The kernel keeps its running max before the scale; the wrapper
    hands it -q and -sm_scale for a negative scale, which is exact."""
    q, k, v = _qkv_bf16(dev, 1, 2, 100, 64, seed=31)
    out, lse = fa._flash_forward(q, k, v, True, -0.125, 0.1, 3)
    _bf16_close(out, fa._attention_reference(q, k, v, True, -0.125, 0.1, 3),
                "out")
    torch.testing.assert_close(lse, fa._lse_reference(q, k, True, -0.125),
                               atol=LSE_TOL, rtol=0)


# delta kernel vs plain: the same float32 sum of D exact (bf16) or once
# rounded (float32) products in another order, so a row lies within this
# share of its sum of |dO O|
DELTA_TOL = 1e-5


@pytest.mark.parametrize("T", [1, 17, 256, 300])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_delta_kernel_matches_plain(dev, dtype, D, T):
    o, do = (t.to(dtype) for t in _qkv(dev, 2, 3, T, D, seed=T + D, n=2))
    native.reset_launches()
    got = fa.flash_delta(o, do)
    counter = "flash_delta" + ("_bf16" if dtype == torch.bfloat16 else "")
    assert native.launches[counter] == 1
    assert sum(native.launches.values()) == 1
    assert got.dtype == torch.float32 and got.shape == (2, 3, T)
    want = fa._flash_delta_reference(o, do)
    scale = (do.float() * o.float()).abs().sum(-1)
    assert bool(((got - want).abs() <= DELTA_TOL * scale).all()), \
        float(((got - want).abs() / scale).max())
    assert torch.equal(got, fa.flash_delta(o, do))


def test_flash_delta_kernel_refuses_a_misaligned_view(dev):
    o, do = (t.to(torch.bfloat16) for t in _qkv(dev, 1, 2, 64, 64, seed=2,
                                                n=2))
    buf = torch.empty(o.numel() + 8, dtype=torch.bfloat16, device=dev)
    odd = buf[1:1 + o.numel()].view(o.shape)
    odd.copy_(o)
    native.reset_launches()
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_delta(odd, do)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_delta(o, odd)
    assert native.launches["flash_delta_bf16"] == 0


@pytest.mark.parametrize("T", [32, 128])
def test_flash_bf16_kernels_drop_exactly_the_plain_mask(dev, T):
    """As test_kernels_drop_exactly_the_plain_mask, in bf16: the same
    bits as the float32 kernels."""
    B, H, D, rate, seed = 1, 3, T, 0.5, 4242
    q, k, v, do = _qkv_bf16(dev, B, H, T, D, seed=T, n=4)
    eye = torch.eye(T, device=dev, dtype=torch.bfloat16).expand(
        B, H, T, T).contiguous()
    dropped = ~fa._attention_keep(seed, B * H, T, T, rate, dev).reshape(
        B, H, T, T)
    out, lse = fa._flash_forward(q, k, eye, False, 0.1, rate, seed)
    assert torch.equal(out == 0, dropped)
    zero = torch.zeros(B, H, T, device=dev)
    dq = fa._flash_dq(q, eye, v, do, lse, zero, False, 0.1, rate, seed)
    assert torch.equal(dq == 0, dropped)
    _, dv = fa._flash_dkv(q, k, v, eye, lse, zero, False, 0.1, rate, seed)
    assert torch.equal(dv == 0, dropped.transpose(-1, -2))


@pytest.mark.parametrize("shape", [(32, 256, 512), (5, 7, 3), (1031,)])
def test_dropout_bf16_kernel_equals_plain_and_keeps_the_f32_bits(dev, shape):
    g = torch.Generator(device=dev).manual_seed(shape[0])
    x = torch.randn(*shape, device=dev, generator=g)
    xb = x.to(torch.bfloat16)
    seed = 0xC0FFEE12
    native.reset_launches()
    out, mask = dk.dropout_forward(xb, seed, 0.1, want_mask=True)
    assert (native.launches["dropout_bf16"], native.launches["dropout"]) \
        == (1, 0)
    ref_out, ref_mask = dk.dropout_reference(xb, seed, 0.1)
    assert out.dtype == mask.dtype == torch.bfloat16
    assert torch.equal(out.view(torch.int16), ref_out.view(torch.int16))
    assert torch.equal(mask.view(torch.int16), ref_mask.view(torch.int16))
    _, mask32 = dk.dropout_forward(x, seed, 0.1, want_mask=True)
    assert torch.equal(mask.float(), mask32)
    # the kept elements scaled by 1/(1 - 0.1) rounded to bf16
    assert dk.drop_scale(0.1, torch.bfloat16) == 1.109375
    kept = mask.bool()
    assert torch.equal(out[kept], (xb[kept].float() * 1.109375).to(
        torch.bfloat16))


def test_pool2d_nhwc_bf16_avg_grad_on_card_equals_host(dev):
    """The channels-last avg_pool2d backward fault, in bf16: card and host
    agree within bf16 rounding."""
    x = torch.from_numpy(np.random.RandomState(3).randn(4, 28, 28, 64)
                         .astype(np.float32)).to(torch.bfloat16)
    attrs = {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
             "paddings": [1, 1], "exclusive": True, "data_format": "NHWC"}
    res = []
    for d in (dev, torch.device("cpu")):
        xv = x.to(d).clone().requires_grad_(True)
        y = _rule("pool2d", attrs, X=xv)["Out"][0]
        cot = torch.from_numpy(np.random.RandomState(9).randn(
            *y.shape).astype(np.float32)).to(d).to(torch.bfloat16)
        res.append([y, *torch.autograd.grad(y, [xv], cot)])
    for a, b in zip(*res):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.cpu().float(), b.float(), atol=2e-2,
                                   rtol=2e-2)


def test_amp_step_launches_only_the_bf16_kernels(dev):
    """One AMP step of a one-layer Transformer-base (batch 2) under
    dropout_impl=pallas: the bf16 flash kernels launch and the float32
    ones not at all; the dropout kernel launches in bf16 at every site but
    the two right after the embeddings, whose input (embedding plus
    position table) no bf16 op has reached, and which therefore run in
    float32, as in the JAX package; parameters and Adam state stay
    float32."""
    from paddle_tpu_torch import flags, optimizer
    from paddle_tpu_torch.models import transformer
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, fetches = transformer.build(n_layer=1, dropout_rate=0.1)
        optimizer.Adam(learning_rate=1e-3).minimize(fetches["loss"])
    n_sites = sum(op.type == "dropout" for op in main.global_block().ops)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CUDAPlace(0), amp=True)
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {n: rng.randint(0, 30000, (2, 256)).astype(np.int64)
            for n in ("src_word", "trg_word", "lbl_word")}
    flags.set_flag("dropout_impl", "pallas")
    try:
        native.reset_launches()
        loss, = exe.run(main, feed=feed, fetch_list=[fetches["loss"]],
                        scope=scope)
    finally:
        flags.set_flag("dropout_impl", "auto")
    assert np.isfinite(loss).all()
    want = dict.fromkeys(native.launches, 0)
    want.update(flash_fwd_bf16=6, flash_dq_bf16=3, flash_dkv_bf16=3,
                flash_delta_bf16=3, dropout=2 * 2,
                dropout_bf16=2 * (n_sites - 2))
    assert native.launches == want
    for n in scope.local_var_names():
        v = scope.find_var(n)
        if v.is_floating_point():
            assert v.dtype == torch.float32, n


def test_amp_executor_on_card_asks_for_float32_sums(dev):
    """An AMP executor on a card turns cuBLAS's bf16 split-K reductions off
    for the process (the JAX package sums bf16 products in float32); a
    float32 executor leaves the setting alone."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    try:
        matmul.allow_bf16_reduced_precision_reduction = True
        ptt.Executor(ptt.CUDAPlace(0))
        assert matmul.allow_bf16_reduced_precision_reduction
        ptt.Executor(ptt.CUDAPlace(0), amp=True)
        assert not matmul.allow_bf16_reduced_precision_reduction
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before


# ---------------------------------------------------------------------------
# the zoo and optimizer slice: the unfused attention's dropout, the optimizer
# sweep, an SE-ResNeXt step, the bf16 softmax and average pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,B", [("float32", 32), ("bfloat16", 64)])
def test_dropout_kernel_at_the_unfused_attention_weights(dev, dtype, B):
    """Kernel 6 at train-base-unfused's attention weights [B, 8, 256, 256]
    (float32 at B 32, bf16 at B 64): Out, Mask and the backward's launch
    on dy equal to the plain version bit for bit."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(B)
    x = torch.randn(B, 8, 256, 256, device=dev, generator=g).to(dt)
    dy = torch.randn(B, 8, 256, 256, device=dev, generator=g).to(dt)
    assert dk.supports(x, 0.1)
    native.reset_launches()
    out, mask = dk.dropout_forward(x, 77, 0.1, want_mask=True)
    dx, _ = dk.dropout_forward(dy, 77, 0.1)
    name = "dropout" if dtype == "float32" else "dropout_bf16"
    assert native.launches[name] == 2
    ref_out, ref_mask = dk.dropout_reference(x, 77, 0.1)
    ref_dx, _ = dk.dropout_reference(dy, 77, 0.1)
    view = torch.int32 if dtype == "float32" else torch.int16
    for a, b in ((out, ref_out), (mask, ref_mask), (dx, ref_dx)):
        assert torch.equal(a.view(view), b.view(view))


def test_unfused_transformer_one_layer_on_card_under_the_dropout_flag(dev):
    """One step of a one-layer unfused Transformer-base at batch 2 under
    FLAGS_dropout_impl=pallas: no flash kernel, and the dropout kernel at
    every gated site (its 3 attention weights among them) forward and
    backward, none writing a Mask."""
    from paddle_tpu_torch import flags, optimizer
    from paddle_tpu_torch.models import transformer
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, fetches = transformer.build(n_layer=1, fused_attention=False)
        optimizer.Adam(learning_rate=1e-3).minimize(fetches["loss"])
    gb = main.global_block()
    gated = sum(op.type == "dropout"
                and gb.vars[op.inputs["X"][0]].shape[-1] % 128 == 0
                for op in gb.ops)
    assert gated == 2 + 3 + 4 + 3           # embeddings, enc, dec, attention
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(1)
    feed = {n: rng.randint(0, 30000, (2, 256)).astype(np.int64)
            for n in ("src_word", "trg_word", "lbl_word")}
    flags.set_flag("dropout_impl", "pallas")
    try:
        native.reset_launches()
        loss, = exe.run(main, feed=feed, fetch_list=[fetches["loss"]],
                        scope=scope)
    finally:
        flags.set_flag("dropout_impl", "auto")
    assert np.isfinite(loss).all()
    want = dict.fromkeys(native.launches, 0)
    want["dropout"] = 2 * gated
    assert native.launches == want


def test_optimizer_sweep_on_card_equals_host(dev):
    """chip_smoke.py's optimizer sweep at width 64, batch 16: every
    optimizer class, ModelAverage, every schedule, append_LARS, every
    clip and a per-parameter learning rate, 3 steps on the card and on
    the host from one state, within the sweep's stated tolerances."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    for case in chip_smoke.SWEEP_CASES:
        chip_smoke.run_sweep_case(torch, ptt, case, width=64, batch=16)


def test_se_resnext50_step_on_card_equals_host(dev):
    """One step of SE-ResNeXt-50 at 32 x 32, NHWC, batch 8, 10 classes,
    Momentum on piecewise_decay with L2Decay, from one startup state on
    the card and on the host: the loss to 1e-4 relative, the running
    stats and the step counter to 1e-4, every velocity within 0.1
    relative L2 (as the ResNet-50 step above), no kernel launched."""
    from paddle_tpu_torch import optimizer, regularizer
    from paddle_tpu_torch.core.executor import fetch_var
    from paddle_tpu_torch.models import se_resnext
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, fetches = se_resnext.build(class_dim=10, image_shape=(3, 32, 32),
                                      data_format="NHWC")
        lr = ptt.layers.piecewise_decay([1, 2], [1e-3, 1e-4, 1e-5])
        optimizer.Momentum(learning_rate=lr, momentum=0.9,
                           regularization=regularizer.L2Decay(1e-4)
                           ).minimize(fetches["loss"])
    scope0 = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope0)
    arrays = {n: fetch_var(n, scope0) for n in scope0.local_var_names()}
    rng = np.random.RandomState(14)
    feed = {"image": rng.rand(8, 32, 32, 3).astype(np.float32),
            "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}
    out = {}
    for side, place in (("card", ptt.CUDAPlace(0)), ("host", ptt.CPUPlace())):
        scope = ptt.io.state_from_numpy(arrays, place)
        native.reset_launches()
        loss, = ptt.Executor(place).run(main, feed=feed,
                                        fetch_list=[fetches["loss"]],
                                        scope=scope)
        assert not any(native.launches.values())
        out[side] = (loss, {n: fetch_var(n, scope) for n in arrays})
    assert np.isfinite(out["card"][0]).all()
    np.testing.assert_allclose(out["card"][0], out["host"][0], rtol=1e-4)
    stats = {op.inputs[s][0] for op in main.global_block().ops
             if op.type == "batch_norm" for s in ("Mean", "Variance")}
    assert len(stats) == 2 * 53
    for n in arrays:
        a, b = out["card"][1][n], out["host"][1][n]
        if n in stats or n == "@LR_DECAY_COUNTER@":
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=n)
        elif "velocity" in n:
            assert np.linalg.norm(a - b) <= 0.1 * np.linalg.norm(b), n


def test_bf16_softmax_sigmoid_and_avg_pool_on_card_equal_host(dev):
    """The bf16 rules that round at each step (softmax, sigmoid, the
    windowed average pool) on the card against the host: the pool (adds
    and divides only) bit for bit; softmax and sigmoid, whose float32 exp
    may differ by an ulp between the card's and the host's libraries,
    each output within one bf16 ulp and all but 1 in 1000 equal. Their
    grads (the pool's averages a contiguous NCHW copy: the comment at
    ops/nn.py::_window_pool) within SPECS' AMP tolerance."""
    from paddle_tpu_torch.core import registry
    x = torch.randn(4, 6, 64, generator=torch.Generator().manual_seed(3))
    img = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(4))
    cases = (("softmax", {"axis": -1}, x), ("sigmoid", {}, x * 4),
             ("pool2d", {"pooling_type": "avg", "ksize": [3, 3],
                         "strides": [2, 2], "paddings": [1, 1],
                         "exclusive": True, "data_format": "NHWC"}, img))
    for op, attrs, a in cases:
        res = {}
        for d in ("cpu", dev):
            t = a.to(torch.bfloat16).to(d).requires_grad_(True)
            out = registry.get_op_def(op).lower(
                registry.LoweringContext(attrs, d), t)["Out"]
            g, = torch.autograd.grad(out.float().square().sum(), t)
            res[str(d)] = (out.detach().cpu(), g.cpu())
        (oc, gc), (od, gd) = res["cpu"], res[str(dev)]
        assert od.dtype == torch.bfloat16
        diff = (od.view(torch.int16).int() - oc.view(torch.int16).int()).abs()
        if op == "pool2d":
            assert not diff.any()
        else:
            assert diff.max() <= 1 and (diff != 0).float().mean() <= 1e-3, op
        torch.testing.assert_close(gd.float(), gc.float(), rtol=2e-2,
                                   atol=2e-3)


def _lstm_rule(place_dev, ins, attrs, lens, dtype):
    from paddle_tpu_torch.core import registry
    t = {k: torch.from_numpy(v).to(place_dev, dtype) for k, v in ins.items()}
    out = registry.get_op_def("lstm").lower(
        registry.LoweringContext(attrs, place_dev), **t,
        SeqLen=torch.from_numpy(lens).to(place_dev))
    return {k: v.float().cpu().numpy() for k, v in out.items()}


# the card's bf16 lstm against the host's, as a share of bf16's own noise
# (the host's bf16 against its float32): the card's GEMMs and exp / tanh
# round in their own order, a far smaller difference than bf16's rounding;
# the card's float32 run, rounded to bf16, lies outside it (the control)
LSTM_BF16_NOISE_SHARE = 0.5


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_rule_bf16_on_card_within_bf16_noise_of_host(dev, reverse):
    """The bf16 `lstm` rule at the stacked LSTM's widths (B 64, T 100, H
    512, peepholes): the card's output within LSTM_BF16_NOISE_SHARE of
    the host's bf16-vs-float32 distance from the host's bf16 output, and
    the card's float32 output rounded to bf16 outside it; finished rows
    keep zeros past their lengths on both."""
    rng = np.random.RandomState(7)
    B, T, H = 64, 100, 512
    lens = rng.randint(T // 2, T + 1, B).astype(np.int32)
    lens[:2] = (1, T)
    ins = {"Input": rng.randn(B, T, 4 * H).astype(np.float32),
           "Weight": (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32),
           "Bias": (rng.randn(1, 7 * H) * 0.1).astype(np.float32)}
    attrs = {"use_peepholes": True, "is_reverse": reverse}
    card = _lstm_rule(dev, ins, attrs, lens, torch.bfloat16)
    card32 = _lstm_rule(dev, ins, attrs, lens, torch.float32)
    host = _lstm_rule(torch.device("cpu"), ins, attrs, lens, torch.bfloat16)
    host32 = _lstm_rule(torch.device("cpu"), ins, attrs, lens,
                        torch.float32)

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    for k in card:
        pad = np.arange(T)[None, :] >= lens[:, None]
        assert not card[k][pad].any() and not host[k][pad].any()
        limit = LSTM_BF16_NOISE_SHARE * rel(host[k], host32[k])
        dist = rel(card[k], host[k])
        control = rel(torch.from_numpy(card32[k]).bfloat16().float().numpy(),
                      host[k])
        print(f"lstm bf16 {k} reverse={reverse}: card {dist:.3e}, "
              f"float32 control {control:.3e}, limit {limit:.3e}")
        assert dist <= limit, (k, dist, limit)
        assert control > limit, (k, control, limit)


# ---------------------------------------------------------------------------
# control flow on the card: the loop ops and the beam ops against the host
# (chip_smoke.py owns the full-width machine_translation train and beam
# decode; these check the ops at small sizes)
# ---------------------------------------------------------------------------

CONTROL_TOL = 1e-5


def _card_and_host(dev, build, feed, backward=True):
    """`build(L)` -> (loss or None, fetch names) in a fresh Program, its
    grads appended when there is a loss; one step on the host and one on
    the card from the same startup state. Returns (names, host, card)."""
    from paddle_tpu_torch.core.backward import append_backward
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        loss, names = build(ptt.layers)
        if loss is not None and backward:
            append_backward(loss)
            gb = main.global_block()
            names = names + sorted(n for n in gb.vars if n.endswith("@GRAD")
                                   and n[:-5] in gb.vars
                                   and gb.vars[n[:-5]].persistable)
    host_exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    host_exe.run(startup, scope=scope)
    state = {n: ptt.core.executor.fetch_var(n, scope)
             for n in scope.local_var_names()}
    host = host_exe.run(main, feed=feed, fetch_list=names,
                        scope=ptt.io.state_from_numpy(state, ptt.CPUPlace()))
    card = ptt.Executor(ptt.CUDAPlace(0)).run(
        main, feed=feed, fetch_list=names,
        scope=ptt.io.state_from_numpy(state, ptt.CUDAPlace(0)))
    return names, host, card


def _assert_card_is_host(names, host, card):
    for n, h, c in zip(names, host, card):
        assert h.shape == c.shape and h.dtype == c.dtype, n
        if h.dtype.kind in "iub":
            np.testing.assert_array_equal(c, h, err_msg=n)
        else:
            assert np.abs(c - h).max(initial=0) \
                <= CONTROL_TOL * (1 + np.abs(h).max(initial=0)), n


def test_static_rnn_on_card_equals_host(dev):
    """A StaticRNN over 12 steps (an fc + gru_unit body, the MT decoder's
    cell) with its grads: the body's parameters reach their grads through
    the static_rnn grad's recompute on the card."""
    rng = np.random.RandomState(11)

    def build(L):
        xs = L.data("xs", shape=[12, 32])
        h0 = L.fc(L.data("x", shape=[32]), 48)
        rnn = L.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(xs)
            h = rnn.memory(init=h0)
            gate = L.fc(L.concat([xt, h], axis=1), 144, bias_attr=False)
            nh, _, _ = L.gru_unit(gate, h, 144)
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        out = rnn()
        return L.mean(L.fc(out, 1, num_flatten_dims=2)), [out.name]

    names, host, card = _card_and_host(
        dev, build, {"xs": rng.randn(8, 12, 32).astype(np.float32),
                     "x": rng.randn(8, 32).astype(np.float32)})
    assert len(names) >= 5
    _assert_card_is_host(names, host, card)
    assert all(np.abs(g).max() > 0 for g in card[1:])


def test_dynamic_rnn_on_card_equals_host(dev):
    """DynamicRNN over lengths 1..12 with a static input and a memory."""
    rng = np.random.RandomState(12)
    lens = np.array([1, 12, 5, 9, 3, 12, 7, 2], np.int32)

    def build(L):
        xs = L.data("xs", shape=[32], lod_level=1)
        s = L.data("s", shape=[32])
        rnn = L.DynamicRNN()
        with rnn.block():
            xt = rnn.step_input(xs)
            st = rnn.static_input(s)
            h = rnn.memory(shape=[48], value=0.0)
            nh = L.fc([xt, h, st], 48, act="tanh")
            rnn.update_memory(h, nh)
            rnn.output(nh)
        out = rnn()
        last = L.sequence_pool(out, "last")
        return L.mean(L.fc(last, 1)), [out.name, last.name]

    names, host, card = _card_and_host(
        dev, build, {"xs": (rng.randn(8, 12, 32).astype(np.float32), lens),
                     "s": rng.randn(8, 32).astype(np.float32)})
    _assert_card_is_host(names, host, card)
    out = card[0]
    for b, n in enumerate(lens):
        assert not out[b, n:].any()


def test_beam_decode_on_card_equals_host(dev):
    """machine_translation.build_infer at dict 64, width 32, beam 4,
    max_len 8: tile_beam, batch_gather, beam_search_step and
    beam_backtrack inside and after a StaticRNN; ids equal, scores to
    CONTROL_TOL."""
    from paddle_tpu_torch.models import machine_translation
    rng = np.random.RandomState(13)

    def build(L):
        _, f = machine_translation.build_infer(
            dict_size=64, emb_dim=32, hidden_dim=32, beam_size=4, max_len=8)
        return None, [f["ids"].name, f["scores"].name]

    names, host, card = _card_and_host(
        dev, build, {"src_word": (rng.randint(2, 64, (6, 10, 1)),
                                  np.array([10, 1, 4, 7, 10, 2], np.int32))},
        backward=False)
    assert card[0].shape == (6, 4, 8)
    _assert_card_is_host(names, host, card)


# ---------------------------------------------------------------------------
# one-shot serving and hot swap
# ---------------------------------------------------------------------------

def _save_oneshot(path, model, scale=1.0):
    """An MLP (6 -> 8 -> 3) or resnet_cifar10 depth 8 (32 x 32 x 3 NHWC,
    `is_test`, running stats drawn from a seed) saved by the port; `scale`
    multiplies every parameter, so a re-save is another version."""
    from paddle_tpu_torch.models import resnet
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = 3
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        if model == "mlp":
            x = ptt.layers.data("x", shape=[6], dtype="float32")
            h = ptt.layers.fc(input=x, size=8, act="relu")
            pred = ptt.layers.fc(input=h, size=3, act="softmax")
        else:
            x = ptt.layers.data("x", shape=[32, 32, 3], dtype="float32")
            pred = resnet.resnet_cifar10(x, class_dim=10, depth=8,
                                         is_test=True, data_format="NHWC")
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(7)
    for op in main.global_block().ops:
        if op.type == "batch_norm":
            mean, var = op.input("Mean")[0], op.input("Variance")[0]
            c = tuple(scope.find_var(mean).shape)
            scope.set_var(mean, torch.from_numpy(
                (rng.randn(*c) * 0.1).astype(np.float32)))
            scope.set_var(var, torch.from_numpy(
                rng.uniform(0.5, 1.5, c).astype(np.float32)))
    for n in scope.local_var_names():
        scope.set_var(n, scope.find_var(n) * scale)
    ptt.io.save_inference_model(path, ["x"], [pred], exe, main_program=main,
                                scope=scope)
    return (6,) if model == "mlp" else (32, 32, 3)


@pytest.mark.parametrize("model", ["mlp", "resnet"])
def test_oneshot_infer_on_card_equals_host(dev, tmp_path, model):
    mdir = str(tmp_path / model)
    shape = _save_oneshot(mdir, model)
    rng = np.random.RandomState(0)
    feeds = [rng.rand(n, *shape).astype(np.float32) for n in (1, 3, 2, 4)]
    out = {}
    for name, place in (("card", ptt.CUDAPlace(0)), ("host", ptt.CPUPlace())):
        with ptt.serve.InferenceServer(place) as srv:
            srv.add_model(model, mdir,
                          ladder=ptt.serve.BucketLadder(rows=(1, 2, 4)))
            native.reset_launches()
            futs = [srv.submit(model, {"x": f}) for f in feeds]
            out[name] = [f.result(timeout=120)[0] for f in futs]
            assert not any(native.launches.values()), native.launches
    for a, b, f in zip(out["card"], out["host"], feeds):
        assert a.shape == b.shape == (len(f), 3 if model == "mlp" else 10)
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_oneshot_swap_under_traffic_on_card(dev, tmp_path):
    mdir, mdir2 = str(tmp_path / "v1"), str(tmp_path / "v2")
    _save_oneshot(mdir, "mlp")
    _save_oneshot(mdir2, "mlp", scale=1.01)
    x = np.full((1, 6), 0.5, np.float32)
    with ptt.serve.InferenceServer(ptt.CPUPlace()) as host:
        host.add_model("m", mdir2, ladder=ptt.serve.BucketLadder(rows=(1,)))
        want, = host.infer("m", {"x": x})
    with ptt.serve.InferenceServer(ptt.CUDAPlace(0)) as srv:
        v1 = srv.add_model("m", mdir, ladder=ptt.serve.BucketLadder(
            rows=(1, 2, 4)), batch_timeout_ms=1.0)
        errors, served = [], []
        stop = threading.Event()

        def client():
            while not stop.is_set():
                try:
                    fut = srv.submit("m", {"x": x})
                    fut.result(timeout=60)
                    served.append(fut.version_id)
                except Exception as e:      # noqa: BLE001
                    errors.append(repr(e))

        ts = [threading.Thread(target=client) for _ in range(4)]
        for t in ts:
            t.start()
        time.sleep(0.2)
        srv.prepare_swap("m", mdir2)
        v2 = srv.commit_swap("m")
        time.sleep(0.2)
        stop.set()
        for t in ts:
            t.join(timeout=60)
        assert errors == [] and not any(t.is_alive() for t in ts)
        assert set(served) == {v1.version_id, v2.version_id}
        assert v1.wait_retired(10)
        got, = srv.infer("m", {"x": x})
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the data plane: AsyncFeeder's pinned ring and side stream, py_reader's
# double buffer, the profiler's CUDA activity
# ---------------------------------------------------------------------------

def test_async_feeder_copies_from_a_reused_pinned_ring_on_a_side_stream(dev):
    from paddle_tpu_torch.async_feeder import AsyncFeeder
    n, capacity = 12, 2
    batches = [[{"x": np.full((256, 1024), i, np.float32),
                 "n": np.arange(4, dtype=np.int64) + i}] for i in range(n)]
    feeder = AsyncFeeder(lambda b: b[0], lambda: iter(batches),
                         capacity=capacity, device=ptt.CUDAPlace(0))
    seen = []
    for feed in feeder:
        assert feed["x"].is_cuda and feed["n"].is_cuda
        seen.append((float(feed["x"][0, 0]), feed["n"].tolist()))
    assert seen == [(float(i), list(range(i, i + 4))) for i in range(n)]
    stager = feeder.stager
    assert stager.stream is not None
    assert stager.stream.cuda_stream != \
        torch.cuda.default_stream(dev).cuda_stream
    ring = capacity + 2
    # two arrays a batch, one pinned buffer each a ring slot: 12 batches
    # through a ring of 4 allocate no more than that
    assert stager.pinned_allocs == 2 * ring
    bufs = [b for s in stager._slots for b in s.buffers.values()]
    assert len(bufs) == 2 * ring and all(b.is_pinned() for b in bufs)


def test_async_feeder_batch_survives_later_copies_on_card(dev):
    """The step's stream still reads a batch after the consumer dropped it
    and later batches were copied: a busy kernel queued ahead of each read
    keeps the read pending while the producer stages more batches. Without
    the event wait and record_stream, a later copy lands in the dropped
    batch's memory and a sum reads another batch's fill value."""
    from paddle_tpu_torch.async_feeder import AsyncFeeder
    n, size = 16, 1 << 20
    batches = [[{"x": np.full(size, i, np.float32)}] for i in range(n)]
    sums = []
    for feed in AsyncFeeder(lambda b: b[0], lambda: iter(batches),
                            capacity=4, device=dev):
        torch.cuda._sleep(20_000_000)
        sums.append(feed["x"].sum())
        del feed
    torch.cuda.synchronize()
    assert [float(s) for s in sums] == [float(i * size) for i in range(n)]


def test_py_reader_double_buffer_on_card_equals_host(dev, tmp_path):
    import pickle
    from paddle_tpu_torch import recordio
    path = str(tmp_path / "train.recordio")
    rng = np.random.RandomState(0)
    w_true = rng.randn(4, 1).astype(np.float32)
    recs = []
    for _ in range(64):
        x = rng.randn(4).astype(np.float32)
        recs.append(pickle.dumps((x, (x @ w_true).astype(np.float32))))
    recordio.write_file(path, recs)
    losses, state = {}, None
    for name, place in (("host", ptt.CPUPlace()), ("card", ptt.CUDAPlace(0))):
        main, startup = ptt.Program(), ptt.Program()
        with ptt.program_guard(main, startup), ptt.unique_name.guard():
            reader, feed_vars = ptt.layers.open_recordio_file(
                path, shapes=[[-1, 4], [-1, 1]],
                dtypes=["float32", "float32"], pass_num=1)
            reader = ptt.layers.double_buffer(reader, place=place)
            xv, yv = feed_vars
            pred = ptt.layers.fc(input=xv, size=1)
            loss = ptt.layers.mean(ptt.layers.square_error_cost(pred, yv))
            ptt.optimizer.SGD(learning_rate=0.05).minimize(loss)
        exe = ptt.Executor(place)
        scope = ptt.Scope()
        exe.run(startup, scope=scope)
        if state is None:
            state = {k: scope.find_var(k).numpy().copy()
                     for k in scope.local_var_names()}
        else:
            ptt.io.state_from_numpy(state, place, scope=scope)
        popped = []
        pop = reader.next_feed

        def spy(device=None):
            feed = pop(device)
            popped.append(all(t.device.type == place.torch_device().type
                              for t in feed.values()))
            return feed

        reader.next_feed = spy
        out = []
        for _ in range(2):
            reader.start()
            while True:
                try:
                    out.append(float(exe.run(main, fetch_list=[loss],
                                             scope=scope)[0].reshape(-1)[0]))
                except ptt.EOFException:
                    reader.reset()
                    break
        losses[name] = out
        assert all(popped) and len(out) == 8
        if name == "card":
            assert reader._stager.cuda and reader._stager.pinned_allocs > 0
    np.testing.assert_allclose(losses["card"], losses["host"], rtol=1e-5)


def test_py_reader_and_async_feeder_default_to_the_card(dev):
    """With no place named, a py_reader iterated directly (no executor
    pops it) and an AsyncFeeder stage onto card 0 through the pinned ring
    on a side stream; the producer runs from start(), so batches are
    staged before the first pop. A reader given CPUPlace() through
    double_buffer stays on the host."""
    from paddle_tpu_torch.async_feeder import AsyncFeeder, _Staged
    n = 6

    def batches():
        return ({"x": np.full((64, 256), i, np.float32)} for i in range(n))

    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        reader, (xv,) = ptt.reader.py_reader(
            capacity=2, shapes=[[-1, 256]], dtypes=["float32"])
        host_reader, (hv,) = ptt.reader.py_reader(
            capacity=2, shapes=[[-1, 256]], dtypes=["float32"])
    assert ptt.layers.double_buffer(host_reader,
                                    place=ptt.CPUPlace()) is host_reader
    reader.decorate_tensor_provider(
        lambda: ({xv.name: f["x"]} for f in batches()))
    reader.start()
    deadline = time.time() + 60
    while reader._queue.qsize() < 2 and time.time() < deadline:
        time.sleep(0.01)
    assert isinstance(reader._queue.queue[0], _Staged)
    seen = [f[xv.name] for f in reader]
    reader.reset()
    assert all(t.device == torch.device("cuda", 0) for t in seen)
    assert [float(t[0, 0]) for t in seen] == [float(i) for i in range(n)]
    stager = reader._stager
    assert stager.cuda and 0 < stager.pinned_allocs <= 2 + 2
    assert stager.stream.cuda_stream != \
        torch.cuda.default_stream(dev).cuda_stream
    # a host executor's pop: this pass stays on the card (the executor's
    # feed conversion moves it), the next one stages on the host
    reader.start()
    assert reader.next_feed(ptt.CPUPlace())[xv.name].is_cuda
    reader.reset()
    reader.start()
    assert reader.next_feed()[xv.name].device.type == "cpu"
    reader.reset()
    host_reader.decorate_tensor_provider(
        lambda: ({hv.name: f["x"]} for f in batches()))
    host_reader.start()
    assert all(f[hv.name].device.type == "cpu" for f in host_reader)
    host_reader.reset()
    feeder = AsyncFeeder(lambda b: b, batches, capacity=2)
    got = [f["x"] for f in feeder]
    assert all(t.device == torch.device("cuda", 0) for t in got)
    assert [float(t[0, 0]) for t in got] == [float(i) for i in range(n)]
    assert feeder.stager.cuda and feeder.stager.pinned_allocs == 2 + 2


def test_preprocessor_on_card_equals_host(dev):
    """Preprocessor's default place is CUDAPlace(0): its outputs are card
    tensors, equal to a CPUPlace() Preprocessor's (elementwise float32,
    exact)."""
    def source():
        rng = np.random.RandomState(0)
        for _ in range(3):
            yield (rng.randn(4, 5).astype(np.float32),)

    outs = {}
    for name, place in (("card", None), ("host", ptt.CPUPlace())):
        pre = ptt.layers.Preprocessor(source, place=place)
        with pre.block():
            x, = pre.inputs(["float32"], [[4, 5]])
            pre.outputs(ptt.layers.scale(x, scale=3.0, bias=1.0))
        outs[name] = [o for o, in pre()()]
    assert all(t.device == torch.device("cuda", 0) for t in outs["card"])
    assert all(t.device.type == "cpu" for t in outs["host"])
    for a, b in zip(outs["card"], outs["host"]):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())


def test_profiler_all_records_cuda_kernels(dev, tmp_path):
    import json
    from paddle_tpu_torch import profiler as prof
    with prof.profiler(state="All", profile_path=str(tmp_path)):
        with prof.record_event("matmul"):
            a = torch.randn(512, 512, device=dev)
            (a @ a).sum().item()
    trace = json.load(open(tmp_path / "trace.json"))
    kernels = [e for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    assert kernels, sorted({e.get("cat") for e in trace["traceEvents"]})
    with prof.cuda_profiler("nvtx_range"):
        (a @ a).sum().item()


def _assert_within_scale(names, host, card, rtol):
    """Floats within `rtol` of each tensor's largest host magnitude;
    integers equal."""
    for n, h, c in zip(names, host, card):
        assert h.shape == c.shape and h.dtype == c.dtype, n
        if h.dtype.kind in "iub":
            np.testing.assert_array_equal(c, h, err_msg=n)
        else:
            assert np.abs(c - h).max(initial=0) \
                <= rtol * max(np.abs(h).max(initial=0), 1e-30), n


def test_cos_sim_and_crf_pair_on_card_equal_host(dev):
    """cos_sim (a one-row Y too), linear_chain_crf with its grads, and
    crf_decoding with and without Label, on lengths 1..9 of a batch
    padded to 9: card against host from one state, floats within 1e-5
    of each tensor's scale, the Viterbi paths equal."""
    rng = np.random.RandomState(13)
    lens = np.array([9, 1, 4, 9, 2, 7], np.int32)
    B, T, N = len(lens), 9, 12

    def build(L):
        em = L.data("em", shape=[N], lod_level=1, stop_gradient=False)
        lab = L.data("lab", shape=[1], dtype="int64", lod_level=1)
        x = L.data("x", shape=[16], stop_gradient=False)
        y1 = L.data("y1", shape=[1, 16], append_batch_size=False,
                    stop_gradient=False)
        cost = L.linear_chain_crf(em, lab, param_attr="crfw")
        path = L.crf_decoding(em, param_attr="crfw")
        miss = L.crf_decoding(em, param_attr="crfw", label=lab)
        sim = L.cos_sim(x, L.fc(x, 16))
        sim1 = L.cos_sim(x, y1)
        loss = L.sums([L.mean(cost), L.mean(sim), L.mean(sim1)])
        return loss, [cost.name, path.name, miss.name, sim.name, sim1.name,
                      "em@GRAD", "x@GRAD", "y1@GRAD"]

    feed = {"em": (rng.randn(B, T, N).astype(np.float32), lens),
            "lab": (rng.randint(0, N, (B, T, 1)).astype(np.int64), lens),
            "x": rng.randn(B, 16).astype(np.float32),
            "y1": rng.randn(1, 16).astype(np.float32)}
    native.reset_launches()
    names, host, card = _card_and_host(dev, build, feed)
    assert not any(native.launches.values())
    assert "crfw@GRAD" in names
    _assert_within_scale(names, host, card, 1e-5)
    path = card[1]
    for b, n in enumerate(lens):
        assert not path[b, n:].any()


def test_srl_chapter_steps_on_card_equal_host(dev):
    """Two steps of the book's label_semantic_roles chapter (db_lstm at
    the CPU tests' widths: depth 2, 8 LSTM units) on the card and on the
    host from one state, on the same conll05 batches: the losses within
    1e-5 relative, every persistable within 1e-5 of its scale, and the
    Viterbi paths of the inference program equal."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import torch_book as book
    name = "label_semantic_roles"
    w = book.SMALL[name]
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        ch = book.build(ptt, name, w)
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope)
    state = {n: ptt.core.executor.fetch_var(n, scope)
             for n in scope.local_var_names()}
    state.update(book.init_values(ptt, name))
    df = book.feeder(ptt, ch, ptt.CPUPlace(), main)
    feeds = [book.feed(ch, df, rows)
             for rows in book.batches(ptt, name, w, 2)]
    runs = {}
    native.reset_launches()
    for side, place in (("host", ptt.CPUPlace()), ("card", ptt.CUDAPlace(0))):
        exe = ptt.Executor(place)
        sc = ptt.io.state_from_numpy(state, place)
        losses = [float(exe.run(main, feed=f, fetch_list=[ch.loss],
                                scope=sc)[0].reshape(-1)[0]) for f in feeds]
        paths, = exe.run(main.clone(for_test=True), feed=feeds[0],
                         fetch_list=ch.targets, scope=sc)
        runs[side] = (losses, {n: ptt.core.executor.fetch_var(n, sc)
                               for n in state}, paths)
    assert not any(native.launches.values())
    (hl, hs, hp), (cl, cs, cp) = runs["host"], runs["card"]
    np.testing.assert_allclose(cl, hl, rtol=1e-5)
    for n in state:
        assert np.abs(cs[n] - hs[n]).max() \
            <= 1e-5 * max(np.abs(hs[n]).max(), 1e-30), n
    np.testing.assert_array_equal(cp, hp)


# ---------------------------------------------------------------------------
# the common op breadth: the rules whose answers depend on ties, repeats
# and kinks, and the two new convolutions, on the card against the host
# ---------------------------------------------------------------------------

def _one_op(op_type, inputs, attrs, outs=("Out",), backward=True):
    """A Program of one op on data vars (its inputs), with the grads of
    mean(first output) when `backward`; returns (main, fetch names)."""
    from paddle_tpu_torch.core.backward import append_backward
    from paddle_tpu_torch.layer_helper import LayerHelper
    main = ptt.Program()
    with ptt.program_guard(main, ptt.Program()), ptt.unique_name.guard():
        blk = main.global_block()
        helper = LayerHelper(op_type)
        for slot, a in inputs.items():
            blk.create_var(name=slot, shape=a.shape, dtype=str(a.dtype),
                           is_data=True, stop_gradient=a.dtype.kind != "f")
        out = {s: [helper.create_variable_for_type_inference().name]
               for s in outs}
        helper.append_op(op_type, inputs={s: [s] for s in inputs},
                         outputs=out, attrs=attrs)
        fetch = [out[s][0] for s in outs]
        if backward:
            append_backward(ptt.layers.mean(blk.var(fetch[0])))
            fetch += [s + "@GRAD" for s in inputs if s + "@GRAD" in blk.vars]
    return main, fetch


def _op_runs(dev, op_type, inputs, attrs, outs=("Out",), backward=True,
             card_runs=2):
    """The op on the host once and on the card `card_runs` times."""
    main, fetch = _one_op(op_type, inputs, attrs, outs, backward)
    host = ptt.Executor(ptt.CPUPlace()).run(main, feed=inputs,
                                            fetch_list=fetch,
                                            scope=ptt.Scope())
    native.reset_launches()
    cards = [ptt.Executor(ptt.CUDAPlace(0)).run(main, feed=inputs,
                                                fetch_list=fetch,
                                                scope=ptt.Scope())
             for _ in range(card_runs)]
    assert not any(native.launches.values())
    return fetch, host, cards


@pytest.mark.parametrize("overwrite", [True, False])
def test_scatter_repeated_ids_on_card_equals_host(dev, overwrite):
    """8192 ids over 512 rows, each repeated many times: overwriting, the
    last update wins on the card as on the host, bit for bit; adding, a
    row's updates sum in the ids' order on both, held to 1e-6 of the
    tensor's scale (the kernels differ). Two card runs bit-equal."""
    rng = np.random.RandomState(5)
    ins = {"X": rng.randn(512, 64).astype(np.float32),
           "Ids": rng.randint(0, 512, 8192).astype(np.int64),
           "Updates": rng.randn(8192, 64).astype(np.float32)}
    fetch, host, (c1, c2) = _op_runs(dev, "scatter", ins,
                                     {"overwrite": overwrite})
    for n, a, b in zip(fetch, c1, c2):
        np.testing.assert_array_equal(a, b, err_msg=n)
    if overwrite:
        for n, h, c in zip(fetch, host, c1):
            np.testing.assert_array_equal(c, h, err_msg=n)
    else:
        _assert_within_scale(fetch, host, c1, 1e-6)


def test_argsort_ties_on_card_equal_host(dev):
    x = np.random.RandomState(6).randint(0, 4, (64, 300)).astype(np.float32)
    fetch, host, (c1, _) = _op_runs(dev, "argsort", {"X": x}, {"axis": -1},
                                    outs=("Out", "Indices"), backward=False)
    np.testing.assert_array_equal(c1[1], host[1])
    np.testing.assert_array_equal(c1[1], np.argsort(x, -1, kind="stable"))


def test_one_hot_out_of_range_on_card(dev):
    ids = np.array([[-1], [0], [5], [9], [3]], np.int64)
    _, host, (c1, _) = _op_runs(dev, "one_hot", {"X": ids}, {"depth": 6},
                                backward=False)
    np.testing.assert_array_equal(c1[0], host[0])
    np.testing.assert_array_equal(c1[0].sum(1), [0, 1, 1, 0, 1])


@pytest.mark.parametrize("op_type,ins,attrs", [
    ("clip", {"X": np.array([[0, 6, 3, -1], [7, 0, 6, 2]], np.float32)},
     {"min": 0.0, "max": 6.0}),
    ("clip_by_norm", {"X": np.array([[3, 4]], np.float32)},
     {"max_norm": 5.0}),
    ("sigmoid_cross_entropy_with_logits",
     {"X": np.array([[0, 0.5], [0, -2]], np.float32),
      "Label": np.array([[1, 0], [0, 1]], np.float32)}, {})],
    ids=["clip", "clip_by_norm", "sigmoid_ce"])
def test_repaired_grads_at_their_kinks_on_card_equal_host(dev, op_type, ins,
                                                          attrs):
    fetch, host, (c1, _) = _op_runs(dev, op_type, ins, attrs)
    assert "X@GRAD" in fetch
    for n, h, c in zip(fetch, host, c1):
        np.testing.assert_allclose(c, h, rtol=1e-6, atol=1e-7, err_msg=n)


@pytest.mark.parametrize("op_type,ins,attrs", [
    ("depthwise_conv2d", {"Input": (4, 32, 28, 28), "Filter": (32, 1, 3, 3)},
     {"strides": [1, 1], "paddings": [1, 1], "groups": 1}),
    ("depthwise_conv2d", {"Input": (4, 28, 28, 32), "Filter": (32, 1, 3, 3)},
     {"strides": [2, 2], "paddings": [1, 1], "data_format": "NHWC"}),
    ("conv2d_transpose", {"Input": (4, 32, 14, 14),
                          "Filter": (32, 16, 4, 4)},
     {"strides": [2, 2], "paddings": [1, 1]}),
    ("conv2d_transpose", {"Input": (2, 8, 9, 9), "Filter": (8, 4, 3, 3)},
     {"strides": [2, 2], "paddings": [2, 2], "dilations": [2, 2]})],
    ids=["depthwise", "depthwise_nhwc", "transpose", "transpose_dilated"])
def test_depthwise_and_transposed_convs_on_card_equal_host(dev, op_type, ins,
                                                           attrs):
    """cuDNN in float32 with TF32 off against the host, forward and both
    grads within 1e-5 of each tensor's scale."""
    rng = np.random.RandomState(7)
    ins = {k: rng.randn(*shape).astype(np.float32)
           for k, shape in ins.items()}
    fetch, host, (c1,) = _op_runs(dev, op_type, ins, attrs,
                                  outs=("Output",), card_runs=1)
    assert fetch[1:] == ["Input@GRAD", "Filter@GRAD"]
    _assert_within_scale(fetch, host, c1, 1e-5)


# ---------------------------------------------------------------------------
# the rest of the op families: detection, CTC, resize, quantization
# ---------------------------------------------------------------------------

def _ltrb(rng, *lead):
    pts = np.sort(rng.uniform(0, 1, lead + (2, 2)), axis=-2)
    return pts.reshape(lead + (4,))[..., [0, 2, 1, 3]].astype(np.float32)


@pytest.mark.parametrize("eta", [1.0, 0.8])
def test_multiclass_nms_on_card_equals_host(dev, eta):
    """SSD's test pass at batch 4: 21 classes over 2278 priors, scores
    tied (multiples of 1/64) and many rows padded: Out and Count bit for
    bit, two card runs too."""
    rng = np.random.RandomState(8)
    ins = {"BBoxes": _ltrb(rng, 4, 2278),
           "Scores": (np.round(rng.dirichlet(np.ones(21), (4, 2278))
                               .transpose(0, 2, 1) * 64) / 64)
           .astype(np.float32)}
    attrs = dict(score_threshold=0.05, nms_top_k=400, keep_top_k=200,
                 nms_threshold=0.45 if eta == 1.0 else 0.7, nms_eta=eta)
    fetch, host, (c1, c2) = _op_runs(dev, "multiclass_nms", ins, attrs,
                                     outs=("Out", "Count"), backward=False)
    for h, a, b in zip(host, c1, c2):
        np.testing.assert_array_equal(a, h)
        np.testing.assert_array_equal(b, a)
    assert (host[1] > 0).all()


@pytest.mark.parametrize("ap_version", ["integral", "11point"])
def test_detection_map_on_card_equals_host(dev, ap_version):
    rng = np.random.RandomState(9)
    B, D, G = 16, 200, 16
    det = np.full((B, D, 6), -1.0, np.float32)
    gt = np.full((B, G, 6), -1.0, np.float32)
    for b in range(B):
        n_gt, n_det = rng.randint(1, G + 1), rng.randint(0, D + 1)
        gt[b, :n_gt, 0] = rng.randint(1, 21, n_gt)
        gt[b, :n_gt, 1] = rng.rand(n_gt) < 0.2
        gt[b, :n_gt, 2:] = _ltrb(rng, n_gt)
        det[b, :n_det, 0] = rng.randint(1, 21, n_det)
        det[b, :n_det, 1] = np.round(rng.rand(n_det) * 32) / 32
        near = gt[b, rng.randint(0, n_gt, n_det), 2:] + rng.normal(
            0, 0.03, (n_det, 4))
        det[b, :n_det, 2:] = np.where(rng.rand(n_det, 1) < 0.6, near,
                                      _ltrb(rng, n_det))
    fetch, host, (c1, _) = _op_runs(
        dev, "detection_map", {"DetectRes": det, "Label": gt},
        dict(class_num=21, overlap_threshold=0.5, ap_version=ap_version),
        outs=("MAP",), backward=False)
    np.testing.assert_allclose(c1[0], host[0], rtol=1e-6)
    assert 0 < host[0][0] < 1


def test_warpctc_on_card_equals_host(dev):
    """A CRNN recognizer's shapes: B 32, T 96, 96 classes with the
    blank, labels up to 24 with repeats; the loss and the Logits grad
    within 1e-5 of each tensor's scale."""
    rng = np.random.RandomState(10)
    ins = {"Logits": rng.randn(32, 96, 96).astype(np.float32),
           "Label": rng.randint(1, 4, (32, 24)).astype(np.int64),
           "LogitsLen": rng.randint(60, 97, 32).astype(np.int64),
           "LabelLen": rng.randint(0, 25, 32).astype(np.int64)}
    fetch, host, (c1, c2) = _op_runs(dev, "warpctc", ins, {"blank": 0},
                                     outs=("Loss",))
    assert fetch[1:] == ["Logits@GRAD"]
    _assert_within_scale(fetch, host, c1, 1e-5)
    for a, b in zip(c1, c2):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", [(32, 32), (128, 128), (40, 150)],
                         ids=["down", "up", "mixed"])
def test_bilinear_interp_antialias_on_card_equals_host(dev, size):
    rng = np.random.RandomState(11)
    ins = {"X": rng.randn(4, 16, 64, 64).astype(np.float32)}
    fetch, host, (c1,) = _op_runs(dev, "bilinear_interp", ins,
                                  {"out_h": size[0], "out_w": size[1]},
                                  card_runs=1)
    _assert_within_scale(fetch, host, c1, 1e-5)


@pytest.mark.parametrize("is_test", [False, True])
def test_fake_quantize_range_abs_max_on_card_equals_host(dev, is_test):
    """Out, OutScale and the straight-through grad bit for bit."""
    rng = np.random.RandomState(12)
    ins = {"X": rng.randn(1024, 512).astype(np.float32),
           "InScale": np.array([3.5], np.float32)}
    fetch, host, (c1, c2) = _op_runs(
        dev, "fake_quantize_range_abs_max", ins,
        {"bit_length": 8, "is_test": is_test}, outs=("Out", "OutScale"))
    for h, a, b in zip(host, c1, c2):
        np.testing.assert_array_equal(a, h)
        np.testing.assert_array_equal(b, a)


# ---------------------------------------------------------------------------
# the transpilers on a card scope
# ---------------------------------------------------------------------------

def _card_program(build_fn):
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        out = build_fn(ptt.layers)
    exe = ptt.Executor(ptt.CUDAPlace(0))
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    return main, exe, scope, out


def _conv_bn_net(L):
    x = L.data(name="x", shape=[3, 16, 16], dtype="float32")
    c = L.conv2d(x, num_filters=8, filter_size=3, padding=1, bias_attr=False)
    return L.fc(L.batch_norm(c, is_test=True), size=4)


def _attention_net(L):
    q, k, v = (L.data(name=n, shape=[-1, 4, 128, 64], dtype="float32",
                      append_batch_size=False) for n in "qkv")
    return ptt.models.transformer._fused_attention(q, k, v, 64, True, 0.0,
                                                   True)


def test_transpilers_keep_a_card_scope_on_the_card(dev):
    main, exe, scope, out = _card_program(_conv_bn_net)
    x = np.random.RandomState(0).rand(2, 3, 16, 16).astype(np.float32)
    before, = exe.run(main, feed={"x": x}, fetch_list=[out], scope=scope)
    assert ptt.InferenceTranspiler()._fuse_batch_norm(main, scope) == 1
    params = [v.name for v in main.global_block().vars.values()
              if v.persistable]
    assert any(n.endswith("@bn_folded_bias") for n in params)
    for n in params:
        assert scope.find_var(n).device.type == "cuda", n
    after, = exe.run(main, feed={"x": x}, fetch_list=[out], scope=scope)
    np.testing.assert_allclose(after, before, rtol=1e-4, atol=1e-5)
    ptt.transpiler.Float16Transpiler().transpile(main, scope=scope)
    for n in params:
        t = scope.find_var(n)
        assert t.device.type == "cuda" and t.dtype == torch.bfloat16, n
    half, = exe.run(main, feed={"x": x}, fetch_list=[out], scope=scope)
    assert np.isfinite(half).all() and half.shape == before.shape


def test_bf16_transpiled_attention_launches_the_bf16_forward_only(dev):
    main, exe, scope, out = _card_program(_attention_net)
    ptt.transpiler.Float16Transpiler().transpile(main, scope=scope)
    rng = np.random.RandomState(1)
    feed = {n: rng.randn(2, 4, 128, 64).astype(np.float32) for n in "qkv"}
    native.reset_launches()
    got, = exe.run(main, feed=feed, fetch_list=[out], scope=scope,
                   return_numpy=False)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert {k: v for k, v in native.launches.items() if v} == \
        {"flash_fwd_bf16": 1}
    q, k, v = (torch.from_numpy(feed[n]).to(dev, torch.bfloat16)
               for n in "qkv")
    want = fa._attention_reference(q, k, v, True, 64 ** -0.5)
    err = (got.float() - want.float()).abs()
    assert float(err.max()) <= 2.0 ** -6 * float(want.float().abs().max())


def test_float16_transpiled_attention_raises_on_the_card(dev):
    main, exe, scope, out = _card_program(_attention_net)
    ptt.transpiler.Float16Transpiler().transpile(main, scope=scope,
                                                 dtype="float16")
    feed = {n: np.ones((1, 4, 128, 64), np.float32) for n in "qkv"}
    native.reset_launches()
    with pytest.raises(ValueError, match="float16"):
        exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    assert not any(native.launches.values())


# ---------------------------------------------------------------------------
# the global offsets of a rank's shard (ParallelExecutor under 'dp')
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernels_at_a_batch_offset(dev, dtype, causal):
    """A rank holding batch rows 2.. of 4 passes bh0 = 2 * H: its forward,
    dQ and dK/dV are the whole batch's rows bit for bit (the dropout
    mask is one device's), and the plain version at bh0 agrees."""
    B, H, T, D, rate, seed = 4, 2, 128, 64, 0.1, 5
    q, k, v, do = (t.to(dtype) for t in _qkv(dev, B, H, T, D, seed=9, n=4))
    sm = D ** -0.5
    out, lse = fa._flash_forward(q, k, v, causal, sm, rate, seed)
    delta = fa.flash_delta(out, do)
    dq = fa._flash_dq(q, k, v, do, lse, delta, causal, sm, rate, seed)
    dk, dv = fa._flash_dkv(q, k, v, do, lse, delta, causal, sm, rate, seed)
    half = [t[2:].contiguous() for t in (q, k, v, do, out, lse, delta)]
    hq, hk, hv, hdo, hout, hlse, hdelta = half
    o2, l2 = fa._flash_forward(hq, hk, hv, causal, sm, rate, seed, bh0=2 * H)
    dq2 = fa._flash_dq(hq, hk, hv, hdo, hlse, hdelta, causal, sm, rate,
                       seed, bh0=2 * H)
    dk2, dv2 = fa._flash_dkv(hq, hk, hv, hdo, hlse, hdelta, causal, sm,
                             rate, seed, bh0=2 * H)
    for name, a, b in (("out", o2, out[2:]), ("lse", l2, lse[2:]),
                       ("dq", dq2, dq[2:]), ("dk", dk2, dk[2:]),
                       ("dv", dv2, dv[2:])):
        assert torch.equal(a, b), name
    o1, _ = fa._flash_forward(hq, hk, hv, causal, sm, rate, seed)
    assert not torch.equal(o1, o2)      # bh0 moves the mask
    if dtype == torch.float32:
        torch.testing.assert_close(
            o2, fa._attention_reference(hq, hk, hv, causal, sm, rate, seed,
                                        bh0=2 * H), atol=TOL, rtol=TOL)
        ref = fa._flash_backward_reference(hq, hk, hv, hout, hlse, hdo,
                                           causal, sm, rate, seed,
                                           bh0=2 * H)
        for name, a, b in zip(("dq", "dk", "dv"), (dq2, dk2, dv2), ref):
            torch.testing.assert_close(a, b, atol=BWD_TOL, rtol=BWD_TOL,
                                       msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_kernel_at_a_base(dev, dtype):
    """A rank holding rows 2.. of 4 passes their first element's index:
    its bits are the whole tensor's, and the plain version's at that
    base."""
    x = torch.randn(4, 8, 256, device=dev).to(dtype)
    base = 2 * 8 * 256
    full, full_mask = dk.dropout_forward(x, 77, 0.1, want_mask=True)
    part, part_mask = dk.dropout_forward(x[2:], 77, 0.1, want_mask=True,
                                         base=base)
    assert torch.equal(part, full[2:]) and torch.equal(part_mask,
                                                       full_mask[2:])
    ref, ref_mask = dk.dropout_reference(x[2:], 77, 0.1, base=base)
    assert torch.equal(part, ref) and torch.equal(part_mask, ref_mask)
    with pytest.raises(ValueError, match="multiple of 8"):
        dk.dropout_forward(x[2:], 77, 0.1, base=base + 4)


def test_parallel_executor_on_the_card_is_the_executor(dev):
    """A one-rank ParallelExecutor (use_cuda=True, the default) runs the
    same launches and gives the Executor's losses bit for bit."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, fetches = ptt.models.transformer.build(
            src_vocab_size=64, trg_vocab_size=64, seq_len=64, n_layer=1,
            n_head=2, d_model=64, d_inner=128, dropout_rate=0.1,
            fused_attention=True)
        loss = fetches["loss"]
        ptt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    main.random_seed = startup.random_seed = 3
    rng = np.random.RandomState(0)
    src = rng.randint(1, 64, (4, 64)).astype(np.int64)
    feed = {"src_word": src, "trg_word": src, "lbl_word": src}
    runs = {}
    for kind in ("executor", "parallel"):
        scope = ptt.Scope()
        exe = ptt.Executor(ptt.CUDAPlace(0))
        exe.run(startup, scope=scope)
        native.reset_launches()
        if kind == "executor":
            got = [exe.run(main, feed=feed, fetch_list=[loss],
                           scope=scope)[0] for _ in range(3)]
        else:
            pe = ptt.ParallelExecutor(loss_name=loss.name,
                                      main_program=main, scope=scope)
            got = [pe.run(feed=feed, fetch_list=[loss.name])[0]
                   for _ in range(3)]
        runs[kind] = (got, dict(native.launches))
    assert all(np.array_equal(a, b) for a, b in zip(runs["executor"][0],
                                                    runs["parallel"][0]))
    assert runs["executor"][1] == runs["parallel"][1]
    assert runs["parallel"][1]["flash_fwd"] == 2 * 3 * 3
