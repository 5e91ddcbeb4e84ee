"""paddle_tpu_torch on the card: the CUDA kernels against their plain
PyTorch versions, a small generation on the card against the host, and
two training steps of a one-layer Transformer-base on the card.

Every test here needs an NVIDIA card (sm_90a) and skips without one. On
the card, run (this file imports neither jax nor paddle_tpu, so the repo
conftest, which imports jax, is left out):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import native
from paddle_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda

TOL = 1e-4  # f32 summation order + expf
# backward kernels vs their plain version: dQ, dK and dV are sums over T
# of products of f32 terms that are themselves sums over D, taken in
# another order than cuBLAS takes the plain version's (full f32, TF32 off)
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


def test_autograd_function_runs_the_three_kernels(dev):
    q, k, v, do = _qkv(dev, 2, 2, 128, 64, seed=1, n=4)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    native.reset_launches()
    out = fa.flash_attention(*leaves, True, 0.125, 0.1, 9)
    grads = torch.autograd.grad(out, leaves, do)
    assert {n: native.launches[n] for n in ("flash_fwd", "flash_dq",
                                            "flash_dkv")} == \
        {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
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
    once; 3 attentions a layer."""
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
                                                "flash_dkv")} == \
            {"flash_fwd": 6, "flash_dq": 3, "flash_dkv": 3}
