"""paddle_tpu_torch's int8 KV residency against paddle_tpu, on the CPU.

The same numpy inputs go through the JAX package's int8 cache writes,
quantized decode read (its Pallas kernel under the Pallas interpreter,
PADDLE_TPU_PALLAS_INTERPRET=1, and its plain reference), tiny_lm programs,
capacity planner and serving engine, and through the port's. The CUDA
kernel itself is checked on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import serve as jserve
from paddle_tpu.models import tiny_lm as jtiny
from paddle_tpu.observe import metrics as jmetrics
from paddle_tpu.ops import paged_attention as jpa

import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import tiny_lm as ttiny
from paddle_tpu_torch.observe import metrics as tmetrics
from paddle_tpu_torch.ops import native
from paddle_tpu_torch.ops import paged_attention as pa

TOL = 1e-5          # f32 summation order
SCALE_TOL = 1e-7    # one f32 division, the same on both sides


@pytest.fixture
def interpret_kernels(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


# ---------------------------------------------------------------------------
# cache writes
# ---------------------------------------------------------------------------

NB, BS, H, DH = 9, 4, 2, 8


def _resident(rng, scale_lo=0.01, scale_hi=0.05):
    cache = rng.randint(-127, 128, size=(NB, BS, H, DH)).astype(np.int8)
    scale = rng.uniform(scale_lo, scale_hi, size=NB).astype(np.float32)
    return cache, scale


def _append_both(cache, scale, new, bt, seq):
    rc, rs, rn = jpa._q8_append_one(*(jnp.asarray(x) for x in
                                      (cache, scale, new, bt, seq)))
    tc, ts = torch.from_numpy(cache.copy()), torch.from_numpy(scale.copy())
    oc, os_, tn = pa._q8_append_one(tc, ts, *(torch.from_numpy(x) for x in
                                              (new, bt, seq)))
    assert oc is tc and os_ is ts          # in place, no copy of the cache
    return (np.asarray(rc), np.asarray(rs), int(rn)), \
        (tc.numpy(), ts.numpy(), int(tn))


# name -> (seq_lens, magnitude of the new token per slot, requants expected)
APPEND_CASES = {
    # position 4 and 8 are offsets 0 of their blocks: scale set fresh
    "first_token_of_a_block": ([5, 9, 1], [1.0, 30.0, 0.001], 0),
    # a later token far above the resident scale * 127: block requantized
    "scale_grows": ([6, 3, 8], [50.0, 90.0, 70.0], 3),
    # a later token inside the resident range: nothing moves but the token
    "scale_holds": ([6, 3, 8], [0.5, 0.2, 0.9], 0),
    # slot 1 inactive: writes the trash block, counts nothing
    "inactive_slot": ([6, 0, 7], [50.0, 90.0, 0.1], 1),
    "all_inactive": ([0, 0, 0], [5.0, 5.0, 5.0], 0),
}


@pytest.mark.parametrize("case", sorted(APPEND_CASES))
def test_q8_append_matches_paddle_tpu(case):
    seq, mags, n_requant = APPEND_CASES[case]
    rng = np.random.RandomState(sorted(APPEND_CASES).index(case))
    cache, scale = _resident(rng)
    bt = np.array([[2, 5, 0], [4, 1, 7], [3, 6, 8]], np.int32)
    seq = np.array(seq, np.int32)
    new = (rng.uniform(-1, 1, size=(3, H, DH))
           * np.array(mags)[:, None, None]).astype(np.float32)
    (rc, rs, rn), (tc, ts, tn) = _append_both(cache, scale, new, bt, seq)
    # the trash block's token row is written by every inactive slot in an
    # unspecified order; every other block is exact
    np.testing.assert_array_equal(tc[1:], rc[1:])
    np.testing.assert_allclose(ts, rs, atol=SCALE_TOL, rtol=0)
    assert tn == rn == n_requant
    for s, n in enumerate(seq):
        if n > 0:                           # the token reads back in range
            blk, off = bt[s, (n - 1) // BS], (n - 1) % BS
            np.testing.assert_allclose(tc[blk, off] * ts[blk], new[s],
                                       atol=ts[blk] / 2 + 1e-7)


def test_q8_append_recycled_block_ignores_its_stale_scale():
    """A block handed out again still carries its last owner's scale; the
    first token written into it sets the scale fresh, however large the
    stale one is."""
    rng = np.random.RandomState(7)
    cache, scale = _resident(rng)
    scale[5] = 1e6                          # stale, from a freed sequence
    bt = np.array([[2, 5, 0]], np.int32)
    seq = np.array([5], np.int32)           # position 4: offset 0 of block 5
    new = rng.uniform(-1, 1, size=(1, H, DH)).astype(np.float32)
    (rc, rs, rn), (tc, ts, tn) = _append_both(cache, scale, new, bt, seq)
    np.testing.assert_array_equal(tc, rc)
    np.testing.assert_allclose(ts, rs, atol=SCALE_TOL, rtol=0)
    assert tn == rn == 0
    assert ts[5] == pytest.approx(np.abs(new).max() / 127.0, rel=1e-6)


def test_q8_append_requantize_rewrites_the_whole_block():
    rng = np.random.RandomState(8)
    cache, scale = _resident(rng)
    bt = np.array([[2, 5, 0]], np.int32)
    seq = np.array([7], np.int32)           # position 6: offset 2 of block 5
    new = np.full((1, H, DH), 100.0, np.float32)
    before = cache[5].astype(np.float32) * scale[5]
    _, (tc, ts, tn) = _append_both(cache, scale, new, bt, seq)
    assert tn == 1 and ts[5] == pytest.approx(100.0 / 127.0)
    keep = [0, 1, 3]                        # the untouched offsets
    np.testing.assert_allclose(tc[5, keep] * ts[5], before[keep],
                               atol=ts[5] / 2 + 1e-6)
    np.testing.assert_array_equal(tc[5, 2], np.full((H, DH), 127, np.int8))
    np.testing.assert_array_equal(tc[[1, 2, 3, 4, 6, 7, 8]],
                                  cache[[1, 2, 3, 4, 6, 7, 8]])


# name -> (T, seq_lens)
PREFILL_CASES = {
    "ragged_prompt": (8, [6, 8]),
    "one_token": (8, [1, 3]),
    "empty_row": (8, [0, 5]),
    "rung_not_a_block_multiple": (6, [6, 2]),
}


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_q8_prefill_write_matches_paddle_tpu(case):
    T, seq = PREFILL_CASES[case]
    rng = np.random.RandomState(20 + sorted(PREFILL_CASES).index(case))
    cache, scale = _resident(rng)
    scale[3] = 1e6                          # a recycled block's stale scale
    bt = np.array([[3, 7, 0], [5, 1, 2]], np.int32)
    seq = np.array(seq, np.int32)
    x = (rng.randn(2, T, H, DH) * rng.uniform(0.1, 10, size=(2, T, 1, 1))
         ).astype(np.float32)
    rc, rs = jpa._q8_prefill_write_one(*(jnp.asarray(a) for a in
                                         (cache, scale, x, bt, seq)))
    tc, ts = torch.from_numpy(cache.copy()), torch.from_numpy(scale.copy())
    oc, os_ = pa._q8_prefill_write_one(tc, ts, *(torch.from_numpy(a) for a in
                                                 (x, bt, seq)))
    assert oc is tc and os_ is ts
    # the trash block takes the padding positions in an unspecified order
    np.testing.assert_array_equal(tc.numpy()[1:], np.asarray(rc)[1:])
    np.testing.assert_allclose(ts.numpy(), np.asarray(rs), atol=SCALE_TOL,
                               rtol=0)
    for r, n in enumerate(seq):             # every valid position reads back
        for t in range(n):
            blk = bt[r, t // BS]
            np.testing.assert_allclose(
                tc.numpy()[blk, t % BS] * ts.numpy()[blk], x[r, t],
                atol=ts.numpy()[blk] / 2 + 1e-7)
    if seq[0] > 0:                          # the stale scale was overwritten
        assert ts.numpy()[3] < 1.0


# ---------------------------------------------------------------------------
# the decode read
# ---------------------------------------------------------------------------

def _random_q8_cache(rng, Dh, S=4, H=2, BS=4, max_b=4):
    """Block tables drawn from a shuffled pool; seq_lens include 0 and the
    full context (max_b * BS)."""
    NB = 1 + S * max_b
    kc = rng.randint(-127, 128, size=(NB, BS, H, Dh)).astype(np.int8)
    vc = rng.randint(-127, 128, size=(NB, BS, H, Dh)).astype(np.int8)
    ks = rng.uniform(0.002, 0.02, size=NB).astype(np.float32)
    vs = rng.uniform(0.002, 0.02, size=NB).astype(np.float32)
    bt = rng.permutation(np.arange(1, NB)).astype(np.int32).reshape(S, max_b)
    seq = np.array([0, max_b * BS, 5, 1], np.int32)[:S]
    q = rng.randn(S, H, Dh).astype(np.float32)
    return q, kc, vc, ks, vs, bt, seq


@pytest.mark.parametrize("Dh", [32, 64])
def test_q8_plain_matches_pallas_kernel(interpret_kernels, Dh):
    rng = np.random.RandomState(Dh)
    args = _random_q8_cache(rng, Dh)
    sm = 1.0 / np.sqrt(Dh)
    ref = np.asarray(jpa._paged_attention_q8_pallas(
        *(jnp.asarray(x) for x in args), sm))
    native.reset_launches()
    out = pa.paged_attention_q8(*(torch.from_numpy(x) for x in args), sm)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    assert np.array_equal(out.numpy()[0], np.zeros_like(ref[0]))
    assert not any(native.launches.values())


@pytest.mark.parametrize("Dh", [32, 64])
def test_q8_plain_matches_paddle_tpu_reference(Dh):
    rng = np.random.RandomState(100 + Dh)
    args = _random_q8_cache(rng, Dh)
    sm = 1.0 / np.sqrt(Dh)
    ref = np.asarray(jpa.paged_attention_q8_reference(
        *(jnp.asarray(x) for x in args), sm))
    out = pa.paged_attention_q8_reference(*(torch.from_numpy(x)
                                            for x in args), sm)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    assert np.array_equal(out.numpy()[0], np.zeros_like(ref[0]))


def test_q8_plain_never_reads_dead_blocks_or_their_scales():
    """Table entries past ceil(seq_len / BS) may point anywhere and their
    scales may hold anything, NaN included."""
    rng = np.random.RandomState(9)
    q, kc, vc, ks, vs, bt, seq = _random_q8_cache(rng, 32)
    clean = pa.paged_attention_q8_reference(
        *(torch.from_numpy(x) for x in (q, kc, vc, ks, vs, bt, seq)), 0.2)
    bt2, ks2, vs2 = bt.copy(), ks.copy(), vs.copy()
    bt2[2, 2:] = 0                          # seq_len 5: entries 2.. are dead
    bt2[3, 1:] = 0
    bt2[0, :] = 0
    live = set(bt2[1]) | set(bt2[2, :2]) | set(bt2[3, :1])
    for b in range(len(ks)):
        if b not in live:
            ks2[b] = vs2[b] = np.nan
    got = pa.paged_attention_q8_reference(
        *(torch.from_numpy(x) for x in (q, kc, vc, ks2, vs2, bt2, seq)), 0.2)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, clean, atol=1e-6, rtol=0)


def test_q8_wrapper_paths_without_a_card():
    meta = dict(device="meta")
    q = torch.empty(4, 2, 32, **meta)
    c = torch.empty(9, 4, 2, 32, dtype=torch.int8, **meta)
    sc = torch.empty(9, **meta)
    out = pa.paged_attention_q8(q, c, c, sc, sc,
                                torch.empty(4, 2, dtype=torch.int32, **meta),
                                torch.empty(4, dtype=torch.int32, **meta))
    assert out.device.type == "meta" and out.shape == q.shape
    n = native.MAX_GRID_Y + 1
    q = torch.empty(n, 1, 32)
    c = torch.empty(2, 4, 1, 32, dtype=torch.int8)
    with pytest.raises(ValueError, match="y limit"):
        pa._paged_attention_q8_cuda(
            q, c, c, torch.ones(2), torch.ones(2),
            torch.zeros(n, 1, dtype=torch.int32),
            torch.zeros(n, dtype=torch.int32), 1.0)
    with pytest.raises(ValueError, match="head dim"):
        pa._paged_attention_q8_cuda(
            torch.empty(1, 1, 24), c, c, torch.ones(2), torch.ones(2),
            torch.zeros(1, 1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), 1.0)
    assert not any(native.launches.values())


# ---------------------------------------------------------------------------
# the model and the capacity planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["prefill", "decode", "startup",
                                   "signature"])
def test_int8_tiny_lm_builds_identically(which):
    kw = dict(kv_dtype="int8", prefill_seq_rungs=(8, 16), max_context=32)
    ref, got = jtiny.build_tiny_lm(**kw), ttiny.build_tiny_lm(**kw)
    if which == "signature":
        assert got[4] == ref[4]
        assert got[4]["kv_dtype"] == "int8"
        assert sorted(got[4]["scale_vars"]) == sorted(got[4]["cache_vars"])
        assert all(v.endswith(ptt.core.ir.KV_CACHE_SUFFIX)
                   for v in got[4]["scale_vars"].values())
        return
    idx = {"prefill": 0, "decode": 1, "startup": 2}[which]
    assert got[idx].to_dict() == ref[idx].to_dict()
    if which != "startup":
        types = [op.type for op in got[idx].global_block().ops]
        assert f"{'prefill' if which == 'prefill' else 'paged'}" \
               f"_attention_q8" in types


def test_signature_refuses_an_unknown_kv_dtype():
    with pytest.raises(ValueError, match="kv_dtype"):
        ttiny.default_signature(kv_dtype="fp8")


RESIDENCY_SIGS = {
    "tiny_fp32": dict(),
    "tiny_int8": dict(kv_dtype="int8"),
    "wide_fp32": dict(d_model=512, n_heads=8, n_layers=6, block_size=16,
                      max_context=1024),
    "wide_int8": dict(d_model=512, n_heads=8, n_layers=6, block_size=16,
                      max_context=1024, kv_dtype="int8"),
    "one_layer_int8": dict(d_model=64, n_heads=1, n_layers=1, block_size=8,
                           kv_dtype="int8"),
}


@pytest.mark.parametrize("name", sorted(RESIDENCY_SIGS))
def test_block_residency_matches_paddle_tpu(name):
    ref = jtiny.default_signature(**RESIDENCY_SIGS[name])
    sig = ttiny.default_signature(**RESIDENCY_SIGS[name])
    assert ptt.serve.block_residency_nbytes(sig) == \
        jserve.block_residency_nbytes(ref)
    for budget in (0, 1000, 64 * 1024, 201_719_808):
        assert ptt.serve.blocks_for_budget(sig, budget) == \
            jserve.blocks_for_budget(ref, budget)


def test_block_residency_at_the_tiny_and_wide_geometry():
    per_var = [ptt.serve.block_residency_nbytes(
        ttiny.default_signature(**RESIDENCY_SIGS[n])) // (2 * layers)
        for n, layers in (("tiny_fp32", 2), ("tiny_int8", 2),
                          ("wide_fp32", 6), ("wide_int8", 6))]
    assert per_var == [256, 68, 32768, 8196]
    # a cache sized from the wide fp32 model's 513 blocks seats 32 full
    # contexts (64 blocks each) in int8
    fp = ttiny.default_signature(**RESIDENCY_SIGS["wide_fp32"])
    q8 = ttiny.default_signature(**RESIDENCY_SIGS["wide_int8"])
    budget = 513 * ptt.serve.block_residency_nbytes(fp)
    assert ptt.serve.blocks_for_budget(q8, budget) == 2049


# ---------------------------------------------------------------------------
# serving an int8 dir
# ---------------------------------------------------------------------------

SIG_KW = dict(max_slots=4, block_size=4, max_context=32,
              prefill_rows=(1, 2), prefill_seq_rungs=(8, 16))
PROMPTS = [[3, 1, 4, 1, 5], [2, 7, 1], [9, 9, 8, 2, 6, 5, 3],
           [1], [5, 5, 5, 5], [8, 6, 7, 5, 3, 0, 9]]


def _requants(metrics, model):
    return metrics.counter(
        "serve_kv_requant_events_total",
        "int8 KV whole-block requantize events, per model").value(model=model)


def _device_counter(ver):
    """The [1] int32 scope var the decode steps count requantizes in (None
    for an fp32 dir)."""
    rq = ver.decode.signature.get("requant_var")
    return None if rq is None else int(np.asarray(ver.scope.find_var(rq))[0])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """An int8 dir and its fp32 twin saved by paddle_tpu; the int8 dir
    served by both packages' `InferenceServer(CPUPlace())`, the fp32 dir by
    the port."""
    root = tmp_path_factory.mktemp("kv8")
    q8_dir, fp_dir = str(root / "q8"), str(root / "fp")
    jtiny.save_tiny_lm(q8_dir, kv_dtype="int8", **SIG_KW)
    jtiny.save_tiny_lm(fp_dir, **SIG_KW)
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    try:
        for name, srv, mdir, metrics in (
                ("jax_q8", jserve.InferenceServer(fluid.CPUPlace()), q8_dir,
                 jmetrics),
                ("torch_q8", ptt.serve.InferenceServer(ptt.CPUPlace()),
                 q8_dir, tmetrics),
                ("torch_fp", ptt.serve.InferenceServer(ptt.CPUPlace()),
                 fp_dir, tmetrics)):
            try:
                ver = srv.add_model(name, mdir)
                res = [srv.generate(name, p, max_new_tokens=12)
                       for p in PROMPTS]
                out[name] = {
                    "tokens": [r.tokens for r in res],
                    "reasons": [r.finish_reason for r in res],
                    "requants": _requants(metrics, name),
                    "counter": _device_counter(ver),
                    "stats": srv.stats()["models"][name],
                    "cache_dtype": str(np.asarray(ver.scope.find_var(
                        ver.decode.signature["cache_vars"][0]).cpu()
                        if name.startswith("torch") else ver.scope.find_var(
                        ver.decode.signature["cache_vars"][0])).dtype),
                }
            finally:
                srv.close()
    finally:
        mp.undo()
    return out


def test_int8_dir_tokens_equal_paddle_tpu(served):
    assert [len(t) for t in served["torch_q8"]["tokens"]] == [12] * 6
    assert served["torch_q8"]["tokens"] == served["jax_q8"]["tokens"]
    assert served["torch_q8"]["reasons"] == served["jax_q8"]["reasons"]


def test_int8_tokens_equal_fp32_tokens_at_this_size(served):
    assert served["torch_q8"]["tokens"] == served["torch_fp"]["tokens"]


def test_requant_count_equals_paddle_tpu(served):
    """Sequential generations: the decode steps of both packages count the
    same requantize events. Each engine releases its version whenever it
    goes idle and, binding again, publishes the whole device counter again,
    so the metric reaches the counter and runs ahead of it by what each
    idle spell re-publishes; whether an engine goes idle between two
    sequential generations depends on thread timing, so the metrics are
    compared across a forced idle spell in tests/test_torch_oneshot.py and
    without one in the concurrent test below."""
    assert served["torch_q8"]["counter"] == served["jax_q8"]["counter"] > 0
    assert served["torch_q8"]["requants"] >= served["torch_q8"]["counter"]
    assert served["jax_q8"]["requants"] >= served["jax_q8"]["counter"]
    assert served["torch_q8"]["stats"]["kv_requant_events"] == \
        served["torch_q8"]["requants"]
    assert served["torch_fp"]["requants"] == 0
    assert served["torch_fp"]["counter"] is None


def test_requant_metric_equals_paddle_tpu(tmp_path, interpret_kernels):
    """All requests in flight at once, so neither engine goes idle between
    them: ``serve_kv_requant_events_total`` is the same in both."""
    mdir = str(tmp_path / "q8")
    jtiny.save_tiny_lm(mdir, kv_dtype="int8", **SIG_KW)
    seen = {}
    for name, srv, metrics in (
            ("jax_q8_burst", jserve.InferenceServer(fluid.CPUPlace()),
             jmetrics),
            ("torch_q8_burst", ptt.serve.InferenceServer(ptt.CPUPlace()),
             tmetrics)):
        try:
            ver = srv.add_model(name, mdir)
            futs = [srv.submit_generate(name, p, max_new_tokens=12)
                    for p in PROMPTS]
            tokens = [f.result(timeout=300).tokens for f in futs]
            seen[name] = (tokens, _requants(metrics, name),
                          _device_counter(ver))
        finally:
            srv.close()
    ref, got = seen["jax_q8_burst"], seen["torch_q8_burst"]
    assert got[0] == ref[0]
    assert got[1] == ref[1] == got[2] == ref[2] > 0


def test_int8_cache_is_resident_as_int8(served):
    assert served["torch_q8"]["cache_dtype"] == "int8"
    assert served["torch_fp"]["cache_dtype"] == "float32"
    for key in ("tokens", "steps", "kv"):
        assert served["torch_q8"]["stats"][key] == \
            served["jax_q8"]["stats"][key], key


def test_port_saved_int8_dir_serves_in_paddle_tpu(tmp_path, interpret_kernels):
    """The other direction: a dir saved by the port loads in the JAX
    package (the scale vars keep the @KV_CACHE suffix and are never
    saved), with the same greedy tokens."""
    mdir = str(tmp_path / "q8")
    sig = ttiny.save_tiny_lm(mdir, kv_dtype="int8", **SIG_KW)
    saved = {f[:-4] for f in __import__("os").listdir(mdir)
             if f.endswith(".npy")}
    assert not saved & (set(sig["cache_vars"])
                        | set(sig["scale_vars"].values())
                        | {sig["requant_var"]})
    tokens = {}
    for name, srv in (("jax", jserve.InferenceServer(fluid.CPUPlace())),
                      ("torch", ptt.serve.InferenceServer(ptt.CPUPlace()))):
        try:
            srv.add_model("q8", mdir)
            tokens[name] = [srv.generate("q8", p, max_new_tokens=6).tokens
                            for p in PROMPTS[:3]]
        finally:
            srv.close()
    assert tokens["torch"] == tokens["jax"]


def test_int8_state_from_numpy_keeps_dtypes():
    arrays = {"c": np.arange(-4, 4, dtype=np.int8).reshape(2, 4),
              "s": np.ones(2, np.float32), "n": np.zeros(1, np.int32)}
    scope = ptt.io.state_from_numpy(arrays, ptt.CPUPlace())
    assert [scope.find_var(n).dtype for n in ("c", "s", "n")] == \
        [torch.int8, torch.float32, torch.int32]


def test_int8_continuous_batching_equals_solo_runs(tmp_path):
    """Concurrent requests over the int8 cache (slots recycled, blocks
    with stale scales handed out again) generate what each generates
    alone."""
    mdir = str(tmp_path / "q8")
    ttiny.save_tiny_lm(mdir, kv_dtype="int8", **dict(SIG_KW, max_slots=2))
    with ptt.serve.InferenceServer(ptt.CPUPlace()) as srv:
        srv.add_model("q8", mdir)
        solo = [srv.generate("q8", p, max_new_tokens=10).tokens
                for p in PROMPTS]
        futs = [srv.submit_generate("q8", p, max_new_tokens=10)
                for p in PROMPTS]
        together = [f.result(timeout=120).tokens for f in futs]
    assert together == solo
