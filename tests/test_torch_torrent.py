"""Disaggregated serving in the port (``paddle_tpu_torch/torrent`` and the
engine's prefill-only and injected paths), on the CPU.

Every non-slow case of ``tests/test_torrent.py`` runs here against the
port with the same assertions and the same tiny sizes (``SIG_KW``):
session affinity, the KV wire stream (round trip in both residencies,
resume from the acked watermark, nonce supersede, give-up), the int8
residency's parity and capacity, and the in-process 1 prefill + 2 decode
fleet that reproduces the solo server's tokens in one stitched trace.

Then the two packages against each other: `build_records` of both from
one KV payload gives the same commands, equal arrays and equal codec
bytes; the engines' extracted payloads are equal; and a disaggregated
generation whose prefill runs in one package and whose decode runs in
the other reproduces both packages' solo tokens on one JAX-saved int8
dir, both ways round.

The multi-process decode-kill drill is ``tools/torch_chaos_drill.py
--scenario decode_kill`` (``tests/test_torch_fleet_tools.py``).
"""

from __future__ import annotations

import os
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu import fleet as jfleet
from paddle_tpu import serve as jserve
from paddle_tpu.models import tiny_lm as jtiny_lm
from paddle_tpu.torrent import build_records as jbuild_records
from paddle_tpu_torch import fleet, observe, serve
from paddle_tpu_torch.models import tiny_lm
from paddle_tpu_torch.observe import xray
from paddle_tpu_torch.serve.errors import (BadRequestError, KVTransferError,
                                           ModelUnavailableError)
from paddle_tpu_torch.torrent import (KVStreamReceiver, KVStreamSender,
                                      build_records)
from paddle_tpu_torch.wire import codec as tcodec

SIG_KW = dict(max_slots=4, block_size=4, max_context=32,
              prefill_rows=(1, 2), prefill_seq_rungs=(8, 16))

PROMPTS = [[3, 1, 4, 1, 5], [2, 7, 1], [9, 9, 8, 2, 6, 5, 3],
           [1], [5, 5, 5, 5], [8, 6, 7, 5, 3, 0, 9]]


@pytest.fixture(autouse=True)
def _fresh_port_telemetry():
    """The repo conftest resets the JAX package's telemetry; this resets
    the port's (the metrics and traces these cases read)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = fluid.get_flag("observe")
    observe.reset_all()
    yield
    torch.set_num_threads(n)
    fluid.set_flag("observe", prev)
    observe.reset_all()


@pytest.fixture(scope="module")
def lm_fp_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tlm_fp") / "model")
    tiny_lm.save_tiny_lm(d, **SIG_KW)
    return d


@pytest.fixture(scope="module")
def lm_q8_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tlm_q8") / "model")
    tiny_lm.save_tiny_lm(d, kv_dtype="int8", **SIG_KW)
    return d


@pytest.fixture(scope="module")
def jax_q8_dir(tmp_path_factory):
    """One int8 dir, saved by the JAX package: both packages serve it."""
    d = str(tmp_path_factory.mktemp("jlm_q8") / "model")
    jtiny_lm.save_tiny_lm(d, kv_dtype="int8", **SIG_KW)
    return d


@pytest.fixture
def router():
    r = fleet.FleetRouter(fleet.RouterConfig(
        lease_s=1.0, poll_interval_s=0.15)).start()
    yield r
    r.close()


def _member(router, rid, role="both", depth=0, inflight=0):
    """Manufacture a ready member (no socket): the pick/affinity logic
    under test is pure router state."""
    router._register(rid, f"127.0.0.1:{9000 + len(router._members)}",
                     None, session=None, lease_s=30.0, role=role)
    m = router._members[rid]
    m.ready = True
    m.models = {"m": {"depth": depth, "warmed": True,
                      "version_key": "k"}}
    m.inflight = inflight
    return m


# ---------------------------------------------------------------------------
# session affinity: pin lifecycle + role-filtered picking
# ---------------------------------------------------------------------------

class TestAffinity:
    def test_pin_release_lifecycle_and_gauge(self, router):
        _member(router, "d0", role="decode")
        _member(router, "d1", role="decode")
        reg = observe.metrics.default_registry()
        m = router.pin_session("s1", "m")
        assert m.replica_id in ("d0", "d1")
        assert router.session_replica("s1") == m.replica_id
        assert reg.get("fleet_affinity_sessions").value() == 1.0
        assert router.release_session("s1", "eos") is True
        assert router.session_replica("s1") is None
        assert reg.get("fleet_affinity_sessions").value() == 0.0
        assert reg.get("fleet_affinity_released_total").value(
            model="m", reason="eos") == 1
        # idempotent: a second release is a no-op, not a double count
        assert router.release_session("s1", "eos") is False
        assert reg.get("fleet_affinity_released_total").value(
            model="m", reason="eos") == 1

    def test_pin_only_lands_on_decode_pool(self, router):
        _member(router, "p0", role="prefill")
        _member(router, "b0", role="both")
        m = router.pin_session("s1", "m")
        assert m.replica_id == "b0"    # "both" qualifies, prefill never
        router.release_session("s1", "cancel")
        # with ONLY prefill members there is nothing to pin
        router._members.pop("b0").close()
        with pytest.raises(ModelUnavailableError):
            router.pin_session("s2", "m")

    def test_pin_excludes_bad_decodes(self, router):
        _member(router, "d0", role="decode")
        _member(router, "d1", role="decode")
        m = router.pin_session("s1", "m", exclude=frozenset({"d0"}))
        assert m.replica_id == "d1"
        router.release_session("s1", "cancel")

    def test_replica_death_releases_its_pins(self, router):
        _member(router, "d0", role="decode")
        _member(router, "d1", role="decode")
        pins = {sid: router.pin_session(sid, "m").replica_id
                for sid in ("s1", "s2", "s3")}
        victim = pins["s1"]
        router.remove_replica(victim)
        reg = observe.metrics.default_registry()
        for sid, rid in pins.items():
            if rid == victim:
                assert router.session_replica(sid) is None
            else:
                assert router.session_replica(sid) == rid
        dead = sum(1 for rid in pins.values() if rid == victim)
        assert reg.get("fleet_affinity_released_total").value(
            model="m", reason="death") == dead

    def test_prefill_pool_stays_least_loaded(self, router):
        _member(router, "p0", role="prefill", depth=5)
        _member(router, "p1", role="prefill")
        _member(router, "p2", role="both")
        _member(router, "d0", role="decode")
        picks = {router._pick("m", set(), role="prefill").replica_id
                 for _ in range(8)}
        # least-loaded tie between p1/p2; deep p0 and decode-only d0
        # never take prefill traffic
        assert picks == {"p1", "p2"}
        assert router._pick("m", {"p1", "p2"},
                            role="prefill").replica_id == "p0"

    def test_role_rides_membership_doc(self, router):
        _member(router, "p0", role="prefill")
        assert router.members()["p0"]["role"] == "prefill"


# ---------------------------------------------------------------------------
# KV wire stream: round-trip, resume, supersede
# ---------------------------------------------------------------------------

def _fake_kv(kv_dtype="fp32", n_blocks=3, seed=0):
    """A payload in serve/decode.py _extract_kv's shape (rows of
    [block_size, heads, head_dim] per cache var)."""
    r = np.random.RandomState(seed)
    shape = (n_blocks, 4, 2, 8)
    kv = {"prompt_len": 9, "n_blocks": n_blocks, "kv_dtype": kv_dtype}
    if kv_dtype == "int8":
        kv["cache"] = {c: r.randint(-127, 128, shape).astype(np.int8)
                       for c in ("cache_k", "cache_v")}
        kv["scales"] = {c: (r.rand(n_blocks) + 0.01).astype(np.float32)
                        for c in ("cache_k", "cache_v")}
    else:
        kv["cache"] = {c: r.randn(*shape).astype(np.float32)
                       for c in ("cache_k", "cache_v")}
    return kv


def _recorder_admit(admitted):
    def admit(model, prompt, first_token, kv, max_new, trace):
        fut = Future()
        fut.set_result({"model": model, "prompt": prompt,
                        "first_token": first_token, "kv": kv,
                        "max_new": max_new, "trace": trace})
        admitted.append(fut.result())
        return fut
    return admit


class _FlakySend:
    """send() that raises a transport error on chosen call numbers."""

    def __init__(self, recv, fail_at=()):
        self.recv = recv
        self.fail_at = set(fail_at)
        self.calls = 0

    def __call__(self, records):
        self.calls += 1
        if self.calls in self.fail_at:
            raise ConnectionResetError("torn mid-batch")
        return int(self.recv.handle(records)["acked"])


class TestKVStream:
    @pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
    def test_round_trip_both_residencies(self, kv_dtype):
        kv = _fake_kv(kv_dtype)
        admitted = []
        recv = KVStreamReceiver(_recorder_admit(admitted))
        sender = KVStreamSender("m", "s1", [1, 2, 3], 7, 10, kv)
        sender.pump(lambda recs: int(recv.handle(recs)["acked"]),
                    max_records=4)
        assert sender.done and sender.bytes_sent > 0
        (got,) = admitted
        assert got["first_token"] == 7 and got["max_new"] == 10
        out = got["kv"]
        assert out["kv_dtype"] == kv_dtype
        assert out["n_blocks"] == kv["n_blocks"]
        for c, want in kv["cache"].items():
            if kv_dtype == "int8":
                # int8 residency ships raw values + scales VERBATIM
                np.testing.assert_array_equal(out["cache"][c], want)
                np.testing.assert_array_equal(out["scales"][c],
                                              kv["scales"][c])
            else:
                # fp32 rides the lossy int8 wire codec: bounded error
                tol = float(np.abs(want).max()) / 100.0
                np.testing.assert_allclose(out["cache"][c], want,
                                           atol=tol)
        assert recv.future("s1").done()
        recv.release("s1")
        with pytest.raises(KVTransferError):
            recv.future("s1")
        assert recv.stats() == {"staging": 0, "futures": 0}

    def test_torn_transfer_resumes_from_acked_watermark(self):
        admitted = []
        recv = KVStreamReceiver(_recorder_admit(admitted))
        sender = KVStreamSender("m", "s1", [1, 2], 7, 10, _fake_kv())
        send = _FlakySend(recv, fail_at=(2, 4))
        sender.pump(send, max_records=2)
        assert sender.done and sender.resumes == 2
        assert len(admitted) == 1       # dedup: applied exactly once
        reg = observe.metrics.default_registry()
        assert reg.get("torrent_kv_stream_resumes_total").value(
            model="m") >= 2

    def test_sender_gives_up_with_kv_transfer_error(self):
        def dead_send(records):
            raise ConnectionResetError("receiver gone")

        sender = KVStreamSender("m", "s1", [1], 7, 10, _fake_kv())
        with pytest.raises(KVTransferError):
            sender.pump(dead_send, max_retries=2)
        assert not sender.done

    def test_supersede_same_seq_new_nonce_wins(self):
        admitted = []
        recv = KVStreamReceiver(_recorder_admit(admitted))
        s1 = KVStreamSender("m", "s1", [1, 2], 7, 10, _fake_kv(seed=1))
        s1.pump(lambda r: int(recv.handle(r)["acked"]))
        # re-prefill of the SAME sequence (decode failover): fresh
        # nonce supersedes the committed staging
        s2 = KVStreamSender("m", "s1", [1, 2], 7, 10, _fake_kv(seed=2))
        s2.pump(lambda r: int(recv.handle(r)["acked"]))
        assert len(admitted) == 2
        assert recv.stats()["futures"] == 1
        # stale-nonce records now have no staging: the old prefill's
        # retry gets the re-prefill cue, not silent corruption
        cmd, payload = build_records("m", "s1", s1.nonce, [1, 2], 7, 10,
                                     _fake_kv(seed=1))[1]
        with pytest.raises(KVTransferError):
            recv.handle([(2, cmd, payload)])


# ---------------------------------------------------------------------------
# int8 KV residency: parity + capacity
# ---------------------------------------------------------------------------

class TestInt8Residency:
    def test_int8_kv_matches_fp32_token_for_token(self, lm_fp_dir,
                                                  lm_q8_dir):
        sfp = serve.InferenceServer(fluid.CPUPlace(), serve.ServeConfig())
        sq8 = serve.InferenceServer(fluid.CPUPlace(), serve.ServeConfig())
        sfp.add_model("m", lm_fp_dir)
        sq8.add_model("m", lm_q8_dir)
        try:
            for p in PROMPTS:
                a = sfp.generate("m", p, max_new_tokens=12)
                b = sq8.generate("m", p, max_new_tokens=12)
                assert a.tokens == b.tokens, p
                assert a.finish_reason == b.finish_reason
        finally:
            sfp.close()
            sq8.close()

    def test_int8_admits_3x_sequences_at_fixed_budget(self):
        fp = tiny_lm.default_signature(**SIG_KW)
        q8 = tiny_lm.default_signature(kv_dtype="int8", **SIG_KW)
        # 4 cache vars (2 layers x k,v): fp32 pays 256 B/block per var,
        # int8 pays 64 int8 values + one f32 block scale = 68 B
        assert serve.block_residency_nbytes(fp) == 4 * 256
        assert serve.block_residency_nbytes(q8) == 4 * 68
        budget = 64 * 1024
        per_seq = fp["max_context"] // fp["block_size"]
        fp_seqs = serve.blocks_for_budget(fp, budget) // per_seq
        q8_seqs = serve.blocks_for_budget(q8, budget) // per_seq
        assert fp_seqs > 0
        assert q8_seqs >= 3 * fp_seqs, (q8_seqs, fp_seqs)


# ---------------------------------------------------------------------------
# the engine's halves: prefill-only, injected, validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_prefill_then_inject_reproduces_the_solo_generation(
        kv, lm_fp_dir, lm_q8_dir):
    """The two halves on two servers give the solo server's tokens; the
    payload is host numpy (int8 rows stay int8, scales float32), and the
    decode side runs no prefill step."""
    mdir = lm_q8_dir if kv == "int8" else lm_fp_dir
    pre = serve.InferenceServer(fluid.CPUPlace())
    dec = serve.InferenceServer(fluid.CPUPlace())
    pre.add_model("m", mdir)
    dec.add_model("d", mdir)
    try:
        for p in PROMPTS:
            want = pre.generate("m", p, max_new_tokens=9).tokens
            r = pre.submit_prefill("m", p).result(timeout=60)
            assert r.finish_reason == "prefill" and r.tokens == want[:1]
            payload = r.kv
            assert payload["kv_dtype"] == kv
            assert payload["n_blocks"] == -(-len(p) // SIG_KW["block_size"])
            for rows in payload["cache"].values():
                assert isinstance(rows, np.ndarray)
                assert rows.dtype == (np.int8 if kv == "int8"
                                      else np.float32)
            for s in (payload.get("scales") or {}).values():
                assert isinstance(s, np.ndarray) and s.dtype == np.float32
            prefills = dec.stats()["models"]["d"]["prefill_steps"]
            got = dec.submit_prefilled("d", p, r.tokens[0], payload,
                                       max_new_tokens=9).result(timeout=60)
            assert got.tokens == want, p
            assert dec.stats()["models"]["d"]["prefill_steps"] == prefills
        # every block the halves took came back
        for srv, name in ((pre, "m"), (dec, "d")):
            assert srv.stats()["models"][name]["kv"]["blocks_in_use"] == 0
    finally:
        pre.close()
        dec.close()


def test_submit_prefilled_validates_like_the_jax_engine(lm_fp_dir,
                                                        lm_q8_dir):
    srv = serve.InferenceServer(fluid.CPUPlace())
    srv.add_model("q8", lm_q8_dir)
    srv.add_model("fp", lm_fp_dir)
    try:
        kv8 = srv.submit_prefill("q8", [1, 2, 3, 4, 5]).result().kv
        kvf = srv.submit_prefill("fp", [1, 2, 3, 4, 5]).result().kv
        # residency mismatch is refused: nothing requantizes on admit
        with pytest.raises(BadRequestError, match="residency"):
            srv.submit_prefilled("fp", [1, 2, 3, 4, 5], 1, kv8)
        with pytest.raises(BadRequestError, match="residency"):
            srv.submit_prefilled("q8", [1, 2, 3, 4, 5], 1, kvf)
        with pytest.raises(BadRequestError, match="first_token"):
            srv.submit_prefilled("fp", [1, 2], 99, kvf)
        with pytest.raises(BadRequestError, match="missing block rows"):
            short = dict(kvf, cache={c: r[:1] for c, r in
                                     kvf["cache"].items()})
            srv.submit_prefilled("fp", [1] * 9, 1, short)
        with pytest.raises(BadRequestError, match="scales"):
            srv.submit_prefilled("q8", [1, 2, 3, 4, 5], 1,
                                 {k: v for k, v in kv8.items()
                                  if k != "scales"})
        with pytest.raises(BadRequestError, match="'cache' mapping"):
            srv.submit_prefilled("fp", [1], 1, {"kv_dtype": "fp32"})
        with pytest.raises(BadRequestError, match="streaming"):
            srv._engine("fp").submit([1, 2], prefill_only=True,
                                     stream=True)
    finally:
        srv.close()


def test_extracted_payloads_equal_across_packages(jax_q8_dir):
    """The two engines' prefill-only payloads on one dir: the int8
    values of the prompt's positions bit for bit, the block scales to
    float32 summation order (they differ by an ulp at most here), the
    first tokens equal."""
    js = jserve.InferenceServer(jfluid.CPUPlace(), jserve.ServeConfig())
    ts = serve.InferenceServer(fluid.CPUPlace(), serve.ServeConfig())
    js.add_model("m", jax_q8_dir)
    ts.add_model("m", jax_q8_dir)
    try:
        for p in PROMPTS:
            a = js.submit_prefill("m", p).result(timeout=120)
            b = ts.submit_prefill("m", p).result(timeout=120)
            assert a.tokens == b.tokens
            assert a.kv["n_blocks"] == b.kv["n_blocks"]
            assert a.kv["kv_dtype"] == b.kv["kv_dtype"] == "int8"
            for c in a.kv["cache"]:
                ja, tb = np.asarray(a.kv["cache"][c]), b.kv["cache"][c]
                assert ja.dtype == tb.dtype == np.int8
                # only the prompt's positions are defined
                n = len(p)
                bs = SIG_KW["block_size"]
                flat_a = ja.reshape((-1,) + ja.shape[2:])[:n]
                flat_b = tb.reshape((-1,) + tb.shape[2:])[:n]
                np.testing.assert_array_equal(flat_a, flat_b)
                np.testing.assert_allclose(
                    np.asarray(a.kv["scales"][c]), b.kv["scales"][c],
                    rtol=1e-5, atol=0)
                assert ja.shape == tb.shape == (
                    -(-n // bs), bs) + ja.shape[2:]
    finally:
        js.close()
        ts.close()


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_build_records_equal_across_packages(kv_dtype):
    """One KV payload through both packages' `build_records`: the same
    commands in the same order, equal arrays, equal codec bytes."""
    kv = _fake_kv(kv_dtype, n_blocks=4, seed=3)
    trace = {"trace_id": "t", "span_id": "s"}
    a = jbuild_records("m", "s1", "n0", [1, 2, 3], 7, 10, kv, trace=trace)
    b = build_records("m", "s1", "n0", [1, 2, 3], 7, 10, kv, trace=trace)
    assert [c for c, _ in a] == [c for c, _ in b]
    assert len(b) == 1 + 2 * 4 + 1

    def same(x, y):
        if isinstance(x, dict):
            assert isinstance(y, dict) and set(x) == set(y)
            for k in x:
                same(x[k], y[k])
        elif isinstance(x, (np.ndarray, np.generic)):
            y = np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()
        elif isinstance(x, (list, tuple)):
            assert len(x) == len(y)
            for u, v in zip(x, y):
                same(u, v)
        else:
            assert x == y, (x, y)

    for (_, pa), (_, pb) in zip(a, b):
        same(pa, pb)
    if kv_dtype == "fp32":
        # the lossy int8 codec decodes to the same floats in both
        from paddle_tpu.wire import codec as jcodec
        for (ca, pa), (_, pb) in zip(a, b):
            if ca == "kv_block":
                np.testing.assert_array_equal(
                    jcodec.maybe_decode(pa["data"]),
                    tcodec.maybe_decode(pb["data"]))


# ---------------------------------------------------------------------------
# end-to-end: disaggregated fleet reproduces solo tokens, one trace
# ---------------------------------------------------------------------------

def _mk_lm_replica(mdir, router, rid, role, pkg="torch"):
    if pkg == "jax":
        srv = jserve.InferenceServer(jfluid.CPUPlace(), jserve.ServeConfig())
        srv.add_model("m", mdir)
        return jfleet.ReplicaServer(
            srv, replica_id=rid, router_endpoint=router.control_endpoint,
            lease_s=1.0, role=role).start()
    srv = serve.InferenceServer(fluid.CPUPlace(), serve.ServeConfig())
    srv.add_model("m", mdir)
    return fleet.ReplicaServer(srv, replica_id=rid,
                               router_endpoint=router.control_endpoint,
                               lease_s=1.0, role=role).start()


def _wait_ready(router, n, timeout=30):
    deadline = time.time() + timeout
    while len(router.ready_members("m")) < n:
        assert time.time() < deadline, \
            f"fleet never reached {n} ready: {router.members()}"
        time.sleep(0.05)


class TestDisaggregatedE2E:
    def test_tokens_match_solo_and_pins_drain(self, lm_q8_dir, router):
        solo = serve.InferenceServer(fluid.CPUPlace(), serve.ServeConfig())
        solo.add_model("m", lm_q8_dir)
        ref = [solo.generate("m", p, max_new_tokens=10).tokens
               for p in PROMPTS]
        solo.close()

        reps = [_mk_lm_replica(lm_q8_dir, router, rid, role)
                for rid, role in (("p0", "prefill"), ("d0", "decode"),
                                  ("d1", "decode"))]
        try:
            _wait_ready(router, 3)
            reg = observe.metrics.default_registry()
            got = []
            for p in PROMPTS:
                r = router.generate_torrent("m", p, max_new_tokens=10)
                got.append(r.tokens)
                # the decode half served it; the prefill summary rides
                # along (bytes shipped, stream nonce)
                assert r.replica_id in ("d0", "d1")
                assert r.outs["prefill"]["bytes"] > 0
                assert r.outs["finish_reason"] in ("eos", "length")
            assert got == ref
            assert reg.get("torrent_kv_transfer_bytes_total").total() > 0
            assert reg.get("torrent_generations_total").value(
                model="m", outcome="ok") == len(PROMPTS)
            # every pin released (EOS/length), none leaked
            assert reg.get("fleet_affinity_sessions").value() == 0.0
            assert reg.get("fleet_affinity_released_total").total() \
                >= len(PROMPTS)
        finally:
            for rep in reps:
                rep.close()

    def test_cancel_releases_pin_and_receiver_staging(self, lm_q8_dir,
                                                      router):
        reps = [_mk_lm_replica(lm_q8_dir, router, rid, role)
                for rid, role in (("p0", "prefill"), ("d0", "decode"))]
        try:
            _wait_ready(router, 2)
            m = router.pin_session("cx", "m")
            assert m.replica_id == "d0"
            assert router.cancel_torrent("cx") is True
            assert router.session_replica("cx") is None
            assert router.cancel_torrent("cx") is False
        finally:
            for rep in reps:
                rep.close()

    def test_generation_is_one_stitched_trace(self, lm_q8_dir, router):
        fluid.set_flag("observe", True)
        observe.get_tracer().clear()
        reps = [_mk_lm_replica(lm_q8_dir, router, rid, role)
                for rid, role in (("p0", "prefill"), ("d0", "decode"))]
        try:
            _wait_ready(router, 2)
            with xray.span("client_generate", cat="t") as root:
                r = router.generate_torrent("m", PROMPTS[0],
                                            max_new_tokens=6)
            assert r.tokens
        finally:
            for rep in reps:
                rep.close()
            fluid.set_flag("observe", False)
        names = {e.name for e in observe.get_tracer().events()
                 if e.args.get("trace_id") == root.trace_id}
        # the whole disaggregated generation is ONE trace: the routed
        # prefill half, the prefill driver, the KV-stream hop INTO the
        # decode replica, and the pinned collect
        for must in ("fleet:torrent_generate", "replica:torrent_prefill",
                     "torrent:prefill", "replica:torrent_kv",
                     "replica:torrent_collect"):
            assert must in names, (must, sorted(names))


@pytest.mark.parametrize("prefill_pkg,decode_pkg",
                         [("jax", "torch"), ("torch", "jax")])
def test_cross_package_disaggregation_matches_both_solos(
        prefill_pkg, decode_pkg, jax_q8_dir):
    """A prefill replica of one package streams its int8 KV rows over
    the wire to a decode replica of the other, behind the decode
    package's router: the tokens equal both packages' solo servers."""
    jsolo = jserve.InferenceServer(jfluid.CPUPlace(), jserve.ServeConfig())
    tsolo = serve.InferenceServer(fluid.CPUPlace(), serve.ServeConfig())
    jsolo.add_model("m", jax_q8_dir)
    tsolo.add_model("m", jax_q8_dir)
    try:
        jref = [jsolo.generate("m", p, max_new_tokens=10).tokens
                for p in PROMPTS]
        tref = [tsolo.generate("m", p, max_new_tokens=10).tokens
                for p in PROMPTS]
    finally:
        jsolo.close()
        tsolo.close()
    assert jref == tref
    rt = (jfleet if decode_pkg == "jax" else fleet).FleetRouter(
        (jfleet if decode_pkg == "jax" else fleet).RouterConfig(
            lease_s=1.0, poll_interval_s=0.15)).start()
    reps = [_mk_lm_replica(jax_q8_dir, rt, "p0", "prefill", prefill_pkg),
            _mk_lm_replica(jax_q8_dir, rt, "d0", "decode", decode_pkg)]
    try:
        _wait_ready(rt, 2)
        got = []
        for p in PROMPTS:
            r = rt.generate_torrent("m", p, max_new_tokens=10)
            assert r.replica_id == "d0"
            assert r.outs["prefill"]["bytes"] > 0
            got.append(r.tokens)
        assert got == tref
    finally:
        for rep in reps:
            rep.close()
        rt.close()
