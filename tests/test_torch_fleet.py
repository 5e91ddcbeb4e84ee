"""The serving fleet in the port (``paddle_tpu_torch/fleet``), on the CPU.

Every non-slow case of ``tests/test_fleet.py`` runs here against the
port with the same assertions: the row cache, leases, the read-only
client, the sparse save's manifest, the serve-time sparse read path
(bit parity against a full-table reference, invalidation on swap), the
registry's staged swap and readiness detail, the router's membership,
dispatch, failover and error classification, the coordinated swap under
traffic, and the pulse-polled router.

Then the port against the JAX package: the sparse read path of both on
the same pserver shards (the augmented feeds bit for bit, the outputs
within 1e-6: the dense layers sum in each package's order), a JAX router dispatching to port replicas, and the two
cases that waited for this module:
``tests/test_quorum.py::test_fleet_router_quorum_backed_membership`` and
``tests/test_haven.py::test_fleet_sparse_row_pulls_survive_primary_kill``.

The multi-process drills are ``tools/torch_serve_loadgen.py
--replicas`` and ``tools/torch_chaos_drill.py --scenario replica_kill``
(``tests/test_torch_fleet_tools.py``).
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu import fleet as jfleet
from paddle_tpu import serve as jserve
from paddle_tpu_torch import fleet, observe, serve
from paddle_tpu_torch.ark import chaos as ark_chaos
from paddle_tpu_torch.ark.heartbeat import HeartbeatThread
from paddle_tpu_torch.ark.liveness import QuorumLeaseTable
from paddle_tpu_torch.pserver import ParameterServer, PSClient
from paddle_tpu_torch.pserver import rpc as ps_rpc
from paddle_tpu_torch.quorum import QuorumClient, QuorumNode
from paddle_tpu_torch.serve.errors import (BadRequestError,
                                           ModelNotFoundError,
                                           ModelUnavailableError,
                                           QueueFullError)


@pytest.fixture(autouse=True)
def _fresh_port_telemetry():
    """The repo conftest resets the JAX package's telemetry; this resets
    the port's (the metrics, observatory and pulse these cases read)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = fluid.get_flag("observe")
    observe.reset_all()
    yield
    torch.set_num_threads(n)
    fluid.set_flag("observe", prev)
    observe.reset_all()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _build_mlp_dir(dirname, scale=1.0, seed=7):
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        h = fluid.layers.fc(input=x, size=32, act="relu")
        pred = fluid.layers.fc(input=h, size=8, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    if scale != 1.0:
        for v in main.global_block().vars.values():
            if isinstance(v, fluid.Parameter):
                scope.set_var(v.name,
                              np.asarray(scope.find_var(v.name)) * scale)
    fluid.io.save_inference_model(dirname, ["x"], [pred], exe,
                                  main_program=main, scope=scope)


F, NVOCAB, K, D = 4, 300, 6, 3


def _build_deepfm_sparse_dir(dirname, eps, scale=1.0, seed=5, cap=64,
                             with_optimizer=False):
    """DeepFM inference dir whose tables live ONLY in pserver shards."""
    from paddle_tpu_torch.models import deepfm
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _feeds, outs = deepfm.build(num_fields=F, sparse_feature_dim=NVOCAB,
                                    embedding_size=K, dense_dim=D,
                                    hidden_sizes=(8, 8), distributed=True)
        if with_optimizer:
            # the TRAINED-program shape: optimizer slots (fm_v_moment_0,
            # table-sized) exist as persistables in the pruned slice
            fluid.optimizer.Adagrad(learning_rate=0.05).minimize(
                outs["loss"])
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    if scale != 1.0:
        for v in main.global_block().vars.values():
            if isinstance(v, fluid.Parameter):
                scope.set_var(v.name,
                              np.asarray(scope.find_var(v.name)) * scale)
    fleet.save_sparse_inference_model(
        dirname, ["dense_input", "sparse_input"], [outs["predict"]], exe,
        main_program=main, scope=scope, cap=cap)


def _start_sparse_world():
    servers = [ParameterServer("127.0.0.1:0").start() for _ in range(2)]
    eps = [s.endpoint for s in servers]
    client = PSClient(eps)
    for wname, width in (("fm_v", K), ("fm_w", 1)):
        client.init_table(wname, NVOCAB, width, "float32", -0.05, 0.05,
                          seed=1337, opt_type="sgd", lr=0.1, attrs={})
    return servers, eps, client


def _mk_replica(mdir, router=None, rid=None, lease_s=1.0, warm=True,
                sparse=None, ladder=(1, 2, 4)):
    srv = serve.InferenceServer(
        fluid.CPUPlace(), serve.ServeConfig(batch_timeout_ms=1.0))
    srv.add_model("m", mdir, ladder=serve.BucketLadder(rows=ladder),
                  warm=warm, sparse=sparse)
    return fleet.ReplicaServer(
        srv, replica_id=rid,
        router_endpoint=router.control_endpoint if router else None,
        lease_s=lease_s).start()


@pytest.fixture
def mlp_dir(tmp_path):
    d = os.path.join(str(tmp_path), "model")
    _build_mlp_dir(d)
    return d


def _feed(n=2, seed=None):
    r = np.random.RandomState(seed) if seed is not None else np.random
    return {"x": r.randn(n, 16).astype(np.float32)}


def _wait_for(cond, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# small parts: cache, leases, read-only client, manifest
# ---------------------------------------------------------------------------

def test_row_cache_lru_bound():
    c = fleet.RowCache(capacity_rows=3)
    for i in range(5):
        c.put("t", i, np.full(2, i, np.float32))
    assert len(c) == 3
    assert c.get("t", 0) is None and c.get("t", 1) is None
    assert c.get("t", 2) is not None
    # touching 2 makes 3 the LRU victim of the next insert
    c.put("t", 9, np.zeros(2, np.float32))
    assert c.get("t", 3) is None and c.get("t", 2) is not None
    # stored rows are copies, not aliases
    row = np.ones(2, np.float32)
    c.put("u", 1, row)
    row[:] = 7
    np.testing.assert_array_equal(c.get("u", 1), np.ones(2, np.float32))


def test_lease_table_string_members():
    from paddle_tpu_torch.ark import LeaseTable
    lt = LeaseTable()
    lt.beat("r@host:1", lease_s=30.0)
    lt.beat(3, lease_s=30.0)           # legacy int ids still coerce
    lt.beat(np.int64(4), lease_s=0.0)
    assert set(lt.live()) == {"r@host:1", 3}
    assert 4 in lt.expired()
    lt.forget("r@host:1")
    assert lt.live() == [3]


def test_read_only_psclient_refuses_mutation():
    c = PSClient(["127.0.0.1:1"], read_only=True)
    with pytest.raises(RuntimeError, match="read_only"):
        c.push_grad("127.0.0.1:1", "w", np.zeros(2, np.float32))
    with pytest.raises(RuntimeError, match="read_only"):
        c.init_param("127.0.0.1:1", "w", np.zeros(2), "sgd", 0.1, {})
    c.close()


def test_save_sparse_inference_model_manifest(tmp_path):
    d = os.path.join(str(tmp_path), "dfm")
    _build_deepfm_sparse_dir(d, eps=None)
    man = json.load(open(os.path.join(d, "MANIFEST.json")))
    assert set(man["sparse"]["tables"]) == {"fm_v", "fm_w"}
    assert man["sparse"]["cap"] == 64
    assert man["sparse"]["tables"]["fm_v"]["width"] == K
    # the table values are NOT in the dir
    assert not any("fm_v" in f or "fm_w" in f for f in os.listdir(d))
    # loading without a sparse config is refused with a pointed error
    reg = serve.ModelRegistry(fluid.CPUPlace())
    with pytest.raises(ModelUnavailableError, match="pserver shards"):
        reg.load("dfm", d)
    reg.close()
    # a TRAINED program's table-sized optimizer slots are excluded too
    # (and recorded in skip_vars so the loader skips exactly the same
    # set)
    d3 = os.path.join(str(tmp_path), "dfm_trained")
    _build_deepfm_sparse_dir(d3, eps=None, with_optimizer=True)
    man3 = json.load(open(os.path.join(d3, "MANIFEST.json")))
    skips = set(man3["sparse"]["skip_vars"])
    assert {"fm_v", "fm_w"} <= skips
    assert any(s.startswith("fm_v_") for s in skips)
    assert not any(f.startswith(("fm_v", "fm_w"))
                   for f in os.listdir(d3))
    # the dir loads back with the recorded skip list (no missing-file
    # error on the excluded slots)
    exe3 = fluid.Executor(fluid.CPUPlace())
    prog3, _f3, _v3 = fluid.io.load_inference_model(
        d3, exe3, scope=fluid.Scope(), skip_vars=skips)
    assert prog3 is not None
    # a plain model must refuse the sparse save (no silent empty key)
    d2 = os.path.join(str(tmp_path), "plain")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.fc(input=x, size=2)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(BadRequestError, match="no is_distributed"):
        fleet.save_sparse_inference_model(d2, ["x"], [y], exe,
                                          main_program=main, scope=scope)


def test_sparse_dir_manifests_equal_across_packages(tmp_path):
    """A port-saved sparse dir loads in the JAX package's registry path
    and the reverse: both skip the same vars, and the JAX package's
    `io.load_inference_model(skip_vars=)` reads the port's dir."""
    d = os.path.join(str(tmp_path), "dfm")
    _build_deepfm_sparse_dir(d, eps=None, with_optimizer=True)
    man = json.load(open(os.path.join(d, "MANIFEST.json")))
    exe = jfluid.Executor(jfluid.CPUPlace())
    prog, feeds, _v = jfluid.io.load_inference_model(
        d, exe, scope=jfluid.Scope(),
        skip_vars=set(man["sparse"]["skip_vars"]))
    assert feeds == ["dense_input", "sparse_input"]
    assert set(jfleet.sparse_table_specs(prog)) == {"fm_v", "fm_w"}


# ---------------------------------------------------------------------------
# serve-time sparse read path
# ---------------------------------------------------------------------------

def test_sparse_serve_bit_parity_and_cache(tmp_path):
    servers, eps, client = _start_sparse_world()
    try:
        d = os.path.join(str(tmp_path), "dfm")
        _build_deepfm_sparse_dir(d, eps)
        srv = serve.InferenceServer(
            fluid.CPUPlace(), serve.ServeConfig(batch_timeout_ms=1.0))
        srv.add_model("dfm", d, ladder=serve.BucketLadder(rows=(1, 2)),
                      sparse=fleet.SparseServeConfig(eps, cache_rows=512))
        rng = np.random.RandomState(3)
        feed = {"dense_input": rng.randn(2, D).astype(np.float32),
                "sparse_input": rng.randint(
                    0, NVOCAB, size=(2, F)).astype(np.int64)}
        out, = srv.infer("dfm", feed)

        # reference: the SAME program fed the full tables with raw ids
        exe = fluid.Executor(fluid.CPUPlace())
        ref_scope = fluid.Scope()
        prog, _f, fvars = fluid.io.load_inference_model(
            d, exe, scope=ref_scope, skip_vars={"fm_v", "fm_w"})
        full_v = client.prefetch_rows("fm_v", np.arange(NVOCAB))
        full_w = client.prefetch_rows("fm_w", np.arange(NVOCAB))
        ref, = exe.run(prog, feed={**feed, "fm_v": full_v, "fm_w": full_w},
                       fetch_list=fvars, scope=ref_scope)
        np.testing.assert_array_equal(out, np.asarray(ref))

        plan = srv.registry.get("dfm").sparse_plan
        misses0 = plan.misses
        assert misses0 > 0 and plan.hits == 0
        out2, = srv.infer("dfm", feed)      # identical ids: pure cache
        np.testing.assert_array_equal(out, out2)
        assert plan.misses == misses0 and plan.hits > 0
        # the whole path warmed + served with zero unexpected recompiles
        assert not observe.observatory().unexpected()
        srv.close()
    finally:
        client.close()
        for s in servers:
            s.stop()


def test_sparse_cache_invalidation_on_swap(tmp_path):
    servers, eps, client = _start_sparse_world()
    try:
        d = os.path.join(str(tmp_path), "dfm")
        _build_deepfm_sparse_dir(d, eps)
        srv = serve.InferenceServer(
            fluid.CPUPlace(), serve.ServeConfig(batch_timeout_ms=1.0))
        srv.add_model("dfm", d, ladder=serve.BucketLadder(rows=(1, 2)),
                      sparse=fleet.SparseServeConfig(eps, cache_rows=512))
        rng = np.random.RandomState(4)
        feed = {"dense_input": rng.randn(1, D).astype(np.float32),
                "sparse_input": rng.randint(
                    0, NVOCAB, size=(1, F)).astype(np.int64)}
        out1, = srv.infer("dfm", feed)
        plan1 = srv.registry.get("dfm").sparse_plan
        v1 = srv.registry.get("dfm").version_key

        # training moves the touched rows server-side...
        ids = np.unique(feed["sparse_input"].reshape(-1))
        client.push_sparse_grad(
            "fm_v", ids, np.full((ids.size, K), 2.0, np.float32))
        # ...but the serving CACHE answers: same version -> same bytes
        out_cached, = srv.infer("dfm", feed)
        np.testing.assert_array_equal(out1, out_cached)

        # a model push (hot swap) is the invalidation point
        _build_deepfm_sparse_dir(d, eps)      # re-save, same seed/params
        assert srv.reload("dfm", force=False)  # new dir fingerprint
        ver2 = srv.registry.get("dfm")
        assert ver2.version_id != v1 or ver2.version_key == v1
        plan2 = ver2.sparse_plan
        assert plan2 is not plan1
        assert len(plan2.cache) == 0           # fresh, version-keyed
        out3, = srv.infer("dfm", feed)
        assert not np.array_equal(out1, out3)  # updated rows now visible
        # the retired version's plan was closed (cache released)
        assert len(plan1.cache) == 0
        srv.close()
    finally:
        client.close()
        for s in servers:
            s.stop()


def test_sparse_serve_path_equals_the_jax_packages(tmp_path):
    """Both packages' sparse read paths on the SAME pserver shards and the
    same dir: the plans' augmented feeds (the pulled sub-tables and the
    remapped ids) bit for bit, and the served outputs within 1e-6."""
    servers, eps, client = _start_sparse_world()
    try:
        d = os.path.join(str(tmp_path), "dfm")
        _build_deepfm_sparse_dir(d, eps)
        tsrv = serve.InferenceServer(
            fluid.CPUPlace(), serve.ServeConfig(batch_timeout_ms=1.0))
        jsrv = jserve.InferenceServer(
            jfluid.CPUPlace(), jserve.ServeConfig(batch_timeout_ms=1.0))
        tsrv.add_model("dfm", d, ladder=serve.BucketLadder(rows=(1, 2, 4)),
                       sparse=fleet.SparseServeConfig(eps, cache_rows=512))
        jsrv.add_model("dfm", d, ladder=jserve.BucketLadder(rows=(1, 2, 4)),
                       sparse=jfleet.SparseServeConfig(eps, cache_rows=512))
        tplan = tsrv.registry.get("dfm").sparse_plan
        jplan = jsrv.registry.get("dfm").sparse_plan
        rng = np.random.RandomState(11)
        for n in (1, 3, 4):
            feed = {"dense_input": rng.randn(n, D).astype(np.float32),
                    "sparse_input": rng.randint(
                        0, NVOCAB, size=(n, F)).astype(np.int64)}
            ta, ja = tplan.augment(feed), jplan.augment(feed)
            assert set(ta) == set(ja)
            for k in ta:
                assert ta[k].dtype == np.asarray(ja[k]).dtype, k
                np.testing.assert_array_equal(ta[k], np.asarray(ja[k]))
            tout, = tsrv.infer("dfm", feed)
            jout, = jsrv.infer("dfm", feed)
            assert tout.shape == np.asarray(jout).shape == (n, 1)
            # the dense layers sum in each package's own order: 1 ulp
            np.testing.assert_allclose(tout, np.asarray(jout), rtol=0,
                                       atol=1e-6)
        assert tplan.stats()["cache_misses"] == jplan.stats()["cache_misses"]
        assert tplan.stats()["cached_rows"] == jplan.stats()["cached_rows"]
        tsrv.close()
        jsrv.close()
    finally:
        client.close()
        for s in servers:
            s.stop()


def test_fleet_sparse_row_pulls_survive_primary_kill():
    """The port's version of tests/test_haven.py's fleet leg: a read-only
    serve client with the backup listed as replica keeps answering row
    pulls THROUGH a primary kill — no promotion required, the standby's
    bounded-stale reads carry the serving plane."""
    backup = ParameterServer("127.0.0.1:0", trainers=1).start()
    backup.start_standby(lease_s=0.6, auto_promote=True)
    primary = ParameterServer("127.0.0.1:0", trainers=1).start()
    primary.start_replication(backup.endpoint, lease_s=0.6, window=512,
                              stall_timeout_s=5.0)
    setup = PSClient([primary.endpoint])
    srv = PSClient([primary.endpoint],
                   replicas={primary.endpoint: [backup.endpoint]},
                   read_only=True, deadline=5.0)
    try:
        setup.init_table("emb", rows=12, width=4, dtype="float32",
                         init_low=-0.5, init_high=0.5, seed=9,
                         opt_type="sgd", lr=0.5, attrs={})
        setup.push_sparse_grad("emb", np.array([0, 2, 4]),
                               np.ones((3, 4), np.float32))
        _wait_for(lambda: primary._haven.log.lag() == 0, what="ack drain")
        before = srv.prefetch_rows("emb", np.array([0, 2, 4, 6]))
        ark_chaos.kill_server(primary)
        after = srv.prefetch_rows("emb", np.array([0, 2, 4, 6]))
        np.testing.assert_array_equal(before, after)
    finally:
        setup.close()
        srv.close()
        primary.stop()
        backup.stop()


def test_fleet_router_quorum_backed_membership(tmp_path):
    """The port's version of tests/test_quorum.py's fleet case:
    RouterConfig(quorum=) swaps the membership table for the
    quorum-backed one; a replica whose heartbeat to the ROUTER stops
    (asymmetric partition) but whose own arbiter lease stays live is
    still a member."""
    d = str(tmp_path / "q")
    nodes = [QuorumNode("127.0.0.1:0", d, node_id=f"n{i}").start()
             for i in range(3)]
    qc = QuorumClient([x.endpoint for x in nodes])
    router = fleet.FleetRouter(fleet.RouterConfig(
        lease_s=0.2, quorum=qc,
        quorum_member_prefix="fleet-member:")).start()
    try:
        assert isinstance(router._lease, QuorumLeaseTable)
        # plain config keeps the plain table
        r2 = fleet.FleetRouter(fleet.RouterConfig())
        assert type(r2._lease).__name__ == "LeaseTable"
        r2.close()
        # the member side renews EXACTLY as ReplicaServer(quorum=...)
        # wires its HeartbeatThread
        hb = HeartbeatThread(beat=lambda: None, lease_s=5.0, quorum=qc,
                             quorum_resource="fleet-member:r9",
                             quorum_holder="r9")
        hb.beat_once()
        hb.stop()
        router._lease.beat("r9", lease_s=0.2)
        time.sleep(0.4)                      # local lease lapses
        _wait_for(lambda: "r9" in router._lease.live(), timeout=5.0,
                  what="quorum-backed membership")  # arbiters vouch
    finally:
        router.close()
        qc.close()
        for n in nodes:
            n.stop()


# ---------------------------------------------------------------------------
# registry staged swap + readiness detail
# ---------------------------------------------------------------------------

def test_registry_prepare_commit_abort(tmp_path, mlp_dir):
    reg = serve.ModelRegistry(fluid.CPUPlace())
    v1 = reg.load("m", mlp_dir)
    assert v1.warmed and v1.manifest_sha
    with pytest.raises(ModelUnavailableError, match="no staged"):
        reg.commit("m")
    d2 = os.path.join(str(tmp_path), "model2")
    _build_mlp_dir(d2, scale=1.5, seed=11)
    staged = reg.prepare("m", d2)
    assert staged.warmed and reg.staged("m") is staged
    assert reg.get("m") is v1              # NOT published yet
    # the slot's PUBLISHED dir must not move before commit
    assert reg._slot("m").dirname == mlp_dir
    assert reg.reload("m") is False        # watcher no-ops mid-stage
    assert reg.get("m") is v1
    assert reg.abort("m") and reg.staged("m") is None
    assert reg.get("m") is v1
    staged2 = reg.prepare("m", d2)
    committed = reg.commit("m")
    assert committed is staged2 and reg.get("m") is staged2
    assert reg._slot("m").dirname == os.path.abspath(d2)
    assert v1.wait_retired(5.0)
    assert staged2.manifest_sha != v1.manifest_sha
    reg.close()


def test_readyz_detail_version_and_warmed(mlp_dir):
    """The pulse /readyz body carries per-model version_id + warm state
    — the router's 'right version, warmed' gate."""
    import urllib.request
    fluid.set_flag("observe", True)
    srv = serve.InferenceServer(
        fluid.CPUPlace(),
        serve.ServeConfig(batch_timeout_ms=1.0, pulse_port=0))
    srv.add_model("m", mlp_dir, ladder=serve.BucketLadder(rows=(1, 2)))
    ver = srv.registry.get("m")
    with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.pulse_port}/readyz", timeout=5) as r:
        doc = json.loads(r.read())
    assert doc["status"] == "ok"
    detail = next(v["detail"] for k, v in doc["checks"].items()
                  if k.startswith("serve_queues"))
    assert detail["m"]["version"] == ver.version_id
    assert detail["m"]["version_key"] == ver.manifest_sha
    assert detail["m"]["warmed"] is True
    assert detail["m"]["generative"] is False
    assert detail["m"]["capacity"] > 0
    srv.close()


def test_unwarmed_model_reports_unready(mlp_dir):
    """A loaded-but-unwarmed version must gate readiness."""
    srv = serve.InferenceServer(fluid.CPUPlace())
    srv.add_model("m", mlp_dir, warm=False)
    ok, detail = srv._pulse_queue_check()
    assert detail["m"]["warmed"] is False and not ok
    srv.close()


# ---------------------------------------------------------------------------
# router: membership, dispatch, failover, classification
# ---------------------------------------------------------------------------

@pytest.fixture
def router():
    r = fleet.FleetRouter(fleet.RouterConfig(
        lease_s=1.0, poll_interval_s=0.15)).start()
    yield r
    r.close()


def _wait_ready(router, n, model="m", timeout=20):
    deadline = time.time() + timeout
    while len(router.ready_members(model)) < n:
        assert time.time() < deadline, \
            f"fleet never reached {n} ready: {router.members()}"
        time.sleep(0.05)


def test_membership_heartbeat_and_leave(router, mlp_dir):
    rep = _mk_replica(mlp_dir, router, "r0")
    _wait_ready(router, 1)
    mem = router.members()
    assert mem["r0"]["lease_live"] and mem["r0"]["ready"]
    assert mem["r0"]["models"]["m"]["warmed"]
    rep.close()                      # clean stop => explicit leave
    deadline = time.time() + 5
    while "r0" in router.members():
        assert time.time() < deadline
        time.sleep(0.05)


def test_least_loaded_dispatch_prefers_shallow_queue(router):
    """Unit-level: _pick must choose the replica with the smallest
    inflight + polled-depth score, round-robin on ties."""
    for rid, depth, inflight in (("a", 5, 0), ("b", 0, 1), ("c", 0, 1)):
        router._register(rid, f"127.0.0.1:{9000 + ord(rid)}", None,
                         session=None, lease_s=30.0)
        m = router._members[rid]
        m.ready = True
        m.models = {"m": {"depth": depth, "warmed": True,
                          "version_key": "k"}}
        m.inflight = inflight
    picks = {router._pick("m", set()).replica_id for _ in range(8)}
    assert picks == {"b", "c"}       # tie between b/c, a never picked
    # excluding both ties forces the deep queue
    assert router._pick("m", {"b", "c"}).replica_id == "a"
    # version gating: once the fleet committed a version, a stale
    # member is not pickable
    router._desired["m"] = "k2"
    assert router._pick("m", set()) is None


def test_dispatch_spreads_and_tags_versions(router, mlp_dir):
    reps = [_mk_replica(mlp_dir, router, f"r{i}") for i in range(2)]
    try:
        _wait_ready(router, 2)
        served = set()
        for i in range(16):
            res = router.infer("m", _feed(seed=i))
            out = res.outs[0]
            # the reply crossed the wire as host numpy
            assert isinstance(out, np.ndarray) and out.shape == (2, 8)
            assert res.version and res.version_key
            served.add(res.replica_id)
        assert served == {"r0", "r1"}
    finally:
        for r in reps:
            r.close()


def test_failover_on_replica_death_and_lease_expiry(router, mlp_dir):
    reps = [_mk_replica(mlp_dir, router, f"r{i}") for i in range(2)]
    try:
        _wait_ready(router, 2)
        reg = observe.metrics.default_registry()
        before = (reg.get("fleet_failovers_total").total()
                  if reg.get("fleet_failovers_total") else 0)
        reps[0].kill()               # SIGKILL analog: no leave, no drain
        for i in range(8):           # every request survives via r1
            res = router.infer("m", _feed(seed=i))
            assert res.replica_id == "r1"
        after = reg.get("fleet_failovers_total").total()
        assert after >= before + 1   # the reroute was metered
        deadline = time.time() + 6   # lease 1.0s: expiry, not poll luck
        while True:
            mem = router.members()
            if "r0" not in mem or not mem["r0"]["lease_live"]:
                break
            assert time.time() < deadline, mem
            time.sleep(0.1)
        assert len(router.ready_members("m")) == 1
    finally:
        for r in reps:
            r.close()


def test_unwarmed_replica_gets_no_traffic(router, mlp_dir):
    """The 'right version, WARMED' readiness gate end to end."""
    warm_rep = _mk_replica(mlp_dir, router, "warm")
    cold_rep = _mk_replica(mlp_dir, router, "cold", warm=False)
    try:
        _wait_ready(router, 1)
        time.sleep(0.4)              # a few poll rounds for 'cold'
        ready = {m.replica_id for m in router.ready_members("m")}
        assert ready == {"warm"}
        for i in range(6):
            assert router.infer("m", _feed(seed=i)).replica_id == "warm"
    finally:
        warm_rep.close()
        cold_rep.close()


class _FakeReplica:
    """Protocol-level stub: answers readyz ready, and every infer with a
    scripted serve error."""

    def __init__(self, error_type="QueueFullError", retriable=True):
        import socket as _socket
        self.error_type = error_type
        self.retriable = retriable
        self.infer_calls = 0
        self._lis = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
        self._lis.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
        self._lis.bind(("127.0.0.1", 0))
        self._lis.listen(8)
        self.endpoint = f"127.0.0.1:{self._lis.getsockname()[1]}"
        self._stop = False
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while not self._stop:
            try:
                conn, _ = self._lis.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        try:
            while True:
                try:
                    msg = ps_rpc.recv_msg(conn)
                except (ConnectionError, EOFError, OSError):
                    return
                cmd = msg[0]
                if cmd == "readyz":
                    reply = ("ok", {
                        "status": "ok", "replica_id": self.endpoint,
                        "models": {"m": {"depth": 0, "warmed": True,
                                         "version_key": "fake"}}})
                elif cmd == "infer":
                    self.infer_calls += 1
                    reply = ("err_serve", {"type": self.error_type,
                                           "msg": "scripted",
                                           "retriable": self.retriable})
                else:
                    reply = ("ok", None)
                ps_rpc.send_msg(conn, reply)
        finally:
            conn.close()

    def close(self):
        self._stop = True
        try:
            self._lis.close()
        except OSError:
            pass


def test_retriable_error_sheds_terminal_does_not(router):
    a = _FakeReplica("QueueFullError", retriable=True)
    b = _FakeReplica("QueueFullError", retriable=True)
    try:
        router.add_replica(a.endpoint, "fa")
        router.add_replica(b.endpoint, "fb")
        _wait_ready(router, 2)
        # every replica saturated: the request is shed across BOTH, and
        # the surfaced error is the RETRIABLE QueueFullError
        with pytest.raises(QueueFullError):
            router.infer("m", _feed())
        assert a.infer_calls >= 1 and b.infer_calls >= 1
        reg = observe.metrics.default_registry()
        assert reg.get("fleet_sheds_total").total() >= 2
        # terminal classification: BadRequestError raises IMMEDIATELY
        a.error_type = b.error_type = "BadRequestError"
        a.retriable = b.retriable = False
        calls_before = a.infer_calls + b.infer_calls
        with pytest.raises(BadRequestError):
            router.infer("m", _feed())
        assert a.infer_calls + b.infer_calls == calls_before + 1
        # unknown model is terminal too
        a.error_type = b.error_type = "ModelNotFoundError"
        with pytest.raises(ModelNotFoundError):
            router.infer("m", _feed())
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# coordinated swap
# ---------------------------------------------------------------------------

def test_coordinated_swap_skew_free_under_traffic(router, tmp_path,
                                                  mlp_dir):
    reps = [_mk_replica(mlp_dir, router, f"r{i}") for i in range(2)]
    try:
        _wait_ready(router, 2)
        v0 = router.infer("m", _feed()).version_key
        stop = threading.Event()
        completions, errors = [], []
        lock = threading.Lock()

        def hammer(tid):
            i = 0
            while not stop.is_set():
                i += 1
                try:
                    res = router.infer("m", _feed(seed=tid * 1000 + i))
                    with lock:
                        completions.append((res.seq, res.version_key))
                except Exception as e:          # noqa: BLE001
                    with lock:
                        errors.append(repr(e))
        threads = [threading.Thread(target=hammer, args=(t,), daemon=True)
                   for t in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        d2 = os.path.join(str(tmp_path), "model2")
        _build_mlp_dir(d2, scale=1.5, seed=11)
        report = router.swap("m", d2)
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(timeout=10)

        assert not errors, errors[:3]
        assert report["version_key"] != v0
        assert sorted(report["replicas"]) == ["r0", "r1"]
        keys = [k for _, k in sorted(completions)]
        assert v0 in keys and report["version_key"] in keys
        flip = keys.index(report["version_key"])
        # skew gate: strictly old before the flip, strictly new after
        assert all(k == v0 for k in keys[:flip])
        assert all(k == report["version_key"] for k in keys[flip:])
        for rep in reps:
            assert rep.server.registry.get("m").version_key == \
                report["version_key"]
        _wait_ready(router, 2)
        served = set()
        deadline = time.time() + 5
        i = 0
        while served != {"r0", "r1"} and time.time() < deadline:
            i += 1
            served.add(router.infer("m", _feed(seed=i)).replica_id)
        assert served == {"r0", "r1"}
    finally:
        for r in reps:
            r.close()


def test_swap_aborts_fleet_wide_on_prepare_failure(router, tmp_path,
                                                   mlp_dir):
    reps = [_mk_replica(mlp_dir, router, f"r{i}") for i in range(2)]
    try:
        _wait_ready(router, 2)
        v0 = router.infer("m", _feed()).version_key
        with pytest.raises(fleet.FleetError, match="old version keeps"):
            router.swap("m", os.path.join(str(tmp_path), "nonexistent"))
        for rep in reps:
            assert rep.server.registry.staged("m") is None
        res = router.infer("m", _feed())
        assert res.version_key == v0
    finally:
        for r in reps:
            r.close()


# ---------------------------------------------------------------------------
# pulse-armed router + HTTP readyz polling
# ---------------------------------------------------------------------------

def test_router_polls_http_readyz_and_pulse_check(mlp_dir):
    fluid.set_flag("observe", True)
    srv = serve.InferenceServer(
        fluid.CPUPlace(),
        serve.ServeConfig(batch_timeout_ms=1.0, pulse_port=0))
    srv.add_model("m", mlp_dir, ladder=serve.BucketLadder(rows=(1, 2)))
    rep = fleet.ReplicaServer(srv, replica_id="r0").start()
    router = fleet.FleetRouter(fleet.RouterConfig(
        lease_s=1.0, poll_interval_s=0.15, poll="http")).start()
    try:
        router.add_replica(rep.endpoint, "r0", pulse_port=srv.pulse_port)
        _wait_ready(router, 1)
        m = router.members()["r0"]
        assert m["models"]["m"]["warmed"] is True
        assert m["models"]["m"]["version_key"] == \
            srv.registry.get("m").version_key
        res = router.infer("m", _feed())
        assert res.replica_id == "r0"
        ok, detail = router._pulse_membership_check()
        assert ok and detail["ready_by_model"]["m"] == 1
    finally:
        router.close()
        rep.close()


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

def test_jax_router_dispatches_to_port_replicas(mlp_dir):
    """The JAX package's router drives two port replicas over the wire:
    heartbeats, readiness polls and infer replies interoperate, and each
    reply equals the JAX package's own server on the same dir."""
    jr = jfleet.FleetRouter(jfleet.RouterConfig(
        lease_s=1.0, poll_interval_s=0.15)).start()
    reps = [_mk_replica(mlp_dir, jr, f"t{i}") for i in range(2)]
    js = jserve.InferenceServer(jfluid.CPUPlace(),
                                jserve.ServeConfig(batch_timeout_ms=1.0))
    js.add_model("m", mlp_dir, ladder=jserve.BucketLadder(rows=(1, 2, 4)))
    try:
        _wait_ready(jr, 2)
        served = set()
        for i in range(8):
            feed = _feed(seed=i)
            res = jr.infer("m", feed)
            want, = js.infer("m", feed)
            np.testing.assert_allclose(res.outs[0], np.asarray(want),
                                       rtol=0, atol=1e-6)
            assert res.version_key == js.registry.get("m").version_key
            served.add(res.replica_id)
        assert served == {"t0", "t1"}
    finally:
        for r in reps:
            r.close()
        js.close()
        jr.close()
