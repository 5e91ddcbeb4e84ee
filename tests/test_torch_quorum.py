"""fluid-quorum in the port: the partition-safe coordination plane
(``paddle_tpu_torch/quorum``) with every quorum route of ``pserver``,
``haven`` and ``ark`` armed, on the CPU.

Every case of ``tests/test_quorum.py`` runs here against the port's
copies with the same assertions, but
``test_fleet_router_quorum_backed_membership``, which runs in
``tests/test_torch_fleet.py`` beside the rest of ``fleet/``. Then the
interop: the port's client against the JAX package's arbiters and the
reverse give the same replies, and both packages' stores persist the
same bytes.

The cases pin the arbiter protocol (docs/FAULT_TOLERANCE.md §Quorum arbiter):
strict-majority grants at a persisted monotone fencing epoch, arbiter
restarts that can never regress an epoch (torn-snapshot corpus), the
boot blackout, fail-closed minority renewals, exactly-one-grant under
racing campaigns, the haven integration (quorum-gated promotion, fence
-> step-down -> resyncing-standby rejoin, pair-only partitions that do
NOT promote), the NetPartition chaos primitive, quorum-backed lease
tables/heartbeats, the quorum_loss detector, and the plain haven
pair's compatibility guarantee: a no-quorum haven pair behaves exactly as
before.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import ark
from paddle_tpu_torch import observe as tobs
from paddle_tpu_torch.ark import chaos as ark_chaos
from paddle_tpu_torch.ark.heartbeat import HeartbeatThread
from paddle_tpu_torch.ark.liveness import QuorumLeaseTable
from paddle_tpu_torch.pserver import ParameterServer, PSClient
from paddle_tpu_torch.quorum import (QuorumClient, QuorumNode, QuorumStore,
                                     QuorumUnavailable)


@pytest.fixture(autouse=True)
def _fresh_port_telemetry():
    """The repo conftest resets the JAX package's telemetry; this resets
    the port's (the flight recorder and metrics these cases read)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = fluid.get_flag("observe")
    tobs.reset_all()
    yield
    torch.set_num_threads(n)
    fluid.set_flag("observe", prev)
    tobs.reset_all()


@pytest.fixture
def observe_on():
    from paddle_tpu_torch.observe import metrics as obs_metrics
    fluid.set_flag("observe", True)
    obs_metrics.default_registry().reset()
    yield obs_metrics.default_registry()
    fluid.set_flag("observe", False)


def _group(tmp_path, n=3, sub="q"):
    d = str(tmp_path / sub)
    nodes = [QuorumNode("127.0.0.1:0", d, node_id=f"n{i}").start()
             for i in range(n)]
    return nodes, [x.endpoint for x in nodes]


def _wait(cond, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


# -- arbiter protocol -----------------------------------------------------

def test_campaign_renew_resign_roundtrip(tmp_path):
    nodes, eps = _group(tmp_path)
    c = QuorumClient(eps)
    try:
        lease = c.campaign("r", "holder-a", lease_s=1.0)
        assert lease is not None and lease.epoch == 1 and lease.live
        assert c.renew(lease)
        # a rival cannot win while the lease is live, at ANY epoch bid
        c2 = QuorumClient(eps)
        assert c2.campaign("r", "holder-b", lease_s=1.0) is None
        # holder view: majority agrees on holder-a
        rec = c.holder("r")
        assert rec == {"holder": "holder-a", "epoch": 1}
        # resign frees the resource without regressing the epoch
        c.resign(lease)
        lease2 = c2.campaign("r", "holder-b", lease_s=1.0)
        assert lease2 is not None and lease2.epoch == 2
        # the deposed holder's renew is fenced
        assert not c.renew(lease)
        c2.close()
    finally:
        c.close()
        for n in nodes:
            n.stop()


def test_minority_renew_fails_closed(tmp_path):
    """The satellite pin: a holder that can reach only a MINORITY of
    arbiters must see renew() == False (and campaigns from the minority
    side must lose), even though every node it can reach says yes."""
    nodes, eps = _group(tmp_path)
    c = QuorumClient(eps)
    try:
        lease = c.campaign("r", "h", lease_s=5.0)
        assert lease is not None
        nodes[1].stop()
        nodes[2].stop()
        assert not c.renew(lease)      # 1/3 acks < strict majority
        c2 = QuorumClient(eps)
        assert c2.campaign("r2", "rival", lease_s=1.0) is None
        c2.close()
        # every node gone: campaign surfaces unavailability loudly
        nodes[0].stop()
        with pytest.raises(QuorumUnavailable):
            c.campaign("r3", "h", lease_s=1.0)
    finally:
        c.close()
        for n in nodes:
            n.stop()


def test_concurrent_campaigns_yield_exactly_one_grant(tmp_path):
    """The race pin: each node grants each epoch at most once, so two
    candidates campaigning simultaneously can never BOTH assemble a
    strict majority. Repeated with a thread barrier to force the
    interleaving."""
    nodes, eps = _group(tmp_path)
    try:
        for round_i in range(4):
            res = f"race-{round_i}"
            barrier = threading.Barrier(2)
            grants = [None, None]

            def run(i):
                c = QuorumClient(eps)
                try:
                    barrier.wait()
                    grants[i] = c.campaign(res, f"cand-{i}", lease_s=0.8,
                                           max_rounds=1)
                finally:
                    c.close()

            ts = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=20)
            winners = [g for g in grants if g is not None]
            assert len(winners) <= 1, (round_i, grants)
    finally:
        for n in nodes:
            n.stop()


def test_arbiter_restart_never_regresses_epoch(tmp_path):
    """Satellite pin, torn-snapshot corpus included: the persisted
    epoch survives a node restart in every crash shape the atomic-write
    idiom can leave behind, and a restarted node refuses campaigns
    through its boot blackout while accepting the incumbent's renew."""
    d = str(tmp_path / "q")
    node = QuorumNode("127.0.0.1:0", d, node_id="n0").start()
    c = QuorumClient([node.endpoint])
    lease = c.campaign("r", "h", lease_s=0.6)
    assert lease is not None and lease.epoch == 1
    ep = node.endpoint
    store_path = node.store.path
    node.stop()

    # crash-mid-write shape: a stale tmp file litters the dir while the
    # committed file is intact — the load ignores the litter
    with open(os.path.join(d, ".tmp_litter_n0_quorum_epochs.json"),
              "w") as f:
        f.write("{ torn")
    n2 = QuorumNode(ep, d, node_id="n0")
    assert n2.store.epoch("r") == 1

    # boot blackout: a fresh campaign is refused until the longest
    # granted lease has provably expired; the incumbent's renew at the
    # persisted epoch is accepted (it re-establishes the record)
    n2.start()
    reply = n2._h_q_campaign("r", "rival", epoch=2, lease_s=0.5)
    assert reply[1]["granted"] is False
    assert reply[1]["reason"] in ("boot_blackout", "held")
    assert n2.store.epoch("r") == 1          # the refusal spent no epoch
    assert c.renew(lease)                    # majority of 1
    # the blackout is PER RESOURCE: a resource this node never granted
    # has no possible pre-crash lease, so a brand-new shard bootstraps
    # through a freshly-restarted arbiter instantly
    reply = n2._h_q_campaign("fresh-shard", "h2", epoch=1, lease_s=0.5)
    assert reply[1]["granted"] is True
    time.sleep(0.7)                          # blackout + lease run out
    reply = n2._h_q_campaign("r", "rival", epoch=2, lease_s=0.5)
    assert reply[1]["granted"] is True and n2.store.epoch("r") == 2
    n2.stop()

    # crash BETWEEN the atomic payload replace and the sidecar write:
    # the payload self-verifies (embedded sha), so the stale sidecar is
    # healed, never fatal
    os.unlink(store_path + ark.checkpoint.SIDECAR_SUFFIX)
    with open(store_path + ark.checkpoint.SIDECAR_SUFFIX, "w") as f:
        json.dump({"file": os.path.basename(store_path),
                   "sha256": "0" * 64, "bytes": 1}, f)
    n2b = QuorumNode(ep, d, node_id="n0")
    assert n2b.store.epoch("r") == 2
    ark.verify_sidecar(store_path)   # healed on load

    # bit-rot shape: the payload disagrees with its EMBEDDED checksum —
    # the node REFUSES to start rather than restart at epoch 0
    with open(store_path) as f:
        doc = json.load(f)
    doc["epochs"]["r"]["epoch"] = 0   # regressed payload, stale sha
    with open(store_path, "w") as f:
        json.dump(doc, f)
    with pytest.raises(ark.CheckpointError):
        QuorumNode(ep, d, node_id="n0")

    # legacy flat-mapping format (no embedded sha): the sidecar is the
    # verifier — a mismatch refuses too
    with open(store_path, "w") as f:
        json.dump({"r": {"epoch": 0, "lease_s": 0.5}}, f)
    with pytest.raises(ark.CheckpointError):
        QuorumNode(ep, d, node_id="n0")

    # a legitimate rewrite through the atomic idiom heals it
    store = QuorumStore.__new__(QuorumStore)
    store.path = store_path
    store._lock = threading.Lock()
    store._epochs = {}
    store.advance("r", 7, 0.5)
    n3 = QuorumNode(ep, d, node_id="n0")
    assert n3.store.epoch("r") == 7
    c.close()


def test_store_advance_is_strictly_monotone(tmp_path):
    s = QuorumStore(str(tmp_path), "n0")
    s.advance("r", 3, 1.0)
    with pytest.raises(ValueError):
        s.advance("r", 3, 1.0)
    with pytest.raises(ValueError):
        s.advance("r", 2, 1.0)
    s.advance("r", 4, 2.0)
    # lease_s never shrinks (it sizes the boot blackout)
    s.advance("r", 5, 0.5)
    assert s.lease_s("r") == 2.0


# -- NetPartition ---------------------------------------------------------

def test_net_partition_directional_and_actor_attribution(tmp_path):
    """The chaos primitive itself: a blocked (src actor, dst endpoint)
    pair blackholes requests from that actor only — other actors and
    the anonymous trainer keep flowing; heal() restores traffic."""
    nodes, eps = _group(tmp_path, n=1)
    try:
        blocked = QuorumClient([eps[0]], deadline_s=0.3,
                               actor="10.0.0.1:1")
        free = QuorumClient([eps[0]], deadline_s=2.0, actor="10.0.0.2:1")
        anon = QuorumClient([eps[0]], deadline_s=2.0)
        with ark_chaos.NetPartition(seed=3) as net:
            net.block("10.0.0.1:1", eps[0])
            with pytest.raises(QuorumUnavailable):
                blocked._call_node(eps[0], "q_hello", {})
            assert net.dropped >= 1
            assert free._call_node(eps[0], "q_hello", {})["version"] == 1
            assert anon._call_node(eps[0], "q_hello", {})["version"] == 1
            # wildcard src blocks the anonymous actor too
            net.block("*", eps[0])
            with pytest.raises(QuorumUnavailable):
                anon._call_node(eps[0], "q_hello", {})
            net.heal()
            assert blocked._call_node(eps[0], "q_hello", {})["version"] == 1
        blocked.close()
        free.close()
        anon.close()
    finally:
        for n in nodes:
            n.stop()


def test_net_partition_thread_name_actor_and_exclusivity(tmp_path):
    nodes, eps = _group(tmp_path, n=1)
    try:
        c = QuorumClient([eps[0]], deadline_s=0.3)
        net = ark_chaos.NetPartition().start()
        try:
            # a second hook refuses to stack (ChaosMonkey posture)
            with pytest.raises(RuntimeError):
                ark_chaos.ChaosMonkey(seed=1).start()
            net.block("10.9.9.9:7", eps[0])
            out = []

            def named():
                # the `...@<endpoint>` thread-name convention IS the
                # actor — no acting_as needed
                try:
                    c._call_node_impl(eps[0], "q_hello", {})
                    out.append("ok")
                except QuorumUnavailable:
                    out.append("blocked")

            t = threading.Thread(target=named, name="worker@10.9.9.9:7")
            t.start()
            t.join(timeout=10)
            assert out == ["blocked"]
        finally:
            net.stop()
        c.close()
    finally:
        for n in nodes:
            n.stop()


# -- haven integration ----------------------------------------------------

def _quorum_pair(tmp_path, lease_s=0.5, sub="hq"):
    nodes, qeps = _group(tmp_path, sub=sub)
    backup = ParameterServer("127.0.0.1:0").start()
    backup.start_standby(lease_s=lease_s, quorum_endpoints=qeps,
                         quorum_resource="shard0")
    primary = ParameterServer("127.0.0.1:0").start()
    primary.start_replication(backup.endpoint, lease_s=lease_s,
                              quorum_endpoints=qeps,
                              quorum_resource="shard0")
    return nodes, qeps, primary, backup


def test_pair_only_partition_does_not_promote(tmp_path):
    """THE upgrade over the plain pair: severing just the replication link —
    both members still reach every arbiter — must NOT elect a second
    primary (the backup's campaign is rejected while the primary's
    lease renews), and healing resyncs the pair."""
    nodes, qeps, primary, backup = _quorum_pair(tmp_path)
    c = PSClient([primary.endpoint],
                 replicas={primary.endpoint: [backup.endpoint]},
                 dedup_pushes=True)
    try:
        ep = primary.endpoint
        c.init_param(ep, "w", np.zeros(3, np.float32), "sgd", 1.0, {})
        _wait(lambda: primary._haven.log.lag() == 0, what="ack drain")
        with ark_chaos.NetPartition(seed=5) as net:
            net.isolate(primary.endpoint, backup.endpoint)
            time.sleep(3.0 * 0.5)   # several backup-side lease expiries
            assert primary._haven.role == "primary"
            assert backup._haven.role == "backup"
            # the primary keeps serving writes throughout
            c.push_grad(ep, "w", np.ones(3, np.float32))
            np.testing.assert_allclose(primary._dense["w"], -1.0)
        _wait(lambda: np.allclose(backup._dense["w"], -1.0),
              what="post-heal resync")
    finally:
        c.close()
        primary.stop()
        backup.stop()
        for n in nodes:
            n.stop()


def test_asymmetric_partition_fences_minority_and_promotes_majority(
        tmp_path, observe_on):
    """The tentpole contract in miniature: primary cut from backup AND
    2/3 arbiters -> it fences (stops accepting) then steps down as an
    unsynced standby; the backup (majority side) wins a fenced
    election; the healed node resyncs bit-identically; the acked
    prefix survives; metrics + step-down are recorded."""
    nodes, qeps, primary, backup = _quorum_pair(tmp_path)
    c = PSClient([primary.endpoint],
                 replicas={primary.endpoint: [backup.endpoint]},
                 dedup_pushes=True, failover_s=15.0,
                 quorum_endpoints=qeps,
                 quorum_resources={primary.endpoint: "shard0"})
    try:
        ep = primary.endpoint
        c.init_param(ep, "w", np.zeros(3, np.float32), "sgd", 1.0, {})
        c.push_grad(ep, "w", np.ones(3, np.float32))
        _wait(lambda: primary._haven.log.lag() == 0, what="ack drain")
        pre_acked = primary._haven.log.acked_seq
        net = ark_chaos.NetPartition(seed=5).start()
        try:
            net.isolate(primary.endpoint, backup.endpoint)
            net.block(primary.endpoint, qeps[1])
            net.block(primary.endpoint, qeps[2])
            _wait(lambda: not primary._haven.status()["accepting"],
                  timeout=5.0, what="minority fence")
            _wait(lambda: backup._haven.role == "primary", timeout=10.0,
                  what="majority promotion")
            assert backup._haven.epoch == 2
            _wait(lambda: primary._haven.role == "backup", timeout=10.0,
                  what="minority step-down")
            assert not primary._haven.has_synced
            # the client (quorum-routed) fails the write over
            c.push_grad(ep, "w", np.ones(3, np.float32))
            np.testing.assert_allclose(backup._dense["w"], -2.0)
            assert backup._haven.applied_seq >= pre_acked
        finally:
            net.stop()
        # heal: deposed node rejoins as a resyncing standby
        _wait(lambda: primary._haven.has_synced
              and np.allclose(primary._dense["w"], backup._dense["w"]),
              timeout=15.0, what="healed rejoin resync")
        assert observe_on.get("ps_promotions_total").value(
            kind="quorum") == 1
        assert observe_on.get("ps_step_downs_total").total() >= 1
        grants = observe_on.get("quorum_grants_total")
        assert grants is not None and grants.value(outcome="granted") >= 2
        assert observe_on.get("quorum_lease_epoch").value(
            resource="shard0") == 2.0
    finally:
        c.close()
        primary.stop()
        backup.stop()
        for n in nodes:
            n.stop()


def test_no_quorum_pair_is_unchanged_plain_behavior(observe_on):
    """Satellite pin: a haven pair WITHOUT quorum endpoints takes the
    exact plain-pair code paths — no quorum client, no renewer thread, no
    quorum metrics, lease-expiry promotion as before."""
    backup = ParameterServer("127.0.0.1:0").start()
    backup.start_standby(lease_s=0.5)
    primary = ParameterServer("127.0.0.1:0").start()
    primary.start_replication(backup.endpoint, lease_s=0.5)
    c = PSClient([primary.endpoint],
                 replicas={primary.endpoint: [backup.endpoint]},
                 dedup_pushes=True, failover_s=15.0)
    try:
        assert primary._haven.quorum is None
        assert primary._haven._renewer is None
        assert "quorum" not in primary._haven.status()
        ep = primary.endpoint
        c.init_param(ep, "w", np.zeros(3, np.float32), "sgd", 1.0, {})
        _wait(lambda: primary._haven.log.lag() == 0, what="ack drain")
        ark_chaos.kill_server(primary)
        c.push_grad(ep, "w", np.ones(3, np.float32))
        assert backup._haven.role == "primary"
        np.testing.assert_allclose(backup._dense["w"], -1.0)
        assert observe_on.get("ps_promotions_total").value(
            kind="lease_expiry") == 1
        for m in ("quorum_grants_total", "quorum_lease_epoch",
                  "quorum_lease_ok", "ps_step_downs_total"):
            assert observe_on.get(m) is None, m
    finally:
        c.close()
        primary.stop()
        backup.stop()


def test_bootstrap_campaign_lost_raises(tmp_path):
    """A second would-be primary for the SAME resource cannot arm: its
    bootstrap election loses loudly instead of silently split-braining."""
    nodes, qeps, primary, backup = _quorum_pair(tmp_path)
    rogue_backup = ParameterServer("127.0.0.1:0").start()
    rogue = ParameterServer("127.0.0.1:0").start()
    try:
        with pytest.raises(RuntimeError, match="quorum election lost"):
            rogue.start_replication(rogue_backup.endpoint, lease_s=0.5,
                                    quorum_endpoints=qeps,
                                    quorum_resource="shard0")
    finally:
        rogue.stop()
        rogue_backup.stop()
        primary.stop()
        backup.stop()
        for n in nodes:
            n.stop()


# -- quorum-backed membership ---------------------------------------------

def test_quorum_lease_table_second_opinion(tmp_path):
    """A member whose LOCAL lease lapsed but whose own quorum lease is
    live is neither expired nor dropped from live(); without a quorum
    the table is a plain LeaseTable."""
    nodes, eps = _group(tmp_path)
    qc = QuorumClient(eps)
    try:
        plain = QuorumLeaseTable()           # no quorum: the plain table
        plain.beat("r0", lease_s=0.05)
        time.sleep(0.1)
        assert "r0" in plain.expired() and "r0" not in plain.live()

        table = QuorumLeaseTable(quorum=qc, status_ttl_s=0.05)
        table.beat("r0", lease_s=0.05)
        # the member renews its OWN lease at the arbiters
        member = qc.campaign("member:r0", "r0", lease_s=5.0)
        assert member is not None
        time.sleep(0.1)                      # local lease lapses
        assert "r0" not in table.expired()   # arbiters vouch for it
        # live() is NON-blocking (router dispatch path): the first call
        # may serve the not-yet-probed default while a background probe
        # lands, so poll
        _wait(lambda: "r0" in table.live(), timeout=5.0,
              what="non-blocking live() verdict")
        snap = table.snapshot()
        assert snap["r0"]["quorum_live"] is True
        # once the quorum lease lapses too, the member is expired
        qc.resign(member)
        time.sleep(0.1)                      # status cache ttl
        assert "r0" in table.expired()
    finally:
        qc.close()
        for n in nodes:
            n.stop()


def test_heartbeat_thread_renews_member_quorum_lease(tmp_path):
    nodes, eps = _group(tmp_path)
    qc = QuorumClient(eps)
    beats = []
    hb = HeartbeatThread(beat=lambda: beats.append(1), trainer_id=3,
                         lease_s=1.0, quorum=qc)
    try:
        assert hb.beat_once() == 1
        rec = qc.holder("member:3")
        assert rec and rec["holder"] == "3"
        # subsequent rounds RENEW the same lease (epoch stable)
        assert hb.beat_once() == 1
        assert qc.holder("member:3")["epoch"] == rec["epoch"]
        # arbiters gone: the beat still succeeds (best-effort contract)
        for n in nodes:
            n.stop()
        assert hb.beat_once() == 1
    finally:
        hb.stop()
        qc.close()
        for n in nodes:
            n.stop()


# -- PSClient quorum routing ----------------------------------------------

def test_client_resolves_primary_via_quorum_holder(tmp_path):
    """Failover discovery through the arbiters: the client finds the
    promoted primary even when its replica list does NOT name the
    winner's endpoint (the quorum holder IS the address)."""
    nodes, qeps, primary, backup = _quorum_pair(tmp_path)
    c = PSClient([primary.endpoint], dedup_pushes=True, failover_s=10.0,
                 replicas={primary.endpoint: ["127.0.0.1:1"]},  # stale!
                 quorum_endpoints=qeps,
                 quorum_resources={primary.endpoint: "shard0"})
    try:
        ep = primary.endpoint
        c.init_param(ep, "w", np.zeros(3, np.float32), "sgd", 1.0, {})
        _wait(lambda: primary._haven.log.lag() == 0, what="ack drain")
        ark_chaos.kill_server(primary)
        _wait(lambda: backup._haven.role == "primary", timeout=15.0,
              what="promotion")
        # the configured replica list is a dead end; only the arbiters
        # know the winner
        c.push_grad(ep, "w", np.ones(3, np.float32))
        np.testing.assert_allclose(backup._dense["w"], -1.0)
    finally:
        c.close()
        primary.stop()
        backup.stop()
        for n in nodes:
            n.stop()


# -- observability --------------------------------------------------------

def test_quorum_loss_detector_fires_and_self_clears(observe_on):
    from paddle_tpu_torch.observe import metrics as _metrics
    from paddle_tpu_torch.observe.health import (HealthEngine,
                                                 QuorumLossDetector)

    eng = HealthEngine()
    eng.add_detector(QuorumLossDetector())
    now = time.time()
    eng.evaluate(now)
    assert eng.active_alert("quorum_loss") is None   # no gauge: quiet
    g = _metrics.gauge("quorum_lease_ok", "test")
    g.set(1.0, resource="shard0")
    eng.evaluate(now)
    assert eng.active_alert("quorum_loss") is None
    g.set(0.0, resource="shard0")
    eng.evaluate(now)
    alert = eng.active_alert("quorum_loss")
    assert alert is not None and "shard0" in alert.message
    # self-clears on a successful renew / re-grant
    g.set(1.0, resource="shard0")
    eng.evaluate(now)
    assert eng.active_alert("quorum_loss") is None


def test_renew_failure_sets_lease_ok_gauge(tmp_path, observe_on):
    nodes, eps = _group(tmp_path)
    c = QuorumClient(eps)
    try:
        lease = c.campaign("r", "h", lease_s=5.0)
        assert c.renew(lease)
        assert observe_on.get("quorum_lease_ok").value(resource="r") == 1.0
        for n in nodes[1:]:
            n.stop()
        assert not c.renew(lease)
        assert observe_on.get("quorum_lease_ok").value(resource="r") == 0.0
        unreach = observe_on.get("quorum_arbiter_unreachable_total")
        assert unreach is not None and unreach.total() >= 1
    finally:
        c.close()
        for n in nodes:
            n.stop()


# -- across packages ------------------------------------------------------

def _script(client_mod, eps):
    """One fixed sequence of quorum operations through `client_mod`'s
    client; every reply, with the node-local fields (ids, endpoints,
    clocks) taken out."""
    def clean(rows):
        return sorted(tuple(sorted((k, v) for k, v in r.items()
                                   if k not in ("node_id", "endpoint",
                                                "expires_in_s")))
                      for r in rows)
    out = []
    a = client_mod.QuorumClient(eps, actor="a:1")
    b = client_mod.QuorumClient(eps, actor="b:1")
    try:
        la = a.campaign("r", "holder-a", lease_s=5.0)
        out.append(("campaign-a", la.epoch, la.holder, la.resource))
        out.append(("campaign-b", b.campaign("r", "holder-b", lease_s=5.0)))
        out.append(("renew-a", a.renew(la)))
        out.append(("holder", a.holder("r"), b.holder("r")))
        out.append(("status", clean(b.status("r"))))
        out.append(("hello", sorted(
            v["version"] for v in a._fanout("q_hello", {}).values())))
        a.resign(la)
        lb = b.campaign("r", "holder-b", lease_s=5.0)
        out.append(("campaign-b2", lb.epoch, lb.holder))
        out.append(("renew-a-fenced", a.renew(la)))
        out.append(("epochs", sorted(
            v["epoch"] for v in b._fanout("q_epoch",
                                          {"resource": "r"}).values())))
        out.append(("unknown", sorted(
            str(e) for e in _errors(a, eps))))
    finally:
        a.close()
        b.close()
    return out


def _errors(client, eps):
    errs = []
    for ep in eps:
        try:
            client._call_node(ep, "q_nope", {})
        except RuntimeError as e:
            errs.append(str(e).replace(ep, "EP"))
    return errs


@pytest.mark.parametrize("client_pkg,node_pkg", [
    ("port", "jax"), ("jax", "port"), ("port", "port")])
def test_clients_and_arbiters_interoperate_across_packages(
        tmp_path, client_pkg, node_pkg):
    """The wire is the pserver RPC framing in both packages: the port's
    client against JAX arbiters, the JAX client against the port's, and
    the port against itself give the JAX-against-JAX replies."""
    import paddle_tpu.quorum as jq
    import paddle_tpu_torch.quorum as tq
    pkgs = {"jax": jq, "port": tq}

    def run(cpkg, npkg, sub):
        nodes = [pkgs[npkg].QuorumNode("127.0.0.1:0", str(tmp_path / sub),
                                       node_id=f"n{i}").start()
                 for i in range(3)]
        try:
            return _script(pkgs[cpkg], [n.endpoint for n in nodes])
        finally:
            for n in nodes:
                n.stop()

    ref = run("jax", "jax", "ref")
    got = run(client_pkg, node_pkg, "got")
    assert got == ref
    assert ref[0] == ("campaign-a", 1, "holder-a", "r")
    assert ref[1] == ("campaign-b", None)


def test_both_stores_persist_the_same_bytes(tmp_path):
    """The same advances through both packages' stores leave the same
    epoch file, sidecar aside, and each package loads the other's."""
    import paddle_tpu.quorum as jq
    import paddle_tpu_torch.quorum as tq
    paths = {}
    for name, pkg in (("jax", jq), ("port", tq)):
        st = pkg.QuorumStore(str(tmp_path / name), "n0")
        for r, e, l in (("r", 1, 0.5), ("r", 3, 2.0), ("s", 1, 1.0),
                        ("r", 4, 0.25)):
            st.advance(r, e, l)
        paths[name] = st.path
    raw = {k: open(p, "rb").read() for k, p in paths.items()}
    assert raw["port"] == raw["jax"]
    for mine, other in ((tq, "jax"), (jq, "port")):
        st = mine.QuorumStore(str(tmp_path / other), "n0")
        assert (st.epoch("r"), st.lease_s("r"), st.epoch("s")) == (4, 2.0, 1)
