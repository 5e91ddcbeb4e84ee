#!/usr/bin/env python
"""torch_chaos_drill: run a small paddle_tpu_torch distributed training
job under a named fault scenario and exit nonzero unless recovery
succeeds (tools/chaos_drill.py's scenarios and checks, on the port).

    python tools/torch_chaos_drill.py --scenario pserver_kill [--seed 7] \
        [--cpu]

The trainers' steps run through the port's `Executor` on `CUDAPlace(0)`,
or on the host with `--cpu`; servers, masters and arbiters are host
code; `replica_kill` and `decode_kill` spawn serving replica processes
(tools/torch_fleet_replica.py), on the card unless `--cpu`.

Scenarios (all seed-deterministic through ark.chaos):

    flaky_rpc     connections randomly die and stall under the trainer;
                  PASS = training completes, converges, and the retry
                  counters show the client actually recovered
    quant_flaky_rpc  int8-quantized sync-PS pushes (fluid-wire) under
                  close/truncate/delay chaos with batch retries; PASS =
                  the final params are BIT-IDENTICAL to the no-fault
                  quantized run (replayed frames dedup server-side and
                  the error-feedback residual commits exactly once per
                  logical batch — never double-applied on replay)
    pserver_kill  SIGKILL-equivalent pserver death mid-run; PASS = the
                  restarted server recovers its atomic shard checkpoint
                  and the run finishes inside the no-fault loss band
    ckpt_crash    a crash is injected mid-`save_checkpoint` (the commit
                  rename never happens); PASS = the previous serial
                  loads intact (manifest checksums verify) and a fresh
                  trainer auto-resumes bit-identically
    sync_evict    a sync trainer dies holding a heartbeat lease; PASS =
                  the barrier evicts it in lease-time (not sync_timeout)
                  and the surviving trainer's update applies once
    dist_trace    a REAL 2-process trainer+pserver job (tools/
                  torch_ps_worker.py is the server process) killed by SIGTERM
                  mid-run; PASS = the dead server left BOTH postmortem
                  artifacts (chrome trace + flight-recorder JSON) and
                  the merged timeline links client and server RPC spans
                  under one trace id across the two processes
    health_alerts a live 2-process job with fluid-pulse armed on both
                  sides; a NaN loss and a pserver SIGKILL are injected;
                  PASS = the trainer's /healthz flips to 503/unready
                  with the expected alerts (non_finite_loss,
                  ps_retry_storm) and the flight dump records both
                  alerts with the triggering series' last points
    replica_kill  fluid-fleet: one of three serving replica PROCESSES is
                  SIGKILLed under open-loop router traffic; PASS = zero
                  failed requests (failovers metered; p99 degrades and
                  is recorded), the dead replica's lease expires, and
                  the survivors show zero steady-state recompiles
    decode_kill   fluid-torrent: one of two DECODE replica processes of
                  a disaggregated (1 prefill + 2 decode) fleet is
                  SIGKILLed under concurrent generative traffic; PASS =
                  every generation completes and is TOKEN-IDENTICAL to
                  the solo no-fault reference (pinned sequences fail
                  over via re-prefill; greedy decoding is deterministic
                  so zero completed tokens are lost), torrent failovers
                  metered, every session pin released, and the dead
                  replica's lease expires
    ps_primary_kill  fluid-haven: SIGKILL the PRIMARY of a replicated
                  pserver pair mid-training, under async AND sync PS;
                  PASS = training completes with zero trainer-visible
                  failures, the no-fault replicated run is BIT-IDENTICAL
                  to the unreplicated baseline, final loss lands inside
                  the bounded-loss band, the promotion is metered, and
                  the surviving backup's flight recorder shows the
                  promotion event
    ps_handover   fluid-haven: planned live shard handoff to a fresh
                  standby under continuous training load; PASS = zero
                  failed trainer steps, exactly ONE lease-holder at
                  every sampled instant, exact update continuity across
                  the flip, and the handover promotion metered
    master_kill   fluid-elastic: SIGKILL the PRIMARY data master of a
                  quorum-armed HA pair while consumers stream records;
                  PASS = the standby promotes inside the lease budget,
                  zero consumer-visible failures (stall bounded by the
                  blip), at most ONE task-issuing master at every 5ms
                  sample, every record delivered with exactly-once
                  accounting (single-issue tasks delivered exactly
                  once; duplicates only from failure-budget re-issues)
    master_partition  fluid-elastic: the primary master is cut from its
                  standby and from 2/3 arbiters (it keeps the minority)
                  while consumers reach everyone; PASS = the minority
                  primary fences then steps down (its stale replies are
                  redirects, never mutations), the majority-side standby
                  promotes, consumers follow the quorum holder, at most
                  one issuing master at every sample, exactly-once
                  accounting as in master_kill
    trainer_churn fluid-elastic scale-down AND scale-UP: 3 sync-PS
                  trainers stream master-leased batches; one is killed
                  mid-pass (world degrades 3→2 in lease-time) and a
                  REPLACEMENT with a fresh trainer id is started mid-job
                  (admitted at the next barrier epoch, world 2→3, pulls
                  current params before its first push); PASS = world
                  size observed 3→2→3, every record processed exactly
                  once up to the failure-budget re-issue, final loss in
                  the no-fault band, zero trainer-visible failures
    ps_partition  fluid-quorum: ASYMMETRIC partition of a quorum-armed
                  haven pair under async AND sync PS — the primary is
                  cut from its backup and from a majority of the three
                  arbiters while the backup keeps the majority; PASS =
                  at most one write-acceptor at every 5ms sample, the
                  majority side promotes within the lease budget, the
                  minority primary fences and steps down (epoch-stale
                  writes rejected, not applied), zero trainer-visible
                  failures, bounded loss, and the healed node rejoins
                  as a resyncing standby with zero lost acked updates

`--trace-out DIR` (any scenario): every participating process writes its
chrome trace file into DIR (`trace_<process>.json`) and the drill merges
them into `DIR/merged_trace.json`; the drill FAILS if the merge drops
spans. This is the fluid-xray "one coherent picture of a chaos drill"
artifact — open the merged file in chrome://tracing or perfetto.

`tests/test_torch_tools.py` runs `master_kill`, `master_partition` and
`trainer_churn` once each with `--cpu`, and
`tests/test_torch_fleet_tools.py` runs `replica_kill` and `decode_kill`;
their three-seed sweeps are marked `slow` (`pytest -m slow
tests/test_torch_tools.py tests/test_torch_fleet_tools.py`).
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch import ark, layers  # noqa: E402
from paddle_tpu_torch.ark import chaos  # noqa: E402
from paddle_tpu_torch.observe import metrics as obs_metrics  # noqa: E402
from paddle_tpu_torch.pserver import (AsyncPSTrainer,  # noqa: E402
                                      ParameterServer, PSClient)

#: the trainers' place: the card, unless `--cpu` asks for the host
_ON_CPU = [False]


def _place():
    return fluid.CPUPlace() if _ON_CPU[0] else fluid.CUDAPlace(0)


class DrillFailure(Exception):
    pass


def _check(ok, what):
    status = "ok" if ok else "FAIL"
    print(f"  [{status}] {what}")
    if not ok:
        raise DrillFailure(what)


def _lease_budget_s(lease_s):
    """The time a standby may take to promote: lease expiry + the
    monitor's poll + 2 s of grants."""
    return lease_s + lease_s / 3.0 + 2.0


def _fresh_world(seed, n_servers=2, lr=0.1):
    servers = [ParameterServer("127.0.0.1:0").start()
               for _ in range(n_servers)]
    eps = ",".join(s.endpoint for s in servers)
    tr, loss, batch = _build_world(eps, seed, lr=lr)
    return servers, tr, loss, batch


def _build_world(eps, seed, lr=0.1, sync=False, haven_replicas=None,
                 quorum_endpoints=None, quorum_resources=None):
    """Trainer half of the 2-layer FC world, against endpoints that may
    live in ANOTHER process (the health_alerts drill's
    torch_ps_worker).
    `sync=True` builds the pserver-runtime sync world (SyncPSTrainer);
    `haven_replicas` arms the client's primary re-resolution + tagged
    pushes for the fluid-haven drills; `quorum_endpoints`/`_resources`
    give the client the arbiters' view of who rules a shard
    (fluid-quorum)."""
    from paddle_tpu_torch.pserver import SyncPSTrainer

    np.random.seed(seed)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = layers.data(name="x", shape=[8], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="int64")
        h = layers.fc(input=x, size=16, act="relu")
        logits = layers.fc(input=h, size=2, act=None)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    main.random_seed = startup.random_seed = seed
    cfg = fluid.DistributeTranspilerConfig()
    if sync:
        cfg.runtime = "pserver"
    if haven_replicas:
        cfg.haven_replicas = dict(haven_replicas)
    if quorum_endpoints:
        cfg.quorum_endpoints = list(quorum_endpoints)
        cfg.quorum_resources = dict(quorum_resources or {})
    t = fluid.DistributeTranspiler(cfg)
    t.transpile(trainer_id=0, program=main, pservers=eps, trainers=1,
                sync_mode=sync)
    scope = fluid.Scope()
    exe = fluid.Executor(_place())
    exe.run(startup, scope=scope)
    cls = SyncPSTrainer if sync else AsyncPSTrainer
    tr = cls(t, exe, program=main, scope=scope)
    tr.init_params()
    rng = np.random.RandomState(seed + 1)
    w_true = rng.randn(8, 2).astype(np.float32)

    def batch(n=32):
        xs = rng.randn(n, 8).astype(np.float32)
        ys = (xs @ w_true).argmax(1).astype(np.int64).reshape(n, 1)
        return {"x": xs, "y": ys}

    return tr, loss, batch


def _run_steps(tr, loss, batch, n):
    out = []
    for _ in range(n):
        l, = tr.step(batch(), fetch_list=[loss])
        out.append(float(np.asarray(l).reshape(-1)[0]))
    return out


def drill_flaky_rpc(seed, workdir, trace_out=None):
    fluid.set_flag("observe", True)
    obs_metrics.default_registry().reset()
    servers, tr, loss, batch = _fresh_world(seed)
    try:
        with chaos.ChaosMonkey(seed=seed, p_close=0.06, p_delay=0.06,
                               delay_s=(0.001, 0.02)) as monkey:
            losses = _run_steps(tr, loss, batch, 30)
        _check(monkey.total_injected() > 0,
               f"faults injected ({monkey.injected})")
        _check(np.isfinite(losses).all(), "all losses finite")
        _check(np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.8,
               f"converged {np.mean(losses[:5]):.3f} -> "
               f"{np.mean(losses[-5:]):.3f}")
        retries = obs_metrics.default_registry().get(
            "pserver_client_retries_total")
        _check(retries is not None and retries.total() >= 1,
               f"retries recorded "
               f"({retries.total() if retries else 0:.0f})")
        tr.close()
    finally:
        fluid.set_flag("observe", False)
        for s in servers:
            s.stop()


def drill_pserver_kill(seed, workdir, trace_out=None):
    fluid.set_flag("observe", True)
    obs_metrics.default_registry().reset()
    # no-fault reference band
    servers, tr, loss, batch = _fresh_world(seed)
    try:
        ref = _run_steps(tr, loss, batch, 30)
        tr.close()
    finally:
        for s in servers:
            s.stop()

    servers, tr, loss, batch = _fresh_world(seed)
    try:
        losses = _run_steps(tr, loss, batch, 12)
        ckpt = os.path.join(workdir, "shards")
        tr.save(ckpt)
        for s in servers:
            ark.verify_sidecar(s._shard_path(ckpt))
        print(f"  shards checkpointed to {ckpt} (manifests verified)")

        victim = chaos.kill_server(servers[1])
        print(f"  killed pserver {victim} mid-epoch")
        time.sleep(0.1)
        servers[1] = chaos.restart_server(victim, recover_dir=ckpt)
        print(f"  restarted {victim}, shard recovered")

        losses += _run_steps(tr, loss, batch, 18)
        _check(np.isfinite(losses).all(), "all losses finite")
        band = np.mean(ref[-6:]) * 1.25 + 0.05
        _check(np.mean(losses[-6:]) < band,
               f"final loss {np.mean(losses[-6:]):.4f} within no-fault "
               f"band (<{band:.4f})")
        retries = obs_metrics.default_registry().get(
            "pserver_client_retries_total")
        print(f"  client retries: "
              f"{retries.total() if retries else 0:.0f}")
        tr.close()
    finally:
        fluid.set_flag("observe", False)
        for s in servers:
            s.stop()


def drill_ckpt_crash(seed, workdir, trace_out=None):
    d = os.path.join(workdir, "ck")
    arrays = {"w": np.arange(12, dtype=np.float32)}
    ark.save_checkpoint(d, arrays, cursor={"step_id": 1},
                        rng={"train_runs": 1})
    good = ark.latest_checkpoint(d)

    # crash inside the save, after files are staged but before commit
    class Crash(Exception):
        pass

    def dying_shard_saver(stage):
        with open(os.path.join(stage, "shard.bin"), "wb") as f:
            f.write(b"half-written shard")
        raise Crash("process died mid-save")

    try:
        ark.save_checkpoint(d, {"w": arrays["w"] * 2},
                            cursor={"step_id": 2},
                            shard_saver=dying_shard_saver)
    except Crash:
        print("  crash injected mid-save_checkpoint")
    _check(ark.latest_checkpoint(d) == good,
           "previous serial is still the newest committed one")
    ark.verify_checkpoint(good)
    print("  previous serial verifies (manifest checksums)")
    got, manifest = ark.load_checkpoint(good)
    _check(np.array_equal(got["w"], arrays["w"]) and
           manifest["cursor"]["step_id"] == 1,
           "previous checkpoint loads intact")


def drill_sync_evict(seed, workdir, trace_out=None):
    fluid.set_flag("observe", True)
    obs_metrics.default_registry().reset()
    srv = ParameterServer("127.0.0.1:0", trainers=2,
                          sync_timeout=120.0).start()
    ep = srv.endpoint
    c = PSClient([ep])
    try:
        c.init_param(ep, "w", np.zeros(3, np.float32), "sgd", 1.0, {})
        c.heartbeat(ep, trainer_id=1, session="doomed", lease_s=0.5)
        print("  trainer 1 held a 0.5s lease, then died")
        time.sleep(0.8)
        c.push_grads_sync({ep: {"w": np.full(3, 2.0, np.float32)}},
                          batch_id=0, trainer_id=0, session="alive")
        t0 = time.monotonic()
        c.sync_apply([ep])
        dt = time.monotonic() - t0
        _check(dt < 10.0, f"barrier released in {dt:.2f}s "
                          f"(sync_timeout=120s)")
        _check(np.allclose(c.get_param(ep, "w"), -2.0),
               "survivor's update applied once, averaged over live world")
        evicted = obs_metrics.default_registry().get(
            "pserver_trainers_evicted_total")
        _check(evicted is not None and evicted.total() == 1,
               "eviction metered")
        c.close()
    finally:
        fluid.set_flag("observe", False)
        srv.stop()


def drill_quant_flaky_rpc(seed, workdir, trace_out=None):
    """fluid-wire: truncated/retried QUANTIZED frames recover BIT-SAFELY.

    Two sync-PS runs push the same int8-quantized gradient sequence with
    error feedback — one clean, one under chaos (close / truncate-mid-
    frame / delay) with caller-level batch retries. The final server
    params must be BIT-IDENTICAL: transport retries resend the same
    encoded bytes, the server dedups replayed batches by (trainer,
    batch, session), and the client's error-feedback residual commits
    exactly once per logical batch (a replay never double-applies it)."""
    from paddle_tpu_torch.wire import ENCODED_BYTES_METRIC, RAW_BYTES_METRIC

    fluid.set_flag("observe", True)
    obs_metrics.default_registry().reset()
    STEPS = 25
    rng = np.random.RandomState(seed)
    # odd length: the last int8 chunk is partial, so the padded tail of
    # the codec is exercised on every frame
    grads = [(rng.randn(257) * 0.1).astype(np.float32)
             for _ in range(STEPS)]

    def run(monkey=None):
        srv = ParameterServer("127.0.0.1:0", trainers=1).start()
        try:
            c = PSClient([srv.endpoint], comm_quant="int8")
            c.init_param(srv.endpoint, "w", np.zeros(257, np.float32),
                         "sgd", lr=0.5, attrs={})
            retried = 0
            # Negotiate wire_caps BEFORE chaos starts: the lazy one-shot
            # negotiation inside the first push would otherwise run under
            # fault injection, and an exhausted-retry ConnectionError
            # caches raw for the endpoint — the whole run would push
            # float32 and fail the bit-identity check for a reason
            # unrelated to the replay contract this drill proves.
            if c._codec_for(srv.endpoint) != "int8":
                raise DrillFailure("wire_caps negotiation did not land "
                                   "on int8 before chaos")
            if monkey is not None:
                monkey.start()
            try:
                for i, g in enumerate(grads):
                    for _ in range(30):
                        try:
                            c.push_grads_sync(
                                {srv.endpoint: {"w": g}}, batch_id=i,
                                trainer_id=0, session="drill")
                            c.sync_apply([srv.endpoint])
                            break
                        except (RuntimeError, ConnectionError, OSError,
                                EOFError):
                            retried += 1
                    else:
                        raise DrillFailure(f"batch {i} never applied")
            finally:
                if monkey is not None:
                    monkey.stop()
            final = np.array(c.get_param(srv.endpoint, "w"))
            c.close()
            return final, retried
        finally:
            srv.stop()

    try:
        ref, _ = run()
        print(f"  no-fault quantized run complete ({STEPS} batches)")
        reg = obs_metrics.default_registry()
        raw = reg.get(RAW_BYTES_METRIC).value(cmd="push_grads_sync")
        enc = reg.get(ENCODED_BYTES_METRIC).value(cmd="push_grads_sync")
        _check(enc < 0.5 * raw,
               f"quantized frames on the wire ({raw:.0f} -> {enc:.0f} "
               f"bytes, {raw / enc:.2f}x)")

        monkey = chaos.ChaosMonkey(seed=seed, p_close=0.05,
                                   p_truncate=0.05, p_delay=0.05,
                                   delay_s=(0.001, 0.01))
        got, retried = run(monkey)
        _check(monkey.total_injected() > 0,
               f"faults injected ({monkey.injected})")
        _check(monkey.injected["truncate"] + monkey.injected["close"] > 0,
               "at least one frame died mid-flight")
        retries = obs_metrics.default_registry().get(
            "pserver_client_retries_total")
        transport_retries = retries.total() if retries else 0
        _check(transport_retries + retried >= 1,
               f"frames actually replayed (transport retries "
               f"{transport_retries:.0f}, batch retries {retried})")
        _check(np.array_equal(got, ref),
               "chaos run BIT-IDENTICAL to the no-fault quantized run "
               "(error-feedback residual never double-applied on replay)")
    finally:
        fluid.set_flag("observe", False)


def drill_dist_trace(seed, workdir, trace_out=None):
    """2-process trainer+pserver job under SIGTERM (fluid-xray)."""
    import json
    import signal
    import subprocess

    from paddle_tpu_torch.observe import xray

    out = trace_out or workdir
    os.makedirs(out, exist_ok=True)
    fluid.set_flag("observe", True)
    obs_metrics.default_registry().reset()
    xray.set_process_name("trainer0")
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_ps_worker.py")
    proc = subprocess.Popen(
        [sys.executable, worker, "--name", "pserver0", "--out", out],
        stdout=subprocess.PIPE, text=True)
    client = None
    try:
        line = (proc.stdout.readline() or "").strip()
        _check(line.startswith("ENDPOINT "), f"server process up ({line})")
        ep = line.split()[1]
        client = PSClient([ep])
        client.init_param(ep, "w", np.zeros(4, np.float32), "sgd", 0.1, {})
        for _ in range(3):
            client.push_grad(ep, "w", np.full(4, 0.1, np.float32))
        client.heartbeat(ep, trainer_id=0, session="drill")
        got = client.get_param(ep, "w")
        _check(np.isfinite(np.asarray(got)).all(),
               "RPCs served across processes")

        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        print(f"  SIGTERM'd pserver process (rc={rc})")
        # the dying server must have left BOTH artifacts
        _check(os.path.exists(os.path.join(out, "trace_pserver0.json")),
               "server chrome trace dumped on SIGTERM")
        fr_path = os.path.join(out, "flight_pserver0.json")
        _check(os.path.exists(fr_path), "server flight recorder dumped")
        with open(fr_path) as f:
            fr = json.load(f)
        _check(str(fr.get("reason", "")).startswith("signal"),
               f"flight dump names the killer ({fr.get('reason')})")
        _check(any(e.get("kind") == "signal" for e in fr["events"]),
               "flight ring recorded the TERM")
        # one post-kill call: its retries put fail_connect attempt spans
        # (same trace id, distinct span ids) on the trainer timeline
        try:
            client.get_param(ep, "w")
        except Exception:
            pass
    finally:
        if client is not None:
            client.close()
        if proc.poll() is None:
            proc.kill()
        fluid.set_flag("observe", False)


def drill_health_alerts(seed, workdir, trace_out=None):
    """fluid-pulse: a live 2-process job whose health plane must catch a
    NaN loss and a pserver death WHILE RUNNING — before any postmortem.

    A real trainer (this process, pulse armed) drives a real
    torch_ps_worker subprocess (pulse armed too). PASS requires: both /healthz
    endpoints answer ok pre-fault; injecting a NaN batch flips the
    trainer's /healthz to HTTP 503/unready with a `non_finite_loss`
    alert; SIGKILLing the pserver raises a `ps_retry_storm` alert; and
    the trainer's flight-recorder dump carries both alert records with
    the last points of the triggering series — the endpoint and the
    black box agree on why health went red."""
    import json
    import subprocess
    import urllib.error
    import urllib.request

    from paddle_tpu_torch.observe import flight, health, pulse

    def get(port, path):
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    fluid.set_flag("observe", True)
    obs_metrics.default_registry().reset()
    health.reset()
    local_port = pulse.start_pulse(0)
    print(f"  trainer pulse on port {local_port}")
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_ps_worker.py")
    proc = subprocess.Popen(
        [sys.executable, worker, "--name", "pserver0", "--out", workdir,
         "--pulse-port", "0"],
        stdout=subprocess.PIPE, text=True)
    tr = None
    try:
        line = (proc.stdout.readline() or "").strip()
        _check(line.startswith("ENDPOINT "), f"server process up ({line})")
        ep = line.split()[1]
        line = (proc.stdout.readline() or "").strip()
        _check(line.startswith("PULSE "), f"server pulse up ({line})")
        srv_pulse = int(line.split()[1])
        code, doc = get(srv_pulse, "/healthz")
        _check(code == 200 and doc["status"] == "ok",
               f"server /healthz ok pre-fault "
               f"(checks: {sorted(doc['checks'])})")

        tr, loss, batch = _build_world(ep, seed)
        losses = _run_steps(tr, loss, batch, 8)
        _check(np.isfinite(losses).all(), "8 healthy steps against the "
               "remote pserver")
        code, doc = get(local_port, "/healthz")
        _check(code == 200 and doc["status"] == "ok",
               "trainer /healthz ok pre-fault")

        bad = batch()
        bad["x"][:] = np.nan
        tr.step(bad, fetch_list=[loss])
        code, doc = get(local_port, "/healthz")
        rules = {a["rule"] for a in doc["alerts"]}
        _check(code == 503 and doc["status"] == "unready",
               f"/healthz flipped unready on the NaN loss (HTTP {code})")
        _check("non_finite_loss" in rules,
               f"non-finite alert fired ({sorted(rules)})")

        proc.kill()
        proc.wait(timeout=30)
        print("  SIGKILL'd the pserver process mid-run")
        for _ in range(3):
            try:
                tr.step(batch(), fetch_list=[loss])
            except Exception:
                pass   # retries against the corpse are the point
        code, doc = get(local_port, "/healthz")
        rules = {a["rule"] for a in doc["alerts"]}
        _check("ps_retry_storm" in rules,
               f"retry-storm alert fired ({sorted(rules)})")
        _check(code == 503, "trainer /healthz still unready")

        fp = flight.dump(os.path.join(workdir, "flight_trainer0.json"),
                         reason="health_alerts drill")
        with open(fp) as f:
            fr = json.load(f)
        alert_evs = [e for e in fr["events"] if e.get("kind") == "alert"]
        got = {e["rule"] for e in alert_evs}
        _check({"non_finite_loss", "ps_retry_storm"} <= got,
               f"flight ring recorded both alerts ({sorted(got)})")
        _check(any(e.get("points") for e in alert_evs),
               "alert records carry the triggering series' last points")
        _check("memory" in fr, "flight dump carries the memory section")
    finally:
        if tr is not None:
            try:
                tr.close()
            except Exception:
                pass
        if proc.poll() is None:
            proc.kill()
        pulse.stop_pulse()
        health.reset()
        fluid.set_flag("observe", False)


def _await_fresh_empty_poll(router, rid, model, timeout_s=60.0):
    """Block until the router's next readiness poll of `rid` finds it
    ready with an empty `model` queue (depth 0, the least any member can
    have). That poll renewed its lease; a kill right after it leaves the
    replica in dispatch for a whole lease."""
    m = router._members[rid]
    seen = m.last_poll
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        time.sleep(0.002)
        if m.last_poll == seen:
            continue
        seen = m.last_poll
        d = m.models.get(model) or {}
        if m.ready and not m.suspect and not d.get("depth"):
            return
    raise DrillFailure(f"no poll found {rid} ready with an empty queue "
                       f"in {timeout_s:.0f} s")


def _await_pinned(router, rid, timeout_s=60.0):
    """Block until a generation is pinned to decode replica `rid`: a
    kill then lands on a session whose tokens it still owes."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with router._lock:
            if any(p[0] == rid for p in router._affinity.values()):
                return
        time.sleep(0.001)
    raise DrillFailure(f"no generation was pinned to {rid} in "
                       f"{timeout_s:.0f} s")


def drill_replica_kill(seed, workdir, trace_out=None):
    """fluid-fleet: SIGKILL one of three serving replicas mid-traffic.

    PASS requires: zero FAILED requests (the kill's in-flight and
    subsequent dispatches fail over to live replicas — availability is
    preserved, p99 degrades and is recorded), router failovers metered,
    the dead replica's membership lease expires (it stops renewing),
    and the survivors keep serving with zero steady-state recompiles.
    Emits a JSON line (fleet_p99_pre_kill_us / fleet_p99_post_kill_us /
    fleet_kill_failed)."""
    import json
    import random
    import signal
    import threading

    from paddle_tpu_torch import fleet
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_fleet_router import spawn_replicas
    from torch_serve_loadgen import build_and_save

    fluid.set_flag("observe", True)
    obs_metrics.default_registry().reset()
    mdir = os.path.join(workdir, "model")
    build_and_save(fluid, np, mdir)
    # poll_interval 2.0, twice the lease: after the kill below only the
    # lease (1 s) can take the victim out of dispatch, so it is still
    # marked ready when the post-kill burst lands (the failover path,
    # not the poller, must be what saves those requests)
    router = fleet.FleetRouter(fleet.RouterConfig(
        lease_s=1.0, poll_interval_s=2.0)).start()
    workers = []
    try:
        workers = spawn_replicas(3, mdir, router.control_endpoint,
                                 device_ms=2.0, lease_s=1.0,
                                 cpu=_ON_CPU[0])
        deadline = time.time() + 60
        while len(router.ready_members("m")) < 3:
            if time.time() > deadline:
                raise DrillFailure("fleet never became ready")
            time.sleep(0.1)
        print("  3 replica processes ready behind the router")

        DURATION, QPS, THREADS = 6.0, 90.0, 6
        stop = threading.Event()
        lock = threading.Lock()
        failures, rejected, lats = [], [0], []   # (t, us)
        kill_at = [None]

        def client(tid):
            r = random.Random(seed * 100 + tid)
            lam = QPS / THREADS
            nxt = time.perf_counter()
            while not stop.is_set():
                nxt += r.expovariate(lam)
                d = nxt - time.perf_counter()
                if d > 0:
                    time.sleep(d)
                t0 = time.perf_counter()
                feed = {"x": np.random.randn(
                    r.randint(1, 4), 16).astype(np.float32)}
                try:
                    router.infer("m", feed)
                except Exception as e:      # noqa: BLE001
                    with lock:
                        if getattr(e, "retriable", False):
                            rejected[0] += 1
                        else:
                            failures.append(repr(e))
                    continue
                with lock:
                    lats.append((time.perf_counter(),
                                 (time.perf_counter() - t0) * 1e6))

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(DURATION / 2)
        victim = workers[1]
        _await_fresh_empty_poll(router, "r1", "m")
        kill_at[0] = time.perf_counter()
        victim.send_signal(signal.SIGKILL)
        print("  SIGKILL'd replica r1 mid-traffic")
        # deterministic failover exposure: the kill came right after a
        # poll that renewed r1's lease and found its queue empty, so for
        # a lease r1 is ready and the least loaded (ties go round-robin):
        # among this burst's first picks some land on the corpse, and
        # per-request failover, not the poller, must save them
        for _ in range(30):
            t_b = time.perf_counter()
            try:
                router.infer("m", {"x": np.random.randn(
                    2, 16).astype(np.float32)})
            except Exception as e:      # noqa: BLE001
                with lock:
                    if getattr(e, "retriable", False):
                        rejected[0] += 1
                    else:
                        failures.append(repr(e))
                continue
            with lock:
                lats.append((time.perf_counter(),
                             (time.perf_counter() - t_b) * 1e6))
        victim.wait(timeout=10)
        time.sleep(DURATION / 2)
        stop.set()
        for t in threads:
            t.join(timeout=20)

        def p99(window):
            vals = sorted(us for t, us in window)
            return vals[min(len(vals) - 1,
                            int(0.99 * len(vals)))] if vals else 0.0

        pre = [(t, us) for t, us in lats if t < kill_at[0]]
        post = [(t, us) for t, us in lats if t >= kill_at[0]]
        _check(not failures,
               f"zero failed requests across the kill "
               f"({len(lats)} served, first failure: "
               f"{failures[0] if failures else None})")
        _check(len(post) > 0, f"traffic kept flowing after the kill "
                              f"({len(post)} post-kill responses)")
        fo = obs_metrics.default_registry().get("fleet_failovers_total")
        _check(fo is not None and fo.total() >= 1,
               f"failovers metered ({fo.total() if fo else 0:.0f})")
        time.sleep(2.5)   # > 2 lease periods
        mem = router.members()
        _check("r1" not in mem or not mem["r1"]["lease_live"],
               "dead replica's membership lease expired")
        recompiles = 0
        for rid in ("r0", "r2"):
            st = fleet.wire.call(router._members[rid].pool,
                                 "fleet_stats", {}, deadline_s=10.0)
            recompiles += int(st.get("unexpected_recompiles", 0))
        _check(recompiles == 0,
               "zero steady-state recompiles on the survivors")
        out = {
            "fleet_kill_failed": len(failures),
            "fleet_kill_rejected": rejected[0],
            "fleet_p99_pre_kill_us": round(p99(pre), 1),
            "fleet_p99_post_kill_us": round(p99(post), 1),
            "fleet_kill_requests_ok": len(lats),
            "fleet_kill_failovers": fo.total() if fo else 0,
        }
        print(json.dumps(out))
        print(f"  p99 {out['fleet_p99_pre_kill_us']:.0f} us pre-kill -> "
              f"{out['fleet_p99_post_kill_us']:.0f} us post-kill "
              f"(degraded, never failed)")
    finally:
        for w in workers:
            if w.poll() is None:
                w.terminate()
        for w in workers:
            try:
                w.wait(timeout=10)
            except Exception:
                w.kill()
        router.close()
        fluid.set_flag("observe", False)


def drill_decode_kill(seed, workdir, trace_out=None):
    """fluid-torrent: SIGKILL a decode replica of a disaggregated fleet
    mid-generation (see module docstring)."""
    import json
    import random
    import signal
    import threading

    from paddle_tpu_torch import fleet, serve
    from paddle_tpu_torch.models import tiny_lm
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_fleet_router import spawn_replicas

    fluid.set_flag("observe", True)
    obs_metrics.default_registry().reset()
    mdir = os.path.join(workdir, "model")
    tiny_lm.save_tiny_lm(mdir, kv_dtype="int8", max_slots=4,
                         block_size=4, max_context=32,
                         prefill_rows=(1, 2), prefill_seq_rungs=(8, 16))

    rng = random.Random(seed)
    prompts = [[rng.randrange(32) for _ in range(rng.randint(1, 7))]
               for _ in range(10)]
    MAX_NEW = 10

    # solo no-fault reference: the token sequences every disaggregated
    # generation must reproduce EXACTLY, kill or no kill
    solo = serve.InferenceServer(_place(), serve.ServeConfig())
    solo.add_model("m", mdir)
    ref = {i: solo.generate("m", p, max_new_tokens=MAX_NEW).tokens
           for i, p in enumerate(prompts)}
    solo.close()
    print(f"  solo reference computed ({len(ref)} prompts)")

    router = fleet.FleetRouter(fleet.RouterConfig(
        lease_s=1.0, poll_interval_s=0.5)).start()
    workers = []
    try:
        # 1 prefill + 2 decode; the decode pool simulates memory-bound
        # device time per step so generations are in flight long enough
        # for the SIGKILL to land mid-decode
        workers += spawn_replicas(
            1, mdir, router.control_endpoint, rid_prefix="p",
            lease_s=1.0, extra_args=("--role", "prefill"),
            cpu=_ON_CPU[0])
        workers += spawn_replicas(
            2, mdir, router.control_endpoint, rid_prefix="d",
            lease_s=1.0, extra_args=("--role", "decode",
                                     "--sim-decode-step-us", "20000"),
            cpu=_ON_CPU[0])
        deadline = time.time() + 120
        while len(router.ready_members("m")) < 3:
            if time.time() > deadline:
                raise DrillFailure("fleet never became ready")
            time.sleep(0.1)
        print("  1 prefill + 2 decode replica processes ready")

        DURATION, THREADS = 8.0, 4
        stop = threading.Event()
        lock = threading.Lock()
        results, failures = [], []   # (prompt_idx, tokens), repr(e)
        kill_at = [None]

        def client(tid):
            r = random.Random(seed * 100 + tid)
            while not stop.is_set():
                i = r.randrange(len(prompts))
                try:
                    res = router.generate_torrent(
                        "m", prompts[i], max_new_tokens=MAX_NEW)
                except Exception as e:      # noqa: BLE001
                    with lock:
                        failures.append(repr(e))
                    continue
                with lock:
                    results.append((i, res.tokens,
                                    kill_at[0] is not None))

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(THREADS)]
        for t in threads:
            t.start()
        time.sleep(DURATION / 2)
        victim = workers[1]          # first decode replica (d0)
        _await_pinned(router, "d0")
        kill_at[0] = time.perf_counter()
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=10)
        print("  SIGKILL'd decode replica d0 mid-generation")
        time.sleep(DURATION / 2)
        stop.set()
        for t in threads:
            t.join(timeout=60)

        post = [x for x in results if x[2]]
        _check(not failures,
               f"every generation completed across the kill "
               f"({len(results)} ok, first failure: "
               f"{failures[0] if failures else None})")
        _check(len(post) > 0,
               f"traffic kept flowing after the kill ({len(post)} "
               f"post-kill generations)")
        bad = [(i, toks) for i, toks, _ in results if toks != ref[i]]
        _check(not bad,
               f"zero lost completed tokens: all {len(results)} "
               f"generations token-identical to the solo reference "
               f"(first divergence: {bad[0] if bad else None})")
        reg = obs_metrics.default_registry()
        fo = reg.get("torrent_failovers_total")
        _check(fo is not None and fo.total() >= 1,
               f"torrent failovers metered "
               f"({fo.total() if fo else 0:.0f})")
        pins = reg.get("fleet_affinity_sessions")
        _check(pins is not None and pins.value() == 0.0,
               "every session pin released")
        time.sleep(2.5)   # > 2 lease periods
        mem = router.members()
        _check("d0" not in mem or not mem["d0"]["lease_live"],
               "dead decode replica's membership lease expired")

        out = {
            "decode_kill_failed": len(failures),
            "decode_kill_generations_ok": len(results),
            "decode_kill_post_kill_ok": len(post),
            "decode_kill_failovers": fo.total() if fo else 0,
            "decode_kill_divergent": len(bad),
        }
        print(json.dumps(out))
    finally:
        for w in workers:
            if w.poll() is None:
                w.terminate()
        for w in workers:
            try:
                w.wait(timeout=10)
            except Exception:
                w.kill()
        router.close()
        fluid.set_flag("observe", False)


def _haven_pair(lease_s=1.0, auto_promote=True):
    from paddle_tpu_torch.pserver import ParameterServer

    backup = ParameterServer("127.0.0.1:0").start()
    backup.start_standby(lease_s=lease_s, auto_promote=auto_promote)
    primary = ParameterServer("127.0.0.1:0").start()
    primary.start_replication(backup.endpoint, lease_s=lease_s)
    return primary, backup


def _final_params(tr):
    return {p: np.array(tr.client.get_param(spec["endpoint"], p))
            for p, spec in tr.t.param_specs.items()}


def drill_ps_primary_kill(seed, workdir, trace_out=None):
    """fluid-haven: SIGKILL the PRIMARY of a replicated pserver pair
    mid-training, under async and sync PS (see module docstring)."""
    from paddle_tpu_torch.observe import flight as obs_flight

    N1, N2 = 10, 14
    for mode in ("async", "sync"):
        sync = mode == "sync"
        fluid.set_flag("observe", True)
        obs_metrics.default_registry().reset()

        # 1) unreplicated baseline: the loss band AND the bit-identity
        # reference for the no-fault replicated run
        from paddle_tpu_torch.pserver import ParameterServer
        solo = ParameterServer("127.0.0.1:0").start()
        try:
            tr, loss, batch = _build_world(solo.endpoint, seed, sync=sync)
            ref = _run_steps(tr, loss, batch, N1 + N2)
            ref_params = _final_params(tr)
            tr.close()
        finally:
            solo.stop()

        # 2) replicated, no fault: replication must be PASSIVE —
        # bit-identical to the unreplicated baseline
        primary, backup = _haven_pair(lease_s=1.0)
        try:
            tr, loss, batch = _build_world(
                primary.endpoint, seed, sync=sync,
                haven_replicas={primary.endpoint: [backup.endpoint]})
            clean = _run_steps(tr, loss, batch, N1 + N2)
            _check(clean == ref,
                   f"[{mode}] no-fault replicated losses bit-identical "
                   f"to unreplicated baseline")
            got = _final_params(tr)
            _check(all(np.array_equal(got[p], ref_params[p])
                       for p in ref_params),
                   f"[{mode}] no-fault replicated params bit-identical")
            tr.close()
        finally:
            primary.stop()
            backup.stop()

        # 3) replicated + SIGKILL'd primary mid-run
        obs_metrics.default_registry().reset()
        primary, backup = _haven_pair(lease_s=1.0)
        try:
            tr, loss, batch = _build_world(
                primary.endpoint, seed, sync=sync,
                haven_replicas={primary.endpoint: [backup.endpoint]})
            losses = _run_steps(tr, loss, batch, N1)
            victim = chaos.kill_server(primary)
            print(f"  [{mode}] SIGKILL'd primary {victim} at step {N1}")
            t0 = time.monotonic()
            losses += _run_steps(tr, loss, batch, N2)   # raises = FAIL
            print(f"  [{mode}] {N2} post-kill steps completed "
                  f"(first blip absorbed in {time.monotonic() - t0:.1f}s "
                  f"of tail)")
            _check(np.isfinite(losses).all(),
                   f"[{mode}] all losses finite, zero trainer-visible "
                   f"failures")
            band = np.mean(ref[-6:]) * 1.25 + 0.05
            _check(np.mean(losses[-6:]) < band,
                   f"[{mode}] final loss {np.mean(losses[-6:]):.4f} "
                   f"inside the bounded-loss band (<{band:.4f})")
            _check(backup._haven.role == "primary",
                   f"[{mode}] backup promoted itself (epoch "
                   f"{backup._haven.epoch})")
            promoted = obs_metrics.default_registry().get(
                "ps_promotions_total")
            _check(promoted is not None and promoted.total() >= 1,
                   f"[{mode}] promotion metered")
            promos = obs_flight.get_flight().events("haven_promotion")
            _check(any(e.get("endpoint") == backup.endpoint
                       for e in promos),
                   f"[{mode}] surviving backup's flight recorder shows "
                   f"the promotion event")
            fo = obs_metrics.default_registry().get(
                "pserver_client_primary_failovers_total")
            print(f"  [{mode}] client primary failovers: "
                  f"{fo.total() if fo else 0:.0f}")
            tr.close()
        finally:
            fluid.set_flag("observe", False)
            primary.stop()
            backup.stop()


def drill_ps_partition(seed, workdir, trace_out=None):
    """fluid-quorum: ASYMMETRIC network partition of a quorum-armed
    haven pair, under async AND sync PS.

    The partition isolates the primary from its backup AND from a
    majority of the 3 arbiters (it keeps exactly one — the minority
    side), while the backup reaches the majority and the trainer
    reaches everyone — the scenario the crash-stop model could not
    survive. PASS requires, per PS mode:

      * at most ONE write-acceptor at every 5ms-grain sample across the
        whole drill (the fenced minority primary holds, never acks);
      * the majority side promotes within the lease budget and the
        minority primary steps down (its later epoch-stale write is
        REJECTED with a redirect, not applied);
      * zero trainer-visible step failures and a final loss inside the
        no-fault band;
      * healing rejoins the deposed node as a resyncing standby,
        bit-identical to the new primary, with zero lost acked updates
        (the backup's pre-partition ack watermark survives);
      * the promotion is metered (kind="quorum") and the grant /
        step-down evidence is in the metrics + flight recorder.
    """
    import threading

    from paddle_tpu_torch.observe import flight as obs_flight
    from paddle_tpu_torch.pserver import ParameterServer
    from paddle_tpu_torch.quorum import QuorumNode

    LEASE = 1.0
    N_BASE = 14
    for mode in ("async", "sync"):
        sync = mode == "sync"
        fluid.set_flag("observe", True)
        obs_metrics.default_registry().reset()

        # no-fault baseline: the loss band reference
        solo = ParameterServer("127.0.0.1:0").start()
        try:
            tr, loss, batch = _build_world(solo.endpoint, seed, sync=sync)
            ref = _run_steps(tr, loss, batch, N_BASE)
            tr.close()
        finally:
            solo.stop()

        qdir = os.path.join(workdir, f"quorum_{mode}")
        nodes, servers = [], []
        net, tr = None, None
        stop = threading.Event()
        try:
            # everything that can fail to start lives INSIDE the try:
            # a raised start (e.g. a lost bootstrap election) must not
            # leak arbiter threads/servers into the rest of the CI run
            nodes = [QuorumNode("127.0.0.1:0", qdir,
                                node_id=f"n{i}").start()
                     for i in range(3)]
            qeps = [n.endpoint for n in nodes]
            backup = ParameterServer("127.0.0.1:0").start()
            servers.append(backup)
            backup.start_standby(lease_s=LEASE, quorum_endpoints=qeps,
                                 quorum_resource="shard0")
            primary = ParameterServer("127.0.0.1:0").start()
            servers.append(primary)
            primary.start_replication(backup.endpoint, lease_s=LEASE,
                                      quorum_endpoints=qeps,
                                      quorum_resource="shard0")
            servers = [primary, backup]
            tr, loss, batch = _build_world(
                primary.endpoint, seed, sync=sync,
                haven_replicas={primary.endpoint: [backup.endpoint]},
                quorum_endpoints=qeps,
                quorum_resources={primary.endpoint: "shard0"})
            losses, failures = [], []

            def train_loop():
                while not stop.is_set():
                    try:
                        l, = tr.step(batch(), fetch_list=[loss])
                        losses.append(float(np.asarray(l).reshape(-1)[0]))
                    except Exception as e:          # noqa: BLE001
                        failures.append(repr(e))

            # 5ms write-acceptance sampler over BOTH members: fenced or
            # held primaries report accepting=False, so the invariant
            # is at most one True at every sample
            violations = []

            def sample_acceptors():
                while not stop.is_set():
                    acc = [s._haven.status()["accepting"] for s in servers]
                    if sum(acc) > 1:
                        violations.append(list(acc))
                    time.sleep(0.005)

            # flight-ring collector: the bounded ring holds <1s of
            # history at this step rate, so the promotion/step-down
            # evidence is harvested continuously instead of at the end
            seen_events = {"haven_promotion": [], "haven_step_down": []}

            def collect_flight():
                while not stop.is_set():
                    for k, acc_l in seen_events.items():
                        for e in obs_flight.get_flight().events(k):
                            if e not in acc_l:
                                acc_l.append(e)
                    time.sleep(0.05)

            t_train = threading.Thread(target=train_loop, daemon=True)
            t_samp = threading.Thread(target=sample_acceptors, daemon=True)
            t_coll = threading.Thread(target=collect_flight, daemon=True)
            t_train.start()
            t_samp.start()
            t_coll.start()
            time.sleep(1.2)
            pre_steps = len(losses)
            _check(pre_steps > 0, f"[{mode}] healthy steps before the "
                                  f"partition ({pre_steps})")
            pre_acked = primary._haven.log.acked_seq

            # the asymmetric cut: pair severed; primary keeps ONE
            # arbiter (minority), backup keeps all three (majority);
            # the trainer reaches everyone
            net = chaos.NetPartition(seed=seed).start()
            net.isolate(primary.endpoint, backup.endpoint)
            net.block(primary.endpoint, qeps[1])
            net.block(primary.endpoint, qeps[2])
            print(f"  [{mode}] partition up: primary sees 1/3 arbiters, "
                  f"backup sees 3/3, pair severed")

            budget_s = _lease_budget_s(LEASE)
            t0 = time.monotonic()
            while backup._haven.role != "primary":
                if time.monotonic() - t0 > budget_s + 5.0:
                    raise DrillFailure(
                        f"[{mode}] backup never promoted "
                        f"(backup={backup._haven.status()})")
                time.sleep(0.01)
            took = time.monotonic() - t0
            _check(took <= budget_s + 2.0,
                   f"[{mode}] majority-side promotion in {took:.2f}s "
                   f"(lease budget ~{budget_s:.1f}s)")
            t0 = time.monotonic()
            while primary._haven.role == "primary":
                if time.monotonic() - t0 > budget_s + 5.0:
                    raise DrillFailure(f"[{mode}] minority primary never "
                                       f"stepped down")
                time.sleep(0.01)
            _check(primary._haven.role == "backup"
                   and not primary._haven.has_synced,
                   f"[{mode}] minority primary stepped down to an "
                   f"UNSYNCED standby")

            # epoch-stale write at the deposed node: REJECTED (redirect
            # verdict — the node no longer rules), never applied. The
            # raw client has no replica/quorum route on purpose: it
            # models a stale trainer still holding the old primary's
            # socket.
            w_before = {n: v.copy() for n, v in primary._dense.items()}
            raw = PSClient([primary.endpoint], failover_s=1.0)
            name = sorted(w_before)[0]
            rejected = False
            try:
                raw._call(primary.endpoint, "push_grad", name=name,
                          grad=np.ones_like(w_before[name]))
            except RuntimeError as e:
                rejected = "NotPrimary" in str(e) or "redirect" in str(e)
                print(f"  [{mode}] stale write rejected: {str(e)[:80]}")
            raw.close()
            _check(rejected, f"[{mode}] deposed node answered the stale "
                             f"write with a rejection")
            _check(all(np.array_equal(primary._dense[n], w_before[n])
                       for n in w_before),
                   f"[{mode}] deposed node applied NOTHING after the "
                   f"step-down (epoch-stale writes rejected)")

            # zero lost acked updates: the promoted backup's replay
            # watermark covers everything it had acknowledged
            _check(backup._haven.applied_seq >= pre_acked,
                   f"[{mode}] acked prefix survives "
                   f"({backup._haven.applied_seq} >= {pre_acked})")


            time.sleep(1.0)   # traffic against the new primary
            # heal: the deposed node rejoins as a resyncing standby
            net.heal()
            print(f"  [{mode}] partition healed")
            t0 = time.monotonic()
            while not primary._haven.has_synced:
                if time.monotonic() - t0 > 20.0:
                    raise DrillFailure(f"[{mode}] healed node never "
                                       f"resynced")
                time.sleep(0.02)
            time.sleep(0.6)
            stop.set()
            t_train.join(timeout=30)
            t_samp.join(timeout=5)

            _check(not failures,
                   f"[{mode}] zero trainer-visible failures "
                   f"({len(losses)} steps; first: "
                   f"{failures[0] if failures else None})")
            _check(len(losses) > pre_steps,
                   f"[{mode}] training continued through the partition "
                   f"({len(losses) - pre_steps} post-cut steps)")
            _check(not violations,
                   f"[{mode}] at most one write-acceptor at every 5ms "
                   f"sample ({violations[:3] if violations else 'clean'})")
            _check(np.isfinite(losses).all(), f"[{mode}] all losses finite")
            band = np.mean(ref[-6:]) * 1.25 + 0.05
            _check(np.mean(losses[-6:]) < band,
                   f"[{mode}] final loss {np.mean(losses[-6:]):.4f} "
                   f"inside the no-fault band (<{band:.4f})")

            # healed standby is bit-identical to the new primary at the
            # drained watermark
            deadline = time.monotonic() + 10.0
            while backup._haven.log.lag() > 0:
                if time.monotonic() > deadline:
                    raise DrillFailure(f"[{mode}] resync never drained")
                time.sleep(0.02)
            _check(all(np.array_equal(primary._dense[n],
                                      backup._dense[n])
                       for n in backup._dense),
                   f"[{mode}] healed standby bit-identical to the new "
                   f"primary")

            reg = obs_metrics.default_registry()
            promoted = reg.get("ps_promotions_total")
            _check(promoted is not None
                   and promoted.value(kind="quorum") >= 1,
                   f"[{mode}] quorum promotion metered")
            stepdowns = reg.get("ps_step_downs_total")
            _check(stepdowns is not None and stepdowns.total() >= 1,
                   f"[{mode}] step-down metered")
            grants = reg.get("quorum_grants_total")
            _check(grants is not None
                   and grants.value(outcome="granted") >= 2,
                   f"[{mode}] grants metered "
                   f"(bootstrap + election)")
            epoch_g = reg.get("quorum_lease_epoch")
            _check(epoch_g is not None
                   and epoch_g.value(resource="shard0") >= 2,
                   f"[{mode}] quorum_lease_epoch gauge advanced")
            _check(any(e.get("endpoint") == backup.endpoint
                       and e.get("promotion") == "quorum"
                       for e in seen_events["haven_promotion"]),
                   f"[{mode}] promotion in the flight recorder")
            _check(any(e.get("endpoint") == primary.endpoint
                       for e in seen_events["haven_step_down"]),
                   f"[{mode}] step-down in the flight recorder")
        finally:
            stop.set()
            if net is not None:
                net.stop()
            if tr is not None:
                try:
                    tr.close()
                except Exception:   # noqa: BLE001
                    pass
            fluid.set_flag("observe", False)
            for s in servers:
                s.stop()
            for n in nodes:
                n.stop()


def drill_ps_handover(seed, workdir, trace_out=None):
    """fluid-haven: planned live shard handoff under continuous async
    training load (see module docstring)."""
    import threading

    from paddle_tpu_torch.pserver import ParameterServer

    fluid.set_flag("observe", True)
    obs_metrics.default_registry().reset()
    primary, backup = _haven_pair(lease_s=1.0)
    fresh = ParameterServer("127.0.0.1:0").start()
    fresh.start_standby(lease_s=1.0, auto_promote=False)
    servers = [primary, backup, fresh]
    try:
        tr, loss, batch = _build_world(
            primary.endpoint, seed,
            haven_replicas={primary.endpoint: [backup.endpoint,
                                               fresh.endpoint]})
        stop = threading.Event()
        losses, failures = [], []

        def train_loop():
            while not stop.is_set():
                try:
                    l, = tr.step(batch(), fetch_list=[loss])
                    losses.append(float(np.asarray(l).reshape(-1)[0]))
                except Exception as e:          # noqa: BLE001
                    failures.append(repr(e))

        # lease-holder sampler: at EVERY sampled instant at most one of
        # the three servers may be ACCEPTING writes. (`accepting`, not
        # bare role: during the promote RPC round-trip the predecessor
        # still carries the primary role but its mutator gate is held —
        # it cannot acknowledge a write, so the successor is the sole
        # lease-holder the moment it processes the promote.)
        violations = []

        def sample_roles():
            while not stop.is_set():
                acc = [s._haven.status()["accepting"] if s._haven
                       else True for s in servers]
                if sum(acc) > 1:
                    violations.append(list(acc))
                time.sleep(0.005)

        t_train = threading.Thread(target=train_loop, daemon=True)
        t_roles = threading.Thread(target=sample_roles, daemon=True)
        t_train.start()
        t_roles.start()
        time.sleep(1.0)
        pre_steps = len(losses)
        res = primary.handover(fresh.endpoint)
        print(f"  handover complete: successor {res['successor']} at "
              f"epoch {res['epoch']}, seq {res['seq']}")
        time.sleep(1.5)
        stop.set()
        t_train.join(timeout=30)
        t_roles.join(timeout=5)
        _check(not failures,
               f"zero failed trainer steps across the handoff "
               f"({len(losses)} steps; first failure: "
               f"{failures[0] if failures else None})")
        _check(len(losses) > pre_steps,
               f"training continued against the successor "
               f"({len(losses) - pre_steps} post-flip steps)")
        _check(not violations,
               f"exactly one lease-holder at every sampled instant "
               f"({violations[:3] if violations else 'clean'})")
        _check(fresh._haven.role == "primary"
               and primary._haven.role == "retired",
               "roles flipped: successor primary, predecessor retired")
        promoted = obs_metrics.default_registry().get(
            "ps_promotions_total")
        _check(promoted is not None
               and promoted.value(kind="handover") >= 1,
               "handover promotion metered")
        _check(np.isfinite(losses).all(), "all losses finite")
        tr.close()
    finally:
        fluid.set_flag("observe", False)
        for s in servers:
            s.stop()


# -- fluid-elastic: HA data plane -----------------------------------------

#: the quorum resource the master pair contends for
MASTER_RESOURCE = "master0"
#: the issuing sampler's requested period, seconds
ISSUING_SAMPLE_S = 0.005


def _start_issuing_sampler(masters, stop):
    """A daemon thread reading each of `masters`' `issuing` flag every
    ISSUING_SAMPLE_S until `stop` is set. Returns (its sample times on
    the perf counter, the samples at which more than one issued)."""
    import threading

    samples, violations = [], []

    def sample():
        while not stop.is_set():
            acc = [m.issuing for m in masters]
            samples.append(time.perf_counter())
            if sum(acc) > 1:
                violations.append(acc)
            time.sleep(ISSUING_SAMPLE_S)

    threading.Thread(target=sample, daemon=True).start()
    return samples, violations


def _master_ha_world(workdir, lease_s=0.5, timeout_dur=5.0):
    """3 arbiters + primary/standby master pair (quorum-fenced)."""
    from paddle_tpu_torch.master import Master
    from paddle_tpu_torch.quorum import QuorumNode

    qdir = os.path.join(workdir, "mq")
    nodes = [QuorumNode("127.0.0.1:0", qdir, node_id=f"mn{i}").start()
             for i in range(3)]
    qeps = [n.endpoint for n in nodes]
    standby = Master("127.0.0.1:0",
                     snapshot_path=os.path.join(workdir, "standby.json"),
                     timeout_dur=timeout_dur, check_interval=0.1).start()
    standby.start_standby(lease_s=lease_s, quorum_endpoints=qeps,
                          quorum_resource=MASTER_RESOURCE)
    primary = Master("127.0.0.1:0",
                     snapshot_path=os.path.join(workdir, "primary.json"),
                     timeout_dur=timeout_dur, check_interval=0.1).start()
    primary.start_replication(standby.endpoint, lease_s=lease_s,
                              quorum_endpoints=qeps,
                              quorum_resource=MASTER_RESOURCE)
    return nodes, qeps, primary, standby


def _run_master_consumers(primary, standby, qeps, n_consumers=2,
                          item_sleep=0.02):
    """Consumer threads streaming master-leased records; returns the
    shared bookkeeping the checks read. Each delivered payload item and
    each successful RPC timestamp is recorded — the blip measurement."""
    import threading

    from paddle_tpu_torch.master import MasterClient

    lock = threading.Lock()
    state = {"deliveries": [], "failures": [], "op_times": [],
             "threads": [], "lock": lock}

    def consumer(cid):
        mc = MasterClient(primary.endpoint, standbys=[standby.endpoint],
                          quorum_endpoints=qeps,
                          quorum_resource=MASTER_RESOURCE,
                          failover_s=20.0)
        try:
            while True:
                status, task = mc.get_task()
                with lock:
                    state["op_times"].append(time.monotonic())
                if status == "no_more":
                    return
                if status == "none":
                    time.sleep(0.05)
                    continue
                for item in task["payload"]:
                    time.sleep(item_sleep)       # "process" the record
                    with lock:
                        state["deliveries"].append(item)
                mc.task_finished(task["task_id"], task["epoch"])
                with lock:
                    state["op_times"].append(time.monotonic())
        except Exception as e:                   # noqa: BLE001
            with lock:
                state["failures"].append((cid, repr(e)))
        finally:
            mc.close()

    for cid in range(n_consumers):
        th = threading.Thread(target=consumer, args=(cid,), daemon=True)
        state["threads"].append(th)
        th.start()
    return state


def _check_master_exactly_once(ruler, deliveries, n_items):
    """Exactly-once accounting: every payload item delivered >= 1, and
    an item is delivered MORE than once only when its task was
    re-issued (task epoch > 1 — the documented failure-budget path)."""
    from collections import Counter

    counts = Counter(deliveries)
    missing = [i for i in range(n_items) if counts[i] == 0]
    _check(not missing, f"every record delivered ({len(missing)} missing)")
    reissued = 0
    with ruler._lock:
        done = list(ruler._done)
    dup_violations = []
    for t in done:
        if t.epoch > 1:
            reissued += 1
            continue
        for item in t.payload:
            if counts[item] != 1:
                dup_violations.append((item, counts[item]))
    _check(not dup_violations,
           f"single-issue tasks delivered EXACTLY once "
           f"({dup_violations[:3] if dup_violations else 'clean'}; "
           f"{reissued} re-issued tasks allowed duplicates)")


def drill_master_kill(seed, workdir, trace_out=None):
    """fluid-elastic: SIGKILL the primary data master mid-pass (see
    module docstring)."""
    import threading

    from paddle_tpu_torch.observe import flight as obs_flight

    LEASE = 0.5
    N_ITEMS, CHUNK = 60, 2                      # 30 tasks
    fluid.set_flag("observe", True)
    obs_metrics.default_registry().reset()
    from paddle_tpu_torch.master import MasterClient
    nodes, qeps, primary, standby = _master_ha_world(workdir,
                                                     lease_s=LEASE)
    stop_sampling = threading.Event()
    state = None
    try:
        admin = MasterClient(primary.endpoint)
        admin.set_dataset(list(range(N_ITEMS)), chunks_per_task=CHUNK)
        admin.close()

        _, violations = _start_issuing_sampler([primary, standby],
                                               stop_sampling)
        state = _run_master_consumers(primary, standby, qeps)

        # let roughly a third of the pass complete at the primary
        deadline = time.monotonic() + 30
        while True:
            with primary._lock:
                done = len(primary._done)
            if done >= 10:
                break
            if time.monotonic() > deadline:
                raise DrillFailure("pass made no progress at the primary")
            time.sleep(0.02)

        kill_at = time.monotonic()
        chaos.kill_master(primary)
        print(f"  SIGKILL'd primary master {primary.endpoint} "
              f"({done} tasks done)")
        budget_s = _lease_budget_s(LEASE)
        while standby.ha_status()["role"] != "primary":
            if time.monotonic() - kill_at > budget_s + 5.0:
                raise DrillFailure(
                    f"standby never promoted ({standby.ha_status()})")
            time.sleep(0.01)
        took = time.monotonic() - kill_at
        _check(took <= budget_s,
               f"standby promoted in {took:.2f}s (lease budget "
               f"~{budget_s:.1f}s)")

        for th in state["threads"]:
            th.join(timeout=60)
        _check(all(not th.is_alive() for th in state["threads"]),
               "both consumers drained the pass")
        stop_sampling.set()
        _check(not state["failures"],
               f"zero consumer-visible failures "
               f"({state['failures'][:2] if state['failures'] else 'clean'})")
        # the stall is bounded by the blip: the largest gap between
        # consecutive successful ops must not exceed the failover budget
        ops = sorted(state["op_times"])
        gaps = [b - a for a, b in zip(ops, ops[1:])]
        blip = max(gaps) if gaps else 0.0
        _check(blip <= budget_s + 2.0,
               f"max consumer stall {blip:.2f}s bounded by the failover "
               f"blip (budget ~{budget_s:.1f}s)")
        _check(not violations,
               f"at most one task-issuing master at every 5ms sample")
        st = standby.ha_status()
        _check(st["done"] == N_ITEMS // CHUNK and st["todo"] == 0
               and st["pending"] == 0,
               f"pass complete at the promoted master ({st})")
        _check_master_exactly_once(standby, state["deliveries"], N_ITEMS)
        promoted = obs_metrics.default_registry().get(
            "master_promotions_total")
        _check(promoted is not None
               and promoted.value(kind="quorum") >= 1,
               "quorum promotion metered")
        promos = obs_flight.get_flight().events("master_promotion")
        _check(any(e.get("endpoint") == standby.endpoint for e in promos),
               "promotion in the flight recorder")
    finally:
        stop_sampling.set()
        fluid.set_flag("observe", False)
        primary.stop()
        standby.stop()
        for n in nodes:
            n.stop()


def drill_master_partition(seed, workdir, trace_out=None):
    """fluid-elastic: asymmetric partition of the master pair — the
    minority primary fences, trainers follow the quorum holder (see
    module docstring)."""
    import threading

    from paddle_tpu_torch.ark.retry import NO_RETRY

    LEASE = 0.5
    N_ITEMS, CHUNK = 60, 2
    fluid.set_flag("observe", True)
    obs_metrics.default_registry().reset()
    from paddle_tpu_torch.master import MasterClient
    nodes, qeps, primary, standby = _master_ha_world(workdir,
                                                     lease_s=LEASE)
    stop_sampling = threading.Event()
    net, state = None, None
    try:
        admin = MasterClient(primary.endpoint)
        admin.set_dataset(list(range(N_ITEMS)), chunks_per_task=CHUNK)
        admin.close()

        _, violations = _start_issuing_sampler([primary, standby],
                                               stop_sampling)
        state = _run_master_consumers(primary, standby, qeps)

        deadline = time.monotonic() + 30
        while True:
            with primary._lock:
                done = len(primary._done)
            if done >= 8:
                break
            if time.monotonic() > deadline:
                raise DrillFailure("pass made no progress at the primary")
            time.sleep(0.02)

        # the asymmetric cut: pair severed; primary keeps ONE arbiter
        # (minority), standby keeps all three; consumers reach everyone
        net = chaos.NetPartition(seed=seed).start()
        net.isolate(primary.endpoint, standby.endpoint)
        net.block(primary.endpoint, qeps[1])
        net.block(primary.endpoint, qeps[2])
        cut_at = time.monotonic()
        print(f"  partition up: primary sees 1/3 arbiters, standby 3/3, "
              f"pair severed ({done} tasks done)")
        budget_s = _lease_budget_s(LEASE)
        while standby.ha_status()["role"] != "primary":
            if time.monotonic() - cut_at > budget_s + 5.0:
                raise DrillFailure(
                    f"majority-side standby never promoted "
                    f"({standby.ha_status()})")
            time.sleep(0.01)
        took = time.monotonic() - cut_at
        _check(took <= budget_s,
               f"majority-side promotion in {took:.2f}s (budget "
               f"~{budget_s:.1f}s)")
        t0 = time.monotonic()
        while primary.issuing:
            if time.monotonic() - t0 > budget_s + 5.0:
                raise DrillFailure("minority primary never fenced")
            time.sleep(0.01)
        print(f"  minority primary fenced/stepped down "
              f"(role {primary.ha_status()['role']})")

        # a stale client still holding the deposed primary must get a
        # rejection (redirect -> NotMaster), never a state mutation
        raw = MasterClient(primary.endpoint, retry=NO_RETRY,
                           failover_s=0.5)
        rejected = False
        try:
            raw.get_task()
        except (RuntimeError, ConnectionError, OSError) as e:
            rejected = "NotMaster" in str(e) or "redirect" in str(e) \
                or isinstance(e, (ConnectionError, OSError))
            print(f"  stale get_task at the deposed primary rejected: "
                  f"{str(e)[:80]}")
        raw.close()
        _check(rejected, "deposed primary rejects task commands")

        for th in state["threads"]:
            th.join(timeout=60)
        _check(all(not th.is_alive() for th in state["threads"]),
               "consumers drained the pass following the quorum holder")
        stop_sampling.set()
        net.heal()
        _check(not state["failures"],
               f"zero consumer-visible failures "
               f"({state['failures'][:2] if state['failures'] else 'clean'})")
        _check(not violations,
               "at most one task-issuing master at every 5ms sample")
        st = standby.ha_status()
        _check(st["done"] == N_ITEMS // CHUNK and st["todo"] == 0
               and st["pending"] == 0,
               f"pass complete at the promoted master ({st})")
        _check_master_exactly_once(standby, state["deliveries"], N_ITEMS)
        reg = obs_metrics.default_registry()
        promoted = reg.get("master_promotions_total")
        _check(promoted is not None
               and promoted.value(kind="quorum") >= 1,
               "quorum promotion metered")
        stepdowns = reg.get("master_step_downs_total")
        _check(stepdowns is not None and stepdowns.total() >= 1,
               "minority step-down metered")
    finally:
        stop_sampling.set()
        if net is not None:
            net.stop()
        fluid.set_flag("observe", False)
        primary.stop()
        standby.stop()
        for n in nodes:
            n.stop()


def _build_sync_member(eps, seed, trainer_id, trainers, lease_s,
                       lr=0.1):
    """One sync-PS trainer world (own program/scope/executor) with its
    step PRE-COMPILED outside the barrier loop (two concurrent first
    compiles on a contended box can outlast the barrier)."""
    from paddle_tpu_torch.pserver import SyncPSTrainer

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = layers.data(name="x", shape=[8], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="int64")
        h = layers.fc(input=x, size=16, act="relu")
        logits = layers.fc(input=h, size=2, act=None)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    main.random_seed = startup.random_seed = seed
    cfg = fluid.DistributeTranspilerConfig()
    cfg.runtime = "pserver"
    t = fluid.DistributeTranspiler(cfg)
    t.transpile(trainer_id=trainer_id, program=main, pservers=eps,
                trainers=trainers, sync_mode=True)
    scope = fluid.Scope()
    exe = fluid.Executor(_place())
    exe.run(startup, scope=scope)
    # pre-compile with the exact (feed, fetch) signature tr.step uses
    grad_fetches = [t.grad_names[p] for p in t.param_specs]
    rng = np.random.RandomState(0)
    exe.run(main, feed={"x": rng.randn(4, 8).astype(np.float32),
                        "y": np.zeros((4, 1), np.int64)},
            fetch_list=[loss] + grad_fetches, scope=scope)
    tr = SyncPSTrainer(t, exe, program=main, scope=scope,
                       heartbeat_lease_s=lease_s)
    tr.init_params()               # first writer wins
    return tr, loss


def drill_trainer_churn(seed, workdir, trace_out=None):
    """fluid-elastic scale-down AND scale-up: kill 1-of-3 sync trainers
    mid-pass, start a replacement with a FRESH trainer id (see module
    docstring)."""
    import threading

    from paddle_tpu_torch.master import Master, MasterClient
    from paddle_tpu_torch.pserver import ParameterServer

    N_BATCH = 60
    LEASE = 0.5
    RECORD_S = 0.05   # per-record pacing: the pass must outlive the
    #                   churn window so the replacement gets real work

    def batch_of(i, n=32):
        rng = np.random.RandomState(seed * 1000 + i)
        w_true = np.random.RandomState(seed + 1).randn(8, 2)
        xs = rng.randn(n, 8).astype(np.float32)
        ys = (xs @ w_true).argmax(1).astype(np.int64).reshape(n, 1)
        return {"x": xs, "y": ys}

    def run(churn):
        srv = ParameterServer("127.0.0.1:0", trainers=3).start()
        master = Master("127.0.0.1:0", timeout_dur=4.0,
                        check_interval=0.1).start()
        admin = MasterClient(master.endpoint)
        admin.set_dataset(list(range(N_BATCH)))
        lock = threading.Lock()
        deliveries, losses, failures = [], [], []
        kill_evt = threading.Event()
        stop_sampling = threading.Event()
        world_sizes = []

        def sample_world():
            while not stop_sampling.is_set():
                w = srv._sync_barrier.live_parties
                if not world_sizes or world_sizes[-1] != w:
                    world_sizes.append(w)
                time.sleep(0.01)

        def consumer(tid, tr, loss, die=False):
            mc = MasterClient(master.endpoint)
            killed = False
            try:
                while True:
                    if die and kill_evt.is_set():
                        killed = True
                        return
                    status, task = mc.get_task()
                    if status == "no_more":
                        return
                    if status == "none":
                        time.sleep(0.05)
                        continue
                    for i in task["payload"]:
                        if die and kill_evt.is_set():
                            killed = True
                            return   # dies HOLDING the lease
                        l, = tr.step(batch_of(i), fetch_list=[loss])
                        time.sleep(RECORD_S)
                        with lock:
                            deliveries.append((tid, i))
                            losses.append(
                                float(np.asarray(l).reshape(-1)[0]))
                    mc.task_finished(task["task_id"], task["epoch"])
            except Exception as e:               # noqa: BLE001
                with lock:
                    failures.append((tid, repr(e)))
            finally:
                if killed:
                    # SIGKILL analog: the heartbeat dies with the
                    # process — no clean close, the lease just expires
                    tr._heartbeat.stop()
                    tr._hb_client.close()
                else:
                    tr.close()
                mc.close()

        threads = []
        try:
            # builds are SEQUENTIAL (program construction shares the
            # global unique-name state); only the loops run concurrently
            members = [( tid, *_build_sync_member(
                srv.endpoint, seed, tid, trainers=3, lease_s=LEASE))
                for tid in range(3)]
            threading.Thread(target=sample_world, daemon=True).start()
            for tid, tr, loss in members:
                th = threading.Thread(
                    target=consumer, args=(tid, tr, loss),
                    kwargs={"die": churn and tid == 1}, daemon=True)
                threads.append(th)
                th.start()
            if churn:
                # let the pass get going, then SIGKILL trainer 1
                deadline = time.monotonic() + 60
                while True:
                    with lock:
                        n = len(deliveries)
                    if n >= 5:
                        break
                    if time.monotonic() > deadline:
                        raise DrillFailure("pass never got going")
                    time.sleep(0.02)
                kill_evt.set()
                print(f"  killed trainer 1 mid-pass ({n} records in)")
                # world must degrade to 2 in lease-time
                t0 = time.monotonic()
                while srv._sync_barrier.live_parties > 2:
                    if time.monotonic() - t0 > 30:
                        raise DrillFailure("dead trainer never evicted")
                    time.sleep(0.02)
                print(f"  world degraded to 2 in "
                      f"{time.monotonic() - t0:.2f}s")
                # REPLACEMENT with a FRESH id, mid-job (build in the
                # main thread — construction is not thread-safe)
                t_adm = time.monotonic()
                _, tr3, loss3 = (3, *_build_sync_member(
                    srv.endpoint, seed, 3, trainers=3, lease_s=LEASE))
                th = threading.Thread(target=consumer,
                                      args=(3, tr3, loss3), daemon=True)
                threads.append(th)
                th.start()
                t0 = time.monotonic()
                while srv._sync_barrier.live_parties < 3:
                    if time.monotonic() - t0 > 30:
                        raise DrillFailure("replacement never admitted")
                    time.sleep(0.02)
                print(f"  replacement (id 3) admitted in "
                      f"{time.monotonic() - t_adm:.2f}s — world back to 3")
            for th in threads:
                th.join(timeout=300)
            if any(th.is_alive() for th in threads):
                raise DrillFailure("a trainer never drained the pass")
            stop_sampling.set()
            st = admin.stats()
            return {"deliveries": list(deliveries),
                    "losses": list(losses), "failures": list(failures),
                    "world_sizes": list(world_sizes), "stats": st,
                    "master": master}
        finally:
            stop_sampling.set()
            kill_evt.set()
            admin.close()
            srv.stop()
            if not churn:
                master.stop()

    fluid.set_flag("observe", True)
    obs_metrics.default_registry().reset()
    try:
        ref = run(churn=False)
        _check(not ref["failures"], "no-fault reference run clean")
        band = np.mean(ref["losses"][-6:]) * 1.3 + 0.05

        obs_metrics.default_registry().reset()
        got = run(churn=True)
        master = got["master"]
        try:
            _check(not got["failures"],
                   f"zero trainer-visible failures "
                   f"({got['failures'][:2] if got['failures'] else 'clean'})")
            # world size observed 3 -> 2 -> 3
            w = got["world_sizes"]
            sub, it = [3, 2, 3], iter(w)
            _check(all(any(x == want for x in it) for want in sub),
                   f"world size observed 3->2->3 (samples {w})")
            st = got["stats"]
            _check(st["done"] == N_BATCH and st["todo"] == 0
                   and st["pending"] == 0,
                   f"pass complete ({st})")
            by_replacement = sum(1 for tid, _i in got["deliveries"]
                                 if tid == 3)
            _check(by_replacement >= 1,
                   f"replacement trainer processed real work "
                   f"({by_replacement} records)")
            _check_master_exactly_once(
                master, [i for _tid, i in got["deliveries"]], N_BATCH)
            _check(np.isfinite(got["losses"]).all(), "all losses finite")
            tail = np.mean(got["losses"][-6:])
            _check(tail < band,
                   f"final loss {tail:.4f} inside the no-fault band "
                   f"(<{band:.4f})")
            reg = obs_metrics.default_registry()
            evicted = reg.get("pserver_trainers_evicted_total")
            _check(evicted is not None and evicted.total() >= 1,
                   "eviction metered")
            admitted = reg.get("pserver_trainers_admitted_total")
            _check(admitted is not None and admitted.total() >= 1,
                   "scale-up admission metered")
        finally:
            master.stop()
    finally:
        fluid.set_flag("observe", False)


SCENARIOS = {
    "flaky_rpc": drill_flaky_rpc,
    "master_kill": drill_master_kill,
    "master_partition": drill_master_partition,
    "trainer_churn": drill_trainer_churn,
    "ps_primary_kill": drill_ps_primary_kill,
    "ps_handover": drill_ps_handover,
    "ps_partition": drill_ps_partition,
    "replica_kill": drill_replica_kill,
    "decode_kill": drill_decode_kill,
    "quant_flaky_rpc": drill_quant_flaky_rpc,
    "pserver_kill": drill_pserver_kill,
    "ckpt_crash": drill_ckpt_crash,
    "sync_evict": drill_sync_evict,
    "dist_trace": drill_dist_trace,
    "health_alerts": drill_health_alerts,
}


def _export_and_merge(trace_out):
    """Write THIS process's trace file into `trace_out`, merge every
    per-process trace file found there, and fail unless every span
    survived the merge."""
    import glob
    import json

    from paddle_tpu_torch.observe import get_tracer, merge_chrome_traces, xray

    if xray.process_name().startswith("pid"):
        xray.set_process_name("trainer0")
    mine = os.path.join(trace_out, f"trace_{xray.process_name()}.json")
    get_tracer().export_chrome(mine)
    inputs = sorted(glob.glob(os.path.join(trace_out, "trace_*.json")))
    merged_path = os.path.join(trace_out, "merged_trace.json")
    doc, stats = merge_chrome_traces(inputs, out_path=merged_path)
    with open(merged_path) as f:
        json.load(f)   # the artifact must round-trip
    _check(stats["spans_out"] == stats["spans_in"] and stats["spans_in"] > 0,
           f"merged {stats['spans_in']} spans from {len(inputs)} "
           f"process file(s), none dropped")
    print(f"  merged timeline: {merged_path} "
          f"(processes: {', '.join(stats['processes'])})")
    return merged_path, stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenario", required=True, choices=sorted(SCENARIOS),
                    help="fault scenario to drill")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--workdir", default=None,
                    help="scratch dir (default: a fresh tempdir)")
    ap.add_argument("--trace-out", default=None, metavar="DIR",
                    help="write per-process chrome trace files + a merged "
                         "timeline here; the drill fails if the merge "
                         "drops spans")
    ap.add_argument("--cpu", action="store_true",
                    help="run the trainers on the host, not the card")
    args = ap.parse_args(argv)
    _ON_CPU[0] = args.cpu
    workdir = args.workdir or tempfile.mkdtemp(prefix="torch_chaos_drill_")
    os.makedirs(workdir, exist_ok=True)
    print(f"chaos drill: {args.scenario} (seed {args.seed})")
    t0 = time.monotonic()
    try:
        if args.trace_out:
            # root span around the whole scenario: the timeline shows
            # the drill's extent, and scenarios that make no RPC/executor
            # calls (ckpt_crash) still contribute >= 1 span to the merge
            from paddle_tpu_torch.observe import xray
            with xray.span(f"drill:{args.scenario}", cat="drill",
                           seed=args.seed):
                SCENARIOS[args.scenario](args.seed, workdir,
                                         trace_out=args.trace_out)
            os.makedirs(args.trace_out, exist_ok=True)
            _export_and_merge(args.trace_out)
        else:
            SCENARIOS[args.scenario](args.seed, workdir,
                                     trace_out=args.trace_out)
    except DrillFailure as e:
        print(f"DRILL FAILED: {e}")
        return 1
    print(f"DRILL PASSED in {time.monotonic() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
