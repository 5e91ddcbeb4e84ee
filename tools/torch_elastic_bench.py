#!/usr/bin/env python
"""torch_elastic_bench: paddle_tpu_torch's fluid-elastic HA data-plane
numbers, printed with the keys of tools/elastic_bench.py.

    python tools/torch_elastic_bench.py

Both measurements are host TCP + json on the port's `master/`,
`quorum/` and `pserver/`: no step runs, so no card is touched.

Two measurements, printed as one JSON line:

- ``master_failover_blip_ms``: a consumer streams get_task/finish
  against a quorum-armed primary/standby master pair; the primary is
  SIGKILL-equivalently cut mid-stream and the blip is the largest gap
  between consecutive successful consumer ops across the kill — lease
  expiry + election + client re-resolution, end to end. Gated against
  ``master_failover_budget_ms`` (two lease periods + a retry/resolve
  allowance, the same shape as the quorum/haven failover budgets).

- ``elastic_scaleup_admission_s``: a running 2-trainer sync-PS world
  (client-level lockstep, the sync_evict drill idiom) admits a THIRD,
  never-seen trainer id; the admission time runs from its first
  heartbeat to the first barrier generation whose world counts it
  (live_parties == 3) — the scale-UP half of elasticity. Gated at the
  barrier-epoch bound: admission must land within one generation plus
  a lease period (``elastic_scaleup_ok``).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def bench_master_failover(workdir, lease_s=0.5, n_items=200):
    from paddle_tpu_torch.ark import chaos
    from paddle_tpu_torch.master import Master, MasterClient
    from paddle_tpu_torch.quorum import QuorumNode

    nodes = [QuorumNode("127.0.0.1:0", os.path.join(workdir, "q"),
                        node_id=f"b{i}").start() for i in range(3)]
    qeps = [n.endpoint for n in nodes]
    standby = Master("127.0.0.1:0").start()
    standby.start_standby(lease_s=lease_s, quorum_endpoints=qeps,
                          quorum_resource="bench")
    primary = Master("127.0.0.1:0", timeout_dur=10.0,
                     check_interval=0.1).start()
    primary.start_replication(standby.endpoint, lease_s=lease_s,
                              quorum_endpoints=qeps,
                              quorum_resource="bench")
    cli = MasterClient(primary.endpoint, standbys=[standby.endpoint],
                       quorum_endpoints=qeps, quorum_resource="bench",
                       failover_s=20.0)
    try:
        cli.set_dataset(list(range(n_items)), chunks_per_task=1)
        op_times = []
        killed_at = None
        done = 0
        while True:
            status, task = cli.get_task()
            op_times.append(time.monotonic())
            if status == "no_more":
                break
            if status == "none":
                time.sleep(0.01)
                continue
            cli.task_finished(task["task_id"], task["epoch"])
            op_times.append(time.monotonic())
            done += 1
            if killed_at is None and done >= n_items // 3:
                killed_at = time.monotonic()
                chaos.kill_master(primary)
        gaps = [(b - a) for a, b in zip(op_times, op_times[1:])]
        blip_ms = max(gaps) * 1000.0 if gaps else 0.0
        # two lease periods (local expiry is conservative vs the
        # arbiters' own) + election + client resolve allowance
        budget_ms = (2.0 * lease_s + 2.0) * 1000.0
        return {"master_failover_blip_ms": round(blip_ms, 1),
                "master_failover_budget_ms": round(budget_ms, 1),
                "master_failover_ok": blip_ms <= budget_ms,
                "master_failover_tasks_done": done}
    finally:
        cli.close()
        primary.stop()
        standby.stop()
        for n in nodes:
            n.stop()


def bench_scaleup_admission(lease_s=0.5):
    from paddle_tpu_torch.pserver import ParameterServer, PSClient

    srv = ParameterServer("127.0.0.1:0", trainers=2).start()
    ep = srv.endpoint
    stop = threading.Event()
    admitted = {}

    def trainer(tid, session, start_batch=0):
        c = PSClient([ep])
        c2 = None
        try:
            c.init_param(ep, "w", np.zeros(8, np.float32), "sgd", 0.1, {})
            c.heartbeat(ep, trainer_id=tid, session=session,
                        lease_s=lease_s)
            if tid == 2:
                admitted["beat_at"] = time.monotonic()
            hb_stop = threading.Event()

            def hb():
                while not hb_stop.wait(lease_s / 3.0):
                    try:
                        c2.heartbeat(ep, trainer_id=tid, session=session,
                                     lease_s=lease_s)
                    except Exception:   # noqa: BLE001
                        pass

            c2 = PSClient([ep])
            threading.Thread(target=hb, daemon=True).start()
            b = start_batch
            while not stop.is_set():     # steady state until measured
                try:
                    c.push_grads_sync(
                        {ep: {"w": np.full(8, 0.1, np.float32)}},
                        batch_id=b, trainer_id=tid, session=session)
                    c.sync_apply([ep], trainer_id=tid)
                except RuntimeError:
                    continue   # broken barrier around the churn: retry
                b += 1
                time.sleep(0.005)
            hb_stop.set()
        finally:
            c.close()
            if c2 is not None:
                c2.close()

    threads = [threading.Thread(target=trainer, args=(tid, f"s{tid}"),
                                daemon=True) for tid in range(2)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.5)            # the 2-world is in steady state
        t3 = threading.Thread(target=trainer, args=(2, "s2"),
                              kwargs={"start_batch": 0}, daemon=True)
        t3.start()
        threads.append(t3)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if "beat_at" in admitted \
                    and srv._sync_barrier.live_parties >= 3:
                admitted["admitted_at"] = time.monotonic()
                break
            time.sleep(0.005)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        if "admitted_at" not in admitted or "beat_at" not in admitted:
            return {"elastic_scaleup_admission_s": -1.0,
                    "elastic_scaleup_ok": False}
        adm = admitted["admitted_at"] - admitted["beat_at"]
        # bound: one in-flight generation (at most a few barrier polls)
        # plus one lease period of slack
        ok = adm <= lease_s + 2.0
        return {"elastic_scaleup_admission_s": round(adm, 3),
                "elastic_scaleup_ok": ok}
    finally:
        stop.set()
        srv.stop()


def main():
    workdir = tempfile.mkdtemp(prefix="torch_elastic_bench_")
    rec = {}
    rec.update(bench_master_failover(workdir))
    rec.update(bench_scaleup_admission())
    print(json.dumps(rec))
    return 0 if (rec.get("master_failover_ok")
                 and rec.get("elastic_scaleup_ok")) else 1


if __name__ == "__main__":
    sys.exit(main())
