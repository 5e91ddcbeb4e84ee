#!/usr/bin/env python
"""torch_quorum_bench: what paddle_tpu_torch's partition-safe
coordination costs — ONE JSON line with the keys of tools/quorum_bench.py.

    python tools/torch_quorum_bench.py [--cpu]

The arbiters, servers and wire are host TCP + numpy; the trainer's step
runs through the port's `Executor` on `CUDAPlace(0)`, or on the host
with `--cpu`. Two measurements:

1. **Lease-renewal overhead on the training step** — median sync-PS
   step time on a replicated haven pair (int8 wire, torch_haven_bench's
   acceptance configuration) WITHOUT vs WITH a 3-node quorum
   armed. The renewal traffic is one tiny majority fan-out per lease/3
   on a dedicated thread, so the acceptance bar is tight: <= 2% over
   the haven baseline measured in the SAME process.
   Keys: quorum_step_ms_haven, quorum_step_ms_quorum,
   quorum_renewal_overhead_pct, quorum_overhead_ok.

2. **Partition-failover blip** — wall-time gap in trainer step
   completions across an ASYMMETRIC partition (primary loses the
   backup and 2/3 arbiters; backup keeps the majority; the trainer
   reaches everyone): max inter-step gap minus the healthy median. The
   budget: the primary's local lease expiry (it fences first), the
   arbiters' own expiry (the backup's grant can land only after it),
   the promotion monitor's poll, and the client's retry/resolve
   budget. Keys: quorum_failover_blip_ms, quorum_failover_budget_ms,
   quorum_failover_ok.

Same rehearsal-rig honesty as torch_haven_bench: each step simulates its
device phase with a GIL-releasing sleep (DEVICE_MS), because on this
1-core container the backup's apply CPU and the arbiters' work would
otherwise be billed against the trainer's step clock in a way no real
deployment exhibits. Recorded as quorum_device_ms_simulated.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from paddle_tpu_torch.ark import chaos  # noqa: E402
from paddle_tpu_torch.ark.retry import RetryPolicy  # noqa: E402
from paddle_tpu_torch.pserver import ParameterServer  # noqa: E402
from paddle_tpu_torch.quorum import QuorumNode  # noqa: E402

from torch_haven_bench import (DEVICE_MS, _build,  # noqa: E402
                               _median_step_ms)

SEED = 11
LEASE_S = 1.0


def _quorum_group(workdir, n=3):
    nodes = [QuorumNode("127.0.0.1:0", workdir,
                        node_id=f"n{i}").start() for i in range(n)]
    return nodes, [x.endpoint for x in nodes]


def _pair(qeps=None, lease_s=LEASE_S, resource="bench-shard"):
    kw = {}
    if qeps:
        kw = {"quorum_endpoints": qeps, "quorum_resource": resource}
    backup = ParameterServer("127.0.0.1:0").start()
    backup.start_standby(lease_s=lease_s, **kw)
    primary = ParameterServer("127.0.0.1:0").start()
    primary.start_replication(backup.endpoint, lease_s=lease_s, **kw)
    return primary, backup


_MEASURE_N = [0]


def _measure_pair(qeps, cpu):
    # fresh resource per measurement: a stopped pair's quorum lease is
    # deliberately NOT resigned (SIGKILL semantics), so reusing one
    # resource would reject the next pair's bootstrap until expiry
    _MEASURE_N[0] += 1
    primary, backup = _pair(qeps=qeps,
                            resource=f"bench-shard-{_MEASURE_N[0]}")
    try:
        tr, loss, batch = _build(
            primary.endpoint, sync=True, comm_quant="int8",
            haven_replicas={primary.endpoint: [backup.endpoint]}, cpu=cpu)
        ms = _median_step_ms(tr, loss, batch)
        tr.close()
        return ms
    finally:
        primary.stop()
        backup.stop()


def bench_renewal_overhead(workdir, cpu=False):
    # A: replicated pair, int8 wire (the haven baseline) vs
    # B: the same pair + a 3-node quorum renewing at lease/3.
    # INTERLEAVED A/B/A/B rounds, min-of-medians per config: the two
    # configs differ by one tiny majority fan-out per 333ms on a
    # dedicated thread, far below this 1-core container's sequential
    # run-to-run jitter — the min-median is the honest comparator.
    nodes, qeps = _quorum_group(os.path.join(workdir, "q_overhead"))
    try:
        haven_ms = min(_measure_pair(None, cpu) for _ in range(2))
        quorum_ms = min(_measure_pair(qeps, cpu) for _ in range(2))
        # second interleave round tightens both minima
        haven_ms = min(haven_ms, _measure_pair(None, cpu))
        quorum_ms = min(quorum_ms, _measure_pair(qeps, cpu))
    finally:
        for n in nodes:
            n.stop()

    overhead = (quorum_ms - haven_ms) / haven_ms * 100.0 if haven_ms \
        else 0.0
    return {
        "quorum_step_ms_haven": round(haven_ms, 3),
        "quorum_step_ms_quorum": round(quorum_ms, 3),
        "quorum_renewal_overhead_pct": round(overhead, 2),
        "quorum_overhead_ok": bool(haven_ms > 0 and overhead <= 2.0),
        "quorum_device_ms_simulated": DEVICE_MS,
    }


def bench_partition_failover(workdir, cpu=False):
    nodes, qeps = _quorum_group(os.path.join(workdir, "q_failover"))
    primary, backup = _pair(qeps=qeps)
    net = None
    try:
        tr, loss, batch = _build(
            primary.endpoint, sync=False,
            haven_replicas={primary.endpoint: [backup.endpoint]}, cpu=cpu)
        for _ in range(5):
            tr.step(batch(), fetch_list=[loss])
        done = []
        for _ in range(10):
            tr.step(batch(), fetch_list=[loss])
            done.append(time.perf_counter())
        healthy_ms = float(np.median(np.diff(done))) * 1e3

        # the asymmetric cut: the NEXT steps eat the whole failover
        # (fence -> arbiter-side expiry -> election -> client resolve)
        net = chaos.NetPartition(seed=SEED).start()
        net.isolate(primary.endpoint, backup.endpoint)
        net.block(primary.endpoint, qeps[1])
        net.block(primary.endpoint, qeps[2])
        # step THROUGH the whole failover (fence -> expiry -> election):
        # a fixed small step count could complete before the fence even
        # lands and measure nothing
        deadline = time.monotonic() + 60.0
        tail = 0
        while tail < 5:
            tr.step(batch(), fetch_list=[loss])
            done.append(time.perf_counter())
            if backup._haven.role == "primary":
                tail += 1
            if time.monotonic() > deadline:
                raise RuntimeError("partition failover never completed")
        gaps_ms = np.diff(done) * 1e3
        blip_ms = float(gaps_ms.max() - healthy_ms)
        tr.close()
    finally:
        if net is not None:
            net.stop()
        primary.stop()
        backup.stop()
        for n in nodes:
            n.stop()

    # the budget: the holder's local expiry (fence + step-down), the
    # arbiters' own lease expiry (strictly later — the rival's grant
    # waits for it), the promotion monitor's poll, the election round,
    # and the client's one-call retry/resolve budget
    p = RetryPolicy()
    retry_budget_s = sum(
        min(p.max_delay, p.base_delay * 2.0 ** k) * (1.0 + p.jitter)
        for k in range(p.max_attempts + 1)) + 2 * 0.25
    budget_ms = (2.0 * LEASE_S + LEASE_S / 3.0 + retry_budget_s
                 + 1.0) * 1e3
    return {
        "quorum_failover_blip_ms": round(blip_ms, 1),
        "quorum_failover_budget_ms": round(budget_ms, 1),
        "quorum_failover_ok": bool(blip_ms <= budget_ms),
        "quorum_lease_s": LEASE_S,
    }


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the trainers on the host, not the card")
    args = ap.parse_args(argv)
    workdir = tempfile.mkdtemp(prefix="torch_quorum_bench_")
    out = {}
    out.update(bench_renewal_overhead(workdir, args.cpu))
    out.update(bench_partition_failover(workdir, args.cpu))
    print(json.dumps(out))
    # BOTH acceptance bars gate the exit code: <=2% renewal overhead on
    # the sync-PS step and the partition blip inside the lease budget
    return 0 if out.get("quorum_overhead_ok") \
        and out.get("quorum_failover_ok") else 1


if __name__ == "__main__":
    sys.exit(main())
