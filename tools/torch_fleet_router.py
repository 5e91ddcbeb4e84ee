#!/usr/bin/env python
"""torch_fleet_router: run (or drive) paddle_tpu_torch's multi-replica
serving tier (tools/fleet_router.py on the port).

    # spawn a local 3-replica fleet over one model dir and route forever
    python tools/torch_fleet_router.py --spawn 3 --model-dir /models/m

    # attach to already-running replicas (tools/torch_fleet_replica.py)
    python tools/torch_fleet_router.py --attach 127.0.0.1:7001,127.0.0.1:7002

    # one-shot coordinated, version-skew-free swap across the fleet
    python tools/torch_fleet_router.py --attach ... --swap /models/m_v2 --exit

Spawned replicas serve on `CUDAPlace(0)` (every replica process shares
the one card), or on the host with `--cpu`; the router itself is host
code. Prints `CONTROL <endpoint>` (replicas heartbeat there) and a
MEMBERS status line per poll interval; SIGINT/SIGTERM shuts the fleet
down cleanly. The drills live in `tools/torch_serve_loadgen.py
--replicas` and `tools/torch_chaos_drill.py --scenario replica_kill`;
this CLI is the operator's on-ramp.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spawn_replicas(n, model_dir, router_ep, extra_args=(), name="m",
                   pulse=False, device_ms=0.0, lease_s=3.0,
                   rid_prefix="r", cpu=False):
    """Start n `tools/torch_fleet_replica.py` subprocesses against
    `router_ep` (on the card, or on the host with `cpu`); returns the
    Popen list after every worker printed READY.

    Mixed fluid-torrent pools: call twice with distinct `rid_prefix`es
    and `extra_args=("--role", "prefill")` / `("--role", "decode")` —
    replica ids must not collide across the calls."""
    workers = []
    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_fleet_replica.py")
    for i in range(n):
        cmd = [sys.executable, tool, "--model-dir", model_dir,
               "--name", name, "--router", router_ep,
               "--replica-id", f"{rid_prefix}{i}",
               "--lease-s", str(lease_s)]
        if pulse:
            cmd += ["--pulse-port", "0"]
        if device_ms:
            cmd += ["--device-ms", str(device_ms)]
        if cpu:
            cmd += ["--cpu"]
        cmd += list(extra_args)
        workers.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        text=True))
    import queue as _queue

    # one reader thread per worker, lines drained into a queue: the
    # startup wait below then has a REAL deadline (a bare readline()
    # blocks forever on a wedged-but-alive worker, and select() lies
    # once readline's buffered read-ahead has swallowed later lines);
    # the thread also keeps draining stdout afterwards so a chatty
    # worker can never block on a full pipe
    def _reader(w, q):
        try:
            for line in w.stdout:
                q.put(line.strip())
        finally:
            q.put(None)          # EOF sentinel

    lines: dict = {}
    for w in workers:
        q = _queue.Queue()
        lines[w.pid] = q
        threading.Thread(target=_reader, args=(w, q), daemon=True).start()
    for w in workers:
        deadline = time.time() + 120
        ready = False
        while time.time() < deadline:
            try:
                line = lines[w.pid].get(timeout=1.0)
            except _queue.Empty:
                if w.poll() is not None:
                    raise RuntimeError(
                        f"replica worker died at startup "
                        f"(rc={w.returncode})")
                continue
            if line is None:
                raise RuntimeError(
                    f"replica worker died at startup (rc={w.poll()})")
            if line == "READY":
                ready = True
                break
        if not ready:
            raise RuntimeError("replica worker never reported READY "
                               "within 120s")
    return workers


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spawn", type=int, default=0,
                    help="spawn N local replica workers (needs "
                    "--model-dir)")
    ap.add_argument("--model-dir", default=None)
    ap.add_argument("--name", default="m")
    ap.add_argument("--attach", default=None,
                    help="comma-separated replica RPC endpoints to add")
    ap.add_argument("--lease-s", type=float, default=3.0)
    ap.add_argument("--poll-interval-s", type=float, default=0.5)
    ap.add_argument("--pulse-port", type=int, default=None,
                    help="arm the ROUTER's own fluid-pulse health plane "
                    "(turns the observe flag on)")
    ap.add_argument("--replica-pulse", action="store_true",
                    help="spawned replicas arm their own pulse (the "
                    "router then polls real HTTP /readyz)")
    ap.add_argument("--device-ms", type=float, default=0.0,
                    help="spawned replicas' simulated device time "
                    "(rehearsal rigs; see torch_fleet_replica.py)")
    ap.add_argument("--swap", metavar="DIR", default=None,
                    help="run one coordinated fleet swap to DIR")
    ap.add_argument("--exit", dest="exit_after", action="store_true",
                    help="exit after startup (and --swap, if given) "
                    "instead of routing forever")
    ap.add_argument("--cpu", action="store_true",
                    help="spawned replicas serve on the host, not the card")
    args = ap.parse_args(argv)

    if args.spawn and not args.model_dir:
        ap.error("--spawn needs --model-dir")

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import fleet

    if args.pulse_port is not None:
        fluid.set_flag("observe", True)

    router = fleet.FleetRouter(fleet.RouterConfig(
        lease_s=args.lease_s, poll_interval_s=args.poll_interval_s,
        pulse_port=args.pulse_port)).start()
    print(f"CONTROL {router.control_endpoint}", flush=True)
    if router.pulse_port is not None:
        print(f"PULSE {router.pulse_port}", flush=True)

    workers = []
    try:
        if args.spawn:
            workers = spawn_replicas(
                args.spawn, args.model_dir, router.control_endpoint,
                name=args.name, pulse=args.replica_pulse,
                device_ms=args.device_ms, lease_s=args.lease_s,
                cpu=args.cpu)
        for ep in (args.attach or "").split(","):
            if ep:
                router.add_replica(ep)
        # one poll round so MEMBERS below reflects reality
        time.sleep(max(args.poll_interval_s, 0.2))
        if args.swap:
            report = router.swap(args.name, args.swap)
            print(f"SWAP {report}", flush=True)

        stop = threading.Event()
        signal.signal(signal.SIGTERM, lambda *a: stop.set())
        signal.signal(signal.SIGINT, lambda *a: stop.set())
        while not args.exit_after and not stop.is_set():
            mem = router.members()
            ready = sum(1 for m in mem.values() if m["ready"])
            print(f"MEMBERS {len(mem)} ready={ready} "
                  f"{sorted(mem)}", flush=True)
            stop.wait(max(2.0, args.poll_interval_s * 4))
        return 0
    finally:
        for w in workers:
            if w.poll() is None:
                w.terminate()
        for w in workers:
            try:
                w.wait(timeout=10)
            except subprocess.TimeoutExpired:
                w.kill()
        router.close()


if __name__ == "__main__":
    sys.exit(main())
