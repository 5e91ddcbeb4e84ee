#!/usr/bin/env python
"""torch_master_node: run one fluid-elastic data master of paddle_tpu_torch
as its own process (tools/master_node.py's flags and output, on the
port's `master/`; the master is host code and touches no card).

    # solo (legacy single master)
    python tools/torch_master_node.py --endpoint 127.0.0.1:8800 \
        --snapshot /var/m/master.json

    # HA pair behind a 3-node quorum (start the standby FIRST)
    python tools/torch_master_node.py --endpoint 127.0.0.1:8801 --standby \
        --quorum 127.0.0.1:7001,127.0.0.1:7002,127.0.0.1:7003
    python tools/torch_master_node.py --endpoint 127.0.0.1:8800 \
        --replicate-to 127.0.0.1:8801 \
        --quorum 127.0.0.1:7001,127.0.0.1:7002,127.0.0.1:7003

    # operator probe: who rules, at what epoch, with what queues
    python tools/torch_master_node.py --endpoint 127.0.0.1:8800 --status

Prints "ENDPOINT <host:port>" once listening (ephemeral-port friendly),
then parks until SIGTERM/SIGINT, which stops the node cleanly — its
snapshot (ark atomic idiom: embedded sha256 + retained `.prev` serial)
survives the restart, and a quorum-armed node's primacy lease simply
expires at the arbiters so the standby takes over.

`--status` (no server) connects to a RUNNING master and prints its
`ha_status` row — role, fencing epoch, issuing verdict, queue depths —
falling back to plain `stats` against a pre-elastic master.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--endpoint", default="127.0.0.1:0")
    ap.add_argument("--snapshot", default=None,
                    help="snapshot path (ark atomic; .prev serial "
                         "retained beside it)")
    ap.add_argument("--timeout-dur", type=float, default=20.0,
                    help="task lease duration (seconds)")
    ap.add_argument("--failure-max", type=int, default=3)
    ap.add_argument("--lease-s", type=float, default=2.0,
                    help="HA lease duration (replication heartbeat + "
                         "quorum primacy lease)")
    ap.add_argument("--standby", action="store_true",
                    help="start as a standby (promotes on the primary's "
                         "lease expiry — quorum-gated when --quorum is "
                         "given)")
    ap.add_argument("--no-auto-promote", action="store_true",
                    help="standby never self-promotes (operator-driven "
                         "failover)")
    ap.add_argument("--replicate-to", metavar="ENDPOINT", default=None,
                    help="start as the primary of an HA pair, forwarding "
                         "task-lifecycle records to this standby")
    ap.add_argument("--quorum", metavar="EP,EP,EP", default=None,
                    help="arbiter group endpoints (fluid-quorum); arms "
                         "fenced elections for the pair")
    ap.add_argument("--resource", default="master",
                    help="quorum resource name for the primacy lease")
    ap.add_argument("--pulse-port", type=int, default=None,
                    help="fluid-pulse health endpoint port (0 = "
                         "ephemeral; requires the observe flag, which "
                         "this CLI sets when given)")
    ap.add_argument("--status", action="store_true",
                    help="probe a RUNNING master at --endpoint and print "
                         "its epoch/queue row (no server)")
    args = ap.parse_args(argv)

    from paddle_tpu_torch.master import Master, MasterClient

    if args.status:
        c = MasterClient(args.endpoint, failover_s=0.0)
        try:
            try:
                st = c.ha_status()
            except RuntimeError as e:
                if "unknown command" not in str(e):
                    raise
                st = dict(c.stats(), role="solo(pre-elastic)")
            print(" ".join(f"{k}={st[k]}" for k in sorted(st)))
        finally:
            c.close()
        return 0

    if args.pulse_port is not None:
        import paddle_tpu_torch as fluid
        fluid.set_flag("observe", True)

    qeps = [e for e in (args.quorum or "").split(",") if e] or None
    node = Master(args.endpoint, snapshot_path=args.snapshot,
                  timeout_dur=args.timeout_dur,
                  failure_max=args.failure_max,
                  pulse_port=args.pulse_port)

    def arm():
        if args.standby:
            node.start_standby(lease_s=args.lease_s,
                               auto_promote=not args.no_auto_promote,
                               quorum_endpoints=qeps,
                               quorum_resource=args.resource)
        elif args.replicate_to:
            node.start_replication(args.replicate_to,
                                   lease_s=args.lease_s,
                                   quorum_endpoints=qeps,
                                   quorum_resource=args.resource)

    # arm the HA role BEFORE the listener serves task commands: with a
    # concrete port the endpoint (= the node's quorum identity) is
    # already known, and a recovering standby must never answer a
    # trainer's probe as a solo ruler in the start→arm window. Port 0
    # needs the bind to learn its identity first — ephemeral ports are
    # a tests-only convenience, not a pair deployment shape.
    ephemeral = args.endpoint.rsplit(":", 1)[-1] == "0"
    if not ephemeral:
        arm()
    node.start()
    if ephemeral:
        arm()
    print(f"ENDPOINT {node.endpoint}", flush=True)
    if node.pulse_port is not None:
        print(f"PULSE {node.pulse_port}", flush=True)

    done = threading.Event()

    def _stop(signum, frame):
        node.stop(resign=True)   # planned shutdown: hand the lease back
        done.set()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    done.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
