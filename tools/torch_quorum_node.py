#!/usr/bin/env python
"""torch_quorum_node: run one fluid-quorum arbiter of paddle_tpu_torch as
its own process (tools/quorum_node.py's flags and output, on the port's
`quorum/`; the arbiter is host code and touches no card).

    python tools/torch_quorum_node.py --endpoint 127.0.0.1:0 \
        --data-dir /var/q [--node-id n0] [--status RESOURCE]

A production quorum is 3 (or 5) of these on separate failure domains;
tests and the chaos drills run them in-process instead (the rpc fault
hook — the partition injector — only reaches in-process messages).

Prints "ENDPOINT <host:port>" once listening (ephemeral-port friendly),
then parks until SIGTERM/SIGINT, which stops the node cleanly — its
persisted epoch file (`<data-dir>/<node-id>_quorum_epochs.json`, ark
atomic-write + sha256 sidecar) survives the restart and the node
re-opens under a boot blackout sized to the longest lease it ever
granted, so a crashed arbiter can never regress an epoch or hand a
rival a too-early vote.

`--status RESOURCE` (no server): print the node's persisted epoch and
exit — the operator's "which epoch did this arbiter promise" probe.
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
    ap.add_argument("--data-dir", required=True,
                    help="dir for the persisted epoch file")
    ap.add_argument("--node-id", default=None,
                    help="stable node identity (default: derived from "
                         "the bound port — pass one explicitly when the "
                         "endpoint uses port 0 and restarts must find "
                         "the same epoch file)")
    ap.add_argument("--status", metavar="RESOURCE", default=None,
                    help="print the persisted epoch for RESOURCE and "
                         "exit (no server)")
    args = ap.parse_args(argv)

    from paddle_tpu_torch.quorum import QuorumNode, QuorumStore

    if args.status is not None:
        store = QuorumStore(args.data_dir, args.node_id or "q0")
        print(f"{args.status} epoch={store.epoch(args.status)} "
              f"lease_s={store.lease_s(args.status)}")
        return 0

    node = QuorumNode(args.endpoint, args.data_dir,
                      node_id=args.node_id).start()
    print(f"ENDPOINT {node.endpoint}", flush=True)

    done = threading.Event()

    def _stop(signum, frame):
        node.stop()
        done.set()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    done.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
