#!/usr/bin/env python
"""torch_fleet_replica: one serving process of paddle_tpu_torch's fleet
(tools/fleet_replica.py on the port).

Loads a model dir into an InferenceServer, fronts it with a
fleet.ReplicaServer on a TCP endpoint, heartbeats the router's control
endpoint, and (optionally) arms the fluid-pulse health plane so the
router can poll the real HTTP /readyz. Prints, one per line, for the
parent process to read:

    REPLICA <rpc endpoint>
    PULSE <port>            (only with --pulse-port)
    READY

Runs until SIGTERM (clean close: leaves the fleet, drains) or SIGKILL
(the chaos drill's case: the router finds out the hard way).

    python tools/torch_fleet_replica.py --model-dir /models/m \
        --router HOST:PORT [--cpu]
    python tools/torch_fleet_replica.py --model-dir /models/dfm \
        --sparse-endpoints host:4471,host:4472 --sparse-quant int8

The server runs on `CUDAPlace(0)`, or on the host with `--cpu`.
`--device-ms` is the rehearsal knob (see ReplicaServer): it sleeps that
long per request in place of device time, letting a host-only rig
measure router/RPC scaling. Must be 0 (default) in real deployments.
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
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--name", default="m", help="served model name")
    ap.add_argument("--endpoint", default="127.0.0.1:0",
                    help="RPC endpoint to serve on (default ephemeral)")
    ap.add_argument("--replica-id", default=None)
    ap.add_argument("--router", default=None,
                    help="router control endpoint to heartbeat")
    ap.add_argument("--lease-s", type=float, default=3.0)
    ap.add_argument("--buckets", default="1,2,4,8", help="rows ladder")
    ap.add_argument("--batch-timeout-ms", type=float, default=2.0)
    ap.add_argument("--max-queue", type=int, default=512)
    ap.add_argument("--pulse-port", type=int, default=None,
                    help="arm fluid-pulse on this port (0 = ephemeral); "
                    "turns the observe flag on")
    ap.add_argument("--watch-interval-s", type=float, default=0.0,
                    help="> 0: poll the model dir for atomic pushes "
                    "(self-swap outside coordinated swaps)")
    ap.add_argument("--sparse-endpoints", default=None,
                    help="pserver endpoints holding the model's "
                    "distributed lookup tables (comma-separated)")
    ap.add_argument("--sparse-quant", default=None,
                    help="wire codec for row pulls (int8/bf16)")
    ap.add_argument("--sparse-cache-rows", type=int, default=65536)
    ap.add_argument("--device-ms", type=float, default=0.0,
                    help="REHEARSAL ONLY: simulated per-request device "
                    "time (sleep) — see ReplicaServer docstring")
    ap.add_argument("--role", default="both",
                    choices=("prefill", "decode", "both"),
                    help="fluid-torrent pool this replica advertises "
                    "(routing hint; 'both' = all traffic)")
    ap.add_argument("--sim-prefill-us-per-token", type=float, default=0.0,
                    help="REHEARSAL ONLY: simulated per-token prefill "
                    "device time (sleep inside the engine loop) — "
                    "models the compute-bound prefill phase on CPU rigs")
    ap.add_argument("--sim-decode-step-us", type=float, default=0.0,
                    help="REHEARSAL ONLY: simulated per-step decode "
                    "device time — models the memory-bound decode phase")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="turn the observe flag on and export this "
                    "process's chrome trace here at clean shutdown "
                    "(fluid-horizon stitches one per fleet process)")
    ap.add_argument("--cpu", action="store_true",
                    help="serve on the host, not the card")
    args = ap.parse_args(argv)

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import fleet, serve
    from paddle_tpu_torch.observe import xray

    rid = args.replica_id or f"r{os.getpid()}"
    xray.set_process_name(f"replica-{rid}")
    if args.pulse_port is not None or args.trace_out:
        fluid.set_flag("observe", True)

    srv = serve.InferenceServer(
        fluid.CPUPlace() if args.cpu else fluid.CUDAPlace(0),
        serve.ServeConfig(batch_timeout_ms=args.batch_timeout_ms,
                          max_queue=args.max_queue,
                          watch_interval_s=args.watch_interval_s or 2.0,
                          pulse_port=args.pulse_port,
                          simulate_prefill_us_per_token=(
                              args.sim_prefill_us_per_token),
                          simulate_decode_step_us=args.sim_decode_step_us))
    sparse = None
    if args.sparse_endpoints:
        sparse = fleet.SparseServeConfig(
            [e for e in args.sparse_endpoints.split(",") if e],
            comm_quant=args.sparse_quant,
            cache_rows=args.sparse_cache_rows)
    # generative dirs (a __decode__ sidecar in the manifest) derive
    # their ladder from the decode signature; an explicit rows ladder
    # is the dense one-shot path's knob only
    from paddle_tpu_torch.serve.registry import read_decode_signature
    ladder = None
    if read_decode_signature(args.model_dir) is None:
        ladder = serve.BucketLadder(
            rows=tuple(int(b) for b in args.buckets.split(",")))
    srv.add_model(args.name, args.model_dir, ladder=ladder, sparse=sparse)
    if args.watch_interval_s > 0:
        srv.start_watch(args.watch_interval_s)

    rep = fleet.ReplicaServer(srv, endpoint=args.endpoint, replica_id=rid,
                              router_endpoint=args.router,
                              lease_s=args.lease_s,
                              simulate_device_ms=args.device_ms,
                              role=args.role).start()
    print(f"REPLICA {rep.endpoint}", flush=True)
    if srv.pulse_port is not None:
        print(f"PULSE {srv.pulse_port}", flush=True)
    print("READY", flush=True)

    done = threading.Event()

    def _term(signum, frame):
        done.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    done.wait()
    rep.close()
    if args.trace_out:
        from paddle_tpu_torch.observe import get_tracer
        get_tracer().export_chrome(args.trace_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
