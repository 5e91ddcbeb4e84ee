#!/usr/bin/env python
"""torch_ps_worker: a paddle_tpu_torch parameter-server process with the
black box armed (tools/ps_worker.py's flags, output and dumps, on the
port's `pserver/`; the server is numpy on the host and touches no card).

The 2-process trace drill (tools/torch_chaos_drill.py --scenario
dist_trace) and the health-alerts drill spawn this as the SERVER half
of a trainer+pserver job: it starts a ParameterServer, names its
process for the merged chrome timeline, and installs the flight
recorder so a SIGTERM (the drill's kill) leaves BOTH postmortem
artifacts before the process dies:

    <out>/trace_<name>.json     this process's chrome trace (server-side
                                RPC handler spans, trace ids from the
                                client's frames)
    <out>/flight_<name>.json    the flight-recorder dump (recent RPC
                                outcomes, lease transitions, the signal)

Prints "ENDPOINT <host:port>" on stdout once listening (ephemeral-port
friendly), then parks until killed.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--endpoint", default="127.0.0.1:0")
    ap.add_argument("--name", default="pserver0",
                    help="process name in the merged chrome timeline")
    ap.add_argument("--out", required=True,
                    help="dir for the trace + flight dumps")
    ap.add_argument("--trainers", type=int, default=1)
    ap.add_argument("--pulse-port", type=int, default=None,
                    help="start the fluid-pulse health endpoint on this "
                         "port (0 = ephemeral); prints 'PULSE <port>'")
    args = ap.parse_args(argv)

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.observe import flight, xray
    from paddle_tpu_torch.pserver.server import ParameterServer

    fluid.set_flag("observe", True)
    xray.set_process_name(args.name)
    os.makedirs(args.out, exist_ok=True)
    trace_path = os.path.join(args.out, f"trace_{args.name}.json")

    def export_trace():
        from paddle_tpu_torch.observe import get_tracer
        get_tracer().export_chrome(trace_path)

    # SIGTERM -> flight dump + chrome trace export + exit(1): the black
    # box writes BEFORE the process dies, which is the whole point
    flight.install(os.path.join(args.out, f"flight_{args.name}.json"),
                   extra=export_trace)
    flight.set_stage("serving")

    srv = ParameterServer(args.endpoint, trainers=args.trainers,
                          pulse_port=args.pulse_port).start()
    print(f"ENDPOINT {srv.endpoint}", flush=True)
    if srv.pulse_port is not None:
        print(f"PULSE {srv.pulse_port}", flush=True)
    threading.Event().wait()   # park; SIGTERM tears us down


if __name__ == "__main__":
    main()
