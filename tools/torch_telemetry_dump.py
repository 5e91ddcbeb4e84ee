#!/usr/bin/env python3
"""Print/export the fluid-scope telemetry of an instrumented run of
paddle_tpu_torch.

The port's counterpart of tools/telemetry_dump.py, over
`paddle_tpu_torch.observe` (no jax, nothing of paddle_tpu). Runs a small
prepared-program training loop with the `observe` flag on — on
`CUDAPlace(0)`, or on the host with `--cpu` — then dumps the metrics
registry, the step-phase summary, and the plan-build observatory (the
port's counterpart of the JAX package's recompilation observatory: a
new step plan is its "compile"). The interesting CI mode:

    python tools/torch_telemetry_dump.py --assert-no-recompiles
        exit 0 when the steady-state run built each program's plan
        exactly once (only `first_call` events)

    python tools/torch_telemetry_dump.py --assert-no-recompiles --two-shapes
        feeds the SAME model two distinct batch shapes -> the second
        shape is a new feed signature on a bound plan, attributed
        `feed_shape` -> exit 1. This is the runtime counterpart of
        fluid-lint's static feed-shape recompile-hazard warning: the
        lint predicts the hazard, the observatory proves whether it
        fired.

Serving runs (serve/) tag their events with source="serving": a failure
whose cause is `padding_bucket` means the bucket ladder is mis-sized
(the planner emitted a shape warmup never planned — fix the ladder),
while `feed_shape`/anything else on a serving source is a genuine
plan-cache bug. Warmup plans (`warmup`, `first_call`) are expected
and never fail the assertion.

Other output modes: --format json (default) | prom (Prometheus text
exposition) | table (human summary — includes the fluid-wire
per-command compression table, raw -> on-wire bytes with the ratio,
whenever the run recorded pserver traffic); --trace PATH writes the
unified chrome://tracing timeline (open in chrome://tracing or
perfetto).

Live-process mode (fluid-pulse):

    python tools/torch_telemetry_dump.py --url http://host:port [--format ...]

reads a RUNNING process's pulse endpoint instead of running the local
demo loop: `--format prom` prints its `/metrics` scrape verbatim,
`json`/`table` render its `/status` document — the SAME shape the
in-process path prints, so one tool reads dead and live processes.

Multi-process stitch (fluid-xray):

    python tools/torch_telemetry_dump.py --merge merged.json t0.json ps0.json

merges per-process trace files (each written by `Tracer.export_chrome`
in its own process, with its real pid + process_name metadata) into ONE
timeline. Exit 1 if any span would be dropped — a merge that loses
spans is a broken postmortem. Client and server halves of one RPC share
a trace id (`args.trace_id`), so the merged file shows the cross-process
call tree.

Exit status: 0 clean, 1 an assertion or a read failed, 2 usage (and no
card visible without `--cpu`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_model(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=16, act="relu")
        pred = fluid.layers.fc(input=h, size=4, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def print_status_table(doc):
    """Human summary of a status document — shared by the in-process
    path and `--url` (identical output for identical telemetry)."""
    from paddle_tpu_torch.wire import wire_table_from_snapshot

    steps = doc["steps"]
    print(f"steps: {steps['steps']}  "
          f"mean {steps['mean_step_us']:.1f} us/step")
    for phase, us in sorted(steps["phase_us"].items(),
                            key=lambda kv: -kv[1]):
        print(f"  {phase:<16} {us:>12.1f} us total")
    print("recompiles:", doc["recompiles"]["counts"] or "none")
    mem = doc.get("memory") or {}
    if mem.get("programs"):
        print(f"memory: peak est {mem['estimate_peak_bytes'] / 1e6:.2f} MB "
              f"over {len(mem['programs'])} program(s)"
              + (f", live {mem['bytes_in_use'] / 1e6:.2f} MB in use"
                 if mem.get("live") else " (estimate-only: no device "
                 "memory stats on this backend)"))
    alerts = doc.get("alerts") or []
    if alerts:
        print(f"ALERTS ({len(alerts)} active):")
        for a in alerts:
            print(f"  [{a['rule']}] {a['message']}")
    else:
        print("alerts: none")
    for line in wire_table_from_snapshot(doc["metrics"]):
        print(line)
    print("metrics:", ", ".join(sorted(doc["metrics"])))


def _fetch(url: str, timeout: float = 10.0):
    """(status, body) — or (None, error string) when the process is
    unreachable (dead, refused, timed out): the common case for a tool
    that exists to read live processes must exit cleanly, not
    traceback."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()
    except (urllib.error.URLError, OSError) as e:
        return None, str(e)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="dump fluid-scope telemetry of a short prepared run "
                    "of paddle_tpu_torch")
    ap.add_argument("--url", metavar="http://host:port",
                    help="read a LIVE process's pulse endpoint instead of "
                         "running the local demo loop")
    ap.add_argument("--cpu", action="store_true",
                    help="run the demo loop on the host (default: "
                         "CUDAPlace(0))")
    ap.add_argument("--steps", type=int, default=3,
                    help="training steps to run (default 3)")
    ap.add_argument("--two-shapes", action="store_true",
                    help="alternate two batch sizes (provokes a "
                         "feed_shape recompile)")
    ap.add_argument("--assert-no-recompiles", action="store_true",
                    help="exit 1 if any plan-build event beyond "
                         "first_call was recorded (CI gate)")
    ap.add_argument("--format", choices=("json", "prom", "table"),
                    default="json")
    ap.add_argument("--trace", metavar="PATH",
                    help="also write the chrome://tracing timeline here")
    ap.add_argument("--merge", metavar="OUT",
                    help="stitch per-process chrome trace files (the "
                         "positional args) into OUT and exit; exit 1 if "
                         "the merge would drop spans")
    ap.add_argument("inputs", nargs="*",
                    help="input trace files for --merge")
    args = ap.parse_args(argv)

    if args.merge:
        from paddle_tpu_torch.observe.tracer import merge_chrome_traces
        if not args.inputs:
            print("--merge needs at least one input trace file",
                  file=sys.stderr)
            return 1
        doc, stats = merge_chrome_traces(args.inputs, out_path=args.merge)
        print(json.dumps(stats, indent=2, sort_keys=True))
        if stats["spans_out"] != stats["spans_in"]:
            print(f"MERGE DROPPED SPANS: {stats['spans_in']} in, "
                  f"{stats['spans_out']} out", file=sys.stderr)
            return 1
        print(f"merged {stats['spans_in']} spans from "
              f"{len(args.inputs)} file(s) -> {args.merge}",
              file=sys.stderr)
        return 0

    if args.url:
        base = args.url.rstrip("/")
        if args.format == "prom":
            code, body = _fetch(f"{base}/metrics")
            if code != 200:
                print(f"GET {base}/metrics -> "
                      f"{code if code is not None else body}",
                      file=sys.stderr)
                return 1
            sys.stdout.write(body.decode())
            return 0
        code, body = _fetch(f"{base}/status")
        if code != 200:
            print(f"GET {base}/status -> "
                  f"{code if code is not None else body}", file=sys.stderr)
            return 1
        doc = json.loads(body)
        if args.format == "table":
            print_status_table(doc)
        else:
            print(json.dumps(doc, indent=2, sort_keys=True, default=str))
        return 0

    import numpy as np
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device is visible (torch.cuda.is_available() is "
              "False); pass --cpu to run the demo loop on the host",
              file=sys.stderr)
        return 2

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import observe

    fluid.set_flag("observe", True)

    main_p, startup, loss = build_model(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace() if args.cpu
                         else fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    prepared = exe.prepare(main_p, fetch_list=[loss], scope=scope)

    rng = np.random.RandomState(0)
    batch_sizes = (8, 12) if args.two_shapes else (8,)
    for i in range(max(args.steps, 1)):
        bs = batch_sizes[i % len(batch_sizes)]
        prepared.run({"x": rng.randn(bs, 16).astype(np.float32),
                      "y": rng.randint(0, 4, (bs, 1)).astype(np.int64)})

    reg = observe.default_registry()
    obsv = observe.observatory()

    if args.format == "prom":
        print(reg.to_prometheus())
    else:
        # the in-process document is pulse.status_document(): identical
        # in shape to a live /status scrape, so --url and the local demo
        # render through the SAME printers. Built only on these branches
        # — it evaluates detectors and probes device memory, side
        # effects a prom scrape must not pay for. json_safe keeps the
        # local json output strict-parseable (and byte-compatible with
        # the --url path) when a metric or alert carries NaN/inf.
        from paddle_tpu_torch.observe.flight import json_safe
        doc = json_safe(observe.pulse.status_document())
        if args.format == "table":
            print_status_table(doc)
        else:
            print(json.dumps(doc, indent=2, sort_keys=True, default=str))

    if args.trace:
        observe.get_tracer().export_chrome(args.trace)
        print(f"chrome trace written to {args.trace}", file=sys.stderr)

    if args.assert_no_recompiles:
        bad = obsv.unexpected()
        if bad:
            causes = sorted({e.cause for e in bad})
            print(f"ASSERT-NO-RECOMPILES FAILED: {len(bad)} plan-build "
                  f"event(s) beyond first_call, cause(s): "
                  f"{', '.join(causes)}", file=sys.stderr)
            for e in bad:
                print(f"  {e!r} detail={e.detail}", file=sys.stderr)
            return 1
        print("assert-no-recompiles: OK (every program planned exactly "
              "once)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
