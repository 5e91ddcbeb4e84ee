#!/usr/bin/env python3
"""fluid-horizon observatory: scrape a live fleet's pulse endpoints
into one queryable time-series view.

The port's counterpart of tools/observatory.py, over
`paddle_tpu_torch.observe`'s `scrape` and `stitch` (no jax, nothing of
paddle_tpu). The endpoints are the same in both packages, so it reads a
process of either.

    # live table, refreshed each scrape interval (ctrl-C to stop)
    python tools/torch_observatory.py replica0=8471 replica1=8472 --watch

    # scrape a few rounds, print one machine-readable snapshot
    python tools/torch_observatory.py replica0=8471 --rounds 5 --json

    # fetch every target's /trace ring, stitch (skew-corrected, with
    # causal flow arrows) into one chrome://tracing timeline
    python tools/torch_observatory.py replica0=8471 t1=8472 \
        --dump-trace fleet.json

Targets are `job=url` pairs; a bare port means 127.0.0.1. Everything
rides the pulse endpoints (`/metrics`, `/trace`) — processes need
`observe.start_pulse()`, nothing else.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_targets(specs):
    targets = []
    for i, spec in enumerate(specs):
        if "=" in spec:
            job, url = spec.split("=", 1)
        else:
            job, url = f"target{i}", spec
        targets.append((job, url))
    if not targets:
        raise SystemExit("no targets; pass job=url (or job=port) pairs")
    return targets


def _fmt(v, scale=1.0, suffix=""):
    if v is None:
        return "-"
    return f"{v * scale:.1f}{suffix}"


def overview_table(sc, window_s):
    o = sc.fleet_overview(window_s=window_s)
    rows = [
        ("targets up", f"{o['targets_up']}/{o['targets']}"),
        ("serve qps", _fmt(o["serve_qps"])),
        ("fleet qps", _fmt(o["fleet_qps"])),
        ("request p50", _fmt(o["request_p50_us"], 1e-3, " ms")),
        ("request p99", _fmt(o["request_p99_us"], 1e-3, " ms")),
        ("decode occupancy", _fmt(o["decode_occupancy"])),
        ("max repl lag", _fmt(o["max_ps_replication_lag"])),
        ("ps rpc qps", _fmt(o["ps_rpc_qps"])),
        ("master todo", _fmt(o["master_tasks_todo"])),
    ]
    width = max(len(k) for k, _ in rows)
    return "\n".join(f"  {k:<{width}}  {v}" for k, v in rows)


def dump_trace(sc, out_path):
    from paddle_tpu_torch.observe import scrape, stitch

    paths, skipped = [], []
    with tempfile.TemporaryDirectory(prefix="observatory_") as td:
        for t in sc.targets():
            job, url = t["job"], t["url"]
            try:
                doc = scrape.fetch_trace(url)
            except Exception as e:
                skipped.append((job, f"{type(e).__name__}: {e}"))
                continue
            p = os.path.join(td, f"{job}.json")
            with open(p, "w") as f:
                json.dump(doc, f)
            paths.append(p)
        for job, why in skipped:
            print(f"observatory: skipping {job}: {why}", file=sys.stderr)
        if not paths:
            raise SystemExit("no target served a /trace ring")
        _doc, stats = stitch.stitch_traces(paths, out_path=out_path)
    print(f"wrote {out_path}: {stats['spans_out']} spans from "
          f"{len(paths)} process(es), {stats['edges']} cross-process "
          f"edge(s), {stats['orphans']} orphan(s), "
          f"skew_us={stats['skew_us']}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_observatory",
        description="scraping observatory over fluid-pulse endpoints")
    ap.add_argument("targets", nargs="*", metavar="JOB=URL",
                    help="pulse endpoints (bare port = 127.0.0.1)")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="seconds between scrape rounds")
    ap.add_argument("--window", type=float, default=30.0,
                    help="query window for rates/percentiles (s)")
    ap.add_argument("--rounds", type=int, default=3,
                    help="scrape rounds before a one-shot output")
    ap.add_argument("--watch", action="store_true",
                    help="continuous table (ctrl-C to stop)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print a snapshot of every series + overview")
    ap.add_argument("--dump-trace", metavar="OUT",
                    help="stitch every target's /trace ring into OUT")
    args = ap.parse_args(argv)

    from paddle_tpu_torch.observe import scrape

    sc = scrape.Scraper(parse_targets(args.targets),
                        interval_s=args.interval)

    if args.dump_trace:
        return dump_trace(sc, args.dump_trace)

    if args.watch:
        sc.start()
        try:
            while True:
                time.sleep(args.interval)
                print(f"\n== observatory @ round {sc.rounds()} "
                      f"(window {args.window:g}s) ==")
                print(overview_table(sc, args.window))
        except KeyboardInterrupt:
            return 0
        finally:
            sc.stop()

    for _ in range(max(1, args.rounds)):
        sc.poll_once()
        time.sleep(args.interval)
    if args.as_json:
        print(json.dumps(sc.snapshot(window_s=args.window), indent=2,
                         sort_keys=True))
    else:
        print(overview_table(sc, args.window))
    return 0


if __name__ == "__main__":
    sys.exit(main())
