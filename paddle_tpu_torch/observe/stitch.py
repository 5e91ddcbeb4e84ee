"""fluid-horizon stitching: causal cross-process trace assembly.

`tracer.merge_chrome_traces` puts every process's spans on one timeline,
but the result is still N parallel tracks: nothing in the merged file
SHOWS that the router's `fleet:infer` span caused the replica's
`replica:infer` which caused the pserver's `rpc_server:pull_sparse`.
This module turns the merge into a CAUSAL stitch:

- **Flow events.** Every cross-process parent→child span edge (the
  child's ``parent_span_id`` names a span recorded in a DIFFERENT
  process) becomes a chrome flow arrow (``ph:"s"`` at the client span,
  ``ph:"f"`` at the server span), so perfetto draws the request hopping
  router → replica → pserver instead of three unrelated tracks.

- **Clock-skew correction.** Per-process wall clocks drift; an
  uncorrected merge can show the server handler STARTING before the
  client sent the request. Every cross-process RPC edge gives one skew
  observation: the server span sits inside the client span's round
  trip, so ``offset = client_midpoint − server_midpoint`` estimates the
  server clock's error relative to the client (exact when the two
  network legs are symmetric). We take the median observation per
  directed process pair, then BFS the pair graph from a reference
  process, shifting every event of each reached process — the same
  midpoint estimator NTP uses, applied post-hoc.

- **Tree queries.** `trace_tree(events, trace_id)` indexes one trace's
  spans into roots/children/orphans so a drill (or the e2e pinned test)
  can assert "one trace, ≥3 processes, no orphans" in three lines.

Only spans carrying fluid-xray identity (``args.trace_id``/``span_id``)
participate in stitching; plain tracer spans ride through untouched.

Copy of ``paddle_tpu/observe/stitch.py``, its imports rewired to this
package.
"""

from __future__ import annotations

import json
import statistics
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from . import tracer as _tracer


def _span_args(ev: dict) -> dict:
    a = ev.get("args")
    return a if isinstance(a, dict) else {}


def _xray_spans(events: Sequence[dict]) -> List[dict]:
    """The "X" events carrying fluid-xray identity."""
    return [ev for ev in events
            if ev.get("ph") == "X" and _span_args(ev).get("span_id")]


def span_index(events: Sequence[dict]) -> Dict[Tuple[str, str], dict]:
    """(trace_id, span_id) -> event, over xray-identified spans. A
    duplicate identity keeps the FIRST occurrence (per-attempt retry
    spans always allocate fresh ids, so duplicates only arise from
    merging the same file twice — harmless either way)."""
    idx: Dict[Tuple[str, str], dict] = {}
    for ev in _xray_spans(events):
        a = _span_args(ev)
        idx.setdefault((a["trace_id"], a["span_id"]), ev)
    return idx


def cross_process_edges(events: Sequence[dict]) -> List[Tuple[dict, dict]]:
    """Every (parent_event, child_event) pair where the child's
    parent_span_id resolves to a span recorded under a DIFFERENT pid —
    i.e. the causal hops a flow arrow should draw."""
    idx = span_index(events)
    edges = []
    for ev in _xray_spans(events):
        a = _span_args(ev)
        parent_id = a.get("parent_span_id")
        if not parent_id:
            continue
        parent = idx.get((a["trace_id"], parent_id))
        if parent is not None and parent.get("pid") != ev.get("pid"):
            edges.append((parent, ev))
    return edges


def _midpoint_us(ev: dict) -> float:
    return ev.get("ts", 0) + ev.get("dur", 0) / 2.0


def estimate_skew_us(events: Sequence[dict],
                     reference_pid: Optional[int] = None
                     ) -> Dict[int, float]:
    """Per-pid clock offset (µs to ADD to that pid's timestamps), from
    cross-process RPC edges: each edge's server span nests inside the
    client's round trip, so client_mid − server_mid observes the server
    clock's error. Median per directed pid pair, then BFS from
    `reference_pid` (default: the pid with the most xray spans) so
    indirectly-connected processes (trainer→pserver→haven backup) are
    corrected transitively. Pids unreachable from the reference keep
    offset 0 — an uncorrectable clock is left honest, not guessed."""
    spans = _xray_spans(events)
    if not spans:
        return {}
    if reference_pid is None:
        counts: Dict[int, int] = {}
        for ev in spans:
            counts[ev.get("pid", 0)] = counts.get(ev.get("pid", 0), 0) + 1
        reference_pid = max(counts, key=lambda p: (counts[p], -p))
    # directed pair (client_pid, server_pid) -> skew observations
    obs: Dict[Tuple[int, int], List[float]] = {}
    for parent, child in cross_process_edges(events):
        key = (parent.get("pid", 0), child.get("pid", 0))
        obs.setdefault(key, []).append(
            _midpoint_us(parent) - _midpoint_us(child))
    # undirected adjacency with the median offset in the client->server
    # direction (server_offset = client_offset + median)
    adj: Dict[int, List[Tuple[int, float]]] = {}
    for (cpid, spid), vals in obs.items():
        med = statistics.median(vals)
        adj.setdefault(cpid, []).append((spid, med))
        adj.setdefault(spid, []).append((cpid, -med))
    offsets: Dict[int, float] = {reference_pid: 0.0}
    q = deque([reference_pid])
    while q:
        pid = q.popleft()
        for other, delta in adj.get(pid, []):
            if other not in offsets:
                offsets[other] = offsets[pid] + delta
                q.append(other)
    return offsets


def stitch_traces(paths: Sequence[str], out_path: Optional[str] = None,
                  strict: bool = False, skew_correct: bool = True
                  ) -> Tuple[dict, dict]:
    """Merge per-process chrome traces AND make the result causal:
    clock-skew-correct each process onto the reference clock, then emit
    flow events for every cross-process span edge. Returns
    (stitched_doc, stats); stats extends the merge stats with
    ``edges`` (flow arrows emitted), ``skew_us`` (per-pid applied
    shift), and ``orphans`` (xray spans whose parent id resolves
    nowhere in the merge — 0 in a healthy full capture)."""
    doc, stats = _tracer.merge_chrome_traces(paths, strict=strict)
    events = doc["traceEvents"]
    spans = [ev for ev in events if ev.get("ph") != "M"]
    if skew_correct:
        offsets = estimate_skew_us(spans)
        for ev in spans:
            off = offsets.get(ev.get("pid", 0), 0.0)
            if off:
                ev["ts"] = int(ev.get("ts", 0) + off)
        stats["skew_us"] = {str(pid): round(off, 1)
                            for pid, off in offsets.items() if off}
    else:
        stats["skew_us"] = {}
    flows: List[dict] = []
    for i, (parent, child) in enumerate(cross_process_edges(spans)):
        trace_id = _span_args(child).get("trace_id", "")
        flow = {"cat": "xray_flow", "name": "xray",
                "id": f"{trace_id[:8]}:{i}"}
        flows.append(dict(flow, ph="s", pid=parent["pid"],
                          tid=parent.get("tid", 0),
                          ts=int(_midpoint_us(parent))))
        flows.append(dict(flow, ph="f", bp="e", pid=child["pid"],
                          tid=child.get("tid", 0),
                          ts=int(child.get("ts", 0))))
    stats["edges"] = len(flows) // 2
    idx = span_index(spans)
    orphans = []
    for ev in _xray_spans(spans):
        a = _span_args(ev)
        pid_ = a.get("parent_span_id")
        if pid_ and (a["trace_id"], pid_) not in idx:
            orphans.append(a.get("span_id"))
    stats["orphans"] = len(orphans)
    spans.sort(key=lambda e: e.get("ts", 0))
    meta = [ev for ev in events if ev.get("ph") == "M"]
    doc = {"traceEvents": meta + spans + flows, "displayTimeUnit": "ms"}
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(doc, f)
    return doc, stats


def trace_tree(events: Sequence[dict], trace_id: str) -> dict:
    """Index ONE trace's spans into a parentage tree:

        {"roots": [event...],              # spans with no parent
         "orphans": [event...],            # parent id resolves nowhere
         "children": {span_id: [event...]},
         "spans": {span_id: event},
         "pids": {pid...}}

    The e2e contract a stitched capture must satisfy: one root, zero
    orphans, and `pids` spanning every process the request touched."""
    spans = [ev for ev in _xray_spans(events)
             if _span_args(ev).get("trace_id") == trace_id]
    by_id = {_span_args(ev)["span_id"]: ev for ev in spans}
    roots, orphans = [], []
    children: Dict[str, List[dict]] = {}
    for ev in spans:
        parent_id = _span_args(ev).get("parent_span_id")
        if not parent_id:
            roots.append(ev)
        elif parent_id in by_id:
            children.setdefault(parent_id, []).append(ev)
        else:
            orphans.append(ev)
    return {"roots": roots, "orphans": orphans, "children": children,
            "spans": by_id, "pids": {ev.get("pid") for ev in spans}}
