#!/usr/bin/env python
"""torch_race_lint: concurrency lint CLI over paddle_tpu_torch's Python.

The port's counterpart of ``tools/race_lint.py``, with the same options,
output and exit status:

    # sweep the default target (paddle_tpu_torch/) against the baseline
    python tools/torch_race_lint.py

    # specific files or trees
    python tools/torch_race_lint.py paddle_tpu_torch/serve/

    # machine-readable findings
    python tools/torch_race_lint.py --format json

    # show everything, including baselined residue
    python tools/torch_race_lint.py --no-baseline

    # accept the current findings as the reviewed residue
    python tools/torch_race_lint.py --update-baseline

Exit status: 0 = clean (new-ERROR-free; warnings tolerated unless
--strict), 1 = NEW findings above the threshold, 2 = usage failure —
mirroring tools/torch_paddle_lint.py.

The sweep is `paddle_tpu_torch.analysis.concurrency`: lock-discipline
race detection over `# guarded_by:` annotations (with majority-usage
inference), the cross-class acquires-while-holding deadlock graph, and
hold-time hazards (blocking calls under a lock). The baseline
(tools/torch_race_lint_baseline.json, the port's own; the port sweeps
clean, so it holds no entry) pins triaged residue by line-free key,
so CI fails only on findings that are actually new. Baselined entries
carry a mandatory `note` naming why they are accepted; stale entries
(baselined but no longer reported) are listed so the file stays honest.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

DEFAULT_BASELINE = os.path.join(_REPO, "tools",
                                "torch_race_lint_baseline.json")


def _collect(paths):
    from paddle_tpu_torch.analysis import concurrency as cc

    files = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in sorted(dirnames)
                               if d != "__pycache__"]
                files += [os.path.join(dirpath, f)
                          for f in sorted(filenames) if f.endswith(".py")]
        elif p.endswith(".py"):
            files.append(p)
        else:
            raise SystemExit(f"not a python file or directory: {p!r}")
    if not files:
        raise SystemExit("no .py files to analyze")
    return cc.analyze_paths(files, root=_REPO)


def _load_baseline(path):
    if not os.path.exists(path):
        return {}
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        return {e["key"]: e.get("note", "") for e in doc.get("entries", [])}
    except (OSError, json.JSONDecodeError, KeyError, TypeError) as e:
        raise SystemExit(f"cannot load baseline {path!r}: {e}")


def _write_baseline(path, diags, old):
    from paddle_tpu_torch.analysis.concurrency import baseline_key

    entries, seen = [], set()
    for d in diags:
        key = baseline_key(d)
        if key in seen:
            continue
        seen.add(key)
        entries.append({
            "key": key,
            "note": old.get(key, "TODO: triage — explain why this is "
                                 "by-design or file the fix"),
        })
    doc = {
        "version": 1,
        "comment": "Reviewed concurrency-lint residue of paddle_tpu_torch "
                   "(tools/torch_race_lint.py). Every entry needs a triage "
                   "note: CI (tests/test_torch_tools.py) fails on findings "
                   "missing "
                   "from this file. Keys are line-free "
                   "(code path Class.member detail) so they survive "
                   "unrelated edits. Regenerate with --update-baseline; "
                   "notes are preserved.",
        "entries": entries,
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    return len(entries)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_race_lint",
        description="concurrency static analysis: lock-discipline races, "
                    "deadlock cycles, hold-time hazards")
    ap.add_argument("paths", nargs="*",
                    default=[os.path.join(_REPO, "paddle_tpu_torch")],
                    help="files or trees to analyze "
                         "(default: paddle_tpu_torch/)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="reviewed-residue file (default: "
                         "tools/torch_race_lint_baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, baselined or not")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from the current findings "
                         "(existing triage notes are preserved)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on new warnings too")
    args = ap.parse_args(argv)

    from paddle_tpu_torch.analysis import Severity
    from paddle_tpu_torch.analysis.concurrency import baseline_key

    diags = _collect(args.paths)
    # INFO (guard-inference proposals) never gates and is never baselined
    gating = [d for d in diags if d.severity >= Severity.WARNING]
    info = [d for d in diags if d.severity < Severity.WARNING]

    old = {} if args.no_baseline else _load_baseline(args.baseline)

    if args.update_baseline:
        n = _write_baseline(args.baseline, gating,
                            _load_baseline(args.baseline))
        print(f"wrote {n} entries to {args.baseline}")
        return 0

    new = [d for d in gating if baseline_key(d) not in old]
    seen_keys = {baseline_key(d) for d in gating}
    stale = sorted(k for k in old if k not in seen_keys)

    n_err = sum(d.severity == Severity.ERROR for d in new)
    n_warn = sum(d.severity == Severity.WARNING for d in new)

    if args.format == "json":
        print(json.dumps({
            "errors": n_err, "warnings": n_warn,
            "baselined": len(gating) - len(new), "stale": stale,
            "diagnostics": [dict(d.to_dict(), path=d.path, line=d.line,
                                 key=baseline_key(d)) for d in new],
            "proposals": [dict(d.to_dict(), path=d.path, line=d.line)
                          for d in info],
        }, indent=2))
    else:
        for d in new:
            print(f"{d.severity}: [{d.code}] {d.path}:{d.line}: "
                  f"{d.message}")
        for d in info:
            print(f"{d.severity}: [{d.code}] {d.path}:{d.line}: "
                  f"{d.message}")
        for k in stale:
            print(f"stale baseline entry (no longer reported): {k}")
        print(f"{n_err} new error(s), {n_warn} new warning(s), "
              f"{len(gating) - len(new)} baselined, "
              f"{len(info)} proposal(s), {len(stale)} stale")
    return 1 if (n_err or (args.strict and n_warn)) else 0


if __name__ == "__main__":
    sys.exit(main())
