#!/usr/bin/env python3
"""fluid-horizon metrics-catalog drift lint, over paddle_tpu_torch.

The port's counterpart of tools/metrics_lint.py: every metric name
`paddle_tpu_torch/` can emit through `observe.metrics` must have a row
in the "## Metric catalog" table of docs/OBSERVABILITY.md (read only:
the catalog is the JAX package's, and the port emits the same names) —
and every catalog row should still correspond to an emitter. Metrics
are an interface: dashboards, the observatory's derived series, and
alert rules key on these names, so a rename that skips the catalog is
a silent break for every consumer. The lint runs as a tier-1 test
(tests/test_torch_tools.py). A catalog row with no emitter in the port
is a plane the port has not ported yet (ROADMAP Queue 1 item 8), so
stale rows only warn unless `--strict`.

Emitted names are discovered statically:

  * string-literal first arguments of ``counter(`` / ``gauge(`` /
    ``histogram(`` call sites (any receiver, newlines tolerated), and
  * module-level ``*_METRIC = "..."`` / ``*_SERIES = "..."`` constants
    (the repo's idiom for names shared between emitter and tests).

Names built dynamically (f-strings, concatenation) are invisible to
the scan; keep metric names literal — that is the point of a catalog.

Exit status: 0 = clean (stale catalog rows only warn), 1 = emitted
metric missing from the catalog (or --strict and warnings), 2 = usage
failure.  `--list` prints the discovered emitted names and exits.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CATALOG_HEADING = "## Metric catalog"

# string-literal first argument of a counter/gauge/histogram call.
# The receiver is irrelevant (self._metrics.counter, reg.gauge, ...);
# requiring the '(' to follow the method name directly keeps matches
# honest, and \s* tolerates a line break before the literal.
_CALL_RE = re.compile(
    r"\b(?:counter|gauge|histogram)\(\s*[\"']([a-z][a-z0-9_]*)[\"']")

# ALERTS_METRIC = "health_alerts_total" / UP_SERIES = "horizon_up"
_CONST_RE = re.compile(
    r"^\s*[A-Z][A-Z0-9_]*(?:_METRIC|_SERIES)\s*=\s*[\"']"
    r"([a-z][a-z0-9_]*)[\"']", re.M)

# catalog table row: | `name` | kind | source | description |
_ROW_RE = re.compile(r"^\|\s*`([a-z][a-z0-9_]*)`\s*\|", re.M)


def scan_emitted(pkg_root: str) -> dict:
    """Map of metric name -> sorted list of repo-relative files that
    can emit it."""
    emitted: dict = {}
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            try:
                with open(path, encoding="utf-8") as f:
                    text = f.read()
            except OSError:
                continue
            rel = os.path.relpath(path, REPO)
            for rx in (_CALL_RE, _CONST_RE):
                for name in rx.findall(text):
                    emitted.setdefault(name, set()).add(rel)
    return {k: sorted(v) for k, v in emitted.items()}


def parse_catalog(doc_path: str):
    """Names from the catalog table, plus whether the section exists."""
    try:
        with open(doc_path, encoding="utf-8") as f:
            text = f.read()
    except OSError as e:
        raise SystemExit(f"cannot read {doc_path!r}: {e}")
    start = text.find(CATALOG_HEADING)
    if start < 0:
        return None
    # section runs until the next heading of depth <= 2
    m = re.search(r"^#{1,2} ", text[start + len(CATALOG_HEADING):], re.M)
    section = text[start:] if m is None \
        else text[start:start + len(CATALOG_HEADING) + m.start()]
    return set(_ROW_RE.findall(section))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_metrics_lint",
        description="catalog drift check: metric names paddle_tpu_torch "
                    "emits vs the docs/OBSERVABILITY.md metric catalog")
    ap.add_argument("--doc", default=os.path.join(REPO, "docs",
                                                  "OBSERVABILITY.md"))
    ap.add_argument("--pkg", default=os.path.join(REPO, "paddle_tpu_torch"))
    ap.add_argument("--list", action="store_true",
                    help="print emitted names with their source files")
    ap.add_argument("--strict", action="store_true",
                    help="stale catalog rows fail too")
    args = ap.parse_args(argv)

    if not os.path.isdir(args.pkg):
        raise SystemExit(f"package root {args.pkg!r} is not a directory")
    emitted = scan_emitted(args.pkg)

    if args.list:
        for name in sorted(emitted):
            print(f"{name}  ({', '.join(emitted[name])})")
        return 0

    catalog = parse_catalog(args.doc)
    if catalog is None:
        print(f"ERROR: {os.path.relpath(args.doc, REPO)} has no "
              f"{CATALOG_HEADING!r} section")
        return 1

    missing = sorted(set(emitted) - catalog)
    stale = sorted(catalog - set(emitted))

    for name in missing:
        print(f"ERROR: emitted metric `{name}` missing from catalog "
              f"({', '.join(emitted[name])})")
    for name in stale:
        print(f"WARNING: catalog row `{name}` has no emitter "
              f"(renamed or removed?)")

    print(f"metrics_lint: {len(emitted)} emitted, {len(catalog)} "
          f"cataloged, {len(missing)} missing, {len(stale)} stale")
    return 1 if (missing or (args.strict and stale)) else 0


if __name__ == "__main__":
    sys.exit(main())
