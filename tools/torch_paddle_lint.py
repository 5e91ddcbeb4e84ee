#!/usr/bin/env python
"""torch_paddle_lint: static verification CLI over serialized Programs
and book models, over paddle_tpu_torch.

The port's counterpart of ``tools/paddle_lint.py``, with the same
options, output and exit status:

    # lint a serialized program (Program.serialize_to_string JSON)
    python tools/torch_paddle_lint.py /path/to/program.json

    # lint a model-zoo graph, with (default) or without its training ops
    python tools/torch_paddle_lint.py --model mnist
    python tools/torch_paddle_lint.py --model transformer --no-train

    # machine-readable findings
    python tools/torch_paddle_lint.py --format json program.json

Exit status: 0 = clean (or warnings only), 1 = ERROR-severity findings,
2 = usage/load failure. `--strict` promotes warnings to the failing set.

The sweep is `paddle_tpu_torch.analysis.analyze_program`: structural
verifier, whole-program shape/dtype cross-check, and the lints (float64
use, dead ops relative to fetch targets, feed-shape hazards). The sweep
is static: nothing runs on a device. Fetch
targets default to the model's declared fetches; pass --fetch for
serialized programs so the dead-op lint has roots.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _load_model(name: str, train: bool):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import models

    mod = getattr(models, name, None)
    if mod is None or not hasattr(mod, "build"):
        known = sorted(m for m in dir(models)
                       if hasattr(getattr(models, m), "build"))
        raise SystemExit(f"unknown model {name!r}; known: {known}")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        feeds, fetches = _small_build(mod, name)
        if train:
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(
                fetches["loss"])
    return (main, sorted(feeds), [v.name for v in fetches.values()])


def _small_build(mod, name: str):
    """Small shapes where the default config is benchmark-sized: the lint
    is structural, and a dict_size=30000 embedding adds nothing but
    shape-walk time."""
    small = {
        "resnet": dict(class_dim=10, depth=50, image_shape=(3, 64, 64)),
        "se_resnext": dict(class_dim=10, image_shape=(3, 64, 64)),
        "vgg": dict(class_dim=10, image_shape=(3, 32, 32)),
        "stacked_dynamic_lstm": dict(dict_size=200, emb_dim=16,
                                     hidden_dim=16, stacked_num=2),
        "machine_translation": dict(dict_size=200, emb_dim=16,
                                    hidden_dim=16),
        "deepfm": dict(num_fields=8, sparse_feature_dim=1000,
                       embedding_size=8),
    }
    return mod.build(**small.get(name, {}))


def _load_json(path: str):
    from paddle_tpu_torch.core import ir

    try:
        with open(path) as f:
            prog = ir.Program.parse_from_string(f.read())
    except (OSError, json.JSONDecodeError, KeyError) as e:
        raise SystemExit(f"cannot load program from {path!r}: {e}")
    feeds = sorted(v.name for v in prog.global_block().vars.values()
                   if v.is_data)
    return prog, feeds, None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_paddle_lint",
        description="static verifier + shape inference + lints over "
                    "the Program IR")
    ap.add_argument("program", nargs="?",
                    help="serialized program JSON (Program.serialize_to_string)")
    ap.add_argument("--model",
                    help="lint a paddle_tpu_torch.models graph instead")
    ap.add_argument("--no-train", action="store_true",
                    help="with --model: skip optimizer.minimize (lint the "
                         "forward graph only)")
    ap.add_argument("--fetch", action="append", default=None, metavar="VAR",
                    help="fetch target(s) anchoring the dead-op lint")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on warnings too")
    ap.add_argument("--no-lint", action="store_true",
                    help="structural verification + shapes only")
    args = ap.parse_args(argv)

    if bool(args.program) == bool(args.model):
        ap.error("pass exactly one of: a program JSON path, or --model NAME")

    if args.model:
        program, feeds, fetches = _load_model(args.model,
                                              train=not args.no_train)
    else:
        program, feeds, fetches = _load_json(args.program)
    if args.fetch:
        fetches = list(args.fetch)

    from paddle_tpu_torch import analysis

    diags = analysis.analyze_program(program, feed_targets=feeds,
                                     fetch_targets=fetches,
                                     lint=not args.no_lint)
    n_err = sum(d.severity == analysis.Severity.ERROR for d in diags)
    n_warn = sum(d.severity == analysis.Severity.WARNING for d in diags)

    if args.format == "json":
        print(json.dumps({"errors": n_err, "warnings": n_warn,
                          "diagnostics": [d.to_dict() for d in diags]},
                         indent=2))
    else:
        target = args.model or args.program
        if diags:
            print(analysis.format_diagnostics(diags))
        print(f"{target}: {n_err} error(s), {n_warn} warning(s), "
              f"{len(diags) - n_err - n_warn} note(s)")
    return 1 if (n_err or (args.strict and n_warn)) else 0


if __name__ == "__main__":
    sys.exit(main())
