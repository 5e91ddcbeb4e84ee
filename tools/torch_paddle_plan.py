#!/usr/bin/env python
"""torch_paddle_plan: the planner's CLI over paddle_tpu_torch — ranked
mesh plans for a model.

The port's counterpart of ``tools/paddle_plan.py``. Prints the
cost-model-driven `PlanReport` for a book model at a given device
count: every dp×mp×sp factorization with predicted step time, MFU,
per-device peak memory (OOM candidates rejected with the reason) and
bytes-on-the-wire, fastest first. The same search backs
`parallel.mesh.auto_mesh`; this tool is the human/CI view of it.

    python tools/torch_paddle_plan.py --model transformer --devices 8
    python tools/torch_paddle_plan.py --model resnet --devices 4 --json
    python tools/torch_paddle_plan.py --model transformer --devices 1 \\
        --full-size --hw h100

Exit status is the CI gate: nonzero when NO candidate fits the device
memory budget (i.e. the top candidate's predicted peak exceeds it) — a
program that cannot be placed should fail the pipeline before it fails
on the card. `--hw` picks the machine model of `analysis.planner`:
`h100` (`H100`), `cpu` (`CPU_REHEARSAL`) or `auto` (`detect_hardware()`:
`H100` with this card's memory when an H100 is visible, else
`CPU_REHEARSAL`); `--hbm-gb` / `--peak-tflops` override single knobs for
what-if runs. The planning is static: nothing runs on a device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="ranked dp*mp*sp mesh plans from the per-op cost model")
    ap.add_argument("--model", choices=("mlp", "transformer", "resnet"),
                    default="transformer")
    ap.add_argument("--devices", type=int, default=8,
                    help="device count to factorize (default 8)")
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch the feeds are sized at (default 8)")
    ap.add_argument("--full-size", action="store_true",
                    help="transformer: the base config (batch 64 x seq "
                         "256 unless overridden)")
    ap.add_argument("--topk", type=int, default=12)
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--hw", choices=("auto", "h100", "cpu"), default="auto",
                    help="machine model (default: H100 when one is visible)")
    ap.add_argument("--peak-tflops", type=float, default=None,
                    help="override the machine model's peak")
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="override the per-device memory budget")
    args = ap.parse_args(argv)

    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import layers, models
    from paddle_tpu_torch.analysis import planner
    from tools.torch_op_profile import build_mlp, build_resnet

    batch = args.batch
    if args.model == "transformer" and args.full_size and args.batch == 8:
        batch = 64   # the train-base-amp batch

    def build_transformer_train(ptt_, layers_, batch_):
        # a TRAIN step (torch_op_profile's is inference-only): fused
        # attention with dropout 0 — the mesh configuration, so sp
        # candidates are plannable — and Adam
        kw = {} if args.full_size else dict(
            src_vocab_size=128, trg_vocab_size=128, seq_len=16, n_layer=2,
            n_head=4, d_model=64, d_inner=128)
        _, fetches = models.transformer.build(dropout_rate=0.0,
                                              fused_attention=True, **kw)
        ptt_.optimizer.Adam(learning_rate=1e-3).minimize(fetches["loss"])
        seq = 256 if args.full_size else 16
        feed = {k: np.zeros((batch_, seq), np.int64)
                for k in ("src_word", "trg_word", "lbl_word")}
        return fetches["loss"], feed

    main_p, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main_p, startup), ptt.unique_name.guard():
        _, feed = {
            "mlp": build_mlp,
            "transformer": build_transformer_train,
            "resnet": build_resnet,
        }[args.model](ptt, layers, batch)
    feed_shapes = {k: tuple(v.shape) for k, v in feed.items()}

    hw = {"h100": lambda: planner.H100, "cpu": lambda: planner.CPU_REHEARSAL,
          "auto": planner.detect_hardware}[args.hw]()
    if args.peak_tflops is not None:
        hw = hw.replace(peak_flops=args.peak_tflops * 1e12)
    if args.hbm_gb is not None:
        hw = hw.replace(hbm_bytes=args.hbm_gb * 1e9)

    report = planner.plan_meshes(main_p, feed_shapes, args.devices, hw=hw)
    best = report.best

    if args.json:
        out = report.as_dict(args.topk)
        out["model"] = args.model
        out["batch"] = batch
        out["feed_shapes"] = {k: list(v) for k, v in feed_shapes.items()}
        print(json.dumps(out, sort_keys=True))
    else:
        print(f"model={args.model} batch={batch} "
              f"devices={args.devices} hw={hw.name}")
        print(report.table(args.topk))
        if best is not None:
            print(f"PLAN: {best.label()} — predicted "
                  f"{best.t_step_s * 1e3:.3f} ms/step, "
                  f"MFU {best.mfu:.1%}, peak memory "
                  f"{best.peak_hbm_bytes / 1e9:.2f} GB of "
                  f"{hw.hbm_bytes / 1e9:.2f} GB")

    if best is None:
        top = report.candidates[0] if report.candidates else None
        print(f"FAIL: no feasible mesh — top candidate "
              f"{top.label() if top else '?'}: "
              f"{top.reason if top else 'no candidates'}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
