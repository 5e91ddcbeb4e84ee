#!/usr/bin/env python3
"""Capture a torch.profiler trace of train-base steps of paddle_tpu_torch
and print the top device ops by self time.

The port's counterpart of tools/step_profile.py (no jax, nothing of
paddle_tpu). It builds train-base as `chip_smoke.py` does (Transformer-base
of bench.py:205-233 with Adam, float32, batch 32: `chip_smoke.build_train`,
its fixed batch from DATA_SEED), runs the startup and one warm-up step
through the port's Executor, then three steps under `torch.profiler`
(`paddle_tpu_torch.profiler.profiler`), each inside a
`profiler.record_event("train_step")` span and the loss's copy to the host
inside `record_event("fetch_sync")`. It prints

- the host events table from the port's `profiler` / `observe.tracer`
  ring (`profiler.print_host_events`), and writes that timeline as
  `host_timeline.json` (chrome://tracing) beside the profiler's own
  `trace.json`;
- the top device ops by self CUDA time: the kernels, copies and sets as
  CUPTI names them (the hand-written kernels of csrc/ as
  `flash_fwd_kernel<...>`, `flash_dq_kernel<...>`, ...), with their
  count and share.

Runs on `CUDAPlace(0)`; `--cpu` runs on the host, where the table ranks
the operators by self CPU time instead. `--tiny` builds a 1-layer,
d_model 16 Transformer for a quick host run. `--yardstick` traces the
hand-written PyTorch step of tools/torch_yardstick_transformer.py (the
JAX tool's `--yardstick`, tools/yardstick_transformer.py) instead of the
framework's: at train-base-unfused-amp's shapes (batch 64, seq 256,
Transformer-base widths, bf16 products), or with `--tiny` at 1 + 1
layers, d_model 32, batch 4 x seq 8; the same tables.

Usage: python3 tools/torch_step_profile.py [--cpu] [--tiny] [--yardstick]
           [--batch N] [--top K] [--out DIR]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (DATA_SEED, TRAIN_BASE, TRAIN_BATCH,  # noqa: E402
                        build_train)

STEPS = 3   # profiled steps, as tools/step_profile.py takes
TINY = dict(src_vocab_size=64, trg_vocab_size=64, seq_len=16, n_layer=1,
            n_head=2, d_model=16, d_inner=32)


def _self_time(e, cuda):
    if not cuda:
        return e.self_cpu_time_total
    t = getattr(e, "self_device_time_total", None)
    return e.self_cuda_time_total if t is None else t


SPANS = ("train_step", "fetch_sync")   # this tool's record_event names


def summarize(prof, cuda, top=30):
    """The top ops by self device time (self CPU time on the host), from
    the profiler's `key_averages()`; returns the rows printed. On the card
    the rows are the device's own events (kernels, copies, sets: no host
    time of their own), as the JAX tool reads the device's op track; the
    host operators that launched them, and the profiler's device-side
    mirror of this tool's spans, are left out."""
    rows = [(e.key, _self_time(e, cuda), e.count)
            for e in prof.key_averages()
            if not cuda or (e.self_cpu_time_total == 0
                            and e.key not in SPANS)]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    grand = sum(r[1] for r in rows)
    what = "self CUDA" if cuda else "self CPU"
    print(f"top {min(top, len(rows))} ops by {what} time:")
    print(f"{'op':60} {'total ms':>9} {'n':>6} {'%':>5}")
    for name, us, n in rows[:top]:
        print(f"{name[:60]:60} {us / 1e3:9.3f} {n:6d} "
              f"{100 * us / grand:5.1f}")
    print(f"{'TOTAL (' + what + ')':60} {grand / 1e3:9.3f}")
    return rows[:top]


def _framework_step(args):
    """train-base through the port's Executor: (step, fetch), after the
    startup program."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.core.executor import to_numpy
    widths = TINY if args.tiny else {}
    cfg = dict(TRAIN_BASE, **widths)
    batch = args.batch or TRAIN_BATCH
    main_p, startup, loss = build_train(ptt, **widths)
    rng = np.random.RandomState(DATA_SEED)
    feed = {n: rng.randint(0, cfg["trg_vocab_size"],
                           (batch, cfg["seq_len"])).astype(np.int64)
            for n in ("src_word", "trg_word", "lbl_word")}
    place = ptt.CPUPlace() if args.cpu else ptt.CUDAPlace(0)
    scope = ptt.Scope()
    exe = ptt.Executor(place)
    exe.run(startup, scope=scope)
    prepared = exe.prepare(main_p, fetch_list=[loss], scope=scope)
    print(f"train-base{' (tiny)' if args.tiny else ''} on {place}: batch "
          f"{batch}, seq {cfg['seq_len']}, {cfg['n_layer']} + "
          f"{cfg['n_layer']} layers, d_model {cfg['d_model']}")
    return (lambda i: prepared.run(feed, return_numpy=False)[0],
            lambda t: float(to_numpy(t).reshape(-1)[0]))


def _yardstick_step(args):
    """The hand-written PyTorch step: (step, fetch)."""
    import torch_yardstick_transformer as yd
    cfg = dict(yd.TINY if args.tiny else yd.BASE)
    if args.batch:
        cfg["batch_size"] = args.batch
    device = "cpu" if args.cpu else "cuda"
    step = yd.setup(cfg, device)
    print(f"yardstick (hand-written PyTorch{', tiny' if args.tiny else ''}) "
          f"on {device}: batch {cfg['batch_size']}, seq {cfg['seq_len']}, "
          f"{cfg['n_layer']} + {cfg['n_layer']} layers, d_model "
          f"{cfg['d_model']}, bf16 products, dropout 0.1")
    return step, float


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="torch.profiler trace of train-base steps of "
                    "paddle_tpu_torch: the host events and the top device "
                    "ops")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host (default: CUDAPlace(0))")
    ap.add_argument("--tiny", action="store_true",
                    help="a 1-layer, d_model 16 Transformer")
    ap.add_argument("--batch", type=int, default=None,
                    help=f"rows a step (default {TRAIN_BATCH}; the "
                         f"yardstick's 64, or 4 with --tiny)")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--out", help="directory for the traces (default: a "
                                  "new temporary one)")
    ap.add_argument("--yardstick", action="store_true",
                    help="trace the hand-written PyTorch step "
                         "(tools/torch_yardstick_transformer.py)")
    args = ap.parse_args(argv)
    import torch
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device is visible (torch.cuda.is_available() is "
              "False); pass --cpu to profile on the host", file=sys.stderr)
        return 2
    from paddle_tpu_torch import profiler as prof
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    step, fetch = (_yardstick_step if args.yardstick else _framework_step)(
        args)
    print(f"warm-up loss {fetch(step(0)):.6f}")

    trace_dir = args.out or tempfile.mkdtemp(prefix="torch_stepprof_")
    prof.reset_profiler()
    with prof.profiler(state="CPU" if args.cpu else "All",
                       profile_path=trace_dir) as p:
        for i in range(STEPS):
            with prof.record_event(SPANS[0]):
                out = step(i + 1)
        with prof.record_event(SPANS[1]):
            last = fetch(out)
    print(f"last loss {last:.6f}")
    print("trace dir:", trace_dir)
    host_path = os.path.join(trace_dir, "host_timeline.json")
    prof.export_chrome_tracing(host_path)
    print("host timeline:", host_path)
    prof.print_host_events()
    summarize(p, cuda=not args.cpu, top=args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
