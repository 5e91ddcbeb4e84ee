#!/usr/bin/env python3
"""What a train-stacked-lstm step's host time depends on, in one process.

    python3 tools/torch_lstm_step_probe.py [--steps N] [--out DIR]

Builds chip_smoke.py's train-stacked-lstm configuration (LSTM with Adam
at LSTM_BATCH x LSTM_SEQ, bench.py's fixed `(words, lengths)` batch
staged on the card) twice, float32 and under `Executor(amp=True)`, each
with its own scope, and takes 3 warm-up steps of each. Then it times
blocks of N untraced steps (step wall on the host clock after
`torch.cuda.synchronize()`), in this order:

  1. amp, first: nothing timed or traced before it in the process;
  2. float32;
  3. amp, after the float32 block;
  4. one float32 step under `torch.profiler` (CPU and CUDA activity),
     as chip_smoke.py's traced step;
  5. amp, after the profiler;
  6. float32, after the profiler;
  7. amp, after the profiler, with the garbage collector's objects
     frozen (`gc.collect(); gc.freeze()`).

For each block it prints the median and every step's ms, and the time
the garbage collector spent inside the block's steps (`gc.callbacks`)
with its collections by generation. The last line printed is one JSON
summary; ``--out`` also writes it to DIR/summary.json. A run without a
card fails: there is no host fallback.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (LSTM_BATCH, LSTM_SEQ,  # noqa: E402
                        build_stacked_lstm, lstm_batch)


class GcClock:
    """Seconds the garbage collector ran, and its collections by
    generation, while `on`."""

    def __init__(self):
        self.on, self.seconds, self.collections = False, 0.0, [0, 0, 0]
        self._t0 = None

    def __call__(self, phase, info):
        if not self.on:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self.collections[info["generation"]] += 1
            self._t0 = None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=10,
                    help="untraced steps timed in each block")
    ap.add_argument("--out", help="directory for summary.json")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_lstm_step_probe: no CUDA device visible",
              file=sys.stderr)
        return 2
    import paddle_tpu_torch as ptt
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    words, lens, label = lstm_batch()
    feed = {"words": (torch.from_numpy(words).cuda(),
                      torch.from_numpy(lens).cuda()),
            "label": torch.from_numpy(label).cuda()}
    steps = {}
    for amp in (False, True):
        main_prog, startup, fetches = build_stacked_lstm(ptt)
        scope = ptt.Scope()
        exe = ptt.Executor(ptt.CUDAPlace(0), amp=amp)
        exe.run(startup, scope=scope)

        def step(exe=exe, main_prog=main_prog, scope=scope,
                 loss=fetches["loss"]):
            out, = exe.run(main_prog, feed=feed, fetch_list=[loss],
                           scope=scope)
            torch.cuda.synchronize()
            return float(np.asarray(out).reshape(-1)[0])

        for _ in range(3):
            step()
        steps["amp" if amp else "float32"] = step

    clock = GcClock()
    gc.callbacks.append(clock)
    blocks = []

    def block(name, which):
        clock.seconds, clock.collections = 0.0, [0, 0, 0]
        walls = []
        clock.on = True
        for _ in range(args.steps):
            t0 = time.perf_counter()
            steps[which]()
            walls.append((time.perf_counter() - t0) * 1e3)
        clock.on = False
        med = sorted(walls)[len(walls) // 2]
        b = dict(block=name, model=which, median_ms=med, step_ms=walls,
                 gc_ms_per_step=clock.seconds * 1e3 / args.steps,
                 gc_collections=list(clock.collections))
        blocks.append(b)
        print(f"{len(blocks)}. {name} [{card}]: median {med:.1f} ms "
              f"({[round(w, 1) for w in walls]}), "
              f"{LSTM_BATCH / med * 1e3:.1f} examples/s; gc "
              f"{b['gc_ms_per_step']:.2f} ms a step, collections by "
              f"generation {b['gc_collections']}", flush=True)

    block("amp, first in the process", "amp")
    block("float32", "float32")
    block("amp, after float32", "amp")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        t0 = time.perf_counter()
        steps["float32"]()
        traced_ms = (time.perf_counter() - t0) * 1e3
    print(f"   one float32 step under torch.profiler: {traced_ms:.1f} ms",
          flush=True)
    block("amp, after the profiler", "amp")
    block("float32, after the profiler", "float32")
    gc.collect()
    gc.freeze()
    block("amp, after the profiler, gc frozen", "amp")
    gc.unfreeze()
    gc.callbacks.remove(clock)
    summary = {"card": card, "device": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "batch": LSTM_BATCH,
               "seq": LSTM_SEQ, "steps": args.steps,
               "traced_float32_step_ms": traced_ms, "blocks": blocks}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
