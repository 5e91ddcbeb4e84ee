#!/usr/bin/env python3
"""Host dispatch overhead per step of paddle_tpu_torch: prepared against
unprepared.

The port's counterpart of tools/step_overhead_bench.py (no jax, nothing
of paddle_tpu): the same tiny MLP with Adam, the same windows and rounds
(`STEP_OVERHEAD_STEPS` steps a window, `STEP_OVERHEAD_ROUNDS` rounds, 50
warm-up steps a path) and one JSON line with the same keys. It measures
the host's Python work around the step, so the device part of a step is
kept small against it.

Four dispatch paths over the same program and scope:

  legacy   : the port's unprepared dispatch. The port never had the JAX
             package's pre-prepare `run` body, so this is a fresh
             `Executor.prepare(...)` (the validate hook, a new step plan
             built from the program's ops) and its `run`, every step
  run      : `Executor.run()`, the thin wrapper over a memoized
             PreparedProgram
  prepared : a held `Executor.prepare()` handle: feed conversion, state
             gather from the scope, the eager block, write-back
  floor    : the eager block alone (`core.lowering.run_block`) with a
             bound plan and the state gathered once, the feeds already on
             the device: no feed or scope work around it, only the
             refresh of the written state from the block's outputs

host overhead(path) = per-step wall(path) - floor; the headline
`step_overhead_reduction_x` = legacy overhead / prepared overhead, the
denominator clamped at 2 us as the JAX tool clamps it.

Runs on `CUDAPlace(0)`, with `torch.cuda.synchronize()` at each window's
end (the wall then holds the card's time too, which the floor holds
alike); `--cpu` runs on the host. Prints ONE JSON line.

Usage: python3 tools/torch_step_overhead_bench.py [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_program(fluid):
    """tools/step_overhead_bench.py's MLP: a 16-wide 3-layer MLP + Adam,
    about 20 state vars, so the scope gather a step pays is realistic."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=16, act="relu")
        h = fluid.layers.fc(input=h, size=16, act="relu")
        pred = fluid.layers.fc(input=h, size=4, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=y))
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="host dispatch overhead a step: prepared against "
                    "unprepared (paddle_tpu_torch)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host (default: CUDAPlace(0))")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device is visible (torch.cuda.is_available() is "
              "False); pass --cpu to measure on the host", file=sys.stderr)
        return 2

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import flags as _flags
    from paddle_tpu_torch.core.executor import convert_feed
    from paddle_tpu_torch.core.lowering import run_block

    steps = int(os.environ.get("STEP_OVERHEAD_STEPS", "200"))
    n_rounds = int(os.environ.get("STEP_OVERHEAD_ROUNDS", "24"))
    warmup = 50

    main_p, startup, loss = build_program(fluid)
    place = fluid.CPUPlace() if args.cpu else fluid.CUDAPlace(0)
    cuda = not args.cpu
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)

    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(32, 16).astype(np.float32),
            "y": rng.randint(0, 4, (32, 1)).astype(np.int64)}

    prepared = exe.prepare(main_p, fetch_list=[loss], scope=scope)
    prepared.run(feed, return_numpy=False)
    plan = prepared._entry
    device = place.torch_device()
    feed_tensors = convert_feed(main_p.global_block(), feed, device)
    seed = main_p.random_seed if main_p.random_seed is not None else 0
    check = _flags.get_flag("check_nan_inf")

    warmed = set()

    def time_path(fn, n):
        if fn not in warmed:
            warmed.add(fn)
            for _ in range(warmup):
                fn()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        # one sync at the window's end: the card's time of the window
        # is in every path's wall alike, and the floor subtraction
        # removes it
        if cuda:
            torch.cuda.synchronize()
        del out
        return (time.perf_counter() - t0) / n * 1e6  # us/step

    def run_legacy():
        return exe.prepare(main_p, fetch_list=[loss], scope=scope).run(
            feed, return_numpy=False)

    def run_public():
        return exe.run(main_p, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)

    def run_prepared():
        return prepared.run(feed, return_numpy=False)

    # floor: the eager block alone. Its state is gathered once a window
    # and refreshed from the block's written outputs a step (the least
    # python any dispatch path must do); the window's final values go
    # back to the scope, keeping the other paths' reads live
    state = {}

    def run_floor():
        env = dict(state)
        env.update(feed_tensors)
        with torch.no_grad():
            run_block(main_p, 0, env, device, seed, 0, check, plan.live,
                      exe.amp)
        for n in plan.written:
            state[n] = env[n]
        return [env[loss.name]]

    def floor_window(n):
        state.clear()
        state.update({k: scope.find_var(k) for k in plan.read})
        us = time_path(run_floor, n)
        for k in plan.written:
            scope.set_var(k, state[k])
        return us

    # many SHORT interleaved windows, the minimum over rounds a path:
    # interference on a shared host only ever adds time, so each path's
    # minimum over interleaved windows is its clean step cost (the JAX
    # tool's argument)
    rounds = {"legacy": [], "run": [], "prepared": [], "floor": []}
    for _ in range(n_rounds):
        rounds["floor"].append(floor_window(steps))
        rounds["prepared"].append(time_path(run_prepared, steps))
        rounds["run"].append(time_path(run_public, steps))
        rounds["legacy"].append(time_path(run_legacy, steps))
    med = {k: min(v) for k, v in rounds.items()}

    # the floor is by definition at most every path's minimum
    floor = min(med.values())
    over_legacy = max(med["legacy"] - floor, 0.0)
    over_run = max(med["run"] - floor, 0.0)
    over_prepared = max(med["prepared"] - floor, 0.0)
    reduction = over_legacy / max(over_prepared, 2.0)
    result = {
        "steps_per_window": steps,
        "floor_us": round(floor, 2),
        "legacy_us": round(med["legacy"], 2),
        "run_us": round(med["run"], 2),
        "prepared_us": round(med["prepared"], 2),
        "step_overhead_us_unprepared": round(over_legacy, 2),
        "step_overhead_us_run": round(over_run, 2),
        "step_overhead_us": round(over_prepared, 2),
        "step_overhead_reduction_x": round(reduction, 2),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
