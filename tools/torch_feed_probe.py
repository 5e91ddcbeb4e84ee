"""Where train-resnet50-reader's feed cost goes, on the card.

bench.py's ResNet-50 step (batch 128, 224 x 224 x 3 NHWC, Momentum(0.1,
0.9), TF32 off), timed six ways, in float32 and under
`Executor(amp=True)`:

- alone, on one batch staged on the card;
- the same, beside its input pipeline running in threads of this
  process;
- the same, beside the pipeline in a process of its own;
- fed by `AsyncFeeder` from ready host batches (no decode, no stacking:
  the pinned ring, the side-stream copy, the event and a new device
  batch a step);
- fed by `AsyncFeeder` from the pipeline, as `chip_smoke.py` phase 6c
  feeds it;
- alone again (the host clock's drift over the run).

The pipeline is `chip_smoke.py` phase 6c's: `reader.creator.recordio`
over a file of 1024 uint8 images from RandomState(0) -> `xmap_readers`
(4 threads decode to float32) -> `batch(128)` -> `DataFeeder`'s
stacking, paced at one batch a step, as AsyncFeeder's producer runs once
its queue is full; the batches are dropped. A loss that stays when the
pipeline moves to its own process is contention for the host's cores or
memory; a loss that goes was the interpreter lock the step's thread
shares with the pipeline's threads.

    python3 tools/torch_feed_probe.py [--steps 12] [--out chiprun_out/feed_probe.json]
"""

from __future__ import annotations

import argparse
import itertools
import json
import multiprocessing as mp
import os
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# steps before the timed ones, while the pipeline fills xmap's buffers;
# batches the pipeline is handed ahead of the first step (the feeder's
# queue); batches after the timed steps, so that decode work runs through
# every timed step
WARMUP, AHEAD, TAIL = 6, 4, 8
MODES = ("alone", "threads", "process", "stager", "async_feeder",
         "alone_again")


def _feed_program(ptt):
    """A program that declares only the two feed variables."""
    main = ptt.Program()
    with ptt.program_guard(main, ptt.Program()), ptt.unique_name.guard():
        ptt.layers.data(name="image", shape=[224, 224, 3], dtype="float32")
        ptt.layers.data(name="label", shape=[1], dtype="int64")
    return main


def pipeline(path, n, go, ready, done):
    """Decode and stack `n` batches of phase 6c's pipeline, one each time
    `go` is released; `ready` is set once the pipeline is built, `done`
    once it has run out."""
    import paddle_tpu_torch as ptt
    import chip_smoke as cs
    feeder = ptt.DataFeeder(["image", "label"], program=_feed_program(ptt))
    per_pass = cs.READER_SAMPLES // cs.RESNET_BATCH
    source = cs.reader_pipeline(ptt, path, passes=-(-n // per_pass),
                                batches=n)
    ready.set()
    for batch in source():
        go.acquire()
        feeder.feed(batch)
    done.set()


def time_steps(handle, feeds, steps, go=None):
    """Median ms of `steps` steps after WARMUP, each on the next feed of
    the iterator `feeds` (its wait included), releasing `go` once a step;
    each step fetches its loss (a sync), as phase 6c's do. Also the CPU
    time this process's other threads took a timed step."""
    import numpy as np
    ms, other = [], []
    for i in range(WARMUP + steps):
        if go is not None:
            go.release()
        t0 = time.perf_counter()
        cpu0, own0 = time.process_time(), time.thread_time()
        out, = handle.run(next(feeds))
        if not np.isfinite(np.asarray(out)).all():
            raise AssertionError(f"loss not finite: {out}")
        if i >= WARMUP:
            ms.append((time.perf_counter() - t0) * 1e3)
            other.append(((time.process_time() - cpu0)
                          - (time.thread_time() - own0)) * 1e3)
    return dict(ms=ms, median_ms=sorted(ms)[len(ms) // 2],
                other_cpu_ms=sorted(other)[len(other) // 2])


def run_feeder(ptt, handle, host_feed, steps, path, mode):
    """Steps fed by AsyncFeeder (capacity 4, on the handle's device) from
    ready host batches (`stager`) or phase 6c's pipeline; the TAIL
    batches after the timed steps are drained without a step."""
    import chip_smoke as cs
    from paddle_tpu_torch.async_feeder import AsyncFeeder
    n = WARMUP + steps + TAIL
    if mode == "stager":
        feeder = AsyncFeeder(lambda b: b, lambda: (host_feed
                                                   for _ in range(n)),
                             capacity=cs.READER_CAPACITY, prepared=handle)
    else:
        per_pass = cs.READER_SAMPLES // cs.RESNET_BATCH
        feeder = AsyncFeeder(
            ptt.DataFeeder(["image", "label"], program=_feed_program(ptt)),
            cs.reader_pipeline(ptt, path, passes=-(-n // per_pass),
                               batches=n),
            capacity=cs.READER_CAPACITY, prepared=handle)
    feeds = iter(feeder)
    res = time_steps(handle, feeds, steps)
    for _ in feeds:
        pass
    res["produce_ms"] = sorted(feeder.produce_s)[len(feeder.produce_s)
                                                  // 2] * 1e3
    return res


def run_mode(ptt, handle, feed, host_feed, steps, path, mode):
    if mode.startswith("alone"):
        return time_steps(handle, itertools.repeat(feed), steps)
    if mode in ("stager", "async_feeder"):
        return run_feeder(ptt, handle, host_feed, steps, path, mode)
    n = AHEAD + WARMUP + steps + TAIL
    if mode == "threads":
        go, ready, done = (threading.Semaphore(0), threading.Event(),
                           threading.Event())
        worker = threading.Thread(target=pipeline,
                                  args=(path, n, go, ready, done),
                                  daemon=True)
    else:
        ctx = mp.get_context("spawn")
        go, ready, done = ctx.Semaphore(0), ctx.Event(), ctx.Event()
        worker = ctx.Process(target=pipeline, args=(path, n, go, ready, done))

    def wait(event, what):
        deadline = time.perf_counter() + 300
        while not event.wait(0.5):
            if not worker.is_alive() or time.perf_counter() > deadline:
                raise AssertionError(f"the {mode} pipeline did not {what}")

    t0 = time.perf_counter()
    worker.start()
    wait(ready, "start")
    start_s = time.perf_counter() - t0
    for _ in range(AHEAD):
        go.release()
    res = time_steps(handle, itertools.repeat(feed), steps, go)
    for _ in range(TAIL):
        go.release()
    wait(done, "finish")
    worker.join(60)
    res["start_s"] = start_s
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--out", default="chiprun_out/feed_probe.json")
    args = ap.parse_args()
    import torch
    import paddle_tpu_torch as ptt
    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    out = dict(card=card, steps=args.steps, warmup=WARMUP,
               switch_interval_s=sys.getswitchinterval(),
               cpus=os.cpu_count(), runs={})
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="feed_probe_") as tmp:
        path = os.path.join(tmp, "train.recordio")
        out["write"] = cs.write_reader_data(ptt, path)
        for amp in (False, True):
            main_prog, startup, fetches = cs.build_resnet(ptt)
            scope = ptt.Scope()
            exe = ptt.Executor(ptt.CUDAPlace(0), amp=amp)
            exe.run(startup, scope=scope)
            handle = exe.prepare(main_prog, fetch_list=[fetches["loss"]],
                                 scope=scope)
            host_feed = cs.resnet_batch(cs.RESNET_BATCH)
            feed = {k: torch.from_numpy(v).to(dev)
                    for k, v in host_feed.items()}
            for _ in range(3):
                handle.run(feed)
            name = "amp" if amp else "fp32"
            runs = out["runs"][name] = {}
            for mode in MODES:
                r = runs[mode] = run_mode(ptt, handle, feed, host_feed,
                                          args.steps, path, mode)
                print(f"feed probe {name} {mode} [{card}]: step "
                      f"{r['median_ms']:.1f} ms (median of {args.steps} "
                      f"after {WARMUP}; all: "
                      f"{[round(x, 1) for x in r['ms']]}), the other "
                      f"threads' CPU {r['other_cpu_ms']:.1f} ms a step",
                      flush=True)
            base = (runs["alone"]["median_ms"]
                    + runs["alone_again"]["median_ms"]) / 2
            for mode in MODES[1:-1]:
                runs[mode]["over_alone_ms"] = runs[mode]["median_ms"] - base
            print(f"feed probe {name} [{card}]: over the step alone "
                  f"({base:.1f} ms), the pipeline in threads "
                  f"{runs['threads']['over_alone_ms']:+.1f} ms a step, in "
                  f"its own process {runs['process']['over_alone_ms']:+.1f}, "
                  f"AsyncFeeder from ready batches "
                  f"{runs['stager']['over_alone_ms']:+.1f} (producer "
                  f"{runs['stager']['produce_ms']:.1f} ms a batch), from "
                  f"the pipeline {runs['async_feeder']['over_alone_ms']:+.1f}"
                  f" (producer {runs['async_feeder']['produce_ms']:.1f})",
                  flush=True)
            del handle, exe, scope, feed
            torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
