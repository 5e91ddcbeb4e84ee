#!/usr/bin/env python3
"""Where paddle_tpu_torch's training step time goes on one NVIDIA card.

    python3 tools/torch_train_profile.py [--steps N] [--out DIR]

Builds chip_smoke.py's train-base (its TRAIN_BASE, TRAIN_BATCH, Adam
learning rate and fixed batch, imported from there), runs its startup
with `Executor(CUDAPlace(0))`, takes 3 warm-up steps, then N untraced
steps (step wall on the host clock after `torch.cuda.synchronize()`) and
one step under `torch.profiler`. The traced step reports the device's
busy share (the union of kernel and copy intervals over the traced wall),
the device time by kernel and by kernel group (GEMMs, the flash kernels,
int64 elementwise kernels — the dropout op's counter hash — and the rest),
and the device and host time by op type: each op and grad op of the
interpreter (``core/lowering.py``) runs inside a `record_function` range
named after it, put there by this tool only. Kernels that autograd's
engine launches from its own thread (the backward half of a generic grad
op: its matmuls, the flash dQ and dK/dV kernels) fall outside those
ranges, so the by-op device times leave them out; the by-kernel and
by-group times count every kernel. The trace goes to a temporary
directory and is deleted. The last line printed
is one JSON summary; ``--out`` also writes it to DIR/summary.json. A run
without a card fails: there is no host fallback.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import TRAIN_BASE, TRAIN_BATCH, build_train, train_batch  # noqa: E402
from tools.torch_serve_profile import device_breakdown  # noqa: E402


@contextlib.contextmanager
def annotated_ops(torch):
    """Run every op and grad op inside `record_function("op::<type>")`."""
    from paddle_tpu_torch.core import lowering
    run_op, run_grad = lowering._run_op, lowering._run_grad_op

    def op_(op, *a, **k):
        with torch.profiler.record_function("op::" + op.type):
            return run_op(op, *a, **k)

    def grad_(op, *a, **k):
        with torch.profiler.record_function("op::" + op.type):
            return run_grad(op, *a, **k)

    lowering._run_op, lowering._run_grad_op = op_, grad_
    try:
        yield
    finally:
        lowering._run_op, lowering._run_grad_op = run_op, run_grad


def by_op_type(prof, top=16):
    """Per op type: host time in its ranges and the device time of the
    kernels launched inside them. (The profiler also mirrors each range on
    the device timeline, spanning the gaps between its kernels; those
    entries, with no host time, are skipped.)"""
    rows = {}
    for e in prof.key_averages():
        if not e.key.startswith("op::") or e.cpu_time_total <= 0:
            continue
        dev = getattr(e, "device_time_total", None)
        if dev is None:
            dev = e.cuda_time_total
        rows[e.key[4:]] = {"op": e.key[4:], "count": e.count,
                           "device_us": dev, "host_us": e.cpu_time_total}
    ranked = sorted(rows.values(), key=lambda r: -r["device_us"])
    return ranked[:top]


KERNEL_GROUPS = (("flash kernels", ("flash_",)),
                 ("GEMMs", ("gemm", "xmma")),
                 ("int64 elementwise (dropout hash)", ("<long",)))


def by_group(kernels):
    """Device time of every kernel, summed by KERNEL_GROUPS (first match)."""
    out = {name: 0.0 for name, _ in KERNEL_GROUPS}
    out["other"] = 0.0
    for k in kernels:
        group = next((name for name, keys in KERNEL_GROUPS
                      if any(key in k["name"] for key in keys)), "other")
        out[group] += k["us"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5,
                    help="untraced steps timed after the warm-up")
    ap.add_argument("--out", help="directory for summary.json")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device visible", file=sys.stderr)
        return 2
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import native
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    main_prog, startup, loss = build_train(ptt)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = train_batch(TRAIN_BATCH)

    def step():
        out, = exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        return float(np.asarray(out).reshape(-1)[0])

    for _ in range(3):
        step()
    walls = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    native.reset_launches()
    with tempfile.TemporaryDirectory(prefix="train_profile_") as tmp:
        with annotated_ops(torch), torch.profiler.profile(activities=acts) \
                as prof:
            t0 = time.perf_counter()
            step()
            traced_s = time.perf_counter() - t0
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        dev = device_breakdown(trace, traced_s, top=None)
    groups = by_group(dev["by_kernel"])
    dev["by_kernel"] = dev["by_kernel"][:16]
    ops_all = by_op_type(prof, top=None)
    ops = ops_all[:16]
    tokens = TRAIN_BATCH * TRAIN_BASE["seq_len"]
    med = sorted(walls)[len(walls) // 2]
    print(f"train-base [{card}]: untraced step median {med:.1f} ms "
          f"({[round(w, 1) for w in walls]}), {tokens / med * 1e3:.0f} "
          f"tokens/s; traced step {traced_s * 1e3:.1f} ms, device busy "
          f"{dev['busy_us'] / 1e3:.1f} ms = {dev['busy_share']:.3f}; "
          f"launches {dict(native.launches)}", flush=True)
    print("device time by kernel group: " + ", ".join(
        f"{name} {us / 1e3:.1f} ms" for name, us in groups.items()))
    print("device time by kernel:")
    for k in dev["by_kernel"]:
        print(f"  {k['us'] / 1e3:9.3f} ms  x{k['count']:<6d} {k['name']}")
    print(f"device / host time by op type (traced step; all ops: device "
          f"{sum(r['device_us'] for r in ops_all) / 1e3:.1f} ms, host "
          f"{sum(r['host_us'] for r in ops_all) / 1e3:.1f} ms):")
    for r in ops:
        print(f"  {r['device_us'] / 1e3:9.3f} ms device {r['host_us'] / 1e3:9.3f}"
              f" ms host  x{r['count']:<5d} {r['op']}")
    summary = {"card": card, "device": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "batch": TRAIN_BATCH,
               "tokens_per_step": tokens, "untraced_step_ms": walls,
               "traced_step_ms": traced_s * 1e3, "traced": dev,
               "by_kernel_group_us": groups,
               "by_op_type": ops, "launches": dict(native.launches)}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
