#!/usr/bin/env python3
"""Where paddle_tpu_torch's training step time goes on one NVIDIA card.

    python3 tools/torch_train_profile.py
        [--model transformer|resnet50|stacked_lstm|mt] [--amp] [--unfused]
        [--steps N] [--out DIR]
    FLAGS_dropout_impl=pallas python3 tools/torch_train_profile.py ...

Builds one of chip_smoke.py's training configurations, imported from
there: train-base (`--model transformer`, the default: its TRAIN_BASE,
TRAIN_BATCH, Adam learning rate and fixed batch) or train-resnet50
(`--model resnet50`: RESNET50 at RESNET_BATCH with Momentum, its fixed
synthetic batch staged on the card first) or train-stacked-lstm
(`--model stacked_lstm`: LSTM with Adam at LSTM_BATCH x LSTM_SEQ,
bench.py's fixed `(words, lengths)` batch staged on the card; its
`lstm` and `lstm_grad` rows are the time loops) or train-mt (`--model
mt`: machine_translation at MT with Adam at MT_BATCH, its fixed
`(src, lengths)` batch staged on the card; the `static_rnn` and
`static_rnn_grad` rows are the decoder's 50-step loop, and the rows of
the ops of its body, nested inside them, count each step's call);
with `--amp`, the same under
bf16 mixed precision (train-base-amp at TRAIN_AMP_BATCH, bench.py's
batch; train-resnet50-amp), with `--unfused` train-base-unfused
(`fused_attention=False`: matmul, causal mask, softmax, dropout and
matmul in place of the flash kernels), whose kernel groups put the bf16
instantiations of the flash and dropout kernels, and the float32 <->
bf16 casts, apart. It runs the startup
with `Executor(CUDAPlace(0), amp=...)`, takes 3 warm-up steps, then N untraced
steps (step wall on the host clock after `torch.cuda.synchronize()`) and
one step under `torch.profiler`. The dropout path is the one the
``dropout_impl`` flag selects (read from the environment by
``paddle_tpu_torch/flags.py``: `auto`, the bits path, unless
``FLAGS_dropout_impl=pallas`` asks for the hand-written kernel); the
report names it. The traced step reports the device's
busy share (the union of kernel and copy intervals over the traced wall),
the device time by kernel and by kernel group (train-base: GEMMs, the
flash kernels, int64 elementwise kernels — the dropout op's counter hash
— and the rest; train-resnet50: conv forward, dgrad and wgrad, batch
norm, pooling, GEMMs, elementwise and the rest, plus the device time of
the `momentum` ops' ranges), and the device and host time by op type:
each op and grad op of the
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

from chip_smoke import (LSTM_BATCH, LSTM_SEQ, MT_BATCH,  # noqa: E402
                        MT_TRG, RESNET_BATCH, TRAIN_AMP_BATCH, TRAIN_BASE,
                        TRAIN_BATCH, build_mt, build_resnet,
                        build_stacked_lstm, build_train, lstm_batch,
                        mt_batch, resnet_batch, train_batch)
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


# the bf16 instantiations of the hand-written kernels, and the dtype
# casts of the AMP policy (copy kernels), ahead of every other group
AMP_GROUPS = (("flash kernels (bf16)", ("flash_fwd_bf16", "flash_dq_bf16",
                                        "flash_dkv_bf16",
                                        "flash_delta_bf16")),
              ("dropout kernel (bf16)", ("dropout_bf16_kernel",)),
              ("copies and casts", ("direct_copy_kernel",)))

# cuBLAS names its Hopper GEMM kernels `nvjet_*` (bf16 ones among them)
KERNEL_GROUPS = {
    "transformer": (("flash kernels", ("flash_",)),
                    ("GEMMs", ("gemm", "xmma", "nvjet")),
                    ("dropout kernel", ("dropout_kernel",)),
                    ("int64 elementwise (dropout hash)", ("<long",))),
    # cuDNN names a convolution kernel by its pass (fprop, dgrad, wgrad);
    # its plain implicit-GEMM and Winograd kernels carry no pass in their
    # names and count as forward. Its FFT convolutions (any pass) run
    # complex GEMMs (cf32) between FFT kernels; its copies are the NHWC <->
    # NCHW transposes it makes around a kernel that wants NCHW, and its
    # filter flips and scalings
    "resnet50": (("conv dgrad", ("dgrad",)),
                 ("conv wgrad", ("wgrad",)),
                 ("conv forward", ("fprop", "implicit_convolve", "winograd",
                                   "convolve_sgemm", "convolve_common",
                                   "conv2d")),
                 ("conv FFT (any pass)", ("fft", "cf32")),
                 ("cuDNN copies", ("nhwcToNchw", "nchwToNhwc", "flip_filter",
                                   "scalePacked")),
                 ("batch norm", ("batch_norm", "welford")),
                 ("pooling", ("pool",)),
                 ("GEMMs", ("gemm", "xmma", "cutlass", "nvjet")),
                 ("elementwise", ("elementwise", "vectorized", "unrolled"))),
    # the LSTM's time loops: one recurrent GEMM and ~20 small elementwise
    # kernels a step; gathers are the embedding and its grad
    "stacked_lstm": (("GEMMs", ("gemm", "xmma", "cutlass", "nvjet")),
                     ("gathers and scatters", ("index", "gather", "scatter",
                                               "embedding")),
                     ("reductions", ("reduce",)),
                     ("elementwise", ("elementwise", "vectorized",
                                      "unrolled"))),
    # the encoder's LSTM loop and the decoder's 50 static_rnn steps: the
    # output products [64, 512] x [512, 30000] a step among the GEMMs
    "mt": (("GEMMs", ("gemm", "xmma", "cutlass", "nvjet")),
           ("gathers and scatters", ("index", "gather", "scatter",
                                     "embedding")),
           ("softmax and log-softmax", ("softmax",)),
           ("reductions", ("reduce",)),
           ("elementwise", ("elementwise", "vectorized", "unrolled")))}


def by_group(kernels, groups):
    """Device time of every kernel, summed by `groups` (first match)."""
    out = {name: 0.0 for name, _ in groups}
    out["other"] = 0.0
    for k in kernels:
        group = next((name for name, keys in groups
                      if any(key in k["name"] for key in keys)), "other")
        out[group] += k["us"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=sorted(KERNEL_GROUPS),
                    default="transformer")
    ap.add_argument("--amp", action="store_true",
                    help="bf16 mixed precision: Executor(amp=True)")
    ap.add_argument("--unfused", action="store_true",
                    help="train-base with fused_attention=False")
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
    impl = ptt.flags.get_flag("dropout_impl")

    if args.model == "resnet50":
        main_prog, startup, fetches = build_resnet(ptt)
        loss = fetches["loss"]
        feed = {k: torch.from_numpy(v).cuda()
                for k, v in resnet_batch(RESNET_BATCH).items()}
        name, batch, unit, per_step = ("train-resnet50", RESNET_BATCH,
                                       "images", RESNET_BATCH)
    elif args.model == "stacked_lstm":
        main_prog, startup, fetches = build_stacked_lstm(ptt)
        loss = fetches["loss"]
        words, lens, label = lstm_batch()
        feed = {"words": (torch.from_numpy(words).cuda(),
                          torch.from_numpy(lens).cuda()),
                "label": torch.from_numpy(label).cuda()}
        name, batch, unit, per_step = ("train-stacked-lstm", LSTM_BATCH,
                                       "padded_tokens", LSTM_BATCH * LSTM_SEQ)
    elif args.model == "mt":
        main_prog, startup, fetches = build_mt(ptt)
        loss = fetches["loss"]
        src, lens, trg, lbl, _ = mt_batch()
        feed = {"src_word": (torch.from_numpy(src).cuda(),
                             torch.from_numpy(lens).cuda()),
                "trg_word": torch.from_numpy(trg).cuda(),
                "lbl_word": torch.from_numpy(lbl).cuda()}
        name, batch, unit, per_step = ("train-mt", MT_BATCH,
                                       "padded_target_tokens",
                                       MT_BATCH * MT_TRG)
    else:
        main_prog, startup, loss = build_train(
            ptt, fused_attention=not args.unfused)
        batch = TRAIN_AMP_BATCH if args.amp else TRAIN_BATCH
        feed = train_batch(batch)
        name, unit, per_step = ("train-base" + ("-unfused" if args.unfused
                                                else ""), "tokens",
                                batch * TRAIN_BASE["seq_len"])
    groups_of = KERNEL_GROUPS[args.model]
    if args.amp:
        name += "-amp"
        groups_of = AMP_GROUPS + groups_of
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CUDAPlace(0), amp=args.amp)
    exe.run(startup, scope=scope)

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
    groups = by_group(dev["by_kernel"], groups_of)
    other = [k for k in dev["by_kernel"]
             if by_group([k], groups_of)["other"]][:12]
    dev["by_kernel"] = dev["by_kernel"][:16]
    ops_all = by_op_type(prof, top=None)
    if args.model == "resnet50":
        groups["momentum ops (their ranges)"] = sum(
            r["device_us"] for r in ops_all if r["op"] == "momentum")
    ops = ops_all[:16]
    med = sorted(walls)[len(walls) // 2]
    print(f"{name} (dropout_impl={impl}) [{card}]: untraced step median {med:.1f} ms "
          f"({[round(w, 1) for w in walls]}), {per_step / med * 1e3:.1f} "
          f"{unit}/s; traced step {traced_s * 1e3:.1f} ms, device busy "
          f"{dev['busy_us'] / 1e3:.1f} ms = {dev['busy_share']:.3f}; "
          f"launches {dict(native.launches)}", flush=True)
    print("device time by kernel group: " + ", ".join(
        f"{name} {us / 1e3:.1f} ms" for name, us in groups.items()))
    print("the largest kernels in no group:")
    for k in other:
        print(f"  {k['us'] / 1e3:9.3f} ms  x{k['count']:<6d} {k['name']}")
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
               "torch": torch.__version__, "model": name, "amp": args.amp,
               "dropout_impl": impl, "batch": batch,
               f"{unit}_per_step": per_step, "untraced_step_ms": walls,
               "traced_step_ms": traced_s * 1e3, "traced": dev,
               "by_kernel_group_us": groups, "other_kernels": other,
               "by_op_type": ops_all, "launches": dict(native.launches)}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
