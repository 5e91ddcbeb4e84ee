#!/usr/bin/env python3
"""Where paddle_tpu_torch's serving time goes on one NVIDIA card.

    python3 tools/torch_serve_profile.py [--int8 | --oneshot] [--out DIR]

Saves chip_smoke.py's serve-base tiny_lm (its SERVE_BASE, weight seed and
prompts, imported from there), serves it with `InferenceServer(CUDAPlace(0))`
and runs two windows, each with 8 requests submitted at once. With
``--int8`` the model is chip_smoke.py's serve-base-int8 instead (the int8
KV residency, its cache sized from serve-base's byte budget) and each
window submits 32 requests at once:

- ``mixed``: chip_smoke's traffic (prompts of 40..500 tokens, 32 new
  tokens each: prefill-heavy);
- ``decode``: a diagnostic window, not a traffic mix: 128-token prompts,
  256 new tokens each, so most of its wall is decode steps at full slot
  occupancy.

Each window runs once untraced, for TTFT, tokens/s and the engine's
per-step wall times, and once under `torch.profiler`, for the device's
busy share (the union of kernel and copy intervals over the traced wall
time) and the device time by kernel. The traces go to a temporary
directory and are deleted. The last line printed is one JSON summary;
``--out`` also writes it to DIR/summary.json. A run without a card fails:
there is no host fallback.

With ``--oneshot`` the model is chip_smoke.py's serve-resnet50 instead
(ResNet-50 at 224 x 224 x 3 for inference, its weights, rows ladder and
traffic: 16 closed-loop clients, requests of 1-8 images), served through
the MicroBatcher. One window of ONESHOT_REQUESTS requests runs untraced
(images/s, latency) and once under `torch.profiler` (the device's busy
share and its time by kernel group); both runs also time the batcher's
host stages on its thread: plan (`plan_request`, on the client threads),
concat and pad, feed (the host-to-device copies of `convert_feed`), run
(`run_block`: the interpreter launching every op), fetch (`to_numpy`:
waiting for the device, then the device-to-host copy), the rest of
`PreparedProgram.run`, and de-mux (slicing rows back onto the Futures).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (DATA_SEED, INT8_REQUESTS, N_REQUESTS,  # noqa: E402
                        NEW_TOKENS, RESNET50, SERVE_BASE,
                        SERVE_RN50_CLIENTS, SERVE_RN50_LADDER,
                        SERVE_RN50_MAX_IMAGES, SERVE_RN50_POOL,
                        WEIGHT_SEED, prompts_for, save_serve_int8,
                        save_serve_resnet50, serve_resnet50_model)

# one traced window of serve-resnet50 traffic
ONESHOT_REQUESTS = 160
# the inference forward's kernels: cuDNN's convs and their layout copies;
# batch norm in `is_test` is elementwise ops (ops/nn.py), the fc a GEMM
ONESHOT_GROUPS = (
    ("conv forward", ("fprop", "implicit_convolve", "winograd",
                      "convolve_sgemm", "convolve_common", "conv2d",
                      "xmma_fprop", "fft", "cf32")),
    ("cuDNN copies", ("nhwcToNchw", "nchwToNhwc", "flip_filter",
                      "scalePacked")),
    ("pooling", ("pool",)),
    ("GEMMs", ("gemm", "xmma", "cutlass", "nvjet")),
    ("softmax", ("softmax",)),
    ("host <-> device copies", ("Memcpy",)),
    ("elementwise (batch norm, relu, add)", ("elementwise", "vectorized",
                                             "unrolled")))


def windows(n_requests):
    return {
        "mixed": dict(prompt_lens=None, new_tokens=NEW_TOKENS),
        "decode": dict(prompt_lens=[128] * n_requests, new_tokens=256),
    }


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _engine_summary(name):
    from paddle_tpu_torch.observe import metrics
    out = {}
    for key, metric in (("decode_step_us", "serve_decode_step_us"),
                        ("prefill_us", "serve_prefill_us")):
        s = metrics.histogram(metric).summary(model=name)
        out[key] = s and {"count": s["count"], "mean": s["mean"],
                          "min": s["min"], "max": s["max"]}
    return out


def run_window(srv, name, prompts, new_tokens, sync):
    """Submit every prompt at once, wait for all; returns the numbers."""
    t0 = time.perf_counter()
    futs = [srv.submit_generate(name, p, max_new_tokens=new_tokens)
            for p in prompts]
    res = [f.result(timeout=900) for f in futs]
    sync()
    wall = time.perf_counter() - t0
    ttft = sorted(r.ttft_us / 1e3 for r in res)
    n_tok = sum(len(r.tokens) for r in res)
    return {"wall_s": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall,
            "ttft_ms_median": ttft[len(ttft) // 2], "ttft_ms_max": ttft[-1],
            "tokens_out": [r.tokens for r in res]}


def device_breakdown(trace_path, wall_s, top=12):
    """Busy share and device time by kernel name from a Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    spans, by_name = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        spans.append((ts, ts + dur))
        n, d = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, d + dur)
    spans.sort()
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"device_events": len(spans), "busy_us": busy,
            "busy_share": busy / (wall_s * 1e6) if wall_s > 0 else 0.0,
            "by_kernel": [{"name": n[:120], "count": c, "us": d}
                          for n, (c, d) in ranked]}


def profile(srv, name, prompts, new_tokens, sync, trace_path):
    import torch
    from paddle_tpu_torch.ops import native
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    native.reset_launches()
    with torch.profiler.profile(activities=acts) as prof:
        res = run_window(srv, name, prompts, new_tokens, sync)
    launches = dict(native.launches)
    prof.export_chrome_trace(trace_path)
    res.update(device_breakdown(trace_path, res["wall_s"]))
    res["launches"] = launches
    return res


def serve_and_profile(place, sync, int8=False):
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import tiny_lm
    report = {}
    n_requests = INT8_REQUESTS if int8 else N_REQUESTS
    with tempfile.TemporaryDirectory(prefix="serve_profile_") as tmp:
        if int8:
            mdir, sig, _, _ = save_serve_int8(ptt, tiny_lm, tmp)
        else:
            mdir = os.path.join(tmp, "serve_base")
            sig = tiny_lm.save_tiny_lm(mdir, seed=WEIGHT_SEED, **SERVE_BASE)
        for wl, spec in windows(n_requests).items():
            prompts = prompts_for(sig["vocab"], spec["prompt_lens"],
                                  n=n_requests)
            name = f"lm{'8' if int8 else ''}_{wl}"
            with ptt.serve.InferenceServer(place) as srv:
                srv.add_model(name, mdir)
                plain = run_window(srv, name, prompts, spec["new_tokens"],
                                   sync)
                plain.update(_engine_summary(name))
                plain["kv_requant_events"] = srv.stats()["models"][name][
                    "kv_requant_events"]
                traced = profile(srv, name, prompts, spec["new_tokens"], sync,
                                 os.path.join(tmp, f"trace_{wl}.json"))
            if traced.pop("tokens_out") != plain.pop("tokens_out"):
                raise AssertionError(f"{wl}: traced run generated other "
                                     f"tokens than the untraced run")
            report[wl] = {"untraced": plain, "traced": traced}
    return report


class StageTimer:
    """Host time by stage of the one-shot path: wraps the functions the
    batcher thread (and the clients' `plan_request`) calls, in the
    modules that call them, for the life of the `with` block."""

    STAGES = ("plan", "concat", "pad", "feed", "run", "fetch",
              "prepared_other", "demux")

    def __init__(self):
        import threading
        self.lock = threading.Lock()
        self.us = {k: 0.0 for k in self.STAGES}
        self.calls = {k: 0 for k in self.STAGES}
        self.chunk_us = 0.0
        self.prepared_us = 0.0
        self._undo = []

    def _add(self, stage, us):
        with self.lock:
            self.us[stage] += us
            self.calls[stage] += 1

    def _wrap(self, mod, name, stage):
        fn = getattr(mod, name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self._add(stage, (time.perf_counter() - t0) * 1e6)

        setattr(mod, name, timed)
        self._undo.append((mod, name, fn))

    def __enter__(self):
        from paddle_tpu_torch.core import executor
        from paddle_tpu_torch.serve import batcher
        for mod, name, stage in ((batcher, "plan_request", "plan"),
                                 (batcher, "concat_requests", "concat"),
                                 (batcher, "pad_rows", "pad"),
                                 (executor, "convert_feed", "feed"),
                                 (executor, "run_block", "run"),
                                 (executor, "to_numpy", "fetch")):
            self._wrap(mod, name, stage)
        for cls, name, attr in ((batcher.MicroBatcher, "_run_chunk",
                                 "chunk_us"),
                                (executor.PreparedProgram, "run",
                                 "prepared_us")):
            fn = getattr(cls, name)

            def timed(*a, _fn=fn, _attr=attr, **k):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    with self.lock:
                        setattr(self, _attr, getattr(self, _attr)
                                + (time.perf_counter() - t0) * 1e6)

            setattr(cls, name, timed)
            self._undo.append((cls, name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._undo):
            setattr(mod, name, fn)
        # what _run_chunk spends outside concat, pad and the prepared run
        # is the de-mux (row slices onto the Futures, metrics, spans); what
        # PreparedProgram.run spends outside feed, run and fetch is its
        # env gather and write-back
        self.us["demux"] = (self.chunk_us - self.us["concat"]
                            - self.us["pad"] - self.prepared_us)
        self.us["prepared_other"] = (self.prepared_us - self.us["feed"]
                                     - self.us["run"] - self.us["fetch"])

    def report(self, batches):
        return {k: {"ms": v / 1e3, "us_per_batch": v / max(batches, 1),
                    "calls": self.calls[k]} for k, v in self.us.items()}


def oneshot_window(srv, feeds, sync):
    """16 closed-loop clients over `feeds`; returns the numbers."""
    import threading
    from paddle_tpu_torch.observe import metrics
    occ = metrics.histogram("serve_batch_occupancy")
    n0 = (occ.summary(model="rn50") or {"count": 0})["count"]
    lock = threading.Lock()
    order = iter(range(len(feeds)))
    lat = []

    def client():
        while True:
            with lock:
                i = next(order, None)
            if i is None:
                return
            t0 = time.perf_counter()
            srv.infer("rn50", {"image": feeds[i]})
            with lock:
                lat.append((time.perf_counter() - t0) * 1e3)

    threads = [threading.Thread(target=client)
               for _ in range(SERVE_RN50_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    sync()
    wall = time.perf_counter() - t0
    if len(lat) != len(feeds):
        raise AssertionError(f"{len(feeds) - len(lat)} requests failed")
    lat.sort()
    images = sum(len(f) for f in feeds)
    batches = occ.summary(model="rn50")["count"] - n0
    return {"wall_s": wall, "images": images, "images_per_s": images / wall,
            "p50_ms": lat[len(lat) // 2],
            "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
            "batches": batches}


def oneshot_profile(place, sync):
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import native
    from torch_train_profile import by_group
    rng = np.random.RandomState(DATA_SEED + 1)
    c, h, w = RESNET50["image_shape"]
    pool = rng.rand(SERVE_RN50_POOL, h, w, c).astype(np.float32)
    feeds = [pool[rng.randint(0, SERVE_RN50_POOL, n)] for n in rng.randint(
        1, SERVE_RN50_MAX_IMAGES + 1, ONESHOT_REQUESTS)]
    report = {}
    with tempfile.TemporaryDirectory(prefix="serve_profile_") as tmp:
        mdir = os.path.join(tmp, "resnet50")
        save_serve_resnet50(ptt, serve_resnet50_model(ptt), mdir, 1.0)
        with ptt.serve.InferenceServer(place) as srv:
            srv.add_model("rn50", mdir, ladder=ptt.serve.BucketLadder(
                rows=SERVE_RN50_LADDER))
            with StageTimer() as st:
                plain = oneshot_window(srv, feeds, sync)
            plain["host_stages"] = st.report(plain["batches"])
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            native.reset_launches()
            with StageTimer() as st, \
                    torch.profiler.profile(activities=acts) as prof:
                traced = oneshot_window(srv, feeds, sync)
            traced["host_stages"] = st.report(traced["batches"])
            traced["launches"] = dict(native.launches)
            trace = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(trace)
            dev = device_breakdown(trace, traced["wall_s"], top=None)
    traced["by_kernel_group_us"] = by_group(dev["by_kernel"], ONESHOT_GROUPS)
    traced.update(busy_us=dev["busy_us"], busy_share=dev["busy_share"],
                  device_events=dev["device_events"],
                  by_kernel=dev["by_kernel"][:12])
    report["window"] = {"untraced": plain, "traced": traced}
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--int8", action="store_true",
                      help="profile serve-base-int8 (int8 KV residency, 32 "
                           "requests) instead of serve-base")
    mode.add_argument("--oneshot", action="store_true",
                      help="profile serve-resnet50 (one-shot ResNet-50 "
                           "through the MicroBatcher)")
    ap.add_argument("--out", help="directory for summary.json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device visible", file=sys.stderr)
        return 2
    import paddle_tpu_torch as ptt
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if args.oneshot:
        torch.backends.cudnn.allow_tf32 = False
        report = oneshot_profile(ptt.CUDAPlace(0), torch.cuda.synchronize)
        u, t = report["window"]["untraced"], report["window"]["traced"]
        print(f"serve-resnet50 [{card}]: {ONESHOT_REQUESTS} requests, "
              f"{u['images']} images in {u['wall_s']:.3f} s = "
              f"{u['images_per_s']:.1f} images/s, p50 {u['p50_ms']:.1f} ms "
              f"p99 {u['p99_ms']:.1f} ms, {u['batches']} batches; traced: "
              f"{t['images_per_s']:.1f} images/s, device busy "
              f"{t['busy_share']:.3f} of {t['wall_s']:.3f} s "
              f"({t['device_events']} device events), launches "
              f"{t['launches']}", flush=True)
        for name, us in t["by_kernel_group_us"].items():
            print(f"  {us / 1e3:9.3f} ms  {name}")
        for tag, r in (("untraced", u), ("traced", t)):
            print(f"batcher host stages, {tag}: " + ", ".join(
                f"{k} {v['ms']:.1f} ms ({v['us_per_batch']:.0f} us a "
                f"batch)" for k, v in r["host_stages"].items()))
        for k in t["by_kernel"]:
            print(f"  {k['us'] / 1e3:9.3f} ms  x{k['count']:<6d} {k['name']}")
        summary = {"card": card, "device": torch.cuda.get_device_name(0),
                   "torch": torch.__version__, "config": "serve-resnet50",
                   "windows": report}
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "summary.json"), "w") as f:
                json.dump(summary, f, indent=1)
        print(json.dumps(summary), flush=True)
        return 0
    report = serve_and_profile(ptt.CUDAPlace(0), torch.cuda.synchronize,
                               int8=args.int8)
    config = "serve-base-int8" if args.int8 else "serve-base"
    for wl, r in report.items():
        u, t = r["untraced"], r["traced"]
        print(f"{config} {wl} [{card}]: {u['tokens']} tokens in {u['wall_s']:.3f} s "
              f"= {u['tokens_per_s']:.1f} tokens/s, TTFT median "
              f"{u['ttft_ms_median']:.1f} ms max {u['ttft_ms_max']:.1f} ms; "
              f"decode step {u['decode_step_us']}; prefill "
              f"{u['prefill_us']}; requantize events "
              f"{u['kv_requant_events']}; traced: device busy "
              f"{t['busy_share']:.3f} of {t['wall_s']:.3f} s, launches "
              f"{t['launches']}", flush=True)
        for k in t["by_kernel"]:
            print(f"  {k['us'] / 1e3:9.3f} ms  x{k['count']:<6d} {k['name']}")
    summary = {"card": card, "device": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "config": config,
               "windows": report}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
