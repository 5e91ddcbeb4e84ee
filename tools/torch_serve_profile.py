#!/usr/bin/env python3
"""Where paddle_tpu_torch's generation time goes on one NVIDIA card.

    python3 tools/torch_serve_profile.py [--out DIR]

Saves chip_smoke.py's serve-base tiny_lm (its SERVE_BASE, weight seed and
prompts, imported from there), serves it with `InferenceServer(CUDAPlace(0))`
and runs two windows, each with 8 requests submitted at once:

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

from chip_smoke import (N_REQUESTS, NEW_TOKENS, SERVE_BASE,  # noqa: E402
                        WEIGHT_SEED, prompts_for)

WINDOWS = {
    "mixed": dict(prompt_lens=None, new_tokens=NEW_TOKENS),
    "decode": dict(prompt_lens=[128] * N_REQUESTS, new_tokens=256),
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


def serve_and_profile(place, sync):
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import tiny_lm
    report = {}
    with tempfile.TemporaryDirectory(prefix="serve_profile_") as tmp:
        mdir = os.path.join(tmp, "serve_base")
        sig = tiny_lm.save_tiny_lm(mdir, seed=WEIGHT_SEED, **SERVE_BASE)
        for wl, spec in WINDOWS.items():
            prompts = prompts_for(sig["vocab"], spec["prompt_lens"])
            name = f"lm_{wl}"
            with ptt.serve.InferenceServer(place) as srv:
                srv.add_model(name, mdir)
                plain = run_window(srv, name, prompts, spec["new_tokens"],
                                   sync)
                plain.update(_engine_summary(name))
                traced = profile(srv, name, prompts, spec["new_tokens"], sync,
                                 os.path.join(tmp, f"trace_{wl}.json"))
            if traced.pop("tokens_out") != plain.pop("tokens_out"):
                raise AssertionError(f"{wl}: traced run generated other "
                                     f"tokens than the untraced run")
            report[wl] = {"untraced": plain, "traced": traced}
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
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
    report = serve_and_profile(ptt.CUDAPlace(0), torch.cuda.synchronize)
    for wl, r in report.items():
        u, t = r["untraced"], r["traced"]
        print(f"{wl} [{card}]: {u['tokens']} tokens in {u['wall_s']:.3f} s "
              f"= {u['tokens_per_s']:.1f} tokens/s, TTFT median "
              f"{u['ttft_ms_median']:.1f} ms max {u['ttft_ms_max']:.1f} ms; "
              f"decode step {u['decode_step_us']}; prefill "
              f"{u['prefill_us']}; traced: device busy "
              f"{t['busy_share']:.3f} of {t['wall_s']:.3f} s, launches "
              f"{t['launches']}", flush=True)
        for k in t["by_kernel"]:
            print(f"  {k['us'] / 1e3:9.3f} ms  x{k['count']:<6d} {k['name']}")
    summary = {"card": card, "device": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "windows": report}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
