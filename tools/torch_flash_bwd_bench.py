#!/usr/bin/env python3
"""The bf16 flash kernels of paddle_tpu_torch on one card (the forward, the
delta kernel, dQ and dK/dV): the build report of every flash
instantiation, the forward's times beside SDPA's bf16 forward, the
delta kernel's beside its plain version, and the backward pair's beside
SDPA's bf16 backward. Their checks against the plain versions are
tests/test_torch_cuda.py's (-m cuda) and chip_smoke.py's.

    python tools/torch_flash_bwd_bench.py [--root DIR] [--reps N]
        [--out FILE]

--root DIR  import paddle_tpu_torch from the checkout DIR (for example a
            parent commit unpacked with `git archive`), so that two
            versions can be compared on one card in one run; default:
            the checkout that holds this script. Its kernels build under
            DIR.
--reps N    host-time repetitions (default 200)

At train-base-amp's attention shape (B 64, H 8, T 256, D 64), causal or
not, rate 0.1 or 0: the median CUDA-event time on a cold L2
(chip_smoke.time_ms) of the bf16 forward and of SDPA's bf16 forward at
the case's dropout_p, of dQ, of dK/dV, of `flash_delta` and of its plain
version (`_flash_delta_reference`; in a checkout from before the delta
kernel, `flash_delta` is that plain version), of what `_flash_backward`
launches (delta + dQ + dK/dV), of SDPA's bf16 backward at the case's
dropout_p and at 0, each kernel's bound (bytes, or products at 989
TFLOP/s); and the host time of one wrapper call of the forward, dQ and
dK/dV (an enqueue: its tensor maps, attribute and launch), averaged over
--reps calls.

Prints one JSON object a line (the build report, each case) and, with
--out, writes them all to FILE. Needs a card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TIME_CASES = [(64, 8, 256, 64, causal, rate)
              for causal, rate in ((False, 0.1), (True, 0.1), (False, 0.0),
                                   (True, 0.0))]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def emit(rows, row):
    rows.append(row)
    print(json.dumps(row), flush=True)


def build_report(cs, native):
    """Every flash instantiation's line of the build report (registers,
    spills, shared memory, HMMA and HGMMA counts: the float32 ones to
    hold against another checkout's) and the compiler's warnings about
    wgmma."""
    rep = cs.flash_build_report(native, n_expected=None)
    warnings = [line.strip() for line in native.build_info.log.splitlines()
                if re.search(r"warning|wgmma|setmaxnreg", line, re.I)]
    return {"build": rep, "seconds": native.build_info.seconds,
            "warnings": warnings[:40]}


def host_us(torch, fn, reps):
    """Host microseconds of one call of `fn` (an enqueue), over `reps`."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def time_case(torch, fa, cs, flush, B, H, T, D, causal, rate, reps):
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 9 * T
                                                   + int(causal))
    q, k, v, do = (torch.randn(B, H, T, D, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    sm, seed = D ** -0.5, cs.ATTN_SEED
    out, lse = fa._flash_forward(q, k, v, causal, sm, rate, seed)
    delta = fa.flash_delta(out, do)
    plain_delta = getattr(fa, "_flash_delta_reference", fa.flash_delta)
    row = {"case": f"B={B} H={H} T={T} D={D} causal={causal} rate={rate}"}
    row["fwd_ms"] = cs.time_ms(torch, lambda: fa._flash_forward(
        q, k, v, causal, sm, rate, seed), flush)
    row["sdpa_fwd_ms"] = cs.time_ms(
        torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=sm, dropout_p=rate), flush)
    row["dq_ms"] = cs.time_ms(torch, lambda: fa._flash_dq(
        q, k, v, do, lse, delta, causal, sm, rate, seed), flush)
    row["dkv_ms"] = cs.time_ms(torch, lambda: fa._flash_dkv(
        q, k, v, do, lse, delta, causal, sm, rate, seed), flush)
    row["delta_ms"] = cs.time_ms(torch, lambda: fa.flash_delta(out, do),
                                 flush)
    row["delta_plain_ms"] = cs.time_ms(torch, lambda: plain_delta(out, do),
                                       flush)
    row["backward_ms"] = cs.time_ms(torch, lambda: fa._flash_backward(
        q, k, v, out, lse, do, causal, sm, rate, seed), flush)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    for key, p in (("sdpa_ms", rate), ("sdpa_rate0_ms", 0.0)):
        lib_out = F.scaled_dot_product_attention(
            *leaves, is_causal=causal, scale=sm, dropout_p=p)
        row[key] = cs.time_ms(torch, lambda: torch.autograd.grad(
            lib_out, leaves, do, retain_graph=True), flush)
    half = 0.5 if causal else 1.0
    bht, bhtd = B * H * T, B * H * T * D
    # bf16 elements 2 bytes, lse and delta 4 a row
    for name, n_products, n_tensors, n_rows in (("fwd", 2, 4, 1),
                                                ("dq", 3, 5, 2),
                                                ("dkv", 4, 6, 2),
                                                ("delta", 0, 2, 1)):
        row[name + "_bound_ms"], row[name + "_bound_by"] = cs._bound(
            n_products * 2.0 * bhtd * T * half,
            n_tensors * bhtd * 2.0 + n_rows * bht * 4.0, cs.PEAK_BF16_FLOPS)
    row["fwd_host_us"] = host_us(torch, lambda: fa._flash_forward(
        q, k, v, causal, sm, rate, seed), reps)
    row["dq_host_us"] = host_us(torch, lambda: fa._flash_dq(
        q, k, v, do, lse, delta, causal, sm, rate, seed), reps)
    row["dkv_host_us"] = host_us(torch, lambda: fa._flash_dkv(
        q, k, v, do, lse, delta, causal, sm, rate, seed), reps)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_bwd_bench: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import native
    if not native.CSRC.startswith(root):
        raise RuntimeError(f"imported {native.CSRC}, not from {root}")
    cs = _chip_smoke()
    rows = []
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    native.lib()
    emit(rows, {"root": root, "card": card, **build_report(cs, native)})
    flush = cs._l2_flusher(torch)
    for case in TIME_CASES:
        emit(rows, time_case(torch, fa, cs, flush, *case, args.reps))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
