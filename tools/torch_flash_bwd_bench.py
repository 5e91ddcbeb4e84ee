#!/usr/bin/env python3
"""The flash and paged kernels of paddle_tpu_torch on one card: by default
the bf16 training kernels (the forward, the delta kernel, dQ and dK/dV),
with --serve the serving kernels (the float32 flash forward, the float32
and int8 paged decode kernels), with --train32 the float32 training
kernels (dQ, dK/dV and the delta kernel).

    python tools/torch_flash_bwd_bench.py [--root DIR] [--reps N]
        [--serve [--nvcc] | --train32] [--out FILE]

--root DIR  import paddle_tpu_torch from the checkout DIR (for example a
            parent commit unpacked with `git archive`), so that two
            versions can be compared on one card in one run (parent,
            change, change, parent); default: the checkout that holds
            this script. Its kernels build under DIR.
--reps N    host-time repetitions (default 200; bf16 mode)
--serve     time the serving kernels instead (below)
--nvcc      with --serve, before building, compile each of the three
            serving kernels' sources alone with the package's nvcc
            flags, one after another, and report each one's wall
            seconds and exit code (nothing else runs beside it, so the
            seconds are comparable across checkouts in one run)
--train32   time the float32 dQ, dK/dV and delta kernels instead (below)

The bf16 mode reports the build report of every flash instantiation, the
forward's times beside SDPA's bf16 forward, the delta kernel's beside its
plain version, and the backward pair's beside SDPA's bf16 backward. Their
checks against the plain versions are tests/test_torch_cuda.py's (-m
cuda) and chip_smoke.py's. At train-base-amp's attention shape (B 64, H 8, T 256, D 64), causal or
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

The --serve mode times head dims 32, 64 and 128 (which every checkout
since the paged split takes; chip_smoke.py's phase 7u times the others)
with chip_smoke.py's checks, which also hold each kernel against its
plain version (within TOL, two launches bit-equal, the paged poison and
seq_len 0): the flash forward at phase 3's serving shape (4 rows, T 512,
causal) with H = 512 // D and at train-base's attention (B 32, H 8,
T 256, non-causal, rate 0.1) where D is 64; the paged kernel at
serve-base's 8 slots and the int8 one at serve-base-int8's 32,
H = 512 // D. Reported: the median CUDA-event time on a cold L2
(chip_smoke.time_ms) of the kernel, its plain version and, for the
forward, SDPA; the bound; the build's registers, spills and shared
memory of each float32 flash and paged instantiation.

The --train32 mode times head dims 32, 64 and 128 with chip_smoke.py's
check_train_kernels, which also holds each kernel against its plain
version (within TOL / BWD_TOL, two launches bit-equal): at train-base's
attention (B 32, T 256, H = 512 // D), non-causal and causal, rate 0.1,
and non-causal at rate 0. Reported: the median CUDA-event time on a
cold L2 of dQ, dK/dV and the delta kernel, the plain backward's, SDPA's
float32 backward at rate 0, each bound; and the build report of every
float32 dQ and dK/dV instantiation with the build's seconds.

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
SERVE_DIMS = (32, 64, 128)
NVCC_SOURCES = ("flash_fwd.cu", "paged_decode.cu", "paged_decode_q8.cu")


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


def nvcc_seconds(native):
    """Each source of NVCC_SOURCES compiled alone, in turn: {source:
    {seconds, exit}}."""
    out = {}
    nvcc = native._nvcc()
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    for src in NVCC_SOURCES:
        obj = os.path.join(native.BUILD_DIR, f".nvcc_seconds_{os.getpid()}.o")
        t0 = time.perf_counter()
        p = subprocess.run([nvcc, *native.NVCC_FLAGS, "-c",
                            os.path.join(native.CSRC, src), "-o", obj],
                           capture_output=True, text=True)
        out[src] = {"seconds": time.perf_counter() - t0,
                    "exit": p.returncode}
        if os.path.exists(obj):
            os.unlink(obj)
    return out


def serve_rows(torch, cs, native, fa, rows):
    """The --serve mode: the serving kernels at SERVE_DIMS."""
    from paddle_tpu_torch.ops import paged_attention as pa
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(rows, {"flash_build": {
        k: v for k, v in cs.flash_build_report(native, n_expected=None)
        .items() if k.startswith("flash_fwd<")},
        "paged_build": cs.paged_build_report(native, n_expected=None)})
    flush = cs._l2_flusher(torch)
    for D in SERVE_DIMS:
        H = 512 // D
        emit(rows, {"kernel": "flash_fwd", "D": D, "H": H,
                    **cs.check_flash(torch, fa, flush, 4, 512, H=H, D=D)})
        if D == 64:
            train = cs.check_train_kernels(torch, fa, flush, cs.TRAIN_BATCH,
                                           8, 256, 64, False, 0.1)
            emit(rows, {"kernel": "flash_fwd", "D": 64, "H": 8,
                        "case": "B=32 T=256 non-causal rate 0.1",
                        **{k: v for k, v in train.items()
                           if k.startswith("fwd")}})
        emit(rows, {"kernel": "paged_decode", "D": D, "H": H,
                    **cs.check_paged(torch, pa, flush, H=H, Dh=D)})
        emit(rows, {"kernel": "paged_decode_q8", "D": D, "H": H,
                    **cs.check_paged_q8(torch, pa, flush, H=H, Dh=D)})


TRAIN32_CASES = [(False, 0.1), (True, 0.1), (False, 0.0)]


def train32_rows(torch, cs, native, fa, rows):
    """The --train32 mode: the float32 training kernels at SERVE_DIMS."""
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(rows, {"flash_build": {
        k: v for k, v in cs.flash_build_report(native, n_expected=None)
        .items() if k.startswith(("flash_dq<", "flash_dkv<"))},
        "build_s": native.build_info.seconds})
    flush = cs._l2_flusher(torch)
    keys = ("dq_", "dkv_", "delta_", "bwd_")
    for D in SERVE_DIMS:
        for causal, rate in TRAIN32_CASES:
            res = cs.check_train_kernels(torch, fa, flush, cs.TRAIN_BATCH,
                                         512 // D, 256, D, causal, rate)
            emit(rows, {"kernel": "flash_bwd_f32", **{
                k: v for k, v in res.items()
                if k in ("B", "H", "T", "D", "causal", "rate")
                or k.startswith(keys)}})


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
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--nvcc", action="store_true")
    ap.add_argument("--train32", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.nvcc and not args.serve:
        ap.error("--nvcc times the serving kernels' sources: give --serve")
    if args.train32 and args.serve:
        ap.error("--train32 and --serve are two modes: give one")
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
    if args.serve:
        head = {"root": root, "card": card}
        if args.nvcc:
            head["nvcc"] = nvcc_seconds(native)
        native.lib()
        emit(rows, dict(head, build_s=native.build_info.seconds))
        serve_rows(torch, cs, native, fa, rows)
    elif args.train32:
        native.lib()
        emit(rows, {"root": root, "card": card})
        train32_rows(torch, cs, native, fa, rows)
    else:
        native.lib()
        emit(rows, {"root": root, "card": card,
                    **build_report(cs, native)})
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
