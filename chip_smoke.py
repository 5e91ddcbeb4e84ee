#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (an H100:
the kernels are built for sm_90a). Phases, each of which fails the run:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels of ``paddle_tpu_torch/csrc`` and print the build
   time and the compiler's register / shared-memory report;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it (max error vs tolerance, kernel ms,
   plain ms, the least time the card could take, and for flash the time
   of `F.scaled_dot_product_attention` as a yardstick);
4. save the serve-base tiny_lm (vocab 30000, d_model 512, 8 heads, 6
   layers, 8 slots, block 16, context 1024) from a seed, serve it with
   `InferenceServer(CUDAPlace(0))`, send 8 concurrent generate requests
   (prompts of 40..500 tokens, 32 new tokens each), check that each
   kernel was launched 6 times per prefill step / decode step, and that
   the tokens equal a `CPUPlace()` run of the same dir;
5. print one JSON line with every kernel's numbers.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``,
printed only when every phase passed. Without a card, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
WEIGHT_SEED = 11    # serve-base's random weights
TOL = 1e-4         # kernel vs plain version: f32 summation order + expf
LOGIT_TOL = 1e-3    # card vs host prefill logits through 6 layers
PEAK_F32_FLOPS = 67e12      # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
SERVE_BASE = dict(vocab=30000, d_model=512, n_heads=8, n_layers=6,
                  max_slots=8, block_size=16, max_context=1024,
                  prefill_rows=(1, 2, 4), prefill_seq_rungs=(128, 256, 512),
                  kv_dtype="fp32")
N_REQUESTS, NEW_TOKENS = 8, 32


def log(*a):
    print(*a, flush=True)


def _l2_flusher(torch):
    buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    return lambda: buf.zero_()


HOLD_CYCLES = 4_000_000    # ~2 ms spin at the H100's clocks


def time_ms(torch, fn, flush, iters=20, warmup=3):
    """Median CUDA-event time of one call of `fn` on a cold L2. Before each
    timed call the stream is flushed and then held by a ~2 ms spin
    (`torch.cuda._sleep`), so the host has enqueued the whole call before
    the first event fires: the interval holds the device work of `fn`, not
    the Python and launch overhead of enqueueing it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(HOLD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def check_flash(torch, fa, flush, rows, T, H=8, D=64):
    """One flash case: returns its numbers."""
    g = torch.Generator(device="cuda").manual_seed(SEED + rows * 1000 + T)
    q, k, v = (torch.randn(rows, H, T, D, device="cuda", generator=g)
               for _ in range(3))
    sm = D ** -0.5
    out, lse = fa._flash_forward(q, k, v, True, sm)
    ref = fa._attention_reference(q, k, v, True, sm)
    ref_lse = fa._lse_reference(q, k, True, sm)
    torch.cuda.synchronize()
    err = max(float((out - ref).abs().max()), float((lse - ref_lse).abs().max()))
    if not err <= TOL:
        raise AssertionError(f"flash rows={rows} T={T}: max error {err} > {TOL}")
    ms = time_ms(torch, lambda: fa._flash_forward(q, k, v, True, sm), flush)
    plain = time_ms(torch, lambda: fa._attention_reference(q, k, v, True, sm),
                    flush)
    lib = time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=sm), flush)
    flops = 2.0 * rows * H * T * T * D                      # causal half
    nbytes = (4.0 * rows * H * T * D + rows * H * T) * 4     # q,k,v,o + lse
    bound = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    return dict(rows=rows, T=T, err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bound,
                bound_by="operations" if flops / PEAK_F32_FLOPS
                >= nbytes / PEAK_BYTES else "bytes")


def check_paged(torch, pa, flush, S=8, H=8, Dh=64, BS=16, max_ctx=1024):
    """The paged case: ragged seq_lens incl. 0 and the full context, block
    tables drawn from a shuffled pool; positions a slot must not read
    (past its seq_len, and the trash block) hold NaN."""
    import numpy as np
    rng = np.random.RandomState(SEED)
    max_b = max_ctx // BS
    NB = 1 + S * max_b
    seq = np.array([0, 1, 17, 300, 555, 777, 1000, 1024][:S], np.int32)
    pool = rng.permutation(np.arange(1, NB)).astype(np.int32)
    bt = np.zeros((S, max_b), np.int32)
    for s in range(S):
        n = -(-int(seq[s]) // BS)
        bt[s, :n] = pool[s * max_b: s * max_b + n]
    kc = torch.full((NB, BS, H, Dh), float("nan"), device="cuda")
    vc = torch.full((NB, BS, H, Dh), float("nan"), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    # data in exactly the rows the slots may read
    live_blk, live_off = [], []
    for s in range(S):
        for p in range(int(seq[s])):
            live_blk.append(bt[s, p // BS])
            live_off.append(p % BS)
    lb = torch.tensor(live_blk, dtype=torch.long, device="cuda")
    lo = torch.tensor(live_off, dtype=torch.long, device="cuda")
    kc[lb, lo] = torch.randn(len(live_blk), H, Dh, device="cuda", generator=g)
    vc[lb, lo] = torch.randn(len(live_blk), H, Dh, device="cuda", generator=g)
    q = torch.randn(S, H, Dh, device="cuda", generator=g)
    btt = torch.from_numpy(bt).cuda()
    sl = torch.from_numpy(seq).cuda()
    sm = Dh ** -0.5
    out = pa._paged_attention_cuda(q, kc, vc, btt, sl, sm)
    # the plain version gathers whole blocks: give it the NaN-free copy
    ref = pa.paged_attention_reference(q, torch.nan_to_num(kc),
                                       torch.nan_to_num(vc), btt, sl, sm)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("paged kernel read a position it must not")
    if bool(out[0].abs().max() != 0):
        raise AssertionError("paged kernel: seq_len 0 slot is not zeros")
    err = float((out - ref).abs().max())
    if not err <= TOL:
        raise AssertionError(f"paged: max error {err} > {TOL}")
    kz, vz = torch.nan_to_num(kc), torch.nan_to_num(vc)
    ms = time_ms(torch, lambda: pa._paged_attention_cuda(q, kz, vz, btt, sl, sm),
                 flush)
    plain = time_ms(torch, lambda: pa.paged_attention_reference(
        q, kz, vz, btt, sl, sm), flush)
    total = int(seq.sum())
    nbytes = (total * H * Dh * 2 + 2 * S * H * Dh) * 4.0 \
        + 4.0 * (S + int(sum(-(-int(x) // BS) for x in seq)))
    flops = 4.0 * total * H * Dh
    bound = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    return dict(S=S, seq_lens=seq.tolist(), err=err, ms=ms, plain_ms=plain,
                library_ms=None, bound_ms=bound,
                bound_by="bytes" if nbytes / PEAK_BYTES
                >= flops / PEAK_F32_FLOPS else "operations")


def prompts_for(vocab, lens=None):
    """Random prompts from SEED; by default serve-base's traffic, prompts
    of 40..500 tokens."""
    import numpy as np
    rng = np.random.RandomState(SEED)
    if lens is None:
        lens = np.linspace(40, 500, N_REQUESTS).astype(int)
    return [rng.randint(0, vocab, size=int(n)).tolist() for n in lens]


def serve_all(srv, name, prompts, timeout):
    futs = [srv.submit_generate(name, p, max_new_tokens=NEW_TOKENS)
            for p in prompts]
    return [f.result(timeout=timeout) for f in futs]


def prefill_logits(ver, prompt, rung):
    """One prefill step on an all-zero block table: every K/V write lands
    in the trash block, so the served cache is untouched."""
    import numpy as np
    sig = ver.decode.signature
    tokens = np.zeros((1, rung), np.int64)
    tokens[0, :len(prompt)] = prompt
    return ver.prepared.run({
        "tokens": tokens,
        "block_tables": np.zeros((1, sig["max_blocks_per_seq"]), np.int32),
        "seq_lens": np.array([len(prompt)], np.int32)})[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch as ptt
        from paddle_tpu_torch.models import tiny_lm
        from paddle_tpu_torch.ops import flash_attention as fa
        from paddle_tpu_torch.ops import native
        from paddle_tpu_torch.ops import paged_attention as pa
    except ImportError as e:
        print(f"chip_smoke: paddle_tpu_torch is not importable here ({e}); "
              f"run from the root of a checkout", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(ptt.__file__)))
    if pkg_root != here:
        print(f"chip_smoke: imported paddle_tpu_torch from {pkg_root}, not "
              f"from the checkout beside this script ({here})",
              file=sys.stderr)
        return 2
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")

    # 2. build
    native.lib()
    info = native.build_info
    log(f"build: {info.seconds:.2f} s -> {os.path.relpath(info.path)}")
    for line in info.log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "error", "==")):
            log("  " + line.strip())

    # 3. kernels vs their plain versions
    flush = _l2_flusher(torch)
    flash_cases = [check_flash(torch, fa, flush, r, T)
                   for r in (1, 2, 4) for T in (128, 256, 512)]
    flash_cases.append(check_flash(torch, fa, flush, 3, 200))   # ragged T
    for c in flash_cases:
        log(f"flash_fwd rows={c['rows']} T={c['T']} H=8 D=64 causal: "
            f"max_abs_err {c['err']:.3g} (tol {TOL}) kernel {c['ms']:.4f} ms "
            f"plain {c['plain_ms']:.4f} ms sdpa {c['library_ms']:.4f} ms "
            f"bound {c['bound_ms']:.4f} ms ({c['bound_by']}) [{card}]")
    paged = check_paged(torch, pa, flush)
    log(f"paged_decode S=8 H=8 Dh=64 BS=16 seq_lens={paged['seq_lens']}: "
        f"max_abs_err {paged['err']:.3g} (tol {TOL}) kernel {paged['ms']:.4f} ms "
        f"plain {paged['plain_ms']:.4f} ms bound {paged['bound_ms']:.4f} ms "
        f"({paged['bound_by']}) [{card}]")

    # 4. the serving path
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        mdir = os.path.join(tmp, "serve_base")
        t0 = time.perf_counter()
        sig = tiny_lm.save_tiny_lm(mdir, seed=WEIGHT_SEED, **SERVE_BASE)
        log(f"saved serve-base tiny_lm in {time.perf_counter() - t0:.1f} s")
        prompts = prompts_for(sig["vocab"])

        srv = ptt.serve.InferenceServer(ptt.CUDAPlace(0))
        try:
            t0 = time.perf_counter()
            ver = srv.add_model("lm", mdir)
            torch.cuda.synchronize()
            log(f"load + verify + warm on the card: "
                f"{time.perf_counter() - t0:.2f} s")
            before = srv.stats()["models"]["lm"]
            native.reset_launches()
            t0 = time.perf_counter()
            results = serve_all(srv, "lm", prompts, timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(native.launches)
            after = srv.stats()["models"]["lm"]
            card_logits = prefill_logits(ver, prompts[0], 128)
        finally:
            srv.close()
        n_prefill = after["prefill_steps"] - before["prefill_steps"]
        n_decode = after["steps"] - before["steps"]
        n_layers = sig["n_layers"]
        log(f"served {N_REQUESTS} requests: {n_prefill} prefill steps, "
            f"{n_decode} decode steps, launches {launches}")
        if launches["flash_fwd"] != n_layers * n_prefill or n_prefill < 1:
            raise AssertionError(
                f"flash_fwd launched {launches['flash_fwd']} times, expected "
                f"{n_layers} x {n_prefill} prefill steps")
        if launches["paged_decode"] != n_layers * n_decode or n_decode < 1:
            raise AssertionError(
                f"paged_decode launched {launches['paged_decode']} times, "
                f"expected {n_layers} x {n_decode} decode steps")
        for p, r in zip(prompts, results):
            if len(r.tokens) != NEW_TOKENS or r.finish_reason != "length" \
                    or not all(0 <= t < sig["vocab"] for t in r.tokens):
                raise AssertionError(f"bad generation for a {len(p)}-token "
                                     f"prompt: {r}")
        if not np.isfinite(card_logits).all() \
                or card_logits.shape != (1, sig["vocab"]):
            raise AssertionError("prefill logits not finite / wrong shape")
        ttft = sorted(r.ttft_us / 1e3 for r in results)
        gen_tokens = sum(len(r.tokens) for r in results)
        log(f"serve-base on the card [{card}]: TTFT median "
            f"{ttft[len(ttft) // 2]:.1f} ms max {ttft[-1]:.1f} ms; "
            f"{gen_tokens} tokens in {wall:.3f} s = "
            f"{gen_tokens / wall:.1f} tokens/s; decode steps "
            f"{n_decode} ({(wall * 1e3) / max(n_decode, 1):.2f} ms/step "
            f"incl. prefills)")

        # the same dir on the host: tokens must agree
        t0 = time.perf_counter()
        host = ptt.serve.InferenceServer(ptt.CPUPlace())
        try:
            hver = host.add_model("lm_host", mdir, warm=False)
            host_results = serve_all(host, "lm_host", prompts, timeout=900)
            host_logits = prefill_logits(hver, prompts[0], 128)
        finally:
            host.close()
        log(f"host reference run: {time.perf_counter() - t0:.1f} s")
        for i, (a, b) in enumerate(zip(results, host_results)):
            if a.tokens != b.tokens:
                raise AssertionError(
                    f"request {i}: card tokens {a.tokens} != host tokens "
                    f"{b.tokens}")
        logit_err = float(np.abs(card_logits - host_logits).max())
        if not logit_err <= LOGIT_TOL:
            raise AssertionError(f"prefill logits card vs host: max error "
                                 f"{logit_err} > {LOGIT_TOL}")
        log(f"tokens equal to the host run for all {N_REQUESTS} requests; "
            f"prefill logits max_abs_err {logit_err:.3g} (tol {LOGIT_TOL})")

    # 5. the kernels line
    big = max(flash_cases, key=lambda c: (c["rows"] * c["T"] ** 2))
    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "paddle_tpu/ops/pallas_attention.py:152",
         "launches": launches["flash_fwd"],
         "max_abs_err": max(c["err"] for c in flash_cases),
         "ms": big["ms"], "plain_ms": big["plain_ms"],
         "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
         "library_ms": big["library_ms"],
         "shape": f"rows={big['rows']} H=8 T={big['T']} D=64 causal f32"},
        {"name": "paged_decode", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_decode.cu",
         "replaces": "paddle_tpu/ops/paged_attention.py:138",
         "launches": launches["paged_decode"],
         "max_abs_err": paged["err"],
         "ms": paged["ms"], "plain_ms": paged["plain_ms"],
         "bound_ms": paged["bound_ms"], "bound_by": paged["bound_by"],
         "library_ms": None,
         "shape": f"S=8 H=8 Dh=64 BS=16 seq_lens={paged['seq_lens']} f32"},
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
