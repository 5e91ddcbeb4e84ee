#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (an H100:
the kernels are built for sm_90a). Phases, each of which fails the run:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels of ``paddle_tpu_torch/csrc`` (flash forward,
   flash backward, paged decode) and print the build time and the
   compiler's register / shared-memory report;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes its path gives it (max error vs tolerance, kernel ms, plain ms,
   the least time the card could take, and where one PyTorch call
   computes the same function, its time as a yardstick): the flash
   forward at the serving shapes; the flash forward with attention
   dropout and the dQ and dK/dV kernels at the training shapes (B 32,
   H 8, T 256, D 64, causal and not, rate 0 and 0.1, and a ragged T 200);
   the dropout mask of all three exactly equal to the plain version's;
   the paged decode kernel;
4. serve-base: save the tiny_lm (vocab 30000, d_model 512, 8 heads, 6
   layers, 8 slots, block 16, context 1024) from a seed, serve it with
   `InferenceServer(CUDAPlace(0))`, send 8 concurrent generate requests
   (prompts of 40..500 tokens, 32 new tokens each), check that each
   kernel was launched 6 times per prefill step / decode step, and that
   the tokens equal a `CPUPlace()` run of the same dir;
5. train-base: build Transformer-base (`models/transformer.py`: vocab
   30000, seq 256, 6 layers, 8 heads, d_model 512, d_inner 2048, dropout
   0.1, fused attention) with `Adam(1e-3)`, run its startup with
   `Executor(CUDAPlace(0))` and take 10 steps on one fixed batch of
   32 x 256 tokens: losses finite and falling, and per step 36 flash
   forward launches (18 attentions, each run again by its grad op), 18 dQ
   and 18 dK/dV launches; print step ms, tokens/s and peak memory;
6. train parity: the same model at dropout 0, batch 2, from one startup
   state loaded into a `CUDAPlace(0)` and a `CPUPlace()` executor: 3
   steps, losses equal within LOSS_RTOL;
7. print one JSON line with every kernel's numbers.

Float32 matrix products run in full float32 (TF32 off, set below).

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
# backward kernels vs the plain backward: |a - b| <= BWD_TOL (1 + |b|).
# dQ, dK and dV are sums over T of products of f32 sums over D, taken in
# another order than cuBLAS takes the plain version's
BWD_TOL = 1e-4
LOGIT_TOL = 1e-3    # card vs host prefill logits through 6 layers
# card vs host losses of train-base: f32 summation order through ~1000 ops
# a step, amplified by Adam's division by sqrt(v) for the smallest grads
LOSS_RTOL = 1e-3
PEAK_F32_FLOPS = 67e12      # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
SERVE_BASE = dict(vocab=30000, d_model=512, n_heads=8, n_layers=6,
                  max_slots=8, block_size=16, max_context=1024,
                  prefill_rows=(1, 2, 4), prefill_seq_rungs=(128, 256, 512),
                  kv_dtype="fp32")
N_REQUESTS, NEW_TOKENS = 8, 32
TRAIN_BASE = dict(src_vocab_size=30000, trg_vocab_size=30000, seq_len=256,
                  n_layer=6, n_head=8, d_model=512, d_inner=2048,
                  dropout_rate=0.1, fused_attention=True)
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 32, 10, 1e-3
PARITY_BATCH, PARITY_STEPS = 2, 3
DATA_SEED = 21      # the fixed training batch
ATTN_SEED = 12345   # attention-dropout seed of the kernel checks


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


def _bound(flops, nbytes):
    """(ms, what bounds it) for `flops` f32 operations and `nbytes`."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                        else "bytes")


def check_train_kernels(torch, fa, flush, B, H, T, D, causal, rate):
    """The training path's three kernels at one shape: the forward with
    attention dropout, dQ and dK/dV, each against its plain version on the
    same inputs; returns their numbers."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(SEED + 7 * T + int(causal))
    q, k, v, do = (torch.randn(B, H, T, D, device="cuda", generator=g)
                   for _ in range(4))
    sm, seed = D ** -0.5, ATTN_SEED
    out, lse = fa._flash_forward(q, k, v, causal, sm, rate, seed)
    ref = fa._attention_reference(q, k, v, causal, sm, rate, seed)
    ref_lse = fa._lse_reference(q, k, causal, sm)
    delta = (do * out).sum(-1)
    dq = fa._flash_dq(q, k, v, do, lse, delta, causal, sm, rate, seed)
    dk, dv = fa._flash_dkv(q, k, v, do, lse, delta, causal, sm, rate, seed)
    refs = fa._flash_backward_reference(q, k, v, out, lse, do, causal, sm,
                                        rate, seed)
    torch.cuda.synchronize()
    tag = f"B={B} H={H} T={T} D={D} causal={causal} rate={rate}"
    fwd_err = max(float((out - ref).abs().max()),
                  float((lse - ref_lse).abs().max()))
    if not fwd_err <= TOL:
        raise AssertionError(f"flash_fwd {tag}: max error {fwd_err} > {TOL}")
    bwd_err = {}
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        bwd_err[name] = float((a - b).abs().max())
        excess = float(((a - b).abs() - BWD_TOL * (1 + b.abs())).max())
        if not excess <= 0:
            raise AssertionError(
                f"{name} {tag}: max error {bwd_err[name]} exceeds "
                f"{BWD_TOL} * (1 + |plain|)")
    res = dict(B=B, H=H, T=T, D=D, causal=causal, rate=rate,
               fwd_err=fwd_err, dq_err=bwd_err["dq"],
               dkv_err=max(bwd_err["dk"], bwd_err["dv"]))
    res["fwd_ms"] = time_ms(torch, lambda: fa._flash_forward(
        q, k, v, causal, sm, rate, seed), flush)
    res["fwd_plain_ms"] = time_ms(torch, lambda: fa._attention_reference(
        q, k, v, causal, sm, rate, seed), flush)
    res["fwd_library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, scale=sm, dropout_p=rate), flush)
    res["dq_ms"] = time_ms(torch, lambda: fa._flash_dq(
        q, k, v, do, lse, delta, causal, sm, rate, seed), flush)
    res["dkv_ms"] = time_ms(torch, lambda: fa._flash_dkv(
        q, k, v, do, lse, delta, causal, sm, rate, seed), flush)
    res["bwd_plain_ms"] = time_ms(torch, lambda: fa._flash_backward_reference(
        q, k, v, out, lse, do, causal, sm, rate, seed), flush)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                             scale=sm)
    res["bwd_library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, leaves, do, retain_graph=True), flush)
    half = 0.5 if causal else 1.0
    bht, bhtd = B * H * T, B * H * T * D
    res["fwd_bound_ms"], res["fwd_bound_by"] = _bound(
        4.0 * bhtd * T * half, (4.0 * bhtd + bht) * 4)
    res["dq_bound_ms"], res["dq_bound_by"] = _bound(
        3 * 2.0 * bhtd * T * half, (5.0 * bhtd + 2 * bht) * 4)
    res["dkv_bound_ms"], res["dkv_bound_by"] = _bound(
        4 * 2.0 * bhtd * T * half, (6.0 * bhtd + 2 * bht) * 4)
    return res


def check_dropout_mask(torch, fa, T=128, B=2, H=8, rate=0.5):
    """With T == D, identity matrices expose each kernel's dropout mask:
    the forward's out with V = I, dQ with K = I and delta = 0, and dV
    with dO = I are zero exactly where a weight was dropped. All three
    must equal the plain version's mask bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    q, k, v, do = (torch.randn(B, H, T, T, device="cuda", generator=g)
                   for _ in range(4))
    eye = torch.eye(T, device="cuda").expand(B, H, T, T).contiguous()
    zero = torch.zeros(B, H, T, device="cuda")
    dropped = ~fa._attention_keep(ATTN_SEED, B * H, T, T, rate,
                                  "cuda").reshape(B, H, T, T)
    out, lse = fa._flash_forward(q, k, eye, False, 0.1, rate, ATTN_SEED)
    dq = fa._flash_dq(q, eye, v, do, lse, zero, False, 0.1, rate, ATTN_SEED)
    _, dv = fa._flash_dkv(q, k, v, eye, lse, zero, False, 0.1, rate,
                          ATTN_SEED)
    for name, got, want in (("flash_fwd", out == 0, dropped),
                            ("flash_dq", dq == 0, dropped),
                            ("flash_dkv", dv == 0, dropped.transpose(-1, -2))):
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: dropout mask differs from the "
                                 f"plain version's in "
                                 f"{int((got != want).sum())} weights")
    return float(dropped.float().mean())


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


def build_train(ptt, **overrides):
    """Transformer-base (TRAIN_BASE with `overrides`) + Adam(TRAIN_LR):
    (main, startup, loss)."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models import transformer
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, fetches = transformer.build(**dict(TRAIN_BASE, **overrides))
        optimizer.Adam(learning_rate=TRAIN_LR).minimize(fetches["loss"])
    return main, startup, fetches["loss"]


def train_batch(batch):
    """One fixed batch of source, target and label ids from DATA_SEED."""
    import numpy as np
    rng = np.random.RandomState(DATA_SEED)
    shape = (batch, TRAIN_BASE["seq_len"])
    return {n: rng.randint(0, TRAIN_BASE["trg_vocab_size"],
                           shape).astype(np.int64)
            for n in ("src_word", "trg_word", "lbl_word")}


def run_train_base(torch, ptt, native):
    """TRAIN_STEPS steps of train-base on the card; returns the numbers,
    with the launch counts of exactly those steps."""
    import numpy as np
    main, startup, loss = build_train(ptt)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = train_batch(TRAIN_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    native.reset_launches()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.asarray(out).reshape(-1)[0]))
    launches = dict(native.launches)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train-base losses not finite: {losses}")
    if not max(losses[-3:]) < min(losses[:3]):
        raise AssertionError(f"train-base loss did not fall: {losses}")
    n_attn = 3 * TRAIN_BASE["n_layer"]
    want = {"flash_fwd": 2 * n_attn * TRAIN_STEPS,
            "flash_dq": n_attn * TRAIN_STEPS,
            "flash_dkv": n_attn * TRAIN_STEPS, "paged_decode": 0}
    if launches != want:
        raise AssertionError(f"train-base launches {launches}, expected "
                             f"{want}")
    last = sorted(step_ms[-5:])
    med = last[len(last) // 2]
    return dict(losses=losses, step_ms=step_ms, step_ms_median=med,
                tokens_per_s=TRAIN_BATCH * TRAIN_BASE["seq_len"] / med * 1e3,
                peak_bytes=peak, launches=launches)


def run_train_parity(torch, ptt):
    """The same startup state, as numpy, on the card and on the host:
    PARITY_STEPS steps of train-base at dropout 0; returns both losses."""
    import numpy as np
    from paddle_tpu_torch.core.executor import fetch_var
    main, startup, loss = build_train(ptt, dropout_rate=0.0)
    scope0 = ptt.Scope()
    ptt.Executor(ptt.CUDAPlace(0)).run(startup, scope=scope0)
    arrays = {n: fetch_var(n, scope0) for n in scope0.local_var_names()}
    del scope0
    feed = train_batch(PARITY_BATCH)
    losses = {}
    for name, place in (("card", ptt.CUDAPlace(0)), ("host", ptt.CPUPlace())):
        scope = ptt.io.state_from_numpy(arrays, place)
        exe = ptt.Executor(place)
        losses[name] = [float(np.asarray(exe.run(
            main, feed=feed, fetch_list=[loss], scope=scope)[0]).reshape(-1)[0])
            for _ in range(PARITY_STEPS)]
        del scope
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                  losses["host"]))
    if not rel <= LOSS_RTOL:
        raise AssertionError(f"train parity: card losses {losses['card']} vs "
                             f"host {losses['host']}: relative error {rel} > "
                             f"{LOSS_RTOL}")
    return dict(losses=losses, rel_err=rel)


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
    train_cases = [check_train_kernels(torch, fa, flush, TRAIN_BATCH, 8, T, 64,
                                       causal, rate)
                   for T, causal, rate in ((256, False, 0.1), (256, True, 0.1),
                                           (256, False, 0.0), (256, True, 0.0),
                                           (200, True, 0.1))]
    for c in train_cases:
        log(f"train kernels B={c['B']} H={c['H']} T={c['T']} D={c['D']} "
            f"causal={c['causal']} rate={c['rate']} [{card}]:")
        log(f"  flash_fwd max_abs_err {c['fwd_err']:.3g} (tol {TOL}) kernel "
            f"{c['fwd_ms']:.4f} ms plain {c['fwd_plain_ms']:.4f} ms sdpa "
            f"{c['fwd_library_ms']:.4f} ms bound {c['fwd_bound_ms']:.4f} ms "
            f"({c['fwd_bound_by']})")
        log(f"  flash_dq max_abs_err {c['dq_err']:.3g} (tol {BWD_TOL}*(1+|plain|)) "
            f"kernel {c['dq_ms']:.4f} ms bound {c['dq_bound_ms']:.4f} ms "
            f"({c['dq_bound_by']})")
        log(f"  flash_dkv max_abs_err {c['dkv_err']:.3g} (tol {BWD_TOL}*(1+|plain|)) "
            f"kernel {c['dkv_ms']:.4f} ms bound {c['dkv_bound_ms']:.4f} ms "
            f"({c['dkv_bound_by']})")
        log(f"  backward plain (dq, dk, dv) {c['bwd_plain_ms']:.4f} ms; sdpa "
            f"backward at rate 0 (dq, dk, dv) {c['bwd_library_ms']:.4f} ms")
    dropped = check_dropout_mask(torch, fa)
    log(f"dropout mask of flash_fwd, flash_dq and flash_dkv equal to the plain "
        f"version's bit for bit (rate 0.5, {dropped:.4f} dropped)")

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
            if launches["flash_dq"] or launches["flash_dkv"]:
                raise AssertionError(f"serving launched a backward kernel: "
                                     f"{launches}")
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

    # 5. train-base on the card
    t0 = time.perf_counter()
    train = run_train_base(torch, ptt, native)
    log(f"train-base: {TRAIN_STEPS} steps of batch {TRAIN_BATCH} x "
        f"{TRAIN_BASE['seq_len']} in {time.perf_counter() - t0:.1f} s (build "
        f"and startup included); losses "
        f"{[round(x, 4) for x in train['losses']]}")
    log(f"train-base on the card [{card}]: step {train['step_ms_median']:.1f} ms "
        f"(median of the last 5; all: "
        f"{[round(x, 1) for x in train['step_ms']]}), "
        f"{train['tokens_per_s']:.0f} tokens/s, peak memory "
        f"{train['peak_bytes'] / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated), launches {train['launches']} "
        f"over {TRAIN_STEPS} steps")

    # 6. train parity, card vs host
    t0 = time.perf_counter()
    parity = run_train_parity(torch, ptt)
    log(f"train parity at dropout 0, batch {PARITY_BATCH}: card "
        f"{parity['losses']['card']} host {parity['losses']['host']}, max "
        f"relative error {parity['rel_err']:.3g} (tol {LOSS_RTOL}); "
        f"{time.perf_counter() - t0:.1f} s")

    # 7. the kernels line: flash_fwd's headline numbers at the train path's
    # shape, its serving case beside them
    big = max(flash_cases, key=lambda c: (c["rows"] * c["T"] ** 2))
    head = train_cases[0]          # B 32, T 256, non-causal, rate 0.1
    train_shape = (f"B={head['B']} H={head['H']} T={head['T']} D={head['D']} "
                   f"non-causal rate {head['rate']} f32")
    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "paddle_tpu/ops/pallas_attention.py:152",
         "launches": train["launches"]["flash_fwd"],
         "launches_by_path": {"train": train["launches"]["flash_fwd"],
                              "serve": launches["flash_fwd"]},
         "max_abs_err": max([c["err"] for c in flash_cases]
                            + [c["fwd_err"] for c in train_cases]),
         "ms": head["fwd_ms"], "plain_ms": head["fwd_plain_ms"],
         "bound_ms": head["fwd_bound_ms"], "bound_by": head["fwd_bound_by"],
         "library_ms": head["fwd_library_ms"], "shape": train_shape,
         "serve": {"ms": big["ms"], "plain_ms": big["plain_ms"],
                   "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
                   "library_ms": big["library_ms"],
                   "shape": f"rows={big['rows']} H=8 T={big['T']} D=64 "
                            f"causal f32"}},
        {"name": "flash_dq", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "paddle_tpu/ops/pallas_attention.py:215",
         "launches": train["launches"]["flash_dq"],
         "max_abs_err": max(c["dq_err"] for c in train_cases),
         "ms": head["dq_ms"], "plain_ms": head["bwd_plain_ms"],
         "bound_ms": head["dq_bound_ms"], "bound_by": head["dq_bound_by"],
         "library_ms": head["bwd_library_ms"], "shape": train_shape,
         "note": "plain_ms and library_ms compute dq, dk and dv together"},
        {"name": "flash_dkv", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "paddle_tpu/ops/pallas_attention.py:266",
         "launches": train["launches"]["flash_dkv"],
         "max_abs_err": max(c["dkv_err"] for c in train_cases),
         "ms": head["dkv_ms"], "plain_ms": head["bwd_plain_ms"],
         "bound_ms": head["dkv_bound_ms"], "bound_by": head["dkv_bound_by"],
         "library_ms": head["bwd_library_ms"], "shape": train_shape,
         "note": "plain_ms and library_ms compute dq, dk and dv together"},
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
