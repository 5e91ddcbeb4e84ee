#!/usr/bin/env python
"""torch_torrent_bench: paddle_tpu_torch's disaggregated int8-residency
serving plane vs the co-located baseline, at a FIXED fleet size and a
FIXED per-replica KV byte budget (tools/torrent_bench.py on the port:
the same arms and the same JSON keys).

    python tools/torch_torrent_bench.py [--duration 8] [--clients 12] \
        [--cpu]

Runs the same closed-loop generative workload (tiny LM, subprocess
replicas, in-process router) twice over a 3-replica fleet. The replica
processes serve on `CUDAPlace(0)` — all three share the one card, so a
"chip" below is a replica — or on the host with `--cpu`:

    co-located      the serving plane as it shipped before
                    fluid-torrent: 3 replicas role=both, fp32 KV
                    residency; every replica interleaves prompt
                    prefill with its decode batch
    disaggregated   fluid-torrent: 1 prefill + 2 decode replicas,
                    int8-quantized KV residency; prefill replicas
                    compute KV and wire-stream it to the decode
                    replica the router pinned

and prints one JSON line with TTFT p99, tokens/s/chip, and the KV
bytes the disaggregated mode shipped over the wire.

Both arms get the SAME per-chip device byte budget for KV residency
(--kv-budget-bytes); each arm's max_slots is whatever its residency
layout affords under that budget (serve.kvcache.blocks_for_budget).
That is the honest apples-to-apples device constraint: int8 pays 1
byte per cache position plus a per-block f32 scale vs fp32's 4 bytes,
so the torrent arm seats ~4x the concurrent sequences per chip.

Why the torrent arm should win BOTH metrics from the same 3 replicas,
rehearsed via the serve engine's simulated device knobs: decode is MEMORY-BOUND (a decode step is one
HBM sweep of the resident budget — it costs the same wall time
whether 2 or 9 slots ride it), prefill is COMPUTE-BOUND (cost scales
with prompt tokens). The fp32 baseline can only seat 2 sequences per
sweep, and every prompt's prefill stalls the co-located decode batch;
the torrent arm seats ~4x the sequences per sweep on decode engines
that prefill never stalls, and prompts land on a dedicated prefill
engine instead of queueing behind scarce fp32 decode slots — higher
tokens/s/chip AND lower TTFT p99.

`--prefill-us-per-token` / `--decode-step-us` are the rehearsal
knobs (serve.ServeConfig simulate_*): they model those two device
cost shapes on a rehearsal rig, exactly like torch_fleet_replica's
--device-ms. Real deployments run with both at 0.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

MAX_NEW = 10


def _p(vals, q):
    if not vals:
        return 0.0
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(q * len(vals)))]


def _run_mode(mode, mdir, prompts, ref, args):
    """One closed-loop run; returns the mode's record."""
    from paddle_tpu_torch import fleet
    from torch_fleet_router import spawn_replicas

    router = fleet.FleetRouter(fleet.RouterConfig(
        lease_s=2.0, poll_interval_s=0.3)).start()
    sim = ("--sim-prefill-us-per-token", str(args.prefill_us_per_token),
           "--sim-decode-step-us", str(args.decode_step_us))
    workers = []
    try:
        if mode == "disagg":
            workers += spawn_replicas(
                1, mdir, router.control_endpoint, rid_prefix="p",
                lease_s=2.0, extra_args=("--role", "prefill") + sim,
                cpu=args.cpu)
            workers += spawn_replicas(
                2, mdir, router.control_endpoint, rid_prefix="d",
                lease_s=2.0, extra_args=("--role", "decode") + sim,
                cpu=args.cpu)
        else:
            workers += spawn_replicas(
                3, mdir, router.control_endpoint, rid_prefix="c",
                lease_s=2.0, extra_args=("--role", "both") + sim,
                cpu=args.cpu)
        deadline = time.time() + 120
        while len(router.ready_members("m")) < 3:
            if time.time() > deadline:
                raise RuntimeError(f"{mode}: fleet never became ready")
            time.sleep(0.1)

        stop = threading.Event()
        lock = threading.Lock()
        ttfts, failures, kv_bytes = [], [], [0]
        tokens_done = [0]
        divergent = [0]

        def client(tid):
            r = random.Random(args.seed * 100 + tid)
            while not stop.is_set():
                i = r.randrange(len(prompts))
                try:
                    if mode == "disagg":
                        res = router.generate_torrent(
                            "m", prompts[i], max_new_tokens=MAX_NEW)
                        # first token exists once the prefill half's
                        # stream committed: submit -> prefill (queue
                        # included) -> KV on the decode replica
                        ttft = res.outs["prefill"]["stream_us"]
                        nbytes = res.outs["prefill"]["bytes"]
                    else:
                        res = router.generate(
                            "m", prompts[i], max_new_tokens=MAX_NEW)
                        # engine-observed submit -> first token (queue
                        # + the prefill's ride through the decode loop)
                        ttft = res.outs["ttft_us"] if res.outs else 0.0
                        nbytes = 0
                except Exception as e:      # noqa: BLE001
                    with lock:
                        failures.append(repr(e))
                    continue
                with lock:
                    ttfts.append(float(ttft))
                    kv_bytes[0] += int(nbytes)
                    tokens_done[0] += len(res.tokens)
                    if res.tokens != ref[i]:
                        divergent[0] += 1

        threads = [threading.Thread(target=client, args=(i,),
                                    daemon=True)
                   for i in range(args.clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(args.duration)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        dt = time.perf_counter() - t0
        return {
            "generations": len(ttfts),
            "failed": len(failures),
            "divergent": divergent[0],
            "ttft_p50_us": round(_p(ttfts, 0.50), 1),
            "ttft_p99_us": round(_p(ttfts, 0.99), 1),
            "tokens_per_s": round(tokens_done[0] / dt, 1),
            "tokens_per_s_chip": round(tokens_done[0] / dt / 3, 1),
            "kv_transfer_bytes": kv_bytes[0],
        }
    finally:
        for w in workers:
            if w.poll() is None:
                w.terminate()
        for w in workers:
            try:
                w.wait(timeout=10)
            except Exception:
                w.kill()
        router.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--duration", type=float, default=8.0,
                    help="measured seconds per mode")
    ap.add_argument("--clients", type=int, default=12,
                    help="closed-loop client threads (the concurrent "
                    "sequence population)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--kv-budget-bytes", type=int, default=20 * 1024,
                    help="per-chip device byte budget for KV residency; "
                    "each arm's max_slots is what its layout affords "
                    "(fp32 baseline vs int8 torrent)")
    ap.add_argument("--prefill-us-per-token", type=float, default=500.0,
                    help="simulated compute-bound prefill device time")
    ap.add_argument("--decode-step-us", type=float, default=10000.0,
                    help="simulated memory-bound decode step device "
                    "time (per step, NOT per token: the batch rides "
                    "one step)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="serve on the host, not the card")
    args = ap.parse_args(argv)

    import tempfile

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import serve
    from paddle_tpu_torch.models import tiny_lm

    from paddle_tpu_torch.serve import kvcache

    workdir = args.workdir or tempfile.mkdtemp(prefix="torrent_bench_")
    os.makedirs(workdir, exist_ok=True)

    # size each arm's slot count from the SHARED per-chip KV byte
    # budget: slots = blocks the layout affords / blocks a max-context
    # sequence needs
    geo = dict(block_size=4, max_context=32, prefill_rows=(1, 2),
               prefill_seq_rungs=(8, 16))
    slots = {}
    dirs = {}
    for kv_dtype in ("fp32", "int8"):
        sig = tiny_lm.default_signature(kv_dtype=kv_dtype, max_slots=1,
                                        **geo)
        n = max(1, kvcache.blocks_for_budget(sig, args.kv_budget_bytes)
                // sig["max_blocks_per_seq"])
        slots[kv_dtype] = n
        d = dirs[kv_dtype] = os.path.join(workdir, f"model_{kv_dtype}")
        if not os.path.isdir(d):
            tiny_lm.save_tiny_lm(d, kv_dtype=kv_dtype, max_slots=n, **geo)
        sized = tiny_lm.default_signature(kv_dtype=kv_dtype, max_slots=n,
                                          **geo)
        resident = sized["num_blocks"] * kvcache.block_residency_nbytes(
            sized)
        assert resident <= args.kv_budget_bytes, \
            f"{kv_dtype}: {resident} B of cache over the " \
            f"{args.kv_budget_bytes} B budget"

    rng = random.Random(args.seed)
    prompts = [[rng.randrange(32) for _ in range(rng.randint(8, 16))]
               for _ in range(12)]

    # solo greedy reference: every benched generation must reproduce it
    # exactly (both arms — the int8 layout is token-for-token with fp32,
    # parity-tested in tests/test_torch_torrent.py) — a bench that
    # quietly served wrong tokens would be worthless
    solo = serve.InferenceServer(
        fluid.CPUPlace() if args.cpu else fluid.CUDAPlace(0),
        serve.ServeConfig())
    solo.add_model("m", dirs["fp32"])
    ref = {i: solo.generate("m", p, max_new_tokens=MAX_NEW).tokens
           for i, p in enumerate(prompts)}
    solo.close()

    print(f"torrent bench: {args.clients} closed-loop clients, "
          f"{args.duration:.0f}s per mode, fleet size 3, "
          f"KV budget {args.kv_budget_bytes} B/chip "
          f"(fp32 {slots['fp32']} slots, int8 {slots['int8']} slots)",
          flush=True)
    coloc = _run_mode("coloc", dirs["fp32"], prompts, ref, args)
    print(f"  co-located    3x both (fp32): "
          f"{coloc['tokens_per_s_chip']:>7.1f} tok/s/chip, "
          f"TTFT p99 {coloc['ttft_p99_us'] / 1e3:.1f} ms", flush=True)
    disagg = _run_mode("disagg", dirs["int8"], prompts, ref, args)
    print(f"  disaggregated 1p + 2d (int8): "
          f"{disagg['tokens_per_s_chip']:>7.1f} tok/s/chip, "
          f"TTFT p99 {disagg['ttft_p99_us'] / 1e3:.1f} ms, "
          f"{disagg['kv_transfer_bytes'] / 1e6:.2f} MB KV streamed",
          flush=True)

    ok = (disagg["failed"] == 0 and coloc["failed"] == 0
          and disagg["divergent"] == 0 and coloc["divergent"] == 0)
    out = {
        "torrent_generations_disagg": disagg["generations"],
        "torrent_generations_coloc": coloc["generations"],
        "torrent_failed": disagg["failed"] + coloc["failed"],
        "torrent_divergent": disagg["divergent"] + coloc["divergent"],
        "torrent_ttft_p50_us_disagg": disagg["ttft_p50_us"],
        "torrent_ttft_p99_us_disagg": disagg["ttft_p99_us"],
        "torrent_ttft_p50_us_coloc": coloc["ttft_p50_us"],
        "torrent_ttft_p99_us_coloc": coloc["ttft_p99_us"],
        "torrent_tokens_per_s_chip_disagg": disagg["tokens_per_s_chip"],
        "torrent_tokens_per_s_chip_coloc": coloc["tokens_per_s_chip"],
        "torrent_throughput_gain_x": round(
            disagg["tokens_per_s_chip"] / coloc["tokens_per_s_chip"], 2)
        if coloc["tokens_per_s_chip"] else 0.0,
        "torrent_ttft_p99_gain_x": round(
            coloc["ttft_p99_us"] / disagg["ttft_p99_us"], 2)
        if disagg["ttft_p99_us"] else 0.0,
        "torrent_kv_transfer_bytes": disagg["kv_transfer_bytes"],
        "torrent_kv_budget_bytes": args.kv_budget_bytes,
        "torrent_slots_per_chip_fp32": slots["fp32"],
        "torrent_slots_per_chip_int8": slots["int8"],
        "torrent_sim_prefill_us_per_token": args.prefill_us_per_token,
        "torrent_sim_decode_step_us": args.decode_step_us,
    }
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
