#!/usr/bin/env python
"""torch_serve_loadgen: paddle_tpu_torch's serving load generator,
closed + open loop, with a hot-swap drill (tools/serve_loadgen.py on the
port: the same modes, gates and JSON keys).

Drives an in-process InferenceServer on `CUDAPlace(0)` (the host with
`--cpu`) with mixed-shape traffic and reports the serving numbers:

    python tools/torch_serve_loadgen.py --duration 10
        phase 1 (closed loop): N threads issue back-to-back requests —
        measures the saturated pipeline (coalescing occupancy).
        phase 2 (open loop): Poisson arrivals at --qps with random
        request sizes spanning >= 2 buckets — measures p50/p99 latency
        under realistic load; halfway through, a NEW model version is
        atomically saved over the model dir and the registry watcher
        hot-swaps it mid-traffic.

    python tools/torch_serve_loadgen.py --workload generate --duration 10
        fluid-decode drill: open-loop GENERATIVE traffic (tiny LM,
        ragged prompt/output lengths) through the paged-KV continuous-
        batching engine, with the same mid-run hot-swap drill. A fixed
        probe set is decoded SOLO first; probe prompts re-issued under
        load must produce token-identical generations (greedy decode is
        deterministic — any divergence is a KV-cache aliasing or
        batching bug). `--admission drain` runs the drain-and-refill
        baseline the bench A/Bs against.

    python tools/torch_serve_loadgen.py --replicas 3
        fleet drill: N replica processes (tools/torch_fleet_replica.py)
        behind an in-process FleetRouter; QPS, a coordinated swap with
        a skew gate, and every replica's recompile gate.

Exit status is the CI gate: nonzero if ANY steady-state recompile was
recorded by the observatory after warmup (cause `padding_bucket` means
the bucket ladder is mis-sized; `feed_shape`/anything else means a cache
bug), if any request failed, if the hot swap didn't land — and, for
generate, if any under-load generation mismatched its solo reference.
The JSON line on stdout carries serve_p50_us / serve_p99_us / serve_qps
/ serve_recompiles (one-shot) or decode_tokens_per_s / ttft_p50_us /
ttft_p99_us (generate).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _place(fluid, args):
    """The serving place: the card, unless `--cpu` asks for the host."""
    return fluid.CPUPlace() if args.cpu else fluid.CUDAPlace(0)


def build_and_save(fluid, np, dirname, scale=1.0, seed=7):
    """Tiny MLP book model -> inference dir. `scale` perturbs the params
    so a hot-swapped version is observably different."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        h = fluid.layers.fc(input=x, size=32, act="relu")
        pred = fluid.layers.fc(input=h, size=8, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    if scale != 1.0:
        for v in main.global_block().vars.values():
            if isinstance(v, fluid.Parameter):
                arr = np.asarray(scope.find_var(v.name))
                scope.set_var(v.name, arr * scale)
    fluid.io.save_inference_model(dirname, ["x"], [pred], exe,
                                  main_program=main, scope=scope)


def percentiles(np, lat_us):
    if not lat_us:
        return 0.0, 0.0
    a = np.asarray(lat_us)
    return float(np.percentile(a, 50)), float(np.percentile(a, 99))


def run_generate(args):
    """fluid-decode drill: open-loop generative traffic + hot swap +
    solo-parity gate. Returns the process exit code."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import observe, serve
    from paddle_tpu_torch.models import tiny_lm

    fluid.set_flag("observe", True)

    mdir = args.model_dir
    if mdir is None:
        mdir = os.path.join(tempfile.mkdtemp(prefix="serve_loadgen_gen_"),
                            "model")
    sig = tiny_lm.save_tiny_lm(
        mdir, max_slots=8, block_size=4, max_context=48,
        prefill_rows=(1, 2, 4), prefill_seq_rungs=(8, 16))
    srv = serve.InferenceServer(
        _place(fluid, args),
        serve.ServeConfig(max_queue=args.max_queue, watch_interval_s=0.2,
                          decode_admission=args.admission))
    srv.add_model("g", mdir)
    v0 = srv.registry.get("g").version_id

    rng = random.Random(0)
    max_prompt = max(sig["prefill_seq_rungs"])

    def make_prompt(r):
        n = r.randint(2, max_prompt)
        return [r.randrange(1, sig["vocab"]) for _ in range(n)], \
            r.randint(1, min(24, sig["max_context"] - n))

    # fixed probe set, decoded SOLO first: under-load generations of the
    # same prompts (on the same version) must match token-for-token
    probe_rng = random.Random(1234)
    probes = [make_prompt(probe_rng) for _ in range(6)]
    solo = {}
    for prompt, max_new in probes:
        res = srv.generate("g", prompt, max_new_tokens=max_new)
        solo[tuple(prompt) + (max_new,)] = list(res.tokens)

    # everything warmed + solo baselines on the books: any unexpected
    # observatory event past this line is a steady-state recompile
    baseline_unexpected = len(observe.observatory().unexpected())

    stop = threading.Event()
    failures, mismatches = [], []
    rejected = [0]
    results = []
    lock = threading.Lock()
    inflight = []

    def client(tid):
        r = random.Random(100 + tid)
        lam = args.qps / args.threads
        nxt = time.perf_counter()
        while not stop.is_set():
            nxt += r.expovariate(lam)
            delay = nxt - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            if r.random() < 0.3:
                prompt, max_new = probes[r.randrange(len(probes))]
            else:
                prompt, max_new = make_prompt(r)
            try:
                fut = srv.submit_generate("g", prompt,
                                          max_new_tokens=max_new)
            except Exception as e:      # noqa: BLE001
                with lock:
                    if getattr(e, "retriable", False):
                        rejected[0] += 1
                    else:
                        failures.append(repr(e))
                continue

            def done(f, prompt=prompt, max_new=max_new):
                try:
                    res = f.result()
                except Exception as e:  # noqa: BLE001
                    with lock:
                        if getattr(e, "retriable", False):
                            rejected[0] += 1
                        else:
                            failures.append(repr(e))
                    return
                with lock:
                    results.append(res)
                    key = tuple(prompt) + (max_new,)
                    # parity only against the version the solo ref ran on
                    if key in solo and res.version_id == v0 \
                            and res.tokens != solo[key]:
                        mismatches.append(
                            {"prompt_len": len(prompt),
                             "got": res.tokens, "want": solo[key]})

            fut.add_done_callback(done)
            inflight.append(fut)

    swapped = {"ok": args.no_swap}

    def swap_drill():
        time.sleep(args.duration / 2)
        tiny_lm.save_tiny_lm(mdir, max_slots=8, block_size=4,
                             max_context=48, prefill_rows=(1, 2, 4),
                             prefill_seq_rungs=(8, 16), scale=1.5)
        deadline = time.time() + max(10.0, args.duration)
        while time.time() < deadline:
            if srv.registry.get("g").version_id != v0:
                swapped["ok"] = True
                return
            time.sleep(0.1)

    srv.start_watch()
    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(args.threads)]
    if not args.no_swap:
        threads.append(threading.Thread(target=swap_drill, daemon=True))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(args.duration)
    stop.set()
    for t in threads:
        t.join(timeout=max(15, args.duration))
    for f in inflight:
        try:
            f.result(timeout=60)
        except Exception:
            pass                 # recorded by the callback
    wall = time.perf_counter() - t0

    tokens = sum(len(r.tokens) for r in results)
    ttfts = sorted(r.ttft_us for r in results)
    unexpected = observe.observatory().unexpected()[baseline_unexpected:]
    stats = srv.stats()["models"]["g"]
    srv.close()

    def pct(p):
        if not ttfts:
            return 0.0
        return float(ttfts[min(len(ttfts) - 1,
                               int(p / 100.0 * len(ttfts)))])

    out = {
        "decode_tokens_per_s": round(tokens / wall, 1),
        "ttft_p50_us": round(pct(50), 1),
        "ttft_p99_us": round(pct(99), 1),
        "decode_generations": len(results),
        "decode_recompiles": len(unexpected),
        "decode_failed": len(failures),
        "decode_rejected": rejected[0],
        "decode_mismatches": len(mismatches),
        "decode_hot_swap_ok": bool(swapped["ok"]),
        "decode_admission": args.admission,
        "decode_steps": stats["steps"],
        "decode_avg_occupancy": round(
            tokens / max(stats["steps"], 1), 2),
        "decode_offered_qps": args.qps,
    }
    print(json.dumps(out))

    rc = 0
    if unexpected:
        causes = sorted({e.cause for e in unexpected})
        print(f"FAIL: {len(unexpected)} steady-state recompile(s), "
              f"cause(s) {causes}", file=sys.stderr)
        for e in unexpected:
            print(f"  {e!r} detail={e.detail}", file=sys.stderr)
        rc = 1
    if failures:
        print(f"FAIL: {len(failures)} failed generation(s); first: "
              f"{failures[0]}", file=sys.stderr)
        rc = 1
    if mismatches:
        print(f"FAIL: {len(mismatches)} generation(s) mismatched their "
              f"solo reference (KV aliasing / batching bug); first: "
              f"{mismatches[0]}", file=sys.stderr)
        rc = 1
    if not swapped["ok"]:
        print("FAIL: hot swap never landed", file=sys.stderr)
        rc = 1
    if rc == 0:
        print(f"decode loadgen OK ({args.admission}): "
              f"{out['decode_tokens_per_s']} tok/s, ttft p50 "
              f"{out['ttft_p50_us']:.0f} us / p99 "
              f"{out['ttft_p99_us']:.0f} us, {len(results)} generations, "
              f"zero steady-state recompiles, solo parity exact",
              file=sys.stderr)
    return rc


# fleet deepfm-sparse drill model shape: fields, vocab, emb K, dense D
FLEET_DEEPFM_SHAPE = (6, 2000, 8, 4)


def run_fleet(args):
    """fluid-fleet drill: N replica SUBPROCESSES behind the router.

    Open-loop traffic through FleetRouter.infer with three CI gates:
    (1) zero failed requests (retriable backpressure is counted, not
    failed) and traffic spread over every replica; (2) a mid-run
    COORDINATED swap completes with zero version-skewed responses —
    in router completion order, every old-version response strictly
    precedes every new-version one; (3) zero steady-state recompiles on
    EVERY replica process (each replica's own observatory, summed over
    the fleet via the fleet_stats RPC). JSON carries fleet_qps /
    fleet_p50_us / fleet_p99_us.

    `--fleet-model deepfm-sparse` swaps the tiny MLP for a DeepFM whose
    embedding tables live ONLY in pserver shards started by this
    process — the end-to-end distributed sparse serving proof.

    `--device-ms` (rehearsal rigs): each replica sleeps that long per
    request in place of device time, so a single-core container can
    measure ROUTER/RPC scaling honestly (recorded in the JSON)."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import fleet
    from paddle_tpu_torch.pserver import ParameterServer, PSClient
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_fleet_router import spawn_replicas

    fluid.set_flag("observe", True)

    work = tempfile.mkdtemp(prefix="fleet_loadgen_")
    mdir = args.model_dir or os.path.join(work, "model")
    pservers, ps_client = [], None
    replica_args = []
    F, N_VOCAB, K, D = FLEET_DEEPFM_SHAPE

    def save_model(scale=1.0, seed=7):
        if args.fleet_model == "mlp":
            build_and_save(fluid, np, mdir, scale=scale, seed=seed)
            return
        # DeepFM whose tables exist ONLY in the pserver shards
        from paddle_tpu_torch.models import deepfm
        main_p, startup = fluid.Program(), fluid.Program()
        startup.random_seed = seed
        with fluid.program_guard(main_p, startup), \
                fluid.unique_name.guard():
            _feeds, outs = deepfm.build(
                num_fields=F, sparse_feature_dim=N_VOCAB,
                embedding_size=K, dense_dim=D, hidden_sizes=(16, 16),
                distributed=True)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        if scale != 1.0:
            for v in main_p.global_block().vars.values():
                if isinstance(v, fluid.Parameter):
                    arr = np.asarray(scope.find_var(v.name))
                    scope.set_var(v.name, arr * scale)
        fleet.save_sparse_inference_model(
            mdir, ["dense_input", "sparse_input"], [outs["predict"]],
            exe, main_program=main_p, scope=scope, cap=256)

    if args.fleet_model == "deepfm-sparse":
        pservers = [ParameterServer("127.0.0.1:0").start()
                    for _ in range(2)]
        eps = [s.endpoint for s in pservers]
        ps_client = PSClient(eps)
        for wname, width in (("fm_v", K), ("fm_w", 1)):
            ps_client.init_table(wname, N_VOCAB, width, "float32",
                                 -0.05, 0.05, seed=1337, opt_type="sgd",
                                 lr=0.1, attrs={})
        replica_args = ["--sparse-endpoints", ",".join(eps)]
        if args.sparse_quant:
            replica_args += ["--sparse-quant", args.sparse_quant]
    save_model()

    router = fleet.FleetRouter(fleet.RouterConfig(
        lease_s=1.5, poll_interval_s=0.2)).start()
    workers = []
    try:
        workers = spawn_replicas(
            args.replicas, mdir, router.control_endpoint,
            extra_args=replica_args, pulse=args.replica_pulse,
            device_ms=args.device_ms, lease_s=1.5, cpu=args.cpu)
        return _run_fleet_traffic(args, router, mdir, save_model)
    finally:
        # EVERY exit path (including early failures) reaps the replica
        # subprocesses — an orphaned replica would sit in done.wait()
        # forever, eating the single core under later bench segments
        for w in workers:
            if w.poll() is None:
                w.terminate()
        for w in workers:
            try:
                w.wait(timeout=15)
            except Exception:
                w.kill()
        router.close()
        if ps_client is not None:
            ps_client.close()
        for s in pservers:
            s.stop()


def _run_fleet_traffic(args, router, mdir, save_model):
    """The traffic/gates half of run_fleet (its caller owns ALL cleanup
    in a finally, so any early return here still reaps the fleet)."""
    import numpy as np
    from paddle_tpu_torch import fleet

    F, N_VOCAB, _K, D = FLEET_DEEPFM_SHAPE
    deadline = time.time() + 60
    while len(router.ready_members("m")) < args.replicas:
        if time.time() > deadline:
            print("FAIL: fleet never became ready", file=sys.stderr)
            return 1
        time.sleep(0.1)

    rng = random.Random(0)

    def make_feed():
        n = rng.randint(1, 4)
        if args.fleet_model == "mlp":
            return {"x": np.random.randn(n, 16).astype(np.float32)}
        return {"dense_input":
                np.random.randn(n, D).astype(np.float32),
                "sparse_input":
                np.random.randint(0, N_VOCAB,
                                  size=(n, F)).astype(np.int64)}

    stop = threading.Event()
    lock = threading.Lock()
    failures, rejected = [], [0]
    # (router completion seq, version_key, replica_id, us) — seq is the
    # router-assigned wire-level completion order, so the skew gate
    # cannot be inverted by client-thread scheduling between the call
    # returning and the append landing
    completions = []

    def client(tid):
        r = random.Random(100 + tid)
        lam = args.qps / args.threads
        nxt = time.perf_counter()
        while not stop.is_set():
            nxt += r.expovariate(lam)
            delay = nxt - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            t0 = time.perf_counter()
            try:
                res = router.infer("m", make_feed(),
                                   deadline_ms=args.deadline_ms)
            except Exception as e:      # noqa: BLE001
                with lock:
                    if getattr(e, "retriable", False):
                        rejected[0] += 1
                    else:
                        failures.append(repr(e))
                continue
            with lock:
                completions.append(
                    (res.seq, res.version_key, res.replica_id,
                     (time.perf_counter() - t0) * 1e6))

    swap_state = {"ok": args.no_swap, "error": None, "report": None}

    def swap_drill():
        time.sleep(args.duration / 2)
        try:
            save_model(scale=1.5, seed=11)
            swap_state["report"] = router.swap("m", mdir)
            swap_state["ok"] = True
        except Exception as e:          # noqa: BLE001
            swap_state["error"] = repr(e)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(args.threads)]
    if not args.no_swap:
        threads.append(threading.Thread(target=swap_drill, daemon=True))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(args.duration)
    stop.set()
    for t in threads:
        t.join(timeout=max(20, args.duration))
    wall = time.perf_counter() - t0

    # --- skew gate: old-version completions strictly precede new ones ---
    skew_violations = 0
    keys_in_order = []
    for _, key, _, _ in sorted(completions):
        if key not in keys_in_order:
            keys_in_order.append(key)
    first_seen = {k: i for i, k in enumerate(keys_in_order)}
    last_rank = -1
    for _, key, _, _ in sorted(completions):
        rank = first_seen[key]
        if rank < last_rank:
            skew_violations += 1
        last_rank = max(last_rank, rank)

    # --- per-replica observatory gate + spread ---------------------------
    recompiles, sparse_stats = 0, {}
    served_by = {}
    for _, _, rid, _ in completions:
        served_by[rid] = served_by.get(rid, 0) + 1
    for rid, m in router.members().items():
        try:
            st = fleet.wire.call(
                router._members[rid].pool, "fleet_stats", {},
                deadline_s=10.0)
            recompiles += int(st.get("unexpected_recompiles", 0))
            if st.get("sparse"):
                sparse_stats[rid] = st["sparse"]
        except Exception as e:          # noqa: BLE001
            print(f"WARNING: fleet_stats of {rid} failed: {e!r}",
                  file=sys.stderr)

    lat = sorted(c[3] for c in completions)
    p50, p99 = percentiles(np, lat)
    out = {
        "fleet_qps": round(len(completions) / wall, 1),
        "fleet_p50_us": round(p50, 1),
        "fleet_p99_us": round(p99, 1),
        "fleet_replicas": args.replicas,
        "fleet_requests_ok": len(completions),
        "fleet_failed": len(failures),
        "fleet_rejected": rejected[0],
        "fleet_skew_violations": skew_violations,
        "fleet_versions_seen": len(keys_in_order),
        "fleet_swap_ok": bool(swap_state["ok"]),
        "fleet_recompiles": recompiles,
        "fleet_served_by": served_by,
        "fleet_model": args.fleet_model,
        "fleet_device_ms_simulated": args.device_ms,
        "fleet_offered_qps": args.qps,
    }
    if sparse_stats:
        out["fleet_sparse"] = sparse_stats
    print(json.dumps(out))

    rc = 0
    if failures:
        print(f"FAIL: {len(failures)} failed request(s); first: "
              f"{failures[0]}", file=sys.stderr)
        rc = 1
    if skew_violations:
        print(f"FAIL: {skew_violations} version-SKEWED response(s) — "
              f"an old-version response completed after a new-version "
              f"one (coordinated swap broke its drain contract)",
              file=sys.stderr)
        rc = 1
    if not swap_state["ok"]:
        print(f"FAIL: coordinated swap did not land "
              f"({swap_state['error']})", file=sys.stderr)
        rc = 1
    if recompiles:
        print(f"FAIL: {recompiles} steady-state recompile(s) across the "
              f"fleet (per-replica observatory)", file=sys.stderr)
        rc = 1
    if len(served_by) < args.replicas and not args.no_swap:
        # a replica that served nothing means dispatch never spread —
        # tolerated only if it joined late/died; with none of that in
        # this drill, flag it
        print(f"FAIL: only {sorted(served_by)} of {args.replicas} "
              f"replicas served traffic", file=sys.stderr)
        rc = 1
    if rc == 0:
        print(f"fleet loadgen OK: {out['fleet_qps']} qps over "
              f"{args.replicas} replica(s), p50 {p50:.0f} us / p99 "
              f"{p99:.0f} us, swap skew-free, zero failed requests, "
              f"zero fleet recompiles", file=sys.stderr)
    return rc


def main(argv=None):
    ap = argparse.ArgumentParser(description="torch_serve_loadgen")
    ap.add_argument("--workload", choices=("oneshot", "generate"),
                    default="oneshot",
                    help="oneshot = padded single-step inference drill; "
                    "generate = fluid-decode continuous-batching drill")
    ap.add_argument("--admission", choices=("continuous", "drain"),
                    default="continuous",
                    help="generate workload: slot-admission policy "
                    "(drain = the drain-and-refill A/B baseline)")
    ap.add_argument("--model-dir", help="existing save_inference_model dir "
                    "with a single feed named 'x' (default: build a tiny "
                    "MLP in a tempdir)")
    ap.add_argument("--duration", type=float, default=6.0,
                    help="seconds per phase (default 6; the open-loop "
                    "phase hosts the hot-swap drill at its midpoint)")
    ap.add_argument("--threads", type=int, default=4,
                    help="client threads per phase (default 4)")
    ap.add_argument("--qps", type=float, default=300.0,
                    help="open-loop offered load (default 300)")
    ap.add_argument("--buckets", default="1,2,4,8",
                    help="rows ladder (default 1,2,4,8)")
    ap.add_argument("--emit-trace", metavar="PATH",
                    help="oneshot workload: dump the request-shape trace "
                    "(rows + per-feed dynamic dims with timestamps) in "
                    "the serve.BucketLadder.from_trace format, so real "
                    "traffic can re-derive the ladder offline")
    ap.add_argument("--ladder-from", metavar="PATH",
                    help="oneshot workload: derive the ladder from a "
                    "recorded --emit-trace file (fluid-planner "
                    "auto-sizing) instead of --buckets")
    ap.add_argument("--batch-timeout-ms", type=float, default=2.0)
    ap.add_argument("--max-queue", type=int, default=512)
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline (default none)")
    ap.add_argument("--no-swap", action="store_true",
                    help="skip the mid-run hot-swap drill")
    ap.add_argument("--no-observe", action="store_true",
                    help="oneshot workload: leave the observe flag OFF "
                    "entirely — no metrics, no spans (recompile gating "
                    "still works; compile events record regardless)")
    ap.add_argument("--no-trace", action="store_true",
                    help="oneshot workload: observe stays ON (metrics, "
                    "pulse) but the `trace` flag goes off — no span ids, "
                    "no recording, legacy wire frames. The baseline half "
                    "of a trace-overhead A/B: both halves pay for "
                    "metrics, the delta prices trace context alone")
    ap.add_argument("--trace-ab", type=int, default=0, metavar="ROUNDS",
                    help="oneshot workload: PAIRED in-process trace A/B "
                    "— after warmup, alternate the `trace` flag off/on "
                    "across 2*ROUNDS open-loop phases in THIS process "
                    "and report the paired p50 delta. Pairing inside "
                    "one process controls the between-process variance "
                    "(allocator layout, CPU frequency) that dwarfs a "
                    "tens-of-microseconds effect when separate "
                    "subprocess runs are compared")
    ap.add_argument("--replicas", type=int, default=0, metavar="N",
                    help="fluid-fleet mode: spawn N replica SUBPROCESSES "
                    "behind a FleetRouter and drive the open loop "
                    "through it (QPS scaling + skew-free coordinated "
                    "swap + per-replica recompile gates)")
    ap.add_argument("--fleet-model", choices=("mlp", "deepfm-sparse"),
                    default="mlp",
                    help="fleet mode model: tiny MLP, or a DeepFM whose "
                    "embedding tables live only in pserver shards "
                    "(serve-time distributed sparse lookup)")
    ap.add_argument("--sparse-quant", default=None,
                    help="fleet deepfm-sparse: wire codec for row pulls")
    ap.add_argument("--replica-pulse", action="store_true",
                    help="fleet mode: replicas arm fluid-pulse and the "
                    "router polls real HTTP /readyz")
    ap.add_argument("--device-ms", type=float, default=0.0,
                    help="fleet mode, REHEARSAL RIGS: simulated "
                    "per-request device time per replica (sleep) so a "
                    "single-core container measures router/RPC scaling")
    ap.add_argument("--cpu", action="store_true",
                    help="serve on the host, not the card")
    args = ap.parse_args(argv)

    if args.replicas:
        if args.workload != "oneshot":
            ap.error("--replicas currently drives the oneshot workload")
        return run_fleet(args)

    if args.workload == "generate":
        if args.emit_trace or args.ladder_from:
            # fail at launch, not after an expensive silent run: the
            # shape trace / derived ladder are oneshot-workload features
            # (prefill ladders auto-derive from the decode signature)
            ap.error("--emit-trace/--ladder-from apply to the oneshot "
                     "workload only")
        return run_generate(args)

    if args.trace_ab and (args.no_observe or args.no_trace):
        # the A/B owns the trace flag; a pre-disarmed plane would make
        # both halves identical and the "overhead" a pure-noise reading
        ap.error("--trace-ab flips the trace flag itself; drop "
                 "--no-observe/--no-trace")

    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import observe, serve

    fluid.set_flag("observe", not args.no_observe)
    if args.no_trace:
        fluid.set_flag("trace", False)

    mdir = args.model_dir
    if mdir is None:
        mdir = os.path.join(tempfile.mkdtemp(prefix="serve_loadgen_"),
                            "model")
        build_and_save(fluid, np, mdir)

    if args.ladder_from:
        ladder = serve.BucketLadder.from_trace(
            serve.load_trace(args.ladder_from))
        print(f"ladder derived from {args.ladder_from}: rows "
              f"{list(ladder.rows)} dims {ladder.dims}", file=sys.stderr)
    else:
        ladder = serve.BucketLadder(
            rows=tuple(int(b) for b in args.buckets.split(",")))
    rows_ladder = ladder.rows
    srv = serve.InferenceServer(
        _place(fluid, args),
        serve.ServeConfig(batch_timeout_ms=args.batch_timeout_ms,
                          max_queue=args.max_queue,
                          watch_interval_s=0.2))
    srv.add_model("m", mdir, ladder=ladder)
    feat = srv.registry.get("m").spec["x"][0][1]   # feature width

    # everything the warmup compiled is on the books now; any unexpected
    # event past this line is a steady-state recompile
    baseline_unexpected = len(observe.observatory().unexpected())
    v0 = srv.registry.get("m").version_id

    rng = random.Random(0)
    max_req_rows = min(4, rows_ladder[-1])
    stop = threading.Event()
    failures = []
    rejected = [0]
    fail_lock = threading.Lock()

    # request-shape trace for --emit-trace (list.append is GIL-atomic, so
    # client threads record without a lock; the MLP's only dynamic axis
    # is rows — dims stays empty and from_trace learns the rows ladder)
    shape_trace = []

    def make_feed():
        n = rng.randint(1, max_req_rows)
        if args.emit_trace:
            shape_trace.append(serve.trace_request(rows=n, ts=time.time()))
        return {"x": np.random.randn(n, feat).astype(np.float32)}

    def record_failure(e):
        # retriable = the server exercising backpressure on purpose
        # (queue full / deadline) — counted, but not a failure; anything
        # else is a real serving error and fails the run
        with fail_lock:
            if getattr(e, "retriable", False):
                rejected[0] += 1
            else:
                failures.append(repr(e))

    if args.trace_ab:
        # ---- paired in-process trace A/B (fluid-horizon gate) ----------
        # Alternate the `trace` flag off/on across open-loop phases in
        # THIS process and compare PAIRED p50s. Two separate loadgen
        # subprocesses differ by tens of microseconds from allocator
        # layout and CPU frequency alone — more than the tracing effect
        # under test — while consecutive phases of one warmed process
        # share all of that, so the per-round (on - off) delta isolates
        # the trace cost. Median-of-rounds on both the delta and the
        # baseline keeps one descheduled phase from deciding the gate.
        def ab_phase(seconds: float) -> list:
            lats = []
            lat_lock = threading.Lock()
            stop_at = time.perf_counter() + seconds
            gap = args.threads / args.qps if args.qps > 0 else 0.0

            def client():
                prng = random.Random(threading.get_ident())
                while time.perf_counter() < stop_at:
                    if gap > 0:
                        time.sleep(prng.expovariate(1.0 / gap))
                    t0 = time.perf_counter()
                    try:
                        srv.infer("m", make_feed(),
                                  deadline_ms=args.deadline_ms)
                    except Exception as e:
                        record_failure(e)
                        continue
                    with lat_lock:
                        lats.append((time.perf_counter() - t0) * 1e6)

            ths = [threading.Thread(target=client, daemon=True)
                   for _ in range(args.threads)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=seconds + 15)
            return lats

        def p50(lats: list) -> float:
            lats = sorted(lats)
            return lats[len(lats) // 2] if lats else 0.0

        # Each round is an ABBA block — off,on,on,off (mirrored on odd
        # rounds) — because the process's latency floor WANDERS over a
        # run by more than the effect under test (CPU frequency,
        # allocator growth, neighbor load): a fixed off-then-on order
        # turns any drift into systematic bias, and plain alternation
        # only cancels drift that is linear ACROSS rounds. ABBA cancels
        # linear drift exactly WITHIN each block; both same-arm phases
        # pool their raw samples so each block yields one well-sampled
        # paired p50 delta, and the gate reads the median over blocks.
        rounds = max(1, args.trace_ab)
        phase_s = max(0.5, args.duration / (4 * rounds))
        ab_phase(min(1.0, phase_s))            # settle after warmup
        offs, ons = [], []
        for i in range(rounds):
            seq = ((False, True, True, False) if i % 2 == 0
                   else (True, False, False, True))
            offl, onl = [], []
            for flag in seq:
                fluid.set_flag("trace", flag)
                (onl if flag else offl).extend(ab_phase(phase_s))
            offs.append(p50(offl))
            ons.append(p50(onl))
        by_round = [b - a for a, b in zip(offs, ons)]
        diffs = sorted(by_round)
        off_med = sorted(offs)[rounds // 2]
        on_med = sorted(ons)[rounds // 2]
        diff_med = diffs[rounds // 2]
        overhead = diff_med / off_med if off_med > 0 else -1.0
        print(f"trace A/B: {rounds} ABBA blocks of 4x{phase_s:.1f}s, "
              f"p50 off {off_med:.0f} us, paired delta {diff_med:+.0f} us "
              f"({overhead * 100:+.2f}%); per-round deltas "
              f"{[round(d, 1) for d in by_round]}", file=sys.stderr)
        print(json.dumps({
            "serve_p50_us_trace_off": round(off_med, 1),
            "serve_p50_us_trace_on": round(on_med, 1),
            "trace_p50_delta_us": round(diff_med, 1),
            "trace_overhead_pct": round(overhead * 100.0, 2),
            "trace_ab_rounds": rounds,
            "serve_failed": len(failures),
            "serve_rejected": rejected[0],
        }))
        srv.close()
        return 0 if not failures else 1

    # ---- phase 1: closed loop (saturation / coalescing) ----------------
    closed_lat = []
    closed_lock = threading.Lock()

    def closed_client():
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                srv.infer("m", make_feed(), deadline_ms=args.deadline_ms)
            except Exception as e:
                record_failure(e)
                continue
            with closed_lock:
                closed_lat.append((time.perf_counter() - t0) * 1e6)

    threads = [threading.Thread(target=closed_client, daemon=True)
               for _ in range(args.threads)]
    t_closed = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(args.duration)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    closed_wall = time.perf_counter() - t_closed
    closed_qps = len(closed_lat) / closed_wall

    # ---- phase 2: open loop (Poisson arrivals) + hot-swap drill --------
    stop.clear()
    open_lat = []
    open_lock = threading.Lock()
    inflight = []

    def open_client(tid):
        lam = args.qps / args.threads
        nxt = time.perf_counter()
        while not stop.is_set():
            nxt += rng.expovariate(lam)
            delay = nxt - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            t0 = time.perf_counter()
            try:
                fut = srv.submit("m", make_feed(),
                                 deadline_ms=args.deadline_ms)
            except Exception as e:
                record_failure(e)
                continue

            def done(f, t0=t0):
                try:
                    f.result()
                except Exception as e:
                    record_failure(e)
                else:
                    with open_lock:
                        open_lat.append((time.perf_counter() - t0) * 1e6)

            fut.add_done_callback(done)
            inflight.append(fut)

    swapped = {"ok": args.no_swap}

    def swap_drill():
        time.sleep(args.duration / 2)
        build_and_save(fluid, np, mdir, scale=1.5, seed=11)
        deadline = time.time() + max(10.0, args.duration)
        while time.time() < deadline:
            if srv.registry.get("m").version_id != v0:
                swapped["ok"] = True
                return
            time.sleep(0.1)

    srv.start_watch()
    threads = [threading.Thread(target=open_client, args=(i,), daemon=True)
               for i in range(args.threads)]
    if not args.no_swap:
        threads.append(threading.Thread(target=swap_drill, daemon=True))
    t_open = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(args.duration)
    stop.set()
    for t in threads:
        t.join(timeout=max(15, args.duration))
    for f in inflight:           # drain: callbacks record their latency
        try:
            f.result(timeout=30)
        except Exception:
            pass                 # already recorded by the callback
    open_wall = time.perf_counter() - t_open
    open_qps = len(open_lat) / open_wall

    stats = srv.stats()["models"]["m"]
    unexpected = observe.observatory().unexpected()[baseline_unexpected:]
    recompiles = len(unexpected)
    srv.close()

    if args.emit_trace:
        serve.save_trace(args.emit_trace, shape_trace)
        print(f"wrote {len(shape_trace)} request shapes to "
              f"{args.emit_trace}", file=sys.stderr)

    p50, p99 = percentiles(np, open_lat)
    c50, c99 = percentiles(np, closed_lat)
    out = {
        "serve_p50_us": round(p50, 1),
        "serve_p99_us": round(p99, 1),
        "serve_qps": round(open_qps, 1),
        "serve_recompiles": recompiles,
        "serve_failed": len(failures),
        "serve_rejected": rejected[0],
        "serve_hot_swap_ok": bool(swapped["ok"]),
        "serve_occupancy": stats["avg_occupancy"],
        "serve_padding_waste": stats["avg_padding_waste"],
        "serve_closed_p50_us": round(c50, 1),
        "serve_closed_p99_us": round(c99, 1),
        "serve_closed_qps": round(closed_qps, 1),
        "serve_requests_ok": stats["requests"]["ok"],
        "serve_buckets": list(rows_ladder),
        "serve_threads": args.threads,
        "serve_offered_qps": args.qps,
    }
    print(json.dumps(out))

    rc = 0
    if recompiles:
        causes = sorted({e.cause for e in unexpected})
        print(f"FAIL: {recompiles} steady-state recompile(s), cause(s) "
              f"{causes} — padding_bucket = mis-sized ladder, anything "
              f"else = compile-cache bug", file=sys.stderr)
        for e in unexpected:
            print(f"  {e!r} detail={e.detail}", file=sys.stderr)
        rc = 1
    if failures:
        print(f"FAIL: {len(failures)} failed request(s); first: "
              f"{failures[0]}", file=sys.stderr)
        rc = 1
    if not swapped["ok"]:
        print("FAIL: hot swap never landed (watcher did not pick up the "
              "new model version)", file=sys.stderr)
        rc = 1
    if rc == 0:
        print(f"serve_loadgen OK: p50 {p50:.0f} us, p99 {p99:.0f} us, "
              f"{open_qps:.0f} qps open-loop ({closed_qps:.0f} closed), "
              f"occupancy {stats['avg_occupancy']:.2f}, zero steady-state "
              f"recompiles", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
