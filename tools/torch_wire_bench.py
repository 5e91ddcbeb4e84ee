#!/usr/bin/env python
"""fluid-wire bench for paddle_tpu_torch: bytes/step + step-time A/B for
the quantized parameter-server wire (raw vs `comm_quant`), printed as ONE
JSON line with the keys of tools/wire_bench.py.

It runs on the host: the wire and the servers are numpy, and the
trainer's step runs through `Executor(CPUPlace())`, so no card is needed
or touched (the card's parameter-server job is chip_smoke.py's phase
7q). Run: `python3 tools/torch_wire_bench.py`.

Runs the process-based sync-PS dense push path (the RunSyncLoop analog:
push_grads_sync + sync_apply barrier every batch) twice from identical
seeded state — once with raw float32 payloads, once with the int8
per-chunk codec + client-side error feedback — and reads the wire byte
counters (`pserver_wire_bytes_raw` / `_encoded`) the client records per
command. A sparse leg measures the embedding-row pull/push compression
(the DeepFM millions-of-users shape).

Keys: wire_bytes_per_step_raw, wire_bytes_per_step_encoded,
wire_compression_x, wire_sync_ps_step_ms_raw, wire_sync_ps_step_ms_quant,
wire_sparse_compression_x, wire_quant_loss_delta (mean |loss_q - loss_raw|
over the run — the convergence-neutrality readout).

Loopback TCP is latency- not bandwidth-bound, so the step-time A/B here
mostly prices the codec's host cost; the bytes/step ratio is the
transferable result (a NIC-bound deployment converts bytes directly into
wall time).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

STEPS = 12
WARMUP = 2


def _build(fluid, layers, seed=11):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = layers.data(name="x", shape=[64], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="int64")
        h = layers.fc(input=x, size=256, act="relu")
        h = layers.fc(input=h, size=256, act="relu")
        logits = layers.fc(input=h, size=2, act=None)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    main.random_seed = startup.random_seed = seed
    return main, startup, loss


def run_sync_ps(fluid, layers, np, codec):
    """One sync-PS run; returns (per-step raw bytes, per-step encoded
    bytes, mean step ms, losses) for the push_grads_sync command."""
    from paddle_tpu_torch import observe
    from paddle_tpu_torch.pserver import ParameterServer, SyncPSTrainer
    from paddle_tpu_torch.wire import ENCODED_BYTES_METRIC, RAW_BYTES_METRIC

    observe.reset_all()
    srv = ParameterServer("127.0.0.1:0", trainers=1).start()
    try:
        main, startup, loss = _build(fluid, layers)
        cfg = fluid.DistributeTranspilerConfig()
        cfg.runtime = "pserver"
        cfg.comm_quant = codec
        t = fluid.DistributeTranspiler(cfg)
        t.transpile(trainer_id=0, program=main, pservers=srv.endpoint,
                    trainers=1, sync_mode=True)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        tr = SyncPSTrainer(t, exe, scope=scope)
        tr.init_params()

        rng = np.random.RandomState(5)
        w_true = rng.randn(64, 2).astype(np.float32)

        def batch(n=64):
            xs = rng.randn(n, 64).astype(np.float32)
            ys = (xs @ w_true).argmax(1).astype(np.int64).reshape(n, 1)
            return {"x": xs, "y": ys}

        losses = []
        for _ in range(WARMUP):
            tr.step(batch(), fetch_list=[loss])
        reg = observe.default_registry()

        def _bytes():
            raw = reg.get(RAW_BYTES_METRIC)
            enc = reg.get(ENCODED_BYTES_METRIC)
            return (raw.value(cmd="push_grads_sync") if raw else 0.0,
                    enc.value(cmd="push_grads_sync") if enc else 0.0)

        raw0, enc0 = _bytes()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            l, = tr.step(batch(), fetch_list=[loss])
            losses.append(float(np.asarray(l).reshape(-1)[0]))
        wall = time.perf_counter() - t0
        raw1, enc1 = _bytes()
        tr.close()
        return ((raw1 - raw0) / STEPS, (enc1 - enc0) / STEPS,
                wall / STEPS * 1e3, losses)
    finally:
        srv.stop()


def run_sparse(fluid, np):
    """Embedding-row pull/push compression through the quantized client."""
    from paddle_tpu_torch import observe
    from paddle_tpu_torch.pserver import ParameterServer, PSClient
    from paddle_tpu_torch.wire import ENCODED_BYTES_METRIC, RAW_BYTES_METRIC

    observe.reset_all()
    srv = ParameterServer("127.0.0.1:0").start()
    try:
        c = PSClient([srv.endpoint], comm_quant="int8")
        c.init_table("emb", rows=4000, width=16, dtype="float32",
                     init_low=-0.05, init_high=0.05, seed=3,
                     opt_type="sgd", lr=0.1, attrs={})
        rng = np.random.RandomState(9)
        for _ in range(8):
            ids = np.unique(rng.randint(0, 4000, 512).astype(np.int64))
            rows = c.prefetch_rows("emb", ids)
            c.push_sparse_grad("emb", ids,
                               rng.randn(*rows.shape).astype(np.float32)
                               * 0.01)
        reg = observe.default_registry()
        raw = enc = 0.0
        for cmd in ("prefetch", "push_sparse_grad"):
            raw += reg.get(RAW_BYTES_METRIC).value(cmd=cmd)
            enc += reg.get(ENCODED_BYTES_METRIC).value(cmd=cmd)
        c.close()
        return raw / enc if enc else 0.0
    finally:
        srv.stop()


def main():
    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers

    torch.set_num_threads(1)    # a tiny net: one thread is fastest

    fluid.set_flag("observe", True)

    raw_b, raw_enc_b, ms_raw, losses_raw = run_sync_ps(
        fluid, layers, np, codec=None)
    q_raw_b, q_enc_b, ms_quant, losses_q = run_sync_ps(
        fluid, layers, np, codec="int8")
    sparse_x = run_sparse(fluid, np)

    # the raw run must account raw==encoded (codec off is byte-identity)
    assert abs(raw_b - raw_enc_b) < 1e-6, (raw_b, raw_enc_b)
    rec = {
        "wire_bytes_per_step_raw": round(q_raw_b, 1),
        "wire_bytes_per_step_encoded": round(q_enc_b, 1),
        "wire_compression_x": round(q_raw_b / q_enc_b, 2) if q_enc_b else 0.0,
        "wire_sync_ps_step_ms_raw": round(ms_raw, 3),
        "wire_sync_ps_step_ms_quant": round(ms_quant, 3),
        "wire_sparse_compression_x": round(sparse_x, 2),
        "wire_quant_loss_delta": round(float(np.mean(np.abs(
            np.asarray(losses_q) - np.asarray(losses_raw)))), 5),
    }
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
