#!/usr/bin/env python
"""torch_op_profile: the per-op cost table of a model, next to measured
step time, over paddle_tpu_torch.

The port's counterpart of ``tools/op_profile.py``. Static per-op
FLOPs/bytes/memory from `analysis.cost_model`, attributed against the
measured `device_compute` phase of a short observed run (the step log,
``observe/steplog``):

    python tools/torch_op_profile.py --model transformer --topk 15
    python tools/torch_op_profile.py --model mlp --json --cpu
    python tools/torch_op_profile.py --measured-check   # exit 1 if the
        # products the static model counts disagree with torch's FLOP
        # counter over one run (analysis.measured_flops)

Models: mlp (tiny fc stack), transformer (book transformer, scaled-down
config by default; --full-size for the base config: vocab 30000, seq
256, 6 layers, d_model 512), resnet (ResNet-18-ish; conv rules). The
est_time column is `flops_share x measured device_compute`. On a card
`device_compute` is the host wall of the eager block, which queues the
kernels without waiting for them (``observe/steplog``): there it is a
lower bound of the card's time, not the card's time.

`--measured-check` holds the static count of the products (`mul`,
`matmul`, `conv2d`, `depthwise_conv2d` and their grad ops) against
`analysis.measured_flops`, which sees the products only. A grad op
recomputes its forward under autograd, so each product grad op adds its
forward's FLOPs to what the counter sees. Fused attention runs the
hand-written kernels on a card (which the counter does not see) and a
chain of products on the host: no model here takes it (the transformer
is built unfused, as ``tools/op_profile.py`` builds it).

Runs on `CUDAPlace(0)` unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PRODUCT_OPS = ("mul", "matmul", "conv2d", "depthwise_conv2d")


def build_mlp(ptt, layers, batch):
    import numpy as np
    x = layers.data(name="x", shape=[64], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="int64")
    h = layers.fc(input=x, size=128, act="relu")
    h = layers.fc(input=h, size=64, act="relu")
    pred = layers.fc(input=h, size=10, act="softmax")
    loss = layers.mean(layers.cross_entropy(input=pred, label=y))
    ptt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    feed = {"x": np.random.RandomState(0).randn(batch, 64)
            .astype(np.float32),
            "y": np.random.RandomState(1).randint(0, 10, (batch, 1))
            .astype(np.int64)}
    return loss, feed


def build_transformer(ptt, layers, batch, full_size=False):
    import numpy as np

    from paddle_tpu_torch import models
    kw = {} if full_size else dict(
        src_vocab_size=1000, trg_vocab_size=1000, seq_len=32, n_layer=2,
        n_head=2, d_model=64, d_inner=128)
    _, fetches = models.transformer.build(
        dropout_rate=0.0, is_test=True, fused_attention=False, **kw)
    seq = 256 if full_size else 32
    vocab = 30000 if full_size else 1000
    rng = np.random.RandomState(0)
    feed = {k: rng.randint(1, vocab - 1, (batch, seq)).astype(np.int64)
            for k in ("src_word", "trg_word", "lbl_word")}
    return fetches["loss"], feed


def build_resnet(ptt, layers, batch):
    import numpy as np

    from paddle_tpu_torch import models
    _, fetches = models.resnet.build(class_dim=10, depth=18,
                                     data_format="NHWC")
    loss = fetches["loss"]
    ptt.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    rng = np.random.RandomState(0)
    feed = {"image": rng.rand(batch, 224, 224, 3).astype(np.float32),
            "label": rng.randint(0, 10, (batch, 1)).astype(np.int32)}
    return loss, feed


def counted_products(program, report) -> float:
    """The FLOPs `analysis.measured_flops` should count in one run of
    `program`: the static products (PRODUCT_OPS and their grad ops) plus
    the forward each product grad op recomputes under autograd."""
    fwd = {(c.block_idx, c.op_idx): c.flops for c in report.ops
           if c.op_type in PRODUCT_OPS}
    by_out = {}
    for (bi, oi), flops in fwd.items():
        for n in program.blocks[bi].ops[oi].output_arg_names:
            by_out[n] = flops
    total = sum(fwd.values())
    for c in report.ops:
        base = c.op_type[:-len("_grad")] if c.op_type.endswith("_grad") \
            else None
        if base not in PRODUCT_OPS:
            continue
        total += c.flops
        op = program.blocks[c.block_idx].ops[c.op_idx]
        og = op.inputs.get("OutGrad", [None])[0]
        total += by_out.get(og.split("@GRAD")[0], 0.0) if og else 0.0
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="per-op FLOPs/bytes cost table + measured step share")
    ap.add_argument("--model", choices=("mlp", "transformer", "resnet"),
                    default="transformer")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3,
                    help="observed steps for the measured time column")
    ap.add_argument("--topk", type=int, default=15)
    ap.add_argument("--full-size", action="store_true",
                    help="transformer: the base config")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable compact summary on stdout")
    ap.add_argument("--measured-check", action="store_true",
                    help="compare the static products against torch's FLOP "
                         "counter over one run; exit 1 on a disagreement")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host (default: CUDAPlace(0))")
    args = ap.parse_args(argv)

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import analysis, layers, observe
    from paddle_tpu_torch.analysis import cost_model

    main_p, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main_p, startup), ptt.unique_name.guard():
        loss, feed = {
            "mlp": build_mlp,
            "transformer": lambda *a: build_transformer(
                *a, full_size=args.full_size),
            "resnet": build_resnet,
        }[args.model](ptt, layers, args.batch)

    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace() if args.cpu else ptt.CUDAPlace(0))
    exe.run(startup, scope=scope)

    ptt.set_flag("observe", True)
    prepared = exe.prepare(main_p, fetch_list=[loss], scope=scope)
    for _ in range(max(args.steps, 1)):
        prepared.run(dict(feed))
    summ = observe.get_steplog().phase_summary()
    # device_compute per steady step (the binding step's plan build rides
    # in its own `bind` phase; drop that step when more than one ran)
    steps = [s for s in observe.get_steplog().recent(64)
             if "bind" not in s.phases]
    dev_s = (sum(s.phases.get("device_compute", 0.0) for s in steps)
             / len(steps)) if steps else 0.0

    report = cost_model.estimate_cost(
        main_p, {k: v.shape for k, v in feed.items()})

    measured = expected = None
    if args.measured_check or args.json:
        expected = counted_products(main_p, report)
        try:
            measured = analysis.measured_flops(exe, scope, feed,
                                               program=main_p)
        except Exception as e:
            print(f"WARNING: measured cross-check failed ({e!r})",
                  file=sys.stderr)

    if args.json:
        out = report.as_dict(args.topk)
        out["model"] = args.model
        out["batch"] = args.batch
        out["measured_device_compute_us"] = round(dev_s * 1e6, 2)
        out["observed_steps"] = summ["steps"]
        out["static_product_flops"] = expected
        if measured:
            out["measured_flops"] = measured
            out["measured_agreement"] = round(expected / measured, 6)
        print(json.dumps(out, sort_keys=True))
    else:
        print(f"model={args.model} batch={args.batch} "
              f"(measured device_compute "
              f"{dev_s * 1e6:.0f} us/step over {len(steps)} steady steps)")
        print(report.table(args.topk, step_time_s=dev_s or None))

    if args.measured_check:
        if not measured:
            print("MEASURED-CHECK FAILED: no FLOP count available",
                  file=sys.stderr)
            return 1
        # both are sums of integer products: equal up to float rounding
        ok = abs(expected - measured) <= 1e-9 * measured
        print(f"measured-check: static products={expected:.6g} "
              f"measured={measured:.6g} ratio={expected / measured:.6f} "
              f"{'OK' if ok else 'DISAGREE'}", file=sys.stderr)
        if not ok:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
