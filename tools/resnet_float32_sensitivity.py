#!/usr/bin/env python3
"""How far one float32 rounding moves ResNet-50 training in the JAX
package, the reference, on the CPU: the floor under any parity test
that holds another implementation against it.

    JAX_PLATFORMS=cpu python3 tools/resnet_float32_sensitivity.py \\
        [--size 32] [--batch 4] [--classes 100] [--lr 1e-3] [--steps 3]

Builds `paddle_tpu.models.resnet.build` (depth 50, NHWC) with
Momentum(lr, 0.9), runs its startup, and trains twice from that state
on one batch (seed 21): as it is, and with the stem conv's filter scaled
by (1 + 1e-7), about one float32 rounding. Prints, a step each, the
relative change of the loss; after the first step, the relative L2
change of every velocity (the step's grad: median and largest of the
161); after the last, the largest change of a running mean or variance
over 1e-4 + 1e-3 |value|. CPU numbers, not a device's.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--classes", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    import paddle_tpu as fluid
    from paddle_tpu.models import resnet

    main_prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_prog, startup), fluid.unique_name.guard():
        _, fetches = resnet.build(class_dim=args.classes, depth=50,
                                  image_shape=(3, args.size, args.size),
                                  data_format="NHWC")
        fluid.optimizer.Momentum(learning_rate=args.lr,
                                 momentum=0.9).minimize(fetches["loss"])
    rng = np.random.RandomState(21)
    feed = {"image": rng.rand(args.batch, args.size, args.size,
                              3).astype(np.float32),
            "label": rng.randint(0, args.classes,
                                 (args.batch, 1)).astype(np.int64)}
    stem = next(op.inputs["Filter"][0] for op in main_prog.global_block().ops
                if op.type == "conv2d")
    stats = {op.inputs[s][0] for op in main_prog.global_block().ops
             if op.type == "batch_norm" for s in ("Mean", "Variance")}
    runs = []
    for scale in (1.0, 1.0 + 1e-7):
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        w = np.asarray(scope.find_var(stem))
        scope.set_var(stem, (w * np.float32(scale)).astype(np.float32))
        losses, first = [], None
        for step in range(args.steps):
            out, = exe.run(main_prog, feed=feed, fetch_list=[fetches["loss"]],
                           scope=scope)
            losses.append(float(np.asarray(out).reshape(-1)[0]))
            if step == 0:
                first = {n: np.asarray(scope.find_var(n))
                         for n in scope.local_var_names() if "velocity" in n}
        runs.append((losses, first,
                     {n: np.asarray(scope.find_var(n)) for n in stats}))
    (l0, v0, s0), (l1, v1, s1) = runs
    grads = sorted(float(np.linalg.norm(v1[n] - v0[n])
                         / max(np.linalg.norm(v0[n]), 1e-30)) for n in v0)
    stat = max(float((np.abs(s1[n] - s0[n])
                      / (1e-4 + 1e-3 * np.abs(s0[n]))).max()) for n in s0)
    print(f"ResNet-50 {args.size}x{args.size} NHWC, batch {args.batch}, "
          f"{args.classes} classes, Momentum({args.lr}, 0.9), CPU")
    for i, (a, b) in enumerate(zip(l0, l1)):
        print(f"  step {i + 1}: loss {a:.6f} -> {b:.6f}, relative change "
              f"{abs(b - a) / abs(a):.3g}")
    print(f"  grads after step 1, relative L2 change over {len(grads)}: "
          f"median {grads[len(grads) // 2]:.3g}, largest {grads[-1]:.3g}")
    print(f"  running stats after step {args.steps}: largest change "
          f"{stat:.3g} x (1e-4 + 1e-3 |value|)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
