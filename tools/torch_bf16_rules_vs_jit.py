#!/usr/bin/env python3
"""How far the port's bf16 `softmax` and windowed average `pool2d` lie
from the JAX package's jitted Executor, beside the one-rounding rules
they replaced and the JAX rules called op by op. On the CPU.

    JAX_PLATFORMS=cpu python3 tools/torch_bf16_rules_vs_jit.py

Each case builds a one-op Program in both packages over a bf16 `data`
var (`append_batch_size=False`), runs it with the JAX package's
`Executor(CPUPlace())` (which jits the step) and the port's
`Executor(CPUPlace())`, and compares every output against the jitted
one: the JAX rule called eagerly, op by op (`registry.get_op_def(op)
.lower`), the port, and the rule the port had before its bf16 repair
(`torch.softmax` in bf16; `F.avg_pool2d` on a contiguous bf16 NCHW
copy), each as the share of elements whose bits differ and the largest
distance in bf16 ulps. The cases are ROADMAP's two inputs (softmax of
X bf16 [8, 64] from RandomState(0).randn; pool2d of X bf16 NHWC
[2, 8, 8, 4], ksize 3, stride 2, pad 1, exclusive), softmax of wider
rows, and rows of causally masked attention scores. CPU numbers, not a
device's.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

POOL = dict(pool_size=3, pool_type="avg", pool_stride=2, pool_padding=1,
            exclusive=True, data_format="NHWC")


def _ordered(bits):
    """bf16 bit patterns (uint16) as integers in the order of their
    values, so a difference counts ulps."""
    b = bits.astype(np.int32)
    return np.where(b & 0x8000, -(b & 0x7FFF), b)


def compare(ref, got):
    """(share of elements whose bits differ, largest distance in ulps)."""
    ra, ga = _ordered(ref), _ordered(got)
    return float((ra != ga).mean()), int(np.abs(ra - ga).max())


def cases():
    x = np.random.RandomState(0).randn(8, 64).astype(np.float32)
    yield "softmax [8, 64] (ROADMAP)", "softmax", x
    yield ("pool2d [2, 8, 8, 4] NHWC k3 s2 p1 exclusive (ROADMAP)", "pool2d",
           np.random.RandomState(0).randn(2, 8, 8, 4).astype(np.float32))
    for shape, scale in (((4, 256), 3.0), ((64, 256), 1.0), ((16, 1000), 3.0)):
        yield (f"softmax {list(shape)} x {scale}", "softmax",
               np.random.RandomState(1).randn(*shape).astype(np.float32)
               * scale)
    t = 256
    scores = np.random.RandomState(2).randn(4, t, t).astype(np.float32)
    yield ("softmax [4, 256, 256] causal scores", "softmax",
           scores + np.triu(np.full((t, t), -1e9, np.float32), 1))


def main() -> int:
    import jax
    import jax.numpy as jnp
    import torch
    import torch.nn.functional as F
    import paddle_tpu as fluid
    import paddle_tpu_torch as ptt
    from paddle_tpu.core import registry as jregistry

    def run(pkg, place, op, x):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            v = pkg.layers.data("x", shape=list(x.shape), dtype="bfloat16",
                                append_batch_size=False)
            out = pkg.layers.softmax(v) if op == "softmax" \
                else pkg.layers.pool2d(v, **POOL)
        exe = pkg.Executor(place)
        exe.run(startup)
        y, = exe.run(main, feed={"x": x}, fetch_list=[out],
                     return_numpy=False)
        return y

    def bits(t):
        if isinstance(t, torch.Tensor):
            return t.contiguous().view(torch.int16).numpy().view(np.uint16)
        return np.asarray(t).view(np.uint16)

    print(f"jax {jax.__version__}, torch {torch.__version__}; each column: "
          f"share of elements whose bits differ from the jitted JAX "
          f"Executor, largest distance in bf16 ulps")
    for name, op, x32 in cases():
        xj = jnp.asarray(x32).astype(jnp.bfloat16)
        xt = torch.from_numpy(x32).to(torch.bfloat16)
        jit = bits(run(fluid, fluid.CPUPlace(), op, np.asarray(xj)))
        attrs = {"axis": -1} if op == "softmax" else {
            "pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
            "paddings": [1, 1], "exclusive": True, "data_format": "NHWC"}
        eager = bits(jregistry.get_op_def(op).lower(
            jregistry.LoweringContext(attrs), X=xj)["Out"])
        port = bits(run(ptt, ptt.CPUPlace(), op, xt))
        if op == "softmax":
            before = torch.softmax(xt, -1)
        else:
            before = F.avg_pool2d(xt.permute(0, 3, 1, 2).contiguous(), 3, 2, 1,
                                  count_include_pad=False).permute(0, 2, 3, 1)
        row = {"JAX rule eager": compare(jit, eager),
               "port": compare(jit, port),
               "port before the repair": compare(jit, bits(before))}
        print(f"{name}: " + "; ".join(f"{k} {v[0]:.4f} (max {v[1]} ulp)"
                                       for k, v in row.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
