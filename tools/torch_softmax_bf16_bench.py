#!/usr/bin/env python3
"""The port's bf16 `softmax` rule on one card, beside the one-rounding
rule it replaced (torch's bf16 softmax), at train-base-amp's unfused
attention weights.

    python3 tools/torch_softmax_bf16_bench.py [--out FILE]

Scores of bf16 [64, 8, 256, 256] (train-base-amp's batch, heads and
sequence length: the input of each of the 18 attention softmaxes of a
step of `transformer.build(fused_attention=False)` under
`Executor(amp=True)`), drawn from a seeded normal on the card, plus the
causal mask (-1e9 above the diagonal) as the unfused path adds it. Times
(median CUDA-event time on a cold L2, chip_smoke.time_ms) the forward of
the port's rule (`ops/math.py::_softmax`: exp, a float32 sum rounded to
bf16, the quotient, each in bf16, as the JAX rule rounds, the max
taking no grad, and `_HalfSoftmax`'s backward in the order of the JAX
rule's transpose), of the same chain with autograd's backward (the rule
before its backward took that order), of the chain with a grad through
the max too (the rule as it first was), and of `torch.softmax` in bf16,
then a forward and backward of each; gives the bound of one read of the scores and one write of the
weights (the backward: two reads and one write) at 3.35 TB/s; and counts
the elements where the rule's result, and its grad, on the card differ
from its result on the host (CPU) on the same scores, and where its
result differs from `torch.softmax`'s. Prints the card's name and power limit, one JSON line
per case, and with --out writes them to FILE. Needs a card; exits 2
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (PEAK_BYTES, SEED, TRAIN_AMP_BATCH,  # noqa: E402
                        _l2_flusher, time_ms)

SHAPE = (TRAIN_AMP_BATCH, 8, 256, 256)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_softmax_bf16_bench: no CUDA device visible",
              file=sys.stderr)
        return 2
    from paddle_tpu_torch.core import registry
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rule = registry.get_op_def("softmax")

    def port(x):
        ctx = registry.LoweringContext({"axis": -1}, x.device.type)
        return rule.lower(ctx, x)["Out"]

    def torch_softmax(x):
        return torch.softmax(x, -1)

    def port_autograd(x):
        """The rule before its backward took the JAX rule's order."""
        e = torch.exp(x - x.detach().amax(-1, keepdim=True))
        return e / e.sum(-1, keepdim=True, dtype=torch.float32).to(x.dtype)

    def port_max_grad(x):
        """The rule as it was before its max stopped taking a grad."""
        e = torch.exp(x - x.amax(-1, keepdim=True))
        return e / e.sum(-1, keepdim=True, dtype=torch.float32).to(x.dtype)

    g = torch.Generator(device="cuda").manual_seed(SEED)
    t = SHAPE[-1]
    mask = torch.triu(torch.full((t, t), -1e9, device="cuda"), 1)
    x = (torch.randn(SHAPE, device="cuda", generator=g) + mask).to(
        torch.bfloat16)
    dy = torch.randn(SHAPE, device="cuda", generator=g).to(torch.bfloat16)
    flush = _l2_flusher(torch)
    nbytes = x.numel() * x.element_size()
    on_host = port(x.cpu())
    on_card = port(x)

    def grad(x, dy):
        xg = x.detach().requires_grad_(True)
        return torch.autograd.grad(port(xg), xg, dy)[0]

    grad_host, grad_card = grad(x.cpu(), dy.cpu()), grad(x, dy)
    rows = []
    for name, fn in (("port rule", port),
                     ("port rule, autograd's backward", port_autograd),
                     ("port rule, max with a grad", port_max_grad),
                     ("torch.softmax", torch_softmax)):
        xg = x.detach().requires_grad_(True)

        def fwd_bwd(fn=fn, xg=xg):
            torch.autograd.grad(fn(xg), xg, dy)

        rows.append(dict(
            rule=name, shape=list(SHAPE), dtype="bfloat16",
            forward_ms=time_ms(torch, lambda fn=fn: fn(x), flush),
            forward_bound_ms=2 * nbytes / PEAK_BYTES * 1e3,
            forward_backward_ms=time_ms(torch, fwd_bwd, flush),
            forward_backward_bound_ms=5 * nbytes / PEAK_BYTES * 1e3))
    rows.append(dict(
        check="port rule on the card against the host and torch.softmax",
        elements=x.numel(),
        differ_from_host=int((on_card.cpu() != on_host).sum()),
        grad_differ_from_host=int((grad_card.cpu() != grad_host).sum()),
        differ_from_torch_softmax=int((on_card != torch_softmax(x)).sum())))
    for r in rows:
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
