#!/usr/bin/env python3
"""Where the port's bf16 recurrent grads part from the JAX rules', on
the CPU.

    JAX_PLATFORMS=cpu python3 tools/torch_rnn_bf16_grads.py

For each case (`lstm` with peepholes; `lstm` reversed with H0, C0 and a
relu candidate; `gru` reversed with H0; `lstmp` with peepholes,
reversed; all at B 6, T 16, H 16 as `tests/test_torch_seq.py` runs
them, and `lstm` with peepholes at B 6, T 100, H 16 and at B 64, T 100,
H 64) it takes one output and its grads under a random bf16 cotangent
from the jitted JAX rule's vjp and from the port's rule under autograd,
and prints, for the output and every input's grad, the share of
elements whose bits differ and the largest distance in bf16 ulps
(ordered bit patterns, so a sign flip near zero counts every value
between). It does so twice: with the
port's rules as they are, and with torch's own grads for bf16 tanh and
sigmoid put back (torch's tanh grad rounds g (1 - y^2) once; the
sigmoid grad as (g y)(1 - y)), the rounding the port had before its
`_tanh` and `_sigmoid` took the JAX transposes' order. For each gate
bias it also prints both packages' largest distance in ulps from the
float64 sum of the JAX rule's own terms (its Input grad summed over
batch and time). CPU numbers, not a device's. The last line printed is
one JSON summary.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _ordered(bits):
    b = bits.astype(np.int32)
    return np.where(b & 0x8000, -(b & 0x7FFF), b)


def _bf16_bits(a):
    import torch
    return torch.from_numpy(np.array(a, np.float32)).bfloat16().view(
        torch.int16).numpy().view(np.uint16)


def compare(ref, got):
    """(share of elements whose bits differ, largest distance in ulps)."""
    ra, ga = _ordered(_bf16_bits(ref)), _ordered(_bf16_bits(got))
    return float((ra != ga).mean()), int(np.abs(ra - ga).max())


def cases():
    for name, op, attrs, B, T, H in (
            ("lstm peepholes", "lstm", {"use_peepholes": True}, 6, 16, 16),
            ("lstm reverse H0 C0 relu", "lstm",
             {"is_reverse": True, "candidate_activation": "relu"}, 6, 16, 16),
            ("gru reverse H0", "gru", {"is_reverse": True}, 6, 16, 16),
            ("lstmp peepholes reverse", "lstmp",
             {"use_peepholes": True, "is_reverse": True}, 6, 16, 16),
            ("lstm peepholes T 100", "lstm", {"use_peepholes": True},
             6, 100, 16),
            ("lstm peepholes B 64 T 100 H 64", "lstm",
             {"use_peepholes": True}, 64, 100, 64)):
        rng = np.random.RandomState(42)
        lens = rng.randint(1, T + 1, B).astype(np.int32)
        lens[:2] = (1, T)
        G = (3 if op == "gru" else 4) * H
        ins = {"Input": rng.randn(B, T, G),
               "Weight": rng.randn(8 if op == "lstmp" else H, G) * 0.3}
        peep = attrs.get("use_peepholes", False)
        ins["Bias"] = rng.randn(1, 7 * H if peep else G) * 0.3
        if op == "lstmp":
            ins["ProjWeight"] = rng.randn(H, 8) * 0.3
        if "H0" in name:
            ins["H0"] = rng.randn(B, H) * 0.5
        if "C0" in name:
            ins["C0"] = rng.randn(B, H)
        yield name, op, attrs, {k: v.astype(np.float32)
                                for k, v in ins.items()}, lens


@contextlib.contextmanager
def torch_grads():
    """The port's `lstm`, `gru` and `lstmp` with torch's bf16 tanh grad
    and the (g y)(1 - y) sigmoid grad."""
    import torch
    from paddle_tpu_torch.ops import rnn

    class Sigmoid(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            y = 1.0 / (1.0 + torch.exp(-x))
            ctx.save_for_backward(y)
            return y

        @staticmethod
        def backward(ctx, g):
            y, = ctx.saved_tensors
            return g * y * (1.0 - y)

    saved = dict(rnn._ACTS)
    rnn._ACTS.update(tanh=torch.tanh, sigmoid=Sigmoid.apply)
    try:
        yield
    finally:
        rnn._ACTS.clear()
        rnn._ACTS.update(saved)


def run_case(op, attrs, ins, lens):
    import jax
    import jax.numpy as jnp
    import torch
    import paddle_tpu  # noqa: F401  (registers the JAX rules)
    import paddle_tpu_torch  # noqa: F401
    from paddle_tpu.core import registry as jregistry
    from paddle_tpu_torch.core import registry as tregistry
    out_slot = "Projection" if op == "lstmp" else "Hidden"
    names = sorted(ins)
    rule = jregistry.get_op_def(op).lower

    def f(*vals):
        return rule(jregistry.LoweringContext(attrs),
                    **dict(zip(names, vals)),
                    SeqLen=jnp.asarray(lens))[out_slot]

    jins = [jnp.asarray(ins[n], jnp.bfloat16) for n in names]
    out, vjp = jax.vjp(jax.jit(f), *jins)
    cot = np.random.RandomState(43).randn(*out.shape).astype(np.float32)
    ref = {n: np.asarray(g.astype(jnp.float32)) for n, g in
           zip(names, vjp(jnp.asarray(cot, jnp.bfloat16)))}

    def port():
        leaves = [torch.from_numpy(ins[n]).bfloat16().requires_grad_(True)
                  for n in names]
        y = tregistry.get_op_def(op).lower(
            tregistry.LoweringContext(attrs, "cpu"),
            **dict(zip(names, leaves)), SeqLen=torch.from_numpy(lens))
        grads = torch.autograd.grad(y[out_slot], leaves,
                                    torch.from_numpy(cot).bfloat16())
        out = {n: g.float().numpy() for n, g in zip(names, grads)}
        out["(output)"] = y[out_slot].detach().float().numpy()
        return out

    got = port()
    with torch_grads():
        old = port()
    ref["(output)"] = np.asarray(out.astype(jnp.float32))
    G = ins["Input"].shape[-1]
    exact = ref["Input"].astype(np.float64).sum((0, 1))
    row = {"inputs": {}, "gate_bias_ulps_from_exact": {
        "port": compare(exact, got["Bias"].reshape(-1)[:G])[1],
        "jax": compare(exact, ref["Bias"].reshape(-1)[:G])[1]}}
    for n in ["(output)"] + names:
        row["inputs"][n] = {"port": compare(ref[n], got[n]),
                            "torch_grads": compare(ref[n], old[n])}
    return row


def main() -> int:
    summary = {}
    for name, op, attrs, ins, lens in cases():
        row = summary[name] = run_case(op, attrs, ins, lens)
        print(f"{name}:")
        for n, r in row["inputs"].items():
            (s, u), (so, uo) = r["port"], r["torch_grads"]
            print(f"  {n:10s} port {s:7.2%} differ, <= {u} ulp; with "
                  f"torch's tanh / sigmoid grads {so:7.2%}, <= {uo} ulp")
        b = row["gate_bias_ulps_from_exact"]
        print(f"  gate bias from the float64 sum of the JAX terms: port "
              f"<= {b['port']} ulp, JAX <= {b['jax']} ulp", flush=True)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
