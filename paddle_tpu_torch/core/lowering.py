"""Eager block interpreter.

Mirror of ``paddle_tpu/core/lowering.py`` (forward half). The JAX package
traces a whole block into one XLA computation; here the executor runs the
block's ops one by one on the place's device, each through its PyTorch
rule, against a name -> tensor env (the reference's own
`for op in ops: op->Run(...)` loop, executor.cc:321-366). Grad ops are
not ported yet.

Random ops get a `torch.Generator` on the op's device, seeded from
(program seed, run counter, op index): the JAX package's
`fold_in(fold_in(key(seed), counter), op index)` derivation. The two
generators draw different numbers from the same seed, so parity tests
hand both packages the same parameters instead of the same seed.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from . import ir, registry
from .registry import EMPTY_VAR, LoweringContext

_MASK63 = (1 << 63) - 1


def op_seed(seed: int, counter: int, op_idx: int) -> int:
    """Deterministic per-(program seed, run, op) generator seed."""
    s = (int(seed) * 0x9E3779B97F4A7C15 + int(counter)) & _MASK63
    return (s * 0xBF58476D1CE4E5B9 + int(op_idx)) & _MASK63


def run_block(program: ir.Program, block_idx: int, env: Dict[str, Any],
              device, seed: int = 0, counter: int = 0,
              check_nan_inf: bool = False) -> Dict[str, Any]:
    """Run every op of `block_idx` on `env` (name -> tensor), mutating
    and returning it."""
    device = torch.device(device)
    for op_idx, op in enumerate(program.blocks[block_idx].ops):
        _run_op(op, op_idx, env, device, seed, counter, check_nan_inf)
    return env


def _run_op(op: ir.Operator, op_idx: int, env: Dict[str, Any], device,
            seed: int, counter: int, check_nan_inf: bool):
    opdef = registry.get_op_def(op.type)
    gen = None
    if opdef.needs_rng:
        gen = torch.Generator(device=device)
        gen.manual_seed(op_seed(seed, counter,
                                int(op.attrs.get("__idx__", op_idx))))
    ins = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if n == EMPTY_VAR:
                vals.append(None)
                continue
            if n not in env:
                raise KeyError(
                    f"op {op.type}: input var {n!r} not materialized")
            vals.append(env[n])
        ins[slot] = vals
    ctx = LoweringContext(op.attrs, device, generator=gen, op=op)
    outs = registry.call_rule(opdef, ctx, ins)
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        if len(vals) < len(names):
            raise ValueError(f"op {op.type}: slot {slot} produced "
                             f"{len(vals)} values for {len(names)} outputs")
        for name, val in zip(names, vals):
            if name == EMPTY_VAR or val is None:
                continue
            if check_nan_inf and val.is_floating_point() \
                    and not bool(torch.isfinite(val).all()):
                raise RuntimeError(
                    f"NaN/Inf detected in output {name!r} of op "
                    f"{op.type!r} (check_nan_inf mode; reference "
                    f"CheckTensorNANOrInf, operator.cc:622)")
            env[name] = val
