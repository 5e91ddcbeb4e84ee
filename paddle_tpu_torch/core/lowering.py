"""Eager block interpreter.

Mirror of ``paddle_tpu/core/lowering.py``. The JAX package traces a whole
block into one XLA computation; here the executor runs the block's ops one
by one on the place's device, each through its PyTorch rule, against a
name -> tensor env (the reference's own `for op in ops: op->Run(...)`
loop, executor.cc:321-366).

Grad ops (``core/backward.py``: one ``<type>_grad`` op per forward op,
carrying the forward OpDesc in its ``__fwd_op__`` attr) run generically:
the forward rule is recomputed under autograd on detached copies of the
inputs that want a gradient, and `torch.autograd.grad` pulls the output
grads back through it — the JAX package's `jax.vjp` of the same rule. An
op with a hand-written grad (`register_grad`) runs that instead.

Recomputing means each forward rule runs twice per training step (the
JAX package's jit lets XLA share the two, and its ``__remat__`` barrier
keeps them apart on purpose; here every op is rematerialized, so
``__remat__`` needs nothing). Keeping the forward's autograd graph for
the grad op instead is later performance work.

Random ops get a host integer seed from (program seed, run counter, op
index): the JAX package's `fold_in(fold_in(key(seed), counter), op index)`
derivation. A grad op takes the seed of its forward op, so a dropout mask
or an attention seed is the forward's own. The two packages draw
different numbers from the same seed, so parity tests hand both the same
parameters instead of the same seed.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from . import ir, registry
from .registry import EMPTY_VAR, FWD_OP_ATTR, GRAD_OP_SUFFIX, LoweringContext

_MASK63 = (1 << 63) - 1


def op_seed(seed: int, counter: int, op_idx: int) -> int:
    """Deterministic per-(program seed, run, op) seed."""
    s = (int(seed) * 0x9E3779B97F4A7C15 + int(counter)) & _MASK63
    return (s * 0xBF58476D1CE4E5B9 + int(op_idx)) & _MASK63


def run_block(program: ir.Program, block_idx: int, env: Dict[str, Any],
              device, seed: int = 0, counter: int = 0,
              check_nan_inf: bool = False) -> Dict[str, Any]:
    """Run every op of `block_idx` on `env` (name -> tensor), mutating
    and returning it."""
    device = torch.device(device)
    for op_idx, op in enumerate(program.blocks[block_idx].ops):
        if op.type.endswith(GRAD_OP_SUFFIX) and FWD_OP_ATTR in op.attrs:
            _run_grad_op(op, env, device, seed, counter)
            if check_nan_inf:
                for name in op.output_arg_names:
                    _check_finite(op, name, env.get(name))
            continue
        _run_op(op, op_idx, env, device, seed, counter, check_nan_inf)
    return env


def _check_finite(op, name, val):
    if isinstance(val, torch.Tensor) and val.is_floating_point() \
            and not bool(torch.isfinite(val).all()):
        raise RuntimeError(
            f"NaN/Inf detected in output {name!r} of op {op.type!r} "
            f"(check_nan_inf mode; reference CheckTensorNANOrInf, "
            f"operator.cc:622)")


def _gather_inputs(inputs: Dict[str, List[str]], env: Dict[str, Any],
                   op_type: str):
    ins = {}
    for slot, names in inputs.items():
        vals = []
        for n in names:
            if n == EMPTY_VAR:
                vals.append(None)
                continue
            if n not in env:
                raise KeyError(
                    f"op {op_type}: input var {n!r} not materialized")
            vals.append(env[n])
        ins[slot] = vals
    return ins


def _run_op(op: ir.Operator, op_idx: int, env: Dict[str, Any], device,
            seed: int, counter: int, check_nan_inf: bool):
    opdef = registry.get_op_def(op.type)
    s = (op_seed(seed, counter, int(op.attrs.get("__idx__", op_idx)))
         if opdef.needs_rng else None)
    ctx = LoweringContext(op.attrs, device, seed=s, op=op)
    outs = registry.call_rule(opdef, ctx, _gather_inputs(op.inputs, env,
                                                         op.type))
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
            if check_nan_inf:
                _check_finite(op, name, val)
            env[name] = val


# ---------------------------------------------------------------------------
# grad ops
# ---------------------------------------------------------------------------

def _run_grad_op(op: ir.Operator, env: Dict[str, Any], device, seed: int,
                 counter: int):
    fwd = op.attrs[FWD_OP_ATTR]          # forward OpDesc as dict
    fwd_type, fwd_inputs, fwd_outputs = (fwd["type"], fwd["inputs"],
                                         fwd["outputs"])
    fwd_attrs = fwd["attrs"]
    opdef = registry.get_op_def(fwd_type)
    s = (op_seed(seed, counter, int(fwd.get("__idx__", 0)))
         if opdef.needs_rng else None)
    declared = _declared_by_base(op)

    if opdef.grad_lower is not None:
        ins = {sl: [env[n] for n in ns] for sl, ns in fwd_inputs.items()}
        out_grads = {sl: [env.get(ir.grad_var_name(n)) for n in ns]
                     for sl, ns in fwd_outputs.items()}
        ctx = LoweringContext(fwd_attrs, device, seed=s, op=op)
        # forward OUTPUT values, already in env: a grad that consumes a
        # saved output (softmax_with_cross_entropy's LSE) reads it here
        ctx.fwd_outs = {sl: [env.get(n) for n in ns]
                        for sl, ns in fwd_outputs.items()}
        grads = opdef.grad_lower(ctx, ins, out_grads)
        _write_input_grads(declared, fwd_inputs, grads, env)
        return

    # one autograd leaf per wanted floating input; a var that fills several
    # slots gets the sum of its uses' grads from autograd itself
    leaves: Dict[str, torch.Tensor] = {}
    for names in fwd_inputs.values():
        for n in names:
            if n in declared and n not in leaves \
                    and env[n].is_floating_point():
                leaves[n] = env[n].detach().requires_grad_(True)
    if not leaves:
        return
    with torch.enable_grad():
        ins = {sl: [leaves.get(n, env.get(n)) for n in ns]
               for sl, ns in fwd_inputs.items()}
        ctx = LoweringContext(fwd_attrs, device, seed=s, op=op)
        outs = registry.call_rule(opdef, ctx, ins)
        primals, cotangents = [], []
        for slot, out_names in fwd_outputs.items():
            for name, primal in zip(out_names, outs.get(slot, ())):
                g = env.get(ir.grad_var_name(name))
                # a missing output grad, or an output no input reaches
                # (integer, or built from constants), adds nothing
                if g is None or primal is None or not primal.requires_grad:
                    continue
                primals.append(primal)
                cotangents.append(g.to(primal.dtype))
        grads = (torch.autograd.grad(primals, list(leaves.values()),
                                     cotangents, allow_unused=True)
                 if primals else [None] * len(leaves))
    for n, g in zip(leaves, grads):
        env[declared[n]] = (torch.zeros_like(env[n]) if g is None
                            else g.detach())


def _grad_base(grad_name: str) -> str:
    """`x@GRAD` or `x@GRAD@RENAME@k` -> `x` (fan-in contributions are
    renamed by core/backward.py before a `sum` op re-merges them)."""
    return grad_name.split(ir.GRAD_SUFFIX)[0]


def _declared_by_base(grad_op: ir.Operator) -> Dict[str, str]:
    """forward input name -> the grad var name this grad op writes."""
    out = {}
    for names in grad_op.outputs.values():
        for n in names:
            if n != EMPTY_VAR and ir.GRAD_SUFFIX in n:
                out[_grad_base(n)] = n
    return out


def _write_input_grads(declared: Dict[str, str], fwd_inputs, grads, env):
    for slot, g in grads.items():
        gs = g if isinstance(g, (list, tuple)) else [g]
        for name, gv in zip(fwd_inputs.get(slot, []), gs):
            if gv is None or name not in declared:
                continue
            gname = declared[name]
            env[gname] = gv if gname not in env else env[gname] + gv
