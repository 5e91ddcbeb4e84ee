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

Under bf16 mixed precision (`amp`) every forward rule runs through
`registry.call_rule`'s policy, and so does a generic grad op's recompute:
autograd through the policy's casts hands float32 grads to float32
inputs, as `jax.vjp` does through `astype`. A hand-written grad gets the
env's values as they are, with no policy, as in the JAX package.

A variable-length batch is a padded tensor plus an int32 `name@SEQLEN`
companion (``name@SEQLEN.1`` for nested sequences' inner lengths). After
the rule of an op registered with `propagate_seqlen` (the default), the
first input's companions are carried onto the op's outputs
(`_propagate_seqlen`, the JAX package's rule), so an `fc` or an
activation keeps its input's lengths; the sequence ops register False
and their layers wire and alias companions as explicit vars.

A control-flow op (``ops/control.py``) runs its sub-blocks through
`LoweringContext.run_block` on a copy of the live env, which carries the
outer values and their `@SEQLEN` companions in, whatever slot names
them. Its generic grad recomputes it on a copy in which the autograd
leaves of its declared inputs replace the outer values, so a parameter
that only the loop body reads (it is in the op's `X`, the layer adds
the body's external reads there) gets its grad through the recompute.

Random ops get a host integer seed from (program seed, run counter, op
index): the JAX package's `fold_in(fold_in(key(seed), counter), op index)`
derivation. Inside a sub-block the control op's own seed takes the
program seed's place and the iteration the counter's. A grad op takes
the seed of its forward op, so a dropout mask or an attention seed is
the forward's own. The two packages draw different numbers from the same
seed, so parity tests hand both the same parameters instead of the same
seed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Set

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
              check_nan_inf: bool = False,
              live: Optional[Set[str]] = None,
              amp: bool = False, recompute: bool = False) -> Dict[str, Any]:
    """Run every op of `block_idx` on `env` (name -> tensor), mutating
    and returning it. `live`, when given, names the vars that something
    reads (`LoweringContext.wants`); a forward rule may then leave an
    output that is not in it out of `env`. None keeps every output.
    `amp` runs every rule under the bf16 policy (``core/registry.py``);
    `recompute` marks a sub-block run inside a generic grad's recompute."""
    device = torch.device(device)
    for op_idx, op in enumerate(program.blocks[block_idx].ops):
        if op.type.endswith(GRAD_OP_SUFFIX) and FWD_OP_ATTR in op.attrs:
            _run_grad_op(op, env, device, seed, counter, amp,
                         program=program)
            if check_nan_inf:
                for name in op.output_arg_names:
                    _check_finite(op, name, env.get(name))
            continue
        _run_op(op, op_idx, env, device, seed, counter, check_nan_inf, live,
                amp, recompute=recompute, program=program)
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
            seed: int, counter: int, check_nan_inf: bool, live=None,
            amp: bool = False, recompute: bool = False,
            program: Optional[ir.Program] = None):
    opdef = registry.get_op_def(op.type)
    s = (op_seed(seed, counter, int(op.attrs.get("__idx__", op_idx)))
         if opdef.needs_rng else None)
    ctx = LoweringContext(op.attrs, device, seed=s, op=op, live=live,
                          recompute=recompute, amp=amp, program=program,
                          env=env)
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
    if opdef.propagate_seqlen:
        _propagate_seqlen(op, env)


def _propagate_seqlen(op: ir.Operator, env: Dict[str, Any]):
    """Variable-length bookkeeping (the JAX package's rule): an op that
    keeps the batch and time axes carries its first input's length
    companions onto its outputs -- the bare `@SEQLEN` (outer level) and,
    for nested sequences, the `@SEQLEN.1` inner lengths -- where an
    output has at least 2 dims and the companion's leading dim. An
    output that already has a companion keeps it."""
    for suffix in (ir.SEQLEN_SUFFIX, ir.SEQLEN_SUFFIX + ".1"):
        src = None
        for names in op.inputs.values():
            for n in names:
                if n != EMPTY_VAR and (n + suffix) in env:
                    src = env[n + suffix]
                    break
            if src is not None:
                break
        if src is None:
            continue
        for names in op.outputs.values():
            for n in names:
                if n != EMPTY_VAR and n in env and (n + suffix) not in env:
                    val = env[n]
                    if isinstance(val, torch.Tensor) and val.ndim >= 2 \
                            and val.shape[0] == src.shape[0]:
                        env[n + suffix] = src


# ---------------------------------------------------------------------------
# grad ops
# ---------------------------------------------------------------------------

def _run_grad_op(op: ir.Operator, env: Dict[str, Any], device, seed: int,
                 counter: int, amp: bool = False,
                 program: Optional[ir.Program] = None):
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
        ctx = LoweringContext(fwd_attrs, device, seed=s, op=op, amp=amp,
                              program=program, env=env)
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
    shadow = None
    if opdef.reads_env:
        # the rule reads its values through ctx.env: the leaves must
        # stand there for the outer values, or autograd never reaches
        # them (a loop body's parameters would get zero grads)
        shadow = dict(env)
        shadow.update(leaves)
    with torch.enable_grad():
        ins = {sl: [leaves.get(n, env.get(n)) for n in ns]
               for sl, ns in fwd_inputs.items()}
        ctx = LoweringContext(fwd_attrs, device, seed=s, op=op,
                              recompute=True, amp=amp, program=program,
                              env=shadow)
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
