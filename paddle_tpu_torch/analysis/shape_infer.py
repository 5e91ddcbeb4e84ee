"""Whole-program static shape/dtype propagation.

Mirror of ``paddle_tpu/analysis/shape_infer.py`` (reference: the
compile-time InferShape sweep, framework/shape_inference.h:30). There are
no per-op InferShape methods: `registry.infer_op_shapes` derives each
op's output shapes by running its rule on meta tensors
(core/registry.py), so the rule stays the single source of truth, as
`jax.eval_shape` keeps it in the JAX package. This module threads that
per-op inference through a WHOLE program: op by op, block by block
(control-flow sub-blocks see the enclosing env), carrying -1 batch dims,
and cross-checking every declared `Variable.shape/dtype` against what
the rules produce. A mismatch found here at build time is otherwise an
error with no provenance in the middle of a step.

Generic grad ops are not run on meta tensors: a gradient has its base
variable's shape by construction (`x@GRAD[@RENAME@k]` takes the shape of
`x`), which is also how the reference's grad-op InferShape worked
(SetOutputDim(GradVarName(x), GetInputDim(x))).

The port's index dtype is int64 where the JAX package's is int32
(core/types.py), and a Program the JAX package built or saved (a model
dir both packages load) declares int32 where the port's rules give
int64: the dtype cross-check takes int32 and int64 as one index dtype,
so the port reports no mismatch the JAX package does not."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..core import ir, registry, types
from ..core.registry import EMPTY_VAR, FWD_OP_ATTR, GRAD_OP_SUFFIX
from .diagnostics import Diagnostic, Severity, diag_for_op
from .verifier import PSEUDO_OPS

ShapeDtype = Tuple[Tuple[int, ...], str]


def infer_program_shapes(program: ir.Program, update: bool = False,
                         ) -> Tuple[Dict[str, ShapeDtype], List[Diagnostic]]:
    """Propagate shapes through the whole program.

    Returns ({var name -> (shape, dtype)}, diagnostics). With `update`,
    inferred results are written back onto Variables whose declared shape
    was empty (the build-time-inference-failed gap); declared non-empty
    shapes are never rewritten — they are the user's contract and
    mismatches are reported instead.
    """
    diags: List[Diagnostic] = []
    env: Dict[str, ShapeDtype] = {}
    _seed_env(program, env)
    _infer_block(program, program.global_block(), env, diags, update,
                 visited=set())
    return env, diags


def check_program_shapes(program: ir.Program) -> List[Diagnostic]:
    """Cross-check only (no write-back)."""
    return infer_program_shapes(program, update=False)[1]


def _seed_env(program: ir.Program, env: Dict[str, ShapeDtype]):
    """Roots of propagation: vars whose values exist before any op runs —
    fed data (with @SEQLEN companions) and persistables. Temporaries are
    NOT seeded: their declared shapes are re-derived and cross-checked."""
    for blk in program.blocks:
        for v in blk.vars.values():
            if (v.is_data or v.persistable) and v.shape != ():
                env[v.name] = (tuple(v.shape), v.dtype)
                for lvl in range(v.lod_level):
                    env.setdefault(ir.seqlen_var_name(v.name, lvl),
                                   ((-1,) * (lvl + 1), "int32"))


def _lookup(program, block, name, env) -> Optional[ShapeDtype]:
    if name in env:
        return env[name]
    v = block._find_var_recursive(name)
    if v is not None and v.shape != ():
        return (tuple(v.shape), v.dtype)
    return None


def _infer_block(program, block, env, diags, update, visited):
    visited.add(block.idx)
    for op_idx, op in enumerate(block.ops):
        if op.type in PSEUDO_OPS:
            continue
        if op.type.endswith(GRAD_OP_SUFFIX) and FWD_OP_ATTR in op.attrs:
            _infer_grad_op(program, block, op, env)
            continue
        sub_idxs = ir.sub_block_indices(op)
        if sub_idxs:
            # control-flow: infer through the body with the enclosing env
            # (this is where -1 batch dims thread block-by-block), then
            # take the op's own outputs from their declarations — the
            # carry/stack plumbing is the lowering rule's business.
            for si in sub_idxs:
                if si < len(program.blocks) and si not in visited:
                    _infer_block(program, program.blocks[si], env, diags,
                                 update, visited)
            _fallback_outputs(program, block, op, env)
            continue
        if not registry.is_registered(op.type):
            continue  # verifier already reported unknown-op

        ins_by_slot, unknown = {}, None
        for slot, names in op.inputs.items():
            pairs = []
            for n in names:
                if n == EMPTY_VAR:
                    continue
                sd = _lookup(program, block, n, env)
                if sd is None:
                    unknown = n
                    break
                pairs.append(sd)
            if unknown:
                break
            ins_by_slot[slot] = pairs
        if unknown:
            diags.append(diag_for_op(
                "shape-infer-skip", Severity.INFO,
                f"cannot infer: input {unknown!r} has no known shape",
                block, op_idx, op, var=unknown))
            _fallback_outputs(program, block, op, env)
            continue

        try:
            result = registry.infer_op_shapes(op.type, op.attrs, ins_by_slot)
        except Exception as e:  # the rule refused meta tensors
            diags.append(diag_for_op(
                "shape-infer-skip", Severity.INFO,
                f"meta-tensor inference failed: {type(e).__name__}: {e}",
                block, op_idx, op))
            _fallback_outputs(program, block, op, env)
            continue

        for slot, names in op.outputs.items():
            inferred = result.get(slot)
            if inferred is None:
                continue
            for n, (shape, dtype) in zip(names, inferred):
                if n == EMPTY_VAR:
                    continue
                _check_against_declared(program, block, op, op_idx, n,
                                        shape, dtype, diags, update)
                env[n] = (tuple(shape), dtype)


def _infer_grad_op(program, block, op, env):
    for n in op.output_arg_names:
        if n == EMPTY_VAR or ir.GRAD_SUFFIX not in n:
            continue
        base = n.split(ir.GRAD_SUFFIX)[0]
        sd = _lookup(program, block, base, env)
        if sd is not None:
            env[n] = sd


def _fallback_outputs(program, block, op, env):
    """Outputs whose shapes inference can't derive keep their declared
    shapes (runtime stays authoritative), so downstream ops still infer."""
    for n in op.output_arg_names:
        if n == EMPTY_VAR or n in env:
            continue
        v = block._find_var_recursive(n)
        if v is not None and v.shape != ():
            env[n] = (tuple(v.shape), v.dtype)


def _dims_compatible(declared: Sequence[int], inferred: Sequence[int]) -> bool:
    if len(declared) != len(inferred):
        return False
    return all(d == -1 or i == -1 or int(d) == int(i)
               for d, i in zip(declared, inferred))


def _index_as_one(dtype) -> str:
    """A dtype's canonical name, int32 and int64 taken as the index
    dtype (the port's int64 is the JAX package's int32)."""
    name = types.canonical_dtype(dtype)
    return "index" if name in ("int32", "int64") else name


def _check_against_declared(program, block, op, op_idx, name, shape, dtype,
                            diags, update):
    v = block._find_var_recursive(name)
    if v is None:
        return
    if v.shape == ():
        if update:  # fill the build-time-inference gap
            v.shape = tuple(int(d) for d in shape)
            v.dtype = types.canonical_dtype(dtype)
        return
    if not _dims_compatible(v.shape, shape):
        diags.append(diag_for_op(
            "shape-mismatch", Severity.ERROR,
            f"output {name!r} is declared {tuple(v.shape)} but the "
            f"lowering rule produces {tuple(shape)} — the declaration "
            f"(and everything built downstream of it) is wrong",
            block, op_idx, op, var=name))
        return
    if _index_as_one(v.dtype) != _index_as_one(dtype):
        diags.append(diag_for_op(
            "dtype-mismatch", Severity.ERROR,
            f"output {name!r} is declared {v.dtype} but the lowering rule "
            f"produces {dtype}", block, op_idx, op, var=name))
