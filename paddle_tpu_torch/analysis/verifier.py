"""Structural whole-program verifier over the Program IR.

Mirror of ``paddle_tpu/analysis/verifier.py`` (reference: OpDesc
validation + InferShape before execution, framework/shape_inference.h:30,
operator.cc's RuntimeInferShapeContext, block_desc.cc; and
inference/analysis/analyzer.cc). The port's executor runs a block op by
op, so a malformed Program otherwise fails only when its bad op's rule
is called, mid-step, after every op before it has run. This verifier
runs the same class of checks purely over the IR, before any rule:

  - unknown op types vs the registry (grad ops resolve their forward def)
  - input-slot arity vs OpDef.input_slots / optional_slots
  - def-before-use per block, honoring parent-block lookup and the
    executor's availability rules (feeds, persistables, @SEQLEN companions)
  - write-after-write: a value overwritten before anyone read it
  - sub-block attr validity for control-flow ops
  - feed / fetch target existence
  - every optimizer op's Grad input actually written upstream (a trainable
    Parameter reaching its update op without a gradient is the classic
    silently-frozen-layer bug)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

from ..core import ir, registry
from ..core.registry import EMPTY_VAR, FWD_OP_ATTR, GRAD_OP_SUFFIX
from .diagnostics import Diagnostic, Severity, diag_for_op

# Op types the executor handles outside the registry (host-side services
# and the feed/fetch protocol ops the reference also special-cased).
PSEUDO_OPS = frozenset({"feed", "fetch", "listen_and_serv"})

# Input slots read optionally at run time (grad ops pull out-grads
# lazily; a missing one becomes a zero cotangent).
_OPTIONAL_READ_SLOTS = frozenset({"OutGrad"})


def verify_program(program: ir.Program,
                   feed_targets: Optional[Sequence[str]] = None,
                   fetch_targets: Optional[Sequence[str]] = None,
                   ) -> List[Diagnostic]:
    """Run all structural checks; returns diagnostics (never raises)."""
    diags: List[Diagnostic] = []
    gb = program.global_block()

    # feed/fetch targets must resolve somewhere in the program: a declared
    # variable, or (fetch) a name some global-block op actually produces /
    # (feed) a name something actually reads — the executor's env is
    # name-based, so an undeclared-but-produced name fetches fine
    produced = {n for op in gb.ops for n in op.output_arg_names}
    consumed = {n for op in gb.ops for n in op.input_arg_names}
    for name in feed_targets or ():
        if gb._find_var_recursive(name) is None and name not in consumed:
            diags.append(Diagnostic(
                "bad-feed-target", Severity.ERROR,
                f"feed target {name!r} is not a variable of the program "
                f"and nothing reads it", var=name))
    for name in fetch_targets or ():
        if gb._find_var_recursive(name) is None and name not in produced:
            diags.append(Diagnostic(
                "bad-fetch-target", Severity.ERROR,
                f"fetch target {name!r} is neither a variable of the "
                f"program nor produced by any op (fetching it would fail "
                f"only after the whole step ran)", var=name))

    available = _initial_available(program, feed_targets)
    _verify_block(program, gb, available, diags, visited=set())
    _verify_optimizer_grads(program, diags)
    return diags


def _initial_available(program: ir.Program,
                       feed_targets: Optional[Sequence[str]]) -> Set[str]:
    """Names readable before any op runs: persistables (the startup
    program's contract), fed data vars, and their @SEQLEN companions."""
    avail: Set[str] = {EMPTY_VAR}
    feed_set = set(feed_targets) if feed_targets is not None else None
    for blk in program.blocks:
        for v in blk.vars.values():
            fed = v.is_data and (feed_set is None or v.name in feed_set)
            if v.persistable or fed:
                avail.add(v.name)
                if fed:
                    for lvl in range(v.lod_level):
                        avail.add(ir.seqlen_var_name(v.name, lvl))
    return avail


def _verify_block(program: ir.Program, block: ir.Block, available: Set[str],
                  diags: List[Diagnostic], visited: Set[int]):
    """Walk one block in execution order. `available` is mutated: names
    this block produces stay visible to the caller's later ops only when
    the caller passes the same set (control-flow sub-blocks execute inside
    their parent's env, so that is exactly right — see
    executor._StepPlan's produced-set walk)."""
    visited.add(block.idx)
    # write-tracking for WAW: name -> (op_idx, op) of last write; cleared on read
    unread_writes: Dict[str, tuple] = {}

    for op_idx, op in enumerate(block.ops):
        opdef = _check_op_type(program, block, op, op_idx, diags)
        _check_slots(block, op, op_idx, opdef, diags)
        _check_sub_blocks(program, block, op, op_idx, diags)

        # -- reads ---------------------------------------------------------
        is_grad = op.type.endswith(GRAD_OP_SUFFIX) and FWD_OP_ATTR in op.attrs
        for slot, names in op.inputs.items():
            optional_read = is_grad and slot in _OPTIONAL_READ_SLOTS
            for n in names:
                if n == EMPTY_VAR:
                    continue
                unread_writes.pop(n, None)
                if n in available:
                    continue
                if optional_read:
                    continue  # read lazily at run time; missing -> zeros
                if _declared_in_chain(program, block, n):
                    diags.append(diag_for_op(
                        "read-before-write", Severity.ERROR,
                        f"input {n!r} (slot {slot!r}) is declared but "
                        f"nothing wrote it before this op — it is neither "
                        f"persistable, fed, nor produced upstream",
                        block, op_idx, op, var=n))
                else:
                    diags.append(diag_for_op(
                        "undefined-input", Severity.ERROR,
                        f"input {n!r} (slot {slot!r}) is not a variable of "
                        f"this block or any ancestor", block, op_idx, op,
                        var=n))
                available.add(n)  # report each undefined name once
        # control-flow sub-blocks read enclosing-scope names at run time
        for si in ir.sub_block_indices(op):
            if si < len(program.blocks):
                for n in ir.external_reads(program, si):
                    unread_writes.pop(n, None)
                    if n not in available \
                            and not _declared_in_chain(program, block, n):
                        diags.append(diag_for_op(
                            "undefined-input", Severity.ERROR,
                            f"sub-block {si} reads {n!r} which is not "
                            f"available in the enclosing scope",
                            block, op_idx, op, var=n))
                        available.add(n)

        # -- writes --------------------------------------------------------
        seen_here: Set[str] = set()
        for slot, names in op.outputs.items():
            for n in names:
                if n == EMPTY_VAR:
                    continue
                if n in seen_here:
                    diags.append(diag_for_op(
                        "write-after-write", Severity.ERROR,
                        f"op writes {n!r} through two output slots — the "
                        f"first value is lost before anyone reads it",
                        block, op_idx, op, var=n))
                seen_here.add(n)
                prev = unread_writes.get(n)
                if prev is not None:
                    prev_idx, prev_op = prev
                    diags.append(diag_for_op(
                        "write-after-write", Severity.ERROR,
                        f"overwrites {n!r} which op {prev_idx} "
                        f"({prev_op.type}) wrote and nothing read since — "
                        f"the earlier write is dead", block, op_idx, op,
                        var=n))
                unread_writes[n] = (op_idx, op)
                available.add(n)
                # the lowerer materializes @SEQLEN companions implicitly
                available.add(n + ir.SEQLEN_SUFFIX)
                available.add(n + ir.SEQLEN_SUFFIX + ".1")

        # sub-blocks execute within this op: verify them with the current
        # availability (their writes surface through the op's outputs /
        # carry plumbing, so the sub-set is discarded afterwards). The
        # sub-block's OWN declared vars count as available — control-flow
        # rules materialize inner names (step inputs, memories, carries)
        # from attrs before the block's first op runs.
        for si in ir.sub_block_indices(op):
            if si < len(program.blocks) and si not in visited:
                sub = program.blocks[si]
                _verify_block(program, sub, set(available) | set(sub.vars),
                              diags, visited)


def _check_op_type(program, block, op, op_idx, diags):
    """Unknown-op check; returns the OpDef driving slot arity (for grad
    ops, the FORWARD def — the grad op itself is generic) or None."""
    if op.type in PSEUDO_OPS:
        return None
    if op.type.endswith(GRAD_OP_SUFFIX) and FWD_OP_ATTR in op.attrs:
        fwd_type = op.attrs[FWD_OP_ATTR].get("type")
        if not registry.is_registered(fwd_type):
            diags.append(diag_for_op(
                "unknown-op", Severity.ERROR,
                f"grad op's forward type {fwd_type!r} is not registered",
                block, op_idx, op))
        return None  # generic slots (FwdIn/OutGrad/InGrad), no arity contract
    if not registry.is_registered(op.type):
        close = registry.close_op_names(op.type)
        hint = f" — did you mean {close}?" if close else ""
        diags.append(diag_for_op(
            "unknown-op", Severity.ERROR,
            f"op type {op.type!r} is not registered{hint}", block, op_idx,
            op))
        return None
    return registry.get_op_def(op.type)


def _check_slots(block, op, op_idx, opdef, diags):
    """Input-slot arity vs the lowering rule's signature. An unknown slot
    is a WARNING (call_rule silently drops it — almost always a typo'd
    slot name feeding zeros downstream); a missing required slot is the
    ERROR call_rule would raise mid-step."""
    if opdef is None:
        return
    slots = set(opdef.input_slots)
    for slot in opdef.input_slots:
        if slot in opdef.optional_slots:
            continue
        names = [n for n in op.inputs.get(slot, ())]
        if not names:
            diags.append(diag_for_op(
                "missing-slot", Severity.ERROR,
                f"required input slot {slot!r} of {op.type!r} is missing "
                f"or empty (rule signature: {opdef.input_slots})",
                block, op_idx, op))
    for slot in op.inputs:
        if slot not in slots:
            diags.append(diag_for_op(
                "unknown-slot", Severity.WARNING,
                f"input slot {slot!r} is not consumed by {op.type!r} "
                f"(known slots: {opdef.input_slots}) — the value is "
                f"silently ignored by the rule", block, op_idx, op))


def _check_sub_blocks(program, block, op, op_idx, diags):
    for key in ("sub_block", "else_block"):
        idx = op.attrs.get(key)
        if idx is None or (isinstance(idx, int) and idx < 0):
            continue
        if not isinstance(idx, int) or idx >= len(program.blocks):
            diags.append(diag_for_op(
                "bad-sub-block", Severity.ERROR,
                f"attr {key}={idx!r} is not a valid block index "
                f"(program has {len(program.blocks)} blocks)",
                block, op_idx, op))
        elif idx == 0:
            diags.append(diag_for_op(
                "bad-sub-block", Severity.ERROR,
                f"attr {key}=0 references the global block as its own "
                f"sub-block", block, op_idx, op))


def _verify_optimizer_grads(program: ir.Program, diags: List[Diagnostic]):
    """Every optimizer op's Grad input must be produced upstream, and every
    trainable Parameter an optimizer touches gets exactly one live @GRAD
    write before its update op (duplicates surface as write-after-write)."""
    blk = program.global_block()
    written_before: Set[str] = set()
    for op_idx, op in enumerate(blk.ops):
        if registry.is_registered(op.type):
            opdef = registry.get_op_def(op.type)
            if "Param" in opdef.input_slots and "Grad" in opdef.input_slots:
                for pname, gname in zip(op.input("Param"), op.input("Grad")):
                    if gname not in written_before:
                        diags.append(diag_for_op(
                            "missing-grad", Severity.ERROR,
                            f"optimizer {op.type!r} updates parameter "
                            f"{pname!r} but its gradient {gname!r} is never "
                            f"written before this op — the parameter would "
                            f"train on garbage or fail mid-step",
                            blk, op_idx, op, var=gname))
        written_before.update(
            n for n in op.output_arg_names if n != EMPTY_VAR)


def _declared_in_chain(program, block, name) -> bool:
    return block._find_var_recursive(name) is not None
