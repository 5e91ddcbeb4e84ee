"""Severity-ranked diagnostics for the static analysis layer.

Mirror of ``paddle_tpu/analysis/diagnostics.py``. Every finding is a
`Diagnostic` record carrying (block idx, op idx, op type, var)
provenance plus the op's trimmed creation traceback captured by
`Operator.__init__` (core/ir.py), so "op 37 has a bad input" points back
at the layers-DSL line that built op 37, not at the rule that tripped
over it at run time (reference: paddle/fluid/platform/enforce.h,
operator.cc's `op_callstack` attr; inference/analysis/analyzer.cc).

Every lint keeps the JAX package's code and severity, so the two
packages' diagnostics of one Program compare equal; the messages give
the reasons that hold on the H100. Two codes keep names that speak of
the TPU and of XLA's compiles (`float64-on-tpu`, `feed-shape-recompile`):
they are kept for parity, and their docstrings below say what the
finding costs here.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from ..core import ir, registry


class Severity(enum.IntEnum):
    """Ranked: higher = more severe (sort descending for display)."""

    INFO = 1
    WARNING = 2
    ERROR = 3

    def __str__(self):
        return self.name


@dataclass
class Diagnostic:
    """One finding, with enough provenance to act on it."""

    code: str                 # stable kebab-case id, e.g. "undefined-input"
    severity: Severity
    message: str
    block_idx: int = 0
    op_idx: Optional[int] = None
    op_type: Optional[str] = None
    var: Optional[str] = None
    site: Optional[List[str]] = None  # trimmed creation traceback (user frames)

    def format(self, show_site: bool = True) -> str:
        where = f"block {self.block_idx}"
        if self.op_idx is not None:
            where += f" op {self.op_idx}"
        if self.op_type:
            where += f" ({self.op_type})"
        out = f"{self.severity}: [{self.code}] {where}: {self.message}"
        if show_site and self.site:
            out += "".join(f"\n    built at {s}" for s in self.site)
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {"code": self.code, "severity": self.severity.name,
                "message": self.message, "block_idx": self.block_idx,
                "op_idx": self.op_idx, "op_type": self.op_type,
                "var": self.var, "site": self.site}


def diag_for_op(code: str, severity: Severity, message: str,
                block: ir.Block, op_idx: Optional[int] = None,
                op: Optional[ir.Operator] = None,
                var: Optional[str] = None) -> Diagnostic:
    """Build a Diagnostic with provenance pulled off the op itself."""
    return Diagnostic(
        code=code, severity=severity, message=message, block_idx=block.idx,
        op_idx=op_idx, op_type=op.type if op is not None else None, var=var,
        site=getattr(op, "_creation_site", None))


def sort_diagnostics(diags: Sequence[Diagnostic]) -> List[Diagnostic]:
    """Most severe first; program order within a severity."""
    return sorted(diags, key=lambda d: (-int(d.severity), d.block_idx,
                                        d.op_idx if d.op_idx is not None else -1))


def has_errors(diags: Sequence[Diagnostic]) -> bool:
    return any(d.severity == Severity.ERROR for d in diags)


def format_diagnostics(diags: Sequence[Diagnostic],
                       show_site: bool = True) -> str:
    return "\n".join(d.format(show_site=show_site)
                     for d in sort_diagnostics(diags))


class ProgramVerificationError(ValueError):
    """Raised by validate="error" surfaces; carries the findings."""

    def __init__(self, diags: Sequence[Diagnostic], context: str = "program"):
        self.diagnostics = list(diags)
        errors = [d for d in self.diagnostics if d.severity == Severity.ERROR]
        super().__init__(
            f"{context} failed static verification with {len(errors)} "
            f"error(s):\n{format_diagnostics(self.diagnostics)}")


# ---------------------------------------------------------------------------
# lints (advisory WARNINGs — except comm-float64, which is a contract
# violation at the wire boundary and rates an ERROR)
# ---------------------------------------------------------------------------

def lint_program(program: ir.Program,
                 fetch_targets: Optional[Sequence[str]] = None
                 ) -> List[Diagnostic]:
    """Device-fit lints over a structurally valid program."""
    diags: List[Diagnostic] = []
    diags += _lint_float64(program)
    diags += _lint_comm_float64(program)
    diags += _lint_feed_shape_hazards(program)
    diags += _lint_static_inference_feeds(program)
    if fetch_targets:
        diags += _lint_dead_ops(program, list(fetch_targets))
        diags += lint_dead_fetch_targets(program, list(fetch_targets))
    return diags


def _lint_float64(program: ir.Program) -> List[Diagnostic]:
    """float64 on the H100: every byte moved doubles, the CUDA cores run
    it at half float32's rate, the AMP policy passes it through in
    float64, and the hand-written kernels (csrc/) refuse it. The code
    keeps the JAX package's name, `float64-on-tpu`, for parity."""
    diags = []
    for blk in program.blocks:
        flagged = set()
        for v in blk.vars.values():
            if v.dtype == "float64":
                diags.append(Diagnostic(
                    "float64-on-tpu", Severity.WARNING,
                    f"variable {v.name!r} is float64: twice the bytes of "
                    f"float32 at half its rate on the card, and no "
                    f"hand-written kernel takes it — use float32 or "
                    f"bfloat16", block_idx=blk.idx, var=v.name))
                flagged.add(v.name)
        for i, op in enumerate(blk.ops):
            dt = op.attrs.get("dtype")
            if isinstance(dt, str) and dt in ("float64", "fp64", "double") \
                    and not (set(op.output_arg_names) & flagged):
                diags.append(diag_for_op(
                    "float64-on-tpu", Severity.WARNING,
                    f"attr dtype={dt!r}: float64 runs at half float32's "
                    f"rate on the card",
                    blk, i, op))
    return diags


def _lint_comm_float64(program: ir.Program) -> List[Diagnostic]:
    """fluid-wire extension of the float64 lint to the WIRE contract: a
    gradient reaching a quantized communication boundary (a
    `comm_quant_dequant` op — wire/graph.py) with dtype float64 is an
    ERROR, not advice. The wire codecs are float32-only (wire/codec.py
    refuses f64 at runtime with the same message; the port's `wire/`
    waits for ROADMAP item 8), an f64 gradient at an
    int8/bf16 boundary means the program silently planned to throw away
    ~45 bits while paying f64 compute upstream — a config mistake, never
    an intentional trade."""
    diags = []
    for blk in program.blocks:
        for i, op in enumerate(blk.ops):
            if op.type != "comm_quant_dequant":
                continue
            for slot in ("Grad", "Residual"):
                for name in op.input(slot):
                    v = blk._find_var_recursive(name)
                    if v is not None and v.dtype == "float64":
                        diags.append(diag_for_op(
                            "comm-float64", Severity.ERROR,
                            f"{slot.lower()} var {name!r} is float64 at a "
                            f"quantized communication boundary (codec "
                            f"{op.attrs.get('codec', 'int8')!r}): the wire "
                            f"contract is float32 — cast the model to "
                            f"float32, or drop comm_quant for this "
                            f"program", blk, i, op, var=name))
    return diags


def _lint_feed_shape_hazards(program: ir.Program) -> List[Diagnostic]:
    """Dynamic (-1) dims beyond the batch dim. The port compiles no
    program per feed shape (its executor runs op by op), so the lint is
    kept for parity with the JAX package, code and severity alike; what
    such a shape costs here is the serving ladder's padding
    (serve/bucketing.py pads rows to fixed rungs, not other dims), and,
    under `torch.backends.cudnn.benchmark`, a fresh algorithm search for
    each new conv shape. A contiguous LEADING run of -1s (batch + time
    levels) is the padded-sequence feed contract (DataFeeder pads,
    callers bucket), an INFO note; a -1 AFTER a concrete dim has no such
    contract and is almost always a declaration mistake -> WARNING. LoD
    (lod_level>0) inputs are the sequence contract by definition."""
    diags = []
    for blk in program.blocks:
        for v in blk.vars.values():
            if not v.is_data or v.lod_level > 0 or -1 not in v.shape[1:]:
                continue
            lead = 0
            while lead < len(v.shape) and v.shape[lead] == -1:
                lead += 1
            trailing_dynamic = any(d == -1 for d in v.shape[lead:])
            diags.append(Diagnostic(
                "feed-shape-recompile",
                Severity.WARNING if trailing_dynamic else Severity.INFO,
                f"data var {v.name!r} shape {tuple(v.shape)} has a dynamic "
                f"dim beyond the batch dim: a serving ladder pads only "
                f"the rows, and each new conv shape costs cuDNN an "
                f"algorithm search under cudnn.benchmark — pad to a fixed "
                f"extent or bucket feed lengths",
                block_idx=blk.idx, var=v.name))
    return diags


def _lint_dead_ops(program: ir.Program,
                   fetch_targets: List[str]) -> List[Diagnostic]:
    """Ops whose outputs never reach a fetch target, a persistable write
    (parameter/accumulator updates ARE the point of a training step), or a
    side-effecting op. The port's executor runs every op of the block,
    dead ones too (a rule only skips an output nothing reads), so a dead
    op costs its rule call each step, and it hides wiring bugs (a loss
    wired to the wrong var fetches fine and trains nothing)."""
    diags = []
    blk = program.global_block()
    needed = set(fetch_targets)
    live = [False] * len(blk.ops)
    for i in range(len(blk.ops) - 1, -1, -1):
        op = blk.ops[i]
        out_names = [n for n in op.output_arg_names
                     if n != registry.EMPTY_VAR]
        side_effecting = (op.type in _SIDE_EFFECT_OPS
                          or bool(ir.sub_block_indices(op)))
        writes_persistable = any(
            (v := blk._find_var_recursive(n)) is not None and v.persistable
            for n in out_names)
        # an op is also live if a LIVE op downstream needs the @SEQLEN
        # companion of one of its outputs (runtime seqlen propagation
        # materializes companions without an explicit producing op)
        companion_hit = any(n + ir.SEQLEN_SUFFIX in needed
                            for n in out_names)
        if side_effecting or writes_persistable or companion_hit \
                or (needed & set(out_names)):
            live[i] = True
            ins = {n for n in op.input_arg_names if n != registry.EMPTY_VAR}
            for si in ir.sub_block_indices(op):
                ins |= set(ir.external_reads(program, si))
            needed |= ins
            needed |= {n + ir.SEQLEN_SUFFIX for n in ins}
    for i, op in enumerate(blk.ops):
        if not live[i]:
            diags.append(diag_for_op(
                "dead-op", Severity.WARNING,
                f"op never reaches a fetch target "
                f"{sorted(fetch_targets)} or a persistable write — "
                f"mis-wired graph or leftover build code", blk, i, op))
    return diags


_SIDE_EFFECT_OPS = frozenset({"feed", "fetch", "listen_and_serv", "print",
                              "py_reader", "read", "send", "recv"})


def _lint_static_inference_feeds(program: ir.Program) -> List[Diagnostic]:
    """Inference programs whose feed vars declare FULLY static shapes
    (batch dim included) lock the request path to exactly one shape: a
    shape-bucketing server (serve/) cannot pad a 3-row request onto an
    8-row rung, and every client must submit the declared batch size
    exactly. Legal, but it defeats micro-batch coalescing, so it rates
    an INFO note on the
    inference slice only (training programs routinely pin the batch)."""
    if not getattr(program, "_is_inference", False):
        return []
    diags = []
    blk = program.global_block()
    for v in blk.vars.values():
        if v.is_data and v.shape and -1 not in v.shape:
            diags.append(Diagnostic(
                "static-inference-feed", Severity.INFO,
                f"feed var {v.name!r} declares the fully static shape "
                f"{tuple(v.shape)}: every request must match it exactly, "
                f"so a shape-bucketing server cannot coalesce or pad "
                f"mixed batch sizes — declare the batch dim as -1 to "
                f"enable bucketing", block_idx=blk.idx, var=v.name))
    return diags


def lint_dead_fetch_targets(program: ir.Program,
                            fetch_targets: Sequence[str]
                            ) -> List[Diagnostic]:
    """Fetch targets NOTHING in the program produces: no op writes them
    and they are neither feeds nor persistables, so fetching reads an
    undefined value. The classic way to get one is `save_inference_model`
    pruning: a target wired to the training-only graph survives in the
    vars table while its producing op is stripped by the for_test clone —
    the saved model then loads fine and serves garbage."""
    blk = program.global_block()
    produced = set()
    for op in blk.ops:
        for n in op.output_arg_names:
            if n == registry.EMPTY_VAR:
                continue
            produced.add(n)
            # runtime seqlen propagation materializes @SEQLEN companions
            # without an explicit producing op
            produced.add(n + ir.SEQLEN_SUFFIX)
            produced.add(n + ir.SEQLEN_SUFFIX + ".1")
    diags = []
    for t in fetch_targets:
        if t in produced:
            continue
        v = blk._find_var_recursive(t)
        if v is None or v.is_data or v.persistable:
            # nonexistent targets are the verifier's ERROR; feeds and
            # persistables have well-defined values without a producer
            continue
        diags.append(Diagnostic(
            "dead-fetch-target", Severity.WARNING,
            f"fetch target {t!r} is produced by no op in this program "
            f"and is neither a feed nor persistable — fetching it reads "
            f"an undefined value (was its producer pruned away by "
            f"save_inference_model's for_test clone?)",
            block_idx=blk.idx, var=t))
    return diags
