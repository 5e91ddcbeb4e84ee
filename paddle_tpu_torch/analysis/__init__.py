"""Static analysis over the Program IR: structural verification,
whole-program shape/dtype inference, device-fit lints and per-op costs.

Mirror of ``paddle_tpu/analysis/`` (reference: framework/
shape_inference.h:30's compile-time InferShape, inference/analysis/
analyzer.cc's pass manager), over the same JSON-serializable Program IR:

    from paddle_tpu_torch import analysis
    diags = analysis.analyze_program(prog, fetch_targets=["loss"])
    print(analysis.format_diagnostics(diags))

Surfaces wired elsewhere: the read-only "verify" pass and the mutating
"infer_shapes" pass (ir_pass.py), `Executor.prepare(validate=...)` and
the `validate` flag (core/executor.py, flags.py), and
`io.save_inference_model`'s dead-fetch-target warning.

A second, source-level surface lives in `concurrency`: an AST-based
lock-discipline / deadlock-cycle / hold-time analyzer over threaded
Python, run over this package by tests/test_torch_analysis.py.

`planner` is the port's copy of the JAX package's planner
(`HardwareSpec`, `plan_meshes`, `estimate_step_time`,
`flag_family_priors`, ...) with the port's own machine models (`H100`,
`CPU_REHEARSAL`; the JAX package's `TPU_CHIP` is a TPU's and is not
ported); it feeds `parallel.mesh.auto_mesh`. Its `optimal_rungs` is
`serve/bucketing.py`'s.
`xla_flops` has no XLA to ask here: `measured_flops` counts a step with
torch's FLOP counter instead.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..core import ir
from .concurrency import (ConcurrencyDiagnostic, analyze_package,  # noqa: F401
                          analyze_paths, analyze_source, baseline_key)
from .cost_model import (CostReport, OpCost, estimate_cost,  # noqa: F401
                         estimate_peak_hbm, measured_flops, shape_env)
from .planner import (CPU_REHEARSAL, H100, HardwareSpec,  # noqa: F401
                      MeshPlan, PlanReport, cost_profile,
                      detect_hardware, enumerate_meshes,
                      estimate_step_time, flag_family_priors,
                      optimal_rungs, plan_meshes)
from .diagnostics import (Diagnostic, ProgramVerificationError,  # noqa: F401
                          Severity, format_diagnostics, has_errors,
                          lint_dead_fetch_targets, lint_program,
                          sort_diagnostics)
from .shape_infer import check_program_shapes, infer_program_shapes  # noqa: F401
from .verifier import verify_program  # noqa: F401


def analyze_program(program: ir.Program,
                    feed_targets: Optional[Sequence[str]] = None,
                    fetch_targets: Optional[Sequence[str]] = None,
                    shapes: bool = True,
                    lint: bool = True) -> List[Diagnostic]:
    """Full sweep: structural verification + shape/dtype cross-check +
    lints, ranked most-severe-first."""
    diags = verify_program(program, feed_targets=feed_targets,
                           fetch_targets=fetch_targets)
    if shapes and not has_errors(diags):
        # structural errors make shape propagation garbage-in; the
        # reference ordered InferShape after desc validation the same way
        diags += check_program_shapes(program)
    if lint:
        diags += lint_program(program, fetch_targets=fetch_targets)
    return sort_diagnostics(diags)
