"""Generic program-pass infrastructure.

Mirror of ``paddle_tpu/ir_pass.py`` (reference:
paddle/fluid/framework/ir/pass.h `Pass`/`PassRegistry`, ir/graph.h
`Graph`, ir/graph_viz_pass.cc). Passes rewrite the Program IR before it
runs. Built-in passes wrap the transpilers and the analysis, so the two
reference workflows converge:

    prog = apply_pass("fuse_batch_norm", prog, scope=scope)
    prog = apply_pass("memory_optimize", prog)
    apply_pass("graph_viz", prog, path="/tmp/prog.dot")

A read-only pass (`mutates = False`) leaves the Program's version alone,
so the executor's prepared handles and their step plans stay valid; a
mutating pass bumps it, so the next run re-plans.
"""

from __future__ import annotations

from typing import Callable, Dict, List

from .core import ir

_REGISTRY: Dict[str, "Pass"] = {}


class Pass:
    """Base pass: override apply(program, **kw) -> program (reference
    Pass::Apply, ir/pass.h). Passes may mutate in place; they must return
    the program they leave valid."""

    name = "pass"
    mutates = True   # read-only passes set False to keep prepared handles

    def apply(self, program: ir.Program, **kwargs) -> ir.Program:
        raise NotImplementedError

    def __call__(self, program: ir.Program, **kwargs) -> ir.Program:
        out = self.apply(program, **kwargs)
        if out is None:
            out = program
        if self.mutates and hasattr(out, "_bump"):
            out._bump()   # invalidate prepared handles
        return out


def register_pass(name: str):
    """reference REGISTER_PASS macro analog."""
    def deco(cls):
        if name in _REGISTRY:
            raise ValueError(f"pass {name!r} already registered")
        inst = cls()
        inst.name = name
        _REGISTRY[name] = inst
        return cls
    return deco


def get_pass(name: str) -> Pass:
    if name not in _REGISTRY:
        raise KeyError(f"unknown pass {name!r}; registered: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def registered_passes() -> List[str]:
    return sorted(_REGISTRY)


def apply_pass(name: str, program: ir.Program, **kwargs) -> ir.Program:
    return get_pass(name)(program, **kwargs)


# ---------------------------------------------------------------------------
# built-ins
# ---------------------------------------------------------------------------

@register_pass("graph_viz")
class GraphVizPass(Pass):
    """DOT dump of the global block (reference ir/graph_viz_pass.cc)."""

    mutates = False   # inspection only: a version bump here would drop
                      # the executor's prepared handle of the program

    def apply(self, program, path="/tmp/program.dot", **kw):
        from . import debugger
        debugger.draw_block_graphviz(program.global_block(), path=path)
        return program


@register_pass("memory_optimize")
class MemoryOptimizePass(Pass):
    """Rematerialization marks (reference memory_optimize transpiler); a
    no-op at run time in the port (transpiler/
    memory_optimization_transpiler.py)."""

    def apply(self, program, skip_opt_set=None, **kw):
        from .transpiler.memory_optimization_transpiler import memory_optimize
        memory_optimize(program, skip_opt_set=skip_opt_set)
        return program


@register_pass("fuse_batch_norm")
class FuseBatchNormPass(Pass):
    """Exact conv+BN fold for inference (reference
    inference_transpiler.py fuse_batch_norm :107)."""

    def apply(self, program, scope=None, place=None, **kw):
        from .transpiler.inference_transpiler import InferenceTranspiler
        t = InferenceTranspiler()
        t.transpile(program, place, scope=scope)
        return program


@register_pass("prune_for_inference")
class PruneForInferencePass(Pass):
    """Backward-slice to the given targets (reference prune.cc:181 via
    Program._prune)."""

    def apply(self, program, targets=None, **kw):
        if not targets:
            raise ValueError("prune_for_inference needs targets=[names]")
        names = [t.name if hasattr(t, "name") else str(t) for t in targets]
        return program._prune(names)


@register_pass("verify")
class VerifyPass(Pass):
    """Whole-program static verification (analysis/): structural checks +
    shape/dtype cross-check + lints. Read-only by contract — it must
    never bump the program version (a bump would invalidate
    prepared-executor handles for an inspection)."""

    mutates = False

    def apply(self, program, feed_targets=None, fetch_targets=None,
              raise_on_error=True, collect=None, lint=True, **kw):
        """`collect`: a caller-provided list the diagnostics are appended
        to (the pass API returns the program, not findings). With
        `raise_on_error` (default), ERROR findings raise
        ProgramVerificationError."""
        from . import analysis
        diags = analysis.analyze_program(
            program, feed_targets=feed_targets, fetch_targets=fetch_targets,
            lint=lint)
        if collect is not None:
            collect.extend(diags)
        if raise_on_error and analysis.has_errors(diags):
            raise analysis.ProgramVerificationError(diags)
        return program


@register_pass("infer_shapes")
class InferShapesPass(Pass):
    """Whole-program shape/dtype propagation with write-back: fills
    Variables whose build-time inference left an empty shape (reference:
    the block-wide InferShape sweep, shape_inference.h:30). Mutates
    declarations, so prepared handles are invalidated by the base-class
    version bump."""

    def apply(self, program, collect=None, **kw):
        from .analysis import infer_program_shapes
        _, diags = infer_program_shapes(program, update=True)
        if collect is not None:
            collect.extend(diags)
        return program
