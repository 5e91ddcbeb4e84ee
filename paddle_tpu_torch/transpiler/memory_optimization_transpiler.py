"""Memory optimization (reference:
python/paddle/fluid/transpiler/memory_optimization_transpiler.py —
liveness analysis + var reuse, `memory_optimize` :373, `release_memory`
:392).

Mirror of ``paddle_tpu/transpiler/memory_optimization_transpiler.py``:
`memory_optimize` sets the same ``__remat__`` marks on the same ops, and
on grad ops' ``__fwd_op__`` copies, so a Program marked by either
package is the same JSON. In the JAX package a marked op's grad
recomputes its forward behind an optimization barrier
(paddle_tpu/core/lowering.py), so XLA holds no activation for it. In the
port a mark changes nothing at run time: every
generic grad op already recomputes its forward rule from the forward's
inputs (core/lowering.py), so every op is rematerialized whether marked
or not, and no rule reads the mark. Losses and grads are bit-equal with
and without it (tests/test_torch_transpiler.py, chip_smoke.py phase 7m).
"""

from __future__ import annotations

from ..core import ir

# ops whose outputs are cheap to recompute relative to their activation size
_DEFAULT_REMAT_TYPES = {"relu", "tanh", "sigmoid", "gelu", "softmax",
                        "dropout", "batch_norm", "layer_norm",
                        "elementwise_add", "elementwise_mul", "scale"}

REMAT_ATTR = "__remat__"


def memory_optimize(input_program: ir.Program, skip_opt_set=None,
                    print_log=False, level=0):
    """Mark cheap-to-recompute ops for rematerialization, as the JAX
    package marks them.

    level 0: activations only; level 1: also conv/matmul. The port's grad
    ops recompute every forward already, so the marks keep the Program
    identical to the JAX package's and change no run (module docstring).
    """
    skip = set(skip_opt_set or ())
    types = set(_DEFAULT_REMAT_TYPES)
    if level >= 1:
        types |= {"conv2d", "mul", "matmul"}
    count = 0
    for block in input_program.blocks:
        for op in block.ops:
            if op.type in types and not (set(op.output_arg_names) & skip):
                op.attrs[REMAT_ATTR] = True
                count += 1
            # grad ops carry a deep-copied forward desc (made at backward
            # time); the mark reaches it too, as in the JAX package
            fwd = op.attrs.get("__fwd_op__")
            if fwd is not None and fwd.get("type") in types \
                    and not (set(n for ns in fwd.get("outputs", {}).values()
                                 for n in ns) & skip):
                fwd.setdefault("attrs", {})[REMAT_ATTR] = True
    input_program._bump()
    if print_log:
        print(f"[memory_optimize] marked {count} ops for rematerialization")
    return input_program


def release_memory(input_program: ir.Program, skip_opt_set=None):
    """The reference's `release_memory` inserted delete_var ops. The
    port's executor drops a step's non-persistable env entries when the
    step returns, as the JAX package's does; the Program is returned
    unchanged, for API parity."""
    return input_program
