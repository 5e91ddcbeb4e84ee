"""In-graph gradient quantization for the collective (SPMD) path.

Mirror of ``paddle_tpu/wire/graph.py``: `apply_comm_quant` is copied, the
`comm_quant_dequant` rule is written in torch.

EQuARX (PAPERS.md) quantizes the AllReduce inside XLA; fluid-wire
realizes the same numerics at the IR level: a `comm_quant_dequant` op is
inserted between each gradient and its optimizer op, quantize-
dequantizing the gradient with the abs-max idiom of `ops/quantize.py` —
per-chunk int8 scales or a bf16 round — plus PERSISTENT error feedback
(the residual var rides the program state like an optimizer
accumulator, so quantization noise cancels across steps instead of
accumulating).

Where the quantizer sits under a mesh: the op has no sharded rule, so
the SPMD interpreter (``parallel/spmd.py``) runs it on whole inputs, and
a gradient that is a partial sum over 'dp' is all-reduced at the op's
input instead of at the optimizer's. That is the JAX package's numbers:
GSPMD keeps the single-device semantics, so there too the op quantizes
the whole, all-reduced gradient. The collectives a step issues, their
count and their bytes, are those of the unquantized step.

Scope honesty: this is a QDQ (fake-quant) pass. The op emits float32
grid-valued gradients, so full-precision bytes still cross the
all-reduce — what it delivers is the quantized collective's NUMERICS
(int8/bf16 grid + error feedback, convergence held against the
unquantized run), plus the IR boundary a true quantized collective can
later slot into without touching user programs.

Threaded through two surfaces:

    DistributeTranspilerConfig.comm_quant = "int8"   # sync collective /
                                                     # hybrid dense path
    BuildStrategy.comm_quant = "bf16"                # ParallelExecutor

Both call `apply_comm_quant` below.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core import ir
from ..core.registry import register_op
from .codec import _INT8_BINS, CODECS, DEFAULT_CHUNK, WireCodecError

RESIDUAL_SUFFIX = "@COMM_RES"
QUANT_SUFFIX = "@COMM_QUANT"


@register_op("comm_quant_dequant", propagate_seqlen=False)
def _comm_quant_dequant(ctx, Grad, Residual):
    """Out = dequant(quant(Grad + Residual)); ResidualOut carries the new
    quantization error. The host codec's numpy math step for step
    (wire/codec.py: the int8 per-chunk abs-max scale, the bf16
    round-to-nearest-even), so the two are equal bit for bit. The
    bin count divides as a tensor: torch on the card turns a division by
    a Python number into a product with its float32 reciprocal, which is
    an ulp off numpy's quotient in some chunks. (The JAX package's jitted
    step takes that product, XLA's rewrite of the division: an ulp apart
    from the codec in some elements, tests/test_torch_wire.py.)"""
    codec = ctx.attr("codec", "int8")
    comp = Grad + Residual
    if codec == "bf16":
        deq = comp.to(torch.bfloat16).to(comp.dtype)
    elif codec == "int8":
        chunk = max(int(ctx.attr("chunk", DEFAULT_CHUNK)), 1)
        shape = comp.shape
        flat = comp.reshape(-1)
        n = flat.shape[0]
        pad = (-n) % chunk
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        x = flat.reshape(-1, chunk)
        scale = x.abs().amax(dim=1) / x.new_full((), _INT8_BINS)
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        # through int8, as the codec's payload goes: a -0.0 grid point
        # comes back +0.0
        q = torch.round(torch.clamp(x / safe[:, None], -_INT8_BINS,
                                    _INT8_BINS)).to(torch.int8).to(x.dtype)
        deq = (q * safe[:, None]).reshape(-1)[:n].reshape(shape)
    else:
        raise WireCodecError(
            f"comm_quant_dequant: unknown codec {codec!r}; known "
            f"in-graph codecs: ('int8', 'bf16')")
    return {"Out": deq, "ResidualOut": comp - deq}


def _optimizer_op_types():
    # deferred import: transpiler imports this module to apply the pass
    from ..transpiler.distribute_transpiler import OPTIMIZE_OP_TYPES
    return OPTIMIZE_OP_TYPES


def apply_comm_quant(program: ir.Program, codec: str = "int8",
                     chunk: int = DEFAULT_CHUNK,
                     startup_program: Optional[ir.Program] = None,
                     scope=None) -> List[str]:
    """Rewrite `program` so every dense optimizer op consumes a
    quantize-dequantized gradient with persistent error feedback.

    For each optimizer op in the global block: a persistable residual
    var `<grad>@COMM_RES` (zeros, param-shaped) is created, a
    `comm_quant_dequant` op is inserted just before the optimizer op,
    and the optimizer's Grad input is rewired to `<grad>@COMM_QUANT`.
    Idempotent: already-rewired optimizer ops are skipped.

    The residual must be materialized before the first step:
    `startup_program` (when given) gains a `fill_constant` zero-init per
    residual, and/or `scope` (when given — the ParallelExecutor surface,
    whose startup typically already ran) gets the zeros written directly.

    Returns the list of rewired parameter names.
    """
    if codec in (None, "raw"):
        return []
    if codec not in CODECS or codec == "raw":
        raise WireCodecError(
            f"comm_quant codec must be one of ('int8', 'bf16'), got "
            f"{codec!r}")
    block = program.global_block()
    opt_types = _optimizer_op_types()
    sites = []   # (op index, optimizer op)
    for i, op in enumerate(block.ops):
        if op.type not in opt_types:
            continue
        grads = op.input("Grad")
        if not grads or grads[0].endswith(QUANT_SUFFIX):
            continue   # no grad slot / already rewired
        sites.append((i, op))

    rewired: List[str] = []
    skipped: List[str] = []
    # insert back-to-front so earlier indices stay valid
    for i, op in reversed(sites):
        gname = op.input("Grad")[0]
        pname = op.input("Param")[0]
        pvar = block._find_var_recursive(pname)
        if pvar is None or not pvar.shape or any(d == -1 for d in pvar.shape):
            skipped.append(pname)   # no static shape for the residual
            continue
        shape, dtype = tuple(pvar.shape), pvar.dtype
        res_name = gname + RESIDUAL_SUFFIX
        q_name = gname + QUANT_SUFFIX
        if not block.has_var(res_name):
            block.create_var(name=res_name, shape=shape, dtype=dtype,
                             persistable=True)
        if not block.has_var(q_name):
            block.create_var(name=q_name, shape=shape, dtype=dtype)
        block.insert_op(
            i, "comm_quant_dequant",
            inputs={"Grad": [gname], "Residual": [res_name]},
            outputs={"Out": [q_name], "ResidualOut": [res_name]},
            attrs={"codec": codec, "chunk": int(chunk),
                   "__role__": "optimize"})
        op.inputs["Grad"] = [q_name]
        rewired.append(pname)
        if startup_program is not None:
            sblock = startup_program.global_block()
            if not sblock.has_var(res_name):
                sblock.create_var(name=res_name, shape=shape, dtype=dtype,
                                  persistable=True)
                sblock.append_op(
                    "fill_constant", outputs={"Out": [res_name]},
                    attrs={"shape": list(shape), "dtype": dtype,
                           "value": 0.0})
        if scope is not None and scope.find_var(res_name) is None:
            scope.set_var(res_name, np.zeros(shape, dtype=dtype))
    if rewired:
        program._bump()
    already = any(
        op.type in opt_types and op.input("Grad")
        and op.input("Grad")[0].endswith(QUANT_SUFFIX)
        for op in block.ops)
    if skipped or not (rewired or already):
        # a requested-but-inactive quantizer must not be silent: the user
        # believes gradients quantize while they travel full-precision
        import warnings
        what = (f"params without static shapes skipped: "
                f"{sorted(skipped)}" if skipped
                else "no dense optimizer op with a gradient found")
        scope_word = "partially" if (rewired or already) else "entirely"
        warnings.warn(
            f"comm_quant={codec!r} is {scope_word} inactive — {what}; "
            f"the affected gradients stay full-precision",
            RuntimeWarning, stacklevel=2)
    return list(reversed(rewired))
