"""Half-precision inference transpiler.

Mirror of ``paddle_tpu/transpiler/float16_transpiler.py`` (reference:
paddle/contrib/float16/float16_transpiler.py — convert saved f32
weights, rewrite the program's float vars to fp16, insert boundary
casts). The half type defaults to **bfloat16**; float16 is also taken.
Every float32 non-feed variable is re-typed, ops that mint values from a
dtype attr follow, fed float32 inputs are cast at the graph boundary by
an inserted `cast` op, and the scope's parameters are converted in
place: the Program rewrite is the JAX package's, letter for letter.

The parameter conversion is `tensor.to(torch.bfloat16 | torch.float16)`
on the tensor's own device (a card scope keeps every parameter on the
card); like the JAX package's numpy cast it rounds to nearest even, so
the converted parameters equal the JAX package's bit for bit.

On the card, a converted Program's `fused_attention` launches the flash
forward's bf16 instantiation; there is no float16 one, and its wrapper
raises on float16 (ops/flash_attention.py), so a float16 Program with
fused attention runs on the host only. Use on INFERENCE programs (the
result of `io.load_inference_model`); training uses the executor's AMP
policy instead.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import ir

_HALF = {"bfloat16": torch.bfloat16, "float16": torch.float16}


class Float16Transpiler:
    def transpile(self, program=None, place=None, scope=None,
                  dtype="bfloat16"):
        """Rewrite `program` (default main) to half precision in place and
        convert its parameters inside `scope` (default global)."""
        from ..core.executor import global_scope

        if dtype not in _HALF:
            raise ValueError(f"half dtype must be bfloat16 or float16, "
                             f"got {dtype!r}")
        program = program or ir.default_main_program()
        scope = scope or global_scope()
        block = program.global_block()

        # 1. fed data vars keep their f32 dtype; a boundary cast feeds the
        # half-precision graph. Only vars some op actually READS get a
        # cast (an unconditional one would turn ignorable leftover data
        # vars into mandatory feeds), reads inside control-flow
        # sub-blocks included — the scan the executor's read set makes
        read_names = {n for op in block.ops
                      for names in op.inputs.values() for n in names}
        for op in block.ops:
            for si in ir.sub_block_indices(op):
                read_names.update(ir.external_reads(program, si))
        casted = {}
        new_ops = []
        consumed_data = [v for v in block.vars.values()
                         if v.is_data and v.dtype == "float32"
                         and v.name in read_names]
        for v in consumed_data:
            half = block.create_var(name=f"{v.name}.cast_fp16",
                                    shape=v.shape, dtype=dtype,
                                    stop_gradient=True)
            half.lod_level = v.lod_level
            casted[v.name] = half.name
            cast_op = ir.Operator(block, "cast",
                                  inputs={"X": [v.name]},
                                  outputs={"Out": [half.name]},
                                  attrs={"out_dtype": dtype})
            new_ops.append(cast_op)

        # 2. rewrite consumers to read the casted inputs, in EVERY block
        for blk in program.blocks:
            for op in blk.ops:
                for slot, names in op.inputs.items():
                    op.inputs[slot] = [casted.get(n, n) for n in names]

        block.ops[:] = new_ops + block.ops

        # 3. every other float32 var (params and temps) becomes half, in
        # EVERY block, and ops that mint values from a dtype attr
        # (fill_constant, cast, ...) follow suit
        for blk in program.blocks:
            for v in blk.vars.values():
                if v.name in casted or v.is_data:
                    continue
                if v.dtype == "float32":
                    v.dtype = dtype
            for op in blk.ops:
                for key in ("dtype", "out_dtype"):
                    if str(op.attrs.get(key, "")) in ("float32", "fp32"):
                        op.attrs[key] = dtype

        # 4. convert the scope-resident parameters on their own device
        half_t = _HALF[dtype]
        for name in list(scope.local_var_names()):
            var = block.vars.get(name)
            if var is None or var.is_data:
                continue
            val = scope.find_var(name)
            if isinstance(val, np.ndarray) and val.dtype == np.float32:
                val = torch.from_numpy(val)
            if isinstance(val, torch.Tensor) and val.dtype == torch.float32:
                scope.set_var(name, val.to(half_t))

        program._bump()
        return program
