"""Program IR: Variable / Operator / Block / Program.

Copy of ``paddle_tpu/core/ir.py`` with the JSON format unchanged, so this
package loads the model dirs and programs the JAX package saved, and the
reverse. The meaning of an op is its registered PyTorch rule
(``core/registry.py``); the executor interprets a block op by op.
"""

from __future__ import annotations

import copy
import itertools
import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

from . import types
from .types import VarKind

# Name suffix conventions shared with the reference's autodiff
# (reference: python/paddle/fluid/backward.py — `var@GRAD` naming).
GRAD_SUFFIX = "@GRAD"
# Companion variable carrying per-row sequence lengths for variable-length
# (LoD-analog) tensors: padded dense data + `name@SEQLEN` int32[batch].
SEQLEN_SUFFIX = "@SEQLEN"
# fluid-decode: persistable-but-ephemeral device STATE (the paged KV
# cache). Rides the scope like an optimizer accumulator but is never
# serialized: io save/load predicates skip the suffix, and the serving
# registry re-materializes zeros of the manifest-declared shape at load.
KV_CACHE_SUFFIX = "@KV_CACHE"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


def seqlen_var_name(name: str, level: int = 0) -> str:
    """Companion name for the lengths of LoD level `level` (0 = outermost).
    Level 0 keeps the historical bare suffix; deeper levels append the
    level index (nested LoD: data [B, S, T, ...] has `@SEQLEN` = [B] outer
    counts and `@SEQLEN.1` = [B, S] inner lengths)."""
    return name + SEQLEN_SUFFIX + (f".{level}" if level else "")


class Variable:
    """A named value in a Block (reference framework.py:130 `Variable`).

    ``shape`` may contain -1 for dimensions unknown until runtime (batch).
    ``lod_level > 0`` marks a variable-length sequence tensor: at runtime it is
    a padded dense array plus a `@SEQLEN` companion with true row lengths.
    """

    def __init__(
        self,
        block: "Block",
        name: str,
        shape: Sequence[int] = (),
        dtype: str = "float32",
        kind: VarKind = VarKind.DENSE_TENSOR,
        lod_level: int = 0,
        persistable: bool = False,
        stop_gradient: bool = False,
        is_data: bool = False,
    ):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.dtype = types.canonical_dtype(dtype)
        self.kind = kind
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data

    # ---- operator sugar (reference: layers/math_op_patch.py) is attached in
    # layers/math_op_patch.py to avoid a core->layers dependency.

    @property
    def grad_name(self) -> str:
        return grad_var_name(self.name)

    def astype(self, dtype):
        from ..layers import nn as _nn  # local import: layer sugar

        return _nn.cast(self, dtype)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "shape": list(self.shape),
            "dtype": self.dtype,
            "kind": self.kind.value,
            "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
            "is_parameter": isinstance(self, Parameter),
            "trainable": getattr(self, "trainable", None),
            "optimize_attr": getattr(self, "optimize_attr", None),
            "sharding": list(s) if (s := getattr(self, "sharding", None)) else None,
        }

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype}, lod={self.lod_level})")


class Parameter(Variable):
    """A trainable persistable variable (reference framework.py:1759)."""

    def __init__(self, block, name, shape, dtype, trainable=True,
                 regularizer=None, gradient_clip=None, is_distributed=False,
                 sharding=None, **kw):
        kw.setdefault("persistable", True)
        super().__init__(block, name, shape, dtype, **kw)
        self.trainable = trainable
        self.regularizer = regularizer
        self.gradient_clip = gradient_clip
        self.is_distributed = is_distributed
        # Optional PartitionSpec-like tuple; kept for the shared JSON format.
        self.sharding = sharding


# Package root for trimming creation tracebacks: frames inside the
# framework are plumbing, the first frames OUTSIDE it are where the user
# actually built the op (the reference stored the same thing as the
# `op_callstack` attr on every OpDesc).
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep


def _creation_site(max_frames: int = 2) -> Optional[List[str]]:
    """Innermost non-framework frames of the current stack, formatted
    `file:line in func`. Walks raw frame objects (no source loading), so
    the per-op build cost is a few µs."""
    try:
        f = sys._getframe(2)
    except ValueError:  # pragma: no cover - shallow stack
        return None
    site: List[str] = []
    depth = 0
    while f is not None and len(site) < max_frames and depth < 32:
        fn = f.f_code.co_filename
        if not fn.startswith(_PKG_DIR):
            site.append(f"{fn}:{f.f_lineno} in {f.f_code.co_name}")
        f = f.f_back
        depth += 1
    return site or None


class Operator:
    """One op invocation (reference framework.py:418 / op_desc.h:29).

    inputs/outputs map slot name -> list of variable names. attrs must be
    JSON-serializable (sub-blocks are referenced by block index, as in the
    reference's BlockDesc attr).
    """

    def __init__(self, block: "Block", type: str,
                 inputs: Optional[Dict[str, Any]] = None,
                 outputs: Optional[Dict[str, Any]] = None,
                 attrs: Optional[Dict[str, Any]] = None,
                 capture_site: bool = True):
        self.block = block
        self.type = type
        self.inputs = {k: _as_name_list(v) for k, v in (inputs or {}).items() if v is not None}
        self.outputs = {k: _as_name_list(v) for k, v in (outputs or {}).items() if v is not None}
        self.attrs = dict(attrs or {})
        # trimmed creation traceback for diagnostics (analysis/): not
        # serialized — a JSON round-trip yields ops with no site, and the
        # verifier falls back to (block, op index) provenance
        self._creation_site = _creation_site() if capture_site else None

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "type": self.type,
            "inputs": {k: list(v) for k, v in self.inputs.items()},
            "outputs": {k: list(v) for k, v in self.outputs.items()},
            "attrs": copy.deepcopy(self.attrs),
        }

    def __repr__(self):
        return f"Operator({self.type}: {self.inputs} -> {self.outputs})"


def _as_name_list(v) -> List[str]:
    if isinstance(v, (list, tuple)):
        return [x.name if isinstance(x, Variable) else str(x) for x in v]
    return [v.name if isinstance(v, Variable) else str(v)]


class Block:
    """An ordered op list + var table, possibly nested (reference block_desc.h:38)."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    # -- var management -------------------------------------------------
    def create_var(self, name=None, **kw) -> Variable:
        if name is None:
            from .. import unique_name
            name = unique_name.generate("tmp")
        v = Variable(self, name=name, **kw)
        self.vars[name] = v
        self.program._bump()
        return v

    def create_parameter(self, name, shape, dtype, **kw) -> Parameter:
        p = Parameter(self, name, shape, dtype, **kw)
        self.vars[name] = p
        self.program._bump()
        return p

    def var(self, name: str) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise KeyError(f"variable {name!r} not found in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        blk: Optional[Block] = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = self.program.blocks[blk.parent_idx] if blk.parent_idx >= 0 else None
        return None

    @property
    def parent(self) -> Optional["Block"]:
        return self.program.blocks[self.parent_idx] if self.parent_idx >= 0 else None

    # -- op management --------------------------------------------------
    def append_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump()
        return op

    def prepend_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        self.program._bump()
        return op

    def insert_op(self, index: int, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self.program._bump()
        return op

    def remove_op(self, index: int):
        del self.ops[index]
        self.program._bump()

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }

    def __repr__(self):
        return f"Block(idx={self.idx}, ops={len(self.ops)}, vars={len(self.vars)})"


class Program:
    """A list of nested blocks; block 0 is global (reference framework.py:1249).

    `_version` increments on any mutation so executors can cache compiled
    lowerings per (program, version).
    """

    _uid_counter = itertools.count()

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self._current_block_idx = 0
        self._version = 0
        # process-unique id for executor cache keys: id() can be recycled
        # after GC and serve a stale compiled step
        self._uid = next(Program._uid_counter)
        self._seed: Optional[int] = None  # random_seed analog
        self._is_inference = False

    def _bump(self):
        self._version += 1

    # -- block management ------------------------------------------------
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    def _create_block(self, parent_idx: Optional[int] = None) -> Block:
        parent = self._current_block_idx if parent_idx is None else parent_idx
        blk = Block(self, len(self.blocks), parent_idx=parent)
        self.blocks.append(blk)
        self._current_block_idx = blk.idx
        self._bump()
        return blk

    def _rollback(self):
        self._current_block_idx = self.current_block().parent_idx

    @property
    def random_seed(self):
        return self._seed

    @random_seed.setter
    def random_seed(self, seed):
        self._seed = seed
        self._bump()

    # -- cloning / pruning (reference framework.py Program.clone/_prune) --
    def clone(self, for_test: bool = False) -> "Program":
        p = Program.from_dict(self.to_dict())
        p._seed = self._seed
        # Re-attach non-serializable Parameter metadata (regularizer /
        # gradient_clip are python objects; JSON round-trip drops them).
        for src_blk, dst_blk in zip(self.blocks, p.blocks):
            for name, src in src_blk.vars.items():
                dst = dst_blk.vars.get(name)
                if isinstance(src, Parameter) and isinstance(dst, Parameter):
                    dst.regularizer = src.regularizer
                    dst.gradient_clip = src.gradient_clip
                    dst.sharding = src.sharding
                    dst.trainable = src.trainable
                    dst.is_distributed = src.is_distributed
                    if hasattr(src, "optimize_attr"):
                        dst.optimize_attr = dict(src.optimize_attr)
        if for_test:
            p._set_inference_mode()
        return p

    def _set_inference_mode(self):
        """Flip train-only attrs (dropout/batch_norm `is_test`) and drop
        backward/optimize-role ops for eval clones (the reference strips by
        OpRole the same way, framework.py clone/_inference_optimize —
        without this, pruning an inference slice chases a parameter to its
        optimizer op's ParamOut and drags the whole training graph back in)."""
        self._is_inference = True
        for blk in self.blocks:
            blk.ops = [op for op in blk.ops
                       if op.attrs.get("__role__") not in ("backward",
                                                           "optimize")]
            for op in blk.ops:
                if "is_test" in op.attrs:
                    op.attrs["is_test"] = True
        self._bump()

    def _prune(self, targets: Sequence[str]) -> "Program":
        """Backward-slice the global block to ops needed for `targets`
        (reference: framework/prune.cc:181). A kept control-flow op keeps
        its whole sub-block tree, and the sub-blocks' external reads join
        the needed set — otherwise a While/StaticRNN body's producers in
        the global block would be mis-pruned."""
        p = self.clone()
        blk = p.global_block()
        needed = set(targets)
        keep: List[Operator] = []
        for op in reversed(blk.ops):
            if needed & set(op.output_arg_names) or op.type in ("feed", "fetch"):
                keep.append(op)
                needed |= set(op.input_arg_names)
                for si in sub_block_indices(op):
                    needed |= set(external_reads(p, si))
        blk.ops = list(reversed(keep))
        used = {n for op in blk.ops for n in op.input_arg_names + op.output_arg_names}
        for op in blk.ops:
            for si in sub_block_indices(op):
                used |= set(external_reads(p, si))
        blk.vars = {k: v for k, v in blk.vars.items() if k in used or v.persistable}
        p._bump()
        return p

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"version": 1, "blocks": [b.to_dict() for b in self.blocks]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Program":
        p = cls()
        p.blocks = []
        for bd in d["blocks"]:
            blk = Block(p, bd["idx"], bd["parent_idx"])
            for vd in bd["vars"]:
                vcls = Parameter if vd.get("is_parameter") else Variable
                kw = dict(shape=vd["shape"], dtype=vd["dtype"],
                          kind=VarKind(vd["kind"]), lod_level=vd["lod_level"],
                          persistable=vd["persistable"],
                          stop_gradient=vd["stop_gradient"])
                if vcls is Variable:
                    kw["is_data"] = vd.get("is_data", False)
                v = vcls(blk, vd["name"], **kw)
                if vcls is Parameter:
                    if vd.get("trainable") is not None:
                        v.trainable = vd["trainable"]
                    if vd.get("optimize_attr") is not None:
                        v.optimize_attr = vd["optimize_attr"]
                    if vd.get("sharding") is not None:
                        v.sharding = tuple(vd["sharding"])
                blk.vars[vd["name"]] = v
            for od in bd["ops"]:
                # capture_site=False: a deserialized op was not built here
                # — a captured site would point at whoever called
                # from_dict, which is noise (and a wasted frame walk/op)
                blk.ops.append(Operator(blk, od["type"], od["inputs"],
                                        od["outputs"], od["attrs"],
                                        capture_site=False))
            p.blocks.append(blk)
        p._current_block_idx = 0
        return p

    def serialize_to_string(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def parse_from_string(cls, s: str) -> "Program":
        return cls.from_dict(json.loads(s))

    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    def __repr__(self):
        lines = []
        for blk in self.blocks:
            lines.append(f"-- block {blk.idx} (parent {blk.parent_idx}) --")
            for op in blk.ops:
                lines.append(f"  {op}")
        return "\n".join(lines)


def sub_block_indices(op: Operator) -> List[int]:
    """Block indices referenced by a control-flow op's attrs."""
    out = []
    for key in ("sub_block", "else_block"):
        idx = op.attrs.get(key, -1)
        if isinstance(idx, int) and idx >= 0:
            out.append(idx)
    return out


def external_reads(program: "Program", block_idx: int) -> List[str]:
    """Variable names a block (and its nested blocks) reads from enclosing
    scopes: not block-local and not produced by an earlier op in the block.
    Used by executors for state analysis and by control-flow layers to
    declare data dependencies."""
    block = program.blocks[block_idx]
    produced: set = set()
    reads: List[str] = []
    for op in block.ops:
        in_names = list(op.input_arg_names)
        for si in sub_block_indices(op):
            in_names += external_reads(program, si)
        for n in in_names:
            if n in produced or n in block.vars or n in reads:
                continue
            reads.append(n)
        produced.update(op.output_arg_names)
    return reads


# ---------------------------------------------------------------------------
# Default program singletons + guards (reference framework.py:1843-1959).
# ---------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(program: Program) -> Program:
    global _main_program
    prev, _main_program = _main_program, program
    return prev


def switch_startup_program(program: Program) -> Program:
    global _startup_program
    prev, _startup_program = _startup_program, program
    return prev


class program_guard:
    """`with program_guard(main, startup):` context (reference framework.py:1911)."""

    def __init__(self, main_program: Program, startup_program: Optional[Program] = None):
        self._main = main_program
        self._startup = startup_program

    def __enter__(self):
        self._prev_main = switch_main_program(self._main)
        if self._startup is not None:
            self._prev_startup = switch_startup_program(self._startup)
        return self

    def __exit__(self, *exc):
        switch_main_program(self._prev_main)
        if self._startup is not None:
            switch_startup_program(self._prev_startup)
        return False
