"""Program visualization and pretty-printing.

Capability parity with the reference's debugger (reference:
python/paddle/fluid/debugger.py — pprint_program_codes :102,
draw_block_graphviz :219, which renders a BlockDesc to graphviz via the
fluid.graphviz helper). Same two entry points over the dataclass IR:

- ``pprint_program_codes(program)`` — pseudo-code listing, one line per op
  (``out1, out2 = op_type(in1, in2, attr=..)``), forward/backward split.
- ``draw_block_graphviz(block, highlights, path)`` — DOT text with op nodes
  (boxes) and var nodes (ellipses), edges for dataflow; renders with the
  ``dot`` binary when available, otherwise leaves the .dot file.

A copy of ``paddle_tpu/debugger.py`` over this package's ``core/ir.py``."""

from __future__ import annotations

import re
import shutil
import subprocess
from typing import Optional, Sequence

from .core import ir

__all__ = ["pprint_program_codes", "pprint_block_codes",
           "draw_block_graphviz"]


def _repr_attr(v):
    if isinstance(v, float):
        return f"{v:g}"
    if isinstance(v, str):
        return repr(v)
    if isinstance(v, (list, tuple)) and len(v) > 6:
        return f"[{len(v)} items]"
    return repr(v)


def _repr_op(op: ir.Operator) -> str:
    outs = ", ".join(op.output_arg_names) or "_"
    ins = ", ".join(op.input_arg_names)
    attrs = ", ".join(f"{k}={_repr_attr(v)}" for k, v in sorted(op.attrs.items())
                      if not k.startswith("__"))
    arg = ins if not attrs else (f"{ins}, {attrs}" if ins else attrs)
    return f"{outs} = {op.type}({arg})"


def pprint_block_codes(block: ir.Block, show_backward: bool = False) -> str:
    """One pseudo-code line per op (reference pprint_block_codes :111)."""
    lines = [f"# block {block.idx}"]
    for op in block.ops:
        is_bwd = op.type.endswith("_grad") or "@GRAD" in " ".join(
            op.output_arg_names)
        if is_bwd and not show_backward:
            continue
        lines.append("  " + _repr_op(op))
    return "\n".join(lines) + "\n"


def pprint_program_codes(program: ir.Program, show_backward: bool = False) -> str:
    return "".join(pprint_block_codes(b, show_backward)
                   for b in program.blocks)


def _dot_id(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_]", "_", name)


def draw_block_graphviz(block: ir.Block,
                        highlights: Optional[Sequence[str]] = None,
                        path: str = "./temp.dot") -> str:
    """Write a DOT dataflow graph of `block` (reference :219). Ops are
    boxes, variables ellipses; `highlights` are regex patterns whose
    matching var nodes turn red. If the `dot` binary exists, also renders
    `<path>.pdf`. Returns the DOT text."""
    pats = [re.compile(p) for p in (highlights or [])]

    def hl(name):
        return any(p.search(name) for p in pats)

    lines = ["digraph G {", "  rankdir=TB;"]
    vars_seen = set()

    def var_node(name):
        if name in vars_seen:
            return
        vars_seen.add(name)
        v = block._find_var_recursive(name) if hasattr(block, "_find_var_recursive") \
            else block.vars.get(name)
        label = name
        if v is not None and getattr(v, "shape", None) is not None:
            label += "\\n" + "x".join(str(d) for d in v.shape)
        color = "red" if hl(name) else ("lightblue" if isinstance(
            v, ir.Parameter) else "white")
        lines.append(f'  v_{_dot_id(name)} [label="{label}" shape=ellipse '
                     f'style=filled fillcolor={color}];')

    for i, op in enumerate(block.ops):
        lines.append(f'  op_{i} [label="{op.type}" shape=box style=filled '
                     f'fillcolor=gold];')
        for n in op.input_arg_names:
            var_node(n)
            lines.append(f"  v_{_dot_id(n)} -> op_{i};")
        for n in op.output_arg_names:
            var_node(n)
            lines.append(f"  op_{i} -> v_{_dot_id(n)};")
    lines.append("}")
    dot = "\n".join(lines) + "\n"
    with open(path, "w") as f:
        f.write(dot)
    if shutil.which("dot"):
        try:
            subprocess.run(["dot", "-Tpdf", path, "-o", path + ".pdf"],
                           check=False, timeout=30)
        except Exception:
            pass
    return dot
