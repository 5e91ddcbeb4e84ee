"""Draw a Program's op graph as graphviz dot (a copy of
``paddle_tpu/net_drawer.py``; reference
python/paddle/fluid/net_drawer.py draw_graph/parse_graph). Walks the IR
directly instead of the reference's protobuf-to-json round trip."""

from __future__ import annotations

import argparse
import logging

from .core import ir
from .graphviz import Graph

logger = logging.getLogger(__name__)

OP_STYLE = {"shape": "ellipse", "style": "filled", "fillcolor": "lightblue"}
VAR_STYLE = {"shape": "box", "style": "rounded"}

def parse_graph(program, graph, var_dict):
    """Append `program`'s global-block ops + data-flow edges to `graph`."""
    for op in program.global_block().ops:
        op_node = graph.node(op.type, prefix="op", **OP_STYLE)
        for slot, names in op.inputs.items():
            for name in names:
                if name not in var_dict:
                    var_dict[name] = graph.node(name, prefix="var",
                                                **VAR_STYLE)
                graph.edge(var_dict[name], op_node, label=slot)
        for slot, names in op.outputs.items():
            for name in names:
                if name not in var_dict:
                    var_dict[name] = graph.node(name, prefix="var",
                                                **VAR_STYLE)
                graph.edge(op_node, var_dict[name], label=slot)
    return graph


def draw_graph(startup_program, main_program, **kwargs):
    """Render both programs into one dot graph; returns the Graph (and
    writes `filename` when given — reference draw_graph contract).
    `graph_attr` dict entries become dot graph attributes."""
    graph_attr = dict(kwargs.pop("graph_attr", {}) or {})
    filename = kwargs.pop("filename", None) or graph_attr.pop("filename",
                                                              None)
    graph_attr.setdefault("rankdir", "TB")
    graph = Graph("ProgramDesc", **graph_attr)
    var_dict = {}
    parse_graph(startup_program, graph, var_dict)
    parse_graph(main_program, graph, var_dict)
    if filename:
        graph.compile(filename)
    return graph


def main():
    parser = argparse.ArgumentParser(description="draw the default program")
    parser.add_argument("--output", default="program.dot")
    args = parser.parse_args()
    g = draw_graph(ir.default_startup_program(), ir.default_main_program())
    g.compile(args.output)
    logger.info("wrote %s", args.output)


if __name__ == "__main__":
    main()
