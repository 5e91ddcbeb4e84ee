"""Small graphviz dot-building library (a copy of
``paddle_tpu/graphviz.py``; reference
python/paddle/fluid/graphviz.py: Graph/Node/Edge/Rank +
GraphPreviewGenerator). Pure text generation — rendering shells out to
`dot` only if present; `show()` always writes the .dot source so the
capability works where graphviz is not installed."""

from __future__ import annotations

import subprocess


def crepr(v):
    return f'"{v}"' if isinstance(v, str) else repr(v)


class Rank:
    def __init__(self, kind, name, priority):
        if kind not in ("source", "sink", "same", "min", "max"):
            raise ValueError(f"invalid rank kind {kind!r}")
        self.kind = kind
        self.name = name
        self.priority = priority
        self.nodes = []

    def __str__(self):
        if not self.nodes:
            return ""
        return "{" + f"rank={self.kind};" + ",".join(
            n.name for n in self.nodes) + "}"


class Node:
    counter = 1

    def __init__(self, label, prefix, description="", **attrs):
        self.label = label
        self.name = "%s_%d" % (prefix, Node.counter)
        Node.counter += 1
        self.description = description
        self.attrs = attrs

    def __str__(self):
        attrs = ",".join(f"{k}={crepr(v)}" for k, v in
                         ({"label": self.label, **self.attrs}).items())
        return f"{self.name} [{attrs}]"


class Edge:
    def __init__(self, source, target, **attrs):
        self.source = source
        self.target = target
        self.attrs = attrs

    def __str__(self):
        attrs = ",".join(f"{k}={crepr(v)}" for k, v in self.attrs.items())
        return f"{self.source.name}->{self.target.name}" + (
            f" [{attrs}]" if attrs else "")


class Graph:
    rank_counter = 0

    def __init__(self, title, **attrs):
        self.title = title
        self.attrs = attrs
        self.nodes = []
        self.edges = []
        self.rank_groups = {}

    def code(self):
        return self.__str__()

    def rank_group(self, kind, priority):
        name = f"rankgroup-{Graph.rank_counter}"
        Graph.rank_counter += 1
        self.rank_groups[name] = Rank(kind, name, priority)
        return name

    def node(self, label, prefix, description="", **attrs):
        node = Node(label, prefix, description, **attrs)
        if "rank" in attrs:
            self.rank_groups[attrs.pop("rank")].nodes.append(node)
            node.attrs.pop("rank", None)
        self.nodes.append(node)
        return node

    def edge(self, source, target, **attrs):
        edge = Edge(source, target, **attrs)
        self.edges.append(edge)
        return edge

    def compile(self, dot_path):
        """Write dot source; render a PDF beside it when `dot` exists."""
        with open(dot_path, "w") as f:
            f.write(self.code())
        out = dot_path.rsplit(".", 1)[0] + ".pdf"
        try:
            subprocess.run(["dot", "-Tpdf", dot_path, "-o", out],
                           check=True, capture_output=True)
            return out
        except (OSError, subprocess.CalledProcessError):
            return dot_path

    def show(self, dot_path):
        return self.compile(dot_path)

    def _rank_repr(self):
        return "\n".join(str(g) for g in
                         sorted(self.rank_groups.values(),
                                key=lambda x: x.priority))

    def __str__(self):
        name = "".join(c if c.isalnum() or c == "_" else "_"
                       for c in str(self.title)) or "G"
        lines = [f"digraph {name} {{"]
        lines += [f"{k}={crepr(v)};" for k, v in self.attrs.items()]
        lines += [str(n) for n in self.nodes]
        lines += [str(e) for e in self.edges]
        rank = self._rank_repr()
        if rank:
            lines.append(rank)
        lines.append("}")
        return "\n".join(lines)


class GraphPreviewGenerator:
    """Convenience wrapper for op/param/data-node styling (reference
    graphviz.py:179)."""

    def __init__(self, title):
        self.graph = Graph(title)

    def add_param(self, name, data_type, highlight=False):
        return self.graph.node(
            f"{name}\\n{data_type}", prefix="param", shape="box",
            style="filled",
            fillcolor="yellow" if highlight else "lightgray")

    def add_op(self, opType, **kwargs):
        return self.graph.node(opType, prefix="op", shape="ellipse",
                               style="filled", fillcolor="lightblue",
                               **kwargs)

    def add_arg(self, name, highlight=False):
        return self.graph.node(name, prefix="arg", shape="box",
                               fillcolor="orange" if highlight else "white",
                               style="filled")

    def add_edge(self, source, target, **kwargs):
        return self.graph.edge(source, target, **kwargs)

    def __call__(self, path, show=False):
        if show:
            return self.graph.show(path)
        return self.graph.compile(path)
