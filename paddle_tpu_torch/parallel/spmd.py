"""SPMD execution of one Program over a mesh of ranks: what GSPMD does for
the JAX package, done explicitly.

The JAX package compiles the single-device Program once under a
`jax.sharding.Mesh`; GSPMD partitions it and inserts the collectives. The
port has no partitioning compiler, so each rank interprets the Program on
its own shards and this module decides, op by op, what each rank holds
and which collectives keep the result the single-device Program's.

**Placements.** Every var has one entry per mesh axis: `R` (every rank of
the axis holds it whole), an int `d` (split along dim d, rank i of the
axis holding the i-th equal block), `P` (a partial sum: the value is the
sum over the axis's ranks) or `OPAQUE` (a layout no rule can name, such
as `layer_norm`'s per-row statistics under a sequence split: reading it
raises). Feeds, parameters (`ParamAttr.sharding`, `sharding_rules`, the
`Reduce` strategy) and their optimizer state start the pass.

**Rules.** A sharded rule (`RULES`) takes the placements and global
shapes of an op's inputs and says which placements it runs on and which
its outputs get; the executor converts each input first (`convert`):
all-reduce of a `P`, all-gather of a split, a local slice for `R` to a
split, rank-0-keeps for `R` to `P`. An op with no rule runs on whole
(`R`) inputs, correct by construction and only slower; the plan names
it. Decisions read shapes and placements only, so every rank plans the
same collectives in the same order, once per (program version, feed
signature, fetch set).

**Grads.** A grad var's placement is the dual of its forward var's: a
split stays a split, a whole var's grad is a partial sum (each rank's
contribution) and a partial var's grad is whole. A generic grad op runs
the forward rule again under autograd from this rank's stored shards,
through the same conversions as differentiable collectives whose
backwards are the transposed collectives (all-gather <-> reduce-scatter,
slice <-> zero-pad, all-reduce <-> all-reduce, the ring shift <-> the
shift the other way), so `mean`'s grad is 1 / N_global, a weight's grad
over a split batch is a partial sum that the optimizer's rule all-reduces,
and a `mp`-split weight gathered for its product gets its grad
reduce-scattered back. The loss's seed grad, whole on every rank, becomes
a partial sum by rank-0-keeps: the ranks that share a replicated
computation add zeros, so their sums stay exact.

**Collectives** go over the mesh axis's process group and are counted by
kind and bytes in `collectives` (``ops/native.py::launches``' manner).
Under gloo a CUDA tensor is staged through pinned host memory (gloo
takes CPU tensors), and bf16 travels as its int16 bits (or is added in
float32 and rounded once, for a sum).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List

import torch
import torch.distributed as dist

from ..core import ir, registry
from ..core.lowering import (_check_finite, _declared_by_base,
                             _propagate_seqlen, op_seed)
from ..core.registry import (EMPTY_VAR, FWD_OP_ATTR, GRAD_OP_SUFFIX,
                             LoweringContext)

R = None
P = "P"
OPAQUE = "X"

_lock = threading.Lock()
# collective kind -> count / bytes sent into it by this rank
collectives: Dict[str, int] = {}
collective_bytes: Dict[str, int] = {}


def reset_collectives():
    with _lock:
        collectives.clear()
        collective_bytes.clear()


class _Recorder:
    # the plan entry of the op being run; not thread-local: autograd runs
    # a CUDA backward (the transposed collectives) on a thread of its own
    entry = None


_recorder = _Recorder()


def _count(kind: str, axis: str, t: torch.Tensor):
    n = t.numel() * t.element_size()
    with _lock:
        collectives[kind] = collectives.get(kind, 0) + 1
        collective_bytes[kind] = collective_bytes.get(kind, 0) + n
    if _recorder.entry is not None:
        _recorder.entry.colls.append((kind, axis, n))


# ---------------------------------------------------------------------------
# raw collectives on one mesh axis (no autograd)
# ---------------------------------------------------------------------------

def _gloo() -> bool:
    return dist.is_initialized() and dist.get_backend() == "gloo"


def _to_wire(t: torch.Tensor):
    """(tensor gloo/NCCL can move, how to restore it): a CUDA tensor under
    gloo is staged through pinned host memory; bf16 moves as int16."""
    t = t.contiguous()
    wire = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    if wire.is_cuda and _gloo():
        host = torch.empty(wire.shape, dtype=wire.dtype, pin_memory=True)
        host.copy_(wire)
        wire = host

    def back(w):
        w = w.to(t.device) if w.device != t.device else w
        return w.view(torch.bfloat16) if t.dtype == torch.bfloat16 else w
    return wire, back


def all_reduce(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum over the axis's ranks (a new tensor)."""
    _count("all-reduce", axis, t)
    work = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
    wire, back = _to_wire(work.clone())
    dist.all_reduce(wire, group=mesh.group(axis))
    out = back(wire)
    return out.to(t.dtype) if out.dtype != t.dtype else out


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Concatenate the axis's shards along `dim`."""
    _count("all-gather", axis, t)
    wire, back = _to_wire(t)
    parts = [torch.empty_like(wire) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, wire, group=mesh.group(axis))
    return torch.cat([back(p) for p in parts], dim=dim)


def _block(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block of `t` along `dim` (a copy)."""
    n = mesh.shape[axis]
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split "
                         f"over the {n}-way {axis!r} mesh axis")
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.index(axis) * size, size).clone()


def reduce_scatter(t: torch.Tensor, mesh, axis: str,
                   dim: int) -> torch.Tensor:
    """Sum over the axis's ranks, this rank keeping its block along `dim`
    (gloo has no reduce-scatter: a sum, then the block)."""
    _count("reduce-scatter", axis, t)
    work = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
    wire, back = _to_wire(work.clone())
    dist.all_reduce(wire, group=mesh.group(axis))
    out = back(wire)
    out = out.to(t.dtype) if out.dtype != t.dtype else out
    return _block(out, mesh, axis, dim)


def shift(t: torch.Tensor, mesh, axis: str, step: int = 1) -> torch.Tensor:
    """Send `t` to the rank `step` ahead on the axis's ring, receive the
    one from `step` behind: a paired isend / irecv, so no rank waits on
    another's receive (the JAX package's `ppermute`)."""
    _count("collective-permute", axis, t)
    peers, n, i = mesh.peers(axis), mesh.shape[axis], mesh.index(axis)
    wire, back = _to_wire(t)
    got = torch.empty_like(wire)
    ops = [dist.P2POp(dist.isend, wire, peers[(i + step) % n]),
           dist.P2POp(dist.irecv, got, peers[(i - step) % n])]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return back(got)


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """The world's rank-`src` value of `t` (Fluid's BCastParamsToDevices)."""
    _count("broadcast", "world", t)
    wire, back = _to_wire(t.clone())
    dist.broadcast(wire, src=src)
    return back(wire)


# ---------------------------------------------------------------------------
# differentiable collectives: each backward is the transposed collective
# ---------------------------------------------------------------------------

class _AllReduce(torch.autograd.Function):
    """P -> R; its cotangent is a partial sum, made whole the same way."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    """split -> R; backward reduce-scatters the partial-sum cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None,
                None)


class _Slice(torch.autograd.Function):
    """R -> split; backward zero-pads the block: a partial sum."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.full = mesh, axis, dim, x.shape
        return _block(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _pad(g, ctx.mesh, ctx.axis, ctx.dim, ctx.full), None, None, None


class _ReduceScatter(torch.autograd.Function):
    """P -> split; backward all-gathers the split cotangent (whole)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _KeepFirst(torch.autograd.Function):
    """R -> P: rank 0 of the axis keeps the value, the others zeros; its
    backward is the same map on the whole cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _keep_first(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _keep_first(g, ctx.mesh, ctx.axis), None, None


class _Pad(torch.autograd.Function):
    """split -> P: the block in place in zeros; backward takes the block."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, full):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _pad(x, mesh, axis, dim, full)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None, None


class _RingShift(torch.autograd.Function):
    """The ring shift; its backward shifts the cotangent the other way."""

    @staticmethod
    def forward(ctx, x, mesh, axis, step):
        ctx.mesh, ctx.axis, ctx.step = mesh, axis, step
        return shift(x, mesh, axis, step)

    @staticmethod
    def backward(ctx, g):
        return shift(g, ctx.mesh, ctx.axis, -ctx.step), None, None, None


def _keep_first(x, mesh, axis):
    return x.clone() if mesh.index(axis) == 0 else torch.zeros_like(x)


def _pad(x, mesh, axis, dim, full):
    out = x.new_zeros(full)
    size = x.shape[dim]
    out.narrow(dim, mesh.index(axis) * size, size).copy_(x)
    return out


def ring_shift(t, mesh, axis: str, step: int = 1):
    """Differentiable ring shift (used by ring attention)."""
    return _RingShift.apply(t, mesh, axis, step)


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

def replicated(n: int):
    return (R,) * n


def dual(pl):
    """A grad's placement from its forward var's."""
    return tuple(P if p is R else (R if p == P else p) for p in pl)


def global_shape(local, pl, mesh):
    shape = list(local)
    for a, p in zip(mesh.axis_names, pl):
        if isinstance(p, int):
            shape[p] *= mesh.shape[a]
    return tuple(shape)


def origin(local, pl, mesh):
    """(global shape, offsets) of a shard, or None when nothing splits it."""
    if not any(isinstance(p, int) for p in pl):
        return None
    offs = [0] * len(local)
    for a, p in zip(mesh.axis_names, pl):
        if isinstance(p, int):
            offs[p] += mesh.index(a) * local[p]
    return global_shape(local, pl, mesh), tuple(offs)


def fmt(pl, mesh) -> str:
    parts = []
    for a, p in zip(mesh.axis_names, pl):
        if p is R:
            continue
        parts.append(f"{a}:" + ("P" if p == P else "?" if p == OPAQUE
                                else f"S{p}"))
    return "{" + ",".join(parts) + "}"


def convert(t, src, dst, mesh, diff: bool):
    """`t` held at placement `src` as it is held at `dst`, axis by axis;
    `diff` uses the differentiable collectives."""
    if src == dst:
        return t
    for ax, a in enumerate(mesh.axis_names):
        s, d = src[ax], dst[ax]
        if s == d or mesh.shape[a] == 1:    # one rank holds it all
            continue
        if s == OPAQUE:
            raise NotImplementedError(
                f"a var split over {a!r} in a layout no rule names is read "
                f"by an op that needs it whole")
        if isinstance(s, int) and isinstance(d, int):
            t = _AllGather.apply(t, mesh, a, s) if diff \
                else all_gather(t, mesh, a, s)
            s = R
        if s == P and d is R:
            t = _AllReduce.apply(t, mesh, a) if diff \
                else all_reduce(t, mesh, a)
        elif s == P:
            t = _ReduceScatter.apply(t, mesh, a, d) if diff \
                else reduce_scatter(t, mesh, a, d)
        elif isinstance(s, int) and d is R:
            t = _AllGather.apply(t, mesh, a, s) if diff \
                else all_gather(t, mesh, a, s)
        elif isinstance(s, int) and d == P:
            full = list(t.shape)
            full[s] *= mesh.shape[a]
            t = _Pad.apply(t, mesh, a, s, full) if diff \
                else _pad(t, mesh, a, s, full)
        elif s is R and isinstance(d, int):
            t = _Slice.apply(t, mesh, a, d) if diff \
                else _block(t, mesh, a, d)
        elif s is R and d == P:
            t = _KeepFirst.apply(t, mesh, a) if diff \
                else _keep_first(t, mesh, a)
    return t


# ---------------------------------------------------------------------------
# sharded rules
# ---------------------------------------------------------------------------

class Decision:
    """What an op runs on (`want`: slot -> [placement]), what its outputs
    hold (`out`), and an optional rule run in place of the op's own
    (`impl`, an `OpDef`, for ops whose local result needs a global
    count)."""

    def __init__(self, want, out, impl=None, note=""):
        self.want = want
        self.out = out
        self.impl = impl
        self.note = note


class _In:
    """One input as a rule sees it: global shape and placement."""

    def __init__(self, name, gshape, pl):
        self.name, self.shape, self.pl = name, tuple(gshape), pl


RULES: Dict[str, Any] = {}


def rule(*types):
    def deco(fn):
        for t in types:
            RULES[t] = fn
        return fn
    return deco


def _splits(mesh, axis, size) -> bool:
    return mesh.shape[axis] > 1 and size % mesh.shape[axis] == 0


def _whole(op, ins, mesh):
    """The default: every input whole, every output whole."""
    n = len(mesh.axis_names)
    return Decision({s: [replicated(n)] * len(v) for s, v in ins.items()},
                    {s: [replicated(n)] * len(v)
                     for s, v in op.outputs.items()}, note="replicated")


def _keep_dims(pl, keep):
    """`pl` with only the splits `keep(dim)` allows; P made whole."""
    return tuple(p if isinstance(p, int) and keep(p) else R for p in pl)


def _outs(op, pl, slots=None):
    return {s: [pl] * len(v) for s, v in op.outputs.items()
            if slots is None or s in slots}


_POINTWISE = ("relu", "sigmoid", "tanh", "gelu", "exp", "log", "sqrt",
              "rsqrt", "square", "abs", "scale", "dropout", "cast", "softsign",
              "leaky_relu", "elu", "relu6", "swish", "hard_sigmoid",
              "softplus", "brelu", "sign", "floor", "ceil", "round",
              "reciprocal", "assign", "clip", "pow", "stanh", "logsigmoid",
              "tanh_shrink", "softshrink", "hard_shrink", "thresholded_relu",
              "selu", "silu", "mish", "hard_swish", "sin", "cos")


@rule(*_POINTWISE)
def _pointwise(op, ins, mesh):
    """One input X, outputs of its shape: any split carries over."""
    if set(ins) != {"X"} or len(ins["X"]) != 1:
        return None
    pl = _keep_dims(ins["X"][0].pl, lambda d: True)
    return Decision({"X": [pl]}, _outs(op, pl))


@rule("elementwise_add", "elementwise_sub", "elementwise_mul",
      "elementwise_div", "elementwise_max", "elementwise_min",
      "elementwise_pow")
def _elementwise(op, ins, mesh):
    """Y broadcasts into X from dim `axis`; a split of X carries over and
    a non-broadcast dim of Y is sliced to match (the sinusoid table added
    to a sequence-split activation); two partial sums add as one."""
    if set(ins) != {"X", "Y"}:
        return None
    x, y = ins["X"][0], ins["Y"][0]
    if len(y.shape) > len(x.shape):
        return None
    axis = op.attrs.get("axis", -1)
    if axis is None or axis < 0:
        axis = len(x.shape) - len(y.shape)
    linear = op.type in ("elementwise_add", "elementwise_sub")
    want_x, want_y = [], []
    for ax, a in enumerate(mesh.axis_names):
        px, py = x.pl[ax], y.pl[ax]
        if linear and px == P and py == P:
            want_x.append(P)
            want_y.append(P)
            continue
        d = px if isinstance(px, int) else None
        if d is None and isinstance(py, int) \
                and y.shape[py] == x.shape[axis + py] \
                and _splits(mesh, a, x.shape[axis + py]):
            d = axis + py
        want_x.append(d)
        yd = d - axis if d is not None else None
        if yd is not None and 0 <= yd < len(y.shape) \
                and y.shape[yd] == x.shape[d] and x.shape[d] > 1:
            want_y.append(yd)
        else:
            want_y.append(R)
    wx, wy = tuple(want_x), tuple(want_y)
    return Decision({"X": [wx], "Y": [wy]}, _outs(op, wx))


@rule("sum")
def _sum(op, ins, mesh):
    """Every input as the first one holds it; partial sums stay partial."""
    xs = ins["X"]
    want = []
    for ax in range(len(mesh.axis_names)):
        ps = {x.pl[ax] for x in xs}
        if ps == {P}:
            want.append(P)
        else:
            p = xs[0].pl[ax]
            want.append(p if isinstance(p, int) else R)
    w = tuple(want)
    return Decision({"X": [w] * len(xs)}, _outs(op, w))


@rule("mul")
def _mul(op, ins, mesh):
    """X's row dims (before x_num_col_dims) keep their splits; Y is
    gathered whole (mp gathers on use)."""
    x = ins["X"][0]
    xd = op.attrs.get("x_num_col_dims", 1)
    wx = _keep_dims(x.pl, lambda d: d < xd)
    n = len(mesh.axis_names)
    return Decision({"X": [wx], "Y": [replicated(n)]}, _outs(op, wx))


@rule("matmul")
def _matmul(op, ins, mesh):
    """Batch dims split alike in X and Y (a 2-D Y is gathered); X's rows
    keep their split when Y is 2-D and X is not transposed."""
    x, y = ins["X"][0], ins["Y"][0]
    nd = len(x.shape)
    if nd < 2:
        return None
    rows_ok = not op.attrs.get("transpose_X", False) and len(y.shape) == 2
    wx = _keep_dims(x.pl, lambda d: d < nd - 2 or (d == nd - 2 and rows_ok))
    wy = []
    for p in wx:
        if isinstance(p, int) and p < nd - 2 and len(y.shape) == nd \
                and y.shape[p] == x.shape[p]:
            wy.append(p)
        else:
            wy.append(R)
    if any(isinstance(p, int) and p < nd - 2 and q is R
           for p, q in zip(wx, wy)) and len(y.shape) == nd:
        return None     # a broadcast batch dim of Y: run whole
    return Decision({"X": [wx], "Y": [tuple(wy)]}, _outs(op, wx))


@rule("layer_norm")
def _layer_norm(op, ins, mesh):
    """Rows (dims before begin_norm_axis) keep their splits. Mean and
    Variance are flat over the rows: a split of dim 0 alone carries
    over, any other is a layout no rule names."""
    x = ins["X"][0]
    k = op.attrs.get("begin_norm_axis", 1)
    wx = _keep_dims(x.pl, lambda d: d < k)
    flat = tuple(0 if p == 0 else (OPAQUE if isinstance(p, int) else R)
                 for p in wx)
    n = len(mesh.axis_names)
    want = {"X": [wx]}
    for s in ("Scale", "Bias"):
        if s in ins:
            want[s] = [replicated(n)]
    out = _outs(op, wx, ("Y",))
    out.update(_outs(op, flat, ("Mean", "Variance")))
    return Decision(want, out)


@rule("softmax_with_cross_entropy")
def _softmax_ce(op, ins, mesh):
    """Every dim but the class dim keeps its split, the label's alike."""
    x, lab = ins["Logits"][0], ins["Label"][0]
    nd = len(x.shape)
    wx = _keep_dims(x.pl, lambda d: d < nd - 1)
    wl = tuple(p if isinstance(p, int) and p < len(lab.shape)
               and lab.shape[p] == x.shape[p] else R for p in wx)
    if any(isinstance(p, int) and q is R for p, q in zip(wx, wl)):
        return None
    return Decision({"Logits": [wx], "Label": [wl]}, _outs(op, wx))


@rule("softmax", "log_softmax")
def _softmax(op, ins, mesh):
    x = ins["X"][0]
    nd = len(x.shape)
    axis = op.attrs.get("axis", -1) % nd
    wx = _keep_dims(x.pl, lambda d: d != axis)
    return Decision({"X": [wx]}, _outs(op, wx))


@rule("lookup_table")
def _lookup_table(op, ins, mesh):
    """Ids keep their splits (not a trailing size-1 dim); W is gathered."""
    ids = ins["Ids"][0]
    nd = len(ids.shape)
    trail = nd and ids.shape[-1] == 1
    wi = _keep_dims(ids.pl, lambda d: not (trail and d == nd - 1))
    n = len(mesh.axis_names)
    return Decision({"W": [replicated(n)], "Ids": [wi]}, _outs(op, wi))


@rule("reshape", "reshape2")
def _reshape(op, ins, mesh):
    """A split dim carries over when it and every dim before it are kept
    (0 in `shape`, or the same size); the local `shape` attr takes the
    shard's size."""
    x = ins["X"][0]
    shape = [int(s) for s in op.attrs.get("shape", [])]
    if "Shape" in ins or "ShapeTensor" in ins:
        return None
    split = [p for p in x.pl if isinstance(p, int)]
    for d in split:
        if d >= len(shape) or any(
                not (shape[j] == 0 or shape[j] == x.shape[j])
                for j in range(d + 1)):
            return None
    wx = _keep_dims(x.pl, lambda d: True)
    out = _outs(op, wx, ("Out",))
    if "XShape" in op.outputs:
        out.update(_outs(op, replicated(len(mesh.axis_names)), ("XShape",)))
    return Decision({"X": [wx]}, out)


@rule("transpose", "transpose2")
def _transpose(op, ins, mesh):
    x = ins["X"][0]
    perm = list(op.attrs.get("axis", []))
    wx = _keep_dims(x.pl, lambda d: True)
    wo = tuple(perm.index(p) if isinstance(p, int) else p for p in wx)
    out = _outs(op, wo, ("Out",))
    if "XShape" in op.outputs:
        out.update(_outs(op, replicated(len(mesh.axis_names)), ("XShape",)))
    return Decision({"X": [wx]}, out)


def _scaled(op_type, orig, frac):
    """`orig`'s rule with its output scaled by `frac` (a local mean over a
    shard times its share of the global count: the shard's part of the
    global mean)."""
    def lower(ctx, X):
        out = orig.lower(ctx, X)
        return {k: v * frac for k, v in out.items()}
    return registry.OpDef(op_type, lower, needs_rng=False,
                          propagate_seqlen=orig.propagate_seqlen)


@rule("mean")
def _mean(op, ins, mesh):
    """Each split axis leaves a partial sum of local sum / N_global."""
    x = ins["X"][0]
    wx = tuple(p if isinstance(p, int) or p == P else R for p in x.pl)
    out = tuple(P if p is not R else R for p in wx)
    frac = 1.0
    for a, p in zip(mesh.axis_names, wx):
        if isinstance(p, int):
            frac /= mesh.shape[a]
    impl = _scaled("mean", registry.get_op_def("mean"), frac) \
        if frac != 1.0 else None
    return Decision({"X": [wx]}, _outs(op, out), impl=impl)


@rule("reduce_sum", "reduce_mean")
def _reduce(op, ins, mesh):
    """A reduced split dim leaves a partial sum; a kept one moves to its
    place in the output."""
    x = ins["X"][0]
    nd = len(x.shape)
    if op.attrs.get("reduce_all", False):
        dims = list(range(nd))
    else:
        dims = op.attrs.get("dim", [0])
        dims = [dims] if isinstance(dims, int) else list(dims)
        dims = [d % nd for d in dims] if nd else []
    keep = op.attrs.get("keep_dim", False)
    wx, out = [], []
    frac = 1.0
    for a, p in zip(mesh.axis_names, x.pl):
        if p == P:
            wx.append(P)
            out.append(P)
        elif isinstance(p, int) and p in dims:
            wx.append(p)
            out.append(P)
            frac /= mesh.shape[a]
        elif isinstance(p, int):
            wx.append(p)
            out.append(p if keep else p - sum(1 for d in dims if d < p))
        else:
            wx.append(R)
            out.append(R)
    impl = None
    if op.type == "reduce_mean" and frac != 1.0:
        impl = _scaled("reduce_mean", registry.get_op_def("reduce_mean"),
                       frac)
    return Decision({"X": [tuple(wx)]}, _outs(op, tuple(out)), impl=impl)


@rule("fused_attention")
def _fused_attention(op, ins, mesh):
    """Q/K/V [B, H, T, D]: the batch keeps its split; under an 'sp' axis
    the sequence is split (the rule runs the ring), unless 'sp' does not
    divide it (the rule then raises, as the JAX package's)."""
    q = ins["Q"][0]
    want = []
    for a, p in zip(mesh.axis_names, q.pl):
        if a == "sp" and mesh.shape[a] > 1:
            want.append(2 if q.shape[2] % mesh.shape[a] == 0 else R)
        elif p == 0:
            want.append(0)
        else:
            want.append(R)
    w = tuple(want)
    return Decision({s: [w] for s in ("Q", "K", "V")}, _outs(op, w))


_OPTIMIZERS = ("sgd", "momentum", "adam", "adamax", "adagrad",
               "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "lamb",
               "lars_momentum")


@rule(*_OPTIMIZERS)
def _update(op, ins, mesh):
    """An update runs where its parameter lives: every input of the
    parameter's shape (Grad, the moments) at the parameter's placement,
    the rest (the rate, the beta powers) whole. The executor then puts
    each state output back at its own placement."""
    if "Param" not in ins:
        return None
    p = ins["Param"][0]
    n = len(mesh.axis_names)
    common = tuple(x if isinstance(x, int) else R for x in p.pl)
    want = {s: [common if v.shape == p.shape else replicated(n)
                for v in vs] for s, vs in ins.items()}
    out = {}
    for s, names in op.outputs.items():
        base = s[:-3] if s.endswith("Out") else s
        src = ins.get(base)
        out[s] = [common if src and src[0].shape == p.shape
                  else replicated(n)] * len(names)
    return Decision(want, out)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

class _Entry:
    def __init__(self, idx, op_type):
        self.idx, self.type = idx, op_type
        self.ins: List[tuple] = []      # (slot, name, src, dst)
        self.outs: List[tuple] = []     # (slot, name, placement)
        self.colls: List[tuple] = []    # (kind, axis, bytes)
        self.note = ""


class Plan:
    """One step's decisions (op index -> Decision) and what it issued."""

    def __init__(self):
        self.decisions: Dict[int, Decision] = {}
        self.entries: List[_Entry] = []
        self.done = False

    def replicated_ops(self) -> Dict[str, int]:
        """Op types that ran on whole inputs for want of a rule."""
        out: Dict[str, int] = {}
        for e in self.entries:
            if e.note == "replicated":
                out[e.type] = out.get(e.type, 0) + 1
        return out

    def text(self, mesh, hlo: bool) -> str:
        """The plan as text: each op with its inputs' placements and the
        collectives it issued, spelled as HLO (`all-reduce(`,
        `collective-permute(`) or StableHLO (`stablehlo.all_reduce`)."""
        lines = [f"// spmd plan over mesh {dict(mesh.shape)}"]
        for e in self.entries:
            args = ", ".join(
                f"{slot}={name}{fmt(src, mesh)}"
                + (f"->{fmt(dst, mesh)}" if src != dst else "")
                for slot, name, src, dst in e.ins)
            outs = ", ".join(f"{slot}={name}{fmt(pl, mesh)}"
                             for slot, name, pl in e.outs)
            tag = f"  // {e.note}" if e.note else ""
            lines.append(f"op{e.idx} = {e.type}({args}) -> ({outs}){tag}")
            for kind, axis, nbytes in e.colls:
                spell = (f" {kind}(" if hlo
                         else f" stablehlo.{kind.replace('-', '_')}(")
                lines.append(f"  %c ={spell}{axis}) bytes={nbytes}")
        rep = self.replicated_ops()
        if rep:
            lines.append("// ran whole (no sharded rule): " + ", ".join(
                f"{t} x{n}" for t, n in sorted(rep.items())))
        return "\n".join(lines)


class _FwdOp:
    """A grad op's forward OpDesc as an op-like view."""

    def __init__(self, desc):
        self.type = desc["type"]
        self.inputs = desc["inputs"]
        self.outputs = desc["outputs"]
        self.attrs = desc["attrs"]


class SpmdStep:
    """Runs block 0 of a program on this rank's shards. `place` maps each
    var name in `env` to its placement; `state_place` holds the fixed
    placement of every persistable var."""

    def __init__(self, program, mesh, device, state_place, amp=False):
        self.program = program
        self.mesh = mesh
        self.device = torch.device(device)
        self.state_place = state_place
        self.amp = amp
        self.n = len(mesh.axis_names)

    # -- placements ------------------------------------------------------
    def _pl(self, name):
        return self.place.get(name, replicated(self.n))

    def _fetch_conv(self, name, dst):
        """`name` at `dst` (no autograd), memoized until `name` is
        written."""
        src = self._pl(name)
        if src == dst:
            return self.env[name]
        memo = self.cache.setdefault(name, {})
        hit = memo.get(dst)
        if hit is None:
            hit = memo[dst] = convert(self.env[name], src, dst, self.mesh,
                                      diff=False)
        return hit

    def _write(self, name, val, pl):
        self.env[name] = val
        self.place[name] = pl
        self.cache.pop(name, None)
        want = self.state_place.get(name)
        if want is not None and pl != want:
            self.env[name] = convert(val, pl, want, self.mesh, diff=False)
            self.place[name] = want

    def _decide(self, op, idx, ins_names):
        d = self.plan.decisions.get(idx)
        if d is not None:
            return d
        ins = {}
        for slot, names in ins_names.items():
            vals = []
            for n in names:
                v = self.env.get(n) if n != EMPTY_VAR else None
                shape = tuple(v.shape) if isinstance(v, torch.Tensor) else ()
                vals.append(_In(n, global_shape(shape, self._pl(n),
                                                self.mesh), self._pl(n)))
            ins[slot] = vals
        fn = RULES.get(op.type)
        d = fn(op, ins, self.mesh) if fn is not None else None
        if d is None:
            d = _whole(op, ins, self.mesh)
        self.plan.decisions[idx] = d
        return d

    def _shards(self, ins_names, want):
        shards = {}
        for slot, names in ins_names.items():
            pls = want.get(slot)
            if not pls or not any(isinstance(p, int) for p in pls[0]) \
                    or not names or names[0] == EMPTY_VAR:
                continue
            v = self.env.get(names[0])
            if not isinstance(v, torch.Tensor):
                continue
            pl = pls[0]
            local = list(v.shape)
            src = self._pl(names[0])
            gshape = global_shape(local, src, self.mesh)
            loc = list(gshape)
            for a, p in zip(self.mesh.axis_names, pl):
                if isinstance(p, int):
                    loc[p] //= self.mesh.shape[a]
            o = origin(loc, pl, self.mesh)
            if o is not None:
                shards[slot] = o
        return shards

    def _shadow(self, op, base):
        """A control-flow op's env copy with every var its sub-blocks read
        made whole (they run the plain interpreter)."""
        shadow = dict(base)
        for si in ir.sub_block_indices(op):
            for n in ir.external_reads(self.program, si):
                if n in shadow and self._pl(n) != replicated(self.n):
                    shadow[n] = self._fetch_conv(n, replicated(self.n))
        return shadow

    # -- ops -------------------------------------------------------------
    def run(self, env, place, plan: Plan, seed, counter, live,
            check_nan_inf=False):
        self.env, self.place, self.plan = env, place, plan
        # name -> {placement: the var held there}, until `name` is written
        self.cache: Dict[str, Dict[tuple, torch.Tensor]] = {}
        record = not plan.done
        for op_idx, op in enumerate(self.program.global_block().ops):
            entry = _Entry(op_idx, op.type) if record else None
            _recorder.entry = entry
            try:
                if op.type.endswith(GRAD_OP_SUFFIX) \
                        and FWD_OP_ATTR in op.attrs:
                    self._grad_op(op, op_idx, seed, counter, entry)
                else:
                    self._op(op, op_idx, seed, counter, live, entry,
                             check_nan_inf)
            finally:
                _recorder.entry = None
            if record:
                plan.entries.append(entry)
        plan.done = True
        return env

    def _op(self, op, op_idx, seed, counter, live, entry, check_nan_inf):
        opdef = registry.get_op_def(op.type)
        d = self._decide(op, op_idx, op.inputs)
        ins = {}
        for slot, names in op.inputs.items():
            vals = []
            for i, n in enumerate(names):
                if n == EMPTY_VAR:
                    vals.append(None)
                    continue
                if n not in self.env:
                    raise KeyError(
                        f"op {op.type}: input var {n!r} not materialized")
                dst = self._want(d, slot, i)
                vals.append(self._fetch_conv(n, dst))
                if entry is not None:
                    entry.ins.append((slot, n, self._pl(n), dst))
            ins[slot] = vals
        s = (op_seed(seed, counter, int(op.attrs.get("__idx__", op_idx)))
             if opdef.needs_rng else None)
        env = self._shadow(op, self.env) if opdef.reads_env else self.env
        ctx = LoweringContext(op.attrs, self.device, seed=s, op=op,
                              live=live, amp=self.amp, program=self.program,
                              env=env, mesh=self.mesh,
                              shards=self._shards(op.inputs, d.want))
        outs = registry.call_rule(d.impl or opdef, ctx, ins)
        for slot, names in op.outputs.items():
            vals = outs.get(slot)
            if vals is None:
                continue
            if len(vals) < len(names):
                raise ValueError(f"op {op.type}: slot {slot} produced "
                                 f"{len(vals)} values for {len(names)} "
                                 f"outputs")
            pls = d.out.get(slot, [replicated(self.n)] * len(names))
            for name, val, pl in zip(names, vals, pls):
                if name == EMPTY_VAR or val is None:
                    continue
                if check_nan_inf:
                    _check_finite(op, name, val)
                self._write(name, val, pl)
                if entry is not None:
                    entry.outs.append((slot, name, pl))
        if entry is not None:
            entry.note = d.note
        if opdef.propagate_seqlen:
            _propagate_seqlen(op, self.env)
            for n in op.output_arg_names:
                for c in (n + ir.SEQLEN_SUFFIX, n + ir.SEQLEN_SUFFIX + ".1"):
                    if c in self.env and c not in self.place:
                        # a length companion [B] follows its var's batch
                        # split
                        self.place[c] = tuple(0 if p == 0 else R
                                              for p in self._pl(n))

    def _grad_op(self, op, op_idx, seed, counter, entry):
        fwd = op.attrs[FWD_OP_ATTR]
        fop = _FwdOp(fwd)
        opdef = registry.get_op_def(fop.type)
        s = (op_seed(seed, counter, int(fwd.get("__idx__", 0)))
             if opdef.needs_rng else None)
        declared = _declared_by_base(op)
        # the forward's decision, from its inputs' placements now (the
        # same as at its run: nothing re-places a var in between)
        d = self._decide(fop, ("grad", op_idx), fop.inputs)
        if entry is not None:
            entry.note = d.note
        hand = opdef.grad_lower is not None and d.impl is None
        leaves: Dict[str, torch.Tensor] = {}
        for names in fop.inputs.values():
            for n in names:
                if n in declared and n not in leaves \
                        and self.env[n].is_floating_point():
                    leaves[n] = self.env[n].detach().requires_grad_(True)
        if not leaves and not hand:
            return
        conv: Dict[tuple, torch.Tensor] = {}
        with torch.enable_grad():
            ins = {}
            for slot, names in fop.inputs.items():
                vals = []
                for i, n in enumerate(names):
                    dst = self._want(d, slot, i)
                    if n in leaves:
                        v = convert(leaves[n], self._pl(n), dst, self.mesh,
                                    diff=True)
                    else:
                        v = self._fetch_conv(n, dst)
                    conv[(slot, i)] = v
                    vals.append(v)
                    if entry is not None:
                        entry.ins.append((slot, n, self._pl(n), dst))
                ins[slot] = vals
            shadow = None
            if opdef.reads_env:
                shadow = self._shadow(fop, self.env)
                shadow.update({k: conv[(sl, i)]
                               for sl, ns in fop.inputs.items()
                               for i, k in enumerate(ns) if k in leaves})
            ctx = LoweringContext(fop.attrs, self.device, seed=s, op=op,
                                  recompute=True, amp=self.amp,
                                  program=self.program, env=shadow,
                                  mesh=self.mesh,
                                  shards=self._shards(fop.inputs, d.want))

            def cot(slot, i, name):
                g = ir.grad_var_name(name)
                if g not in self.env:
                    return None
                pls = d.out.get(slot, [replicated(self.n)] * (i + 1))
                return self._fetch_conv(g, dual(pls[i]))

            if hand:
                ctx.fwd_outs = {sl: [self.env.get(n) for n in ns]
                                for sl, ns in fop.outputs.items()}
                out_grads = {sl: [cot(sl, i, n) for i, n in enumerate(ns)]
                             for sl, ns in fop.outputs.items()}
                with torch.no_grad():
                    grads = opdef.grad_lower(
                        ctx, {sl: [v.detach() if isinstance(v, torch.Tensor)
                                   else v for v in vs]
                              for sl, vs in ins.items()}, out_grads)
                for slot, g in grads.items():
                    gs = g if isinstance(g, (list, tuple)) else [g]
                    for i, (name, gv) in enumerate(
                            zip(fop.inputs.get(slot, []), gs)):
                        if gv is None or name not in declared:
                            continue
                        if name in leaves and conv[(slot, i)] \
                                is not leaves[name]:
                            gv, = torch.autograd.grad(conv[(slot, i)],
                                                      leaves[name], gv)
                        self._add_grad(declared[name], gv.detach(), name)
                return
            outs = registry.call_rule(d.impl or opdef, ctx, ins)
            primals, cotangents = [], []
            for slot, out_names in fop.outputs.items():
                for i, (name, primal) in enumerate(
                        zip(out_names, outs.get(slot, ()))):
                    g = cot(slot, i, name)
                    if g is None or primal is None \
                            or not primal.requires_grad:
                        continue
                    primals.append(primal)
                    cotangents.append(g.to(primal.dtype))
            grads = (torch.autograd.grad(primals, list(leaves.values()),
                                         cotangents, allow_unused=True)
                     if primals else [None] * len(leaves))
        for n, g in zip(leaves, grads):
            val = torch.zeros_like(self.env[n]) if g is None else g.detach()
            self._write(declared[n], val, dual(self._pl(n)))

    def _want(self, d, slot, i):
        pls = d.want.get(slot)
        return pls[i] if pls and i < len(pls) else replicated(self.n)

    def _add_grad(self, gname, gv, fwd_name):
        pl = dual(self._pl(fwd_name))
        if gname in self.env:
            gv = convert(self.env[gname], self._pl(gname), pl, self.mesh,
                         diff=False) + gv
        self._write(gname, gv, pl)
