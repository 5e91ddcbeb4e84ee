"""Per-op cost attribution over the Program IR.

Mirror of ``paddle_tpu/analysis/cost_model.py``. For every op of the
dataflow graph: how many FLOPs it computes, how many bytes it moves, and
how much memory its output occupies, derived *statically* by propagating
concrete shapes through the program with the same
`registry.infer_op_shapes` machinery the shape verifier uses (meta
tensors), then applying per-op-type arithmetic-intensity rules. The
rules are the JAX package's, so both packages cost one Program alike.

FLOP convention (the JAX package's, which follows XLA's): a dot of
[M,K]x[K,N] is 2·M·K·N; elementwise ops are one FLOP per output element;
transcendentals are NOT counted. The port has no compiler to ask for a
ground truth; `measured_flops` counts what torch's own FLOP counter sees
in one run of a step, which covers the dense products only (see its
docstring), so the static total runs above it by the elementwise work.

Known approximations:
- ops inside control-flow sub-blocks are counted ONCE (not x trip
  count) — the bounded `while` trip count is a runtime value;
- gradient ops of matmul-like ops are costed from their forward
  counterpart (one full product per produced input-grad), the standard
  2x-forward rule (the port's grad op also recomputes the forward,
  which this rule does not count);
- `-1` dims with no feed to resolve them fall back to `default_dim`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import ir, registry
from ..core.registry import EMPTY_VAR, GRAD_OP_SUFFIX
from .verifier import PSEUDO_OPS

ShapeDtype = Tuple[Tuple[int, ...], str]

# op families whose cost is a dense product (2*M*K*N-style)
_MATMUL_LIKE = ("mul", "matmul", "conv2d", "depthwise_conv2d")

# elementwise-ish FLOPs per OUTPUT element, by op type. XLA convention:
# exp/log/tanh/rsqrt are transcendentals, not flops, so e.g. softmax is
# (sub max, sum, div) ~ 3 non-transcendental flops/elem.
_ELEM_FLOPS = {
    "relu": 1.0, "relu6": 1.0, "leaky_relu": 2.0, "sigmoid": 2.0,
    "tanh": 1.0, "gelu": 6.0, "scale": 1.0, "dropout": 2.0, "cast": 0.0,
    "elementwise_add": 1.0, "elementwise_sub": 1.0, "elementwise_mul": 1.0,
    "elementwise_div": 1.0, "elementwise_max": 1.0, "elementwise_min": 1.0,
    "elementwise_pow": 1.0, "sum": 1.0, "sqrt": 0.0, "square": 1.0,
    "softmax": 3.0, "log_softmax": 3.0,
    "layer_norm": 7.0, "batch_norm": 5.0,
    "softmax_with_cross_entropy": 4.0, "cross_entropy": 1.0,
    "sgd": 2.0, "momentum": 4.0, "adam": 10.0, "adagrad": 5.0,
    "clip": 1.0, "abs": 1.0, "pow": 1.0,
}

# grad-op elementwise factors where the backward is notably denser than
# one flop/elem (defaults to the forward factor, then to 1.0)
_GRAD_ELEM_FLOPS = {
    "softmax": 4.0, "layer_norm": 8.0, "batch_norm": 6.0, "dropout": 1.0,
    "softmax_with_cross_entropy": 2.0, "mean": 1.0, "gelu": 8.0,
}

# pure data-movement ops: zero FLOPs, bytes still counted
_MOVEMENT = {
    "reshape", "transpose", "concat", "stack", "split", "slice",
    "squeeze", "unsqueeze", "fill_constant", "fill_zeros_like",
    "assign", "shape", "lookup_table", "gather", "scatter",
    "expand", "pad", "sequence_pad", "sequence_unpad", "one_hot",
    "causal_mask", "sinusoid_pos_encoding", "uniform_random",
    "gaussian_random", "range", "arange", "flatten",
    "space_to_depth", "pixel_shuffle",
}

_DTYPE_BYTES = {"float64": 8, "int64": 8, "float32": 4, "int32": 4,
                "float16": 2, "bfloat16": 2, "int16": 2, "int8": 1,
                "uint8": 1, "bool": 1}


def _nbytes(sd: Optional[ShapeDtype]) -> float:
    if sd is None:
        return 0.0
    shape, dtype = sd
    return float(np.prod([max(int(d), 1) for d in shape])
                 if shape else 1) * _DTYPE_BYTES.get(str(dtype), 4)


def _nelems(shape: Sequence[int]) -> float:
    return float(np.prod([max(int(d), 1) for d in shape])) if shape else 1.0


class OpCost:
    """One op's static cost estimate."""

    __slots__ = ("block_idx", "op_idx", "op_type", "out_name", "flops",
                 "bytes", "out_bytes")

    def __init__(self, block_idx, op_idx, op_type, out_name, flops,
                 bytes_, out_bytes):
        self.block_idx = block_idx
        self.op_idx = op_idx
        self.op_type = op_type
        self.out_name = out_name
        self.flops = float(flops)
        self.bytes = float(bytes_)       # input + output traffic
        self.out_bytes = float(out_bytes)  # est. memory its outputs occupy

    def as_dict(self) -> dict:
        return {"block": self.block_idx, "op": self.op_idx,
                "type": self.op_type, "out": self.out_name,
                "flops": self.flops, "bytes": self.bytes,
                "out_bytes": self.out_bytes}

    def __repr__(self):
        return (f"OpCost({self.op_type}:{self.out_name}, "
                f"flops={self.flops:.3g}, bytes={self.bytes:.3g})")


class CostReport:
    """Whole-program cost table + aggregates."""

    def __init__(self, ops: List[OpCost], param_bytes: float,
                 unresolved: List[str]):
        self.ops = ops
        self.param_bytes = float(param_bytes)
        # ops whose shapes could not be derived (costed by fallback)
        self.unresolved = unresolved

    @property
    def total_flops(self) -> float:
        return sum(o.flops for o in self.ops)

    @property
    def total_bytes(self) -> float:
        return sum(o.bytes for o in self.ops)

    @property
    def total_out_bytes(self) -> float:
        return sum(o.out_bytes for o in self.ops)

    def by_type(self) -> Dict[str, dict]:
        agg: Dict[str, dict] = {}
        for o in self.ops:
            a = agg.setdefault(o.op_type, {"count": 0, "flops": 0.0,
                                           "bytes": 0.0, "out_bytes": 0.0})
            a["count"] += 1
            a["flops"] += o.flops
            a["bytes"] += o.bytes
            a["out_bytes"] += o.out_bytes
        return agg

    def top(self, k: int = 10, key: str = "flops") -> List[OpCost]:
        return sorted(self.ops, key=lambda o: -getattr(o, key))[:k]

    def as_dict(self, top_k: int = 10) -> dict:
        total = self.total_flops or 1.0
        return {
            "total_flops": self.total_flops,
            "total_bytes": self.total_bytes,
            "total_out_bytes": self.total_out_bytes,
            "param_bytes": self.param_bytes,
            "arithmetic_intensity": (self.total_flops
                                     / max(self.total_bytes, 1.0)),
            "ops": len(self.ops),
            "unresolved": len(self.unresolved),
            "by_type": {t: dict(a, flops_share=round(a["flops"] / total, 4))
                        for t, a in sorted(self.by_type().items(),
                                           key=lambda kv: -kv[1]["flops"])},
            "top": [dict(o.as_dict(),
                         flops_share=round(o.flops / total, 4))
                    for o in self.top(top_k)],
        }

    def table(self, k: int = 15, step_time_s: Optional[float] = None) -> str:
        """Human top-k table; with `step_time_s` (a measured step time)
        each op also gets its est. time share."""
        total = self.total_flops or 1.0
        lines = [f"{'op':<28} {'type':<22} {'GFLOPs':>10} {'MB':>9} "
                 f"{'share':>7}" + ("  est_time" if step_time_s else "")]
        for o in self.top(k):
            share = o.flops / total
            line = (f"{o.out_name[:28]:<28} {o.op_type[:22]:<22} "
                    f"{o.flops / 1e9:>10.4f} {o.bytes / 1e6:>9.2f} "
                    f"{share:>6.1%}")
            if step_time_s:
                line += f"  {share * step_time_s * 1e3:8.3f} ms"
            lines.append(line)
        lines.append(
            f"TOTAL: {self.total_flops / 1e9:.3f} GFLOPs, "
            f"{self.total_bytes / 1e6:.1f} MB moved, "
            f"params {self.param_bytes / 1e6:.1f} MB, "
            f"AI {self.total_flops / max(self.total_bytes, 1.0):.1f} "
            f"flops/byte")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# concrete shape propagation
# ---------------------------------------------------------------------------

def _resolve(shape, default_dim: int) -> Tuple[int, ...]:
    return tuple(int(d) if int(d) != -1 else int(default_dim)
                 for d in shape)


def _seed_env(program, env, feed_shapes, default_dim):
    for blk in program.blocks:
        for v in blk.vars.values():
            if v.is_data and v.lod_level > 0:
                # @SEQLEN companions: one int32 length per sequence
                # level — seeded for FED LoD vars too (the feed gives
                # the batch extent; the fed var itself is already in env)
                batch = (feed_shapes.get(v.name, v.shape) or (default_dim,))
                b = int(batch[0]) if int(batch[0]) != -1 else default_dim
                for lvl in range(v.lod_level):
                    env.setdefault(ir.seqlen_var_name(v.name, lvl),
                                   ((b,) * (lvl + 1), "int32"))
            if v.name in feed_shapes:
                continue
            if (v.persistable or v.is_data) and v.shape != ():
                env[v.name] = (_resolve(v.shape, default_dim), v.dtype)


def _concrete_env(program, feed_shapes: Dict[str, Sequence[int]],
                  default_dim: int, unresolved: List[str]
                  ) -> Dict[str, ShapeDtype]:
    """Propagate CONCRETE shapes (no -1 anywhere) through the program.
    Feeds seed the batch dims; every other var follows from the lowering
    rules; declared shapes (with -1 -> default_dim) are the fallback."""
    env: Dict[str, ShapeDtype] = {}
    blk0 = program.global_block()
    for name, shape in feed_shapes.items():
        v = blk0._find_var_recursive(name)
        dtype = v.dtype if v is not None and v.dtype else "float32"
        env[name] = (tuple(int(d) for d in shape), dtype)
    _seed_env(program, env, feed_shapes, default_dim)
    visited: set = set()
    _walk_block(program, blk0, env, default_dim, unresolved, visited)
    return env


def _fallback_outputs(block, op, env, default_dim, unresolved):
    for n in op.output_arg_names:
        if n == EMPTY_VAR or n in env:
            continue
        v = block._find_var_recursive(n)
        if v is not None and v.shape != ():
            env[n] = (_resolve(v.shape, default_dim), v.dtype)
        else:
            unresolved.append(n)


def _walk_block(program, block, env, default_dim, unresolved, visited):
    visited.add(block.idx)
    for op in block.ops:
        if op.type in PSEUDO_OPS:
            continue
        if op.type.endswith(GRAD_OP_SUFFIX):
            # a grad has its base variable's shape by construction
            for n in op.output_arg_names:
                if n == EMPTY_VAR or ir.GRAD_SUFFIX not in n:
                    continue
                base = n.split(ir.GRAD_SUFFIX)[0]
                if base in env:
                    env[n] = env[base]
                else:
                    _fallback_outputs(block, op, env, default_dim,
                                      unresolved)
            continue
        subs = ir.sub_block_indices(op)
        if subs:
            for si in subs:
                if si < len(program.blocks) and si not in visited:
                    _walk_block(program, program.blocks[si], env,
                                default_dim, unresolved, visited)
            _fallback_outputs(block, op, env, default_dim, unresolved)
            continue
        if not registry.is_registered(op.type):
            _fallback_outputs(block, op, env, default_dim, unresolved)
            continue
        ins_by_slot, missing = {}, False
        for slot, names in op.inputs.items():
            pairs = []
            for n in names:
                if n == EMPTY_VAR:
                    continue
                sd = env.get(n)
                if sd is None:
                    v = block._find_var_recursive(n)
                    if v is not None and v.shape != ():
                        sd = (_resolve(v.shape, default_dim), v.dtype)
                    else:
                        missing = True
                        break
                pairs.append(sd)
            if missing:
                break
            ins_by_slot[slot] = pairs
        if missing:
            _fallback_outputs(block, op, env, default_dim, unresolved)
            continue
        try:
            result = registry.infer_op_shapes(op.type, op.attrs, ins_by_slot)
        except Exception:
            _fallback_outputs(block, op, env, default_dim, unresolved)
            continue
        for slot, names in op.outputs.items():
            inferred = result.get(slot)
            if inferred is None:
                continue
            for n, (shape, dtype) in zip(names, inferred):
                if n != EMPTY_VAR:
                    env[n] = (_resolve(shape, default_dim), dtype)
        _fallback_outputs(block, op, env, default_dim, unresolved)


# ---------------------------------------------------------------------------
# per-op FLOP rules
# ---------------------------------------------------------------------------

def _shape_of(env, block, name, default_dim) -> Optional[Tuple[int, ...]]:
    sd = env.get(name)
    if sd is not None:
        return sd[0]
    v = block._find_var_recursive(name)
    if v is not None and v.shape != ():
        return _resolve(v.shape, default_dim)
    return None


def _first(op, slot):
    names = op.inputs.get(slot) or ()
    return names[0] if names and names[0] != EMPTY_VAR else None


def _matmul_flops(op, env, block, default_dim) -> float:
    """2*M*K*N for mul/matmul; 2*out_elems*(kh*kw*cin/groups) for conv."""
    out = op.output_arg_names[0]
    out_shape = _shape_of(env, block, out, default_dim)
    if out_shape is None:
        return 0.0
    if op.type in ("conv2d", "depthwise_conv2d"):
        w = _first(op, "Filter") or _first(op, "W")
        w_shape = _shape_of(env, block, w, default_dim) if w else None
        if w_shape is None or len(w_shape) < 4:
            return 2.0 * _nelems(out_shape)
        # The per-output-element multiply count is the filter volume
        # without its Cout axis (grouping is already folded into the
        # filter's Cin/g extent). `data_format` describes the DATA
        # layout, not the filter's: this DSL stores filters OIHW
        # ([Cout, Cin/g, kh, kw]) for both NCHW and NHWC data — so find
        # the Cout axis by matching the output's channel extent instead
        # of trusting the data layout (the old NHWC branch read
        # Cout·Cin·kh here, inflating ResNet-50 ~300x).
        nhwc = op.attrs.get("data_format", "NCHW") in ("NHWC", "NDHWC")
        cout = out_shape[-1] if nhwc else (
            out_shape[1] if len(out_shape) > 1 else out_shape[-1])
        if w_shape[0] == cout:
            per_out = _nelems(w_shape[1:])
        elif w_shape[-1] == cout:
            per_out = _nelems(w_shape[:-1])
        else:
            per_out = _nelems(w_shape) / max(float(cout), 1.0)
        return 2.0 * _nelems(out_shape) * per_out
    x = _first(op, "X")
    x_shape = _shape_of(env, block, x, default_dim) if x else None
    if x_shape is None:
        return 2.0 * _nelems(out_shape)
    if op.type == "mul":
        ncd = int(op.attrs.get("x_num_col_dims", 1) or 1)
        k = _nelems(x_shape[ncd:])
    else:  # matmul: contraction dim is x's last (or second-to-last if
        # transposed)
        k = x_shape[-2] if op.attrs.get("transpose_X") else x_shape[-1]
    return 2.0 * _nelems(out_shape) * float(max(int(k), 1))


def _attention_flops(op, env, block, default_dim) -> float:
    """fused_attention [B,H,Tq,Dh]x[B,H,Tk,Dh]: the two dots QK^T and
    W·V (2·M·K·N each => 4·Dh per score) plus softmax's ~3
    non-transcendental flops per score — what XLA counts for the
    equivalent unfused chain, so fused and unfused programs cost the
    same math."""
    q = _first(op, "Q")
    k = _first(op, "K")
    q_shape = _shape_of(env, block, q, default_dim) if q else None
    k_shape = _shape_of(env, block, k, default_dim) if k else None
    if q_shape is None or k_shape is None or len(q_shape) < 2 \
            or len(k_shape) < 2:
        out = next((n for n in op.output_arg_names if n != EMPTY_VAR),
                   None)
        out_shape = _shape_of(env, block, out, default_dim) if out else None
        return 2.0 * _nelems(out_shape) if out_shape else 0.0
    return ((4.0 * q_shape[-1] + 3.0)
            * _nelems(q_shape[:-1]) * float(k_shape[-2]))


def _op_flops(op, env, block, default_dim, fwd_by_out) -> float:
    t = op.type
    out_names = [n for n in op.output_arg_names if n != EMPTY_VAR]
    out_shapes = [s for s in (_shape_of(env, block, n, default_dim)
                              for n in out_names) if s is not None]
    out_elems = sum(_nelems(s) for s in out_shapes)
    if t in _MOVEMENT:
        return 0.0
    if t in _MATMUL_LIKE:
        return _matmul_flops(op, env, block, default_dim)
    if t == "fused_attention":
        return _attention_flops(op, env, block, default_dim)
    if t.endswith(GRAD_OP_SUFFIX):
        base = t[: -len(GRAD_OP_SUFFIX)]
        if base == "fused_attention":
            # flash backward: dV, dW, dQ, dK plus the W recompute —
            # ~2.5x the forward's dot work
            og = _first(op, "OutGrad")
            fwd = fwd_by_out.get(og.split(ir.GRAD_SUFFIX)[0]) if og else None
            if fwd is not None:
                return 2.5 * _attention_flops(fwd, env, block, default_dim)
            return 2.0 * out_elems
        if base in _MATMUL_LIKE:
            # one full product per produced input-grad (the 2x-forward
            # rule), costed from the forward op that made OutGrad's base
            og = _first(op, "OutGrad")
            fwd = fwd_by_out.get(og.split(ir.GRAD_SUFFIX)[0]) if og else None
            if fwd is not None:
                per = _matmul_flops(fwd, env, block, default_dim)
                n_grads = max(len(out_names), 1)
                return per * n_grads
            return 2.0 * out_elems
        if base in _MOVEMENT:
            return 0.0
        factor = _GRAD_ELEM_FLOPS.get(base, _ELEM_FLOPS.get(base, 1.0))
        return factor * max(out_elems, 1.0)
    if t in ("mean", "reduce_mean", "reduce_sum", "reduce_max"):
        ins = sum(_nelems(s) for s in
                  (_shape_of(env, block, n, default_dim)
                   for n in op.input_arg_names if n != EMPTY_VAR) if s)
        return float(ins)
    factor = _ELEM_FLOPS.get(t)
    if factor is not None:
        # normalization/softmax-family ops read more than they write; use
        # the dominant tensor (max of in/out elems) as the element count
        ins = [s for s in (_shape_of(env, block, n, default_dim)
                           for n in op.input_arg_names if n != EMPTY_VAR)
               if s is not None]
        elems = max([out_elems] + [_nelems(s) for s in ins])
        return factor * elems
    return float(max(out_elems, 1.0))   # unknown op: one flop per elem


def estimate_cost(program: ir.Program,
                  feed_shapes: Dict[str, Sequence[int]],
                  default_dim: Optional[int] = None) -> CostReport:
    """Static per-op FLOPs/bytes/memory for `program` with the given
    concrete feed shapes. `default_dim` substitutes any -1 the feeds
    don't resolve (defaults to the first feed's leading dim, else 1)."""
    if default_dim is None:
        default_dim = 1
        for shape in feed_shapes.values():
            if len(shape) and int(shape[0]) > 0:
                default_dim = int(shape[0])
                break
    unresolved: List[str] = []
    env = _concrete_env(program, feed_shapes, default_dim, unresolved)
    ops: List[OpCost] = []
    for block in program.blocks:
        fwd_by_out = {}
        for op in block.ops:
            if not op.type.endswith(GRAD_OP_SUFFIX) \
                    and op.type not in PSEUDO_OPS:
                for n in op.output_arg_names:
                    if n != EMPTY_VAR:
                        fwd_by_out[n] = op
        for op_idx, op in enumerate(block.ops):
            if op.type in PSEUDO_OPS:
                continue
            in_bytes = sum(_nbytes(env.get(n))
                           for n in op.input_arg_names if n != EMPTY_VAR)
            out_bytes = sum(_nbytes(env.get(n))
                            for n in op.output_arg_names if n != EMPTY_VAR)
            flops = _op_flops(op, env, block, default_dim, fwd_by_out)
            out0 = next((n for n in op.output_arg_names if n != EMPTY_VAR),
                        op.type)
            ops.append(OpCost(block.idx, op_idx, op.type, out0, flops,
                              in_bytes + out_bytes, out_bytes))
    param_bytes = 0.0
    for blk in program.blocks:
        for v in blk.vars.values():
            if v.persistable and v.shape != ():
                param_bytes += _nbytes(
                    (_resolve(v.shape, default_dim), v.dtype))
    return CostReport(ops, param_bytes, unresolved)


def shape_env(program: ir.Program,
              feed_shapes: Dict[str, Sequence[int]],
              default_dim: Optional[int] = None) -> Dict[str, ShapeDtype]:
    """The concrete {var: (shape, dtype)} environment `estimate_cost`
    walks — exposed for consumers that need per-tensor shapes next to
    the per-op table."""
    if default_dim is None:
        default_dim = 1
        for shape in feed_shapes.values():
            if len(shape) and int(shape[0]) > 0:
                default_dim = int(shape[0])
                break
    return _concrete_env(program, feed_shapes, default_dim, [])


def estimate_peak_hbm(program: ir.Program,
                      feed_shapes: Dict[str, Sequence[int]],
                      default_dim: Optional[int] = None) -> dict:
    """Per-program peak device-memory estimate from the same
    concrete-shape walk `estimate_cost` uses (the name is the JAX
    package's).

    Decomposition (all bytes):

    - ``param_bytes``          persistable vars minus optimizer slots —
                               identical to CostReport.param_bytes minus
                               the slot component (their sum EQUALS
                               CostReport.param_bytes, test-pinned)
    - ``optimizer_slot_bytes`` persistable inputs of optimizer ops in
                               slots other than Param/Grad/LearningRate
                               (Velocity, Moment*, Beta*Pow, ...)
    - ``grad_bytes``           non-persistable GRAD-suffixed vars — the
                               dualed gradients live until applied
    - ``activation_bytes``     every other non-persistable intermediate
                               the walk resolved (forward activations a
                               training step keeps for the backward)
    - ``feed_bytes``           the fed batch itself
    - ``peak_bytes``           the sum — an upper-bound-flavored estimate
                               (the port's executor keeps every env
                               entry of a step to the step's end, and
                               the caching allocator adds workspace and
                               rounding on top)
    """
    if default_dim is None:
        default_dim = 1
        for shape in feed_shapes.values():
            if len(shape) and int(shape[0]) > 0:
                default_dim = int(shape[0])
                break
    unresolved: List[str] = []
    env = _concrete_env(program, feed_shapes, default_dim, unresolved)

    slot_names: set = set()
    for block in program.blocks:
        for op in block.ops:
            ins = op.inputs
            if "Param" not in ins or "Grad" not in ins:
                continue
            for slot, names in ins.items():
                if slot in ("Param", "Grad", "LearningRate"):
                    continue
                slot_names.update(n for n in names if n != EMPTY_VAR)

    params = slots = grads = acts = feeds = 0.0
    seen: set = set()
    for blk in program.blocks:
        for v in blk.vars.values():
            if v.name in seen or v.shape == ():
                continue
            seen.add(v.name)
            nb = _nbytes(env.get(v.name)
                         or (_resolve(v.shape, default_dim), v.dtype))
            if v.persistable:
                if v.name in slot_names:
                    slots += nb
                else:
                    params += nb
            elif v.is_data or v.name in feed_shapes:
                feeds += nb
            elif ir.GRAD_SUFFIX in v.name:
                grads += nb
            else:
                acts += nb
    return {
        "param_bytes": params,
        "optimizer_slot_bytes": slots,
        "grad_bytes": grads,
        "activation_bytes": acts,
        "feed_bytes": feeds,
        "peak_bytes": params + slots + grads + acts + feeds,
        "unresolved": len(unresolved),
    }


def measured_flops(exe, scope, feed, program=None) -> float:
    """FLOPs that `torch.utils.flop_counter.FlopCounterMode` counts in
    one run of a step: `program`, or the largest program (by global-block
    ops) that `exe` has run. The run takes clones of the scope's
    persistables into a scope of its own and puts `exe`'s run counter
    back, so neither the caller's parameters nor its later dropout
    streams move.

    What the counter sees: the aten products (`mm`, `bmm`, `addmm`,
    `baddbmm`, the convolutions and their backward, and
    `scaled_dot_product_attention`), each 2·M·K·N, in the forward rules
    and in the grad ops' autograd backward; on the host the flash
    attention's plain version is such a chain of products. What it does
    not see: elementwise ops, reductions, norms and softmax (0 FLOPs to
    it, where `estimate_cost` counts ~1-7 a element), the forward each
    grad op recomputes (counted here, not by `estimate_cost`), and the
    hand-written kernels of csrc/, whose insides are not aten ops (on a
    card a fused attention counts 0)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..core.executor import PreparedProgram, Scope

    if program is None:
        if not exe._prepared:
            raise ValueError("measured_flops: the executor has run no "
                             "program; pass program=")
        program = max((p.program for p in exe._prepared.values()),
                      key=lambda p: len(p.global_block().ops))
    shadow = Scope()
    for blk in program.blocks:
        for v in blk.vars.values():
            val = scope.find_var(v.name) if v.persistable else None
            if val is not None:
                shadow.set_var(v.name, val.clone()
                               if hasattr(val, "clone") else val)
    runs = exe._run_counts.get(program._uid)
    try:
        with FlopCounterMode(display=False) as counter:
            PreparedProgram(exe, program, [], shadow,
                            validate="off").run(dict(feed))
    finally:
        if runs is None:
            exe._run_counts.pop(program._uid, None)
        else:
            exe._run_counts[program._uid] = runs
    return float(counter.get_total_flops())
