"""Op registry: each op type maps to a PyTorch rule.

Mirror of ``paddle_tpu/core/registry.py``. A rule is a plain function on
tensors: ``rule(ctx, SlotA, SlotB=None, ...) -> {output_slot: tensor}``.
The executor calls the rules one by one on the place's device
(``core/lowering.py``); there is no tracing and no compile step.

Build-time shape inference runs the rule itself on ``device="meta"``
tensors, which carry shape and dtype but no data. An unknown (-1) dim is
replaced by a sentinel; a second run with another sentinel tells which
output dims derive from it (those map back to -1). Rules therefore avoid
data-dependent shapes, and kernel wrappers answer meta tensors with an
empty output of the right shape, without launching anything.
"""

from __future__ import annotations

import inspect
import json
from typing import Any, Callable, Dict, List, Optional

import torch

from . import types

# Sentinel sizes substituted for -1 dims during build-time shape inference
# (the same two primes as the JAX package).
DIM_SENTINEL = 8191
DIM_SENTINEL_ALT = 7919

EMPTY_VAR = "@EMPTY@"
GRAD_OP_SUFFIX = "_grad"
FWD_OP_ATTR = "__fwd_op__"  # grad ops carry the forward OpDesc dict here


class OpDef:
    def __init__(self, type: str, lower: Callable, needs_rng: bool,
                 propagate_seqlen: bool = True, reads_env: bool = False):
        self.type = type
        self.lower = lower
        self.needs_rng = needs_rng
        self.propagate_seqlen = propagate_seqlen
        self.reads_env = reads_env
        self.grad_lower: Optional[Callable] = None
        # parameter names of the rule (minus ctx) = input slot names
        params = list(inspect.signature(lower).parameters.values())[1:]
        self.input_slots = [p.name for p in params]
        self.optional_slots = {p.name for p in params
                               if p.default is not inspect.Parameter.empty}


_REGISTRY: Dict[str, OpDef] = {}


def register_op(type: str, needs_rng: bool = False,
                propagate_seqlen: bool = True, reads_env: bool = False):
    """Decorator registering the rule for op `type`. With
    `propagate_seqlen` (the default, as in the JAX package) the executor
    carries the first input's `@SEQLEN` companions onto the op's outputs
    after the rule runs (``core/lowering.py::_propagate_seqlen``); an op
    that changes the time axis or the batch (`transpose`, `top_k`, the
    sequence ops, the optimizer updates) registers False. `reads_env`
    marks a rule that reads vars through `ctx.env` rather than its slots
    (the control-flow ops, ``ops/control.py``): its generic grad
    recomputes it on a copy of the env in which the autograd leaves
    stand for the outer values."""

    def deco(fn):
        if type in _REGISTRY:
            raise ValueError(f"op {type!r} already registered")
        _REGISTRY[type] = OpDef(type, fn, needs_rng, propagate_seqlen,
                                reads_env)
        return fn

    return deco


def register_grad(type: str):
    """Register a hand-written grad rule for op `type`, in place of the
    generic one (the forward rule recomputed under autograd,
    ``core/lowering.py``). Signature:
    ``grad(ctx, ins: dict, out_grads: dict) -> {input_slot: grad}``;
    ``ctx.fwd_outs`` holds the forward op's outputs."""

    def deco(fn):
        if type not in _REGISTRY:
            close = close_op_names(type)
            hint = f"; closest registered: {', '.join(close)}" if close else ""
            raise ValueError(
                f"register_grad({type!r}): forward op {type!r} is not "
                f"registered — register_op must run first{hint}")
        _REGISTRY[type].grad_lower = fn
        return fn

    return deco


def close_op_names(name: str, n: int = 3) -> List[str]:
    """Registered op types most similar to `name` (typo hints for
    register_grad and the analysis verifier)."""
    import difflib
    return difflib.get_close_matches(name, _REGISTRY, n=n)


def get_op_def(type: str) -> OpDef:
    if type not in _REGISTRY:
        raise KeyError(f"op type {type!r} is not registered")
    return _REGISTRY[type]


def is_registered(type: str) -> bool:
    return type in _REGISTRY


def registered_ops() -> List[str]:
    return sorted(_REGISTRY)


# bf16 mixed precision (`Executor(amp=True)`), the JAX package's policy
# letter for letter. Matrix-product ops cast float32 inputs to bf16 and
# keep bf16 outputs, so activations flow through the network in bf16;
# numerically sensitive ops (the losses, means, log_softmax) upcast bf16
# inputs to float32; everything else runs in whatever dtype reaches it.
# Float32 parameters are cast at their point of use, so autograd through
# the cast hands float32 grads to the optimizer. Plain `softmax` is not
# float32-listed: it subtracts the max, so bf16 is safe. The sets name op
# types the port does not register as well: the policy is the JAX
# package's, whatever the port runs.
AMP_BF16_OPS = frozenset({"conv2d", "depthwise_conv2d", "conv2d_transpose",
                          "mul", "matmul", "lstm", "gru", "fc",
                          "fused_attention"})
AMP_F32_OPS = frozenset({"log_softmax", "cross_entropy",
                         "softmax_with_cross_entropy",
                         "sigmoid_cross_entropy_with_logits",
                         "square_error_cost", "smooth_l1", "huber_loss",
                         "mean", "reduce_mean", "nce", "hierarchical_sigmoid",
                         "linear_chain_crf", "warpctc", "cos_sim"})
# A mixed bf16 / float32 elementwise op casts its float32 side down rather
# than promote the bf16 side: one float32 mask or bias in the residual
# stream would otherwise turn every tensor after it float32. bf16 keeps
# float32's exponent range, so additive masks (-1e9) survive the cast.
AMP_DOWNCAST_OPS = frozenset({"elementwise_add", "elementwise_sub",
                              "elementwise_mul", "elementwise_div",
                              "elementwise_max", "elementwise_min"})


class LoweringContext:
    """Per-op context handed to rules.

    `device` is where creation ops (fill_constant, gaussian_random) put
    their output. A random op gets `seed`, a host integer derived from
    (program seed, run, op index): kernels and counter-hash dropout take
    it as it is, so no random number is ever read back from the card.
    `generator` is a `torch.Generator` on `device` seeded from it, made
    on first use (None for an op without a seed, and in meta runs).
    `live` is the set of var names that something reads after the block
    runs an op (`wants`); None means every output is read. `recompute`
    is True when a generic grad op runs the forward rule again under
    autograd (``core/lowering.py``): a rule that updates state in place
    (`batch_norm`'s running stats) does so only in the forward op. `amp`
    turns on the bf16 policy in `call_rule` (the JAX package reads it as
    ``ctx.lowerer.amp``; the port has no lowerer).

    A control-flow rule also gets the `program` and the live `env`
    (name -> tensor) and runs a sub-block through `run_block`, with this
    context's device, `amp` and `recompute`; `env` is None in meta runs.

    Under a `ParallelExecutor` (``parallel/spmd.py``) a rule runs on this
    rank's shards: `mesh` is the rank's mesh (the JAX lowerer's `mesh`),
    and `origin(slot)` gives the global shape of the slot's first input
    and the offsets of this rank's shard in it (None outside a mesh, or
    for an input every rank holds whole), so a random rule draws the bits
    one device would draw for those elements."""

    def __init__(self, attrs: Dict[str, Any], device, seed=None, op=None,
                 live=None, recompute=False, amp=False, program=None,
                 env=None, mesh=None, shards=None):
        self.attrs = attrs
        self.device = torch.device(device)
        self.seed = seed
        self.op = op
        self.live = live
        self.recompute = recompute
        self.amp = amp
        self.program = program
        self.env = env
        self.mesh = mesh
        self.shards = shards
        self._generator = None

    def origin(self, slot: str):
        """(global shape, offsets) of this rank's shard of the slot's
        first input, or None when it is not split over ranks."""
        return self.shards.get(slot) if self.shards else None

    def run_block(self, block_idx: int, env: Dict[str, Any], step: int = 0):
        """Run block `block_idx` of the program on `env` (mutated and
        returned). The random ops of iteration `step` draw from seeds
        derived from (this op's seed, step, their index in the block):
        the JAX package's `fold_in(key, t)`, so a grad's recompute draws
        the forward's numbers."""
        from .lowering import run_block
        return run_block(self.program, block_idx, env, self.device,
                         seed=self.seed or 0, counter=step, amp=self.amp,
                         recompute=self.recompute)

    @property
    def generator(self):
        if self._generator is None and self.seed is not None \
                and self.device.type != "meta":
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(self.seed)
        return self._generator

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)

    def wants(self, slot: str) -> bool:
        """Whether anything reads a var of this op's output `slot`: an
        op's input, a fetch, or a persistable write-back
        (``core/executor.py::_StepPlan``). The JAX package computes every
        output as an expression that XLA drops when nothing reads it; a
        rule may skip an output that is not wanted. Only names in the
        block's op inputs count: a hand-written grad that reads a forward
        output through `ctx.fwd_outs` (the `dropout` bits path's `Mask`)
        is not seen here, so such a rule keeps computing that output."""
        if self.live is None or self.op is None:
            return True
        return any(n in self.live for n in self.op.outputs.get(slot, ()))


def _cast_to(v, dt_from, dt_to):
    if isinstance(v, torch.Tensor) and v.dtype == dt_from:
        return v.to(dt_to)
    return v


def _amp_cast(opdef: OpDef, ins_by_slot):
    """(from, to) dtypes the AMP policy casts `opdef`'s inputs between,
    or None."""
    if opdef.type in AMP_BF16_OPS:
        return torch.float32, torch.bfloat16
    if opdef.type in AMP_F32_OPS:
        return torch.bfloat16, torch.float32
    if opdef.type in AMP_DOWNCAST_OPS:
        dtypes = {v.dtype for vals in ins_by_slot.values() for v in vals
                  if isinstance(v, torch.Tensor)}
        if {torch.bfloat16, torch.float32} <= dtypes:
            return torch.float32, torch.bfloat16
    return None


def call_rule(opdef: OpDef, ctx: LoweringContext,
              ins_by_slot: Dict[str, List[Any]]):
    """Dispatch tensors to the rule per its signature, under the AMP
    policy when `ctx.amp`; normalize outputs to {slot: [tensor, ...]}.
    Integer tensors and float64 pass the policy unchanged."""
    cast = _amp_cast(opdef, ins_by_slot) if ctx.amp else None
    kwargs = {}
    for slot in opdef.input_slots:
        vals = ins_by_slot.get(slot)
        if not vals:
            if slot not in opdef.optional_slots:
                raise ValueError(
                    f"op {opdef.type}: required input slot {slot!r} missing")
            continue
        if cast is not None:
            vals = [_cast_to(v, *cast) for v in vals]
        kwargs[slot] = vals[0] if len(vals) == 1 else list(vals)
    out = opdef.lower(ctx, **kwargs) or {}
    return {slot: (list(v) if isinstance(v, (list, tuple)) else [v])
            for slot, v in out.items()}


# ---------------------------------------------------------------------------
# Build-time shape inference on meta tensors.
# ---------------------------------------------------------------------------

def _mark_dynamic(shape_a, shape_b):
    """A dim that moved when the sentinel moved derives from a dynamic
    input dim -> -1."""
    if shape_b is None:
        return tuple(int(d) for d in shape_a)
    return tuple(-1 if int(a) != int(b) else int(a)
                 for a, b in zip(shape_a, shape_b))


def _eval_meta(opdef, attrs, ins_by_slot, sentinel):
    metas = {slot: [torch.empty([sentinel if d == -1 else int(d)
                                 for d in shape],
                                dtype=types.torch_dtype(dtype), device="meta")
                    for shape, dtype in pairs]
             for slot, pairs in ins_by_slot.items()}
    ctx = LoweringContext(attrs, "meta", seed=0 if opdef.needs_rng else None)
    return call_rule(opdef, ctx, metas)


# (op_type, attrs json, input signature) -> inferred result: model
# builders repeat identical layers, so one meta run serves them all
_infer_cache: Dict[tuple, Dict[str, List[tuple]]] = {}
_MAX_INFER_CACHE = 4096


def _infer_cache_key(op_type, attrs, ins_by_slot):
    try:
        akey = json.dumps(attrs, sort_keys=True, default=repr)
    except (TypeError, ValueError):  # unserializable attr -> don't cache
        return None
    sig = tuple(sorted((slot, tuple((tuple(s), str(d)) for s, d in pairs))
                       for slot, pairs in ins_by_slot.items()))
    return (op_type, akey, sig)


def infer_op_shapes(op_type: str, attrs: Dict[str, Any],
                    ins_by_slot: Dict[str, List[Any]]):
    """Return {output_slot: [(shape, dtype), ...]} for an op given input
    (shape, dtype) pairs, -1 marking a dim unknown until run time."""
    opdef = get_op_def(op_type)
    key = _infer_cache_key(op_type, attrs, ins_by_slot)
    hit = _infer_cache.get(key) if key is not None else None
    if hit is not None:
        return {slot: list(pairs) for slot, pairs in hit.items()}
    had_dynamic = any(d == -1 for pairs in ins_by_slot.values()
                      for shape, _ in pairs for d in shape)
    result = _eval_meta(opdef, attrs, ins_by_slot, DIM_SENTINEL)
    result_alt = (_eval_meta(opdef, attrs, ins_by_slot, DIM_SENTINEL_ALT)
                  if had_dynamic else None)
    out = {}
    for slot, vals in result.items():
        alts = result_alt[slot] if result_alt is not None \
            else [None] * len(vals)
        out[slot] = [(_mark_dynamic(v.shape,
                                    a.shape if a is not None else None),
                      types.canonical_dtype(v.dtype))
                     for v, a in zip(vals, alts)]
    if key is not None:
        if len(_infer_cache) >= _MAX_INFER_CACHE:
            _infer_cache.pop(next(iter(_infer_cache)))
        _infer_cache[key] = {slot: list(pairs) for slot, pairs in out.items()}
    return out
