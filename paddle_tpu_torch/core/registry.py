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
    def __init__(self, type: str, lower: Callable, needs_rng: bool):
        self.type = type
        self.lower = lower
        self.needs_rng = needs_rng
        self.grad_lower: Optional[Callable] = None
        # parameter names of the rule (minus ctx) = input slot names
        params = list(inspect.signature(lower).parameters.values())[1:]
        self.input_slots = [p.name for p in params]
        self.optional_slots = {p.name for p in params
                               if p.default is not inspect.Parameter.empty}


_REGISTRY: Dict[str, OpDef] = {}


def register_op(type: str, needs_rng: bool = False):
    """Decorator registering the rule for op `type`."""

    def deco(fn):
        if type in _REGISTRY:
            raise ValueError(f"op {type!r} already registered")
        _REGISTRY[type] = OpDef(type, fn, needs_rng)
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
            raise ValueError(
                f"register_grad({type!r}): forward op {type!r} is not "
                f"registered — register_op must run first")
        _REGISTRY[type].grad_lower = fn
        return fn

    return deco


def get_op_def(type: str) -> OpDef:
    if type not in _REGISTRY:
        raise KeyError(f"op type {type!r} is not registered")
    return _REGISTRY[type]


def is_registered(type: str) -> bool:
    return type in _REGISTRY


def registered_ops() -> List[str]:
    return sorted(_REGISTRY)


class LoweringContext:
    """Per-op context handed to rules.

    `device` is where creation ops (fill_constant, gaussian_random) put
    their output. A random op gets `seed`, a host integer derived from
    (program seed, run, op index): kernels and counter-hash dropout take
    it as it is, so no random number is ever read back from the card.
    `generator` is a `torch.Generator` on `device` seeded from it, made
    on first use (None for an op without a seed, and in meta runs)."""

    def __init__(self, attrs: Dict[str, Any], device, seed=None, op=None):
        self.attrs = attrs
        self.device = torch.device(device)
        self.seed = seed
        self.op = op
        self._generator = None

    @property
    def generator(self):
        if self._generator is None and self.seed is not None \
                and self.device.type != "meta":
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(self.seed)
        return self._generator

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)


def call_rule(opdef: OpDef, ctx: LoweringContext,
              ins_by_slot: Dict[str, List[Any]]):
    """Dispatch tensors to the rule per its signature; normalize outputs
    to {slot: [tensor, ...]}."""
    kwargs = {}
    for slot in opdef.input_slots:
        vals = ins_by_slot.get(slot)
        if not vals:
            if slot not in opdef.optional_slots:
                raise ValueError(
                    f"op {opdef.type}: required input slot {slot!r} missing")
            continue
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
