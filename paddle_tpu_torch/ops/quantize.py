"""Fake-quantization ops for quantization-aware training and int8
inference (mirror of ``paddle_tpu/ops/quantize.py``; reference
fake_quantize_op.cc, fake_dequantize_op.cc).

Quantize-dequantize stays in float, and the grad is the straight-through
estimator: the output is x + (q - x) with the parenthesis detached, as
the JAX rule's x + stop_gradient(q - x). In float32 that sum is not
always q, so the port computes the same sum rather than q with a custom
grad. `torch.round`, like `jnp.round`, rounds half to even, and the
scale keeps the JAX rule's floor of 1e-12.

The JAX rules divide by constants (the bin count, `max_range`), and the
JAX package's executor jits its step, where XLA turns a division by a
constant into a product with the constant's float32 reciprocal: an ulp
off the quotient in a few percent of the elements. The rules here take
that product, so their outputs are the JAX package's bit for bit (a
later quantizer rounds them again, where one ulp can move a value to
the next bin).
"""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .math import jax_abs, jax_clip


def _ste(x, q):
    """Straight-through estimator: forward x + (q - x), backward
    identity."""
    return x + (q - x).detach()


def _quant(x, scale, bin_cnt):
    s = torch.maximum(scale, scale.new_full((), 1e-12))
    return torch.round(jax_clip(x / s, -1.0, 1.0) * bin_cnt) * s * (
        1.0 / bin_cnt)


def _bin_cnt(ctx):
    return (1 << (int(ctx.attr("bit_length", 8)) - 1)) - 1


@register_op("fake_quantize_abs_max", propagate_seqlen=False)
def _fake_quantize_abs_max(ctx, X):
    """Dynamic per-tensor abs-max quantization (reference
    fake_quantize_op.cc quantize_type=abs_max)."""
    scale = jax_abs(X).amax()
    return {"Out": _ste(X, _quant(X, scale, _bin_cnt(ctx))),
            "OutScale": scale.reshape(1)}


@register_op("fake_quantize_range_abs_max", propagate_seqlen=False)
def _fake_quantize_range_abs_max(ctx, X, InScale=None):
    """range_abs_max: in training the scale is max(running scale, the
    batch's abs-max); at `is_test` the stored scale, unchanged. The layer
    writes `OutScale` back onto the `InScale` var, so the scale is state
    that grows across steps."""
    cur = jax_abs(X).amax()
    if InScale is None:
        scale = cur
    elif ctx.attr("is_test", False):
        scale = InScale.reshape(())
    else:
        scale = torch.maximum(InScale.reshape(()), cur)
    return {"Out": _ste(X, _quant(X, scale, _bin_cnt(ctx))),
            "OutScale": scale.reshape(1)}


@register_op("fake_dequantize_max_abs", propagate_seqlen=False)
def _fake_dequantize_max_abs(ctx, X, Scale):
    """reference fake_dequantize_op.cc: Out = X * Scale / max_range."""
    return {"Out": X * Scale.reshape(()) * (
        1.0 / ctx.attr("max_range", 127.0))}
