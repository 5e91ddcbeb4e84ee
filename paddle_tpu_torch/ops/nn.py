"""Neural-net op rules (the slice's subset): `layer_norm`, `dropout`.

Mirror of ``paddle_tpu/ops/nn.py``. `dropout` is the JAX package's default
path, ``_bits_dropout``: one byte per element from a counter hash
(murmur3's fmix32 over the element's linear index and the op's seed)
decides keep at 1/256 resolution, bit for bit the JAX package's bits for
the same seed words. The JAX package computes it
in XLA, outside any Pallas kernel; here it is plain PyTorch integer math
(int64 holding uint32 values, every product reduced mod 2**32 by
`_mul32`). Its hand-written kernel (``ops/pallas_dropout.py``, reached
only with ``FLAGS_dropout_impl=pallas``) is not ported yet.

The grad does not hash again. XLA drops the JAX package's `Mask` output
when nothing reads it, so its grad regenerates the bits; an eager
interpreter computes `Mask` in the forward and keeps it to the end of the
step anyway, so `_dropout_grad` selects by it: the hash, a few dozen
int64 passes over the tensor, runs once a step instead of twice.

The same integer helpers key the attention-weight dropout of the flash
kernels (``ops/flash_attention.py``).
"""

from __future__ import annotations

import torch

from ..core.registry import register_grad, register_op

M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_KNUTH = 2654435761


def seed32(seed: int) -> int:
    """The op's host seed (up to 64 bits) folded to 32: its two words
    `lo`, `hi` combine as the JAX package combines a key's two words,
    ``lo ^ (hi * 0x9E3779B9)``."""
    lo, hi = int(seed) & M32, (int(seed) >> 32) & M32
    return lo ^ ((hi * _GOLDEN) & M32)


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 tensors holding uint32 values and a
    uint32 constant, without leaving int64: x is split into 16-bit
    halves, so no partial product passes 2**48."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & M32


def _fmix32(x):
    """murmur3's 32-bit finalizer on int64 tensors holding uint32 values."""
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def _hash_bits8(seed: int, shape, device):
    """One random byte per element (uint8): fmix32 of the element's
    linear index * 2654435761 + `seed` (a uint32), the JAX package's
    `_hash_bits8` bit for bit."""
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    x = (_mul32(idx, _KNUTH) + seed) & M32
    return (_fmix32(x) & 0xFF).to(torch.uint8)


def _keep_bits(seed: int, shape, p: float, device):
    t = round((1.0 - p) * 256) - 1
    if t < 0:                       # p ~ 1: nothing survives
        return torch.zeros(shape, dtype=torch.bool, device=device)
    return _hash_bits8(seed, shape, device) <= min(255, t)


def _bits_dropout(x, seed: int, p: float, scale: float):
    """Keep-and-scale by the hashed bits; returns (out, keep)."""
    keep = _keep_bits(seed, x.shape, p, x.device)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device)), keep


@register_op("layer_norm")
def _layer_norm(ctx, X, Scale=None, Bias=None):
    eps = ctx.attr("epsilon", 1e-5)
    begin = ctx.attr("begin_norm_axis", 1)
    axes = tuple(range(begin, X.ndim))
    x32 = X.float()
    mean = x32.mean(dim=axes, keepdim=True)
    var = x32.var(dim=axes, unbiased=False, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    bshape = (1,) * begin + tuple(X.shape[begin:])
    if Scale is not None:
        y = y * Scale.reshape(bshape)
    if Bias is not None:
        y = y + Bias.reshape(bshape)
    return {"Y": y.to(X.dtype), "Mean": mean.reshape(X.shape[:begin]),
            "Variance": var.reshape(X.shape[:begin])}


@register_op("dropout", needs_rng=True)
def _dropout(ctx, X):
    p = ctx.attr("dropout_prob", 0.5)
    impl = ctx.attr("dropout_implementation", "downgrade_in_infer")
    if ctx.attr("is_test", False):
        out = X if impl == "upscale_in_train" else X * (1.0 - p)
        return {"Out": out, "Mask": torch.ones_like(X)}
    if p >= 1.0:
        # degenerate: drop everything (upscale would divide by zero)
        return {"Out": torch.zeros_like(X), "Mask": torch.zeros_like(X)}
    scale = 1.0 if impl != "upscale_in_train" else 1.0 / (1.0 - p)
    out, keep = _bits_dropout(X, seed32(ctx.seed), float(p), float(scale))
    return {"Out": out, "Mask": keep.to(X.dtype)}


@register_grad("dropout")
def _dropout_grad(ctx, ins, out_grads):
    """dX from dOut through the forward's own keep mask."""
    g = out_grads.get("Out", [None])[0]
    X = ins["X"][0]
    if g is None:
        return {"X": torch.zeros_like(X)}
    p = ctx.attr("dropout_prob", 0.5)
    impl = ctx.attr("dropout_implementation", "downgrade_in_infer")
    if ctx.attr("is_test", False):
        return {"X": g if impl == "upscale_in_train" else g * (1.0 - p)}
    if p >= 1.0:
        return {"X": torch.zeros_like(g)}
    scale = 1.0 if impl != "upscale_in_train" else 1.0 / (1.0 - p)
    keep = ctx.fwd_outs["Mask"][0] != 0
    return {"X": torch.where(keep, g * scale,
                             torch.zeros((), dtype=g.dtype, device=g.device))}
