"""Dropout as one hand-written kernel: mask made in the kernel, regenerated
in the backward pass.

Counterpart of ``paddle_tpu/ops/pallas_dropout.py``. That kernel seeds the
TPU's hardware generator per (seed, tile) and draws its bits in fast
memory, so dropout is one read and one write of the tensor, and its
backward is the same kernel on `dy` with the same seed: no mask is stored.
The card has no such generator, so the kernel of ``csrc/dropout.cu``
hashes (seed, linear element index) instead, murmur3's fmix32 twice, and
keeps an element when the full 32-bit word reaches the JAX kernel's
32-bit threshold (``rate * 2**32``, `keep_threshold`). The mask is
therefore a function of the seed and the linear index only: the same for
`[4, 256]` and `[2, 2, 256]`, whatever the grid. `dropout_reference` is the plain PyTorch version, bit for bit
the kernel's mask and output (int64 holding uint32 values, the helpers of
``ops/nn.py``).

The kernel takes float32 or bf16 (each its own instantiation, counted
as `dropout` and `dropout_bf16`): the same keep bits for the same seed
and element index in both, the kept elements multiplied by 1/(1 - rate)
rounded to the tensor's dtype, as the JAX kernel's
``jnp.asarray(inv, x.dtype)`` rounds it (1.109375 in bf16 at rate 0.1),
and `Mask` in the tensor's dtype.

It is reached from the `dropout` op only with ``FLAGS_dropout_impl=pallas``
(the JAX package's name for its kernel, see ``flags.py``), on tensors that
pass `supports`. On a CUDA tensor the wrapper launches the kernel or
raises; on a CPU tensor it runs the plain version; a meta tensor gets
empty outputs.
"""

from __future__ import annotations

import torch

from ..core import types
from . import native
from .nn import M32, _GOLDEN, _fmix32, _mul32

_LANES = 128
_COL_MULT = 0x85EBCA77


def supports(x, rate) -> bool:
    """Kernel applicability, the JAX package's gate: a minor dim that is a
    multiple of 128 and a nontrivial rate."""
    if not (0.0 < rate < 1.0) or not tuple(x.shape):
        return False
    return x.shape[-1] % _LANES == 0 and x.numel() > 0


def keep_threshold(rate: float) -> int:
    """Keep an element when its 32-bit hash, read as unsigned, is >= this.
    The JAX kernel compares the word as signed against
    ``-2**31 + rate * 2**32`` (clamped to int32); adding 2**31 to both
    sides gives the same comparison on the unsigned word."""
    signed = int(min(max(-2 ** 31 + rate * 2 ** 32, -2 ** 31), 2 ** 31 - 1))
    return signed + 2 ** 31


def _keep_range(seed: int, start: int, stop: int, rate: float, device):
    """The kernel's keep bits for linear indices [start, stop), a bool
    vector."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    seed = int(seed) & M32
    if stop <= 1 << 32:               # high word 0 throughout: one key
        key = _fmix32(seed)
    else:
        key = _fmix32(seed ^ _mul32(idx >> 32, _GOLDEN))
        idx = idx & M32
    return _fmix32(key ^ _mul32(idx, _COL_MULT)) >= keep_threshold(rate)


def drop_scale(rate: float, dtype) -> float:
    """1 / (1 - rate) rounded to `dtype`, the value kept elements are
    multiplied by."""
    return types.scalar_as(1.0 / (1.0 - rate), dtype)


def dropout_reference(x, seed: int, rate: float, base: int = 0):
    """Plain version: returns (out, mask), `mask` 1.0 where kept. `base`
    is the linear index of x's first element in the whole tensor."""
    keep = _keep_range(seed, base, base + x.numel(), rate,
                       x.device).reshape(x.shape)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return (torch.where(keep, x * drop_scale(rate, x.dtype), zero),
            keep.to(x.dtype))


# element dtype -> (C entry point, launch counter)
_ENTRIES = {torch.float32: ("ptt_dropout_f32", "dropout"),
            torch.bfloat16: ("ptt_dropout_bf16", "dropout_bf16")}


def _dropout_cuda(x, seed: int, rate: float, want_mask: bool, base: int):
    dev = x.device
    if x.dtype not in _ENTRIES:
        raise ValueError(f"dropout kernel takes float32 or bfloat16, got "
                         f"{x.dtype}")
    if base % 8:
        raise ValueError(f"dropout kernel: base {base} is not a multiple "
                         f"of 8")
    entry, counter = _ENTRIES[x.dtype]
    x = x.contiguous()
    out = torch.empty_like(x)
    mask = torch.empty_like(x) if want_mask else None
    if x.numel() == 0:
        return out, mask
    err = getattr(native.lib(), entry)(
        x.data_ptr(), out.data_ptr(),
        mask.data_ptr() if want_mask else None, x.numel(), int(base),
        int(seed) & M32, keep_threshold(rate), drop_scale(rate, x.dtype),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    native.check(err, "dropout launch")
    native.count_launch(counter)
    if want_mask:
        native.count_launch("dropout_mask")
    return out, mask


def dropout_forward(x, seed: int, rate: float, want_mask: bool = False,
                    base: int = 0):
    """out (and the op's Mask when asked for, written in the same pass):
    the kernel on a card, the plain version on the host. Returns
    (out, mask or None). No autograd: `dropout_kernel` is the
    differentiable form, and the `dropout` op has its own grad rule.
    `base` is the linear index of x's first element in the whole tensor
    (a rank's rows of a batch split over ranks; a multiple of 8)."""
    if x.device.type == "cuda":
        return _dropout_cuda(x, seed, rate, want_mask, base)
    if x.device.type == "meta":
        return torch.empty_like(x), (torch.empty_like(x) if want_mask
                                     else None)
    if x.device.type == "cpu":
        out, mask = dropout_reference(x, seed, rate, base)
        return out, (mask if want_mask else None)
    raise ValueError(f"dropout kernel: no path for device {x.device}")


class _DropoutKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, rate):
        ctx.seed, ctx.rate = seed, rate
        return dropout_forward(x, seed, rate)[0]

    @staticmethod
    def backward(ctx, dy):
        # the same kernel on dy with the forward's seed: no stored mask
        return dropout_forward(dy, ctx.seed, ctx.rate)[0], None, None


def dropout_kernel(x, seed: int, rate: float):
    """Upscale-in-train dropout of `x` (any shape that `supports` takes;
    float32 or bf16), keyed by the uint32 `seed`. Differentiable: the backward
    pass reruns the kernel on the incoming gradient."""
    return _DropoutKernel.apply(x, int(seed), float(rate))
