"""Neural-net op rules: `conv2d`, `depthwise_conv2d`, `conv2d_transpose`,
`pool2d`, `batch_norm`, `layer_norm`, `dropout`, `lrn`, `grid_sampler`
and `im2sequence`.

Mirror of ``paddle_tpu/ops/nn.py``. The JAX package computes convs and
pools in XLA (`lax.conv_general_dilated`, `lax.reduce_window`), outside
any Pallas kernel; here they are torch's own (cuDNN on the card). Both
take NCHW or NHWC. An NHWC tensor goes to torch as its NCHW view
(`permute(0, 3, 1, 2)`, channels-last strides), which cuDNN runs without
a copy, and the result's view back is NHWC again: only an average pool
over windows takes a copy (`_window_pool` says why). `batch_norm`
normalizes with the biased batch variance (the JAX package's `jnp.var`)
and updates the running stats in place.

`dropout` is the JAX package's default
path, ``_bits_dropout``: one byte per element from a counter hash
(murmur3's fmix32 over the element's linear index and the op's seed)
decides keep at 1/256 resolution, bit for bit the JAX package's bits for
the same seed words. The JAX package computes it
in XLA, outside any Pallas kernel; here it is plain PyTorch integer math
(int64 holding uint32 values, every product reduced mod 2**32 by
`_mul32`). With ``FLAGS_dropout_impl=pallas`` an op that passes the JAX
package's gate (`upscale_in_train`, 0 < rate < 1, minor dim a multiple of
128) runs the hand-written kernel of ``ops/dropout_kernel.py`` instead,
in its forward and again, on `dOut` with the forward's seed, in its grad,
which does not read `Mask`. The forward writes `Mask` in the same pass
only when something reads it (`LoweringContext.wants`: an op input, a
fetch, a write-back); in a training step nothing does, so the kernel
moves 8 bytes an element instead of 12, as XLA drops the JAX package's
unread `Mask`. On a
CPU tensor that path runs the kernel's plain version, where the JAX
package falls back to the bits path (the TPU's generator cannot run on a
CPU): under the flag the two packages' masks differ on the host as they
do on the devices.

On the bits path the grad does not hash again. XLA drops the JAX package's `Mask` output
when nothing reads it, so its grad regenerates the bits; an eager
interpreter computes `Mask` in the forward and keeps it to the end of the
step anyway, so `_dropout_grad` selects by it: the hash, a few dozen
int64 passes over the tensor, runs once a step instead of twice.

The same integer helpers key the attention-weight dropout of the flash
kernels (``ops/flash_attention.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import flags as _flags
from ..core import types
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


def _linear_index(shape, device, origin=None):
    """Each element's linear index, int64 of `shape`; with `origin`
    (global shape, offsets) its index in the whole tensor of which this
    is the shard at those offsets."""
    if origin is None:
        n = 1
        for d in shape:
            n *= int(d)
        return torch.arange(n, dtype=torch.int64,
                            device=device).reshape(shape)
    gshape, offs = origin
    idx = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for d in reversed(range(len(shape))):
        pos = torch.arange(int(offs[d]), int(offs[d]) + int(shape[d]),
                           dtype=torch.int64, device=device) * stride
        idx = idx + pos.reshape([-1] + [1] * (len(shape) - 1 - d))
        stride *= int(gshape[d])
    return idx.expand(tuple(int(d) for d in shape))


def _hash_bits8(seed: int, shape, device, origin=None):
    """One random byte per element (uint8): fmix32 of the element's
    linear index * 2654435761 + `seed` (a uint32), the JAX package's
    `_hash_bits8` bit for bit (the index in the whole tensor when
    `origin` places this shard in it)."""
    idx = _linear_index(shape, device, origin)
    x = (_mul32(idx, _KNUTH) + seed) & M32
    return (_fmix32(x) & 0xFF).to(torch.uint8)


def _keep_bits(seed: int, shape, p: float, device, origin=None):
    t = round((1.0 - p) * 256) - 1
    if t < 0:                       # p ~ 1: nothing survives
        return torch.zeros(shape, dtype=torch.bool, device=device)
    return _hash_bits8(seed, shape, device, origin) <= min(255, t)


def _bits_dropout(x, seed: int, p: float, scale: float, origin=None):
    """Keep-and-scale by the hashed bits, the scale rounded to x's dtype
    as the JAX package rounds it; returns (out, keep)."""
    keep = _keep_bits(seed, x.shape, p, x.device, origin)
    return torch.where(keep, x * types.scalar_as(scale, x.dtype),
                       torch.zeros((), dtype=x.dtype, device=x.device)), keep


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _nchw(x, fmt):
    """`x` as torch's NCHW: an NHWC tensor's view, no copy."""
    return x if fmt == "NCHW" else x.permute(0, 3, 1, 2)


def _from_nchw(y, fmt):
    return y if fmt == "NCHW" else y.permute(0, 2, 3, 1)


def _conv(ctx, Input, Filter, Bias, groups):
    fmt = ctx.attr("data_format", "NCHW")
    out = _from_nchw(F.conv2d(
        _nchw(Input, fmt), Filter, None,
        stride=_pair(ctx.attr("strides", [1, 1])),
        padding=_pair(ctx.attr("paddings", [0, 0])),
        dilation=_pair(ctx.attr("dilations", [1, 1])),
        groups=groups), fmt)
    if Bias is not None:
        bshape = (1, -1, 1, 1) if fmt == "NCHW" else (1, 1, 1, -1)
        out = out + Bias.reshape(bshape)
    return {"Output": out}


@register_op("conv2d", propagate_seqlen=False)
def _conv2d(ctx, Input, Filter, Bias=None):
    """Conv in NCHW or NHWC (reference conv_op.cc `data_format`). Filter
    is always stored OIHW, so parameters are layout-independent."""
    return _conv(ctx, Input, Filter, Bias, ctx.attr("groups", 1))


@register_op("depthwise_conv2d", propagate_seqlen=False)
def _depthwise_conv2d(ctx, Input, Filter, Bias=None):
    """`conv2d` with one group a channel: groups is the input's channel
    count under its `data_format`, whatever the attr says."""
    c_axis = 1 if ctx.attr("data_format", "NCHW") == "NCHW" else 3
    return _conv(ctx, Input, Filter, Bias, Input.shape[c_axis])


@register_op("conv2d_transpose", propagate_seqlen=False)
def _conv2d_transpose(ctx, Input, Filter, Bias=None):
    """The gradient of a conv as a forward op (reference
    conv_transpose_op.cc), NCHW. The filter is stored [in_c, out_c, kh,
    kw], `F.conv_transpose2d`'s own layout; with no output padding the
    output is (in - 1) s + d (k - 1) + 1 - 2p, the JAX rule's size."""
    out = F.conv_transpose2d(
        Input, Filter, None, stride=_pair(ctx.attr("strides", [1, 1])),
        padding=_pair(ctx.attr("paddings", [0, 0])),
        dilation=_pair(ctx.attr("dilations", [1, 1])))
    if Bias is not None:
        out = out + Bias.reshape(1, -1, 1, 1)
    return {"Output": out}


@register_op("lrn", propagate_seqlen=False)
def _lrn(ctx, X):
    """Local response norm across channels, NCHW: mid = (k + alpha * the
    sum of X^2 over n neighbouring channels)^beta, Out = X / mid, summed
    as the JAX rule sums its n shifted slices (k defaults to 2.0 here,
    1.0 in the layer, as in the JAX package)."""
    n = ctx.attr("n", 5)
    half = n // 2
    sq = X * X
    pad = F.pad(sq, (0, 0, 0, 0, half, n - 1 - half))
    c = X.shape[1]
    acc = sum(pad[:, i:i + c] for i in range(n))
    mid = torch.pow(ctx.attr("k", 2.0) + ctx.attr("alpha", 1e-4) * acc,
                    ctx.attr("beta", 0.75))
    return {"Out": X / mid, "MidOut": mid}


@register_op("im2sequence", propagate_seqlen=False)
def _im2sequence(ctx, X):
    """Every (kh, kw) patch of NCHW `X` (padded by `paddings` = [top,
    left, bottom, right]) as a row: [N * OH * OW, C * kh * kw], rows in
    image-major, then row-major patch order, each row's values in the
    order (c, i, j). `F.unfold` gives exactly the patch layout of the JAX
    rule's `lax.conv_general_dilated_patches`."""
    kernels = _pair(ctx.attr("kernels"))
    strides = _pair(ctx.attr("strides", [1, 1]))
    pads = ctx.attr("paddings", [0, 0, 0, 0])
    xp = F.pad(X, (pads[1], pads[3], pads[0], pads[2]))
    patches = F.unfold(xp, kernels, stride=strides)    # [N, C*kh*kw, L]
    n, ck, length = patches.shape
    return {"Out": patches.transpose(1, 2).reshape(n * length, ck)}


@register_op("grid_sampler", propagate_seqlen=False)
def _grid_sampler(ctx, X, Grid):
    """Bilinear grid sample with aligned corners, NCHW, as the JAX rule
    writes it: each of the four corners' indices clamped into the image
    (not the coordinate), the weights from the unclamped coordinate; the
    corners gathered from X."""
    n, c, h, w = X.shape
    gx = (Grid[..., 0] + 1.0) * (w - 1) / 2.0
    gy = (Grid[..., 1] + 1.0) * (h - 1) / 2.0
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = (gx - x0)[..., None], (gy - y0)[..., None]
    batch = torch.arange(n, device=X.device)[:, None, None]

    def sample(xi, yi):              # [N, Hg, Wg, C]
        xi = xi.clamp(0, w - 1).long()
        yi = yi.clamp(0, h - 1).long()
        return X[batch, :, yi, xi]

    out = (sample(x0, y0) * (1 - wx) * (1 - wy)
           + sample(x0 + 1, y0) * wx * (1 - wy)
           + sample(x0, y0 + 1) * (1 - wx) * wy
           + sample(x0 + 1, y0 + 1) * wx * wy)
    return {"Output": out.permute(0, 3, 1, 2)}


def _window_pool(x, ptype, ksize, strides, pads, exclusive):
    """Max or average over (kh, kw) windows of NCHW `x`, padded by `pads`
    on both sides of each spatial dim: max pads with -inf, an exclusive
    average divides by the window's count of real elements, else by
    kh * kw. Torch's pools take a pad of at most half the window; a wider
    one is padded explicitly. An average pools a contiguous NCHW copy of
    `x`: torch's CUDA avg_pool2d computes wrong grads for a channels-last
    input (torch 2.11, CUDA 12.8, on an H100: errors of order 1 against
    the host, `tests/test_torch_cuda.py`). ResNet's average pool is
    global, a mean, and takes no copy. A half-precision average takes
    `_half_window_avg`."""
    fits = all(p <= k // 2 for p, k in zip(pads, ksize))
    if ptype == "max":
        if fits:
            return F.max_pool2d(x, ksize, strides, pads)
        xp = F.pad(x, (pads[1], pads[1], pads[0], pads[0]),
                   value=float("-inf"))
        return F.max_pool2d(xp, ksize, strides)
    x = x.contiguous()
    if x.dtype in (torch.bfloat16, torch.float16):
        return _half_window_avg(x, ksize, strides, pads, exclusive)
    if fits:
        return F.avg_pool2d(x, ksize, strides, pads,
                            count_include_pad=not exclusive,
                            divisor_override=None if exclusive
                            else ksize[0] * ksize[1])
    padding = (pads[1], pads[1], pads[0], pads[0])
    total = F.avg_pool2d(F.pad(x, padding), ksize, strides,
                         divisor_override=1)
    if not exclusive:
        return total / (ksize[0] * ksize[1])
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    return total / F.avg_pool2d(F.pad(ones, padding), ksize, strides,
                                divisor_override=1)


def _window_sum(xp, ksize, strides, out_hw):
    """Sum of each (kh, kw) window of padded NCHW `xp` in its own dtype,
    one add a window element in row-major order from 0: the order and
    rounding of the JAX rule's `lax.reduce_window(X, 0, lax.add, ...)` on
    a bf16 input."""
    (kh, kw), (sh, sw), (oh, ow) = ksize, strides, out_hw
    acc = torch.zeros(xp.shape[:2] + (oh, ow), dtype=xp.dtype,
                      device=xp.device)
    for i in range(kh):
        for j in range(kw):
            acc = acc + xp[:, :, i:i + sh * (oh - 1) + 1:sh,
                           j:j + sw * (ow - 1) + 1:sw]
    return acc


def _half_window_avg(x, ksize, strides, pads, exclusive):
    """The JAX rule's average pool on a bf16 (or fp16) NCHW input: the
    window sum rounded at each add, and the quotient by the count, each
    in x's dtype (torch's avg_pool2d sums in float32 and rounds once,
    one ulp off the JAX rule in most outputs)."""
    padding = (pads[1], pads[1], pads[0], pads[0])
    h, w = x.shape[2] + 2 * pads[0], x.shape[3] + 2 * pads[1]
    out_hw = ((h - ksize[0]) // strides[0] + 1,
              (w - ksize[1]) // strides[1] + 1)
    total = _window_sum(F.pad(x, padding), ksize, strides, out_hw)
    if not exclusive:
        return total / types.scalar_as(float(ksize[0] * ksize[1]), x.dtype)
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    return total / _window_sum(F.pad(ones, padding), ksize, strides, out_hw)


@register_op("pool2d", propagate_seqlen=False)
def _pool2d(ctx, X):
    """Reference pool_op.cc: max or avg, global, adaptive (where the
    output divides the input), NCHW or NHWC. `ceil_mode` is ignored, as
    the JAX package ignores it: output sizes round down."""
    ptype = ctx.attr("pooling_type", "max")
    ksize = _pair(ctx.attr("ksize", [2, 2]))
    fmt = ctx.attr("data_format", "NCHW")
    spatial = (2, 3) if fmt == "NCHW" else (1, 2)
    adaptive = ctx.attr("adaptive", False)
    if ctx.attr("global_pooling", False) or adaptive:
        oh, ow = ksize if adaptive else (1, 1)
        h, w = X.shape[spatial[0]], X.shape[spatial[1]]
        if adaptive and (oh < 1 or ow < 1):
            raise ValueError(
                "adaptive pool2d needs an explicit positive pool_size "
                f"(the output grid); got {(oh, ow)}")
        if (oh, ow) == (1, 1):
            tiles, red = X, spatial
        elif h % oh or w % ow:
            raise NotImplementedError(
                f"adaptive pool2d: output {(oh, ow)} must divide input "
                f"{(h, w)} (unequal bins need ragged windows)")
        elif fmt == "NCHW":
            n, c = X.shape[0], X.shape[1]
            tiles, red = X.reshape(n, c, oh, h // oh, ow, w // ow), (3, 5)
        else:
            n, c = X.shape[0], X.shape[3]
            tiles, red = X.reshape(n, oh, h // oh, ow, w // ow, c), (2, 4)
        keep = (oh, ow) == (1, 1)
        if ptype == "max":
            return {"Out": tiles.amax(dim=red, keepdim=keep)}
        return {"Out": tiles.mean(dim=red, keepdim=keep)}
    out = _window_pool(_nchw(X, fmt), ptype, ksize,
                       _pair(ctx.attr("strides", [1, 1])),
                       _pair(ctx.attr("paddings", [0, 0])),
                       ctx.attr("exclusive", True))
    return {"Out": _from_nchw(out, fmt)}


@register_op("batch_norm", propagate_seqlen=False)
def _batch_norm(ctx, X, Scale, Bias, Mean, Variance):
    """Reference batch_norm_op.cc, as the JAX package computes it: in
    training, Y normalizes X by its batch mean and *biased* variance;
    `SavedMean` is that mean and `SavedVariance` is rsqrt(var + eps), not
    the variance. `MeanOut` and `VarianceOut` are the variables `Mean`
    and `Variance` themselves (``layers/nn.py::batch_norm``): they are
    updated in place, Mean <- momentum * Mean + (1 - momentum) * mean
    (the same with the biased variance), and returned as the same
    tensors, so the scope keeps its objects. A grad op's recompute of
    this rule (``ctx.recompute``) leaves them alone: the forward op
    updated them once. `is_test` normalizes by `Mean` and `Variance` and
    passes them through."""
    eps = ctx.attr("epsilon", 1e-5)
    fmt = ctx.attr("data_layout", "NCHW")
    shape = (1, -1) + (1,) * (X.ndim - 2) if fmt == "NCHW" \
        else (1,) * (X.ndim - 1) + (-1,)
    if ctx.attr("is_test", False):
        inv = torch.rsqrt(Variance.float() + eps)
        y = (X.float() - Mean.reshape(shape)) * inv.reshape(shape)
        y = y * Scale.reshape(shape) + Bias.reshape(shape)
        return {"Y": y.to(X.dtype), "MeanOut": Mean, "VarianceOut": Variance,
                "SavedMean": Mean, "SavedVariance": inv}
    # torch's batch norm in training mode without running stats: it
    # normalizes by the biased variance and returns the batch mean and
    # 1 / sqrt(var + eps) (the reference's SavedVariance)
    x = X.float() if fmt == "NCHW" else X.float().movedim(-1, 1)
    y, mean, inv = torch.native_batch_norm(
        x, Scale.float(), Bias.float(), None, None, True, 0.0, eps)
    y = y if fmt == "NCHW" else y.movedim(1, -1)
    if not ctx.recompute:
        m = ctx.attr("momentum", 0.9)
        var = inv.detach().pow(-2) - eps
        Mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
        Variance.mul_(m).add_(var, alpha=1.0 - m)
    return {"Y": y.to(X.dtype), "MeanOut": Mean, "VarianceOut": Variance,
            "SavedMean": mean, "SavedVariance": inv}


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
        out = X if impl == "upscale_in_train" \
            else X * types.scalar_as(1.0 - p, X.dtype)
        return {"Out": out, "Mask": torch.ones_like(X)}
    if p >= 1.0:
        # degenerate: drop everything (upscale would divide by zero)
        return {"Out": torch.zeros_like(X), "Mask": torch.zeros_like(X)}
    if _takes_kernel(X, p, impl):
        # the grad reruns the kernel on dOut and reads no Mask, so the
        # kernel writes Mask only when an op, a fetch or a write-back does
        from . import dropout_kernel
        want = ctx.wants("Mask")
        out, mask = dropout_kernel.dropout_forward(
            X, seed32(ctx.seed), float(p), want_mask=want,
            base=_kernel_base(ctx, X))
        return {"Out": out, "Mask": mask} if want else {"Out": out}
    scale = 1.0 if impl != "upscale_in_train" else 1.0 / (1.0 - p)
    out, keep = _bits_dropout(X, seed32(ctx.seed), float(p), float(scale),
                              ctx.origin("X"))
    return {"Out": out, "Mask": keep.to(X.dtype)}


def _kernel_base(ctx, x) -> int:
    """The linear index of this rank's first element of X in the whole
    tensor (0 outside a mesh): the dropout kernel's `base`. The kernel
    walks its elements in order, so the shard must be one run of them."""
    shard = ctx.origin("X")
    if shard is None:
        return 0
    gshape, offs = shard
    if tuple(gshape[1:]) != tuple(x.shape[1:]):
        raise NotImplementedError(
            "dropout kernel: only the leading dim may be split over ranks "
            "(FLAGS_dropout_impl=pallas)")
    return int(offs[0]) * (x[0].numel() if x.shape[0] else 0)


def _takes_kernel(x, p, impl) -> bool:
    """Path choice of a training-mode dropout op: the hand-written kernel
    only when the flag asks for it and the JAX package's gate passes."""
    if _flags.get_flag("dropout_impl") != "pallas" \
            or impl != "upscale_in_train":
        return False
    from . import dropout_kernel
    return dropout_kernel.supports(x, p)


@register_grad("dropout")
def _dropout_grad(ctx, ins, out_grads):
    """dX from dOut: the kernel again on the kernel path, else through
    the forward's own keep mask."""
    g = out_grads.get("Out", [None])[0]
    X = ins["X"][0]
    if g is None:
        return {"X": torch.zeros_like(X)}
    p = ctx.attr("dropout_prob", 0.5)
    impl = ctx.attr("dropout_implementation", "downgrade_in_infer")
    if ctx.attr("is_test", False):
        return {"X": g if impl == "upscale_in_train"
                else g * types.scalar_as(1.0 - p, g.dtype)}
    if p >= 1.0:
        return {"X": torch.zeros_like(g)}
    if _takes_kernel(g, p, impl):
        from . import dropout_kernel
        return {"X": dropout_kernel.dropout_forward(
            g, seed32(ctx.seed), float(p), base=_kernel_base(ctx, g))[0]}
    scale = 1.0 if impl != "upscale_in_train" else 1.0 / (1.0 - p)
    keep = ctx.fwd_outs["Mask"][0] != 0
    return {"X": torch.where(keep, g * types.scalar_as(scale, g.dtype),
                             torch.zeros((), dtype=g.dtype, device=g.device))}
