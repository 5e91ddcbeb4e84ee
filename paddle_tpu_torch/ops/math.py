"""Math / elementwise / activation / reduction op rules.

Mirror of ``paddle_tpu/ops/math.py``, every rule of it: the elementwise
ops with the reference's broadcast `axis` (`add` ... `pow`, `mod`,
`floordiv`), `mul`, `matmul`, `scale`, `sum`, `mean`, `cast`, `clip`,
`clip_by_norm`, the `reduce_*` ops, the activations, `prelu`,
`softmax`, `log_softmax`, `cumsum`, `top_k`, `arg_max` / `arg_min`,
`isfinite`, `maximum`, `l2_normalize`, `cos_sim`, the comparisons and
the logical ops. Each rule is written as its JAX rule is, so that its
grad is autograd through the same expression: where that expression
takes `jnp.clip`, `jnp.maximum` or `jnp.abs`, the grad at a bound, a tie
or 0 is theirs (`jax_clip`, `torch.maximum`, `jax_abs`; `torch.clamp`
and `torch.abs` differ there). Matrix products go to `torch.matmul`,
as the JAX package leaves them to XLA; in float32 on the card they run
in full float32 (`torch.backends.cuda.matmul.allow_tf32` is False by
default).

On a bf16 input each rule rounds where the JAX rule rounds: a Python
scalar is rounded to the tensor's dtype first (`types.scalar_as`, JAX's
weak typing); a sum (`reduce_sum`, the norm of `clip_by_norm`, the
softmax's denominator) adds in float32 and rounds once, as `jnp.sum`
upcasts a bf16 input; and `softmax` rounds exp(x - max), the sum and the
quotient each to bf16, as ``jax.nn.softmax`` does in X's dtype, and
`sigmoid` rounds exp(-x), 1 + exp(-x) and the quotient, as `lax.logistic`
does. (Under `jax.jit` on a CPU, XLA may keep an intermediate of such a
chain in float32, ``xla_allow_excess_precision``; the rules here follow
the JAX rule as written, each op rounding to its dtype.)
"""

from __future__ import annotations

import math

import torch

from ..core import types
from ..core.registry import register_op


def _align_y(X, Y, axis):
    """Reference elementwise broadcast semantics (elementwise_op_function.h):
    Y's dims match a contiguous run of X's dims starting at `axis`."""
    if Y.ndim == 0 or X.shape == Y.shape or Y.ndim == X.ndim:
        return Y
    axis = int(axis)
    if axis < 0:
        axis = X.ndim - Y.ndim
    return Y.reshape([1] * axis + list(Y.shape)
                     + [1] * (X.ndim - axis - Y.ndim))


def _register_binary(name, fn):
    """An elementwise or comparison op: fn(X, Y aligned at `axis`)."""
    @register_op(name)
    def _rule(ctx, X, Y, _fn=fn):
        return {"Out": _fn(X, _align_y(X, Y, ctx.attr("axis", -1)))}
    _rule.__name__ = name
    return _rule


_register_binary("elementwise_add", torch.add)
_register_binary("elementwise_sub", torch.sub)
_register_binary("elementwise_mul", torch.mul)
_register_binary("elementwise_div", torch.div)
_register_binary("elementwise_max", torch.maximum)
_register_binary("elementwise_min", torch.minimum)
_register_binary("elementwise_pow", torch.pow)
# `jnp.mod` / `jnp.floor_divide`: the result takes the divisor's sign
# (`torch.fmod` would take the dividend's)
_register_binary("elementwise_mod", torch.remainder)
_register_binary("elementwise_floordiv", torch.floor_divide)
_register_binary("equal", torch.eq)
_register_binary("not_equal", torch.ne)
_register_binary("less_than", torch.lt)
_register_binary("less_equal", torch.le)
_register_binary("greater_than", torch.gt)
_register_binary("greater_equal", torch.ge)
_register_binary("logical_and", torch.logical_and)
_register_binary("logical_or", torch.logical_or)
_register_binary("logical_xor", torch.logical_xor)


@register_op("mul")
def _mul(ctx, X, Y):
    """Flattening matmul (reference mul_op.cc): X flattened to 2-D at
    x_num_col_dims, Y at y_num_col_dims, one GEMM, the result shaped
    X.shape[:x_num_col_dims] + Y.shape[y_num_col_dims:]."""
    xd = ctx.attr("x_num_col_dims", 1)
    yd = ctx.attr("y_num_col_dims", 1)
    if X.dtype != Y.dtype:
        dt = torch.promote_types(X.dtype, Y.dtype)
        X, Y = X.to(dt), Y.to(dt)
    xs, ys = X.shape, Y.shape
    x2 = X.reshape(math.prod(xs[:xd]), math.prod(xs[xd:]))
    y2 = Y.reshape(math.prod(ys[:yd]), math.prod(ys[yd:]))
    return {"Out": torch.matmul(x2, y2).reshape(*xs[:xd], *ys[yd:])}


@register_op("matmul")
def _matmul(ctx, X, Y):
    a = X.transpose(-1, -2) if ctx.attr("transpose_X", False) else X
    b = Y.transpose(-1, -2) if ctx.attr("transpose_Y", False) else Y
    out = torch.matmul(a, b)
    alpha = ctx.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * types.scalar_as(alpha, out.dtype)
    return {"Out": out}


def _register_act(name, fn):
    @register_op(name)
    def _rule(ctx, X, _fn=fn):
        return {"Out": _fn(X)}
    _rule.__name__ = name
    return _rule


class _HalfSigmoid(torch.autograd.Function):
    """`lax.logistic` on a bf16 (or fp16) input as the JAX rule rounds it,
    1 / (1 + exp(-x)) with exp, the sum and the quotient each rounded to
    x's dtype (torch's sigmoid rounds once: about a quarter of bf16
    outputs one ulp off). Its grad is logistic's own, g * (y * (1 - y))
    rounded in that order, so no exp(-x) that overflows reaches the
    backward."""

    @staticmethod
    def forward(ctx, x):
        y = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return g * (y * (1.0 - y))


class _HalfTanh(torch.autograd.Function):
    """tanh on a bf16 (or fp16) input with the grad rounded as the
    transpose of `lax.tanh`'s JVP (g + g y)(1 - y): t = g (1 - y), then
    t and t y as two terms (torch's tanh grad rounds g (1 - y^2) once).
    It takes x twice, `apply(x, x)`, and returns t for one and t y for
    the other: the JAX transpose adds the two into x's cotangent one at
    a time, after what x's other uses gave it, and autograd's buffer
    does the same when they reach it as two grads."""

    @staticmethod
    def forward(ctx, x, x_again):
        y = torch.tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        t = g * (1.0 - y)
        return t, t * y


def _sigmoid(x):
    if x.dtype in (torch.bfloat16, torch.float16):
        return _HalfSigmoid.apply(x)
    return torch.sigmoid(x)


def _tanh(x):
    if x.dtype in (torch.bfloat16, torch.float16):
        return _HalfTanh.apply(x, x)
    return torch.tanh(x)


_register_act("relu", torch.relu)
_register_act("sigmoid", _sigmoid)
_register_act("exp", torch.exp)
_register_act("sqrt", torch.sqrt)
_register_act("square", lambda x: x * x)
_register_act("tanh", _tanh)
_register_act("floor", torch.floor)
_register_act("ceil", torch.ceil)
_register_act("logical_not", torch.logical_not)
_register_act("log", torch.log)
_register_act("rsqrt", torch.rsqrt)
_register_act("sign", torch.sign)
_register_act("round", torch.round)       # half to even, as jnp.round
_register_act("cos", torch.cos)
_register_act("sin", torch.sin)
_register_act("reciprocal", lambda x: 1.0 / x)
_register_act("tanh_shrink", lambda x: x - _tanh(x))


@register_op("cast")
def _cast(ctx, X):
    return {"Out": X.to(types.torch_dtype(ctx.attr("out_dtype", "float32")))}


@register_op("scale")
def _scale(ctx, X):
    s = types.scalar_as(ctx.attr("scale", 1.0), X.dtype)
    b = types.scalar_as(ctx.attr("bias", 0.0), X.dtype)
    if ctx.attr("bias_after_scale", True):
        return {"Out": X * s + b}
    return {"Out": (X + b) * s}


@register_op("sum")
def _sum(ctx, X):
    xs = X if isinstance(X, list) else [X]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


def _sum_as_jnp(x, dims=None, keepdim=False):
    """`jnp.sum`'s rounding: a half-precision input adds in float32 and
    rounds once to its own dtype."""
    if x.dtype not in (torch.bfloat16, torch.float16):
        return x.sum() if dims is None else x.sum(dims, keepdim=keepdim)
    s = x.sum(dtype=torch.float32) if dims is None \
        else x.sum(dims, keepdim=keepdim, dtype=torch.float32)
    return s.to(x.dtype)


def _reduce(ctx, X, fn):
    """Reference reduce_op.cc: over `dim` (default [0]), or every dim
    with `reduce_all` (a [1] result, or all-ones dims with `keep_dim`).
    `fn(x, dims, keepdim)` reduces over a tuple of dims, or over all of
    them when dims is None."""
    keep = ctx.attr("keep_dim", False)
    if ctx.attr("reduce_all", False):
        out = fn(X, None, False)
        return {"Out": out.reshape((1,) * X.ndim if keep else (1,))}
    dims = ctx.attr("dim", [0])
    dims = tuple(dims) if isinstance(dims, (list, tuple)) else (dims,)
    return {"Out": fn(X, dims, keep)}


def _mean_as_jnp(x, dims, keepdim):
    """`jnp.mean`'s rounding: a half-precision input is averaged in
    float32 and rounded once."""
    dims = tuple(range(x.ndim)) if dims is None else dims
    if x.dtype not in (torch.bfloat16, torch.float16):
        return x.mean(dims, keepdim=keepdim)
    return x.mean(dims, keepdim=keepdim, dtype=torch.float32).to(x.dtype)


def _prod(x, dims, keepdim):
    """`jnp.prod` over several dims as one product: the reduced dims are
    moved last and flattened, so the grad with zeros in a row is
    `torch.prod`'s over one dim, which equals the JAX rule's."""
    dims = range(x.ndim) if dims is None else sorted(d % x.ndim
                                                     for d in dims)
    kept = [d for d in range(x.ndim) if d not in dims]
    out = x.permute(*kept, *dims).reshape(
        [x.shape[d] for d in kept] + [-1]).prod(-1)
    if keepdim:
        out = out.reshape([1 if d in dims else x.shape[d]
                           for d in range(x.ndim)])
    return out


@register_op("reduce_sum")
def _reduce_sum(ctx, X):
    return _reduce(ctx, X, _sum_as_jnp)


@register_op("reduce_mean")
def _reduce_mean(ctx, X):
    return _reduce(ctx, X, _mean_as_jnp)


@register_op("reduce_max")
def _reduce_max(ctx, X):
    """`torch.amax`, whose grad splits among tied maxima as `jnp.max`'s
    does (`torch.max(dim=)` sends it all to one)."""
    return _reduce(ctx, X, lambda x, d, k: x.amax(d or (), keepdim=k))


@register_op("reduce_min")
def _reduce_min(ctx, X):
    return _reduce(ctx, X, lambda x, d, k: x.amin(d or (), keepdim=k))


@register_op("reduce_prod")
def _reduce_prod(ctx, X):
    return _reduce(ctx, X, _prod)


def jax_clip(x, lo, hi):
    """`jnp.clip(x, lo, hi)` with its grad: minimum(maximum(x, lo), hi),
    whose grad splits 0.5 at a bound, as the JAX rule's does
    (`torch.clamp` passes the whole grad there). The bounds are rounded
    to x's dtype first (`types.scalar_as`)."""
    return torch.minimum(
        torch.maximum(x, x.new_full((), types.scalar_as(lo, x.dtype))),
        x.new_full((), types.scalar_as(hi, x.dtype)))


def jax_abs(x):
    """`jnp.abs(x)` with its grad: +1 at 0, where `torch.abs`'s is 0."""
    return torch.where(x >= 0, x, -x)


@register_op("clip")
def _clip(ctx, X):
    return {"Out": jax_clip(X, ctx.attr("min"), ctx.attr("max"))}


@register_op("clip_by_norm")
def _clip_by_norm(ctx, X):
    """X * min(max_norm / max(||X||, 1e-12), 1), with `torch.minimum` and
    `torch.maximum` as the JAX rule's `jnp.minimum` / `jnp.maximum`, so
    the grad splits where the norm meets max_norm."""
    dt = X.dtype
    norm = torch.sqrt(_sum_as_jnp(X * X))
    scale = torch.minimum(
        types.scalar_as(ctx.attr("max_norm"), dt)
        / torch.maximum(norm, norm.new_full((), types.scalar_as(1e-12, dt))),
        norm.new_full((), 1.0))
    return {"Out": X * scale}


@register_op("mean")
def _mean(ctx, X):
    return {"Out": X.mean().reshape(1)}


@register_op("softmax")
def _softmax(ctx, X):
    """`jax.nn.softmax` in X's dtype. In float32 that is torch's softmax.
    In bf16 the JAX rule rounds three times, and so does this one:
    e = exp(x - max) in bf16, its sum in float32 rounded to bf16, e / sum
    in bf16 (torch's bf16 softmax rounds once, one ulp off the JAX rule
    in about half the elements). The max takes no grad, as the JAX rule
    stops it (`lax.stop_gradient`), which also spares the backward
    amax's passes; `_HalfSoftmax` takes the grad."""
    axis = ctx.attr("axis", -1)
    if X.dtype not in (torch.bfloat16, torch.float16):
        return {"Out": torch.softmax(X, dim=axis)}
    return {"Out": _HalfSoftmax.apply(X, axis)}


class _HalfSoftmax(torch.autograd.Function):
    """The bf16 (or fp16) softmax of `_softmax`, its grad rounded as the
    JAX rule's transpose rounds it: with y = e / s, the cotangent of s is
    -sum(g * (1 / (s * s)) * e) (the quotient rule's s^-2 as 1 / (s s)),
    and x's is (g / s + that) * e. The JAX rule adds that sum in bf16 in
    XLA's order; here it adds in float32 and rounds once, so the two
    agree bit for bit where the axis has two entries and by that sum's
    rounding elsewhere (ROADMAP Queue 3, expected differences)."""

    @staticmethod
    def forward(ctx, x, axis):
        e = torch.exp(x - x.amax(dim=axis, keepdim=True))
        s = _sum_as_jnp(e, (axis,), keepdim=True)
        ctx.save_for_backward(e, s)
        ctx.axis = axis
        return e / s

    @staticmethod
    def backward(ctx, g):
        e, s = ctx.saved_tensors
        ct_s = -_sum_as_jnp(g * (1.0 / (s * s)) * e, (ctx.axis,),
                            keepdim=True)
        return (g / s + ct_s) * e, None


def jax_log_softmax(x, axis=-1):
    """`jax.nn.log_softmax`: x - max - log(sum(exp(x - max))), the max
    taking no grad."""
    shifted = x - x.amax(dim=axis, keepdim=True).detach()
    return shifted - torch.log(
        _sum_as_jnp(torch.exp(shifted), (axis,), keepdim=True))


@register_op("log_softmax")
def _log_softmax(ctx, X):
    return {"Out": jax_log_softmax(X, ctx.attr("axis", -1))}


@register_op("top_k", propagate_seqlen=False)
def _top_k(ctx, X):
    """The k largest along the last dim, in descending order. Indices are
    int64, the port's index dtype (``core/types.py``)."""
    vals, idx = torch.topk(X, ctx.attr("k", 1), dim=-1)
    return {"Out": vals, "Indices": idx}


@register_op("cos_sim")
def _cos_sim(ctx, X, Y):
    """Row-wise cosine similarity over the last dim, [N, 1]; a one-row Y
    broadcasts over X's rows. The denominator is clamped at 1e-12 by
    `torch.maximum`, whose grad splits at a tie as `jnp.maximum`'s
    does."""
    xn = torch.sqrt(torch.sum(X * X, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(Y * Y, dim=-1, keepdim=True))
    den = xn * yn
    out = torch.sum(X * Y, dim=-1, keepdim=True) / torch.maximum(
        den, den.new_tensor(1e-12))
    return {"Out": out, "XNorm": xn, "YNorm": yn}


# -- the rest of the activations (the JAX package's formulas, so each grad
# is autograd through the same expression: at a kink or a bound the grad
# is the JAX rule's, see `jax_clip` and `jax_abs`) --------------------------

def _register_attr_act(name, fn):
    @register_op(name)
    def _rule(ctx, X, _fn=fn):
        return {"Out": _fn(ctx, X)}
    _rule.__name__ = name
    return _rule


def _softplus(x):
    """`jax.nn.softplus`, logaddexp(x, 0) (`F.softplus` turns linear
    above 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _elu(x, alpha):
    """`jax.nn.elu`: x above 0, alpha * expm1(x) at and below it."""
    pos = x > 0
    return torch.where(pos, x, alpha * torch.expm1(
        torch.where(pos, x.new_zeros(()), x)))


def _a(ctx, x, name, default):
    """Attr `name` rounded to x's dtype, as JAX's weak typing rounds a
    Python scalar."""
    return types.scalar_as(ctx.attr(name, default), x.dtype)


_register_act("abs", jax_abs)
_register_act("logsigmoid", lambda x: -_softplus(-x))
_register_act("softplus", _softplus)
_register_act("softsign", lambda x: x / (1.0 + jax_abs(x)))
_register_act("gelu", lambda x: torch.nn.functional.gelu(
    x, approximate="none"))
_register_attr_act("relu6", lambda ctx, x: jax_clip(
    x, 0.0, ctx.attr("threshold", 6.0)))
_register_attr_act("leaky_relu", lambda ctx, x: torch.where(
    x >= 0, x, x * _a(ctx, x, "alpha", 0.02)))
_register_attr_act("elu", lambda ctx, x: _elu(x, _a(ctx, x, "alpha", 1.0)))
_register_attr_act("swish", lambda ctx, x: x * _sigmoid(
    _a(ctx, x, "beta", 1.0) * x))
_register_attr_act("hard_sigmoid", lambda ctx, x: jax_clip(
    _a(ctx, x, "slope", 0.2) * x + _a(ctx, x, "offset", 0.5), 0.0, 1.0))
_register_attr_act("brelu", lambda ctx, x: jax_clip(
    x, ctx.attr("t_min", 0.0), ctx.attr("t_max", 24.0)))
_register_attr_act("soft_relu", lambda ctx, x: torch.log(1 + torch.exp(
    jax_clip(x, -ctx.attr("threshold", 40.0), ctx.attr("threshold", 40.0)))))
_register_attr_act("pow", lambda ctx, x: torch.pow(
    x, ctx.attr("factor", 1.0)))
_register_attr_act("hard_shrink", lambda ctx, x: torch.where(
    jax_abs(x) > _a(ctx, x, "threshold", 0.5), x, x.new_zeros(())))
_register_attr_act("thresholded_relu", lambda ctx, x: torch.where(
    x > _a(ctx, x, "threshold", 1.0), x, x.new_zeros(())))


@register_op("softshrink")
def _softshrink(ctx, X):
    lam = _a(ctx, X, "lambda", 0.5)
    return {"Out": torch.where(X > lam, X - lam, torch.where(
        X < -lam, X + lam, X.new_zeros(())))}


@register_op("prelu")
def _prelu(ctx, X, Alpha):
    """Modes `all` (one alpha), `channel` (Alpha [C] as [1, C, 1, 1] for a
    4-d X) and `element` (Alpha broadcast as it is)."""
    alpha = Alpha
    if ctx.attr("mode", "all") == "channel" and Alpha.ndim == 1 \
            and X.ndim == 4:
        alpha = Alpha.reshape(1, -1, 1, 1)
    return {"Out": torch.where(X >= 0, X, X * alpha)}


@register_op("cumsum")
def _cumsum(ctx, X):
    """`reverse` by flipping twice and `exclusive` as the cumsum minus X,
    as the JAX rule computes them."""
    axis = ctx.attr("axis", -1)
    if ctx.attr("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(X, (axis,)), dim=axis),
                         (axis,))
    else:
        out = torch.cumsum(X, dim=axis)
    if ctx.attr("exclusive", False):
        out = out - X
    return {"Out": out}


@register_op("arg_max", propagate_seqlen=False)
def _arg_max(ctx, X):
    """The first index of the largest value along `axis`, int64."""
    return {"Out": torch.argmax(X, dim=ctx.attr("axis", -1))}


@register_op("arg_min", propagate_seqlen=False)
def _arg_min(ctx, X):
    return {"Out": torch.argmin(X, dim=ctx.attr("axis", -1))}


@register_op("isfinite")
def _isfinite(ctx, X):
    """One bool of shape [1]: every element of every tensor in X is
    finite."""
    xs = X if isinstance(X, list) else [X]
    ok = torch.stack([torch.isfinite(x).all() for x in xs]).all()
    return {"Out": ok.reshape(1)}


@register_op("maximum")
def _maximum(ctx, X, Y):
    return {"Out": torch.maximum(X, Y)}


@register_op("l2_normalize")
def _l2_normalize(ctx, X):
    """X / max(||X||, epsilon) along `axis`, and the norm."""
    axis = ctx.attr("axis", -1)
    norm = torch.sqrt(torch.sum(X * X, dim=axis, keepdim=True))
    eps = norm.new_full((), types.scalar_as(ctx.attr("epsilon", 1e-10),
                                            norm.dtype))
    return {"Out": X / torch.maximum(norm, eps), "Norm": norm}
