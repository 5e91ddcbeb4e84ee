"""Math / elementwise / activation / reduction op rules (the slices'
subset).

Mirror of ``paddle_tpu/ops/math.py``: the elementwise ops `add`, `sub`,
`mul`, `div`, `max`, `min` and `pow` with the reference's broadcast
`axis`, `mul`, `matmul`, `scale`, `sum`, `mean`, `cast`, `clip`,
`clip_by_norm`, `reduce_sum`, the activations `relu`, `exp`, `sqrt`,
`square`, `sigmoid`, `tanh`, `floor` and `ceil`, `softmax`,
`log_softmax`, `top_k`, `cos_sim`, the comparisons `equal`, `not_equal`,
`less_than`, `less_equal`, `greater_than` and `greater_equal`, and the
logical ops `logical_and`, `logical_or`, `logical_xor` and
`logical_not`. Matrix products go to `torch.matmul`,
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


@register_op("reduce_sum")
def _reduce_sum(ctx, X):
    """Reference reduce_op.cc: over `dim` (default [0]), or every dim
    with `reduce_all` (a [1] result, or all-ones dims with `keep_dim`)."""
    keep = ctx.attr("keep_dim", False)
    if ctx.attr("reduce_all", False):
        out = _sum_as_jnp(X)
        return {"Out": out.reshape((1,) * X.ndim if keep else (1,))}
    dims = ctx.attr("dim", [0])
    dims = tuple(dims) if isinstance(dims, (list, tuple)) else (dims,)
    return {"Out": _sum_as_jnp(X, dims, keep)}


@register_op("clip")
def _clip(ctx, X):
    return {"Out": torch.clamp(X, types.scalar_as(ctx.attr("min"), X.dtype),
                               types.scalar_as(ctx.attr("max"), X.dtype))}


@register_op("clip_by_norm")
def _clip_by_norm(ctx, X):
    """X * min(max_norm / max(||X||, 1e-12), 1)."""
    dt = X.dtype
    norm = torch.sqrt(_sum_as_jnp(X * X))
    scale = torch.clamp(
        types.scalar_as(ctx.attr("max_norm"), dt)
        / torch.clamp(norm, min=types.scalar_as(1e-12, dt)), max=1.0)
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


@register_op("log_softmax")
def _log_softmax(ctx, X):
    """`jax.nn.log_softmax`: x - max - log(sum(exp(x - max))), the max
    taking no grad."""
    axis = ctx.attr("axis", -1)
    shifted = X - X.amax(dim=axis, keepdim=True).detach()
    return {"Out": shifted - torch.log(
        _sum_as_jnp(torch.exp(shifted), (axis,), keepdim=True))}


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
