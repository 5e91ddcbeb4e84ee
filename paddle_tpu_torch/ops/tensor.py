"""Tensor creation / shape / lookup op rules (the slices' subset).

Mirror of ``paddle_tpu/ops/tensor.py``: `fill_constant`,
`fill_constant_batch_size_like`, `uniform_random`, `gaussian_random`,
`assign`, `assign_value`, `reshape`, `squeeze`, `unsqueeze`,
`transpose`, `concat`, `split`, `slice`, `increment`, `lookup_table`,
`batch_gather`, `sequence_mask`, `causal_mask`, `sinusoid_pos_encoding`,
`is_empty`, `print` and `load`; and `truncated_gaussian_random`,
`uniform_random_batch_size_like`, `shape`, `flatten`, `stack`,
`unstack`, `expand`, `expand_dims_tile`, `reverse`, `gather`,
`gather_nd`, `scatter`, `one_hot`, `pad`, `pad2d`, `range` and
`argsort`. Random ops draw from the op's own
`torch.Generator` (``core/registry.py``), on the op's device. `reshape`
and `transpose` return views where PyTorch can; `assign` copies, since
the optimizer rules update their state in place and an alias of a
parameter (``ModelAverage``'s backup) must keep its value.
"""

from __future__ import annotations

import math
import os

import torch

from ..core import types
from ..core.registry import DIM_SENTINEL, DIM_SENTINEL_ALT, register_op


@register_op("fill_constant")
def _fill_constant(ctx, X=None):
    shape = [int(s) for s in ctx.attr("shape", [1])]
    return {"Out": torch.full(shape, ctx.attr("value", 0.0),
                              dtype=types.torch_dtype(
                                  ctx.attr("dtype", "float32")),
                              device=ctx.device)}


@register_op("fill_constant_batch_size_like")
def _fill_constant_bsl(ctx, Input):
    """`shape` with dim output_dim_idx taken from Input's input_dim_idx."""
    shape = [int(d) for d in ctx.attr("shape")]
    shape[ctx.attr("output_dim_idx", 0)] = \
        Input.shape[ctx.attr("input_dim_idx", 0)]
    return {"Out": torch.full(shape, ctx.attr("value", 0.0),
                              dtype=types.torch_dtype(
                                  ctx.attr("dtype", "float32")),
                              device=Input.device)}


@register_op("uniform_random", needs_rng=True)
def _uniform_random(ctx, X=None):
    shape = [int(s) for s in ctx.attr("shape")]
    out = torch.empty(shape, dtype=types.torch_dtype(
        ctx.attr("dtype", "float32")), device=ctx.device)
    out.uniform_(ctx.attr("min", -1.0), ctx.attr("max", 1.0),
                 generator=ctx.generator)
    return {"Out": out}


@register_op("gaussian_random", needs_rng=True)
def _gaussian_random(ctx, X=None):
    shape = [int(s) for s in ctx.attr("shape")]
    out = torch.empty(shape, dtype=types.torch_dtype(
        ctx.attr("dtype", "float32")), device=ctx.device)
    out.normal_(ctx.attr("mean", 0.0), ctx.attr("std", 1.0),
                generator=ctx.generator)
    return {"Out": out}


@register_op("assign")
def _assign(ctx, X):
    return {"Out": X.clone()}


@register_op("assign_value")
def _assign_value(ctx):
    """A constant from the op's `values` attr, made on the device."""
    return {"Out": torch.tensor(
        ctx.attr("values"), dtype=types.torch_dtype(
            ctx.attr("dtype", "float32")),
        device=ctx.device).reshape(ctx.attr("shape"))}


@register_op("concat")
def _concat(ctx, X):
    xs = X if isinstance(X, list) else [X]
    return {"Out": torch.cat(xs, dim=ctx.attr("axis", 0))}


@register_op("increment")
def _increment(ctx, X):
    """X + step in X's dtype (an integer counter stays an integer)."""
    return {"Out": X + torch.tensor(ctx.attr("step", 1.0)).to(
        dtype=X.dtype, device=X.device)}


@register_op("lookup_table")
def _lookup_table(ctx, W, Ids):
    """Embedding lookup (reference lookup_table_op.cc). Ids has a trailing
    size-1 dim in the reference convention."""
    ids = Ids
    if ids.ndim and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    out = torch.nn.functional.embedding(ids.long(), W)
    pad = ctx.attr("padding_idx", -1)
    if pad is not None and pad >= 0:
        out = out * (ids != pad).unsqueeze(-1).to(out.dtype)
    return {"Out": out}


@register_op("sequence_mask", propagate_seqlen=False)
def _sequence_mask(ctx, X):
    """Y[b, t] = t < X[b] for t < the static `maxlen`, in `out_dtype`
    (int64 by default; the JAX package's x32 mode makes it int32)."""
    maxlen = ctx.attr("maxlen", -1)
    if maxlen < 0:
        raise ValueError("sequence_mask needs a static maxlen")
    t = torch.arange(maxlen, device=X.device)
    return {"Y": (t[None, :] < X.reshape(-1, 1)).to(
        types.torch_dtype(ctx.attr("out_dtype", "int64")))}


@register_op("reshape")
def _reshape(ctx, X, Shape=None):
    shape = [int(s) for s in ctx.attr("shape")]
    # reference reshape_op.cc: 0 means "copy this dim from input"
    shape = [X.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    if X.device.type == "meta":
        return {"Out": torch.empty(_meta_reshape(X.shape, shape),
                                   dtype=X.dtype, device="meta")}
    return {"Out": X.reshape(shape)}


def _meta_reshape(in_shape, target):
    """The JAX package's static reshape rule (its `_reshape_infer`) for
    build-time shape inference, where a dynamic input dim is a multiple
    of a sentinel: a -1 that cannot absorb the input exactly (a [-1, V]
    input reshaped to [-1, K, V]) stays dynamic, and a target with no -1
    is kept as declared."""
    sentinel = next((s for s in (DIM_SENTINEL, DIM_SENTINEL_ALT)
                     if any(d >= s and d % s == 0 for d in in_shape)), None)
    target = list(target)
    if -1 in target:
        known = math.prod(d for d in target if d != -1)
        total = math.prod(in_shape)
        if known and total % known == 0:
            target[target.index(-1)] = total // known
        elif sentinel is not None:
            target[target.index(-1)] = sentinel
        else:
            raise ValueError(f"reshape: cannot infer -1 dim reshaping "
                             f"{tuple(in_shape)} to {target}")
    return target


@register_op("squeeze")
def _squeeze(ctx, X):
    axes = ctx.attr("axes", [])
    if axes:
        return {"Out": X.squeeze(tuple(a % X.ndim for a in axes))}
    return {"Out": X.squeeze()}


@register_op("unsqueeze")
def _unsqueeze(ctx, X):
    out = X
    for a in sorted(ctx.attr("axes")):
        out = out.unsqueeze(a)
    return {"Out": out}


@register_op("split")
def _split(ctx, X):
    """`num` equal parts, or parts of the sizes in `sections`, along
    `axis`."""
    axis = ctx.attr("axis", 0)
    sections = ctx.attr("sections", [])
    if sections:
        return {"Out": list(torch.split(X, list(sections), dim=axis))}
    num = ctx.attr("num", 0)
    if X.shape[axis] % num:
        raise ValueError(f"split: dim {axis} of {tuple(X.shape)} does not "
                         f"divide into {num} equal parts")
    return {"Out": list(torch.chunk(X, num, dim=axis))}


@register_op("slice", propagate_seqlen=False)
def _slice(ctx, Input):
    """Input[starts:ends] along `axes`, each bound clipped into the dim
    (a negative one counts from its end)."""
    idx = [slice(None)] * Input.ndim
    for a, s, e in zip(ctx.attr("axes"), ctx.attr("starts"),
                       ctx.attr("ends")):
        dim = Input.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    return {"Out": Input[tuple(idx)]}


@register_op("batch_gather", propagate_seqlen=False)
def _batch_gather(ctx, X, Index):
    """Per-row gather along axis 1: X [B, K, ...], Index [B, K'] ->
    [B, K', ...] (a beam's parent reordering)."""
    idx = Index.long()
    idx = idx.reshape(idx.shape + (1,) * (X.ndim - idx.ndim))
    return {"Out": torch.gather(X, 1, idx.expand(
        tuple(idx.shape[:2]) + tuple(X.shape[2:])))}


@register_op("is_empty")
def _is_empty(ctx, X):
    """Whether X holds no element, [1] bool (reference is_empty_op.cc);
    shapes are known on the host, so nothing is read back."""
    return {"Out": torch.full((1,), X.numel() == 0, dtype=torch.bool,
                              device=X.device)}


@register_op("print")
def _print(ctx, X):
    """Print X on the host (reference print_op.cc): the message, the
    shape and the first `summarize` values (all with -1). Out is X, so
    the op can sit anywhere in a graph. Nothing prints on meta tensors
    (build-time shape inference)."""
    if X.device.type != "meta":
        flat = X.reshape(-1)
        summarize = int(ctx.attr("summarize", -1))
        shown = flat[:summarize] if summarize > 0 else flat
        if shown.dtype == torch.bfloat16:
            shown = shown.float()
        print(f"{ctx.attr('message', '') or ''}shape={tuple(X.shape)} "
              f"{shown.detach().cpu().numpy()}", flush=True)
    return {"Out": X}


@register_op("load")
def _load(ctx):
    """One np.save'd array (reference load_op.cc), read from `file_path`
    (or `file_path` + ".npy") each time the op runs, onto the op's device;
    `load_as_fp16` casts it to float16."""
    import numpy as np
    path = ctx.attr("file_path")
    if not path.endswith(".npy") and not os.path.exists(path):
        path += ".npy"
    arr = np.load(path)
    if ctx.attr("load_as_fp16"):
        arr = arr.astype(np.float16)
    return {"Out": torch.from_numpy(arr).to(ctx.device)}


@register_op("transpose", propagate_seqlen=False)
def _transpose(ctx, X):
    return {"Out": X.permute(*ctx.attr("axis"))}


@register_op("causal_mask", propagate_seqlen=False)
def _causal_mask(ctx):
    """Additive float32 attention mask [1, 1, T, T]: `neg` above the
    diagonal, 0 on and below it, made on the device."""
    t = int(ctx.attr("size"))
    row = torch.arange(t, device=ctx.device)[:, None]
    col = torch.arange(t, device=ctx.device)[None, :]
    mask = torch.where(col > row,
                       torch.tensor(ctx.attr("neg", -1e9), dtype=torch.float32,
                                    device=ctx.device),
                       torch.zeros((), dtype=torch.float32, device=ctx.device))
    return {"Out": mask.reshape(1, 1, t, t)}


@register_op("sinusoid_pos_encoding", propagate_seqlen=False)
def _sinusoid_pos_encoding(ctx):
    """Transformer sinusoidal position table [T, D], computed on the
    device (the JAX package's formula, in float32)."""
    t = int(ctx.attr("size"))
    d = int(ctx.attr("d_model"))
    pos = torch.arange(t, dtype=torch.float32, device=ctx.device)[:, None]
    i = torch.arange(d, dtype=torch.float32, device=ctx.device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=ctx.device),
                            (2.0 * torch.floor(i / 2.0)) / d)
    even = torch.arange(d, device=ctx.device)[None, :] % 2 == 0
    return {"Out": torch.where(even, torch.sin(angle), torch.cos(angle))}


@register_op("truncated_gaussian_random", needs_rng=True)
def _truncated_gaussian_random(ctx, X=None):
    """mean + std * z, z the standard normal truncated to [-2, 2] (the
    JAX rule's `jax.random.truncated_normal(key, -2, 2)`), so the draw's
    std is 0.880 * `std`. z is the inverse CDF of a uniform draw from the
    op's generator over [Phi(-2), Phi(2)]."""
    shape = [int(s) for s in ctx.attr("shape")]
    dtype = types.torch_dtype(ctx.attr("dtype", "float32"))
    u = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    edge = math.erf(2.0 / math.sqrt(2.0))     # 2 Phi(2) - 1
    u.uniform_(-edge, edge, generator=ctx.generator)
    z = torch.clamp(torch.erfinv(u) * math.sqrt(2.0), -2.0, 2.0)
    return {"Out": (ctx.attr("mean", 0.0) + ctx.attr("std", 1.0) * z).to(
        dtype)}


@register_op("uniform_random_batch_size_like", needs_rng=True)
def _uniform_random_bsl(ctx, Input):
    """`uniform_random` of `shape` with dim output_dim_idx taken from
    Input's input_dim_idx."""
    shape = [int(s) for s in ctx.attr("shape")]
    shape[ctx.attr("output_dim_idx", 0)] = \
        Input.shape[ctx.attr("input_dim_idx", 0)]
    out = torch.empty(shape, dtype=types.torch_dtype(
        ctx.attr("dtype", "float32")), device=Input.device)
    out.uniform_(ctx.attr("min", -1.0), ctx.attr("max", 1.0),
                 generator=ctx.generator)
    return {"Out": out}


@register_op("shape", propagate_seqlen=False)
def _shape(ctx, Input):
    """Input's shape as a [ndim] int64 tensor (the port's index dtype)."""
    return {"Out": torch.tensor(list(Input.shape), dtype=torch.int64,
                                device=Input.device)}


@register_op("flatten")
def _flatten(ctx, X):
    """[prod(dims before `axis`), prod(the rest)]."""
    axis = ctx.attr("axis", 1)
    lead = math.prod(X.shape[:axis]) if axis > 0 else 1
    return {"Out": X.reshape(lead, -1)}


@register_op("stack")
def _stack(ctx, X):
    xs = X if isinstance(X, list) else [X]
    return {"Y": torch.stack(xs, dim=ctx.attr("axis", 0))}


@register_op("unstack")
def _unstack(ctx, X):
    return {"Y": list(torch.unbind(X, dim=ctx.attr("axis", 0)))}


def _tile(x, times):
    """`jnp.tile`: fewer reps than dims are padded with leading 1s."""
    times = [int(t) for t in times]
    return x.repeat([1] * (x.ndim - len(times)) + times)


@register_op("expand")
def _expand(ctx, X):
    return {"Out": _tile(X, ctx.attr("expand_times"))}


@register_op("expand_dims_tile")
def _expand_dims_tile(ctx, X):
    return {"Out": _tile(X, ctx.attr("times"))}


@register_op("reverse")
def _reverse(ctx, X):
    return {"Out": torch.flip(X, dims=tuple(ctx.attr("axis")))}


@register_op("gather", propagate_seqlen=False)
def _gather(ctx, X, Index):
    """Rows of X at the flattened Index. An id outside [0, rows) raises
    (the JAX rule's `jnp.take` gives a NaN row there). Indexing, not
    `index_select`: its grad adds a repeated id's rows with a sorted
    kernel on the card, in the same order every run (`index_select`'s
    adds with atomics)."""
    return {"Out": X[Index.reshape(-1).long()]}


@register_op("gather_nd", propagate_seqlen=False)
def _gather_nd(ctx, X, Index):
    """X at the index tuples along Index's last dim."""
    return {"Out": X[tuple(Index.long().movedim(-1, 0))]}


@register_op("scatter", propagate_seqlen=False)
def _scatter(ctx, X, Ids, Updates):
    """X with the rows at Ids set to (`overwrite`, the default) or added
    to Updates' rows. Where an id repeats, the last update wins, as on
    the JAX package's CPU, decided here before anything is written:
    the ids are sorted stably, the last of each run names its row's
    winner, and each row then takes its winner or keeps X. No two writes
    meet in a real row, so the result does not depend on the device's
    write order. Added rows sum a row's updates one at a time in the ids'
    order on either device, as the JAX package's CPU does: on the host
    `index_add` walks the ids in order; on the card it would add with
    atomics, so there `index_put` with `accumulate` (a sorted kernel,
    stable within a row) does it (on the host that one runs threads and
    is the one that varies)."""
    ids = Ids.reshape(-1).long()
    if not ctx.attr("overwrite", True):
        if X.is_cuda:
            return {"Out": X.index_put((ids,), Updates, accumulate=True)}
        return {"Out": X.index_add(0, ids, Updates)}
    rows = X.shape[0]
    sid, order = torch.sort(ids, stable=True)
    last = torch.ones_like(sid, dtype=torch.bool)
    last[:-1] = sid[:-1] != sid[1:]
    winner = torch.full((rows + 1,), -1, dtype=torch.int64, device=X.device)
    # runs' other members all write the spare row `rows`
    winner[torch.where(last, sid, rows)] = order
    winner = winner[:rows]
    hit = winner >= 0
    # a row that keeps X gathers some update it then drops; spread over
    # the updates, so that the grad's sorted add meets no one hot row
    src = torch.where(hit, winner, torch.arange(
        rows, device=X.device) % max(ids.numel(), 1))
    return {"Out": torch.where(hit.reshape((rows,) + (1,) * (X.ndim - 1)),
                               Updates[src], X)}


@register_op("one_hot", propagate_seqlen=False)
def _one_hot(ctx, X):
    """float32 one-hot of the ids (a trailing dim of 1 squeezed first);
    an id outside [0, depth) gives a zero row, as `jax.nn.one_hot` does
    (`F.one_hot` would raise)."""
    ids = X.reshape(X.shape[:-1]) if X.ndim and X.shape[-1] == 1 else X
    depth = torch.arange(ctx.attr("depth"), device=X.device)
    return {"Out": (ids.long()[..., None] == depth).to(torch.float32)}


@register_op("pad")
def _pad(ctx, X):
    """`paddings` as flat (before, after) pairs, one pair a dim, filled
    with `pad_value`."""
    p = ctx.attr("paddings")
    flat = []
    for d in reversed(range(X.ndim)):
        flat += [p[2 * d], p[2 * d + 1]]
    return {"Out": torch.nn.functional.pad(
        X, flat, value=ctx.attr("pad_value", 0.0))}


def _pad_index(n, before, after, mode, device):
    """The source index of each padded position of a dim of n:
    `reflect` mirrors about the edge without repeating it, `edge`
    repeats the edge."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    i = i.abs()
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


@register_op("pad2d")
def _pad2d(ctx, X):
    """NCHW, `paddings` (top, bottom, left, right); mode `constant`
    (`pad_value`), `reflect` or `edge`. The last two gather X at the
    padded positions' source indices (`F.pad`'s `reflect` and
    `replicate` give the same values, but their grads add with atomics on
    the card, so two runs can differ in the last bit; the gather's grad
    is a sorted, ordered sum)."""
    t, b, l, r = ctx.attr("paddings", [0, 0, 0, 0])
    mode = ctx.attr("mode", "constant")
    if mode == "constant":
        return {"Out": torch.nn.functional.pad(
            X, (l, r, t, b), value=ctx.attr("pad_value", 0.0))}
    if mode not in ("reflect", "edge"):
        raise ValueError(f"pad2d: unknown mode {mode!r}")
    hi = _pad_index(X.shape[2], t, b, mode, X.device)
    wi = _pad_index(X.shape[3], l, r, mode, X.device)
    return {"Out": X[:, :, hi[:, None], wi[None, :]]}


@register_op("range")
def _range(ctx):
    """arange(start, end, step) in `dtype` (int64 by default)."""
    return {"Out": torch.arange(
        ctx.attr("start", 0), ctx.attr("end"), ctx.attr("step", 1),
        dtype=types.torch_dtype(ctx.attr("dtype", "int64")),
        device=ctx.device)}


@register_op("argsort")
def _argsort(ctx, X):
    """Sorted values and indices along `axis`; a stable sort, as
    `jnp.argsort` is, so ties keep their order."""
    out, idx = torch.sort(X, dim=ctx.attr("axis", -1), stable=True)
    return {"Out": out, "Indices": idx}