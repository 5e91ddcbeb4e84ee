"""The extra nn ops: 3-D conv and pool, image resize, crop, random crop,
label smoothing, multiplex, mean IoU, ROI max pooling, greedy CTC
decoding, `lod_reset` and `chunk_eval`.

Mirror of ``paddle_tpu/ops/extra_nn.py``. The JAX package computes these
in XLA, outside any Pallas kernel; here they are torch's own ops (cuDNN
for the 3-D convs and pools on the card). Each rule is the JAX rule:

- `bilinear_interp` is `jax.image.resize`: half-pixel centres, and on a
  downscale a triangle kernel widened by the scale (antialiasing), as
  its weight matrices, one product a changed dim; its `nearest` method
  gathers the same sources as the JAX one. A dynamic `OutSize` raises,
  as in the JAX package.
- `roi_pool` takes each bin's bounds as the JAX package's jitted step
  computes them (`floor` / `ceil` of the rounded, scaled ROI;
  `_bin_span` says how XLA rounds them) and max-pools the feature values
  inside the bin and the image, 0 for an empty bin. The JAX rule masks
  the whole map for every bin; here each bin gathers only the rows and
  columns its bounds allow (at most KH x KW, the largest bin of the
  batch, read back once), so a full-width batch fits on the card, and
  its grad adds only each bin's tied maxima back into the map
  (`_BinMax`), each an equal share as `jnp.max`'s grad gives it.
- `crop` with an `Offsets` tensor and `random_crop` clamp each start
  into the input (`lax.dynamic_slice`'s rule) and gather on the device:
  no offset is read back to the host. `random_crop` draws its starts
  from the op's generator (`LoweringContext.generator`); its stream is
  the port's own, not the JAX package's (ROADMAP, expected differences).
- `ctc_greedy_decoder`'s ids are int64, the port's index dtype; the
  decoded lengths (`OutLen`, int32) ride the output's `@SEQLEN`
  companion, written by the layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.ir import SEQLEN_SUFFIX
from ..core.registry import register_op
from .nn import _pair


def _triple(v):
    return _pair(v, 3)


@register_op("conv3d", propagate_seqlen=False)
def _conv3d(ctx, Input, Filter, Bias=None):
    """NCDHW conv (reference conv3d registration in conv_op.cc)."""
    out = F.conv3d(Input, Filter, None,
                   stride=_triple(ctx.attr("strides", [1, 1, 1])),
                   padding=_triple(ctx.attr("paddings", [0, 0, 0])),
                   dilation=_triple(ctx.attr("dilations", [1, 1, 1])),
                   groups=ctx.attr("groups", 1) or 1)
    if Bias is not None:
        out = out + Bias.reshape(1, -1, 1, 1, 1)
    return {"Output": out}


@register_op("conv3d_transpose", propagate_seqlen=False)
def _conv3d_transpose(ctx, Input, Filter, Bias=None):
    """The grad of a conv3d as a forward op; the filter is stored [in_c,
    out_c, D, H, W], `F.conv_transpose3d`'s own layout, and the output is
    (in - 1) s + d (k - 1) + 1 - 2p, the JAX rule's size."""
    out = F.conv_transpose3d(
        Input, Filter, None, stride=_triple(ctx.attr("strides", [1, 1, 1])),
        padding=_triple(ctx.attr("paddings", [0, 0, 0])),
        dilation=_triple(ctx.attr("dilations", [1, 1, 1])))
    if Bias is not None:
        out = out + Bias.reshape(1, -1, 1, 1, 1)
    return {"Output": out}


def _window_sum3(xp, k, s, out):
    """Sum of each (kd, kh, kw) window of padded NCDHW `xp` at stride s:
    one strided slice a window offset, added in row-major order. Its
    grad pads each slice's grad back and adds them in the same fixed
    order, with no atomics (torch's CUDA `avg_pool3d` grad adds
    overlapping windows with atomics: two runs differ)."""
    acc = None
    for a in range(k[0]):
        for b in range(k[1]):
            for c in range(k[2]):
                sl = xp[:, :, a:a + s[0] * (out[0] - 1) + 1:s[0],
                        b:b + s[1] * (out[1] - 1) + 1:s[1],
                        c:c + s[2] * (out[2] - 1) + 1:s[2]]
                acc = sl if acc is None else acc + sl
    return acc


@register_op("pool3d", propagate_seqlen=False)
def _pool3d(ctx, X):
    """Max or average over (kd, kh, kw) windows of NCDHW `X`: max pads
    with -inf, an exclusive average divides by the window's count of real
    elements, else by kd * kh * kw. Torch's max pool takes a pad of at
    most half the window and an input no smaller than it, otherwise the
    input is padded explicitly; the average sums strided slices
    (`_window_sum3`)."""
    ptype = ctx.attr("pooling_type", "max")
    if ctx.attr("global_pooling", False):
        if ptype == "max":
            return {"Out": X.amax(dim=(2, 3, 4), keepdim=True)}
        return {"Out": X.mean(dim=(2, 3, 4), keepdim=True)}
    k = _triple(ctx.attr("ksize", [2, 2, 2]))
    s = _triple(ctx.attr("strides", [1, 1, 1]))
    p = _triple(ctx.attr("paddings", [0, 0, 0]))
    padding = (p[2], p[2], p[1], p[1], p[0], p[0])
    if ptype == "max":
        if all(pi <= ki // 2 and n >= ki
               for pi, ki, n in zip(p, k, X.shape[2:])):
            return {"Out": F.max_pool3d(X, k, s, p)}
        return {"Out": F.max_pool3d(F.pad(X, padding, value=float("-inf")),
                                    k, s)}
    out = [(n + 2 * pi - ki) // si + 1
           for n, pi, ki, si in zip(X.shape[2:], p, k, s)]
    total = _window_sum3(F.pad(X, padding), k, s, out)
    if not ctx.attr("exclusive", True):
        return {"Out": total * (1.0 / (k[0] * k[1] * k[2]))}
    ones = torch.ones((1, 1) + tuple(X.shape[2:]), dtype=X.dtype,
                      device=X.device)
    return {"Out": total / _window_sum3(F.pad(ones, padding), k, s, out)}


def _linear_weights(n_in, n_out, device):
    """`jax.image.resize`'s linear weights [n_in, n_out]: its
    `compute_weight_mat` with the triangle kernel, widened by the scale
    on a downscale (antialiasing), normalized per output, zero for an
    output whose sample falls outside the input; a division by a
    constant taken as the product with its float32 reciprocal, as XLA
    takes it."""
    inv = 1.0 / (n_out / n_in)
    f32 = torch.float32
    sample = (torch.arange(n_out, dtype=f32, device=device) + 0.5) * inv \
        - 0.5
    x = torch.abs(sample[None, :] - torch.arange(
        n_in, dtype=f32, device=device)[:, None]) * (1.0 / max(inv, 1.0))
    w = torch.clamp_min(1.0 - x, 0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _nearest_index(n_in, n_out, device):
    """`jax.image.resize`'s nearest source of each output:
    floor((i + 0.5) * n_in / n_out), with n_in / n_out folded into one
    float32 constant as XLA folds it."""
    step = torch.tensor(n_in, dtype=torch.float32) * torch.tensor(
        1.0 / n_out, dtype=torch.float32)
    at = (torch.arange(n_out, dtype=torch.float32) + 0.5) * step
    return torch.floor(at).long().to(device)


@register_op("bilinear_interp", propagate_seqlen=False)
def _bilinear_interp(ctx, X, OutSize=None):
    """NCHW resize to (out_h, out_w), or to the input's size times
    `scale`, as `jax.image.resize` computes it: a dim whose size does
    not change is left alone; `linear` contracts each changed dim with
    its weight matrix (`_linear_weights`, two float32 products), and
    `nearest` gathers (`_nearest_index`). Both grads add in a fixed
    order (a product's, and a sorted index add): torch's CUDA resize
    grads add with atomics, so two runs would differ."""
    if OutSize is not None:
        raise NotImplementedError(
            "dynamic OutSize: pass the out_h / out_w attrs (the JAX "
            "package refuses it too, for XLA's static shapes)")
    n, c, h, w = X.shape
    scale = ctx.attr("scale", 0.0) or 0.0
    oh = ctx.attr("out_h", 0) or int(h * scale)
    ow = ctx.attr("out_w", 0) or int(w * scale)
    method = ctx.attr("interp_method", "bilinear")
    out = X
    if method in ("bilinear", "linear"):
        x = X.float()
        if ow != w:
            x = torch.matmul(x, _linear_weights(w, ow, X.device))
        if oh != h:
            x = torch.matmul(_linear_weights(h, oh, X.device).t(), x)
        out = x
    elif method == "nearest":
        if oh != h:
            out = out[:, :, _nearest_index(h, oh, X.device)]
        if ow != w:
            out = out[..., _nearest_index(w, ow, X.device)]
    else:
        raise NotImplementedError(f"bilinear_interp: interp_method "
                                  f"{method!r}")
    return {"Out": out.to(X.dtype)}


def _window(X, starts, sizes, lead=0):
    """X[..., s0:s0 + n0, s1:s1 + n1, ...] over the dims from `lead` on,
    each start a device scalar clamped into [0, dim - size]
    (`lax.dynamic_slice`), gathered on the device."""
    idx = []
    k = len(sizes)
    for i, (st, n) in enumerate(zip(starts, sizes)):
        dim = X.shape[lead + i]
        first = st.reshape(()).long().clamp(0, max(dim - n, 0))
        shape = [1] * k
        shape[i] = n
        idx.append((first + torch.arange(n, device=X.device)).reshape(shape))
    return X[(Ellipsis,) + tuple(idx)] if lead else X[tuple(idx)]


@register_op("crop", propagate_seqlen=False)
def _crop(ctx, X, Y=None, Offsets=None):
    """Crop (reference crop_op.cc): the output shape from the attr or
    Y's shape; the offsets from the attr, or from an `Offsets` tensor
    whose starts clamp into the input."""
    shape = ctx.attr("shape") or (list(Y.shape) if Y is not None else None)
    shape = [int(s) for s in shape]
    if Offsets is not None:
        flat = Offsets.reshape(-1)
        if flat.shape[0] != X.ndim:
            raise ValueError(
                f"crop: Offsets has {flat.shape[0]} elements for a "
                f"{X.ndim}-D input; one offset per dimension is required")
        if X.device.type == "meta":
            return {"Out": X.new_empty(shape)}
        return {"Out": _window(X, [flat[i] for i in range(X.ndim)], shape)}
    offsets = [int(o) for o in (ctx.attr("offsets") or [0] * X.ndim)]
    return {"Out": X[tuple(slice(o, o + s) for o, s in zip(offsets, shape))]}


@register_op("random_crop", needs_rng=True, propagate_seqlen=False)
def _random_crop(ctx, X):
    """A window of attr `shape` over X's trailing dims at starts drawn
    uniformly from [0, dim - size] (reference random_crop_op.cc)."""
    shape = [int(s) for s in ctx.attr("shape")]
    lead = X.ndim - len(shape)
    if X.device.type == "meta":
        return {"Out": X.new_empty(list(X.shape[:lead]) + shape)}
    starts = [torch.randint(0, X.shape[lead + i] - shape[i] + 1, (),
                            generator=ctx.generator, device=X.device)
              for i in range(len(shape))]
    return {"Out": _window(X, starts, shape, lead)}


@register_op("label_smooth", propagate_seqlen=False)
def _label_smooth(ctx, X, PriorDist=None):
    eps = ctx.attr("epsilon", 0.1)
    prior = PriorDist if PriorDist is not None else 1.0 / X.shape[-1]
    return {"Out": (1.0 - eps) * X + eps * prior}


@register_op("multiplex", propagate_seqlen=False)
def _multiplex(ctx, X, Ids):
    """Row-wise select among candidate tensors (reference
    multiplex_op.cc): out[i] = X[Ids[i]][i]."""
    stacked = torch.stack(X if isinstance(X, list) else [X], dim=0)
    ids = Ids.reshape(-1).long()
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return {"Out": stacked[ids, rows]}


@register_op("mean_iou", propagate_seqlen=False)
def _mean_iou(ctx, Predictions, Labels):
    """Mean IoU over the classes present in either tensor (reference
    mean_iou_op.cc), with the per-class wrong and correct counts (int32,
    as the JAX rule casts them). A class id outside [0, num_classes)
    counts nowhere, as `jax.nn.one_hot` gives it a zero row."""
    n = ctx.attr("num_classes")
    cls = torch.arange(n, device=Predictions.device)
    hit_p = Predictions.reshape(-1, 1).long() == cls
    hit_l = Labels.reshape(-1, 1).long() == cls
    inter = (hit_p & hit_l).sum(0)
    n_lab = hit_l.sum(0)
    union = (hit_p.sum(0) + n_lab - inter).float()
    valid = union > 0
    iou = torch.where(valid, inter.float() / torch.clamp_min(union, 1e-9),
                      0.0)
    miou = iou.sum() / torch.clamp_min(valid.sum(), 1)
    return {"OutMeanIou": miou.float(),
            "OutWrong": (n_lab - inter).int(), "OutCorrect": inter.int()}


def _bin_span(start, extent, pooled, limit):
    """Each bin's [lo, hi) along one axis, clipped into [0, limit): the
    JAX rule's floor(start + p * extent / pooled) and
    ceil(start + (p + 1) * extent / pooled) as its jitted step rounds
    them on the CPU: XLA folds p * (1 / pooled) into one float32
    constant c_p, so a bound is start + extent * c_p, each operation
    rounded to float32. A bound that falls on an integer can move with
    that rounding: dividing first, as the rule reads, or fusing the
    multiply-add, as XLA's optimizing backend does, moves some (ROADMAP
    Queue 3)."""
    c = torch.arange(pooled + 1, dtype=torch.float32,
                     device=start.device) * torch.tensor(
        1.0 / pooled, dtype=torch.float32, device=start.device)
    at = start[:, None] + extent[:, None] * c
    lo, hi = torch.floor(at[:, :-1]), torch.ceil(at[:, 1:])
    return lo.clamp(0, limit).long(), hi.clamp(0, limit).long()


class _BinMax(torch.autograd.Function):
    """Each bin's max over its gathered window, 0 for an empty bin; the
    grad splits each bin's among its tied maxima as `jnp.max`'s does,
    and adds only those positions into X (a sorted index add): the
    window's other elements, most of the gather, take no part."""

    @staticmethod
    def forward(ctx, X, b, rows, cols, inside):
        # [R, ph, pw, kh, kw, C]
        vals = X[b[:, None, None, None, None], :,
                 rows[:, :, None, :, None], cols[:, None, :, None, :]]
        vals = torch.where(inside[..., None], vals,
                           vals.new_full((), float("-inf")))
        v = vals.amax(dim=(3, 4))                       # [R, ph, pw, C]
        finite = torch.isfinite(v)
        tied = (vals == v[:, :, :, None, None, :]) & finite[:, :, :, None,
                                                           None, :]
        ctx.save_for_backward(b, rows, cols, tied.nonzero(),
                              tied.sum(dim=(3, 4)))
        ctx.x_shape = X.shape
        return torch.where(finite, v, v.new_zeros(()))

    @staticmethod
    def backward(ctx, g):
        b, rows, cols, at, count = ctx.saved_tensors
        r, i, j, a, k, c = at.unbind(1)
        share = g[r, i, j, c] / count[r, i, j, c]
        gx = g.new_zeros(ctx.x_shape)
        gx.index_put_((b[r], c, rows[r, i, a], cols[r, j, k]), share,
                      accumulate=True)
        return gx, None, None, None, None


@register_op("roi_pool", propagate_seqlen=False)
def _roi_pool(ctx, X, ROIs, RoisLod=None):
    """Max-pool each ROI to a fixed grid (reference roi_pool_op.cc).
    ROIs: [R, 5] rows (batch_idx, x1, y1, x2, y2) in input-image
    coordinates; the output [R, C, pooled_h, pooled_w] (module
    docstring)."""
    ph = ctx.attr("pooled_height", 1)
    pw = ctx.attr("pooled_width", 1)
    scale = ctx.attr("spatial_scale", 1.0)
    N, C, H, W = X.shape
    R = ROIs.shape[0]
    if X.device.type == "meta" or R == 0:
        return {"Out": X.new_empty((R, C, ph, pw))}
    rois = ROIs.float()
    b = rois[:, 0].long()
    x1, y1, x2, y2 = (torch.round(rois[:, i] * scale) for i in range(1, 5))
    h_lo, h_hi = _bin_span(y1, torch.clamp_min(y2 - y1 + 1, 1.0), ph, H)
    w_lo, w_hi = _bin_span(x1, torch.clamp_min(x2 - x1 + 1, 1.0), pw, W)
    kh = max(int((h_hi - h_lo).max()), 1)
    kw = max(int((w_hi - w_lo).max()), 1)
    rows = h_lo[:, :, None] + torch.arange(kh, device=X.device)
    cols = w_lo[:, :, None] + torch.arange(kw, device=X.device)
    inside = ((rows < h_hi[:, :, None])[:, :, None, :, None]
              & (cols < w_hi[:, :, None])[:, None, :, None, :])
    v = _BinMax.apply(X, b, rows.clamp(max=H - 1), cols.clamp(max=W - 1),
                      inside)
    return {"Out": v.permute(0, 3, 1, 2).to(X.dtype)}


@register_op("ctc_greedy_decoder", propagate_seqlen=True)
def _ctc_greedy_decoder(ctx, X, SeqLen=None):
    """Greedy CTC decode (reference ctc_align_op.cc): the first argmax
    of each frame, repeats merged, blanks dropped, each row's tokens
    packed to its front and padded with the blank: [B, T] int64 ids and
    the int32 decoded lengths."""
    blank = ctx.attr("blank", 0)
    ids = torch.argmax(X, dim=-1)                       # [B, T]
    B, T = ids.shape
    if X.device.type == "meta":
        return {"Out": ids, "OutLen": X.new_empty((B,), dtype=torch.int32)}
    seqlen = (SeqLen.reshape(-1).long() if SeqLen is not None else
              torch.full((B,), T, dtype=torch.long, device=X.device))
    t = torch.arange(T, device=X.device)
    valid = t[None, :] < seqlen[:, None]
    prev = torch.cat([torch.full((B, 1), -1, dtype=ids.dtype,
                                 device=X.device), ids[:, :-1]], 1)
    keep = valid & (ids != blank) & (ids != prev)
    pos = torch.cumsum(keep.long(), dim=1) - 1
    blanks = torch.full_like(ids, blank)
    out = blanks.scatter(1, torch.where(keep, pos, T - 1),
                         torch.where(keep, ids, blanks))
    lens = keep.sum(dim=1)
    out = torch.where(t[None, :] < lens[:, None], out, blanks)
    return {"Out": out, "OutLen": lens.int()}


@register_op("lod_reset", propagate_seqlen=False)
def _lod_reset(ctx, X, Y=None):
    """Replace X's sequence-length companion (reference lod_reset_op.cc)
    with Y, or with the lengths of attr `target_lod` (offsets)."""
    if Y is not None:
        lens = Y.int()
    else:
        lod = [int(v) for v in ctx.attr("target_lod")]
        lens = torch.tensor([b - a for a, b in zip(lod, lod[1:])],
                            dtype=torch.int32, device=X.device)
    if ctx.env is not None and ctx.op is not None:
        for out_name in ctx.op.output("Out"):
            ctx.env[out_name + SEQLEN_SUFFIX] = lens
    return {"Out": X}


def _shift(x, fill, forward):
    """x moved one step along dim 1 (right if `forward`), `fill` entering
    at the open end."""
    pad = torch.full_like(x[:, :1], fill)
    return (torch.cat([pad, x[:, :-1]], 1) if forward
            else torch.cat([x[:, 1:], pad], 1))


def _chunk_marks(tags, types, valid, scheme):
    """Exact chunk (begin, last) position masks per stream (the JAX
    rule's `_chunk_marks`): a position is in a chunk iff its type >= 0;
    `begin` marks chunk starts, `last` chunk ends."""
    in_chunk = (types >= 0) & valid
    prev_in = _shift(in_chunk, False, True)
    prev_ty = _shift(types, -1, True)
    prev_tag = _shift(tags, -1, True)
    if scheme == "IOB":      # tag 0=B, 1=I
        begin = in_chunk & ((tags == 0) | ~prev_in | (prev_ty != types))
    elif scheme == "IOE":    # tag 0=I, 1=E: E terminates a chunk
        begin = in_chunk & (~prev_in | (prev_ty != types) | (prev_tag == 1))
    elif scheme == "plain":
        begin = in_chunk & (~prev_in | (prev_ty != types))
    else:
        raise NotImplementedError(f"chunk scheme {scheme!r}")
    nxt_begin = _shift(begin, False, False)
    nxt_in = _shift(in_chunk, False, False)
    last = in_chunk & (nxt_begin | ~nxt_in)
    if scheme == "IOE":
        last = in_chunk & ((tags == 1) | nxt_begin | ~nxt_in)
    return begin, last


@register_op("chunk_eval", propagate_seqlen=False)
def _chunk_eval(ctx, X, Label, SeqLen=None):
    """Chunk precision / recall / F1 for NER-style tagging (reference
    chunk_eval_op.cc): a predicted chunk is correct iff a label chunk has
    the same begin, end and type, matched through each stream's begin
    index carried to every chunk-last position (a running max)."""
    num_types = ctx.attr("num_chunk_types")
    scheme = ctx.attr("chunk_scheme", "IOB")
    tag_num = {"IOB": 2, "IOE": 2, "plain": 1}[scheme]
    exclude = ctx.attr("excluded_chunk_types", []) or []

    def split(x):
        x = x.reshape(x.shape[0], -1).long()
        types = torch.where(x >= 0, torch.div(x, tag_num,
                                              rounding_mode="floor"), -1)
        tags = torch.where(x >= 0, torch.remainder(x, tag_num), -1)
        oob = types >= num_types          # the "O"/outside tag
        return torch.where(oob, -1, types), torch.where(oob, -1, tags)

    def mask_excluded(types):
        m = torch.ones_like(types, dtype=torch.bool)
        for e in exclude:
            m &= types != e
        return m

    inf_ty, inf_tag = split(X)
    lab_ty, lab_tag = split(Label)
    B, T = inf_ty.shape
    seqlen = (SeqLen.reshape(-1).long() if SeqLen is not None else
              torch.full((B,), T, dtype=torch.long, device=X.device))
    idx = torch.arange(T, device=X.device)[None, :]
    valid = idx < seqlen[:, None]

    inf_b, inf_l = _chunk_marks(inf_tag, inf_ty, valid, scheme)
    lab_b, lab_l = _chunk_marks(lab_tag, lab_ty, valid, scheme)
    inf_b &= mask_excluded(inf_ty)
    lab_b &= mask_excluded(lab_ty)
    inf_l &= mask_excluded(inf_ty)
    lab_l &= mask_excluded(lab_ty)

    if X.device.type == "meta":
        inf_cbi = lab_cbi = idx.expand(B, T)
    else:
        inf_cbi = torch.cummax(torch.where(inf_b, idx, -1), dim=1).values
        lab_cbi = torch.cummax(torch.where(lab_b, idx, -1), dim=1).values
    correct = (inf_l & lab_l & (inf_cbi == lab_cbi) & (inf_cbi >= 0)
               & (inf_ty == lab_ty))

    n_inf = inf_b.sum().float()
    n_lab = lab_b.sum().float()
    n_cor = correct.sum().float()
    precision = torch.where(n_inf > 0, n_cor / torch.clamp_min(n_inf, 1),
                            0.0)
    recall = torch.where(n_lab > 0, n_cor / torch.clamp_min(n_lab, 1), 0.0)
    f1 = torch.where(n_cor > 0, 2 * precision * recall / torch.clamp_min(
        precision + recall, 1e-9), 0.0)
    return {"NumInferChunks": inf_b.sum().int(),
            "NumLabelChunks": lab_b.sum().int(),
            "NumCorrectChunks": correct.sum().int(),
            "Precision": precision, "Recall": recall, "F1-Score": f1}
