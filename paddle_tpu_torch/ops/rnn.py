"""Recurrent op rules over padded variable-length batches (mirror of
``paddle_tpu/ops/rnn.py``; reference paddle/fluid/operators/lstm_op.cc,
gru_op.cc, lstm_unit_op.cc, gru_unit_op.cc, lstmp_op.cc).

A batch is padded [B, T, ...] plus its int32 `@SEQLEN` lengths. The JAX
package runs the time loop as a `lax.scan`; here it is a Python loop
over all T steps, each step a few PyTorch ops on the whole batch. A row
past its length keeps its carry (m * new + (1 - m) * old, m its 0/1
mask at that step) and writes zeros, so the loop never reads a length
back to the host and runs T steps whatever the lengths are; the mask is
built once a call. `is_reverse` reverses each row's valid prefix before
the loop and after it. Gate order is (i, f, g, o) for the LSTM and
(u, r, c) for the GRU, as in the JAX package, so its weights load here
unchanged. Each op of a step is the JAX rule's, in its order, so a bf16
step (`lstm` and `gru` are in the AMP policy's bf16 set) rounds where
the JAX rule rounds (`_sigmoid` is `lax.logistic`'s rounding), and its
grads round where the JAX rule's transpose rounds (`_sigmoid` and
`_tanh` take their grads in the order of `lax.logistic`'s and
`lax.tanh`'s JVPs). The
recurrent product is `torch.matmul`, as the JAX package leaves it to
XLA outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from ..core import types
from ..core.registry import register_op
from .math import _sigmoid, _tanh

_ACTS = {
    "sigmoid": _sigmoid,
    "tanh": _tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
}


def _reverse_padded(x, seqlen):
    """Time reversal of each row's valid prefix of a padded [B, T, ...]
    batch; the padding stays where it is."""
    B, T = x.shape[0], x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    L = seqlen.reshape(-1, 1).long()
    idx = torch.where(t < L, L - 1 - t, t)
    idx = idx.reshape((B, T) + (1,) * (x.ndim - 2))
    return torch.gather(x, 1, idx.expand(x.shape))


def _prepare(ctx, Input, Bias, SeqLen, n_gates):
    """The x-projections with the gate biases added and, under
    `is_reverse`, each row's prefix reversed; the peephole taps W_ic,
    W_if, W_oc of a [1, 7H] LSTM bias (None without peepholes); the
    lengths; the step masks m and 1 - m, [B, T, 1] each."""
    B, T, G = Input.shape
    H = G // n_gates
    seqlen = SeqLen if SeqLen is not None else torch.full(
        (B,), T, dtype=torch.int32, device=Input.device)
    x = Input
    if ctx.attr("is_reverse", False):
        x = _reverse_padded(x, seqlen)
    peep = None
    if Bias is not None:
        b = Bias.reshape(-1)
        x = x + b[:G].reshape(1, 1, G)
        if ctx.attr("use_peepholes", False):
            peep = (b[4 * H:5 * H], b[5 * H:6 * H], b[6 * H:7 * H])
    t = torch.arange(T, device=Input.device)
    mask = (t[None, :] < seqlen.reshape(-1, 1)).to(Input.dtype)[..., None]
    return x, peep, seqlen, mask, 1.0 - mask


def _check_peepholes(ctx, Bias):
    if ctx.attr("use_peepholes", False) and Bias is None:
        raise ValueError(
            "use_peepholes=True needs the fused [1,7H] bias tensor (it "
            "carries W_ic/W_if/W_oc); pass a bias or use_peepholes=False")


def _finish(ctx, seqs, mask, seqlen):
    """Stack the steps' outputs to [B, T, ...], zero past each row's
    length, and undo `is_reverse`."""
    outs = []
    for s in seqs:
        out = torch.stack(s, dim=1) * mask
        if ctx.attr("is_reverse", False):
            out = _reverse_padded(out, seqlen)
        outs.append(out)
    return outs


def _steps(x):
    """The steps a loop runs: all T, but 1 on meta tensors (build-time
    shape inference), where one step has every step's shape and dtype and
    `_repeat` stands it in for the rest."""
    return 1 if x.device.type == "meta" else x.shape[1]


def _repeat(seq, x):
    return seq * x.shape[1] if x.device.type == "meta" else seq


def _lstm_loop(ctx, x, W, r0, c0, peep, mask, keep, proj=None):
    """The LSTM time loop of `lstm` (r is h) and `lstmp` (r is the
    projected state proj_act(h @ ProjWeight)). Returns the steps'
    recurrent outputs and cells, unmasked."""
    gate_act = _ACTS[ctx.attr("gate_activation", "sigmoid")]
    cell_act = _ACTS[ctx.attr("cell_activation", "tanh")]
    cand_act = _ACTS[ctx.attr("candidate_activation", "tanh")]
    r, c = r0, c0
    rs, cs = [], []
    for step in range(_steps(x)):
        m, mk = mask[:, step], keep[:, step]
        gates = x[:, step] + r @ W
        i, f, g, o = gates.chunk(4, dim=-1)
        if peep is not None:
            i = i + peep[0] * c
            f = f + peep[1] * c
        i, f = gate_act(i), gate_act(f)
        c_new = f * c + i * cand_act(g)
        if peep is not None:
            o = o + peep[2] * c_new
        o = gate_act(o)
        r_new = o * cell_act(c_new)
        if proj is not None:
            r_new = proj[1](r_new @ proj[0])
        c = m * c_new + mk * c
        r = m * r_new + mk * r
        rs.append(r_new)
        cs.append(c_new)
    return _repeat(rs, x), _repeat(cs, x)


@register_op("lstm")
def _lstm(ctx, Input, Weight, Bias=None, H0=None, C0=None, SeqLen=None):
    """Input: [B, T, 4H] x-projections, Weight: [H, 4H] recurrent, Bias:
    [1, 4H], or [1, 7H] with the peephole taps W_ic, W_if, W_oc after
    the gate biases (reference lstm_op.cc). Hidden, Cell: [B, T, H]."""
    _check_peepholes(ctx, Bias)
    B, T, H4 = Input.shape
    H = H4 // 4
    x, peep, seqlen, mask, keep = _prepare(ctx, Input, Bias, SeqLen, 4)
    h0 = H0 if H0 is not None else Input.new_zeros((B, H))
    c0 = C0 if C0 is not None else Input.new_zeros((B, H))
    hs, cs = _lstm_loop(ctx, x, Weight, h0, c0, peep, mask, keep)
    hidden, cell = _finish(ctx, (hs, cs), mask, seqlen)
    return {"Hidden": hidden, "Cell": cell}


@register_op("gru")
def _gru(ctx, Input, Weight, Bias=None, H0=None, SeqLen=None):
    """Input: [B, T, 3H] x-projections; Weight: [H, 3H] packed as
    [W_u | W_r | W_c]; gate order (u, r, c) (reference gru_op.cc)."""
    gate_act = _ACTS[ctx.attr("gate_activation", "sigmoid")]
    cand_act = _ACTS[ctx.attr("activation", "tanh")]
    B, T, H3 = Input.shape
    H = H3 // 3
    x, _, seqlen, mask, keep = _prepare(ctx, Input, Bias, SeqLen, 3)
    h = H0 if H0 is not None else Input.new_zeros((B, H))
    W_ur, W_c = Weight[:, :2 * H], Weight[:, 2 * H:]
    hs = []
    for step in range(_steps(x)):
        m, mk = mask[:, step], keep[:, step]
        xt = x[:, step]
        u, r = gate_act(xt[:, :2 * H] + h @ W_ur).chunk(2, dim=-1)
        c = cand_act(xt[:, 2 * H:] + (r * h) @ W_c)
        h_new = (1.0 - u) * h + u * c
        h = m * h_new + mk * h
        hs.append(h_new)
    hidden, = _finish(ctx, (_repeat(hs, x),), mask, seqlen)
    return {"Hidden": hidden}


@register_op("lstm_unit", propagate_seqlen=False)
def _lstm_unit(ctx, X, C_prev):
    """One LSTM cell step on pre-projected gates X [B, 4H] (reference
    lstm_unit_op.cc)."""
    i, f, g, o = X.chunk(4, dim=-1)
    i = _sigmoid(i)
    f = _sigmoid(f + types.scalar_as(ctx.attr("forget_bias", 0.0), f.dtype))
    g = _tanh(g)
    o = _sigmoid(o)
    c = f * C_prev + i * g
    return {"C": c, "H": o * _tanh(c)}


@register_op("gru_unit", propagate_seqlen=False)
def _gru_unit(ctx, Input, HiddenPrev, Weight, Bias=None):
    """One GRU step (reference gru_unit_op.cc) on the x-projection
    Input [B, 3H]."""
    gate_act = _ACTS[ctx.attr("gate_activation", "sigmoid")]
    cand_act = _ACTS[ctx.attr("activation", "tanh")]
    H3 = Input.shape[1]
    H = H3 // 3
    x = Input if Bias is None else Input + Bias.reshape(1, H3)
    W_ur, W_c = Weight[:, :2 * H], Weight[:, 2 * H:]
    u, r = gate_act(x[:, :2 * H] + HiddenPrev @ W_ur).chunk(2, dim=-1)
    c = cand_act(x[:, 2 * H:] + (r * HiddenPrev) @ W_c)
    h = (1.0 - u) * HiddenPrev + u * c
    return {"Hidden": h, "ResetHiddenPrev": r * HiddenPrev,
            "Gate": torch.cat([u, r, c], dim=-1)}


@register_op("lstmp")
def _lstmp(ctx, Input, Weight, ProjWeight, Bias=None, H0=None, C0=None,
           SeqLen=None):
    """LSTM with a recurrent projection (reference lstmp_op.cc): the gates
    read the projected state r = proj_act(h @ ProjWeight). Input:
    [B, T, 4H] x-projections; Weight: [P, 4H]; ProjWeight: [H, P].
    Projection: [B, T, P], Cell: [B, T, H]."""
    _check_peepholes(ctx, Bias)
    B, T, H4 = Input.shape
    H = H4 // 4
    P = ProjWeight.shape[1]
    x, peep, seqlen, mask, keep = _prepare(ctx, Input, Bias, SeqLen, 4)
    r0 = H0 if H0 is not None else Input.new_zeros((B, P))
    c0 = C0 if C0 is not None else Input.new_zeros((B, H))
    proj_act = _ACTS[ctx.attr("proj_activation", "tanh")]
    rs, cs = _lstm_loop(ctx, x, Weight, r0, c0, peep, mask, keep,
                        proj=(ProjWeight, proj_act))
    proj, cell = _finish(ctx, (rs, cs), mask, seqlen)
    return {"Projection": proj, "Cell": cell}
