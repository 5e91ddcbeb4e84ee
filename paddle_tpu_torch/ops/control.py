"""Control-flow op rules: `while`, `bounded_while`, `static_rnn`,
`dynamic_rnn`, `conditional_block`, `if_else`, `select_input`.

Mirror of ``paddle_tpu/ops/control.py`` (reference while_op.cc,
recurrent_op.cc, conditional_block_op.cc). The JAX package makes a
sub-block the body of `lax.while_loop` / `lax.scan` / `lax.cond`; here
each is a host loop (or branch) that runs the sub-block's rules on a
copy of the live env through `ctx.run_block`, as the reference's C++ ops
run a nested executor. The copy carries every outer value, the
`@SEQLEN` companions included, into the body.

`static_rnn`, `bounded_while` and `dynamic_rnn` read nothing back from
the card: their step count is a shape or an attr, and a finished row or
a dead iteration is masked with `torch.where` (never `x * m`, which
would carry a NaN of a padded step into the result). Only `while` and
`conditional_block` read their predicate on the host, once an
iteration or a call, as the reference's C++ ops do. On meta tensors
(build-time shape inference) one step stands in for all of them.

Iteration t of a loop runs the body with seeds derived from (the op's
seed, t), the counterpart of `fold_in(key, t)`; a generic grad's
recompute derives the same ones.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op


def _run_sub(ctx, sub_idx, carry, step=0):
    env2 = dict(ctx.env)
    env2.update(carry)
    return ctx.run_block(sub_idx, env2, step)


def _is_meta(t):
    return isinstance(t, torch.Tensor) and t.device.type == "meta"


def _row_mask(active, v):
    """[B] bool -> broadcastable against v [B, ...]."""
    return active.reshape(active.shape + (1,) * (v.ndim - active.ndim))


@register_op("while", propagate_seqlen=False, needs_rng=True,
             reads_env=True)
def _while(ctx, X=None, Condition=None):
    """attrs: sub_block, carry_vars (the loop state, the condition
    among them), cond_var, carry_pre (each carry's `@PRE` snapshot). The
    sub-block must write the condition each iteration; the loop reads it
    back once an iteration."""
    env = ctx.env
    sub_idx = ctx.attr("sub_block")
    carry_names = list(ctx.attr("carry_vars"))
    cond_name = ctx.attr("cond_var")
    pre_map = ctx.attr("carry_pre", {}) or {}
    carry = {n: env[pre_map.get(n, n)] for n in carry_names}
    t = 0
    while (t == 0 if _is_meta(carry[cond_name])
           else bool(carry[cond_name].reshape(()))):
        env2 = _run_sub(ctx, sub_idx, carry, t)
        carry = {n: env2[n] for n in carry_names}
        t += 1
    return {"Out": [carry[n] for n in carry_names]}


@register_op("bounded_while", propagate_seqlen=False, needs_rng=True,
             reads_env=True)
def _bounded_while(ctx, X=None, Condition=None):
    """A `While(cond, max_iters=N)` loop: N iterations, each keeping the
    carry where the condition was already false at its start, so the
    result is the unbounded loop's and autograd runs through it."""
    env = ctx.env
    sub_idx = ctx.attr("sub_block")
    carry_names = list(ctx.attr("carry_vars"))
    cond_name = ctx.attr("cond_var")
    pre_map = ctx.attr("carry_pre", {}) or {}
    n_iters = int(ctx.attr("max_iters"))
    carry = {n: env[pre_map.get(n, n)] for n in carry_names}
    for t in range(1 if _is_meta(carry[cond_name]) else n_iters):
        live = carry[cond_name].reshape(())
        env2 = _run_sub(ctx, sub_idx, carry, t)
        carry = {n: torch.where(live, env2[n], carry[n])
                 for n in carry_names}
    return {"Out": [carry[n] for n in carry_names]}


def _stack_steps(steps, n_out, T):
    """Per-step output tuples -> [B, T, ...] each; on meta the one step
    stands in for T."""
    outs = []
    for i in range(n_out):
        seq = [s[i] for s in steps]
        if len(seq) < T:
            seq = seq * T
        outs.append(torch.stack(seq, dim=1))
    return outs


@register_op("static_rnn", propagate_seqlen=False, needs_rng=True,
             reads_env=True)
def _static_rnn(ctx, X=None):
    """Run the sub-block over the time axis. attrs: sub_block;
    step_inputs [(outer, inner)], outer [B, T, ...] read as [B, ...] a
    step; memories [(inner pre, inner mem, init)]; step_outputs [inner]
    stacked to [B, T, ...]; num_steps for a loop with no step input."""
    env = ctx.env
    sub_idx = ctx.attr("sub_block")
    step_inputs = [tuple(p) for p in ctx.attr("step_inputs")]
    memories = [tuple(m) for m in ctx.attr("memories")]
    step_outputs = list(ctx.attr("step_outputs"))
    xs = {inner: env[outer] for outer, inner in step_inputs}
    if xs:
        T = next(iter(xs.values())).shape[1]
    else:
        T = int(ctx.attr("num_steps") or 0)
        if T <= 0:
            raise ValueError(
                "StaticRNN has no step_input and no positive num_steps — "
                "pass StaticRNN(num_steps=...) for input-free decode loops")
    mems = {pre: env[init] for pre, mem, init in memories}
    meta = ctx.device.type == "meta" or any(
        _is_meta(v) for v in list(xs.values()) + list(mems.values()))
    steps = []
    for t in range(1 if meta else T):
        carry = dict(mems)
        carry.update({inner: x[:, t] for inner, x in xs.items()})
        env2 = _run_sub(ctx, sub_idx, carry, t)
        mems = {pre: env2[mem] for pre, mem, init in memories}
        steps.append(tuple(env2[n] for n in step_outputs))
    return {"Out": _stack_steps(steps, len(step_outputs), T)}


@register_op("dynamic_rnn", propagate_seqlen=False, needs_rng=True,
             reads_env=True)
def _dynamic_rnn(ctx, X=None, SeqLen=None):
    """A variable-length RNN over a padded batch (reference DynamicRNN):
    all T steps on the whole batch; a row's memory keeps its value once
    t reaches the row's length, and its step outputs are zero there, so
    `sequence_pool('last')` finds each row's final state. attrs as
    static_rnn's; SeqLen the first step input's lengths."""
    env = ctx.env
    sub_idx = ctx.attr("sub_block")
    step_inputs = [tuple(p) for p in ctx.attr("step_inputs")]
    memories = [tuple(m) for m in ctx.attr("memories")]
    step_outputs = list(ctx.attr("step_outputs"))
    x0 = env[step_inputs[0][0]]
    B, T = x0.shape[0], x0.shape[1]
    lengths = (SeqLen.reshape(-1) if SeqLen is not None
               else torch.full((B,), T, dtype=torch.int32, device=x0.device))
    xs = {inner: env[outer] for outer, inner in step_inputs}
    mems = {pre: env[init] for pre, mem, init in memories}
    steps = []
    for t in range(1 if _is_meta(x0) else T):
        active = lengths > t
        carry = dict(mems)
        carry.update({inner: x[:, t] for inner, x in xs.items()})
        env2 = _run_sub(ctx, sub_idx, carry, t)
        mems = {pre: torch.where(_row_mask(active, env2[mem]), env2[mem],
                                 mems[pre])
                for pre, mem, init in memories}
        steps.append(tuple(
            torch.where(_row_mask(active, env2[n]), env2[n],
                        torch.zeros((), dtype=env2[n].dtype,
                                    device=env2[n].device))
            for n in step_outputs))
    return {"Out": _stack_steps(steps, len(step_outputs), T),
            "OutLen": [lengths.to(torch.int32)] * len(step_outputs)}


@register_op("conditional_block", propagate_seqlen=False, needs_rng=True,
             reads_env=True)
def _conditional_block(ctx, Cond, X=None):
    """attrs: sub_block, out_vars (written by the branch), else_block
    (-1 for none). The predicate is read once a call. With no else
    branch a false predicate leaves the vars' current values, as the
    reference skips the block."""
    env = ctx.env
    sub_idx = ctx.attr("sub_block")
    else_idx = ctx.attr("else_block", -1)
    out_names = list(ctx.attr("out_vars"))
    pred = True if _is_meta(Cond) else bool(Cond.reshape(()))
    if pred:
        env2 = _run_sub(ctx, sub_idx, {})
    elif else_idx >= 0:
        env2 = _run_sub(ctx, else_idx, {})
    else:
        missing = [n for n in out_names if n not in env]
        if missing:
            raise ValueError(
                f"conditional_block out_vars {missing} have no prior value; "
                f"assign them before the block or add an else branch")
        env2 = env
    return {"Out": [env2[n] for n in out_names]}


@register_op("if_else", propagate_seqlen=False, needs_rng=True,
             reads_env=True)
def _if_else(ctx, Cond, X=None):
    """Per-row two-way branch (reference IfElse): both sub-blocks run on
    the whole batch and each output takes the true branch's row where
    Cond [B, 1] holds, the false branch's elsewhere. attrs: true_block,
    false_block, true_outs, false_outs (inner names)."""
    env_t = _run_sub(ctx, ctx.attr("true_block"), {})
    env_f = _run_sub(ctx, ctx.attr("false_block"), {})
    cond = Cond.reshape(Cond.shape[0]).to(torch.bool)
    merged = []
    for tn, fn in zip(ctx.attr("true_outs"), ctx.attr("false_outs")):
        tv, fv = env_t[tn], env_f[fn]
        merged.append(torch.where(_row_mask(cond, tv), tv, fv.to(tv.dtype)))
    return {"Out": merged}


@register_op("select_input", propagate_seqlen=False)
def _select_input(ctx, X, Mask):
    """X[Mask] of same-shaped branch results, the index clamped into
    range as `lax.switch` clamps it; no host read."""
    xs = X if isinstance(X, list) else [X]
    idx = Mask.reshape(1).long().clamp(0, len(xs) - 1)
    return {"Out": torch.index_select(torch.stack(xs), 0, idx)[0]}
