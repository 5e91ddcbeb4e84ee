"""Program-level autodiff: `append_backward`.

Copy of ``paddle_tpu/core/backward.py`` (IR only, the reference's
python/paddle/fluid/backward.py:450 `append_backward`). Every forward op
gets ONE generic grad op; ``core/lowering.py`` runs it by recomputing the
forward rule under autograd. Fan-in gradient accumulation inserts `sum`
ops, and stop_gradient / no_grad_set prune dead branches, as in the
reference. The grad ops and their JSON are the JAX package's, op for op.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import ir, registry
from .ir import GRAD_SUFFIX, grad_var_name
from .registry import EMPTY_VAR, FWD_OP_ATTR, GRAD_OP_SUFFIX

# Ops that never need/propagate gradients.
_NON_DIFF_OPS = {"fill_constant", "uniform_random", "gaussian_random", "feed",
                 "fetch", "accuracy", "increment", "assign_value", "shape",
                 "iota", "truncated_gaussian_random"}


def _grad_contrib_name(name: str, k: int) -> str:
    return f"{name}{GRAD_SUFFIX}@RENAME@{k}"


def append_backward(loss: ir.Variable,
                    parameter_list: Optional[Sequence[str]] = None,
                    no_grad_set: Optional[Set[str]] = None,
                    ) -> List[Tuple[ir.Variable, ir.Variable]]:
    """Append gradient ops for `loss` to its program's global block.

    Returns [(parameter, gradient_variable)] pairs, like the reference.
    """
    block = loss.block
    program = block.program
    no_grad = set(no_grad_set or ())

    # 1. d(loss)/d(loss) = 1.
    loss_grad = _ensure_grad_var(block, loss)
    block.append_op(
        "fill_constant",
        outputs={"Out": [loss_grad.name]},
        attrs={"shape": list(loss.shape) if loss.shape else [1],
               "dtype": loss.dtype, "value": 1.0,
               "__role__": "backward"},
    )

    # 2. Reverse walk emitting grad ops; collect per-var grad contributions.
    #
    # Contributions are tracked in EPOCHS: programs are not strictly SSA (a
    # `while` loop or `assign(x, out=y)` re-writes an existing name), and
    # grad contributions to different SSA "versions" of a name must never be
    # summed together. When the reverse walk passes an op that WRITES var n,
    # n's current epoch closes and a fresh one opens; each epoch's
    # contributions are summed separately into the canonical `n@GRAD` name,
    # and ordered execution (grad ops run reverse-fwd) makes the canonical
    # name hold the right epoch's value at every read point. (The reference
    # gets the same effect with per-step scopes, while_op.cc:96.)
    loss_idx = _find_producer_idx(block, loss.name)
    # var -> list of epochs; each epoch is a list of (contrib_name, grad_op)
    contribs: Dict[str, List[List[Tuple[str, Optional[ir.Operator]]]]] = {
        loss.name: [[(loss_grad.name, block.ops[-1])]]}
    rename_counter: Dict[str, int] = {}
    fwd_ops = list(enumerate(block.ops[: loss_idx + 1]))

    def _has_grad(n):
        # only the CURRENT epoch's contributions are reachable by ops at this
        # point of the reverse walk; earlier epochs belong to later SSA
        # versions of the name (severed by a write barrier)
        return n in contribs and bool(contribs[n][-1])

    def _write_barrier(op):
        # this op produced these names; earlier consumers see the previous
        # SSA version, so their grads start a new epoch. Applies to EVERY
        # producing op — a non-diff op (fill_constant out=x) severs the
        # dependency just as thoroughly as a diff one.
        for ns in op.outputs.values():
            for n in ns:
                if n in contribs:
                    contribs[n].append([])

    for idx, op in reversed(fwd_ops):
        if op.type.endswith(GRAD_OP_SUFFIX):
            continue
        if op.type in _NON_DIFF_OPS:
            _write_barrier(op)
            continue
        out_has_grad = any(_has_grad(n) for ns in op.outputs.values() for n in ns)
        if not out_has_grad:
            _write_barrier(op)
            continue
        if op.type == "while":
            raise NotImplementedError(
                "gradients cannot flow through an unbounded `while` loop "
                "(control flow is not ported to paddle_tpu_torch yet)")
        grad_targets = _grad_needing_inputs(block, op, no_grad, parameter_list)

        # out-grad inputs: canonical @GRAD names.
        out_grad_names = []
        for ns in op.outputs.values():
            for n in ns:
                if _has_grad(n):
                    out_grad_names.append(grad_var_name(n))

        _write_barrier(op)

        if not grad_targets:
            continue

        # in-grad outputs: contribution names within the target's epoch.
        out_names, touched = [], []
        for n in grad_targets:
            epochs = contribs.setdefault(n, [[]])
            epoch = epochs[-1]
            if not epoch:
                cname = grad_var_name(n)
            else:
                k = rename_counter.get(n, 0) + 1
                rename_counter[n] = k
                cname = _grad_contrib_name(n, k)
            out_names.append(cname)
            touched.append(n)
            _ensure_grad_var(block, block.var(n), cname)

        fwd_desc = op.to_dict()
        fwd_desc["__idx__"] = idx
        grad_op = ir.Operator(
            block, op.type + GRAD_OP_SUFFIX,
            inputs={"FwdIn": sorted({n for ns in op.inputs.values() for n in ns}),
                    "OutGrad": out_grad_names},
            outputs={"InGrad": out_names},
            attrs={FWD_OP_ATTR: fwd_desc, "__role__": "backward"},
        )
        block.ops.append(grad_op)
        program._bump()
        for n, cname in zip(touched, out_names):
            contribs[n][-1].append((cname, grad_op))

    # 3. Fan-in accumulation per epoch: rename the epoch's first contribution
    # (which took the canonical name) and insert a `sum` op right after the
    # epoch's last contribution (reference `_addup_repetitive_outputs_`).
    _insert_sum_ops(block, contribs, loss.name, rename_counter)

    # 4. Collect (param, grad) pairs.
    params = block.all_parameters()
    if parameter_list is not None:
        wanted = set(parameter_list)
        params = [p for p in params if p.name in wanted]
    pairs = []
    for p in params:
        if not p.trainable or p.name in no_grad:
            continue
        gname = grad_var_name(p.name)
        if p.name in contribs:
            pairs.append((p, block.var(gname)))
    return pairs


def _insert_sum_ops(block: ir.Block, contribs, loss_name: str,
                    rename_counter: Dict[str, int]):
    # Collect (var, epoch) groups needing a sum, with their op references.
    pending = []  # (n, [(cname, op), ...])
    for n, epochs in contribs.items():
        if n == loss_name:
            continue
        for epoch in epochs:
            if len(epoch) > 1:
                pending.append((n, epoch))
    if not pending:
        return
    for n, epoch in pending:
        canonical = grad_var_name(n)
        # rename the epoch's first contribution (it took the canonical name)
        first_name, first_op = epoch[0]
        k = rename_counter.get(n, 0) + 1
        rename_counter[n] = k
        renamed0 = _grad_contrib_name(n, k)
        for slot, names in first_op.outputs.items():
            for j, out in enumerate(names):
                if out == first_name:
                    names[j] = renamed0
        _ensure_grad_var(block, block.var(n), renamed0)
        srcs = [renamed0] + [c for c, _ in epoch[1:]]
        # insert the sum right after the epoch's last contributing op
        ops_in_epoch = {id(op) for _, op in epoch}
        last_idx = max(i for i, op in enumerate(block.ops)
                       if id(op) in ops_in_epoch)
        block.insert_op(last_idx + 1, "sum",
                        inputs={"X": srcs}, outputs={"Out": [canonical]},
                        attrs={"__role__": "backward"})


def _grad_needing_inputs(block, op, no_grad, parameter_list) -> List[str]:
    """Inputs of `op` that should receive gradients (dedup, order-stable)."""
    seen, out = set(), []
    for ns in op.inputs.values():
        for n in ns:
            if n in seen or n == EMPTY_VAR:
                continue
            seen.add(n)
            if n in no_grad:
                continue
            if not block.has_var(n):
                continue
            v = block.var(n)
            from .types import is_float_dtype
            if v.stop_gradient or not is_float_dtype(v.dtype):
                continue
            out.append(n)
    return out


def _ensure_grad_var(block: ir.Block, fwd_var: ir.Variable, name: Optional[str] = None):
    name = name or grad_var_name(fwd_var.name)
    if name in block.vars:
        return block.vars[name]
    return block.create_var(name=name, shape=fwd_var.shape, dtype=fwd_var.dtype,
                            stop_gradient=True)


def _find_producer_idx(block: ir.Block, name: str) -> int:
    for i in range(len(block.ops) - 1, -1, -1):
        if name in block.ops[i].output_arg_names:
            return i
    raise ValueError(f"loss var {name!r} has no producing op in block")


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Reference calc_gradient analog (backward.py:667): gradients of
    `targets` w.r.t. `inputs`."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if len(targets) != 1:
        raise NotImplementedError("calc_gradient currently supports one target")
    pairs = append_backward(targets[0], no_grad_set=no_grad_set,
                            parameter_list=None)
    block = targets[0].block
    outs = []
    for v in inputs:
        gname = grad_var_name(v.name)
        outs.append(block.var(gname) if block.has_var(gname) else None)
    return outs
