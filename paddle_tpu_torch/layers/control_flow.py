"""Control-flow layers (mirror of ``paddle_tpu/layers/control_flow.py``;
reference python/paddle/fluid/layers/control_flow.py: While :654,
StaticRNN :429, Switch :1282, IfElse :1408, DynamicRNN :1538, the tensor
arrays and the rank-table family). Each builds the JAX package's
Program, op for op and name for name: a loop or branch body is a nested
block, and one op in the parent block (``ops/control.py``) runs it. The
op's `X` names the body's external reads, so the executor loads a
parameter that only the body reads, and its generic grad reaches it.
`ParallelDo` is the JAX package's shim: its body is traced inline over
the full batch, and `ParallelExecutor` splits the batch.
"""

from __future__ import annotations

import contextlib

from .. import unique_name
from ..core import ir
from ..layer_helper import LayerHelper
from . import tensor as lt


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out_name = x.name if in_place else None
    if out_name is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        out_name = out.name
    helper.append_op("increment", inputs={"X": [x.name]},
                     outputs={"Out": [out_name]}, attrs={"step": float(value)})
    return x if in_place else out


def less_than(x, y, cond=None):
    helper = LayerHelper("less_than")
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype="bool")
    helper.append_op("less_than", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [cond.name]}, attrs={"axis": -1})
    return cond


def equal(x, y, cond=None):
    helper = LayerHelper("equal")
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype="bool")
    helper.append_op("equal", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [cond.name]}, attrs={"axis": -1})
    return cond


class While:
    """`with While(cond).block(): ...` loop (reference control_flow.py:654).

    The body must re-assign `cond` (via layers.assign / logical ops) so the
    loop terminates. All outer variables assigned inside the body become
    loop-carried state.
    """

    def __init__(self, cond, is_test=False, name=None, max_iters=None):
        """`max_iters` bounds the loop at N masked iterations so gradients
        flow through it (op `bounded_while`); without it the loop (op
        `while`) reads its condition back each iteration and is
        forward-only (reference while_grad, while_op.cc:96, is the
        analogous backward machinery)."""
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.max_iters = max_iters

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent_block = program.current_block()
        sub_block = program._create_block()
        yield
        program._rollback()

        # loop-carried state: vars written in the sub-block that exist in an
        # enclosing block (assign-out pattern), plus the condition.
        carry = []
        for op in sub_block.ops:
            for n in op.output_arg_names:
                if n in parent_block.vars or (
                        parent_block._find_var_recursive(n) is not None
                        and n not in sub_block.vars):
                    if n not in carry:
                        carry.append(n)
        if self.cond_var.name not in carry:
            carry.append(self.cond_var.name)
        x_inputs = sorted(set(ir.external_reads(program, sub_block.idx))
                          | set(carry))

        # SSA snapshot of the loop-carried state: the while op mutates its
        # carries in place, so a grad op re-tracing the loop later would read
        # POST-loop values (e.g. cond already false -> identity loop, wrong
        # grads). Copy each carry to a fresh `@PRE` var the op reads instead;
        # `assign`'s grad then routes carry grads back to the real producers
        # through the normal fan-in machinery.
        pre_map = {}
        for n in carry:
            pre = parent_block.create_var(
                name=unique_name.generate(f"{n}@PRE"),
                shape=parent_block._find_var_recursive(n).shape
                if parent_block._find_var_recursive(n) is not None else (),
                dtype=parent_block._find_var_recursive(n).dtype
                if parent_block._find_var_recursive(n) is not None
                else "float32")
            parent_block.append_op("assign", inputs={"X": [n]},
                                   outputs={"Out": [pre.name]})
            pre_map[n] = pre.name

        attrs = {"sub_block": sub_block.idx, "carry_vars": list(carry),
                 "cond_var": self.cond_var.name,
                 "carry_pre": {n: pre_map[n] for n in carry}}
        op_type = "while"
        if self.max_iters is not None:
            op_type = "bounded_while"
            attrs["max_iters"] = int(self.max_iters)
        x_ext = [n for n in x_inputs
                 if parent_block._find_var_recursive(n) is not None
                 and n not in pre_map]
        parent_block.append_op(
            op_type,
            inputs={"X": x_ext + [pre_map[n] for n in carry],
                    "Condition": [pre_map[self.cond_var.name]]},
            outputs={"Out": list(carry)},
            attrs=attrs)


class StaticRNN:
    """Fixed-length RNN builder (reference control_flow.py:429).

    with rnn.step():
        x_t = rnn.step_input(x)       # [B, T, D] -> [B, D]
        h = rnn.memory(init=h0)       # carried state
        nh = some_layers(x_t, h)
        rnn.update_memory(h, nh)
        rnn.step_output(nh)
    outs = rnn()                      # [B, T, H]
    """

    def __init__(self, name=None, num_steps=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self.num_steps = num_steps  # for input-free (decode) loops
        self._step_inputs = []   # (outer_name, inner_name)
        self._memories = []      # (pre_name, mem_name, init_name)
        self._step_outputs = []  # inner names
        self._outputs = []       # outer Vars
        self._sub_block = None
        self._parent_block = None

    @contextlib.contextmanager
    def step(self):
        program = self.helper.main_program
        self._parent_block = program.current_block()
        self._sub_block = program._create_block()
        yield
        program._rollback()
        self._finalize()

    def step_input(self, x):
        inner = self._sub_block.create_var(
            name=f"{self.helper.name}.in_{len(self._step_inputs)}",
            shape=(x.shape[0],) + tuple(x.shape[2:]), dtype=x.dtype)
        self._step_inputs.append((x.name, inner.name))
        return inner

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=1):
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError("memory() needs `init` or (shape, batch_ref)")
            # build init in the PARENT block
            program = self.helper.main_program
            cur = program._current_block_idx
            program._current_block_idx = self._parent_block.idx
            try:
                from . import tensor as _t
                init = _t.fill_constant_batch_size_like(
                    batch_ref, [0] + list(shape[1:] if len(shape) > 1 else shape),
                    "float32", init_value, input_dim_idx=0, output_dim_idx=0)
            finally:
                program._current_block_idx = cur
        pre = self._sub_block.create_var(
            name=f"{self.helper.name}.mem_{len(self._memories)}",
            shape=init.shape, dtype=init.dtype)
        self._memories.append([pre.name, None, init.name])
        return pre

    def update_memory(self, mem, var):
        for m in self._memories:
            if m[0] == mem.name:
                m[1] = var.name
                return
        raise ValueError(f"{mem.name} is not a memory of this StaticRNN")

    def step_output(self, o):
        self._step_outputs.append(o.name)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _finalize(self):
        for m in self._memories:
            if m[1] is None:
                raise ValueError(f"memory {m[0]} was never update_memory()-ed")
        outs = []
        for inner_name in self._step_outputs:
            inner = self._sub_block.vars.get(inner_name)
            shape = ((inner.shape[0], -1) + tuple(inner.shape[1:])
                     if inner is not None and inner.shape else ())
            out = self._parent_block.create_var(
                name=f"{self.helper.name}.out_{len(outs)}",
                shape=shape, dtype=inner.dtype if inner else "float32")
            outs.append(out)
        self._outputs = outs
        program = self.helper.main_program
        externals = [n for n in ir.external_reads(program, self._sub_block.idx)
                     if self._parent_block._find_var_recursive(n) is not None]
        init_names = [m[2] for m in self._memories]
        x_names = [outer for outer, _ in self._step_inputs]
        all_ins = list(dict.fromkeys(x_names + init_names + externals))
        self._parent_block.append_op(
            "static_rnn",
            inputs={"X": all_ins},
            outputs={"Out": [o.name for o in outs]},
            attrs={"sub_block": self._sub_block.idx,
                   "step_inputs": [list(p) for p in self._step_inputs],
                   "memories": [list(m) for m in self._memories],
                   "step_outputs": list(self._step_outputs),
                   "num_steps": self.num_steps or 0})

    def __call__(self):
        if len(self._outputs) == 1:
            return self._outputs[0]
        return self._outputs


class Switch:
    """Reference control_flow.py:1282 — used mainly for LR warmup schedules.
    First matching case wins, as in the reference: each case's effective
    condition is `its condition AND none-of-the-previous`; the default fires
    only when every case condition was false. Each case is a
    `conditional_block` over a sub-block.
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self._prev_conds = []

    @contextlib.contextmanager
    def case(self, condition):
        yield from self._record(condition)

    @contextlib.contextmanager
    def default(self):
        yield from self._record(None)

    def _record(self, condition):
        program = self.helper.main_program
        parent = program.current_block()
        sub = program._create_block()
        yield
        program._rollback()
        outs = sorted({n for op in sub.ops for n in op.output_arg_names
                       if parent._find_var_recursive(n) is not None})
        eff = self._effective_cond(parent, condition)
        if condition is not None:
            self._prev_conds.append(condition)
        externals = [n for n in ir.external_reads(program, sub.idx)
                     if parent._find_var_recursive(n) is not None]
        prior = [n for n in outs if n not in externals]
        parent.append_op(
            "conditional_block",
            inputs={"Cond": [eff.name], "X": externals + prior},
            outputs={"Out": outs},
            attrs={"sub_block": sub.idx, "out_vars": outs, "else_block": -1})

    def _effective_cond(self, parent, condition):
        from .. import unique_name

        def _logical(op_type, ins):
            name = unique_name.generate("switch_cond")
            v = parent.create_var(name=name, shape=(1,), dtype="bool",
                                  stop_gradient=True)
            parent.append_op(op_type, inputs=ins, outputs={"Out": [name]},
                             attrs={"axis": -1})
            return v

        none_prev = None
        for prev in self._prev_conds:
            none_prev = (prev if none_prev is None
                         else _logical("logical_or", {"X": [none_prev.name],
                                                      "Y": [prev.name]}))
        if none_prev is not None:
            none_prev = _logical("logical_not", {"X": [none_prev.name]})
        if condition is None:
            return none_prev if none_prev is not None else _always_true(parent)
        if none_prev is None:
            return condition
        return _logical("logical_and", {"X": [condition.name],
                                        "Y": [none_prev.name]})


def _always_true(block):
    from .. import unique_name
    name = unique_name.generate("switch_true")
    v = block.create_var(name=name, shape=(1,), dtype="bool", stop_gradient=True)
    block.append_op("fill_constant", outputs={"Out": [name]},
                    attrs={"shape": [1], "dtype": "bool", "value": 1.0})
    return v


# ---------------------------------------------------------------------------
# Tensor arrays (reference: layers/control_flow.py array_write :1030,
# array_read :1120, array_length :1190, tensor_array_read_write_op.cc).
# A tensor array is a pre-allocated [capacity, ...] device buffer plus an
# `@ALEN` int32 length companion (ops/tensor_array.py), so a loop indexes it
# with a device tensor instead of growing a host vector.
# ---------------------------------------------------------------------------

ALEN_SUFFIX = "@ALEN"


def _alen_var(block, array):
    name = array.name + ALEN_SUFFIX
    if name in block.vars:
        return block.vars[name]
    return block.create_var(name=name, shape=(), dtype="int32",
                            stop_gradient=True)


def create_array(dtype="float32", capacity=None):
    """Declare a tensor-array variable (reference create_array). `capacity`
    bounds the number of entries (static buffer size); defaults to
    ops.tensor_array.DEFAULT_ARRAY_CAPACITY at first write."""
    helper = LayerHelper("array")
    arr = helper.block.create_var(
        name=unique_name.generate("array"), shape=(), dtype=dtype)
    arr.is_tensor_array = True
    arr.array_capacity = capacity
    arr.array_written = False
    return arr


def array_write(x, i, array=None, capacity=None):
    """Write x into array[i]; returns the array (reference :1030)."""
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(dtype=x.dtype, capacity=capacity)
    block = helper.block
    alen = _alen_var(block, array)
    inputs = {"X": [x.name], "I": [i.name]}
    written = getattr(array, "array_written", True)
    if written:
        inputs["Array"] = [array.name]
        inputs["ALen"] = [alen.name]
    cap = capacity or getattr(array, "array_capacity", None)
    attrs = {"capacity": int(cap)} if cap else {}
    helper.append_op("array_write", inputs=inputs,
                     outputs={"Out": [array.name], "OutLen": [alen.name]},
                     attrs=attrs)
    array.array_written = True
    return array


def array_read(array, i):
    """Read array[i] (reference :1120)."""
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(dtype=array.dtype)
    helper.append_op("array_read",
                     inputs={"Array": [array.name], "I": [i.name]},
                     outputs={"Out": [out.name]})
    return out


def array_length(array):
    """Logical length of the array (reference :1190)."""
    helper = LayerHelper("array_length")
    alen = _alen_var(helper.block, array)
    out = helper.create_variable_for_type_inference(dtype="int32")
    out.stop_gradient = True
    helper.append_op("array_length", inputs={"ALen": [alen.name]},
                     outputs={"Out": [out.name]})
    return out


def lod_rank_table(x, level=0):
    """Sequence rank table (reference lod_rank_table :828). On the padded
    representation this is the row-lengths vector (ops/tensor_array.py)."""
    helper = LayerHelper("lod_rank_table")
    inputs = {"X": [x.name]}
    seq = helper.ensure_seqlen_var(x)
    if seq is not None:
        inputs["SeqLen"] = [seq.name]
    out = helper.create_variable_for_type_inference(dtype="int32")
    out.stop_gradient = True
    helper.append_op("lod_rank_table", inputs=inputs,
                     outputs={"Out": [out.name]})
    return out


def max_sequence_len(rank_table):
    """Max length in a rank table (reference max_sequence_len :895)."""
    helper = LayerHelper("max_seqence_len")
    out = helper.create_variable_for_type_inference(dtype="int32")
    out.stop_gradient = True
    helper.append_op("max_sequence_len", inputs={"RankTable": [rank_table.name]},
                     outputs={"Out": [out.name]})
    return out


def lod_tensor_to_array(x, table):
    """[B,T,...] LoD tensor -> time-major tensor array (reference :925)."""
    helper = LayerHelper("lod_tensor_to_array")
    array = create_array(dtype=x.dtype)
    alen = _alen_var(helper.block, array)
    helper.append_op("lod_tensor_to_array",
                     inputs={"X": [x.name], "RankTable": [table.name]},
                     outputs={"Out": [array.name], "OutLen": [alen.name]})
    array.array_written = True
    return array


def array_to_lod_tensor(x, table):
    """Tensor array -> [B,T,...] LoD tensor with lengths restored (:975)."""
    helper = LayerHelper("array_to_lod_tensor")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.lod_level = 1
    helper.append_op("array_to_lod_tensor",
                     inputs={"X": [x.name], "RankTable": [table.name]},
                     outputs={"Out": [out.name]})
    return out


def shrink_memory(x, i, table):
    """Freeze finished rows at step i (reference shrink_rnn_memory_op.cc);
    masked-select analog — see ops/tensor_array.py."""
    helper = LayerHelper("shrink_memory")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("shrink_memory",
                     inputs={"X": [x.name], "I": [i.name],
                             "RankTable": [table.name]},
                     outputs={"Out": [out.name]})
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    idx = helper.create_variable_for_type_inference(dtype="int32")
    idx.stop_gradient = True
    helper.append_op("reorder_lod_tensor_by_rank",
                     inputs={"X": [x.name], "RankTable": [rank_table.name]},
                     outputs={"Out": [out.name], "OutIndex": [idx.name]})
    return out


class DynamicRNN:
    """Variable-length RNN builder (reference control_flow.py:1538).

    with rnn.block():
        x_t = rnn.step_input(seq)          # [B,T,D] lod var -> [B,D]
        h = rnn.memory(shape=[H], value=0) # carried, frozen past row length
        nh = some_layers(x_t, h)
        rnn.update_memory(h, nh)
        rnn.output(nh)
    out = rnn()                            # [B,T,H] lod var

    One op (`dynamic_rnn`, ops/control.py) runs all T steps with per-row
    masks instead of the reference's lod_rank_table/while/shrink_rnn_memory
    pipeline — identical numerics on the padded representation.
    """

    BEFORE_RNN = 0
    IN_RNN = 1
    AFTER_RNN = 2

    def __init__(self, name=None):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self.status = DynamicRNN.BEFORE_RNN
        self._step_inputs = []   # (outer_name, inner_name)
        self._static_inputs = []
        self._memories = []      # [pre_name, mem_name or None, init_name]
        self._step_outputs = []
        self._outputs = []
        self._sub_block = None
        self._parent_block = None
        self._seq_var = None     # first step_input's outer var (for lengths)

    @contextlib.contextmanager
    def block(self):
        if self.status != DynamicRNN.BEFORE_RNN:
            raise ValueError("rnn.block() can only be entered once")
        program = self.helper.main_program
        self._parent_block = program.current_block()
        self._sub_block = program._create_block()
        self.status = DynamicRNN.IN_RNN
        yield
        program._rollback()
        self.status = DynamicRNN.AFTER_RNN
        self._finalize()

    def step_input(self, x, level=0):
        self._assert_in_rnn("step_input")
        if self._seq_var is None:
            self._seq_var = x
        inner = self._sub_block.create_var(
            name=f"{self.helper.name}.in_{len(self._step_inputs)}",
            shape=(x.shape[0],) + tuple(x.shape[2:]), dtype=x.dtype)
        self._step_inputs.append((x.name, inner.name))
        return inner

    def static_input(self, x):
        """A var visible unchanged at every step (reference :1636) — with
        whole-batch masking no reorder is needed; the var is simply read."""
        self._assert_in_rnn("static_input")
        self._static_inputs.append(x.name)
        return x

    def memory(self, init=None, shape=None, value=0.0, need_reorder=False,
               dtype="float32"):
        self._assert_in_rnn("memory")
        if init is None:
            if shape is None:
                raise ValueError("memory() needs `init` or `shape`")
            if self._seq_var is None:
                raise ValueError("call step_input() before shape-based memory()")
            program = self.helper.main_program
            cur = program._current_block_idx
            program._current_block_idx = self._parent_block.idx
            try:
                init = lt.fill_constant_batch_size_like(
                    self._seq_var, [-1] + list(shape), dtype, value,
                    input_dim_idx=0, output_dim_idx=0)
            finally:
                program._current_block_idx = cur
        pre = self._sub_block.create_var(
            name=f"{self.helper.name}.mem_{len(self._memories)}",
            shape=init.shape, dtype=init.dtype)
        self._memories.append([pre.name, None, init.name])
        return pre

    def update_memory(self, ex_mem, new_mem):
        self._assert_in_rnn("update_memory")
        for m in self._memories:
            if m[0] == ex_mem.name:
                m[1] = new_mem.name
                return
        raise ValueError(f"{ex_mem.name} is not a memory of this DynamicRNN")

    def output(self, *outputs):
        self._assert_in_rnn("output")
        for o in outputs:
            self._step_outputs.append(o.name)

    def _assert_in_rnn(self, method):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError(f"{method}() must be called inside rnn.block()")

    def _finalize(self):
        if not self._step_inputs:
            raise ValueError("DynamicRNN needs at least one step_input")
        for m in self._memories:
            if m[1] is None:
                raise ValueError(f"memory {m[0]} was never update_memory()-ed")
        if not self._step_outputs:
            raise ValueError("DynamicRNN needs at least one output")
        program = self.helper.main_program
        outs = []
        for inner_name in self._step_outputs:
            inner = self._sub_block.vars.get(inner_name)
            shape = ((inner.shape[0], -1) + tuple(inner.shape[1:])
                     if inner is not None and inner.shape else ())
            out = self._parent_block.create_var(
                name=f"{self.helper.name}.out_{len(outs)}",
                shape=shape, dtype=inner.dtype if inner else "float32")
            out.lod_level = 1
            outs.append(out)
        self._outputs = outs
        externals = [n for n in ir.external_reads(program, self._sub_block.idx)
                     if self._parent_block._find_var_recursive(n) is not None]
        init_names = [m[2] for m in self._memories]
        x_names = [outer for outer, _ in self._step_inputs]
        all_ins = list(dict.fromkeys(x_names + init_names
                                     + self._static_inputs + externals))
        inputs = {"X": all_ins}
        from ..core.ir import seqlen_var_name
        seq_name = seqlen_var_name(self._seq_var.name)
        if self._seq_var.lod_level > 0:
            blk = self._seq_var.block
            if seq_name not in blk.vars:
                blk.create_var(name=seq_name, shape=(-1,), dtype="int32",
                               stop_gradient=True)
            inputs["SeqLen"] = [seq_name]
        self._parent_block.append_op(
            "dynamic_rnn",
            inputs=inputs,
            outputs={"Out": [o.name for o in outs],
                     "OutLen": [seqlen_var_name(o.name) for o in outs]},
            attrs={"sub_block": self._sub_block.idx,
                   "step_inputs": [list(p) for p in self._step_inputs],
                   "memories": [list(m) for m in self._memories],
                   "step_outputs": list(self._step_outputs)})
        for o in outs:
            if seqlen_var_name(o.name) not in self._parent_block.vars:
                self._parent_block.create_var(
                    name=seqlen_var_name(o.name), shape=(-1,), dtype="int32",
                    stop_gradient=True)

    def __call__(self):
        if self.status != DynamicRNN.AFTER_RNN:
            raise ValueError("DynamicRNN outputs are available after block()")
        if len(self._outputs) == 1:
            return self._outputs[0]
        return self._outputs


class IfElse:
    """Per-row two-way branch (reference control_flow.py:1408).

    ie = IfElse(cond)           # cond: [B,1] bool
    with ie.true_block():
        x_t = ie.input(x)
        ie.output(f(x_t))
    with ie.false_block():
        ie.output(g(ie.input(x)))
    out, = ie()

    Reference splits the batch by mask, runs each branch on its slice, and
    merges; here both branches run on the full batch and rows are selected
    with `where` (op `if_else`, ops/control.py) — SPMD-friendly, no dynamic
    shapes, same results for the row-local compute the API supports.
    """

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self._blocks = {}        # "true"/"false" -> sub_block
        self._outs = {"true": [], "false": []}
        self._inputs = []
        self._current = None

    @contextlib.contextmanager
    def true_block(self):
        yield from self._branch("true")

    @contextlib.contextmanager
    def false_block(self):
        yield from self._branch("false")

    def _branch(self, which):
        program = self.helper.main_program
        self._parent_block = program.current_block()
        sub = program._create_block()
        self._blocks[which] = sub
        self._current = which
        yield
        program._rollback()
        self._current = None

    def input(self, x):
        if self._current is None:
            raise ValueError("input() must be called inside a branch block")
        if x.name not in self._inputs:
            self._inputs.append(x.name)
        return x

    def output(self, *outs):
        if self._current is None:
            raise ValueError("output() must be called inside a branch block")
        self._outs[self._current].extend(o.name for o in outs)

    def __call__(self):
        if "true" not in self._blocks or "false" not in self._blocks:
            raise ValueError("IfElse needs both true_block and false_block")
        nt, nf = len(self._outs["true"]), len(self._outs["false"])
        if nt != nf:
            raise ValueError(
                f"true_block produced {nt} outputs, false_block {nf}; they "
                f"must match")
        program = self.helper.main_program
        parent = program.current_block()
        externals = []
        for which in ("true", "false"):
            for n in ir.external_reads(program, self._blocks[which].idx):
                if parent._find_var_recursive(n) is not None \
                        and n not in externals:
                    externals.append(n)
        outs = []
        for tn in self._outs["true"]:
            inner = self._blocks["true"].vars.get(tn)
            out = parent.create_var(
                name=f"{self.helper.name}.out_{len(outs)}",
                shape=tuple(inner.shape) if inner is not None else (),
                dtype=inner.dtype if inner is not None else "float32")
            outs.append(out)
        parent.append_op(
            "if_else",
            inputs={"Cond": [self.cond.name], "X": externals},
            outputs={"Out": [o.name for o in outs]},
            attrs={"true_block": self._blocks["true"].idx,
                   "false_block": self._blocks["false"].idx,
                   "true_outs": list(self._outs["true"]),
                   "false_outs": list(self._outs["false"])})
        return outs


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """Runtime tensor printing (reference control_flow.py:143): the
    `print` op prints on the host each time it runs; first_n and
    print_phase are accepted and not applied, as in the JAX package."""
    helper = LayerHelper("print")
    prefix = (message + " ") if message else ""
    if print_tensor_name:
        prefix += input.name + " "
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("print", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"message": prefix, "summarize": summarize})
    out.lod_level = input.lod_level
    return out


def is_empty(x, cond=None):
    """Whether `x` has zero elements (reference control_flow.py is_empty)."""
    helper = LayerHelper("is_empty")
    out = cond or helper.create_variable_for_type_inference(dtype="bool")
    helper.append_op("is_empty", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]})
    return out


class ParallelDo:
    """Block-level data parallelism (reference parallel_do_op.cc:115,
    control_flow.py ParallelDo), the JAX package's shim.

    The reference split the batch across places and ran the sub-block per
    device on threads; under a `ParallelExecutor` the WHOLE program runs
    over the mesh, so a parallel_do region is its body over the full
    batch, and the executor splits the batch dim and reduces the
    gradients as the reference's merge step did. do() traces the body
    inline; read_input/write_output are identity bookkeeping."""

    def __init__(self, places, use_nccl=False, name=None):
        self.helper = LayerHelper("parallel_do", name=name)
        self._inputs = []

    @contextlib.contextmanager
    def do(self):
        yield

    def read_input(self, var):
        self._inputs.append(var)
        return var

    def write_output(self, var):
        self._out = var

    def __call__(self):
        return self._out
