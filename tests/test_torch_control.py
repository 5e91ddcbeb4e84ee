"""paddle_tpu_torch's control flow against paddle_tpu, on the CPU:
`While` (and `While(max_iters=)`, op `bounded_while`), `StaticRNN`,
`DynamicRNN`, `Switch` / `conditional_block`, `IfElse`, the tensor
arrays and the rank-table family, the smaller ops the layers and the
attention seq2seq need, `models.machine_translation` (training and its
beam decode, through `save_inference_model` / `load_inference_model`)
and `contrib.decoder`.

Each case builds its Program with each package's own layers; the two
Programs, main and startup, are equal as JSON, sub-blocks included (an
int64 var the x32 JAX package declares int32 aside). Both start from the
JAX startup's parameters (`io.state_from_numpy`) and run one step;
outputs and every grad agree to 1e-5 in float32. The JAX side runs as
its own tests run it, on the CPU.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.contrib import decoder as jdecoder
from paddle_tpu.core import lowering as jlowering
from paddle_tpu.layer_helper import LayerHelper as JLayerHelper
from paddle_tpu.models import machine_translation as jmt

import paddle_tpu_torch as ptt
from paddle_tpu_torch.contrib import decoder as tdecoder
from paddle_tpu_torch.core import lowering as tlowering
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.core.backward import append_backward as tappend_backward
from paddle_tpu_torch.core.executor import fetch_var
from paddle_tpu_torch.layer_helper import LayerHelper as TLayerHelper
from paddle_tpu_torch.models import machine_translation as tmt

TOL = 1e-5
AMP_RTOL, AMP_ATOL = 2e-2, 2e-3     # SPECS' AMP tolerances


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small CPU ops run far faster on one thread than on a pool that
    several test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pkg(L):
    return fluid if L is fluid.layers else ptt


def _helper(L, op_type):
    return (JLayerHelper if L is fluid.layers else TLayerHelper)(op_type)


def _op(L, op_type, inputs, outputs=("Out",), attrs=None, dtypes=None):
    """One op appended the way the layers of L's package append it."""
    helper = _helper(L, op_type)
    outs = {s: helper.create_variable_for_type_inference(
        (dtypes or {}).get(s, "float32")) for s in outputs}
    helper.append_op(op_type, inputs=inputs,
                     outputs={s: [v.name] for s, v in outs.items()},
                     attrs=attrs or {})
    return outs


def _head(L, out, name="head_w"):
    """mean(out @ w): a random cotangent."""
    return L.mean(L.fc(out, 1, num_flatten_dims=len(out.shape) - 1,
                       bias_attr=False, param_attr=name))


def _int64_as_port(program_dict, tmain):
    """The JAX package's program dict with the vars the port declares
    int64 declared so: the x32 JAX package declares them int32."""
    for b, tb in zip(program_dict["blocks"], tmain.blocks):
        for v in b["vars"]:
            if (v["dtype"] == "int32" and "@SEQLEN" not in v["name"]
                    and tb.vars[v["name"]].dtype == "int64"):
                v["dtype"] = "int64"
    return program_dict


def _build_case(pkg, build, backward):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss, names = build(pkg.layers)
        grads = []
        if loss is not None and backward is not None:
            backward(loss)
            gb = main.global_block()
            grads = sorted(n for n in gb.vars if n.endswith("@GRAD")
                           and n[:-5] in gb.vars
                           and (gb.vars[n[:-5]].is_data
                                or gb.vars[n[:-5]].persistable))
    return main, startup, names + grads, len(grads)


def _same_programs(main, startup, tmain, tstartup):
    assert tmain.to_dict() == _int64_as_port(main.to_dict(), tmain)
    assert tstartup.to_dict() == startup.to_dict()


def _jax_state(startup):
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(startup, scope=jscope)
    return jscope, jexe


def _numpy_state(jscope):
    return {n: np.asarray(jscope.find_var(n))
            for n in jscope.local_var_names()}


def _run_both(build, feed, backward=True):
    """Build the case with each package's layers, hold the Programs equal,
    start both from the JAX startup's parameters and run one step each:
    (fetch names, JAX fetches, port fetches, number of grads)."""
    main, startup, fetch, n_grads = _build_case(
        fluid, build, fluid.backward.append_backward if backward else None)
    tmain, tstartup, tfetch, _ = _build_case(
        ptt, build, tappend_backward if backward else None)
    _same_programs(main, startup, tmain, tstartup)
    assert tfetch == fetch
    jscope, jexe = _jax_state(startup)
    arrays = _numpy_state(jscope)
    ref = jexe.run(main, feed=feed, fetch_list=fetch, scope=jscope)
    got = ptt.Executor(ptt.CPUPlace()).run(
        tmain, feed=feed, fetch_list=fetch,
        scope=ptt.io.state_from_numpy(arrays, ptt.CPUPlace()))
    return fetch, [np.asarray(r) for r in ref], got, n_grads


def _assert_fetches(fetch, ref, got, tol=TOL):
    for n, a, b in zip(fetch, got, ref):
        assert a.shape == b.shape, n
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=n)
            continue
        assert a.dtype == b.dtype, n
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=n)


def _nonzero_grads(fetch, got, n_grads):
    for n, g in zip(fetch[-n_grads:], got[-n_grads:]):
        assert np.abs(g).max() > 0, f"{n} is all zeros"


# ---------------------------------------------------------------------------
# the loops and branches
# ---------------------------------------------------------------------------

B, D = 3, 4
_RNG = np.random.RandomState(5)
_X = _RNG.randn(B, D).astype(np.float32)
_XS = _RNG.randn(B, 5, D).astype(np.float32)
_LENS = np.array([1, 5, 3], np.int32)


def _while_arrays(L):
    """A counter loop over a tensor array: entry i + 1 = 2 * entry i + x."""
    x = L.data("x", shape=[D])
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 3)
    arr = L.array_write(x, i, capacity=8)
    cond = L.less_than(i, n)
    loop = L.While(cond)
    with loop.block():
        prev = L.array_read(arr, i)
        nxt = L.elementwise_add(L.scale(prev, scale=2.0), x)
        L.increment(i, in_place=True)
        L.array_write(nxt, i, array=arr)
        L.less_than(i, n, cond=cond)
    last = L.array_read(arr, n)
    length = L.array_length(arr)
    return None, [last.name, length.name, i.name, cond.name]


def _bounded_while(L, rewrite_after=False):
    """h <- tanh(h W) three times under While(max_iters=5); the grads
    reach W (read only by the body) and x. With `rewrite_after` the
    parent block writes h again after the loop (a second SSA version
    of the name), and the loss reads both."""
    x = L.data("x", shape=[D])
    h = L.fc(x, D, param_attr="w_in", bias_attr=False)
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 3)
    cond = L.less_than(i, n)
    loop = L.While(cond, max_iters=5)
    with loop.block():
        nh = L.fc(h, D, act="tanh", param_attr="w_loop", bias_attr=False)
        L.assign(nh, h)
        L.increment(i, in_place=True)
        L.less_than(i, n, cond=cond)
    fetch = [h.name, i.name]
    if rewrite_after:
        after = L.scale(h, scale=3.0)
        mid = _head(L, h, "head_mid")
        L.assign(L.elementwise_mul(after, after), h)
        return L.elementwise_add(mid, _head(L, h)), fetch
    return _head(L, h), fetch


def _static_rnn_decode(L):
    """An input-free StaticRNN (num_steps): h <- tanh(h W + b), each step
    an output."""
    x = L.data("x", shape=[D])
    h0 = L.fc(x, 6, param_attr="w_init")
    rnn = L.StaticRNN(num_steps=4)
    with rnn.step():
        h = rnn.memory(init=h0)
        nh = L.fc(h, 6, act="tanh", param_attr="w_rnn")
        rnn.update_memory(h, nh)
        rnn.step_output(nh)
    out = rnn()
    return _head(L, out), [out.name]


def _static_rnn_inputs(L):
    """A StaticRNN over a step input with two memories, one of them
    made from shape and batch_ref."""
    xs = L.data("xs", shape=[5, D])
    h0 = L.fc(L.data("x", shape=[D]), D, param_attr="w_init")
    rnn = L.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(xs)
        h = rnn.memory(init=h0)
        c = rnn.memory(shape=[-1, D], batch_ref=h0)
        nh = L.fc([xt, h], D, act="tanh", param_attr=["w_x", "w_h"])
        nc = L.elementwise_add(c, nh)
        rnn.update_memory(h, nh)
        rnn.update_memory(c, nc)
        rnn.step_output(nh)
        rnn.step_output(nc)
    out, acc = rnn()
    return L.elementwise_add(_head(L, out), _head(L, acc, "head_c")), \
        [out.name, acc.name]


def _dynamic_rnn(L):
    """DynamicRNN over lengths 1, 5, 3 with a static input: memory and
    output masked past each row's length."""
    xs = L.data("xs", shape=[D], lod_level=1)
    s = L.data("s", shape=[D])
    rnn = L.DynamicRNN()
    with rnn.block():
        xt = rnn.step_input(xs)
        st = rnn.static_input(s)
        h = rnn.memory(shape=[D], value=0.5)
        nh = L.fc([xt, h, st], D, act="tanh",
                  param_attr=["w_x", "w_h", "w_s"])
        rnn.update_memory(h, nh)
        rnn.output(nh)
    out = rnn()
    last = L.sequence_pool(out, "last")
    return L.elementwise_add(_head(L, out), _head(L, last, "head_last")), \
        [out.name, out.name + "@SEQLEN", last.name]


def _switch(with_default):
    def build(L):
        step = L.data("step", shape=[1], append_batch_size=False)
        x = L.data("x", shape=[D])
        out = L.scale(x, scale=-1.0)
        two = L.fill_constant([1], "float32", 2.0)
        five = L.fill_constant([1], "float32", 5.0)
        sw = L.Switch()
        with sw.case(L.less_than(step, two)):
            L.assign(L.scale(x, scale=2.0), out)
        with sw.case(L.less_than(step, five)):
            L.assign(L.fc(x, D, param_attr="w_case"), out)
        if with_default:
            with sw.default():
                L.assign(L.elementwise_mul(x, x), out)
        return None, [out.name]
    return build


def _conditional_block_else(L):
    """conditional_block with an else branch, as the op itself takes it."""
    x = L.data("x", shape=[D])
    flag = L.data("flag", shape=[1], append_batch_size=False, dtype="bool")
    pkg = _pkg(L)
    out = L.scale(x, scale=0.0)
    prog = pkg.default_main_program()
    parent = prog.current_block()
    sub = prog._create_block()
    L.assign(L.scale(x, scale=3.0), out)
    prog._rollback()
    other = prog._create_block()
    L.assign(L.exp(x), out)
    prog._rollback()
    parent.append_op("conditional_block",
                     inputs={"Cond": [flag.name], "X": [x.name, out.name]},
                     outputs={"Out": [out.name]},
                     attrs={"sub_block": sub.idx, "out_vars": [out.name],
                            "else_block": other.idx})
    return None, [out.name]


def _if_else(L):
    """IfElse on x's first column: 2x where it is negative, tanh(x W)
    elsewhere, with grads."""
    x = L.data("x", shape=[D])
    col = L.slice(x, axes=[1], starts=[0], ends=[1])
    cond = L.less_than(col, L.fill_constant([1], "float32", 0.0))
    ie = L.IfElse(cond)
    with ie.true_block():
        ie.output(L.scale(ie.input(x), scale=2.0))
    with ie.false_block():
        ie.output(L.fc(ie.input(x), D, act="tanh", param_attr="w_false"))
    out, = ie()
    return _head(L, out), [out.name]


LOOP_CASES = {
    "while-arrays": (_while_arrays, {"x": _X}, False),
    "bounded-while": (_bounded_while, {"x": _X}, True),
    "bounded-while-rewrite-after": (lambda L: _bounded_while(L, True),
                                    {"x": _X}, True),
    "static-rnn-num-steps": (_static_rnn_decode, {"x": _X}, True),
    "static-rnn-step-inputs": (_static_rnn_inputs, {"x": _X, "xs": _XS},
                               True),
    "dynamic-rnn": (_dynamic_rnn, {"xs": (_XS, _LENS), "s": _X}, True),
    "if-else": (_if_else, {"x": _X}, True),
    **{f"switch-{'default' if d else 'no-default'}-step{s}":
       (_switch(d), {"x": _X, "step": np.array([s], np.float32)}, False)
       for d in (False, True) for s in (0.0, 3.0, 7.0)},
    **{f"conditional-block-else-{f}":
       (_conditional_block_else,
        {"x": _X, "flag": np.array([f], bool)}, False)
       for f in (True, False)},
}


@pytest.mark.parametrize("name", sorted(LOOP_CASES))
def test_control_flow_matches_paddle_tpu(name):
    build, feed, backward = LOOP_CASES[name]
    fetch, ref, got, n_grads = _run_both(build, feed, backward)
    _assert_fetches(fetch, ref, got)
    if backward:
        assert n_grads >= 2
        _nonzero_grads(fetch, got, n_grads)


def test_dynamic_rnn_masks_past_each_rows_length():
    fetch, ref, got, _ = _run_both(_dynamic_rnn,
                                   {"xs": (_XS, _LENS), "s": _X})
    out, lens, last = got[:3]
    np.testing.assert_array_equal(lens, _LENS)
    for b, n in enumerate(_LENS):
        assert np.abs(out[b, n:]).max(initial=0) == 0
        assert np.abs(out[b, :n]).min() > 0
        np.testing.assert_array_equal(last[b], out[b, n - 1])


def test_unbounded_while_under_append_backward_raises_the_jax_message():
    def build(pkg):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()), \
                pkg.unique_name.guard():
            loss, _ = _bounded_while(pkg.layers)
            main.global_block().ops[
                [op.type for op in main.global_block().ops].index(
                    "bounded_while")].type = "while"
        return loss

    msgs = []
    for pkg, backward in ((fluid, fluid.backward.append_backward),
                          (ptt, tappend_backward)):
        with pytest.raises(NotImplementedError) as e:
            backward(build(pkg))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "max_iters" in msgs[1]


def test_loop_seeds_differ_by_iteration_and_the_grad_redraws_them():
    """Dropout inside a StaticRNN body: each step draws its own mask, and
    the grad's recompute draws the forward's (x is all ones, so the grad
    of mean(out) is out / out.size)."""
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = 3
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        L = ptt.layers
        xs = L.data("xs", shape=[4, 64], stop_gradient=False)
        rnn = L.StaticRNN()
        with rnn.step():
            rnn.step_output(L.dropout(rnn.step_input(xs), 0.5,
                                      dropout_implementation=
                                      "upscale_in_train"))
        out = rnn()
        loss = L.mean(out)
        tappend_backward(loss)
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    ones = np.ones((2, 4, 64), np.float32)
    o, g = exe.run(main, feed={"xs": ones}, fetch_list=[out, "xs@GRAD"],
                   scope=scope)
    np.testing.assert_allclose(g * o.size, o, rtol=1e-6)
    assert not np.array_equal(o[:, 0], o[:, 1])
    o2, = exe.run(main, feed={"xs": ones}, fetch_list=[out], scope=scope)
    assert not np.array_equal(o, o2)      # the next run draws anew


def test_a_parameter_read_only_by_a_loop_body_is_loaded_from_the_scope():
    """`_StepPlan` counts a sub-block's external reads as reads: with the
    body's parameters taken out of the static_rnn op's X, the step still
    loads them from the scope and the forward runs."""
    main, startup, fetch, _ = _build_case(ptt, _static_rnn_decode, None)
    op = next(o for o in main.global_block().ops if o.type == "static_rnn")
    gb = main.global_block()
    body_params = {n for n in ptt.core.ir.external_reads(main, 1)
                   if gb.vars[n].persistable}
    assert "w_rnn" in body_params and len(body_params) == 2
    op.inputs["X"] = [n for n in op.inputs["X"] if n not in body_params]
    assert not body_params & {n for o in main.global_block().ops
                              for n in o.input_arg_names}
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    plan = ptt.core.executor._StepPlan(main, {"x"}, scope)
    assert body_params <= set(plan.read) and body_params <= plan.live
    out, = exe.run(main, feed={"x": _X}, fetch_list=fetch[:1], scope=scope)
    assert out.shape == (B, 4, 6) and np.isfinite(out).all()


# ---------------------------------------------------------------------------
# tensor arrays, the rank-table family and the smaller ops
# ---------------------------------------------------------------------------

def _rank_case(op):
    def build(L):
        xs = L.data("xs", shape=[D], lod_level=1)
        table = L.lod_rank_table(xs)
        if op == "lod_rank_table":
            return None, [table.name]
        if op == "max_sequence_len":
            return None, [L.max_sequence_len(table).name]
        if op == "lod_tensor_to_array":
            arr = L.lod_tensor_to_array(xs, table)
            i = L.fill_constant([1], "int64", 2)
            return None, [L.array_read(arr, i).name,
                          L.array_length(arr).name]
        if op == "array_to_lod_tensor":
            arr = L.lod_tensor_to_array(xs, table)
            back = L.array_to_lod_tensor(arr, table)
            return _head(L, back), [back.name]
        if op == "shrink_memory":
            h = L.fc(L.sequence_pool(xs, "sum"), D)
            i = L.fill_constant([1], "int64", 2)
            out = L.shrink_memory(h, i, table)
            return _head(L, out), [out.name]
        if op == "reorder_lod_tensor_by_rank":
            h = L.fc(L.sequence_pool(xs, "sum"), D)
            out = L.reorder_lod_tensor_by_rank(h, table)
            return _head(L, out), [out.name]
        raise KeyError(op)
    return build


def _small_case(op):
    def build(L):
        x = L.data("x", shape=[D])
        if op == "fill_constant_batch_size_like":
            out = L.fill_constant_batch_size_like(x, [-1, 2, 3], "float32",
                                                  1.5)
            return None, [out.name]
        if op == "assign_value":
            out = L.assign(np.arange(6, dtype=np.float32).reshape(2, 3))
            return None, [out.name]
        if op == "squeeze":
            out = L.squeeze(L.fc(x, 1), axes=[1])
            return _head(L, L.unsqueeze(out, axes=[1])), [out.name]
        if op == "unsqueeze":
            out = L.unsqueeze(x, axes=[0, 2])
            return _head(L, L.squeeze(out, axes=[0])), [out.name]
        if op == "slice":
            out = L.slice(L.data("xs", shape=[5, D]), axes=[1, 2],
                          starts=[1, -3], ends=[100, -1])
            return _head(L, out), [out.name]
        if op == "batch_gather":
            xs = L.data("xs", shape=[5, D])
            idx = L.data("idx", shape=[3], dtype="int32")
            out = _op(L, "batch_gather", {"X": [xs.name],
                                          "Index": [idx.name]})["Out"]
            return _head(L, out), [out.name]
        if op == "is_empty":
            return None, [L.is_empty(x).name]
        if op == "print":
            out = L.Print(L.scale(x, scale=2.0), message="control")
            return _head(L, out), [out.name]
        if op == "log_softmax":
            out = _op(L, "log_softmax", {"X": [x.name]},
                      attrs={"axis": -1})["Out"]
            return _head(L, out), [out.name]
        if op in ("tanh", "floor", "ceil"):
            out = getattr(L, op)(L.scale(x, scale=2.5))
            return _head(L, out), [out.name]
        if op == "split":
            a, b = L.split(L.fc(x, 6), 2, dim=1)
            c, d, e = L.split(L.data("xs", shape=[6, D]), 3, dim=1)
            return L.elementwise_add(_head(L, b), _head(L, d, "head_d")), \
                [a.name, b.name, c.name, e.name]
        if op == "nets.glu":
            out = _pkg(L).nets.glu(L.fc(x, 6), dim=1)
            return _head(L, out), [out.name]
        if op == "equal":
            return None, [L.equal(x, L.data("y", shape=[D])).name]
        if op in ("not_equal", "less_equal", "greater_than"):
            y = L.data("y", shape=[D])
            return None, [_op(L, op, {"X": [x.name], "Y": [y.name]},
                              dtypes={"Out": "bool"})["Out"].name]
        if op.startswith("logical_"):
            a = L.less_than(x, L.fill_constant([1], "float32", 0.0))
            bb = L.less_than(L.data("y", shape=[D]),
                             L.fill_constant([1], "float32", 0.5))
            ins = ({"X": [a.name]} if op == "logical_not"
                   else {"X": [a.name], "Y": [bb.name]})
            return None, [_op(L, op, ins, dtypes={"Out": "bool"})[
                "Out"].name]
        raise KeyError(op)
    return build


_Y = np.round(_X * 2) / 2
_Y[0] = _X[0]                     # equal in the first row
SMALL_FEED = {"x": _X, "y": _Y, "xs": _RNG.randn(B, 6, D).astype(np.float32),
              "idx": np.array([[4, 0, 0], [1, 2, 3], [3, 3, 1]], np.int32)}
RANK_OPS = ["lod_rank_table", "max_sequence_len", "lod_tensor_to_array",
            "array_to_lod_tensor", "shrink_memory",
            "reorder_lod_tensor_by_rank"]
SMALL_OPS = ["fill_constant_batch_size_like", "assign_value", "squeeze",
             "unsqueeze", "slice", "batch_gather", "is_empty", "print",
             "log_softmax", "tanh", "floor", "ceil", "split", "nets.glu",
             "equal",
             "not_equal", "less_equal", "greater_than", "logical_and",
             "logical_or", "logical_xor", "logical_not"]


def _feed_for(build):
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()), \
            fluid.unique_name.guard():
        build(fluid.layers)
    names = {v.name for v in main.global_block().vars.values() if v.is_data}
    feed = {n: SMALL_FEED[n] for n in names if n in SMALL_FEED}
    if "xs" in names and main.global_block().vars["xs"].lod_level:
        feed["xs"] = (_XS, _LENS)
    return feed


@pytest.mark.parametrize("op", RANK_OPS + SMALL_OPS)
def test_op_matches_paddle_tpu(op):
    build = _rank_case(op) if op in RANK_OPS else _small_case(op)
    fetch, ref, got, n_grads = _run_both(build, _feed_for(build))
    _assert_fetches(fetch, ref, got)
    if n_grads:
        _nonzero_grads(fetch, got, 1)


def test_split_by_sections_matches_paddle_tpu():
    """`split` by `sections` (the JAX rule infers no shape for it at
    build time, so the rules are held here on the same input)."""
    from paddle_tpu.core import registry as jregistry
    x = _RNG.randn(3, 7, 2).astype(np.float32)
    attrs = {"sections": [2, 4, 1], "axis": 1}
    ref = jregistry.get_op_def("split").lower(
        fluid.core.registry.LoweringContext(attrs), x)["Out"]
    got = tregistry.get_op_def("split").lower(
        tregistry.LoweringContext(attrs, "cpu"), torch.from_numpy(x))["Out"]
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_array_write_past_its_capacity_keeps_the_buffer_and_counts():
    def build(L):
        x = L.data("x", shape=[D])
        arr = L.array_write(x, L.fill_constant([1], "int64", 1), capacity=2)
        L.array_write(L.scale(x, scale=2.0), L.fill_constant(
            [1], "int64", 5), array=arr)
        return None, [arr.name, L.array_length(arr).name]
    fetch, ref, got, _ = _run_both(build, {"x": _X}, False)
    _assert_fetches(fetch, ref, got)
    assert got[1] == 6
    np.testing.assert_array_equal(got[0][1], _X)


CONTROL_OPS = {"while", "bounded_while", "static_rnn", "dynamic_rnn",
               "conditional_block", "if_else", "select_input",
               "array_write", "array_read", "array_length",
               "lod_rank_table", "max_sequence_len", "lod_tensor_to_array",
               "array_to_lod_tensor", "shrink_memory",
               "reorder_lod_tensor_by_rank", "tile_beam",
               "beam_search_step", "beam_backtrack"}


def test_every_control_op_is_registered_with_the_jax_flags():
    from paddle_tpu.core import registry as jregistry
    ops = set(tregistry.registered_ops())
    small = set(SMALL_OPS) - {"nets.glu"}
    assert CONTROL_OPS | small <= ops
    assert ops <= set(jregistry.registered_ops())
    for op in CONTROL_OPS | small:
        assert tregistry.get_op_def(op).propagate_seqlen \
            == jregistry.get_op_def(op).propagate_seqlen, op


def test_select_input_picks_the_masked_branch_without_a_host_read():
    xs = [torch.full((2, 3), float(k)) for k in range(3)]
    ctx = tregistry.LoweringContext({}, "cpu")
    rule = tregistry.get_op_def("select_input").lower
    for k, want in ((0, 0.0), (2, 2.0), (7, 2.0)):
        out = rule(ctx, xs, torch.tensor([k], dtype=torch.int32))["Out"]
        assert out.shape == (2, 3) and float(out[0, 0]) == want


# ---------------------------------------------------------------------------
# machine_translation: training, the beam decode and its saved model
# ---------------------------------------------------------------------------

MT = dict(dict_size=32, emb_dim=16, hidden_dim=16)
MT_BATCH, MT_SRC, MT_TRG = 4, 6, 5


def _mt_train(pkg, mod, optimize=True):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, fetches = mod.build(**MT)
        if optimize:
            pkg.optimizer.Adam(learning_rate=1e-3).minimize(fetches["loss"])
        else:
            (fluid.backward.append_backward if pkg is fluid
             else tappend_backward)(fetches["loss"])
    return main, startup, fetches["loss"].name


def _mt_infer(pkg, mod, beam_size=4, max_len=8):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, fetches = mod.build_infer(beam_size=beam_size, max_len=max_len,
                                     **MT)
    return main, startup, fetches


def _mt_feeds(n, seed=17):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = rng.randint(1, MT_SRC + 1, MT_BATCH).astype(np.int32)
        lens[:2] = (1, MT_SRC)
        out.append({
            "src_word": (rng.randint(2, MT["dict_size"],
                                     (MT_BATCH, MT_SRC, 1)).astype(np.int64),
                         lens),
            "trg_word": rng.randint(0, MT["dict_size"],
                                    (MT_BATCH, MT_TRG, 1)).astype(np.int64),
            "lbl_word": rng.randint(0, MT["dict_size"],
                                    (MT_BATCH, MT_TRG, 1)).astype(np.int64)})
    return out


def test_mt_programs_are_the_same_in_both_packages():
    for build in (_mt_train, _mt_infer):
        jmain, jstartup, _ = build(fluid, jmt)
        tmain, tstartup, _ = build(ptt, tmt)
        _same_programs(jmain, jstartup, tmain, tstartup)
        assert len(tmain.blocks) == 2


def test_mt_grads_reach_every_parameter_through_the_static_rnn():
    jmain, jstartup, loss = _mt_train(fluid, jmt, optimize=False)
    tmain = _mt_train(ptt, tmt, optimize=False)[0]
    params = sorted(p.name for p in jmain.global_block().all_parameters())
    fetch = [loss] + [p + "@GRAD" for p in params]
    jscope, jexe = _jax_state(jstartup)
    feed = _mt_feeds(1)[0]
    ref = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
    got = ptt.Executor(ptt.CPUPlace()).run(
        tmain, feed=feed, fetch_list=fetch,
        scope=ptt.io.state_from_numpy(_numpy_state(jscope), ptt.CPUPlace()))
    assert {"dec_gru_w", "dec_gate_proj", "dec_out_w", "trg_emb"} \
        <= set(params)
    _assert_fetches(fetch, [np.asarray(r) for r in ref], got)
    _nonzero_grads(fetch, got, len(params))


@pytest.fixture(scope="module")
def mt_trained():
    """3 Adam steps of each package from the JAX startup's state: (JAX
    scope, port scope, JAX losses, port losses)."""
    jmain, jstartup, loss = _mt_train(fluid, jmt)
    tmain = _mt_train(ptt, tmt)[0]
    jscope, jexe = _jax_state(jstartup)
    tscope = ptt.io.state_from_numpy(_numpy_state(jscope), ptt.CPUPlace())
    texe = ptt.Executor(ptt.CPUPlace())
    jl, tl = [], []
    for feed in _mt_feeds(1) * 3:
        jl.append(np.asarray(jexe.run(jmain, feed=feed, fetch_list=[loss],
                                      scope=jscope)[0]))
        tl.append(texe.run(tmain, feed=feed, fetch_list=[loss],
                           scope=tscope)[0])
    return jscope, tscope, jl, tl


def test_mt_trains_like_paddle_tpu(mt_trained):
    jscope, tscope, jl, tl = mt_trained
    np.testing.assert_allclose(np.ravel(tl), np.ravel(jl), rtol=TOL)
    assert tl[-1][0] < tl[0][0]
    names = list(jscope.local_var_names())
    assert len(names) > 20
    for n in names:
        np.testing.assert_allclose(fetch_var(n, tscope),
                                   np.asarray(jscope.find_var(n)),
                                   atol=TOL, rtol=0, err_msg=n)


def _beam_feed():
    rng = np.random.RandomState(23)
    lens = np.array([1, 6, 4, 2], np.int32)
    return {"src_word": (rng.randint(2, MT["dict_size"], (4, MT_SRC, 1))
                         .astype(np.int64), lens)}


def test_mt_beam_decode_matches_paddle_tpu(mt_trained, tmp_path):
    """build_infer (beam 4, max_len 8) on the trained parameters: ids
    equal, scores to 1e-5; then the port's program through
    save_inference_model / load_inference_model into a fresh scope
    decodes the same."""
    jscope, tscope, _, _ = mt_trained
    jmain, jstartup, jf = _mt_infer(fluid, jmt)
    tmain, tstartup, tf = _mt_infer(ptt, tmt)
    _same_programs(jmain, jstartup, tmain, tstartup)
    feed = _beam_feed()
    fetch = [jf["ids"].name, jf["scores"].name]
    ids, scores = fluid.Executor(fluid.CPUPlace()).run(
        jmain, feed=feed, fetch_list=fetch, scope=jscope)
    texe = ptt.Executor(ptt.CPUPlace())
    tids, tscores = texe.run(tmain, feed=feed, fetch_list=fetch,
                             scope=tscope)
    assert tids.shape == (4, 4, 8) and tscores.shape == (4, 4)
    np.testing.assert_array_equal(tids, np.asarray(ids))
    np.testing.assert_allclose(tscores, np.asarray(scores), rtol=TOL,
                               atol=TOL)
    assert (np.diff(tscores, axis=1) <= 1e-5).all()

    d = str(tmp_path / "mt_beam")
    ptt.io.save_inference_model(d, ["src_word"], [tf["ids"], tf["scores"]],
                                texe, main_program=tmain, scope=tscope)
    scope2 = ptt.Scope()
    prog, feed_names, fetch_vars = ptt.io.load_inference_model(
        d, texe, scope=scope2)
    assert feed_names == ["src_word"] and len(prog.blocks) == 2
    assert prog.blocks[1].to_dict() == tmain.blocks[1].to_dict()
    lids, lscores = texe.run(prog, feed=feed, fetch_list=fetch_vars,
                             scope=scope2)
    np.testing.assert_array_equal(lids, tids)
    np.testing.assert_array_equal(lscores, tscores)


def test_beam_backtrack_and_step_rules_match_paddle_tpu():
    """The beam rules alone on hand-made histories with finished beams:
    bit-equal ids and parents, scores to 1e-6."""
    rng = np.random.RandomState(3)
    Bq, K, V, T = 2, 3, 7, 5
    logp = np.log(rng.dirichlet(np.ones(V), (Bq, K))).astype(np.float32)
    acc = rng.randn(Bq, K).astype(np.float32)
    fin = np.array([[True, False, False], [False, False, True]])
    hist_ids = rng.randint(0, V, (Bq, T, K)).astype(np.int32)
    hist_par = rng.randint(0, K, (Bq, T, K)).astype(np.int32)
    attrs = {"beam_size": K, "end_id": 1}
    jctx = fluid.core.registry.LoweringContext(attrs)
    tctx = tregistry.LoweringContext(attrs, "cpu")
    from paddle_tpu.core import registry as jregistry
    import jax.numpy as jnp
    for op, ins in (("beam_search_step", dict(LogProbs=logp, AccScores=acc,
                                              Finished=fin)),
                    ("beam_backtrack", dict(Ids=hist_ids, Parents=hist_par,
                                            AccScores=acc))):
        ref = jregistry.get_op_def(op).lower(
            jctx, **{k: jnp.asarray(v) for k, v in ins.items()})
        got = tregistry.get_op_def(op).lower(
            tctx, **{k: torch.from_numpy(v) for k, v in ins.items()})
        assert set(ref) == set(got)
        for slot in ref:
            a, b = got[slot].numpy(), np.asarray(ref[slot])
            assert a.dtype == b.dtype, slot
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=slot)


# ---------------------------------------------------------------------------
# contrib.decoder
# ---------------------------------------------------------------------------

CV, CE, CH, CK = 30, 16, 24, 3


def _cd_encoder(L, src):
    emb = L.embedding(src, size=[CV, CE])
    proj = L.fc(input=emb, size=CH * 4, num_flatten_dims=2, bias_attr=False)
    enc, _ = L.dynamic_lstm(input=proj, size=CH * 4)
    return L.sequence_pool(enc, pool_type="last")


def _cd_cell(L, dec, enc_last):
    cell = dec.StateCell(inputs={"x": None},
                         states={"h": dec.InitState(init=enc_last)},
                         out_state="h")

    @cell.state_updater
    def updater(state_cell):
        x = state_cell.get_input("x")
        h = state_cell.get_state("h")
        state_cell.set_state("h", L.fc(input=L.concat([x, h], axis=1),
                                       size=CH, act="tanh"))

    return cell


def _cd_train(pkg, dec):
    main, startup = pkg.Program(), pkg.Program()
    L = pkg.layers
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        src = L.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = L.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = L.data(name="lbl", shape=[1], dtype="int64", lod_level=1)
        cell = _cd_cell(L, dec, _cd_encoder(L, src))
        trg_emb = L.embedding(trg, size=[CV, CE])
        decoder = dec.TrainingDecoder(cell)
        with decoder.block():
            cur = decoder.step_input(trg_emb)
            decoder.state_cell.compute_state(inputs={"x": cur})
            out = L.fc(input=decoder.state_cell.get_state("h"), size=CV,
                       act="softmax")
            decoder.state_cell.update_states()
            decoder.output(out)
        loss = L.mean(L.cross_entropy(input=decoder(), label=lbl))
        pkg.optimizer.Adam(5e-3).minimize(loss)
    return main, startup, loss.name


def _cd_infer(pkg, dec, max_len=5):
    main, startup = pkg.Program(), pkg.Program()
    L = pkg.layers
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        src = L.data(name="src", shape=[1], dtype="int64", lod_level=1)
        enc_last = _cd_encoder(L, src)
        init_ids = L.fill_constant_batch_size_like(enc_last, [-1, 1],
                                                   "int64", 0.0)
        init_scores = L.fill_constant_batch_size_like(enc_last, [-1, 1],
                                                      "float32", 0.0)
        decoder = dec.BeamSearchDecoder(
            state_cell=_cd_cell(L, dec, enc_last), init_ids=init_ids,
            init_scores=init_scores, target_dict_dim=CV, word_dim=CE,
            sparse_emb=False, max_len=max_len, beam_size=CK, end_id=1)
        decoder.decode()
        ids, scores = decoder()
    return main, startup, [ids.name, scores.name]


def test_contrib_decoders_match_paddle_tpu():
    """TrainingDecoder: the Programs and 3 Adam steps from the JAX
    state; BeamSearchDecoder: the Programs and a decode on the trained
    parameters, ids equal and scores to 1e-5."""
    jmain, jstartup, loss = _cd_train(fluid, jdecoder)
    tmain, tstartup, _ = _cd_train(ptt, tdecoder)
    _same_programs(jmain, jstartup, tmain, tstartup)
    jscope, jexe = _jax_state(jstartup)
    tscope = ptt.io.state_from_numpy(_numpy_state(jscope), ptt.CPUPlace())
    texe = ptt.Executor(ptt.CPUPlace())
    rng = np.random.RandomState(0)
    for _ in range(3):
        lens = rng.randint(3, 7, (8,)).astype(np.int32)
        src = rng.randint(2, CV, (8, 6, 1)).astype(np.int64)
        trg = rng.randint(2, CV, (8, 4, 1)).astype(np.int64)
        tl = np.array([4, 1, 3, 4, 2, 4, 4, 3], np.int32)
        feed = {"src": (src, lens), "trg": (trg, tl), "lbl": (trg, tl)}
        ref, = jexe.run(jmain, feed=feed, fetch_list=[loss], scope=jscope)
        got, = texe.run(tmain, feed=feed, fetch_list=[loss], scope=tscope)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=TOL)

    jimain, jistartup, fetch = _cd_infer(fluid, jdecoder)
    timain, tistartup, tfetch = _cd_infer(ptt, tdecoder)
    _same_programs(jimain, jistartup, timain, tistartup)
    assert tfetch == fetch
    feed = {"src": (rng.randint(2, CV, (4, 6, 1)).astype(np.int64),
                    np.array([6, 1, 3, 5], np.int32))}
    ids, scores = jexe.run(jimain, feed=feed, fetch_list=fetch, scope=jscope)
    tids, tscores = texe.run(timain, feed=feed, fetch_list=fetch,
                             scope=tscope)
    assert tids.shape == (4, CK, 5)
    np.testing.assert_array_equal(tids, np.asarray(ids))
    np.testing.assert_allclose(tscores, np.asarray(scores), rtol=TOL,
                               atol=TOL)


# ---------------------------------------------------------------------------
# bf16 mixed precision through a loop body
# ---------------------------------------------------------------------------

def _gru_rnn(L):
    """A StaticRNN with an fc and a gru_unit body (the MT decoder's
    cell) over a step input."""
    xs = L.data("xs", shape=[5, D])
    # a float32 carry, as the MT decoder's: gru_unit returns float32
    h0 = L.cast(L.fc(L.data("x", shape=[D]), 6, param_attr="w_init"),
                "float32")
    rnn = L.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(xs)
        h = rnn.memory(init=h0)
        gate = L.fc(L.concat([xt, h], axis=1), 18, bias_attr=False,
                    param_attr="w_gate")
        nh, _, _ = L.gru_unit(gate, h, 18, param_attr="w_gru")
        rnn.update_memory(h, nh)
        rnn.step_output(nh)
    out = rnn()
    return _head(L, out), [out.name]


def test_static_rnn_gru_body_under_amp_matches_paddle_tpu():
    """One AMP step each: every var either package writes, inside the
    loop body too, has the JAX dtype, and the fetches (outputs and
    grads) lie within SPECS' AMP tolerances."""
    main, startup, fetch, n_grads = _build_case(
        fluid, _gru_rnn, fluid.backward.append_backward)
    tmain, tstartup, _, _ = _build_case(ptt, _gru_rnn, tappend_backward)
    _same_programs(main, startup, tmain, tstartup)
    feed = {"x": _X, "xs": _XS}
    jseen, tseen = {}, {}
    jrun = jlowering.BlockLowerer._run_op
    trun, tgrad = tlowering._run_op, tlowering._run_grad_op

    def jspy(self, block, op, op_idx, env, key):
        jrun(self, block, op, op_idx, env, key)
        for n in op.output_arg_names:
            if hasattr(env.get(n), "dtype"):
                jseen[n] = str(env[n].dtype)

    def record(op, env):
        for n in op.output_arg_names:
            if isinstance(env.get(n), torch.Tensor):
                tseen[n] = str(env[n].dtype).replace("torch.", "")

    def tspy(op, op_idx, env, *a, **kw):
        trun(op, op_idx, env, *a, **kw)
        record(op, env)

    def tgspy(op, env, *a, **kw):
        tgrad(op, env, *a, **kw)
        record(op, env)

    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace(), amp=True)
    jexe.run(startup, scope=jscope)
    tscope = ptt.io.state_from_numpy(_numpy_state(jscope), ptt.CPUPlace())
    jlowering.BlockLowerer._run_op = jspy
    tlowering._run_op, tlowering._run_grad_op = tspy, tgspy
    try:
        ref = jexe.run(main, feed=feed, fetch_list=fetch, scope=jscope)
        got = ptt.Executor(ptt.CPUPlace(), amp=True).run(
            tmain, feed=feed, fetch_list=fetch, scope=tscope)
    finally:
        jlowering.BlockLowerer._run_op = jrun
        tlowering._run_op, tlowering._run_grad_op = trun, tgrad
    inner = {n for op in tmain.blocks[1].ops for n in op.output_arg_names}
    assert inner <= set(tseen) and inner <= set(jseen)
    assert set(jseen) == set(tseen)
    differ = {n: (jseen[n], tseen[n]) for n in jseen if jseen[n] != tseen[n]}
    assert not differ, differ
    assert "bfloat16" in {tseen[n] for n in inner}
    for n, a, b in zip(fetch, got, ref):
        np.testing.assert_allclose(a, np.asarray(b, np.float32),
                                   rtol=AMP_RTOL, atol=AMP_ATOL, err_msg=n)
