"""paddle_tpu_torch's variable-length slice against paddle_tpu, on the CPU:
`lod_level` feeds and `@SEQLEN` propagation, the sequence and recurrent
op rules, `nets.sequence_conv_pool` and the stacked dynamic LSTM.

Each op case builds a small program with each package's own layers (a
`lod_level` input fed as a `(padded, lengths)` pair, or nested as
`(padded, (outer counts, inner lengths))`) and appends its backward; the
two Programs, main and startup, are equal as JSON, companions and
aliases included (an int64 output the x32 JAX package declares int32
aside). Both start from the JAX startup's parameters
(`io.state_from_numpy`) and run one step; outputs, length companions and
every grad agree to 1e-5 in float32. The lengths include 1 and the
padded T.

Under AMP (`lstm` and `gru` are in the bf16 set) the recurrent rules'
outputs equal the JAX rules' bit for bit, both the rule called op by op
(`jax.disable_jit`) and the jitted one (on the host XLA keeps no step
intermediate of these scans in float32), and so do their grads but for
one sum: a Bias grad adds per-element terms, themselves bit-equal, over
the batch (and the time steps), which XLA adds one bf16 add at a time
where torch adds in float32 and rounds once (ROADMAP Queue 3, expected
differences). So each Bias grad is held, bit for bit, to torch's sum of
the JAX rule's own terms. Three AMP steps of the stacked LSTM are held
the same way against the JAX package's AMP step run op by op. All this
at these sizes: wider, the host's bf16 GEMMs (float32 sums in oneDNN's
order against XLA's) round an element of a recurrent product the other
way now and then, and the recurrence carries it on (ROADMAP).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import executor as jexecutor
from paddle_tpu.core import registry as jregistry
from paddle_tpu.layer_helper import LayerHelper as JLayerHelper
from paddle_tpu.models import stacked_dynamic_lstm as jlstm_model

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.core.backward import append_backward as tappend_backward
from paddle_tpu_torch.core.executor import fetch_var
from paddle_tpu_torch.layer_helper import LayerHelper as TLayerHelper
from paddle_tpu_torch.models import stacked_dynamic_lstm as tlstm_model
from paddle_tpu_torch.ops.rnn import _reverse_padded

TOL = 1e-5
AMP_LOSS_RTOL = 5e-3     # the port against the jitted JAX AMP step
ADAM_RTOL = 1e-6         # float32 Adam: an ulp here and there


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small CPU ops run far faster on one thread than on a pool that
    several test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the registry flag
# ---------------------------------------------------------------------------

def test_propagate_seqlen_flag_is_the_jax_packages_for_every_op():
    ops = tregistry.registered_ops()
    assert set(ops) <= set(jregistry.registered_ops())
    differ = {op: tregistry.get_op_def(op).propagate_seqlen for op in ops
              if tregistry.get_op_def(op).propagate_seqlen
              != jregistry.get_op_def(op).propagate_seqlen}
    assert not differ, differ
    assert not tregistry.get_op_def("sequence_pool").propagate_seqlen
    assert tregistry.get_op_def("lstm").propagate_seqlen


# ---------------------------------------------------------------------------
# op rules and their grads against paddle_tpu
# ---------------------------------------------------------------------------

B, T, D = 4, 6, 4
LENS = np.array([1, 6, 3, 5], np.int32)
NB, NS, NT = 2, 3, 5                      # nested: docs, sentences, tokens
OUTER = np.array([3, 3], np.int32)
INNER = np.array([[2, 5, 1], [4, 1, 3]], np.int32)
INNER0 = np.array([[2, 5, 0], [4, 1, 0]], np.int32)   # a doc of 2

_RNG = np.random.RandomState(31)
_X = _RNG.randn(B, T, D).astype(np.float32)
_Y = _RNG.randn(B, T + 2, D).astype(np.float32)
_XN = _RNG.randn(NB, NS, NT, D).astype(np.float32)
_TIES = (np.floor(_RNG.randn(B, T, D) * 1.5) / 2).astype(np.float32)
_IDS = _RNG.randint(0, 4, (B, T, 1)).astype(np.int64)
_IDSN = _RNG.randint(0, 4, (NB, NS, NT, 1)).astype(np.int64)
_G = _RNG.randn(B, T, 4 * D).astype(np.float32)       # LSTM x-projections


def _seq(L, name="x", width=D, lod_level=1, dtype="float32",
         stop_gradient=False):
    return L.data(name, shape=[width], dtype=dtype, lod_level=lod_level,
                  stop_gradient=stop_gradient)


def _dense(L, name, shape, dtype="float32", stop_gradient=False):
    """A dense input with a -1 batch dim before `shape`."""
    return L.data(name, shape=list(shape), dtype=dtype,
                  stop_gradient=stop_gradient)


def _head(L, out, name="head_w"):
    """mean(out @ w): a random cotangent."""
    return L.mean(L.fc(out, 1, num_flatten_dims=len(out.shape) - 1,
                       bias_attr=False, param_attr=name))


def _helper(L, op_type):
    """The LayerHelper of the package whose layers L are."""
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


def _pool(ptype, nested=False, ties=False):
    def build(L):
        x = _seq(L, lod_level=2 if nested else 1)
        out = L.sequence_pool(x, ptype)
        return _head(L, out), [out.name]
    feed = {"x": (_XN, (OUTER, INNER)) if nested
            else (_TIES if ties else _X, LENS)}
    return build, feed


def _softmax(nested=False):
    def build(L):
        x = _seq(L, lod_level=2 if nested else 1)
        out = L.sequence_softmax(L.scale(x, 3.0))
        return _head(L, out), [out.name, out.name + "@SEQLEN"]
    return build, {"x": (_XN, (OUTER, INNER0)) if nested else (_X, LENS)}


def _expand(nested=False):
    def build(L):
        if nested:
            x = _dense(L, "xd", (NS, D))
            y = _seq(L, "y", lod_level=2, stop_gradient=True)
        else:
            x = _dense(L, "xd", (D,))
            y = _seq(L, "y", stop_gradient=True)
        out = L.sequence_expand(x, y)
        return _head(L, out), [out.name, out.name + "@SEQLEN"]
    rng = np.random.RandomState(32)
    if nested:
        return build, {"xd": rng.randn(NB, NS, D).astype(np.float32),
                       "y": (_XN, (OUTER, INNER))}
    return build, {"xd": rng.randn(B, D).astype(np.float32), "y": (_X, LENS)}


def _reshape(nested=False):
    def build(L):
        x = _seq(L, lod_level=2 if nested else 1)
        out = L.sequence_reshape(x, 2)
        comp = out.name + ("@SEQLEN.1" if nested else "@SEQLEN")
        return _head(L, out), [out.name, comp]
    return build, {"x": (_XN, (OUTER, INNER)) if nested else (_X, LENS)}


def _concat(nested=False):
    def build(L):
        lv = 2 if nested else 1
        x, y = _seq(L, lod_level=lv), _seq(L, "y", lod_level=lv)
        out = L.sequence_concat([x, L.scale(y, 2.0)])
        comp = out.name + ("@SEQLEN.1" if nested else "@SEQLEN")
        return _head(L, out), [out.name, comp]
    if nested:
        yn = np.random.RandomState(33).randn(NB, NS, 3, D).astype(np.float32)
        return build, {"x": (_XN, (OUTER, INNER)),
                       "y": (yn, (OUTER, np.array([[3, 0, 2], [1, 3, 3]],
                                                  np.int32)))}
    return build, {"x": (_X, LENS),
                   "y": (_Y, np.array([8, 2, 1, 7], np.int32))}


def _concat_full_rows():
    """A `SeqLen` slot with EMPTY_VAR for an input without lengths: its
    rows count in full. Forward only: neither package's generic grad
    takes an EMPTY_VAR input (no layer makes one)."""
    def build(L):
        x, y = _seq(L), _dense(L, "yd", (3, D))
        empty = (jregistry if L is fluid.layers else tregistry).EMPTY_VAR
        outs = _op(L, "sequence_concat",
                   {"X": [x.name, y.name],
                    "SeqLen": [x.name + "@SEQLEN", empty]},
                   ("Out", "OutLen"), dtypes={"OutLen": "int32"})
        out = outs["Out"]
        return None, [out.name, outs["OutLen"].name]
    return build, {"x": (_X, LENS),
                   "yd": np.random.RandomState(34).randn(B, 3, D).astype(
                       np.float32)}


def _slice(nested=False):
    def build(L):
        x = _seq(L, lod_level=2 if nested else 1)
        shape = (-1,) if nested else (1,)
        off = _dense(L, "off", shape, "int64", True)
        ln = _dense(L, "len", shape, "int64", True)
        out = L.sequence_slice(x, off, ln)
        comp = out.name + ("@SEQLEN.1" if nested else "@SEQLEN")
        return _head(L, out), [out.name, comp]
    if nested:
        return build, {"x": (_XN, (OUTER, INNER)),
                       "off": np.array([[0, 2, 4], [1, -1, 0]], np.int64),
                       "len": np.array([[2, 3, 9], [3, 1, 0]], np.int64)}
    # offsets below 0 and slices past T clamp to the padded bound
    return build, {"x": (_X, LENS),
                   "off": np.array([[0], [2], [-1], [4]], np.int64),
                   "len": np.array([[1], [3], [2], [9]], np.int64)}


def _conv(filter_size=3, nested=False):
    def build(L):
        x = _seq(L, lod_level=2 if nested else 1)
        out = L.sequence_conv(x, num_filters=5, filter_size=filter_size,
                              act="sigmoid")
        return _head(L, out), [out.name, out.name + "@SEQLEN"]
    return build, {"x": (_XN, (OUTER, INNER)) if nested else (_X, LENS)}


def _conv_op(context_length, context_start):
    """contextLength / contextStart that the layer never sets."""
    def build(L):
        x = _seq(L)
        w = _helper(L, "sequence_conv").create_parameter(
            None, [context_length * D, 3], "float32")
        out = _op(L, "sequence_conv",
                  {"X": [x.name], "Filter": [w.name],
                   "SeqLen": [x.name + "@SEQLEN"]},
                  attrs={"contextLength": context_length,
                         "contextStart": context_start})["Out"]
        return _head(L, out), [out.name]
    return build, {"x": (_X, LENS)}


def _erase(nested=False):
    def build(L):
        x = _seq(L, lod_level=2 if nested else 1, width=1, dtype="int64",
                 stop_gradient=True)
        out = L.sequence_erase(x, [0, 2])
        comp = out.name + ("@SEQLEN.1" if nested else "@SEQLEN")
        return None, [out.name, comp]
    return build, {"x": (_IDSN, (OUTER, INNER)) if nested
                   else (_IDS, LENS)}


def _expand_as():
    def build(L):
        x, y = _dense(L, "xd", (D,)), _seq(L, "y", stop_gradient=True)
        out = _op(L, "sequence_expand_as", {"X": [x.name], "Y": [y.name]})
        return _head(L, out["Out"]), [out["Out"].name]
    return build, {"xd": np.random.RandomState(35).randn(B, D).astype(
        np.float32), "y": (_X, LENS)}


def _row_conv():
    def build(L):
        out = L.row_conv(_seq(L), future_context_size=2, act="relu")
        return _head(L, out), [out.name, out.name + "@SEQLEN"]
    return build, {"x": (_X, LENS)}


def _mask():
    def build(L):
        n = _dense(L, "n", (), "int64", True)
        out = L.sequence_mask(n, maxlen=T, dtype="int64")
        return None, [out.name]
    return build, {"n": LENS.astype(np.int64)}


def _lstm(peep, reverse, init=False, acts=None):
    def build(L):
        x = _seq(L, width=4 * D)
        kw = {}
        if init:
            kw = dict(h_0=_dense(L, "h0", (D,)), c_0=_dense(L, "c0", (D,)))
        h, c = L.dynamic_lstm(L.scale(x, 0.5), size=4 * D,
                              use_peepholes=peep, is_reverse=reverse,
                              **(acts or {}), **kw)
        loss = L.elementwise_add(_head(L, h),
                                 _head(L, L.scale(c, 0.3), "head_c"))
        return loss, [h.name, c.name, h.name + "@SEQLEN"]
    rng = np.random.RandomState(36)
    feed = {"x": (_G, LENS)}
    if init:
        feed.update(h0=rng.randn(B, D).astype(np.float32),
                    c0=rng.randn(B, D).astype(np.float32))
    return build, feed


def _gru(reverse, init=False):
    def build(L):
        x = _seq(L, width=3 * D)
        h0 = _dense(L, "h0", (D,)) if init else None
        h = L.dynamic_gru(x, size=D, is_reverse=reverse, h_0=h0)
        return _head(L, h), [h.name]
    rng = np.random.RandomState(37)
    feed = {"x": (_G[..., :3 * D], LENS)}
    if init:
        feed["h0"] = rng.randn(B, D).astype(np.float32)
    return build, feed


def _lstmp(peep, reverse):
    def build(L):
        x = _seq(L, width=4 * D)
        p, c = L.dynamic_lstmp(x, size=4 * D, proj_size=3,
                               use_peepholes=peep, is_reverse=reverse)
        loss = L.elementwise_add(_head(L, p), _head(L, c, "head_c"))
        return loss, [p.name, c.name]
    return build, {"x": (_G, LENS)}


def _units():
    def build(L):
        x = _dense(L, "xu", (D,))
        h_prev, c_prev = _dense(L, "hp", (D,)), _dense(L, "cp", (D,))
        h, c = L.lstm_unit(x, h_prev, c_prev, forget_bias=0.5)
        gx = _dense(L, "gx", (3 * D,))
        gh, reset, gate = L.gru_unit(gx, h, size=3 * D)
        loss = L.elementwise_add(_head(L, c), _head(L, gh, "head_g"))
        return loss, [h.name, c.name, gh.name, reset.name, gate.name]
    rng = np.random.RandomState(38)
    return build, {n: rng.randn(*s).astype(np.float32) for n, s in
                   (("xu", (B, D)), ("hp", (B, D)), ("cp", (B, D)),
                    ("gx", (B, 3 * D)))}


OP_CASES = {
    **{f"pool-{p}": _pool(p) for p in ("average", "sum", "sqrt", "max",
                                       "last", "first")},
    "pool-max-ties": _pool("max", ties=True),
    "pool-average-nested": _pool("average", nested=True),
    "pool-max-nested": _pool("max", nested=True),
    "pool-last-nested": _pool("last", nested=True),
    "softmax": _softmax(), "softmax-nested": _softmax(True),
    "expand": _expand(), "expand-nested": _expand(True),
    "reshape": _reshape(), "reshape-nested": _reshape(True),
    "concat": _concat(), "concat-nested": _concat(True),
    "concat-full-rows": _concat_full_rows(),
    "slice": _slice(), "slice-nested": _slice(True),
    "conv-3": _conv(3), "conv-4": _conv(4), "conv-nested": _conv(3, True),
    "conv-start0-len2": _conv_op(2, 0), "conv-start-2-len3": _conv_op(3, -2),
    "erase": _erase(), "erase-nested": _erase(True),
    "expand_as": _expand_as(), "row_conv": _row_conv(),
    "sequence_mask": _mask(),
    "lstm-peepholes": _lstm(True, False),
    "lstm-peepholes-reverse": _lstm(True, True),
    "lstm-plain-h0-c0": _lstm(False, False, init=True),
    "lstm-reverse-h0-c0-acts": _lstm(
        False, True, init=True,
        acts=dict(gate_activation="sigmoid", cell_activation="relu",
                  candidate_activation="identity")),
    "gru": _gru(False), "gru-reverse-h0": _gru(True, init=True),
    "lstmp-peepholes": _lstmp(True, False),
    "lstmp-reverse": _lstmp(False, True),
    "lstm_unit-gru_unit": _units(),
}


def _build_case(pkg, build, backward):
    """The case's main and startup Programs built with pkg's layers, its
    backward appended when it has a loss; the fetch names (outputs, then
    the grads of every float input that takes one and of every
    parameter) and the number of grads."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss, names = build(pkg.layers)
        grads = []
        if loss is not None:
            backward(loss)
            gb = main.global_block()
            grads = sorted(n for n in gb.vars if n.endswith("@GRAD")
                           and n[:-5] in gb.vars
                           and (gb.vars[n[:-5]].is_data
                                or gb.vars[n[:-5]].persistable))
    return main, startup, names + grads, len(grads)


def _int64_as_port(program_dict, tmain):
    """The JAX package's program dict with the vars the port declares
    int64 (sequence_erase's, sequence_mask's and top_k's index outputs)
    declared so: the x32 JAX package declares them int32. Length
    companions stay int32 in both."""
    tvars = tmain.global_block().vars
    for b in program_dict["blocks"]:
        for v in b["vars"]:
            if (v["dtype"] == "int32" and "@SEQLEN" not in v["name"]
                    and tvars[v["name"]].dtype == "int64"):
                v["dtype"] = "int64"
    return program_dict


def _run_both(build, feed):
    """Build the case with each package's layers, hold the two Programs
    equal, start both from the JAX startup's parameters and run one step
    of each; returns the fetch names, both fetch lists and the number of
    grads."""
    main, startup, fetch, n_grads = _build_case(
        fluid, build, fluid.backward.append_backward)
    tmain, tstartup, tfetch, _ = _build_case(ptt, build, tappend_backward)
    assert tmain.to_dict() == _int64_as_port(main.to_dict(), tmain)
    assert tstartup.to_dict() == startup.to_dict()
    assert tfetch == fetch
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(startup, scope=jscope)
    arrays = {n: np.asarray(jscope.find_var(n))
              for n in jscope.local_var_names()}
    ref = jexe.run(main, feed=feed, fetch_list=fetch, scope=jscope)
    got = ptt.Executor(ptt.CPUPlace()).run(
        tmain, feed=feed, fetch_list=fetch,
        scope=ptt.io.state_from_numpy(arrays, ptt.CPUPlace()))
    return fetch, [np.asarray(r) for r in ref], got, n_grads


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_rule_and_grads_match_paddle_tpu(name):
    build, feed = OP_CASES[name]
    fetch, ref, got, n_grads = _run_both(build, feed)
    if not name.startswith(("erase", "sequence_mask", "concat-full")):
        assert n_grads >= 1
    for n, a, b in zip(fetch, got, ref):
        assert a.shape == b.shape, n
        if a.dtype.kind == "i":
            # int64 in the port, int32 in the x32 JAX package
            np.testing.assert_array_equal(a, b, err_msg=n)
            continue
        assert a.dtype == b.dtype, n
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL, err_msg=n)


SEQ_OPS = {"sequence_pool", "sequence_softmax", "sequence_expand",
           "sequence_reshape", "sequence_concat", "sequence_slice",
           "sequence_conv", "sequence_erase", "sequence_expand_as",
           "row_conv", "sequence_mask", "lstm", "gru", "lstm_unit",
           "gru_unit", "lstmp"}


def test_every_op_of_the_slice_is_registered_and_has_a_case():
    assert SEQ_OPS <= set(tregistry.registered_ops())
    covered = set()
    for build, _ in OP_CASES.values():
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()), \
                fluid.unique_name.guard():
            build(fluid.layers)
        covered |= {op.type for op in main.global_block().ops}
    assert SEQ_OPS <= covered, SEQ_OPS - covered


def test_max_pool_splits_its_grad_among_tied_maxima():
    """The tie case's grad is the JAX package's: a row's grad is shared
    evenly by the positions that hold its maximum."""
    x = torch.tensor([[[1.0], [3.0], [3.0], [3.0]]], requires_grad=True)
    ctx = tregistry.LoweringContext({"pooltype": "MAX"}, "cpu")
    out = tregistry.get_op_def("sequence_pool").lower(
        ctx, x, torch.tensor([3], dtype=torch.int32))["Out"]
    g, = torch.autograd.grad(out.sum(), x)
    np.testing.assert_allclose(g.reshape(-1).numpy(), [0, 0.5, 0.5, 0])


def test_nested_input_is_refused_where_the_rule_has_no_nested_path():
    for pkg in (fluid, ptt):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()), \
                pkg.unique_name.guard():
            x = pkg.layers.data("x", shape=[D], lod_level=2)
            with pytest.raises(NotImplementedError, match="nested"):
                pkg.layers.row_conv(x, future_context_size=1)


# ---------------------------------------------------------------------------
# bf16: the recurrent rules against the JAX rules
# ---------------------------------------------------------------------------

def _bf16_case(op, seed):
    rng = np.random.RandomState(seed)
    Bn, Tn, H, P = 6, 16, 16, 8
    lens = rng.randint(1, Tn + 1, Bn).astype(np.int32)
    lens[:2] = (1, Tn)
    ins = {"lstm": {"Input": rng.randn(Bn, Tn, 4 * H),
                    "Weight": rng.randn(H, 4 * H) * 0.3,
                    "Bias": rng.randn(1, 7 * H) * 0.3},
           "lstm-h0-c0": {"Input": rng.randn(Bn, Tn, 4 * H),
                          "Weight": rng.randn(H, 4 * H) * 0.3,
                          "Bias": rng.randn(1, 4 * H) * 0.3,
                          "H0": rng.randn(Bn, H), "C0": rng.randn(Bn, H)},
           "gru": {"Input": rng.randn(Bn, Tn, 3 * H),
                   "Weight": rng.randn(H, 3 * H) * 0.3,
                   "Bias": rng.randn(1, 3 * H) * 0.3,
                   "H0": rng.randn(Bn, H) * 0.5},
           "lstmp": {"Input": rng.randn(Bn, Tn, 4 * H),
                     "Weight": rng.randn(P, 4 * H) * 0.3,
                     "ProjWeight": rng.randn(H, P) * 0.3,
                     "Bias": rng.randn(1, 7 * H) * 0.3}}[op]
    attrs = {"lstm": {"use_peepholes": True},
             "lstm-h0-c0": {"is_reverse": True,
                            "candidate_activation": "relu"},
             "gru": {"is_reverse": True},
             "lstmp": {"use_peepholes": True, "is_reverse": True}}[op]
    ins = {k: v.astype(np.float32) for k, v in ins.items()}
    return op.split("-")[0], ins, attrs, lens


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.detach().view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


@pytest.mark.parametrize("case", ["lstm", "lstm-h0-c0", "gru", "lstmp"])
def test_recurrent_rules_bf16_are_the_jax_rules_bit_for_bit(case):
    op, ins, attrs, lens = _bf16_case(case, 41)
    jins = {k: jnp.asarray(v, jnp.bfloat16) for k, v in ins.items()}
    jins["SeqLen"] = jnp.asarray(lens)
    rule = jregistry.get_op_def(op).lower

    def jrule(**kw):
        return rule(jregistry.LoweringContext(attrs), **kw)

    with jax.disable_jit():
        op_by_op = jrule(**jins)
    jitted = jax.jit(jrule)(**jins)
    tins = {k: torch.from_numpy(v).bfloat16() for k, v in ins.items()}
    tins["SeqLen"] = torch.from_numpy(lens)
    got = tregistry.get_op_def(op).lower(
        tregistry.LoweringContext(attrs, "cpu"), **tins)
    assert set(got) == set(jitted)
    for slot, t in got.items():
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(t), _bits(op_by_op[slot]), slot)
        np.testing.assert_array_equal(_bits(t), _bits(jitted[slot]), slot)


def _bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).bfloat16()


def _bias_grad_from_terms(ct, lens, reverse, cell=None):
    """The Bias grad the port's rule gives, from the JAX rule's own terms:
    ct [B, T, G] the Input grad and, with peepholes, cell [B, T, H] the
    Cell output (bf16 values, zero initial cell). The gate biases take
    ct summed over batch and time; each peephole tap takes, per step, the
    batch sum of its products (the i and f taps with the cell before the
    step, the o tap with the one after), the steps added in bf16 from the
    last one back, as autograd accumulates them. Each sum is torch's bf16
    sum: float32 inside, rounded once."""
    ct, lens = _bf16(ct), torch.from_numpy(lens)
    ct = _reverse_padded(ct, lens) if reverse else ct
    parts = [ct.sum((0, 1))]
    if cell is not None:
        cell = _bf16(cell)
        cell = _reverse_padded(cell, lens) if reverse else cell
        H = cell.shape[-1]
        prev = torch.cat([torch.zeros_like(cell[:, :1]), cell[:, :-1]], 1)
        for gate, c in ((0, prev), (1, prev), (3, cell)):
            acc = None
            for t in reversed(range(ct.shape[1])):
                term = (ct[:, t, gate * H:(gate + 1) * H] * c[:, t]).sum(0)
                acc = term if acc is None else acc + term
            parts.append(acc)
    return torch.cat(parts).float().numpy()


@pytest.mark.parametrize("case", ["lstm", "lstm-h0-c0", "gru", "lstmp"])
def test_recurrent_bf16_grads_lie_within_bf16s_own_noise(case):
    """The port's bf16 grads against the jitted JAX rule's vjp: every
    input's equal but the Bias's, and the Bias's equal to torch's sums of
    the JAX rule's terms (module doc); equal as values, so a zero's sign
    may differ (at padded steps). Control: the port's float32 grads
    rounded to bf16 are not the JAX rule's."""
    op, ins, attrs, lens = _bf16_case(case, 42)
    out_slot = {"lstm": "Hidden", "gru": "Hidden", "lstmp": "Projection"}[op]
    names = sorted(ins)
    rule = jregistry.get_op_def(op).lower

    def f(*vals):
        return rule(jregistry.LoweringContext(attrs),
                    **dict(zip(names, vals)), SeqLen=jnp.asarray(lens))

    jins = [jnp.asarray(ins[n], jnp.bfloat16) for n in names]
    outs = jax.jit(f)(*jins)
    cot = np.random.RandomState(43).randn(
        *outs[out_slot].shape).astype(np.float32)
    _, vjp = jax.vjp(jax.jit(lambda *v: f(*v)[out_slot]), *jins)
    ref = dict(zip(names, vjp(jnp.asarray(cot, jnp.bfloat16))))

    def port_grads(dtype):
        leaves = [torch.from_numpy(ins[n]).to(dtype).requires_grad_(True)
                  for n in names]
        out = tregistry.get_op_def(op).lower(
            tregistry.LoweringContext(attrs, "cpu"),
            **dict(zip(names, leaves)), SeqLen=torch.from_numpy(lens))
        return dict(zip(names, torch.autograd.grad(
            out[out_slot], leaves, torch.from_numpy(cot).to(dtype))))

    got = port_grads(torch.bfloat16)
    assert all(g.dtype == torch.bfloat16 for g in got.values())
    got = {n: g.float().numpy() for n, g in got.items()}
    ref = {n: np.asarray(r.astype(jnp.float32)) for n, r in ref.items()}
    for n in names:
        if n != "Bias":
            np.testing.assert_array_equal(got[n], ref[n], n)
    cell = None
    if attrs.get("use_peepholes", False):
        cell = np.asarray(outs["Cell"].astype(jnp.float32))
    want = _bias_grad_from_terms(ref["Input"], lens,
                                 attrs.get("is_reverse", False), cell)
    np.testing.assert_array_equal(got["Bias"].reshape(-1), want)
    f32 = port_grads(torch.float32)["Input"].bfloat16().float().numpy()
    assert not np.array_equal(f32, ref["Input"])


# ---------------------------------------------------------------------------
# feeds
# ---------------------------------------------------------------------------

def _feed_block(pkg):
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()), pkg.unique_name.guard():
        L = pkg.layers
        L.data("w", shape=[1], dtype="int64", lod_level=1)
        L.data("doc", shape=[3], dtype="float32", lod_level=2)
        L.data("label", shape=[1], dtype="int64")
    return main


def test_lod_data_and_feeds_are_the_jax_packages():
    jmain, tmain = _feed_block(fluid), _feed_block(ptt)
    assert tmain.to_dict() == jmain.to_dict()
    gb = tmain.global_block()
    assert gb.vars["w"].shape == (-1, -1, 1) or \
        list(gb.vars["w"].shape) == [-1, -1, 1]
    assert gb.vars["w@SEQLEN"].dtype == "int32"
    assert list(gb.vars["doc@SEQLEN.1"].shape) == [-1, -1]
    rng = np.random.RandomState(44)
    feed = {"w": (rng.randint(0, 9, (3, 5, 1)), [5, 1, 3]),
            "doc": (rng.randn(2, 2, 4, 3), ([2, 1], [[4, 1], [2, 0]])),
            "label": [[1], [0], [1]]}
    ref = jexecutor._convert_feed_dict(jmain.global_block(), feed)
    got = texecutor.convert_feed(tmain.global_block(), feed, "cpu")
    assert set(got) == set(ref) == {"w", "w@SEQLEN", "doc", "doc@SEQLEN",
                                    "doc@SEQLEN.1", "label"}
    for n, r in ref.items():
        r = np.asarray(r)
        assert got[n].numpy().dtype == r.dtype or n in ("w", "label"), n
        np.testing.assert_array_equal(got[n].numpy(), r, err_msg=n)
    assert got["w@SEQLEN"].dtype == torch.int32


def test_create_lod_tensor_and_data_feeder_are_the_jax_packages():
    flat = np.arange(10, dtype=np.float32).reshape(5, 2)
    for data, lens in ((flat, [[2, 3]]), (flat, [[2, 1], [2, 1, 2]]),
                       ([[1, 2], [3]], [[2, 1]]),
                       ([[[1, 2], [3]], [[4]]], [[2, 1], [2, 1, 1]])):
        ref, got = fluid.create_lod_tensor(data, lens), \
            ptt.create_lod_tensor(data, lens)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    np.random.seed(45)
    ref = fluid.create_random_int_lodtensor([[3, 1]], [1], low=2, high=7)
    np.random.seed(45)
    got = ptt.create_random_int_lodtensor([[3, 1]], [1], low=2, high=7)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    rows = [([[3], [1], [4]], [[1.0, 2.0, 0.5]], 1),
            ([[5]], [[0.1, 0.2, 0.3], [1.0, 1.0, 1.0]], 0)]
    jmain, tmain = _feed_block(fluid), _feed_block(ptt)
    for pad_to in (0, 6):
        ref = fluid.DataFeeder(["w", "doc", "label"], program=jmain).feed(
            [(r[0], [r[1]], r[2]) for r in rows], pad_to=pad_to)
        got = ptt.DataFeeder(["w", "doc", "label"], program=tmain).feed(
            [(r[0], [r[1]], r[2]) for r in rows], pad_to=pad_to)
        assert set(got) == set(ref)
        for n in ref:
            for a, b in zip(jax.tree_util.tree_leaves(got[n]),
                            jax.tree_util.tree_leaves(ref[n])):
                np.testing.assert_array_equal(a, b, err_msg=n)
                assert a.dtype == b.dtype, n


# ---------------------------------------------------------------------------
# the programs and the stacked LSTM
# ---------------------------------------------------------------------------

SMALL = dict(dict_size=200, emb_dim=16, hidden_dim=16, stacked_num=2)


def _lstm_model(pkg, **cfg):
    mod = jlstm_model if pkg is fluid else tlstm_model
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, fetches = mod.build(**cfg)
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(fetches["loss"])
    return main, startup, fetches["loss"].name


def _conv_pool_model(pkg):
    """A text CNN in the reference's understand_sentiment shape: ids ->
    embedding -> nets.sequence_conv_pool (two window sizes) -> softmax."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        L = pkg.layers
        words = L.data("words", shape=[1], dtype="int64", lod_level=1)
        label = L.data("label", shape=[1], dtype="int64")
        emb = L.embedding(words, size=[50, 8])
        convs = [pkg.nets.sequence_conv_pool(emb, num_filters=6,
                                             filter_size=k, act="sigmoid",
                                             pool_type=p)
                 for k, p in ((3, "max"), (4, "average"))]
        prob = L.fc(convs, size=2, act="softmax")
        loss = L.mean(L.cross_entropy(prob, label))
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss.name


@pytest.mark.parametrize("model", ["stacked_dynamic_lstm",
                                   "sequence_conv_pool"])
def test_programs_are_the_same_in_both_packages(model):
    build = (lambda p: _lstm_model(p, **SMALL)) \
        if model == "stacked_dynamic_lstm" else _conv_pool_model
    jmain, jstartup, _ = build(fluid)
    tmain, tstartup, _ = build(ptt)
    assert tmain.to_dict() == _int64_as_port(jmain.to_dict(), tmain)
    assert tstartup.to_dict() == jstartup.to_dict()
    gb = tmain.global_block()
    types = [op.type for op in gb.ops]
    seqlens = sorted(n for n in gb.vars if "@SEQLEN" in n)
    if model == "stacked_dynamic_lstm":
        assert types.count("lstm") == 2 and "sequence_pool" in types
        # the data's companion, and the ones the lstm ops read off the
        # fc outputs (written at run time by propagation, not by an op)
        # and the one sequence_pool reads off the last lstm's output
        assert len(seqlens) == 4 and "words@SEQLEN" in seqlens
        assert all(gb.vars[n].dtype == "int32" for n in seqlens)
    else:
        assert types.count("sequence_conv") == 2
        assert types.count("assign") == 2       # the companions' aliases


def _lstm_feeds(n, batch=4, steps=12, dict_size=200, seed=46):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = rng.randint(1, steps + 1, batch).astype(np.int32)
        lens[:2] = (1, steps)
        out.append({"words": (rng.randint(0, dict_size, (batch, steps, 1))
                              .astype(np.int64), lens),
                    "label": rng.randint(0, 2, (batch, 1)).astype(np.int64)})
    return out


def _conv_pool_feeds(n, seed=47):
    rng = np.random.RandomState(seed)
    return [{"words": (rng.randint(0, 50, (4, 9, 1)).astype(np.int64),
                       np.array([1, 9, 4, 6], np.int32)),
             "label": rng.randint(0, 2, (4, 1)).astype(np.int64)}
            for _ in range(n)]


@pytest.mark.parametrize("model", ["stacked_dynamic_lstm",
                                   "sequence_conv_pool"])
def test_models_train_like_paddle_tpu(model):
    """A free run of 3 Adam steps from the JAX startup's state: losses to
    1e-4 relative, every parameter and moment to 1e-4."""
    if model == "stacked_dynamic_lstm":
        (jmain, jstartup, loss), feeds = _lstm_model(fluid, **SMALL), \
            _lstm_feeds(3)
        tmain = _lstm_model(ptt, **SMALL)[0]
    else:
        (jmain, jstartup, loss), feeds = _conv_pool_model(fluid), \
            _conv_pool_feeds(3)
        tmain = _conv_pool_model(ptt)[0]
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    names = list(jscope.local_var_names())
    tscope = ptt.io.state_from_numpy(
        {n: np.asarray(jscope.find_var(n)) for n in names}, ptt.CPUPlace())
    texe = ptt.Executor(ptt.CPUPlace())
    for feed in feeds:
        ref, = jexe.run(jmain, feed=feed, fetch_list=[loss], scope=jscope)
        got, = texe.run(tmain, feed=feed, fetch_list=[loss], scope=tscope)
        assert got[0] > 0.1
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4)
    for n in names:
        np.testing.assert_allclose(fetch_var(n, tscope),
                                   np.asarray(jscope.find_var(n)),
                                   atol=1e-4, rtol=0, err_msg=n)


def _bias_sums(main):
    """For each lstm op of a stacked LSTM Program: the Input and Cell it
    reads and writes, its Bias, the bias of the fc whose output it reads,
    and whether it runs reversed."""
    ops = main.global_block().ops
    add_bias = {op.outputs["Out"][0]: op.inputs["Y"][0] for op in ops
                if op.type == "elementwise_add"}
    return [(op.inputs["Input"][0], op.outputs["Cell"][0],
             op.inputs["Bias"][0], add_bias[op.inputs["Input"][0]],
             op.attrs.get("is_reverse", False))
            for op in ops if op.type == "lstm"]


def test_stacked_lstm_amp_steps_match_paddle_tpu_from_its_state():
    """3 AMP steps, each from the JAX package's AMP state after the step
    before, against its AMP step run op by op: the loss, every lstm's
    Input grad and Cell, and every parameter's grad but the biases' equal;
    each lstm's and fc's bias grad equal to torch's sums of the JAX
    package's terms (module doc); every state but the biases' and their
    moments within ADAM_RTOL after the step (float32 Adam). The losses
    within AMP_LOSS_RTOL of the jitted JAX AMP step's, which leaves the
    op-by-op one by a few bf16 ulp (ROADMAP Queue 3)."""
    jmain, jstartup, loss = _lstm_model(fluid, **SMALL)
    tmain = _lstm_model(ptt, **SMALL)[0]
    lstms = _bias_sums(tmain)
    biases = {b for _, _, lb, fb, _ in lstms for b in (lb, fb)}
    bias_grads = {b + "@GRAD" for b in biases}
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace(), amp=True)
    jexe.run(jstartup, scope=jscope)
    names = list(jscope.local_var_names())
    params = sorted(n for n in names if isinstance(
        tmain.global_block().vars[n], ptt.Parameter))
    fetch = ([loss] + [n + "@GRAD" for n in params]
             + [v for i, c, *_ in lstms for v in (i + "@GRAD", c)])
    texe = ptt.Executor(ptt.CPUPlace(), amp=True)
    for feed in _lstm_feeds(3, seed=48):
        state = {n: np.asarray(jscope.find_var(n)) for n in names}
        tscope = ptt.io.state_from_numpy(state, ptt.CPUPlace())
        jit_scope = fluid.Scope()
        for n, v in state.items():
            jit_scope.set_var(n, v.copy())
        jit_loss, = jexe.run(jmain, feed=feed, fetch_list=[loss],
                             scope=jit_scope)
        with jax.disable_jit():
            ref = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
        ref = dict(zip(fetch, (np.asarray(r).astype(np.float32)
                               for r in ref)))
        got = dict(zip(fetch, texe.run(tmain, feed=feed, fetch_list=fetch,
                                       scope=tscope)))
        for n in fetch:
            if n not in bias_grads:
                np.testing.assert_array_equal(got[n], ref[n], n)
        for inp, cell, lstm_bias, fc_bias, reverse in lstms:
            want = _bias_grad_from_terms(ref[inp + "@GRAD"],
                                         feed["words"][1], reverse,
                                         ref[cell])
            np.testing.assert_array_equal(
                got[lstm_bias + "@GRAD"].reshape(-1), want)
            np.testing.assert_array_equal(
                got[fc_bias + "@GRAD"].reshape(-1),
                _bias_grad_from_terms(ref[inp + "@GRAD"], feed["words"][1],
                                      False))
        np.testing.assert_allclose(got[loss], np.asarray(jit_loss),
                                   rtol=AMP_LOSS_RTOL)
        for n in names:
            if not any(n.startswith(b) for b in biases):
                np.testing.assert_allclose(
                    fetch_var(n, tscope), np.asarray(jscope.find_var(n)),
                    rtol=ADAM_RTOL, atol=0, err_msg=n)


def test_lengths_propagate_only_through_ops_that_keep_the_time_axis():
    """An op registered with propagate_seqlen (`mul`, `elementwise_add`)
    hands its input's lengths to its output; `sequence_pool` (False)
    does not, though its [B, D] output has the batch's leading dim."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        x = ptt.layers.data("x", shape=[D], lod_level=1)
        h = ptt.layers.fc(x, size=3, num_flatten_dims=2)
        pooled = ptt.layers.sequence_pool(h, "sum")
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {"x": (_X, LENS)}
    lens, = exe.run(main, feed=feed, fetch_list=[h.name + "@SEQLEN"],
                    scope=scope)
    np.testing.assert_array_equal(lens, LENS)
    with pytest.raises(KeyError, match="was not computed"):
        exe.run(main, feed=feed, fetch_list=[pooled.name + "@SEQLEN"],
                scope=scope)


def test_fc_companion_written_by_propagation_is_not_reported_missing():
    """`dynamic_lstm` reads the companion of the `fc` output before it,
    which no op writes: the step plan counts it as produced by the op
    whose output it follows, and propagation writes it."""
    tmain, tstartup, loss = _lstm_model(ptt, **SMALL)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(tstartup, scope=scope)
    lstm_in = [op.inputs["SeqLen"][0] for op in tmain.global_block().ops
               if op.type == "lstm"]
    assert lstm_in[0] != "words@SEQLEN"
    feed = _lstm_feeds(1)[0]
    out = exe.run(tmain, feed=feed, fetch_list=[loss] + lstm_in, scope=scope)
    for lens in out[1:]:
        np.testing.assert_array_equal(lens, feed["words"][1])
        assert lens.dtype == np.int32
