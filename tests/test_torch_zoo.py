"""paddle_tpu_torch's zoo and optimizer slice against paddle_tpu, on the
CPU: the new op rules and the rest of the non-recurrent model zoo.

The op rules this slice adds (the elementwise `sub`, `mul`, `div`,
`max`, `min` and `pow` with the broadcast `axis`; `exp`, `sqrt`,
`square`, `sigmoid`; `reduce_sum`, `clip`, `clip_by_norm`; `less_than`,
`greater_equal`; `concat`, `increment`, `assign`, `causal_mask`;
`sigmoid_cross_entropy_with_logits`) and their generic grads, the nets
`img_conv_group` and `scaled_dot_product_attention`, and the models
SE-ResNeXt-50, VGG-16, DeepFM and the unfused-attention Transformer are
held against the JAX package on the same numpy inputs and parameters
(`io.state_from_numpy` of the JAX startup's scope). The optimizers,
schedules and clips are in tests/test_torch_optim.py; the bf16 cases in
tests/test_torch_amp.py.

Tolerances: 1e-5 for one op and its grads in float32 (summation order);
after training steps, losses to 1e-4 relative (1e-5 for DeepFM, whose
Adagrad steps are short sums) and state to 1e-4 absolute (running
variances relative too). At 32 x 32, SE-ResNeXt-50 reaches a 1 x 1 last
stage and VGG-16 a 2 x 2 one, where batch norm normalizes over the batch
alone: like ResNet-50 (tests/test_torch_vision.py) they are chaotic in
float32, so each of their steps starts from the JAX package's state.

The models' dropouts draw from different generators in the two packages
(ROADMAP, expected differences), so the training comparisons set every
dropout's rate to 0 in both copies of the Program after checking that
the Programs are the same as built.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.layer_helper import LayerHelper as JLayerHelper
from paddle_tpu.models import deepfm as jdeepfm
from paddle_tpu.models import se_resnext as jse
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.models import vgg as jvgg
from paddle_tpu.ops import pallas_dropout as jpd

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.executor import fetch_var
from paddle_tpu_torch.models import deepfm as tdeepfm
from paddle_tpu_torch.models import se_resnext as tse
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.models import vgg as tvgg
from paddle_tpu_torch.ops import dropout_kernel as dk
from paddle_tpu_torch.ops import native

TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small CPU ops run far faster on one thread than on a pool that
    several test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret_kernels(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


# ---------------------------------------------------------------------------
# op rules and their grads against paddle_tpu
# ---------------------------------------------------------------------------

def _run_both(build, feed, fetch):
    """Build with paddle_tpu (`build(fluid)` returns the loss), append its
    backward, load the same Program JSON into the port, start both from
    the JAX startup's parameters, run one step of each and return both
    fetch lists (grads are fetched as `<name>@GRAD`)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, names = build(fluid)
        fluid.backward.append_backward(loss)
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(startup, scope=jscope)
    arrays = {n: np.asarray(jscope.find_var(n))
              for n in jscope.local_var_names()}
    fetch = names + fetch
    ref = jexe.run(main, feed=feed, fetch_list=fetch, scope=jscope)
    native.reset_launches()
    got = ptt.Executor(ptt.CPUPlace()).run(
        ptt.Program.from_dict(main.to_dict()), feed=feed, fetch_list=fetch,
        scope=ptt.io.state_from_numpy(arrays, ptt.CPUPlace()))
    assert not any(native.launches.values())
    return fetch, [np.asarray(r) for r in ref], got


def _head(L, out):
    """mean(out @ w) for a Xavier-initialized w: a random cotangent."""
    return L.mean(L.fc(out, 1, num_flatten_dims=len(out.shape) - 1,
                       bias_attr=False, param_attr="head_w"))


def _x(L, shape, name="x", stop_gradient=False):
    return L.data(name, shape=list(shape), dtype="float32",
                  append_batch_size=False, stop_gradient=stop_gradient)


def _op(op_type, inputs, attrs=None, dtype="float32"):
    """Append one op of `op_type` the way the JAX package's layers do."""
    helper = JLayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(op_type, inputs={k: [v.name for v in vs]
                                      for k, vs in inputs.items()},
                     outputs={"Out": [out.name]}, attrs=attrs or {})
    return out


X3 = (2, 6, 8)
_RNG = np.random.RandomState(21)
_FEED = {"x": _RNG.randn(*X3).astype(np.float32),
         "y": _RNG.randn(*X3).astype(np.float32),
         "yb": _RNG.randn(6).astype(np.float32),
         "pos": (np.abs(_RNG.randn(*X3)) + 0.5).astype(np.float32),
         "lbl": (_RNG.rand(*X3) > 0.5).astype(np.float32)}
_FEED["lbl"][0, 0, :3] = -100.0          # ignore_index


def _binary_case(op, broadcast):
    def build(pkg):
        L = pkg.layers
        x = _x(L, X3, "pos" if op in ("div", "pow") else "x")
        y = _x(L, (6,), "yb") if broadcast else _x(L, X3, "y")
        if op == "div":
            y = L.scale(L.sigmoid(y), scale=2.0, bias=0.5)   # away from 0
        out = getattr(L, f"elementwise_{op}")(x, y, axis=1 if broadcast
                                              else -1)
        return _head(L, out), [out.name]
    grads = ["pos@GRAD" if op in ("div", "pow") else "x@GRAD",
             "yb@GRAD" if broadcast else "y@GRAD"]
    return build, grads


def _unary_case(fn, src="x"):
    def build(pkg):
        out = fn(pkg.layers, _x(pkg.layers, X3, src))
        return _head(pkg.layers, out), [out.name]
    return build, [f"{src}@GRAD"]


def _concat_case():
    def build(pkg):
        L = pkg.layers
        out = L.concat([_x(L, X3, "x"), L.scale(_x(L, X3, "y"), 2.0)],
                       axis=1)
        return _head(L, out), [out.name]
    return build, ["x@GRAD", "y@GRAD"]


def _compare_case(op):
    """less_than / greater_equal (bool, no grad), cast to float32 and used
    as a gate on x, so their output reaches the loss."""
    def build(pkg):
        L = pkg.layers
        x, y = _x(L, X3, "x"), _x(L, X3, "y", stop_gradient=True)
        cmp = _op(op, {"X": [x], "Y": [y]}, {"axis": -1}, "bool")
        out = L.elementwise_mul(x, L.cast(cmp, "float32"))
        return _head(L, out), [cmp.name, out.name]
    return build, ["x@GRAD"]


def _increment_assign_case():
    def build(pkg):
        L = pkg.layers
        x = _x(L, X3, "x")
        inc = _op("increment", {"X": [x]}, {"step": 2.5})
        out = L.assign(L.elementwise_mul(inc, x))
        return _head(L, out), [inc.name, out.name]
    return build, ["x@GRAD"]


def _causal_mask_case():
    def build(pkg):
        L = pkg.layers
        x = _x(L, (2, 2, 8, 8), "m")
        mask = jtransformer._causal_mask(8)
        out = L.softmax(L.elementwise_add(x, mask))
        return _head(L, out), [mask.name, out.name]
    return build, ["m@GRAD"]


def _sigmoid_ce_case():
    def build(pkg):
        L = pkg.layers
        out = L.sigmoid_cross_entropy_with_logits(
            L.scale(_x(L, X3, "x"), 3.0), _x(L, X3, "lbl", True))
        return _head(L, out), [out.name]
    return build, ["x@GRAD"]


def _sdpa_case(heads, dropout):
    def build(pkg):
        L = pkg.layers
        q, k, v = (_x(L, X3, n) for n in ("x", "y", "pos"))
        out = pkg.nets.scaled_dot_product_attention(q, k, v, heads, dropout)
        return _head(L, out), [out.name]
    return build, ["x@GRAD", "y@GRAD", "pos@GRAD"]


OP_CASES = {
    **{f"elementwise_{op}{'-axis1' if b else ''}": _binary_case(op, b)
       for op in ("sub", "mul", "div", "max", "min", "pow")
       for b in (False, True)},
    "exp": _unary_case(lambda L, x: L.exp(x)),
    "sqrt": _unary_case(lambda L, x: L.sqrt(x), "pos"),
    "square": _unary_case(lambda L, x: L.square(x)),
    "sigmoid": _unary_case(lambda L, x: L.sigmoid(L.scale(x, 4.0))),
    "reduce_sum-dim1": _unary_case(lambda L, x: L.reduce_sum(x, dim=1)),
    "reduce_sum-dims-keep": _unary_case(
        lambda L, x: L.reduce_sum(x, dim=[1, 2], keep_dim=True)),
    "reduce_sum-all": _unary_case(lambda L, x: L.reduce_sum(x)),
    "clip": _unary_case(lambda L, x: L.clip(x, -0.4, 0.7)),
    "clip_by_norm-clipped": _unary_case(lambda L, x: L.clip_by_norm(x, 1.5)),
    "clip_by_norm-unclipped": _unary_case(
        lambda L, x: L.clip_by_norm(x, 100.0)),
    "concat": _concat_case(),
    "less_than": _compare_case("less_than"),
    "greater_equal": _compare_case("greater_equal"),
    "increment-assign": _increment_assign_case(),
    "causal_mask": _causal_mask_case(),
    "sigmoid_cross_entropy_with_logits": _sigmoid_ce_case(),
    "scaled_dot_product_attention-1head": _sdpa_case(1, 0.0),
    "scaled_dot_product_attention-2heads": _sdpa_case(2, 0.0),
}


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_rule_and_grad_match_paddle_tpu(name):
    build, grads = OP_CASES[name]
    feed = dict(_FEED)
    if name == "causal_mask":
        feed = {"m": np.random.RandomState(22).randn(2, 2, 8, 8)
                .astype(np.float32)}
    fetch, ref, got = _run_both(build, feed, grads + ["head_w@GRAD"])
    for n, a, b in zip(fetch, got, ref):
        assert a.shape == b.shape, n
        assert a.dtype == b.dtype, n
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL, err_msg=n)


def test_causal_mask_is_upper_triangular_minus_1e9():
    ctx = ptt.core.registry.LoweringContext({"size": 5, "neg": -1e9}, "cpu")
    m = ptt.core.registry.get_op_def("causal_mask").lower(ctx)["Out"]
    assert m.shape == (1, 1, 5, 5) and m.dtype == torch.float32
    want = np.triu(np.full((5, 5), -1e9, np.float32), k=1)
    np.testing.assert_array_equal(m[0, 0].numpy(), want)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _model(pkg, build, opt):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, fetches = build(pkg)
        opt(pkg).minimize(fetches["loss"])
    return main, startup, fetches["loss"].name


def _index_dtypes_as_port(program_dict):
    """The JAX package's program dict with its top_k `Indices` vars
    declared int64, as the port declares them (tests/test_torch_vision.py
    says why)."""
    idx = {op["outputs"]["Indices"][0]
           for b in program_dict["blocks"] for op in b["ops"]
           if op["type"] == "top_k"}
    for b in program_dict["blocks"]:
        for v in b["vars"]:
            if v["name"] in idx:
                assert v["dtype"] == "int32"
                v["dtype"] = "int64"
    return program_dict


def _no_dropout(program_dict):
    """The program dict with every dropout's rate set to 0 (the module
    docstring says why); returns the number of dropout ops."""
    n = 0
    for b in program_dict["blocks"]:
        for op in b["ops"]:
            if op["type"] in ("dropout", "dropout_grad"):
                op["attrs"]["dropout_prob"] = 0.0
                fwd = op["attrs"].get("__fwd_op__")
                if fwd is not None:
                    fwd["attrs"]["dropout_prob"] = 0.0
                n += op["type"] == "dropout"
    return n


def _momentum_piecewise(pkg):
    """The PaddlePaddle/models image-classification recipe that
    chip_smoke.py trains SE-ResNeXt-50 with."""
    lr = pkg.layers.piecewise_decay([2, 4], [0.1, 0.01, 0.001])
    return pkg.optimizer.Momentum(
        learning_rate=lr, momentum=0.9,
        regularization=pkg.regularizer.L2Decay(1e-4))


def _se(fmt):
    def build(pkg):
        mod = jse if pkg is fluid else tse
        return mod.build(class_dim=10, image_shape=(3, 32, 32),
                         data_format=fmt)
    return build


def _vgg(pkg):
    return (jvgg if pkg is fluid else tvgg).build(class_dim=10)


DEEPFM = dict(num_fields=6, sparse_feature_dim=1000, embedding_size=8,
              dense_dim=4, hidden_sizes=(32, 32))


def _deepfm(pkg):
    return (jdeepfm if pkg is fluid else tdeepfm).build(**DEEPFM)


def _adagrad_global_clip(pkg):
    pkg.clip.set_gradient_clip(pkg.clip.GradientClipByGlobalNorm(10.0))
    return pkg.optimizer.Adagrad(learning_rate=0.01)


@pytest.fixture
def no_global_clip():
    yield
    fluid.clip.set_gradient_clip(None)
    ptt.clip.set_gradient_clip(None)


@pytest.mark.parametrize("name", ["se_resnext50-NCHW", "se_resnext50-NHWC",
                                  "vgg16", "deepfm"])
def test_programs_are_the_same_in_both_packages(name, no_global_clip):
    build, opt = {"se_resnext50-NCHW": (_se("NCHW"), _momentum_piecewise),
                  "se_resnext50-NHWC": (_se("NHWC"), _momentum_piecewise),
                  "vgg16": (_vgg, _momentum_piecewise),
                  "deepfm": (_deepfm, _adagrad_global_clip)}[name]
    jmain, jstartup, _ = _model(fluid, build, opt)
    fluid.clip.set_gradient_clip(None)
    tmain, tstartup, _ = _model(ptt, build, opt)
    assert tmain.to_dict() == _index_dtypes_as_port(jmain.to_dict())
    assert tstartup.to_dict() == jstartup.to_dict()
    types = [op.type for op in tmain.global_block().ops]
    if name.startswith("se_resnext"):
        assert types.count("conv2d") == 53 and "increment" in types
        groups = {op.attrs["groups"] for op in tmain.global_block().ops
                  if op.type == "conv2d"}
        assert groups == {1, 32}
        assert types.count("sigmoid") == 16            # the SE gates
    elif name == "vgg16":
        assert types.count("conv2d") == 13 and types.count("dropout") == 10
    else:
        assert {"concat", "reduce_sum", "elementwise_sub", "sqrt",
                "sigmoid_cross_entropy_with_logits", "adagrad"} <= set(types)


def _steps(jprog, tprog, feeds, teacher_forced=False):
    """Run the JAX program and the port's on the same feeds from the JAX
    startup's state; with `teacher_forced` each port step starts from the
    JAX package's state. Returns ([(ref, got) losses], JAX scope, port
    scope, state names)."""
    (jmain, jstartup, loss), tmain = jprog, tprog
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    names = list(jscope.local_var_names())

    def state():
        return ptt.io.state_from_numpy(
            {n: np.asarray(jscope.find_var(n)) for n in names},
            ptt.CPUPlace())

    tscope = state()
    texe = ptt.Executor(ptt.CPUPlace())
    out = []
    native.reset_launches()
    for feed in feeds:
        if teacher_forced:
            tscope = state()
        ref, = jexe.run(jmain, feed=feed, fetch_list=[loss], scope=jscope)
        got, = texe.run(tprog, feed=feed, fetch_list=[loss], scope=tscope)
        out.append((float(np.asarray(ref).reshape(-1)[0]),
                    float(got.reshape(-1)[0])))
    assert not any(native.launches.values())
    return out, jscope, tscope, names


def _rate0_pair(build, opt):
    """Both packages' programs with every dropout at rate 0."""
    jmain, jstartup, loss = _model(fluid, build, opt)
    d = jmain.to_dict()
    n = _no_dropout(d)
    return (fluid.Program.from_dict(d), jstartup, loss), \
        ptt.Program.from_dict(d), n


def _images(rng, shape, n=3, classes=10):
    return [{"image": rng.rand(*shape).astype(np.float32),
             "label": rng.randint(0, classes, (shape[0], 1)).astype(np.int64)}
            for _ in range(n)]


def test_se_resnext50_steps_like_paddle_tpu():
    """SE-ResNeXt-50 32x4d at 32 x 32, 10 classes, batch 4, NHWC (as the
    card trains it; the NCHW program's ops are the same, and the vision
    ops' NCHW rules are held in tests/test_torch_vision.py): 3 Momentum
    steps on piecewise_decay with L2Decay, each from the JAX package's
    state (the module docstring says why): the loss to 1e-4 relative, the
    running stats and the LR counter to 1e-4."""
    fmt = "NHWC"
    jprog, tprog, ndrop = _rate0_pair(_se(fmt), _momentum_piecewise)
    assert ndrop == 1
    shape = (4, 3, 32, 32) if fmt == "NCHW" else (4, 32, 32, 3)
    losses, jscope, tscope, names = _steps(
        jprog, tprog, _images(np.random.RandomState(23), shape),
        teacher_forced=True)
    for ref, got in losses:
        assert got > 0.1
        np.testing.assert_allclose(got, ref, rtol=1e-4)
    stats = {op.inputs[s][0] for op in tprog.global_block().ops
             if op.type == "batch_norm" for s in ("Mean", "Variance")}
    assert len(stats) == 2 * 53 and stats <= set(names)
    for n in sorted(stats) + ["@LR_DECAY_COUNTER@"]:
        np.testing.assert_allclose(fetch_var(n, tscope),
                                   np.asarray(jscope.find_var(n)),
                                   atol=1e-4, rtol=1e-4, err_msg=n)


def test_vgg16_steps_like_paddle_tpu():
    """VGG-16 with batch norm at 32 x 32, 10 classes, batch 4: 3 steps of
    the recipe, each from the JAX package's state. Its last conv block
    and its fc batch norm see 2 x 2 positions and the batch alone, so,
    like SE-ResNeXt here, a free run drifts (1 % by the third step, at
    lr 1e-3 as at 0.1). The loss to 1e-4 relative, the running stats to
    1e-4."""
    jprog, tprog, ndrop = _rate0_pair(_vgg, _momentum_piecewise)
    assert ndrop == 10
    losses, jscope, tscope, names = _steps(
        jprog, tprog, _images(np.random.RandomState(24), (4, 3, 32, 32)),
        teacher_forced=True)
    for ref, got in losses:
        np.testing.assert_allclose(got, ref, rtol=1e-4)
    stats = {op.inputs[s][0] for op in tprog.global_block().ops
             if op.type == "batch_norm" for s in ("Mean", "Variance")}
    assert len(stats) == 2 * 14 and stats <= set(names)
    for n in sorted(stats):
        np.testing.assert_allclose(fetch_var(n, tscope),
                                   np.asarray(jscope.find_var(n)),
                                   atol=1e-4, rtol=1e-4, err_msg=n)


def test_deepfm_trains_like_paddle_tpu(no_global_clip):
    """DeepFM at tests/test_models.py's sizes, batch 16: a free run of 3
    Adagrad(0.01) steps under GradientClipByGlobalNorm(10); losses to
    1e-5 relative, every parameter and moment to 1e-5."""
    jmain, jstartup, loss = _model(fluid, _deepfm, _adagrad_global_clip)
    fluid.clip.set_gradient_clip(None)
    tprog = ptt.Program.from_dict(jmain.to_dict())
    rng = np.random.RandomState(25)
    feeds = [{"dense_input": rng.rand(16, 4).astype(np.float32),
              "sparse_input": rng.randint(0, 1000, (16, 6)).astype(np.int64),
              "label": rng.randint(0, 2, (16, 1)).astype(np.int64)}
             for _ in range(3)]
    losses, jscope, tscope, names = _steps((jmain, jstartup, loss), tprog,
                                           feeds)
    for ref, got in losses:
        np.testing.assert_allclose(got, ref, rtol=1e-5)
    for n in names:
        np.testing.assert_allclose(fetch_var(n, tscope),
                                   np.asarray(jscope.find_var(n)),
                                   atol=1e-5, rtol=1e-5, err_msg=n)


def test_deepfm_keeps_is_distributed_and_sharding():
    """`distributed` and the tables' sharding are kept in the Program,
    as the JAX package keeps them."""
    for distributed in (False, True):
        def build(pkg):
            mod = jdeepfm if pkg is fluid else tdeepfm
            return mod.build(distributed=distributed, **DEEPFM)
        jmain = _model(fluid, build, lambda p: p.optimizer.SGD(0.1))[0]
        tmain = _model(ptt, build, lambda p: p.optimizer.SGD(0.1))[0]
        assert tmain.to_dict() == jmain.to_dict()
        gb = tmain.global_block()
        lookups = [op for op in gb.ops if op.type == "lookup_table"]
        assert [op.attrs["is_distributed"] for op in lookups] == \
            [distributed] * 2
        assert gb.vars["fm_v"].sharding == (None if distributed
                                            else ("mp", None))


SMALL = dict(src_vocab_size=64, trg_vocab_size=64, seq_len=128, n_layer=2,
             n_head=4, d_model=32, d_inner=64)


def _transformer(pkg, fused, dropout_rate=0.0):
    mod = jtransformer if pkg is fluid else ttransformer

    def build(p):
        return mod.transformer(dropout_rate=dropout_rate,
                               fused_attention=fused, **SMALL)
    return _model(pkg, build, lambda p: p.optimizer.Adam(learning_rate=1e-3))


def _batch(rng, B=2):
    return {n: rng.randint(0, 64, (B, 128)).astype(np.int64)
            for n in ("src_word", "trg_word", "lbl_word")}


def test_unfused_transformer_program_is_the_same_in_both_packages():
    jmain, jstartup, _ = _transformer(fluid, False, 0.1)
    tmain, tstartup, _ = _transformer(ptt, False, 0.1)
    assert tmain.to_dict() == jmain.to_dict()
    assert tstartup.to_dict() == jstartup.to_dict()
    types = [op.type for op in tmain.global_block().ops]
    assert "fused_attention" not in types
    # 2 encoder self, 2 decoder self (causal) and 2 cross attentions
    assert types.count("softmax") == 6 and types.count("causal_mask") == 2
    attn_drops = [op for op in tmain.global_block().ops
                  if op.type == "dropout"
                  and tmain.global_block().vars[op.inputs["X"][0]].shape[-1]
                  == 128]
    assert len(attn_drops) == 6


def test_unfused_transformer_trains_like_paddle_tpu():
    """2 layers, d_model 32, batch 2, dropout 0: a free run of 3 Adam
    steps; losses to 1e-4 relative, every parameter and moment to 1e-4."""
    jmain, jstartup, loss = _transformer(fluid, False)
    tmain, _, _ = _transformer(ptt, False)
    rng = np.random.RandomState(26)
    losses, jscope, tscope, names = _steps(
        (jmain, jstartup, loss), tmain, [_batch(rng) for _ in range(3)])
    for ref, got in losses:
        np.testing.assert_allclose(got, ref, rtol=1e-4)
    for n in names:
        np.testing.assert_allclose(fetch_var(n, tscope),
                                   np.asarray(jscope.find_var(n)),
                                   atol=1e-4, rtol=0, err_msg=n)


def test_unfused_attention_equals_fused_from_the_same_parameters():
    """In the port, the unfused and the fused model (the flash plain
    versions on the host) from the same parameters at dropout 0: the
    losses of 2 steps within the flash forward's tolerance, 1e-4."""
    umain, ustartup, uloss = _transformer(ptt, False)
    fmain, _, floss = _transformer(ptt, True)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(ustartup, scope=scope)
    arrays = {n: fetch_var(n, scope) for n in scope.local_var_names()}
    fscope = ptt.io.state_from_numpy(arrays, ptt.CPUPlace())
    rng = np.random.RandomState(27)
    for _ in range(2):
        feed = _batch(rng)
        a, = exe.run(umain, feed=feed, fetch_list=[uloss], scope=scope)
        b, = exe.run(fmain, feed=feed, fetch_list=[floss], scope=fscope)
        np.testing.assert_allclose(a, b, rtol=1e-4)


def test_unfused_attention_weights_pass_both_dropout_kernel_gates():
    """The attention weights [B, 8, 256, 256] of Transformer-base pass the
    dropout kernel's gate in both packages, so under
    FLAGS_dropout_impl=pallas each unfused attention dropout runs kernel 6
    (csrc/dropout.cu) forward and backward: 2 x 62 launches a step, the
    fused path's 2 x 44 plus 2 x 18 at the attention sites."""
    for b in (32, 64):
        x = torch.empty(b, 8, 256, 256, device="meta")
        assert dk.supports(x, 0.1)
        assert jpd.supports(jnp.zeros((1, 8, 256, 256)), 0.1)
    counts = {}
    for fused in (True, False):
        main = ptt.Program()
        with ptt.program_guard(main, ptt.Program()), \
                ptt.unique_name.guard():
            ttransformer.transformer(fused_attention=fused)
        gb = main.global_block()
        counts[fused] = sum(
            op.type == "dropout"
            and op.attrs["dropout_implementation"] == "upscale_in_train"
            and gb.vars[op.inputs["X"][0]].shape[-1] % 128 == 0
            for op in gb.ops)
    assert counts == {True: 44, False: 62}
