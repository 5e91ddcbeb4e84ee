"""paddle_tpu_torch's optimizers, learning-rate schedules, per-parameter
learning rates, gradient clips and ModelAverage against paddle_tpu, on
the CPU.

Each update op rule is held to the JAX rule on the same numpy arrays;
each optimizer class, schedule and clip builds the same Program JSON as
the JAX package and steps a small MLP from the JAX startup's state
(`io.state_from_numpy`, which carries every persistable by name: the
accumulators, the `@LR_DECAY_COUNTER@` step counter, ModelAverage's sums
and int32 counters) to the same losses and state.

Tolerances (float32): one update op to 1e-6 relative and absolute (the
same arithmetic in the same order; XLA may contract a product and a sum
into one rounding); after 5 steps of the MLP, losses to 1e-5 relative
and every persistable to 1e-5 (DecayedAdagrad's to 1e-4: `STATE_TOL`
says why); a schedule's learning rate over 30 steps to 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import registry as jregistry

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.core.executor import fetch_var
from paddle_tpu_torch.ops import native

OP_TOL = 1e-6
TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread_and_no_global_clip():
    """One torch thread (small CPU ops run far faster so under xdist), and
    no global gradient clip left behind in either package."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    fluid.clip.set_gradient_clip(None)
    ptt.clip.set_gradient_clip(None)


# ---------------------------------------------------------------------------
# the update op rules against the JAX rules
# ---------------------------------------------------------------------------

def _state(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _positive(rng, *shape):
    return (np.abs(rng.randn(*shape)) + 0.1).astype(np.float32)


def _update_case(op):
    """(inputs, attrs) of an update op of a [4, 5] parameter."""
    rng = np.random.RandomState(len(op))
    p, g = _state(rng, 4, 5), _state(rng, 4, 5)
    lr = np.array([0.05], np.float32)
    base = {"Param": p, "Grad": g, "LearningRate": lr}
    cases = {
        "sgd": ({}, {}),
        "adamax": ({"Moment": _state(rng, 4, 5),
                    "InfNorm": _positive(rng, 4, 5),
                    "Beta1Pow": np.array([0.9 ** 3], np.float32)},
                   {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
        "adagrad": ({"Moment": _positive(rng, 4, 5)}, {"epsilon": 1e-6}),
        "decayed_adagrad": ({"Moment": _positive(rng, 4, 5)},
                            {"decay": 0.95, "epsilon": 1e-6}),
        "adadelta": ({"AvgSquaredGrad": _positive(rng, 4, 5),
                      "AvgSquaredUpdate": _positive(rng, 4, 5)},
                     {"rho": 0.95, "epsilon": 1e-6}),
        "rmsprop": ({"MeanSquare": _positive(rng, 4, 5),
                     "Moment": _state(rng, 4, 5)},
                    {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5}),
        "rmsprop-centered": ({"MeanSquare": _positive(rng, 4, 5) + 1.0,
                              "Moment": _state(rng, 4, 5),
                              "MeanGrad": _state(rng, 4, 5) * 0.1},
                             {"decay": 0.9, "epsilon": 1e-6,
                              "momentum": 0.5, "centered": True}),
        "ftrl": ({"SquaredAccumulator": _positive(rng, 4, 5),
                  "LinearAccumulator": _state(rng, 4, 5)},
                 {"l1": 0.3, "l2": 0.1, "lr_power": -0.5}),
        "ftrl-power": ({"SquaredAccumulator": _positive(rng, 4, 5),
                        "LinearAccumulator": _state(rng, 4, 5)},
                       {"l1": 0.3, "l2": 0.1, "lr_power": -0.3}),
        "proximal_gd": ({}, {"l1": 0.02, "l2": 0.1}),
        "proximal_adagrad": ({"Moment": _positive(rng, 4, 5)},
                             {"l1": 0.02, "l2": 0.1}),
    }
    extra, attrs = cases[op]
    ins = dict(base, **extra)
    if op.startswith("adadelta"):
        del ins["LearningRate"]
    return ins, attrs


UPDATE_OPS = ["sgd", "adamax", "adagrad", "decayed_adagrad", "adadelta",
              "rmsprop", "rmsprop-centered", "ftrl", "ftrl-power",
              "proximal_gd", "proximal_adagrad"]


@pytest.mark.parametrize("name", UPDATE_OPS)
def test_update_op_matches_paddle_tpu_in_place(name):
    """Every output equals the JAX rule's; the port's outputs are its
    input tensors, updated in place."""
    op = name.split("-")[0]
    ins, attrs = _update_case(name)
    ref = jregistry.get_op_def(op).lower(
        jregistry.LoweringContext(attrs),
        **{k: jnp.asarray(v) for k, v in ins.items()})
    tins = {k: torch.from_numpy(v.copy()) for k, v in ins.items()}
    got = tregistry.get_op_def(op).lower(
        tregistry.LoweringContext(attrs, "cpu"), **tins)
    assert set(got) == set(ref)
    for slot, val in got.items():
        src = slot.replace("Out", "").replace("Accum", "Accumulator")
        assert val is tins[src], slot                 # in place
        np.testing.assert_allclose(val.numpy(), np.asarray(ref[slot]),
                                   rtol=OP_TOL, atol=OP_TOL, err_msg=slot)


def _average_ins(rng, nu, na, old):
    return {"param": _state(rng, 3, 4), "in_sum_1": _state(rng, 3, 4),
            "in_sum_2": _state(rng, 3, 4), "in_sum_3": _state(rng, 3, 4),
            "in_num_accumulates": np.array([na], np.int32),
            "in_old_num_accumulates": np.array([old], np.int32),
            "in_num_updates": np.array([nu], np.int32)}


@pytest.mark.parametrize("counters", [(0, 0, 0), (5, 1, 3), (16383, 4, 2),
                                      (9, 5, 0)], ids=["first", "middle",
                                                       "roll", "trigger"])
def test_average_accumulates_matches_paddle_tpu(counters):
    """The window sums in each branch: plain accumulate, the 16384-update
    roll of sum_1 into sum_2, and the window restart."""
    ins = _average_ins(np.random.RandomState(30), *counters)
    attrs = {"average_window": 0.5, "min_average_window": 2,
             "max_average_window": 3}
    ref = jregistry.get_op_def("average_accumulates").lower(
        jregistry.LoweringContext(attrs),
        **{k: jnp.asarray(v) for k, v in ins.items()})
    tins = {k: torch.from_numpy(v.copy()) for k, v in ins.items()}
    got = tregistry.get_op_def("average_accumulates").lower(
        tregistry.LoweringContext(attrs, "cpu"), **tins)
    for slot, val in got.items():
        assert val is tins[slot.replace("out_", "in_")], slot
        assert val.numpy().dtype == np.asarray(ref[slot]).dtype
        np.testing.assert_allclose(val.numpy(), np.asarray(ref[slot]),
                                   rtol=OP_TOL, atol=OP_TOL, err_msg=slot)


# ---------------------------------------------------------------------------
# optimizer classes, schedules, per-parameter rates and clips, end to end
# ---------------------------------------------------------------------------

def _mlp(pkg, opt, param_attr=None, clip=None):
    """x [8] -> fc 16 relu -> fc 4 -> softmax_with_cross_entropy; `opt`
    (pkg -> Optimizer) minimizes it. Returns (main, startup, loss)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        L = pkg.layers
        x = L.data("x", shape=[8], dtype="float32")
        label = L.data("label", shape=[1], dtype="int64")
        h = L.fc(x, 16, act="relu", param_attr=param_attr)
        loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, 4), label))
        if clip is not None:
            pkg.clip.set_gradient_clip(clip(pkg))
        opt(pkg).minimize(loss)
        pkg.clip.set_gradient_clip(None)
    return main, startup, loss.name


def _feeds(seed, n=5):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(6, 8).astype(np.float32),
             "label": rng.randint(0, 4, (6, 1)).astype(np.int64)}
            for _ in range(n)]


def _train_both(jprog, tprog, feeds, extra_fetch=()):
    """Both programs on the same feeds from the JAX startup's state;
    returns the per-step fetches of each and both scopes."""
    jmain, jstartup, loss = jprog
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    tscope = ptt.io.state_from_numpy(
        {n: np.asarray(jscope.find_var(n)) for n in jscope.local_var_names()},
        ptt.CPUPlace())
    texe = ptt.Executor(ptt.CPUPlace())
    fetch = [loss, *extra_fetch]
    ref, got = [], []
    native.reset_launches()
    for feed in feeds:
        ref.append([np.asarray(r) for r in
                    jexe.run(jmain, feed=feed, fetch_list=fetch,
                             scope=jscope)])
        got.append(texe.run(tprog, feed=feed, fetch_list=fetch,
                            scope=tscope))
    assert not any(native.launches.values())
    return ref, got, jscope, tscope


def _assert_same_state(jscope, tscope, tol=TOL):
    names = list(jscope.local_var_names())
    assert sorted(names) == sorted(tscope.local_var_names())
    for n in names:
        want = np.asarray(jscope.find_var(n))
        got = fetch_var(n, tscope)
        assert got.dtype == want.dtype, n
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=n)


def _check(opt, feeds_seed=40, param_attr=None, clip=None, n_steps=5,
           state_tol=TOL):
    """Same Program JSON, then `n_steps` steps to the same losses and
    state (to `state_tol`); returns the op types of the program."""
    jmain, jstartup, loss = _mlp(fluid, opt, param_attr, clip)
    tmain, tstartup, _ = _mlp(ptt, opt, param_attr, clip)
    assert tmain.to_dict() == jmain.to_dict()
    assert tstartup.to_dict() == jstartup.to_dict()
    ref, got, jscope, tscope = _train_both((jmain, jstartup, loss), tmain,
                                           _feeds(feeds_seed, n_steps))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g[0], r[0], rtol=TOL)
    _assert_same_state(jscope, tscope, state_tol)
    return [op.type for op in tmain.global_block().ops]


OPTIMIZERS = {
    "SGD": lambda p: p.optimizer.SGD(learning_rate=0.1),
    "Adagrad": lambda p: p.optimizer.Adagrad(learning_rate=0.01),
    "Adamax": lambda p: p.optimizer.Adamax(learning_rate=0.01),
    "DecayedAdagrad": lambda p: p.optimizer.DecayedAdagrad(
        learning_rate=0.01),
    "Adadelta": lambda p: p.optimizer.Adadelta(learning_rate=1.0),
    "RMSProp": lambda p: p.optimizer.RMSProp(learning_rate=0.01),
    "RMSProp-centered": lambda p: p.optimizer.RMSProp(
        learning_rate=0.01, momentum=0.9, centered=True),
    "Ftrl": lambda p: p.optimizer.Ftrl(learning_rate=0.1, l1=0.01, l2=0.01),
    "Ftrl-power": lambda p: p.optimizer.Ftrl(learning_rate=0.1, l1=0.01,
                                             lr_power=-0.3),
    "Momentum-L2Decay": lambda p: p.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9,
        regularization=p.regularizer.L2Decay(1e-3)),
}


# decayed_adagrad's first step divides each grad g by 0.22 |g| + 1e-6, so
# for a grad within a few 1e-6 of 0 it turns the float32 summation noise
# of g (both packages' grads agree to ~1e-9) into up to 3e-5 of the update
STATE_TOL = {"DecayedAdagrad": 1e-4}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_paddle_tpu(name):
    types = _check(OPTIMIZERS[name], state_tol=STATE_TOL.get(name, TOL))
    op = {"SGD": "sgd", "Adagrad": "adagrad", "Adamax": "adamax",
          "DecayedAdagrad": "decayed_adagrad", "Adadelta": "adadelta",
          "RMSProp": "rmsprop", "RMSProp-centered": "rmsprop",
          "Ftrl": "ftrl", "Ftrl-power": "ftrl",
          "Momentum-L2Decay": "momentum"}[name]
    assert types.count(op) == 4              # two fcs, weight and bias


def test_short_aliases_are_the_classes():
    o = ptt.optimizer
    for short, cls in (("SGD", o.SGDOptimizer), ("Adagrad", o.AdagradOptimizer),
                       ("Adamax", o.AdamaxOptimizer),
                       ("DecayedAdagrad", o.DecayedAdagradOptimizer),
                       ("Adadelta", o.AdadeltaOptimizer),
                       ("RMSProp", o.RMSPropOptimizer),
                       ("Ftrl", o.FtrlOptimizer), ("Adam", o.AdamOptimizer),
                       ("Momentum", o.MomentumOptimizer)):
        assert getattr(o, short) is cls


SCHEDULES = {
    "exponential_decay": lambda L: L.exponential_decay(0.1, 5, 0.5),
    "natural_exp_decay": lambda L: L.natural_exp_decay(0.1, 5, 0.5),
    "inverse_time_decay": lambda L: L.inverse_time_decay(0.1, 5, 0.5),
    "polynomial_decay": lambda L: L.polynomial_decay(0.1, 20, 0.001, 2.0),
    "piecewise_decay": lambda L: L.piecewise_decay([3, 10, 20],
                                                   [0.1, 0.05, 0.01, 0.001]),
    "noam_decay": lambda L: L.noam_decay(64, 10),
    "exponential_decay-staircase": lambda L: L.exponential_decay(
        0.1, 5, 0.5, staircase=True),
    "polynomial_decay-cycle": lambda L: L.polynomial_decay(
        0.1, 8, 0.001, 2.0, cycle=True),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_paddle_tpu_over_30_steps(name):
    """The schedule drives SGD; its learning rate each step, the step
    counter and the parameters after 30 steps."""
    lr_name = []

    def opt(pkg):
        lr = SCHEDULES[name](pkg.layers)
        lr_name.append(lr.name)
        return pkg.optimizer.SGD(learning_rate=lr)

    jmain, jstartup, loss = _mlp(fluid, opt)
    tmain, _, _ = _mlp(ptt, opt)
    assert tmain.to_dict() == jmain.to_dict()
    assert lr_name[0] == lr_name[1]
    ref, got, jscope, tscope = _train_both(
        (jmain, jstartup, loss), tmain, _feeds(41, 30), [lr_name[0]])
    lrs = np.array([g[1][0] for g in got])
    np.testing.assert_allclose(lrs, [r[1][0] for r in ref], rtol=1e-6)
    assert len(set(lrs.tolist())) > 2             # it decays
    np.testing.assert_array_equal(fetch_var("@LR_DECAY_COUNTER@", tscope),
                                  [30.0])
    _assert_same_state(jscope, tscope)


def test_per_parameter_learning_rate_matches_paddle_tpu():
    """ParamAttr(learning_rate=0.25) on the first fc's weight: its update
    reads the global rate times 0.25 (`Optimizer._lr_for_param`, an
    elementwise_mul by a fill_constant), the other parameters the global
    rate."""
    def attr(pkg):
        return pkg.ParamAttr(name="w_slow", learning_rate=0.25)

    jmain, jstartup, loss = _mlp(fluid, OPTIMIZERS["SGD"], attr(fluid))
    tmain, _, _ = _mlp(ptt, OPTIMIZERS["SGD"], attr(ptt))
    assert tmain.to_dict() == jmain.to_dict()
    gb = tmain.global_block()
    sgd_w = next(op for op in gb.ops if op.type == "sgd"
                 and op.inputs["Param"] == ["w_slow"])
    others = {op.inputs["LearningRate"][0] for op in gb.ops
              if op.type == "sgd" and op.inputs["Param"] != ["w_slow"]}
    assert len(others) == 1
    assert sgd_w.inputs["LearningRate"][0] not in others
    ref, got, jscope, tscope = _train_both((jmain, jstartup, loss), tmain,
                                           _feeds(42))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g[0], r[0], rtol=TOL)
    _assert_same_state(jscope, tscope)


def _lars(pkg):
    main, startup = pkg.Program(), pkg.Program()
    backward = fluid.backward if pkg is fluid else ptt.core.backward
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        L = pkg.layers
        x = L.data("x", shape=[8], dtype="float32")
        label = L.data("label", shape=[1], dtype="int64")
        h = L.fc(x, 16, act="relu", name="larsfc")
        loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, 4), label))
        params_grads = backward.append_backward(loss)
        lr = L.fill_constant([1], "float32", 0.1)
        L.append_LARS(params_grads, lr, weight_decay=1e-4)
        pkg.optimizer.SGD(learning_rate=0.1)._create_optimization_pass(
            params_grads, loss)
    return main, startup, loss.name


def _names_for_variables(program_dict):
    """The program dict with each Variable a parameter's optimize_attr
    holds (append_LARS's per-parameter rate) replaced by its name: the
    two packages' Variables are different objects."""
    for b in program_dict["blocks"]:
        for v in b["vars"]:
            if v.get("optimize_attr"):
                v["optimize_attr"] = {
                    k: getattr(val, "name", val)
                    for k, val in v["optimize_attr"].items()}
    return program_dict


def test_append_LARS_matches_paddle_tpu():
    """append_LARS stores a Variable rate on each parameter, which the
    optimizer reads as it is (`_lr_for_param`'s Variable case)."""
    jmain, jstartup, loss = _lars(fluid)
    tmain, _, _ = _lars(ptt)
    assert _names_for_variables(tmain.to_dict()) == \
        _names_for_variables(jmain.to_dict())
    for p in tmain.global_block().all_parameters():
        assert isinstance(p.optimize_attr["learning_rate"], tir.Variable)
    ref, got, jscope, tscope = _train_both((jmain, jstartup, loss), tmain,
                                           _feeds(43))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g[0], r[0], rtol=TOL)
    _assert_same_state(jscope, tscope)


CLIPS = {
    "GradientClipByValue": lambda p: p.clip.GradientClipByValue(0.02),
    "GradientClipByNorm": lambda p: p.clip.GradientClipByNorm(0.05),
    "GradientClipByGlobalNorm": lambda p: p.clip.GradientClipByGlobalNorm(
        0.1),
}


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_gradient_clip_matches_paddle_tpu(name):
    """Each clip set globally (`set_gradient_clip`) in front of SGD; the
    bounds are small enough that every step clips."""
    types = _check(OPTIMIZERS["SGD"], feeds_seed=44, clip=CLIPS[name])
    want = {"GradientClipByValue": "clip",
            "GradientClipByNorm": "clip_by_norm",
            "GradientClipByGlobalNorm": "elementwise_max"}[name]
    assert want in types


def test_gradient_clip_by_norm_as_a_parameter_attribute():
    """`ParamAttr(gradient_clip=...)` clips that parameter's grad alone."""
    def attr(pkg):
        return pkg.ParamAttr(name="w_clip",
                             gradient_clip=pkg.clip.GradientClipByNorm(0.01))
    jmain, jstartup, loss = _mlp(fluid, OPTIMIZERS["SGD"], attr(fluid))
    tmain, _, _ = _mlp(ptt, OPTIMIZERS["SGD"], attr(ptt))
    assert tmain.to_dict() == jmain.to_dict()
    types = [op.type for op in tmain.global_block().ops]
    assert types.count("clip_by_norm") == 1
    ref, got, jscope, tscope = _train_both((jmain, jstartup, loss), tmain,
                                           _feeds(45))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g[0], r[0], rtol=TOL)
    _assert_same_state(jscope, tscope)


def _error_clip(pkg):
    main, startup = pkg.Program(), pkg.Program()
    backward = fluid.backward if pkg is fluid else ptt.core.backward
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        L = pkg.layers
        x = L.data("x", shape=[8], dtype="float32")
        label = L.data("label", shape=[1], dtype="int64")
        h = L.fc(x, 16, act="relu")
        loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, 4), label))
        params_grads = backward.append_backward(loss)
        block = main.global_block()
        for _, g in params_grads:
            pkg.clip.ErrorClipByValue(0.01).append_clip_op(block, g.name)
        pkg.optimizer.SGD(learning_rate=0.1)._create_optimization_pass(
            params_grads, loss)
    return main, startup, loss.name


def test_error_clip_by_value_matches_paddle_tpu():
    jmain, jstartup, loss = _error_clip(fluid)
    tmain, _, _ = _error_clip(ptt)
    assert tmain.to_dict() == jmain.to_dict()
    assert [op.type for op in tmain.global_block().ops].count("clip") == 4
    ref, got, jscope, tscope = _train_both((jmain, jstartup, loss), tmain,
                                           _feeds(46))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g[0], r[0], rtol=TOL)
    _assert_same_state(jscope, tscope)


def _model_average(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        L = pkg.layers
        x = L.data("x", shape=[8], dtype="float32")
        label = L.data("label", shape=[1], dtype="int64")
        h = L.fc(x, 16, act="relu")
        loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, 4), label))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        ma = pkg.optimizer.ModelAverage(0.5, min_average_window=2,
                                        max_average_window=3)
    return main, startup, loss.name, ma


def test_model_average_apply_and_restore_match_paddle_tpu():
    """7 SGD steps with the window sums (average_accumulates after each
    update), then apply (the parameters hold the window average) and
    restore (the trained values come back), in both packages; the
    applied values also equal a host simulation of
    average_accumulates_op.h."""
    jmain, jstartup, loss, jma = _model_average(fluid)
    tmain, _, _, tma = _model_average(ptt)
    assert tmain.to_dict() == jmain.to_dict()
    assert tma.apply_program.to_dict() == jma.apply_program.to_dict()
    assert tma.restore_program.to_dict() == jma.restore_program.to_dict()
    ref, got, jscope, tscope = _train_both((jmain, jstartup, loss), tmain,
                                           _feeds(47, 7))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g[0], r[0], rtol=TOL)
    _assert_same_state(jscope, tscope)
    counters = [n for n in tscope.local_var_names() if "num_" in n]
    assert counters and all(fetch_var(n, tscope).dtype == np.int32
                            for n in counters)
    params = [p.name for p in tmain.global_block().all_parameters()]
    live = {n: fetch_var(n, tscope).copy() for n in params}
    jexe, texe = fluid.Executor(fluid.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    with jma.apply(jexe, scope=jscope), tma.apply(texe, scope=tscope):
        applied = {n: fetch_var(n, tscope).copy() for n in params}
        for n in params:
            np.testing.assert_allclose(applied[n],
                                       np.asarray(jscope.find_var(n)),
                                       rtol=TOL, atol=TOL, err_msg=n)
            assert not np.allclose(applied[n], live[n]), n
    for n in params:
        np.testing.assert_array_equal(fetch_var(n, tscope), live[n])
    # the window of average_accumulates_op.h, simulated on the host from
    # the parameters after each step
    tscope2 = ptt.io.state_from_numpy(
        {n: np.asarray(v) for n, v in _startup_arrays(jstartup).items()},
        ptt.CPUPlace())
    post = []
    for feed in _feeds(47, 7):
        texe.run(tmain, feed=feed, scope=tscope2)
        post.append({n: fetch_var(n, tscope2).copy() for n in params})
    s1 = s2 = s3 = 0.0
    na = old = nu = 0
    for step in post:
        nu += 1
        na += 1
        s1 = s1 + np.stack([step[n].ravel()[:1] for n in params])
        if na >= 2 and na >= min(3, int(nu * 0.5)):
            s3, s1, s2, old, na = s1 + s2, 0.0, 0.0, na, 0
    expected = (s1 + s2 + s3) / (na + old)
    np.testing.assert_allclose(
        np.stack([applied[n].ravel()[:1] for n in params]), expected,
        rtol=1e-5)


def _startup_arrays(jstartup):
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(jstartup, scope=scope)
    return {n: np.asarray(scope.find_var(n)) for n in scope.local_var_names()}
