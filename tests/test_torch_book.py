"""The Fluid book in paddle_tpu_torch against paddle_tpu, on the CPU.

Each of the nine chapters is built by ``tools/torch_book.py``'s function,
the one that ``chip_smoke.py`` phase 7j builds the card's programs with,
at tests/test_book.py's sizes (`torch_book.SMALL`), once with each
package. The two programs are the same but for the index dtype (int32
in the x32 JAX package, int64 in the port: ``core/types.py``). Both
start from the JAX startup's state and train on the same batches, each
read from its own package's `dataset` through its own `reader.batch`
and `DataFeeder`. Then the port runs the book's cycle tail:
save_inference_model, load_inference_model, one inference batch.

Tolerances: the first step's loss within 1e-5 relative and each
parameter grad within 1e-5 of its tensor's largest magnitude (float32
sums in another order); the later steps' losses within 1e-4 relative;
inference outputs within 1e-4 relative of the JAX package's run on its
own trained state, Viterbi paths equal.

The ops the book adds (`cos_sim`, `linear_chain_crf`, `crf_decoding`)
are held against the JAX rules at their edges: a one-row Y and an
all-zero row and a row whose norms' product falls below the 1e-12 clamp
for `cos_sim` (both packages give NaN grads for the zero row, sqrt's
grad at 0); T = 1, length-1 rows among longer ones, padding past
the lengths and a given `Label` for the CRF pair.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as ptt
from paddle_tpu_torch.ops import native

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import torch_book as book  # noqa: E402

STEPS = 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(pkg, name, w):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        chapter = book.build(pkg, name, w)
    return main, startup, chapter


def _assert_same_but_index_dtypes(jprog, tprog):
    """The programs' JSON equal, but where the JAX package declares an
    int32 var that the port declares int64."""
    a, b = jprog.to_dict(), tprog.to_dict()
    for ba, bb in zip(a["blocks"], b["blocks"]):
        vb = {v["name"]: v for v in bb["vars"]}
        for v in ba["vars"]:
            if v != vb[v["name"]]:
                assert (v["dtype"], vb[v["name"]]["dtype"]) == \
                    ("int32", "int64"), v["name"]
                vb[v["name"]]["dtype"] = "int32"
    assert a == b


def _feeds_equal(jf, tf):
    assert sorted(jf) == sorted(tf)
    for n, v in jf.items():
        for x, y in zip(*((v, tf[n]) if isinstance(v, tuple)
                          else ((v,), (tf[n],)))):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=n)


def _close(got, ref, rtol, what):
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - ref).max()) / scale
    assert err <= rtol, f"{what}: {err} > {rtol}"


def _trained_pair(name):
    """Both packages' chapter `name` after STEPS steps from one state on
    the same batches; returns (jax side, port side), each a dict."""
    w = book.SMALL[name]
    jm, js, jch = _build(fluid, name, w)
    tm, ts, tch = _build(ptt, name, w)
    _assert_same_but_index_dtypes(jm, tm)
    _assert_same_but_index_dtypes(js, ts)

    jexe = fluid.Executor(fluid.CPUPlace())
    jscope = fluid.Scope()
    jexe.run(js, scope=jscope)
    for n, v in book.init_values(fluid, name).items():
        jscope.set_var(n, jnp.asarray(v))
    state = {n: np.asarray(jscope.find_var(n))
             for n in jscope.local_var_names()}
    texe = ptt.Executor(ptt.CPUPlace())
    tscope = ptt.io.state_from_numpy(state, ptt.CPUPlace())

    params = [p.name for p in jm.global_block().all_parameters()
              if p.trainable]
    assert params
    fetch = [jch.loss.name] + [p + "@GRAD" for p in params]
    jdf = book.feeder(fluid, jch, fluid.CPUPlace(), jm)
    tdf = book.feeder(ptt, tch, ptt.CPUPlace(), tm)
    jfeeds = [book.feed(jch, jdf, rows)
              for rows in book.batches(fluid, name, w, STEPS)]
    tfeeds = [book.feed(tch, tdf, rows)
              for rows in book.batches(ptt, name, w, STEPS)]
    native.reset_launches()
    for step, (jf, tf) in enumerate(zip(jfeeds, tfeeds)):
        _feeds_equal(jf, tf)
        ref = jexe.run(jm, feed=jf, fetch_list=fetch, scope=jscope)
        got = texe.run(tm, feed=tf, fetch_list=fetch, scope=tscope)
        assert np.isfinite(np.asarray(got[0])).all()
        _close(got[0], ref[0], 1e-5 if step == 0 else 1e-4,
               f"{name} step {step} loss")
        if step == 0:
            for p, r, g in zip(params, ref[1:], got[1:]):
                _close(g, r, 1e-5, f"{name} {p}@GRAD")
    assert not any(native.launches.values())
    return (dict(exe=jexe, scope=jscope, main=jm, chapter=jch,
                 feed=jfeeds[0]),
            dict(exe=texe, scope=tscope, main=tm, chapter=tch,
                 feed=tfeeds[0]))


def _cycle(pkg, side, dirname):
    """The book's cycle tail (tests/test_book.py:_cycle): save the
    inference model, load it, run one batch."""
    ch = side["chapter"]
    pkg.io.save_inference_model(str(dirname), ch.infer_feeds, ch.targets,
                                side["exe"], main_program=side["main"],
                                scope=side["scope"])
    scope = pkg.Scope()
    prog, feed_names, fetches = pkg.io.load_inference_model(
        str(dirname), side["exe"], scope=scope)
    assert feed_names == ch.infer_feeds
    outs = side["exe"].run(prog, feed=book.infer_feed(ch, side["feed"]),
                           fetch_list=fetches, scope=scope)
    for o in outs:
        assert np.isfinite(np.asarray(o, np.float64)).all()
    return [np.asarray(o) for o in outs]


@pytest.mark.parametrize("name", book.CHAPTERS)
def test_chapter_trains_and_infers_as_paddle_tpu(name, tmp_path):
    jax_side, port_side = _trained_pair(name)
    got = _cycle(ptt, port_side, tmp_path / "port")
    ref = _cycle(fluid, jax_side, tmp_path / "jax")
    agree = port_side["chapter"].agree
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        if agree == "equal":
            np.testing.assert_array_equal(g, r)
            continue
        _close(g, r, 1e-4, f"{name} inference")
        if agree == "top1":
            np.testing.assert_array_equal(g.argmax(-1), r.argmax(-1))


def test_jax_saved_srl_inference_dir_gives_the_port_its_viterbi_paths(
        tmp_path):
    """An SRL inference dir saved by the JAX package (`crfw` among its
    parameters) loads into the port: the same Viterbi paths, and the
    emissions within 1e-5 relative."""
    name = "label_semantic_roles"
    w = book.SMALL[name]
    jm, js, ch = _build(fluid, name, w)
    jexe = fluid.Executor(fluid.CPUPlace())
    jscope = fluid.Scope()
    jexe.run(js, scope=jscope)
    for n, v in book.init_values(fluid, name).items():
        jscope.set_var(n, jnp.asarray(v))
    crf = next(op for op in jm.global_block().ops
               if op.type == "crf_decoding")
    emission = jm.global_block().var(crf.inputs["Emission"][0])
    fluid.io.save_inference_model(str(tmp_path), ch.infer_feeds,
                                  ch.targets + [emission], jexe,
                                  main_program=jm, scope=jscope)
    rows, = book.batches(fluid, name, w, 1)
    feed = book.infer_feed(ch, book.feed(
        ch, book.feeder(fluid, ch, fluid.CPUPlace(), jm), rows))
    jscope = fluid.Scope()
    jprog, _, jfetch = fluid.io.load_inference_model(str(tmp_path), jexe,
                                                     scope=jscope)
    ref = jexe.run(jprog, feed=feed, fetch_list=jfetch, scope=jscope)
    texe = ptt.Executor(ptt.CPUPlace())
    tscope = ptt.Scope()
    tprog, names, tfetch = ptt.io.load_inference_model(str(tmp_path), texe,
                                                       scope=tscope)
    assert names == ch.infer_feeds
    assert "crfw" in tscope.local_var_names()
    got = texe.run(tprog, feed=feed, fetch_list=tfetch, scope=tscope)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))
    assert np.asarray(got[0]).any()
    _close(got[1], ref[1], 1e-5, "SRL emissions")


# ---------------------------------------------------------------------------
# the three ops at their edges
# ---------------------------------------------------------------------------

def _run_both(build, feed, fetch_of, params):
    """Build with paddle_tpu's layers, run it; parse its JSON in the port
    and run that on the same feed and `params`; returns both fetches."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss = build(fluid)
        fluid.backward.append_backward(loss)
    fetch = fetch_of(main)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    for n, v in params.items():
        scope.set_var(n, jnp.asarray(v))
    ref = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    got = ptt.Executor(ptt.CPUPlace()).run(
        ptt.Program.parse_from_string(main.serialize_to_string()),
        feed=feed, fetch_list=fetch,
        scope=ptt.io.state_from_numpy(params, ptt.CPUPlace()))
    return [np.asarray(r) for r in ref], [np.asarray(g) for g in got]


def _cos_sim_case(y_rows):
    rng = np.random.RandomState(4)
    x = rng.randn(5, 6).astype(np.float32)
    x[2] = 0.0                                   # an all-zero row
    y = rng.randn(y_rows, 6).astype(np.float32)
    x[3] *= 1e-7
    if y_rows > 1:
        y[3] *= 1e-7                 # row 3's |x| |y| below the 1e-12 clamp

    def build(pkg):
        X = pkg.layers.data("x", shape=[5, 6], append_batch_size=False,
                            stop_gradient=False)
        Y = pkg.layers.data("y", shape=[y_rows, 6],
                            append_batch_size=False, stop_gradient=False)
        return pkg.layers.mean(pkg.layers.cos_sim(X, Y))

    def fetch(main):
        op = next(o for o in main.global_block().ops if o.type == "cos_sim")
        return [op.outputs[s][0] for s in ("Out", "XNorm", "YNorm")] + \
            ["x@GRAD", "y@GRAD"]

    return build, {"x": x, "y": y}, fetch


@pytest.mark.parametrize("y_rows", [5, 1])
def test_cos_sim_matches_paddle_tpu_with_a_zero_row(y_rows):
    ref, got = _run_both(*_cos_sim_case(y_rows), {})
    assert got[0].shape == (5, 1)
    assert got[0][2, 0] == 0.0
    for r, g in zip(ref, got):
        assert r.shape == g.shape
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-7)
    # the zero row's grad is NaN in both (sqrt's grad at 0), and only it
    assert np.isnan(got[3][2]).all()
    assert np.isfinite(np.delete(got[3], 2, 0)).all()
    assert np.isfinite(got[4]).all()


def _crf_case(T, lens, label, pad=30.0):
    rng = np.random.RandomState(T * 10 + len(lens))
    B, N = len(lens), 5
    em = rng.randn(B, T, N).astype(np.float32)
    lab = rng.randint(0, N, (B, T, 1)).astype(np.int64)
    lens = np.array(lens, np.int32)
    # what lies past a row's length must not count
    for b, n in enumerate(lens):
        em[b, n:] = pad
        lab[b, n:] = N - 1
    w = (rng.randn(N + 2, N) * 0.5).astype(np.float32)

    def build(pkg):
        e = pkg.layers.data("em", shape=[N], dtype="float32", lod_level=1,
                            stop_gradient=False)
        y = pkg.layers.data("lab", shape=[1], dtype="int64", lod_level=1)
        cost = pkg.layers.linear_chain_crf(
            e, y, param_attr=pkg.ParamAttr(name="crfw"))
        pkg.layers.crf_decoding(e, param_attr=pkg.ParamAttr(name="crfw"))
        if label:
            pkg.layers.crf_decoding(e, param_attr="crfw", label=y)
        return pkg.layers.mean(cost)

    def fetch(main):
        ops = main.global_block().ops
        crf = next(o for o in ops if o.type == "linear_chain_crf")
        dec = [o.outputs["ViterbiPath"][0] for o in ops
               if o.type == "crf_decoding"]
        return [crf.outputs[s][0] for s in
                ("LogLikelihood", "Alpha", "EmissionExps",
                 "TransitionExps")] + dec + ["em@GRAD", "crfw@GRAD"]

    return build, {"em": (em, lens), "lab": (lab, lens)}, fetch, {"crfw": w}


@pytest.mark.parametrize("T,lens,label", [
    (1, [1, 1, 1], False),
    (1, [1, 1], True),
    (6, [6, 1, 3, 1], False),
    (6, [1, 6, 2], True),
    (4, [4, 4], True),
])
def test_crf_pair_matches_paddle_tpu(T, lens, label):
    build, feed, fetch, params = _crf_case(T, lens, label)
    ref, got = _run_both(build, feed, fetch, params)
    n_paths = 2 if label else 1
    floats = list(range(4)) + [len(ref) - 2, len(ref) - 1]
    for i, (r, g) in enumerate(zip(ref, got)):
        assert r.shape == g.shape, i
        if i in floats:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)
        else:
            assert g.dtype == np.int64 and r.dtype == np.int32
            np.testing.assert_array_equal(g, r)
    paths = got[4:4 + n_paths]
    lens = np.asarray(lens)
    for p in paths:
        assert not p[np.arange(T)[None, :] >= lens[:, None]].any()


def test_crf_emission_grad_stays_finite_where_exp_overflows():
    """A fault of the JAX package that the port does not share (ROADMAP
    Queue 3): the JAX rule's unused `EmissionExps` output, exp(e),
    overflows to inf for e > 88.7, and its generic vjp hands that output
    a zero cotangent (paddle_tpu/core/lowering.py:174-180), so exp's vjp
    makes 0 * inf = NaN in the Emission grad there. The port's generic
    grad skips an output that has no grad: its Emission grad is 0 past
    each length, and everything else agrees."""
    build, feed, fetch, params = _crf_case(6, [6, 1, 3, 1], False,
                                           pad=100.0)
    ref, got = _run_both(build, feed, fetch, params)
    lens = feed["em"][1]
    past = np.arange(6)[None, :] >= lens[:, None]
    em_grad_ref, em_grad = ref[-2], got[-2]
    assert np.isnan(em_grad_ref[past]).all()
    assert not np.isnan(em_grad_ref[~past]).any()
    assert (em_grad[past] == 0.0).all()
    np.testing.assert_allclose(em_grad[~past], em_grad_ref[~past],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    np.testing.assert_array_equal(got[4], ref[4])


def test_crf_parameters_run_float32_under_amp():
    """Both ops' rules take float32 under the bf16 policy: the port lists
    `cos_sim` and `linear_chain_crf` in AMP_F32_OPS as the JAX package
    does, and `crf_decoding` upcasts its emissions itself."""
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg
    assert {"cos_sim", "linear_chain_crf"} <= treg.AMP_F32_OPS
    assert treg.AMP_F32_OPS == jreg.AMP_F32_OPS
    build, feed, fetch, params = _crf_case(6, [6, 1, 3, 1], True)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        fluid.backward.append_backward(build(fluid))
    tprog = ptt.Program.from_dict(main.to_dict())
    names = fetch(main)
    exe = ptt.Executor(ptt.CPUPlace())
    plain = exe.run(tprog, feed=feed, fetch_list=names,
                    scope=ptt.io.state_from_numpy(params, ptt.CPUPlace()))
    amp = ptt.Executor(ptt.CPUPlace(), amp=True).run(
        tprog, feed=feed, fetch_list=names,
        scope=ptt.io.state_from_numpy(params, ptt.CPUPlace()))
    for a, b in zip(amp, plain):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_data_feeder_refuses_flat_id_lists_in_both_packages():
    """A fault of the JAX package that the port mirrors (ROADMAP Queue 3):
    a lod var declared `shape=[1]` (declared [-1, -1, 1]) fed a flat list
    of ids a row, as Fluid's DataFeeder takes it and as every dataset
    reader yields it, fails to stack (paddle_tpu/data_feeder.py:78-85:
    the rows become [n, 1], the padded array [B, T]). Rows of [n, 1]
    arrays stack alike in both, which is how tools/torch_book.py feeds
    them."""
    outs = []
    for pkg in (fluid, ptt):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            w = pkg.layers.data("w", shape=[1], dtype="int64", lod_level=1)
        feeder = pkg.DataFeeder([w], pkg.CPUPlace(), program=main)
        with pytest.raises(ValueError, match="broadcast"):
            feeder.feed([([1, 2, 3],), ([4],)])
        outs.append(feeder.feed([(np.array([[1], [2], [3]]),),
                                 (np.array([[4]]),)])["w"])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert outs[1][0].shape == (2, 3, 1)
