"""paddle_tpu_torch's serving slice against paddle_tpu, on the CPU.

The port's generative path (program IR, op rules, executor, model dir,
registry, decode engine) is held against the JAX package on the same
model dir, feeds and parameters, with the JAX package's Pallas kernels run
under the Pallas interpreter (PADDLE_TPU_PALLAS_INTERPRET=1) the way its
own tests run them. The port never imports jax or paddle_tpu; the last
tests here check that.
"""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import serve as jserve
from paddle_tpu.models import tiny_lm as jtiny
from paddle_tpu.serve import batcher as jbatcher
from paddle_tpu.serve import bucketing as jbucketing
from paddle_tpu.serve import kvcache as jkvcache

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.executor import fetch_var
from paddle_tpu_torch.models import tiny_lm as ttiny
from paddle_tpu_torch.serve import batcher as tbatcher
from paddle_tpu_torch.serve import bucketing as tbucketing
from paddle_tpu_torch.serve import kvcache as tkvcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "paddle_tpu_torch")
LOGIT_TOL = 1e-4   # f32 through two layers, summation order


def _interpreted():
    mp = pytest.MonkeyPatch()
    mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    return mp


# ---------------------------------------------------------------------------
# the model: same programs, same generations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["prefill", "decode", "startup"])
def test_tiny_lm_programs_serialize_identically(which):
    """Both builders emit the same Program JSON (ops, attrs, var shapes and
    dtypes), so a dir saved by either package serves in both."""
    idx = {"prefill": 0, "decode": 1, "startup": 2}[which]
    ref = jtiny.build_tiny_lm(prefill_seq_rungs=(128,), max_context=160)
    got = ttiny.build_tiny_lm(prefill_seq_rungs=(128,), max_context=160)
    assert got[idx].to_dict() == ref[idx].to_dict()
    assert got[4] == ref[4]


def _prefill_logits(ver, prompts, rung):
    """One prefill step of all prompts on all-zero block tables: every K/V
    write lands in the trash block, so the served cache is untouched."""
    sig = ver.decode.signature
    tokens = np.zeros((len(prompts), rung), np.int64)
    for r, p in enumerate(prompts):
        tokens[r, :len(p)] = p
    return np.asarray(ver.prepared.run({
        "tokens": tokens,
        "block_tables": np.zeros((len(prompts), sig["max_blocks_per_seq"]),
                                 np.int32),
        "seq_lens": np.array([len(p) for p in prompts], np.int32)})[0])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A tiny_lm dir saved by paddle_tpu, served by both packages'
    `InferenceServer(CPUPlace())`: 3 prompts, 8 new tokens each."""
    mdir = str(tmp_path_factory.mktemp("lm") / "lm")
    sig = jtiny.save_tiny_lm(mdir, prefill_seq_rungs=(128,), max_context=160)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, sig["vocab"], size=n).tolist()
               for n in (5, 40, 100)]
    out = {}
    mp = _interpreted()
    try:
        for name, srv in (
                ("jax", jserve.InferenceServer(fluid.CPUPlace())),
                ("torch", ptt.serve.InferenceServer(ptt.CPUPlace()))):
            try:
                ver = srv.add_model("lm", mdir)
                tokens = [srv.generate("lm", p, max_new_tokens=8).tokens
                          for p in prompts]
                out[name] = (tokens, _prefill_logits(ver, prompts, 128),
                             srv.stats()["models"]["lm"])
            finally:
                srv.close()
    finally:
        mp.undo()
    return out


def test_generate_tokens_equal_paddle_tpu(served):
    ref, got = served["jax"][0], served["torch"][0]
    assert [len(t) for t in got] == [8, 8, 8]
    assert got == ref


def test_prefill_logits_agree_with_paddle_tpu(served):
    ref, got = served["jax"][1], served["torch"][1]
    assert got.shape == ref.shape == (3, 32)
    np.testing.assert_allclose(got, ref, atol=LOGIT_TOL, rtol=0)


def test_generate_step_counts_match_paddle_tpu(served):
    ref, got = served["jax"][2], served["torch"][2]
    for key in ("tokens", "steps", "active_slots", "queued", "kv"):
        assert got[key] == ref[key], key
    assert got["prefill_steps"] == 3   # one per sequential generate


def test_stream_yields_the_generated_tokens_in_order(tmp_path):
    mdir = str(tmp_path / "lm")
    ttiny.save_tiny_lm(mdir, prefill_seq_rungs=(8, 16), max_context=32)
    with ptt.serve.InferenceServer(ptt.CPUPlace()) as srv:
        srv.add_model("lm", mdir)
        stream = srv.submit_stream("lm", [3, 1, 4, 1, 5], max_new_tokens=6)
        streamed = list(stream)
        res = stream.future.result(timeout=60)
        assert streamed == res.tokens
        assert res.tokens == srv.generate("lm", [3, 1, 4, 1, 5],
                                          max_new_tokens=6).tokens
        assert (res.prompt_len, res.finish_reason) == (5, "length")
        with pytest.raises(ptt.serve.BadRequestError, match="rung"):
            srv.submit_generate("lm", [1] * 17)


# ---------------------------------------------------------------------------
# weights carried across
# ---------------------------------------------------------------------------

def _jax_initial_state(sig):
    prefill, decode, startup, logits, _ = jtiny.build_tiny_lm(sig=sig)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    arrays = {n: np.asarray(scope.find_var(n))
              for n in scope.local_var_names()}
    return prefill, decode, logits, arrays


def test_state_from_numpy_round_trip():
    sig = jtiny.default_signature()
    _, _, _, arrays = _jax_initial_state(sig)
    arrays["an_int_table"] = np.arange(12, dtype=np.int32).reshape(3, 4)
    arrays["an_index"] = np.array([7, -1], np.int64)
    scope = ptt.io.state_from_numpy(arrays, ptt.CPUPlace())
    assert sorted(scope.local_var_names()) == sorted(arrays)
    for name, arr in arrays.items():
        t = scope.find_var(name)
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        back = fetch_var(name, scope)
        assert back.dtype == arr.dtype and back.shape == arr.shape
        np.testing.assert_array_equal(back, arr)
    scope.find_var("an_int_table").add_(1)     # the scope owns a copy
    assert arrays["an_int_table"][0, 0] == 0


def test_jax_state_runs_both_steps_like_paddle_tpu():
    """The JAX package's initial parameters, carried into a port scope by
    `state_from_numpy`, run the JAX-built prefill and decode programs
    (cross-loaded from JSON) with the JAX package's logits and KV cache."""
    sig = jtiny.default_signature()
    prefill, decode, (pl, dl), arrays = _jax_initial_state(sig)
    cache_shape = (sig["num_blocks"], sig["block_size"], sig["num_heads"],
                   sig["head_dim"])
    jscope = fluid.Scope()
    for n, a in arrays.items():
        jscope.set_var(n, a)
    for n in sig["cache_vars"]:
        jscope.set_var(n, np.zeros(cache_shape, np.float32))
    tscope = ptt.io.state_from_numpy(
        dict(arrays, **{n: np.zeros(cache_shape, np.float32)
                        for n in sig["cache_vars"]}), ptt.CPUPlace())
    jexe = fluid.Executor(fluid.CPUPlace())
    texe = ptt.Executor(ptt.CPUPlace())
    tprefill = ptt.Program.from_dict(prefill.to_dict())
    tdecode = ptt.Program.from_dict(decode.to_dict())
    rng = np.random.RandomState(5)
    max_b = sig["max_blocks_per_seq"]
    bt = np.zeros((sig["max_slots"], max_b), np.int32)
    bt[0, :2] = [3, 1]
    bt[1, :4] = [2, 4, 5, 6]
    pre = {"tokens": rng.randint(0, sig["vocab"], (2, 16)).astype(np.int64),
           "block_tables": bt[:2].copy(),
           "seq_lens": np.array([6, 16], np.int32)}
    dec = {"tokens": rng.randint(0, sig["vocab"],
                                 (sig["max_slots"], 1)).astype(np.int64),
           "block_tables": bt,
           "seq_lens": np.array([7, 17, 0, 0], np.int32)}
    mp = _interpreted()
    try:
        for prog, tprog, feed, fetch in ((prefill, tprefill, pre, pl),
                                         (decode, tdecode, dec, dl)):
            ref, = jexe.run(prog, feed=feed, fetch_list=[fetch], scope=jscope)
            got, = texe.run(tprog, feed=feed, fetch_list=[fetch.name],
                            scope=tscope)
            np.testing.assert_allclose(got, np.asarray(ref),
                                       atol=LOGIT_TOL, rtol=0)
    finally:
        mp.undo()
    for n in sig["cache_vars"]:
        # block 0 takes padding and inactive-slot writes in an unspecified
        # order on both sides; every other block holds the same K/V
        np.testing.assert_allclose(
            fetch_var(n, tscope)[1:], np.asarray(jscope.find_var(n))[1:],
            atol=1e-5, rtol=0)


def test_check_nan_inf_names_the_same_op_as_paddle_tpu():
    from paddle_tpu import flags as jflags
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        y = fluid.layers.relu(fluid.layers.matmul(x, x, transpose_y=True))
    feed = {"x": np.array([[1, np.nan, 0, 0]], np.float32)}
    msgs = []
    for flags, exe, prog, scope in (
            (jflags, fluid.Executor(fluid.CPUPlace()), main, fluid.Scope()),
            (ptt.flags, ptt.Executor(ptt.CPUPlace()),
             ptt.Program.from_dict(main.to_dict()), ptt.Scope())):
        flags.set_flag("check_nan_inf", True)
        try:
            with pytest.raises(RuntimeError, match="NaN/Inf") as err:
                exe.run(prog, feed=feed, fetch_list=[y.name], scope=scope)
        finally:
            flags.set_flag("check_nan_inf", False)
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]


# ---------------------------------------------------------------------------
# host-side serving pieces, step for step against the reference
# ---------------------------------------------------------------------------

def test_bucket_ladder_matches_paddle_tpu():
    kw = dict(rows=(1, 2, 4), dims={"tokens": {1: (128, 256, 512)}})
    ref, got = jbucketing.BucketLadder(**kw), tbucketing.BucketLadder(**kw)
    for n in range(1, 5):
        assert got.rows_rung(n) == ref.rows_rung(n)
    for extent in (1, 127, 128, 129, 300, 512):
        assert got.dim_rung("tokens", 1, extent) == \
            ref.dim_rung("tokens", 1, extent)
    with pytest.raises(ptt.serve.BadRequestError):
        got.dim_rung("tokens", 1, 513)
    spec = {"tokens": ((-1, -1), "int64"), "seq_lens": ((-1,), "int32")}
    shapes = [{k: (v.shape, v.dtype) for k, v in f.items()}
              for f in tbucketing.warm_feed_shapes(spec, got)]
    assert shapes == [{k: (v.shape, v.dtype) for k, v in f.items()}
                      for f in jbucketing.warm_feed_shapes(spec, ref)]


def test_kv_block_allocator_matches_paddle_tpu():
    args = (13, 4, 4, 3)
    ref, got = jkvcache.PagedKVCache(*args), tkvcache.PagedKVCache(*args)
    script = [("reserve", 0, 10), ("ensure", 0, 5), ("reserve", 1, 16),
              ("ensure", 1, 16), ("ensure", 0, 9), ("free", 0, 0),
              ("reserve", 2, 7), ("ensure", 2, 7), ("free", 1, 0),
              ("reserve", 0, 3), ("ensure", 0, 3)]
    for op, slot, n in script:
        for alloc in (ref, got):
            if op == "reserve":
                alloc.reserve(slot, n)
            elif op == "ensure":
                alloc.ensure(slot, n)
            else:
                alloc.free_slot(slot)
        np.testing.assert_array_equal(got.block_tables, ref.block_tables)
        assert (got.in_use(), got.available()) == \
            (ref.in_use(), ref.available())
    with pytest.raises(ptt.serve.CacheExhaustedError):
        got.reserve(1, 17)


@pytest.mark.parametrize("admission", ["continuous", "drain"])
def test_slot_scheduler_matches_paddle_tpu(admission):
    ref = jbatcher.SlotScheduler(4, max_queue=3, admission=admission)
    got = tbatcher.SlotScheduler(4, max_queue=3, admission=admission)
    trace = []
    for sched in (ref, got):
        seen = []
        with sched.cond:
            sched.submit_locked("a")
            seen.append(sched.admissible_locked())
            sched.submit_locked("b")
            seen.append(sched.admissible_locked())
            sched.occupy_locked(0, sched.pending.popleft())
            sched.occupy_locked(1, sched.pending.popleft())
            sched.submit_locked("c")
            seen.append(sched.admissible_locked())
            sched.vacate_locked(0)
            seen.append(sched.admissible_locked())
            seen.append(sched.active_count())
        trace.append(seen)
    assert trace[1] == trace[0]


# ---------------------------------------------------------------------------
# the port stands alone and defaults to the card
# ---------------------------------------------------------------------------

def test_default_place_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (ptt.Executor, ptt.serve.InferenceServer, ptt.CUDAPlace):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


_ISOLATION_SCRIPT = r"""
import os, pkgutil, sys, tempfile, importlib
import paddle_tpu_torch as ptt
for m in pkgutil.walk_packages(ptt.__path__, "paddle_tpu_torch."):
    importlib.import_module(m.name)
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.models import tiny_lm, transformer
main, startup = ptt.Program(), ptt.Program()
with ptt.program_guard(main, startup), ptt.unique_name.guard():
    _, fetches = transformer.build(src_vocab_size=16, trg_vocab_size=16,
                                   seq_len=8, n_layer=1, n_head=2,
                                   d_model=32, d_inner=32)
    optimizer.Adam(learning_rate=1e-3).minimize(fetches["loss"])
exe = ptt.Executor(ptt.CPUPlace())
scope = ptt.Scope()
exe.run(startup, scope=scope)
feed = {n: [[1, 2, 3, 4, 5, 6, 7, 8]] for n in ("src_word", "trg_word", "lbl_word")}
assert exe.run(main, feed=feed, fetch_list=[fetches["loss"]], scope=scope)[0] > 0
with tempfile.TemporaryDirectory() as t:
    d = os.path.join(t, "lm")
    tiny_lm.save_tiny_lm(d, prefill_seq_rungs=(8,), max_context=16)
    with ptt.serve.InferenceServer(ptt.CPUPlace()) as srv:
        srv.add_model("lm", d)
        assert len(srv.generate("lm", [1, 2, 3], max_new_tokens=3).tokens) == 3
    d8 = os.path.join(t, "lm8")
    tiny_lm.save_tiny_lm(d8, prefill_seq_rungs=(8,), max_context=16,
                         kv_dtype="int8")
    with ptt.serve.InferenceServer(ptt.CPUPlace()) as srv:
        srv.add_model("lm8", d8)
        assert len(srv.generate("lm8", [1, 2, 3], max_new_tokens=6).tokens) == 6
    def save_mlp(path, scale):
        m, s = ptt.Program(), ptt.Program()
        with ptt.program_guard(m, s), ptt.unique_name.guard():
            x = ptt.layers.data("x", shape=[4], dtype="float32")
            p = ptt.layers.fc(input=x, size=3, act="softmax")
        sc = ptt.Scope()
        exe.run(s, scope=sc)
        for n in sc.local_var_names():
            sc.set_var(n, sc.find_var(n) * scale)
        ptt.io.save_inference_model(path, ["x"], [p], exe, main_program=m,
                                    scope=sc)
    dm, dm2 = os.path.join(t, "mlp"), os.path.join(t, "mlp2")
    save_mlp(dm, 1.0)
    save_mlp(dm2, 2.0)
    with ptt.serve.InferenceServer(ptt.CPUPlace()) as srv:
        v1 = srv.add_model("m", dm, ladder=ptt.serve.BucketLadder(rows=(1, 2)))
        out, = srv.infer("m", {"x": [[1.0, 2.0, 3.0, 4.0]] * 2})
        assert out.shape == (2, 3)
        srv.prepare_swap("m", dm2)
        v2 = srv.commit_swap("m")
        fut = srv.submit("m", {"x": [[1.0, 2.0, 3.0, 4.0]]})
        assert fut.result(timeout=60)[0].shape == (1, 3)
        assert fut.version_id == v2.version_id != v1.version_id
        assert v1.wait_retired(10)
ptt.flags.set_flag("dropout_impl", "pallas")
drop = ptt.Program()
with ptt.program_guard(drop, ptt.Program()), ptt.unique_name.guard():
    x = ptt.layers.data("x", shape=[128], dtype="float32")
    y = ptt.layers.dropout(x, dropout_prob=0.5,
                           dropout_implementation="upscale_in_train")
out, = exe.run(drop, feed={"x": [[1.0] * 128] * 4}, fetch_list=[y],
               scope=ptt.Scope())
assert set(out.reshape(-1).tolist()) == {0.0, 2.0}
from paddle_tpu_torch.layers import learning_rate_scheduler
from paddle_tpu_torch.models import deepfm, se_resnext, vgg
for name in ("paddle_tpu_torch.layers.control_flow",
             "paddle_tpu_torch.layers.math_op_patch",
             "paddle_tpu_torch.layers.tensor", "paddle_tpu_torch.nets",
             "paddle_tpu_torch.ops.control", "paddle_tpu_torch.ops.beam",
             "paddle_tpu_torch.ops.tensor_array",
             "paddle_tpu_torch.models.machine_translation",
             "paddle_tpu_torch.contrib.decoder.beam_search_decoder"):
    assert name in sys.modules, name
from paddle_tpu_torch.models import machine_translation
mt, mt_start = ptt.Program(), ptt.Program()
with ptt.program_guard(mt, mt_start), ptt.unique_name.guard():
    _, mtf = machine_translation.build_infer(dict_size=16, emb_dim=8,
                                             hidden_dim=8, beam_size=2,
                                             max_len=3)
mt_scope = ptt.Scope()
exe.run(mt_start, scope=mt_scope)
ids, = exe.run(mt, feed={"src_word": ([[[3], [4], [5]]] * 2, [3, 1])},
               fetch_list=[mtf["ids"]], scope=mt_scope)
assert ids.shape == (2, 2, 3)
for build in (lambda: vgg.build(), lambda: se_resnext.build(class_dim=10),
              lambda: transformer.build(src_vocab_size=16, trg_vocab_size=16,
                                        seq_len=8, n_layer=1, n_head=2,
                                        d_model=32, d_inner=32,
                                        fused_attention=False)):
    with ptt.program_guard(ptt.Program(), ptt.Program()), \
            ptt.unique_name.guard():
        build()
fm, fm_start = ptt.Program(), ptt.Program()
with ptt.program_guard(fm, fm_start), ptt.unique_name.guard():
    _, f = deepfm.build(num_fields=3, sparse_feature_dim=50,
                        embedding_size=4, dense_dim=2, hidden_sizes=(8,))
    ptt.clip.set_gradient_clip(ptt.clip.GradientClipByGlobalNorm(1.0))
    lr = learning_rate_scheduler.noam_decay(16, 4)
    optimizer.Adagrad(learning_rate=lr).minimize(f["loss"])
    ptt.clip.set_gradient_clip(None)
    ma = optimizer.ModelAverage(0.5, min_average_window=1,
                                max_average_window=2)
fm_scope = ptt.Scope()
exe.run(fm_start, scope=fm_scope)
fm_feed = {"dense_input": [[0.5, 1.0]] * 2, "sparse_input": [[1, 2, 3]] * 2,
           "label": [[1], [0]]}
for _ in range(2):
    assert exe.run(fm, feed=fm_feed, fetch_list=[f["loss"]],
                   scope=fm_scope)[0] > 0
with ma.apply(exe, scope=fm_scope):
    pass
for name in ["paddle_tpu_torch.dataset." + m for m in (
        "common", "image", "mnist", "cifar", "uci_housing", "imdb", "wmt16",
        "imikolov", "movielens", "conll05", "sentiment", "wmt14", "voc2012",
        "flowers", "mq2007")] + ["paddle_tpu_torch.ops.loss_extra",
                                 "paddle_tpu_torch.layers.loss_layers"]:
    assert name in sys.modules, name
assert len(next(ptt.dataset.conll05.test()())) == 9
crf, crf_start = ptt.Program(), ptt.Program()
with ptt.program_guard(crf, crf_start), ptt.unique_name.guard():
    em = ptt.layers.data("em", shape=[3], dtype="float32", lod_level=1)
    lab = ptt.layers.data("lab", shape=[1], dtype="int64", lod_level=1)
    cost = ptt.layers.linear_chain_crf(em, lab, param_attr="crfw")
    path = ptt.layers.crf_decoding(em, param_attr="crfw")
    sim = ptt.layers.cos_sim(ptt.layers.sequence_pool(em, "sum"),
                             ptt.layers.sequence_pool(em, "max"))
crf_scope = ptt.Scope()
exe.run(crf_start, scope=crf_scope)
crf_out = exe.run(crf, feed={"em": ([[[1.0, 2.0, 3.0]] * 2] * 2, [2, 1]),
                             "lab": ([[[1], [2]]] * 2, [2, 1])},
                  fetch_list=[cost, path, sim], scope=crf_scope)
assert crf_out[1].tolist()[1][1] == 0 and crf_out[2].shape == (2, 1)
for name in ("paddle_tpu_torch.ops.extra_nn", "paddle_tpu_torch.ops.detection",
             "paddle_tpu_torch.ops.quantize",
             "paddle_tpu_torch.layers.detection",
             "paddle_tpu_torch.layers.quant"):
    assert name in sys.modules, name
det, det_start = ptt.Program(), ptt.Program()
with ptt.program_guard(det, det_start), ptt.unique_name.guard():
    bx = ptt.layers.data("bx", shape=[3, 4], dtype="float32")
    sc = ptt.layers.data("sc", shape=[2, 3], dtype="float32")
    nms, cnt = ptt.layers.multiclass_nms(bx, sc, keep_top_k=4)
    qx, _ = ptt.layers.fake_quantize(bx)
    rs = ptt.layers.image_resize(ptt.layers.reshape(qx, [-1, 1, 3, 4]),
                                 out_shape=[2, 2])
det_out = exe.run(det, feed={"bx": [[[0, 0, 1, 1], [0, 0, 1, 0.9],
                                     [0.5, 0.5, 1, 1]]],
                             "sc": [[[0.1, 0.2, 0.3], [0.9, 0.8, 0.1]]]},
                  fetch_list=[nms, cnt, rs], scope=ptt.Scope())
assert det_out[1].tolist() == [2] and det_out[2].shape == (1, 1, 2, 2)
for name in ("paddle_tpu_torch.analysis.concurrency",
             "paddle_tpu_torch.analysis.cost_model",
             "paddle_tpu_torch.analysis.diagnostics",
             "paddle_tpu_torch.analysis.shape_infer",
             "paddle_tpu_torch.analysis.verifier",
             "paddle_tpu_torch.transpiler.float16_transpiler",
             "paddle_tpu_torch.transpiler.inference_transpiler",
             "paddle_tpu_torch.transpiler.memory_optimization_transpiler",
             "paddle_tpu_torch.ir_pass"):
    assert name in sys.modules, name
cb, cb_start = ptt.Program(), ptt.Program()
with ptt.program_guard(cb, cb_start), ptt.unique_name.guard():
    im = ptt.layers.data("im", shape=[2, 4, 4], dtype="float32")
    cbn = ptt.layers.batch_norm(ptt.layers.conv2d(im, 3, 3, bias_attr=False),
                                is_test=True)
cb_scope = ptt.Scope()
exe.run(cb_start, scope=cb_scope)
im_feed = {"im": [[[[0.5] * 4] * 4] * 2]}
before, = exe.run(cb, feed=im_feed, fetch_list=[cbn], scope=cb_scope)
assert ptt.ir_pass.apply_pass("verify", cb, fetch_targets=[cbn.name]) is cb
ptt.memory_optimize(cb)
assert ptt.InferenceTranspiler()._fuse_batch_norm(cb, cb_scope) == 1
folded, = exe.prepare(cb, [cbn], cb_scope, validate="error").run(im_feed)
assert abs(folded - before).max() < 1e-5
ptt.transpiler.Float16Transpiler().transpile(cb, scope=cb_scope)
assert exe.run(cb, feed=im_feed, fetch_list=[cbn],
               scope=cb_scope)[0].shape == before.shape
assert ptt.analysis.analyze_source("x = 1\n") == []
from paddle_tpu_torch import observe
ptt.set_flag("observe", True)
pulse_port = observe.start_pulse(0)
exe.run(cb, feed=im_feed, fetch_list=[cbn], scope=cb_scope)
assert observe.get_steplog().phase_summary()["steps"] == 1
assert observe.summary()["memory"]["live"] is False
observe.reset_all()
for name in ("flight", "health", "memory", "pulse", "scrape", "steplog",
             "stitch", "tracer", "xray"):
    assert "paddle_tpu_torch.observe." + name in sys.modules, name
import numpy as np
import paddle_tpu_torch.ark, paddle_tpu_torch.haven, paddle_tpu_torch.pserver
for name in ("pserver.client", "pserver.optim", "pserver.rpc",
             "pserver.server", "pserver.trainer", "haven.log",
             "haven.replication", "ark.retry", "ark.liveness",
             "ark.heartbeat", "ark.chaos"):
    assert "paddle_tpu_torch." + name in sys.modules, name
ps = ptt.layers.ListenAndServ("127.0.0.1:0")
ps_client = ptt.pserver.PSClient([ps.endpoint], comm_quant="int8")
ps_client.init_param(ps.endpoint, "w", np.zeros(4, np.float32), "sgd", 1.0,
                     {})
ps_client.push_grad(ps.endpoint, "w", np.ones(4, np.float32))
assert ps_client.get_param(ps.endpoint, "w").tolist() == [-1.0] * 4
ps_client.close()
ptt.ark.chaos.kill_server(ps)
import tempfile
for name in ("quorum", "quorum.client", "quorum.node", "master",
             "master.client", "master.service"):
    assert "paddle_tpu_torch." + name in sys.modules, name
with tempfile.TemporaryDirectory() as qdir:
    arbiters = [ptt.quorum.QuorumNode("127.0.0.1:0", qdir,
                                      node_id=f"n{i}").start()
                for i in range(3)]
    qc = ptt.quorum.QuorumClient([a.endpoint for a in arbiters])
    lease = qc.campaign("r", "h", lease_s=5.0)
    assert lease.epoch == 1 and qc.renew(lease)
    qc.close()
    m = ptt.master.Master("127.0.0.1:0").start()
    mc = ptt.master.MasterClient(m.endpoint)
    mc.set_dataset([0, 1])
    status, task = mc.get_task()
    assert status == "ok" and mc.task_finished(task["task_id"],
                                               task["epoch"])
    assert mc.stats()["done"] == 1
    mc.close()
    m.stop()
    for a in arbiters:
        a.stop()
for name in ("fleet", "fleet.replica", "fleet.router", "fleet.sparse",
             "fleet.wire", "torrent", "torrent.prefill", "torrent.stream"):
    assert "paddle_tpu_torch." + name in sys.modules, name
with tempfile.TemporaryDirectory() as t:
    d8 = os.path.join(t, "lm8")
    tiny_lm.save_tiny_lm(d8, prefill_seq_rungs=(8,), max_context=16,
                         kv_dtype="int8")
    router = ptt.fleet.FleetRouter(ptt.fleet.RouterConfig(
        lease_s=1.0, poll_interval_s=0.1)).start()
    reps = []
    for rid, role in (("p0", "prefill"), ("d0", "decode")):
        srv = ptt.serve.InferenceServer(ptt.CPUPlace())
        srv.add_model("m", d8)
        reps.append(ptt.fleet.ReplicaServer(
            srv, replica_id=rid, router_endpoint=router.control_endpoint,
            lease_s=1.0, role=role).start())
    import time
    while len(router.ready_members("m")) < 2:
        time.sleep(0.05)
    res = router.generate_torrent("m", [1, 2, 3], max_new_tokens=3)
    assert len(res.tokens) == 3 and res.outs["prefill"]["bytes"] > 0
    for rep in reps:
        rep.close()
    router.close()
import paddle_tpu_torch.capi_runtime as capi_runtime
with tempfile.TemporaryDirectory() as t:
    cmain, cstart = ptt.Program(), ptt.Program()
    with ptt.program_guard(cmain, cstart), ptt.unique_name.guard():
        cy = ptt.layers.fc(ptt.layers.data(name="x", shape=[4],
                                           dtype="float32"), size=3)
    c_scope = ptt.Scope()
    exe.run(cstart, scope=c_scope)
    ptt.io.save_inference_model(t, ["x"], [cy], exe, main_program=cmain,
                                scope=c_scope)
    os.environ[capi_runtime.PLACE_ENV] = "cpu"
    (cname, cdtype, cout), = capi_runtime.create(t).run(
        [("x", (2, 4), "float32", np.ones((2, 4), np.float32).tobytes())])
    assert cname == cy.name and cdtype == "float32" and cout.shape == (2, 3)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print("FOREIGN", bad)
sys.exit(1 if bad else 0)
"""


def test_port_runs_without_jax_or_paddle_tpu_in_the_process():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _ISOLATION_SCRIPT],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FOREIGN []" in proc.stdout


def _foreign_imports(path):
    tree = ast.parse(open(path).read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    return bad


def test_port_sources_import_no_jax_or_paddle_tpu():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
             if f.endswith(".py")]
    files += [os.path.join(REPO, "chip_smoke.py")]
    files += [os.path.join(REPO, "tools", f) for f in (
        "torch_serve_profile.py", "torch_train_profile.py",
        "torch_flash_bwd_bench.py", "torch_book.py",
        "torch_paddle_lint.py", "torch_race_lint.py",
        "torch_op_profile.py", "torch_paddle_plan.py",
        "torch_telemetry_dump.py", "torch_observatory.py",
        "torch_metrics_lint.py", "torch_step_profile.py",
        "torch_wire_bench.py", "torch_quorum_node.py",
        "torch_master_node.py", "torch_ps_worker.py",
        "torch_haven_bench.py", "torch_elastic_bench.py",
        "torch_quorum_bench.py", "torch_chaos_drill.py",
        "torch_fleet_replica.py", "torch_fleet_router.py",
        "torch_torrent_bench.py", "torch_serve_loadgen.py",
        "torch_step_overhead_bench.py", "torch_yardstick_transformer.py")]
    assert len(files) > 20
    for part in ("dataset/mnist.py", "dataset/common.py",
                 "ops/loss_extra.py", "layers/loss_layers.py",
                 "wire/graph.py", "transpiler/distribute_transpiler.py",
                 "pserver/trainer.py", "haven/replication.py",
                 "ark/chaos.py", "quorum/node.py", "quorum/client.py",
                 "master/service.py", "master/client.py",
                 "fleet/replica.py", "fleet/router.py", "fleet/sparse.py",
                 "fleet/wire.py", "torrent/prefill.py",
                 "torrent/stream.py", "capi_runtime.py",
                 "capi/build.py"):
        assert os.path.join(PORT, part) in files, part
    found = {os.path.relpath(f, REPO): _foreign_imports(f) for f in files}
    assert {f: b for f, b in found.items() if b} == {}


# a module named to the embedded interpreter by a C source
_PY_IMPORT = re.compile(r'PyImport_\w*\(\s*"([^"]*)"')


def test_port_native_sources_import_only_the_port():
    """The port's C, C++ and CUDA sources name no module to an embedded
    interpreter but the port's own: `capi.cc` imports
    `paddle_tpu_torch.capi_runtime`, never the JAX package's."""
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
             if f.endswith((".cc", ".h", ".cu", ".cuh"))]
    assert os.path.join(PORT, "capi", "capi.cc") in files
    assert os.path.join(PORT, "csrc", "flash_fwd.cu") in files
    named = {os.path.relpath(f, REPO): _PY_IMPORT.findall(open(f).read())
             for f in files}
    assert named["paddle_tpu_torch/capi/capi.cc"] == [
        "paddle_tpu_torch.capi_runtime"]
    bad = {f: [m for m in ms if m.split(".")[0] != "paddle_tpu_torch"]
           for f, ms in named.items()}
    assert {f: ms for f, ms in bad.items() if ms} == {}


def test_chip_smoke_kernels_line_reads_serve_bases_launches():
    """The kernels line's `serve` counts (flash_fwd, and paged_decode's
    `launches`) read the serve-base phase's `launches`: no later phase of
    `main()` may rebind that name (phase 7l once did, and the line read
    0 for paged_decode)."""
    path = os.path.join(REPO, "chip_smoke.py")
    tree = ast.parse(open(path).read(), path)
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    binds = [n.lineno for n in ast.walk(main)
             if isinstance(n, ast.Assign)
             for t in n.targets if isinstance(t, ast.Name)
             and t.id == "launches"]
    assert len(binds) == 1, binds
