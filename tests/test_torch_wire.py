"""The port's fluid-wire and DistributeTranspiler against the JAX
package's, on the CPU.

`paddle_tpu_torch.wire` copies the JAX package's host codecs and error
feedback (numpy only) and writes the `comm_quant_dequant` rule in torch;
`paddle_tpu_torch.transpiler` copies `DistributeTranspiler` and its
dispatchers. Every case runs the same numpy inputs, made from a seed,
through both packages:

- the codecs (raw, bf16, int8 at chunks 1, 7, 64 and 2048, empty and
  all-zero tensors): payloads and dequants bit for bit; the refusals
  raise the same classes;
- `ErrorFeedback`: the same residual streams over ten pushes, replay
  safety under a repeated tag, `state_dict` round trips;
- the `comm_quant_dequant` rule: bit for bit against the host codec, and
  within `tests/test_wire.py`'s atol 1e-7 of the JAX rule called op by
  op (equal there, in fact). The JAX package's jitted step differs: XLA
  multiplies the abs-max by float32(1 / 127) where numpy and the port
  divide, and that product is an ulp off the quotient in some chunks;
  over this file's inputs the jitted rule parts from the codec in up to
  9.54e-07 (one ulp at |x| in [8, 16)), and a numpy emulation of the
  reciprocal reproduces every jitted element (`JIT_RECIPROCAL_MAX_DIFF`);
- `apply_comm_quant`: the same rewritten Program JSON (main and
  startup), the same RuntimeWarning when nothing is rewired, idempotent;
- `DistributeTranspiler` in every mode (collective, collective with
  comm_quant, hybrid, async, sync `runtime="pserver"`) with `RoundRobin`
  and `HashName`: the same trainer Program, specs, grad names, pserver
  Programs and errors;
- a small net trained through the collective path with comm_quant (int8
  and bf16, SGD and Adam) from the same parameters: losses within
  TRAIN_RTOL of the JAX package's, and within the JAX tests' band of the
  unquantized run;
- a 2-rank gloo world (tests/_torch_parallel_worker.py) with
  `BuildStrategy.comm_quant`: in the band of the unquantized run, the
  same collectives (count and bytes), the op run whole;
- a `listen_and_serv` Program is served by `Executor.run` until a
  client stops it (the test keeps its name from when it raised citing
  item 8.4); `comm-float64`
  gives the same findings in both packages; and the float64 Program of
  ROADMAP Queue 3, built by both packages, with its declared dtypes and
  both lints' findings pinned.
"""

import json
import os
import subprocess
import sys
import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import wire as jwire
from paddle_tpu.core import registry as jreg

import paddle_tpu_torch as ptt
from paddle_tpu_torch import wire as twire
from paddle_tpu_torch.core import registry as treg

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PKGS = {"jax": fluid, "port": ptt}
CHUNKS = (1, 7, 64, 2048)
SHAPES = {"37x9": (37, 9), "4097": (4097,), "64x64": (64, 64), "3": (3,),
          "empty": (0,), "zeros": (5, 6)}
# tests/test_wire.py's tolerance between the JAX rule and the host codec
RULE_ATOL = 1e-7
# the largest difference between the JAX package's jitted rule and the
# host codec over this file's inputs: one float32 ulp at |x| in [8, 16)
JIT_RECIPROCAL_MAX_DIFF = 9.5367431640625e-07
# per-step losses of the comm_quant collective path, port vs JAX
# package, from the same parameters: float32 sums in another order (read
# over 6 steps: at most 1.6e-07 relative, SGD and Adam, int8 and bf16)
TRAIN_RTOL = 1e-5
# the JAX tests' band of a quantized run around the unquantized one
# (tests/test_wire.py:591): |q[-1] - ref[-1]| <= 0.1 |ref[0]| + 0.05
BAND = (0.1, 0.05)


def _tensor(shape_key, seed, scale=3.0):
    shape = SHAPES[shape_key]
    if shape_key == "zeros":
        return np.zeros(shape, np.float32)
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _same_payload(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
        return
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            _same_payload(a[k], b[k])
        else:
            assert a[k] == b[k], k


# ---------------------------------------------------------------------------
# the host codecs
# ---------------------------------------------------------------------------

CODEC_CASES = [("raw", 2048), ("bf16", 2048)] + [("int8", c) for c in CHUNKS]


@pytest.mark.parametrize("shape_key", sorted(SHAPES))
@pytest.mark.parametrize("codec,chunk", CODEC_CASES)
def test_codec_payloads_and_dequants_are_the_jax_packages(shape_key, codec,
                                                          chunk):
    x = _tensor(shape_key, seed=chunk)
    jp, jd = jwire.encode_with_dequant(x, codec, name="t", chunk=chunk)
    tp, td = twire.encode_with_dequant(x, codec, name="t", chunk=chunk)
    _same_payload(jp, tp)
    assert jd.tobytes() == td.tobytes() and jd.shape == td.shape
    _same_payload(jwire.encode_tensor(x, codec, chunk=chunk),
                  twire.encode_tensor(x, codec, chunk=chunk))
    if codec != "raw":
        assert twire.decode_tensor(tp).tobytes() == td.tobytes()
        assert twire.payload_nbytes(tp) == jwire.payload_nbytes(jp)
        assert twire.is_encoded(tp) and twire.maybe_decode(tp).tobytes() \
            == jwire.maybe_decode(jp).tobytes()


def _malformed():
    ok = jwire.encode_tensor(np.arange(6, dtype=np.float32), "int8",
                             chunk=4)
    bf = jwire.encode_tensor(np.arange(6, dtype=np.float32), "bf16")
    return {
        "no_codec": {k: v for k, v in ok.items() if k != "codec"},
        "bad_shape": dict(ok, shape="x"),
        "unknown_codec": dict(ok, codec="fp4"),
        "bf16_dtype": dict(bf, data=bf["data"].astype(np.int16)),
        "bf16_size": dict(bf, data=bf["data"][:3]),
        "int8_chunk0": dict(ok, chunk=0),
        "int8_no_scale": dict(ok, scale=None),
        "int8_scale_2d": dict(ok, scale=ok["scale"].reshape(1, -1)),
        "int8_scale_int": dict(ok, scale=ok["scale"].astype(np.int32)),
        "int8_scale_count": dict(ok, scale=ok["scale"][:1]),
        "int8_dtype": dict(ok, data=ok["data"].astype(np.int16)),
    }


@pytest.mark.parametrize("case", sorted(_malformed()))
def test_malformed_frames_raise_the_same_class(case):
    frame = _malformed()[case]
    errs = []
    for w in (jwire, twire):
        with pytest.raises(w.WireCodecError) as e:
            w.decode_tensor(frame)
        errs.append(type(e.value).__name__)
    assert errs[0] == errs[1] == "WireCodecError"


@pytest.mark.parametrize("case", ["inf", "nan", "float64", "unknown",
                                  "float16"])
@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_refusals_raise_the_same_class(case, codec):
    x = np.ones((4, 4), np.float32)
    if case == "inf":
        x[1, 2] = np.inf
    elif case == "nan":
        x[0, 0] = np.nan
    elif case == "float64":
        x = x.astype(np.float64)
    elif case == "float16":
        x = x.astype(np.float16)
    use = "int4" if case == "unknown" else codec
    names = []
    for w in (jwire, twire):
        with pytest.raises(w.WireCodecError) as e:
            w.encode_tensor(x, use, name="grad_w")
        names.append(type(e.value).__name__)
        assert "grad_w" in str(e.value)
    assert names[0] == names[1]
    assert names[0] == ("NonFiniteTensorError" if case in ("inf", "nan")
                        else "WireCodecError")
    assert issubclass(twire.NonFiniteTensorError, twire.WireCodecError)
    assert issubclass(twire.WireCodecError, ValueError)


def test_huge_chunk_frame_decodes_in_o_of_data():
    payload = {"__wire__": 1, "codec": "int8", "shape": [2],
               "dtype": "float32", "chunk": 2 ** 31,
               "scale": np.array([0.5], np.float32),
               "data": np.array([2, -4], np.int8)}
    np.testing.assert_array_equal(twire.decode_tensor(payload),
                                  jwire.decode_tensor(payload))


def test_compression_ratios_and_the_wire_table():
    x = _tensor("64x64", seed=4)
    for codec, lo, hi in (("int8", 3.9, 4.0), ("bf16", 2.0, 2.0)):
        p = twire.encode_tensor(x, codec, chunk=2048)
        r = twire.compression_ratio(x.nbytes, twire.payload_nbytes(p))
        assert r == jwire.compression_ratio(x.nbytes,
                                            jwire.payload_nbytes(p))
        assert lo <= r <= hi
    assert twire.compression_ratio(10, 0) == 0.0
    snap = {twire.RAW_BYTES_METRIC: {"values": {"cmd=push_grad": 4096.0}},
            twire.ENCODED_BYTES_METRIC: {"values": {"cmd=push_grad":
                                                    1032.0}}}
    assert twire.wire_table_from_snapshot(snap) == \
        jwire.wire_table_from_snapshot(snap)
    assert twire.wire_table_from_snapshot({}) == []
    assert (twire.RAW_BYTES_METRIC, twire.ENCODED_BYTES_METRIC) == \
        (jwire.RAW_BYTES_METRIC, jwire.ENCODED_BYTES_METRIC)


def test_wire_table_reads_the_ports_registry():
    from paddle_tpu_torch.observe import metrics
    reg = metrics.Registry()
    assert twire.wire_table(reg) == []
    reg.counter(twire.RAW_BYTES_METRIC).inc(4096.0, cmd="push_grad")
    reg.counter(twire.ENCODED_BYTES_METRIC).inc(1032.0, cmd="push_grad")
    lines = twire.wire_table(reg)
    assert any("push_grad" in ln and "(3.97x)" in ln for ln in lines)
    assert lines[-1].lstrip().startswith("TOTAL")


# ---------------------------------------------------------------------------
# error feedback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["int8", "bf16", "raw"])
def test_error_feedback_streams_are_the_jax_packages(codec):
    rng = np.random.RandomState(9)
    grads = [(rng.randn(300) * 0.1).astype(np.float32) for _ in range(10)]
    grads[3][7] = 2.0     # an outlier coarsens its chunk's scale
    efs = {"jax": jwire.ErrorFeedback(), "port": twire.ErrorFeedback()}
    for step, g in enumerate(grads):
        got = {}
        for k, ef in efs.items():
            payload, commit = ef.encode(("ep", "w"), g, codec, name="w",
                                        chunk=64, tag=("s", step))
            commit()
            res = ef.residual(("ep", "w"))
            got[k] = (payload, None if res is None else res.tobytes())
        _same_payload(got["jax"][0], got["port"][0])
        assert got["jax"][1] == got["port"][1]
    if codec == "raw":
        assert efs["port"].residual(("ep", "w")) is None


def test_error_feedback_is_replay_safe_and_round_trips():
    g = np.array([0.3, -0.7, 0.011], np.float32)
    for w in (jwire, twire):
        ef = w.ErrorFeedback()
        payload, commit = ef.encode("k", g, "int8", tag=("s", 0))
        assert ef.residual("k") is None
        commit()
        r1 = ef.residual("k").copy()
        payload2, commit2 = ef.encode("k", g, "int8", tag=("s", 0))
        commit2()
        np.testing.assert_array_equal(ef.residual("k"), r1)
        _, commit3 = ef.encode("k", g, "int8", tag=("s", 1))
        commit3()
        assert not np.array_equal(ef.residual("k"), r1)
    states = {}
    for name, w in (("jax", jwire), ("port", twire)):
        ef = w.ErrorFeedback()
        for i, ep in enumerate(("a:1", "b:2")):
            _, c = ef.encode((ep, f"w{i}"), g * (i + 1), "int8")
            c()
        states[name] = ef.state_dict()
        back = w.ErrorFeedback()
        back.load_state_dict(states[name])
        assert back.state_dict().keys() == states[name].keys()
        for k in states[name]:
            assert back.state_dict()[k].tobytes() == \
                states[name][k].tobytes()
        back.clear()
        assert back.state_dict() == {}
    assert states["jax"].keys() == states["port"].keys() == {"a:1|w0",
                                                             "b:2|w1"}
    for k in states["jax"]:
        assert states["jax"][k].tobytes() == states["port"][k].tobytes()


# ---------------------------------------------------------------------------
# the comm_quant_dequant rule
# ---------------------------------------------------------------------------

def _port_rule(x, r, codec, chunk, device="cpu"):
    ctx = treg.LoweringContext({"codec": codec, "chunk": chunk}, device)
    out = treg.get_op_def("comm_quant_dequant").lower(
        ctx, torch.tensor(x, device=device), torch.tensor(r, device=device))
    return {k: v.cpu().numpy() for k, v in out.items()}


@pytest.mark.parametrize("shape_key", sorted(SHAPES))
@pytest.mark.parametrize("codec,chunk", CODEC_CASES[1:])
def test_rule_is_the_host_codec_bit_for_bit(shape_key, codec, chunk):
    x = _tensor(shape_key, seed=2)
    r = _tensor(shape_key, seed=3, scale=0.01)
    got = _port_rule(x, r, codec, chunk)
    _, deq = twire.encode_with_dequant(x + r, codec, chunk=chunk)
    assert got["Out"].tobytes() == deq.tobytes()
    assert got["ResidualOut"].tobytes() == ((x + r) - deq).tobytes()
    assert got["Out"].dtype == np.float32 and got["Out"].shape == x.shape


def _reciprocal_codec(x, chunk):
    """The host codec with the abs-max multiplied by float32(1 / 127), as
    the JAX package's jitted step computes it."""
    flat = x.ravel()
    pad = (-flat.size) % chunk
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    xx = flat.reshape(-1, chunk)
    scale = (np.abs(xx).max(axis=1) * np.float32(1.0 / 127.0)).astype(
        np.float32)
    safe = np.where(scale > 0, scale, np.float32(1.0)).astype(np.float32)
    q = np.rint(np.clip(xx / safe[:, None], -127.0, 127.0)).astype(np.int8)
    return (q.astype(np.float32) * safe[:, None]).ravel()[:x.size].reshape(
        x.shape)


def test_rule_against_the_jax_rule_op_by_op_and_jitted():
    rule = jreg.get_op_def("comm_quant_dequant").lower
    worst = {"eager": 0.0, "jit": 0.0}
    for seed, key in enumerate(["37x9", "4097", "64x64", "3"] * 3):
        x = _tensor(key, seed=seed)
        r = _tensor(key, seed=seed + 50, scale=0.01)
        for codec, chunk in [("bf16", 2048)] + [("int8", c) for c in CHUNKS]:
            ctx = jreg.LoweringContext({"codec": codec, "chunk": chunk})
            port = _port_rule(x, r, codec, chunk)
            eager = rule(ctx, jnp.asarray(x), jnp.asarray(r))
            jitted = jax.jit(lambda a, b: rule(ctx, a, b))(
                jnp.asarray(x), jnp.asarray(r))
            for tag, o in (("eager", eager), ("jit", jitted)):
                d = float(np.abs(np.asarray(o["Out"]) - port["Out"]).max())
                worst[tag] = max(worst[tag], d)
            np.testing.assert_allclose(np.asarray(eager["Out"]), port["Out"],
                                       atol=RULE_ATOL, rtol=0)
            np.testing.assert_allclose(np.asarray(eager["ResidualOut"]),
                                       port["ResidualOut"], atol=RULE_ATOL,
                                       rtol=0)
            want = (_reciprocal_codec(x + r, chunk) if codec == "int8"
                    else port["Out"])
            # every jitted element is the reciprocal's (no other source)
            np.testing.assert_array_equal(np.asarray(jitted["Out"]), want)
    assert worst["eager"] == 0.0
    assert worst["jit"] == JIT_RECIPROCAL_MAX_DIFF


def test_rule_is_inferred_on_meta_tensors_as_the_jax_package_infers():
    ins = {"Grad": [((-1, 40), "float32")], "Residual": [((-1, 40),
                                                          "float32")]}
    for attrs in ({"codec": "int8", "chunk": 64}, {"codec": "bf16"}):
        assert treg.infer_op_shapes("comm_quant_dequant", attrs, ins) == \
            jreg.infer_op_shapes("comm_quant_dequant", attrs, ins)
    opdef = treg.get_op_def("comm_quant_dequant")
    assert opdef.propagate_seqlen is False \
        and jreg.get_op_def("comm_quant_dequant").propagate_seqlen is False
    assert "comm_quant_dequant" not in (treg.AMP_BF16_OPS | treg.AMP_F32_OPS
                                        | treg.AMP_DOWNCAST_OPS)
    with pytest.raises(twire.WireCodecError, match="unknown codec"):
        _port_rule(np.ones(3, np.float32), np.zeros(3, np.float32), "fp4",
                   8)


# ---------------------------------------------------------------------------
# apply_comm_quant and DistributeTranspiler
# ---------------------------------------------------------------------------

def _cls_net(pkg, seed=7, opt="sgd"):
    """tests/test_wire.py's classifier."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[16], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="int64")
        h = pkg.layers.fc(input=x, size=32, act="relu")
        logits = pkg.layers.fc(input=h, size=4, act=None)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        (pkg.optimizer.SGD(learning_rate=0.2) if opt == "sgd"
         else pkg.optimizer.Adam(learning_rate=0.01)).minimize(loss)
    main.random_seed = startup.random_seed = seed
    return main, startup, loss


def _cls_batches(n=6):
    rng = np.random.RandomState(0)
    w_true = rng.randn(16, 4).astype(np.float32)
    out = []
    for _ in range(n):
        xs = rng.randn(32, 16).astype(np.float32)
        out.append({"x": xs, "y": (xs @ w_true).argmax(1).astype(np.int64)
                    .reshape(32, 1)})
    return out


def _ctr_net(pkg):
    """A dense net beside a distributed lookup table (the hybrid / async
    plans' sparse half)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        ids = pkg.layers.data(name="ids", shape=[1], dtype="int64")
        x = pkg.layers.data(name="x", shape=[8], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        emb = pkg.layers.embedding(input=ids, size=[1000, 8],
                                   is_distributed=True)
        h = pkg.layers.fc(input=[emb, x], size=16, act="relu")
        pred = pkg.layers.fc(input=h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("codec", ["int8", "bf16"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_apply_comm_quant_rewrites_the_same_program(codec, opt):
    out = {}
    for name, pkg in PKGS.items():
        main, startup, _ = _cls_net(pkg, opt=opt)
        w = pkg.wire
        rewired = w.apply_comm_quant(main, codec=codec, chunk=512,
                                     startup_program=startup)
        again = w.apply_comm_quant(main, codec=codec,
                                   startup_program=startup)
        out[name] = (main.to_dict(), startup.to_dict(), rewired, again,
                     main._version)
    assert out["port"][:4] == out["jax"][:4]
    main_d, startup_d, rewired, again, _ = out["port"]
    assert rewired == ["fc_0.w_0", "fc_0.w_1", "fc_1.w_0", "fc_1.w_1"]
    assert again == []
    ops = [op["type"] for op in main_d["blocks"][0]["ops"]]
    assert ops.count("comm_quant_dequant") == 4
    assert out["port"][4] == out["jax"][4]


def test_apply_comm_quant_writes_zero_residuals_into_a_scope():
    main, startup, _ = _cls_net(ptt)
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope)
    names = twire.apply_comm_quant(main, codec="int8", scope=scope)
    res = sorted(n for n in scope.local_var_names()
                 if n.endswith(twire.graph.RESIDUAL_SUFFIX))
    assert len(res) == len(names) == 4
    for n in res:
        v = np.asarray(scope.find_var(n))
        assert v.dtype == np.float32 and not v.any()


@pytest.mark.parametrize("case", ["no_optimizer", "raw", "bad_codec"])
def test_apply_comm_quant_refusals_and_warnings(case):
    got = []
    for pkg in PKGS.values():
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data(name="x", shape=[4], dtype="float32")
            pkg.layers.fc(input=x, size=2)
        if case == "no_optimizer":
            with pytest.warns(RuntimeWarning, match="entirely inactive") \
                    as rec:
                assert pkg.wire.apply_comm_quant(main, codec="int8") == []
            got.append([str(r.message) for r in rec])
        elif case == "raw":
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                assert pkg.wire.apply_comm_quant(main, codec="raw") == []
                assert pkg.wire.apply_comm_quant(main, codec=None) == []
            got.append(main.to_dict())
        else:
            with pytest.raises(pkg.wire.WireCodecError) as e:
                pkg.wire.apply_comm_quant(main, codec="fp8")
            got.append(str(e.value))
    assert got[0] == got[1]


MODES = ["collective", "collective_int8", "collective_bf16", "hybrid",
         "hybrid_int8", "async", "pserver"]


def _transpile(pkg, mode, split):
    main, startup, _ = _ctr_net(pkg)
    cfg = pkg.DistributeTranspilerConfig()
    cfg.split_method = getattr(pkg.transpiler, split)
    if mode.endswith(("_int8", "_bf16")):
        cfg.comm_quant = mode.rsplit("_", 1)[1]
    if mode == "pserver":
        cfg.runtime = "pserver"
    t = pkg.DistributeTranspiler(cfg)
    eps = "127.0.0.1:6170,127.0.0.1:6171,127.0.0.1:6172"
    kw = dict(program=main, startup_program=startup, trainers="a,b")
    if mode.startswith(("hybrid", "async", "pserver")):
        kw["pservers"] = eps
    if mode.startswith("hybrid"):
        kw["mode"] = "hybrid"
    if mode == "async":
        kw["sync_mode"] = False
    assert t.transpile(1, **kw) is t
    prog = t.get_trainer_program()
    out = {"trainer": prog.to_dict(), "startup": startup.to_dict(),
           "param_specs": t.param_specs, "sparse_specs": t.sparse_specs,
           "grad_names": t.grad_names, "sync_mode": t.sync_mode,
           "startup_for": t.get_startup_program(
               startup_program=startup).to_dict()}
    if mode.startswith("collective"):
        with pytest.raises(NotImplementedError) as e:
            t.get_pserver_program("127.0.0.1:6170")
        out["pserver"] = type(e.value).__name__
    else:
        out["pserver"] = [t.get_pserver_programs(ep).to_dict()
                          for ep in eps.split(",")]
    return out


@pytest.mark.parametrize("split", ["RoundRobin", "HashName"])
@pytest.mark.parametrize("mode", MODES)
def test_distribute_transpiler_plans_as_the_jax_package(mode, split):
    j, t = _transpile(fluid, mode, split), _transpile(ptt, mode, split)
    assert t == j
    ops = [op["type"] for op in t["trainer"]["blocks"][0]["ops"]]
    # six dense optimizer ops: the table's, two fc weights and a bias,
    # then a weight and a bias; the table's moves to the servers but in
    # the collective modes
    if mode in ("async", "pserver"):
        assert "adam" not in ops and len(t["param_specs"]) == 5
        eps = {s["endpoint"] for s in t["param_specs"].values()}
        assert eps <= {"127.0.0.1:6170", "127.0.0.1:6171", "127.0.0.1:6172"}
    if mode.startswith("hybrid"):
        assert ops.count("adam") == 5 and not t["param_specs"]
    if mode.startswith("collective"):
        assert ops.count("adam") == 6
    assert ops.count("comm_quant_dequant") == {
        "collective_int8": 6, "collective_bf16": 6,
        "hybrid_int8": 5}.get(mode, 0)
    if not mode.startswith("collective"):
        assert list(t["sparse_specs"]) == ["embedding_0.w_0"]
        assert t["sparse_specs"]["embedding_0.w_0"]["opt_type"] == "adam"


@pytest.mark.parametrize("case", ["hybrid", "async", "pserver",
                                  "table_without_optimizer"])
def test_distribute_transpiler_errors_as_the_jax_package(case):
    got = []
    for pkg in PKGS.values():
        if case == "table_without_optimizer":
            main, startup = pkg.Program(), pkg.Program()
            with pkg.program_guard(main, startup), pkg.unique_name.guard():
                ids = pkg.layers.data(name="ids", shape=[1], dtype="int64")
                pkg.layers.embedding(input=ids, size=[10, 4],
                                     is_distributed=True)
            kw = dict(pservers="127.0.0.1:1", sync_mode=False)
        else:
            main, startup, _ = _ctr_net(pkg)
            kw = {"hybrid": dict(mode="hybrid"),
                  "async": dict(sync_mode=False), "pserver": {}}[case]
        cfg = pkg.DistributeTranspilerConfig()
        if case == "pserver":
            cfg.runtime = "pserver"
        with pytest.raises(ValueError) as e:
            pkg.DistributeTranspiler(cfg).transpile(0, program=main, **kw)
        got.append(type(e.value).__name__)
    assert got == ["ValueError", "ValueError"]


def test_collective_transpile_marks_big_tables_and_from_env(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINERS", "3")
    got = {}
    for name, pkg in PKGS.items():
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            ids = pkg.layers.data(name="ids", shape=[1], dtype="int64")
            emb = pkg.layers.embedding(input=ids, size=[200, 4])
            loss = pkg.layers.mean(emb)
            pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
            cfg = pkg.DistributeTranspilerConfig()
            cfg.distributed_lookup_threshold = 100
            pkg.DistributeTranspiler(cfg).transpile(0)
            t = pkg.DistributeTranspiler.from_env()
        got[name] = (main.to_dict(), t._trainer_id, t._trainers,
                     main.global_block().var("embedding_0.w_0").sharding)
    assert got["port"] == got["jax"]
    assert tuple(got["port"][3]) == ("mp", None)


def test_dispatchers_as_the_jax_package():
    eps = ["a:1", "b:2", "c:3"]
    names = [f"fc_{i}.w_0" for i in range(9)]
    for cls in ("RoundRobin", "HashName"):
        j = getattr(fluid.transpiler, cls)(eps)
        t = getattr(ptt.transpiler, cls)(eps)
        assert t.dispatch(names) == j.dispatch(names)
        assert t.dispatch_one("x") == j.dispatch_one("x")
        t.reset()
        j.reset()
        assert t.dispatch(names[:2]) == j.dispatch(names[:2])
        assert t.eps == eps
    with pytest.raises(NotImplementedError):
        ptt.transpiler.ps_dispatcher.PSDispatcher(eps).dispatch(names)


# ---------------------------------------------------------------------------
# training through the collective path
# ---------------------------------------------------------------------------

def _collective_losses(pkg, state, codec, opt, steps=6):
    main, startup, loss = _cls_net(pkg, opt=opt)
    cfg = pkg.DistributeTranspilerConfig()
    cfg.comm_quant = codec
    t = pkg.DistributeTranspiler(cfg)
    t.transpile(0, program=main, trainers=1, sync_mode=True,
                startup_program=startup)
    prog = t.get_trainer_program()
    place = pkg.CPUPlace()
    scope = pkg.Scope()
    exe = pkg.Executor(place)
    exe.run(startup, scope=scope)
    res = sorted(n for n in scope.local_var_names()
                 if n.endswith("@COMM_RES"))
    zero = all(not np.asarray(scope.find_var(n)).any() for n in res)
    for n, v in state.items():
        scope.set_var(n, jnp.asarray(v) if pkg is fluid
                      else torch.tensor(v))
    losses = [float(np.asarray(exe.run(prog, feed=b, fetch_list=[loss],
                                       scope=scope)[0]).reshape(-1)[0])
              for b in _cls_batches(steps)]
    moved = [n for n in res if np.asarray(scope.find_var(n)).any()]
    return losses, res, zero, moved


@pytest.mark.parametrize("codec", ["int8", "bf16"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_collective_path_trains_as_the_jax_package(codec, opt):
    main, startup, _ = _cls_net(fluid, opt=opt)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    state = {n: np.asarray(scope.find_var(n))
             for n in scope.local_var_names()}
    jl, jres, jzero, jmoved = _collective_losses(fluid, state, codec, opt)
    tl, tres, tzero, tmoved = _collective_losses(ptt, state, codec, opt)
    assert tres == jres and len(tres) == 4 and tzero and jzero
    assert tmoved == jmoved == tres
    np.testing.assert_allclose(tl, jl, rtol=TRAIN_RTOL, atol=0)
    assert np.isfinite(tl).all() and tl[-1] < tl[0]
    ref, _, _, _ = _collective_losses(ptt, state, None, opt)
    assert abs(tl[-1] - ref[-1]) <= BAND[0] * abs(ref[0]) + BAND[1]


def test_parallel_executor_comm_quant_one_rank_is_the_executors():
    """BuildStrategy.comm_quant on a one-rank mesh: the Executor's step on
    the same rewritten Program, bit for bit; no unexpected plan build."""
    from paddle_tpu_torch import observe
    main, startup, loss = _cls_net(ptt, opt="adam")
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope)
    state = {n: scope.find_var(n).numpy().copy()
             for n in scope.local_var_names()}
    observe.reset_all()
    ptt.set_flag("observe", True)
    try:
        bs = ptt.BuildStrategy()
        bs.comm_quant = "int8"
        pe = ptt.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                  main_program=main, scope=scope,
                                  build_strategy=bs)
        got = [float(pe.run(feed=b, fetch_list=[loss.name])[0].reshape(-1)
                     [0]) for b in _cls_batches()]
        unexpected = observe.observatory().unexpected()
    finally:
        ptt.set_flag("observe", False)
        observe.reset_all()
    assert unexpected == []
    assert sum(op.type == "comm_quant_dequant"
               for op in main.global_block().ops) == 4
    s2 = ptt.io.state_from_numpy(state, ptt.CPUPlace())
    for n in scope.local_var_names():
        if n.endswith("@COMM_RES"):
            s2.set_var(n, torch.zeros(scope.find_var(n).shape))
    exe = ptt.Executor(ptt.CPUPlace())
    want = [float(exe.run(main, feed=b, fetch_list=[loss],
                          scope=s2)[0].reshape(-1)[0])
            for b in _cls_batches()]
    assert got == want


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------

def _free_ports(n):
    import socket
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


@pytest.fixture(scope="module")
def wire_world(tmp_path_factory):
    """One 2-rank gloo world: the tiny Transformer of
    tests/test_torch_parallel.py over dp2 with and without comm_quant,
    from the JAX startup's state."""
    d = tmp_path_factory.mktemp("wire_world")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, fetches = fluid.models.transformer.build(
            src_vocab_size=64, trg_vocab_size=64, seq_len=32, n_layer=2,
            n_head=2, d_model=32, d_inner=64, dropout_rate=0.0,
            fused_attention=True)
        fluid.optimizer.Momentum(learning_rate=0.05, momentum=0.9).minimize(
            fetches["loss"])
    main.random_seed = startup.random_seed = 7
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    np.savez(d / "momentum.npz", **{n: np.asarray(scope.find_var(n))
                                    for n in scope.local_var_names()})
    cases = [dict(name=f"dp2_{q or 'raw'}", kind="trajectory", world=2,
                  mesh=[2], axes=["dp"], optimizer="momentum",
                  state="momentum.npz", comm_quant=q)
             for q in (None, "int8", "bf16")]
    job = d / "job.json"
    job.write_text(json.dumps({"dir": str(d), "cases": cases}))
    eps = ",".join(f"127.0.0.1:{p}" for p in _free_ports(2))
    procs = []
    for r in range(2):
        env = dict(os.environ, PADDLE_TRAINER_ID=str(r), PADDLE_TRAINERS="2",
                   PADDLE_TRAINER_ENDPOINTS=eps, OMP_NUM_THREADS="1",
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_torch_parallel_worker.py"),
             str(job)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=400)[0].decode())
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0].decode())
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [json.loads((d / f"rank{r}_2.json").read_text())
            for r in range(2)]


@pytest.mark.parametrize("codec", ["int8", "bf16"])
def test_two_ranks_with_comm_quant_stay_in_the_band(wire_world, codec):
    for res in wire_world:
        raw, q = res["dp2_raw"], res[f"dp2_{codec}"]
        assert "failed" not in q, q.get("failed")
        assert "failed" not in raw, raw.get("failed")
        ref = raw["losses"]
        assert np.isfinite(q["losses"]).all()
        assert abs(q["losses"][-1] - ref[-1]) <= BAND[0] * abs(ref[0]) \
            + BAND[1]
        # the op quantizes the whole, all-reduced gradient: the step's
        # collectives are the unquantized step's, count and bytes
        assert q["collectives"] == raw["collectives"]
        assert q["collective_bytes"] == raw["collective_bytes"]
        assert q["inventory"] == raw["inventory"]
        assert q["inventory"].get("all-reduce", 0) > 0
        n = q["comm_quant_ops"]
        assert n > 0 and raw["comm_quant_ops"] == 0
        assert q["replicated_ops"].get("comm_quant_dequant") == n
        assert len(q["residuals"]) == n and max(q["residuals"].values()) > 0
    assert wire_world[0][f"dp2_{codec}"]["losses"] == \
        wire_world[1][f"dp2_{codec}"]["losses"]


# ---------------------------------------------------------------------------
# pserver Programs, the comm-float64 lint, float64 Programs
# ---------------------------------------------------------------------------

def test_a_listen_and_serv_program_raises_citing_item_8_4():
    """A `listen_and_serv` Program (item 8.4, now ported) is served by
    `Executor.run` and by a prepared handle's `run`, blocking until a
    client stops it over the wire; each run then returns []. The
    prepared handle passes `validate="error"` (a host service is no
    step)."""
    from paddle_tpu_torch.pserver import PSClient

    main, startup, _ = _ctr_net(ptt)
    ep = f"127.0.0.1:{_free_ports(1)[0]}"
    t = ptt.DistributeTranspiler()
    t.transpile(0, program=main, pservers=ep, sync_mode=False,
                startup_program=startup)
    prog = t.get_pserver_program(ep)
    exe = ptt.Executor(ptt.CPUPlace())
    handle = exe.prepare(prog, validate="error")
    for run in (lambda: handle.run({}), lambda: exe.run(prog)):
        out = {}
        th = threading.Thread(target=lambda: out.update(ret=run()),
                              daemon=True)
        th.start()
        c = PSClient([ep])
        deadline = time.monotonic() + 60
        while True:
            try:
                assert c._call(ep, "stats")["endpoint"] == ep
                break
            except (ConnectionError, OSError, RuntimeError):
                assert time.monotonic() < deadline, "never served"
                time.sleep(0.05)
        c.stop_all()
        c.close()
        th.join(timeout=60)
        assert not th.is_alive() and out["ret"] == []


def _boundary(pkg, dtype):
    prog = pkg.Program()
    blk = prog.global_block()
    blk.create_var(name="g", shape=(4,), dtype=dtype)
    blk.create_var(name="g@COMM_RES", shape=(4,), dtype=dtype,
                   persistable=True)
    blk.create_var(name="g@COMM_QUANT", shape=(4,), dtype=dtype)
    blk.append_op("comm_quant_dequant",
                  inputs={"Grad": ["g"], "Residual": ["g@COMM_RES"]},
                  outputs={"Out": ["g@COMM_QUANT"],
                           "ResidualOut": ["g@COMM_RES"]},
                  attrs={"codec": "int8", "chunk": 2048})
    return prog


def _findings(pkg, diags):
    return sorted((d.code, d.severity.name, d.block_idx, d.op_idx,
                   d.op_type, d.var) for d in diags)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_comm_float64_lint_gives_the_same_findings(dtype):
    got = {}
    for name, pkg in PKGS.items():
        diags = pkg.analysis.lint_program(_boundary(pkg, dtype))
        got[name] = _findings(pkg, diags)
        hits = [d for d in diags if d.code == "comm-float64"]
        assert bool(hits) == (dtype == "float64")
        assert pkg.analysis.has_errors(diags) == (dtype == "float64")
    assert got["port"] == got["jax"]


def _float64_probe(pkg):
    """ROADMAP Queue 3's probe: data(float64) -> fc(relu) -> mean."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[8], dtype="float64")
        loss = pkg.layers.mean(pkg.layers.fc(input=x, size=4, act="relu"))
    return main, loss


FLOAT64_DECLARED = {
    # the JAX package runs with x64 off: its build-time inference
    # (jax.eval_shape) takes the float64 inputs as float32, so every var
    # an op infers is float32, and fc's bias, made with its pre-bias
    # var's dtype, too. It keeps what the layers declare (x, the weight)
    "jax": {"x": "float64", "fc_0.w_0": "float64", "fc_0.tmp_0": "float32",
            "fc_0.w_1": "float32", "fc_0.tmp_1": "float32",
            "fc_0.tmp_2": "float32", "mean_0.tmp_0": "float32"},
    # the port's meta inference keeps float64 all through: it computes in
    # float64 what the Program declares float64
    "port": {"x": "float64", "fc_0.w_0": "float64", "fc_0.tmp_0": "float64",
             "fc_0.w_1": "float64", "fc_0.tmp_1": "float64",
             "fc_0.tmp_2": "float64", "mean_0.tmp_0": "float64"},
}


def test_a_float64_program_declares_each_packages_own_dtypes():
    """Queue 3's float64 finding, settled as an expected difference: each
    package's Program declares what its own rules compute, and each
    package's lint passes its own Program with no dtype-mismatch. The
    port's lint refuses the JAX-saved Program, whose float32 declarations
    downstream of float64 inputs no port rule produces."""
    progs = {}
    for name, pkg in PKGS.items():
        main, loss = _float64_probe(pkg)
        progs[name] = (main, loss)
        declared = {n: v.dtype for n, v in main.global_block().vars.items()}
        assert declared == FLOAT64_DECLARED[name]
        diags = pkg.analysis.analyze_program(
            main, feed_targets=["x"], fetch_targets=[loss.name], lint=True)
        assert not pkg.analysis.has_errors(diags)
        f64 = sorted(d.var for d in diags if d.code == "float64-on-tpu")
        assert f64 == sorted(n for n, t in FLOAT64_DECLARED[name].items()
                             if t == "float64")
        assert {d.code for d in diags} == {"float64-on-tpu"}
    saved = ptt.Program.parse_from_string(
        progs["jax"][0].serialize_to_string())
    diags = ptt.analysis.analyze_program(
        saved, feed_targets=["x"], fetch_targets=[progs["jax"][1].name],
        lint=True)
    assert _findings(ptt, diags) == sorted(
        [("dtype-mismatch", "ERROR", 0, i, t, v) for i, t, v in (
            (0, "mul", "fc_0.tmp_0"), (1, "elementwise_add", "fc_0.tmp_1"),
            (2, "relu", "fc_0.tmp_2"), (3, "mean", "mean_0.tmp_0"))]
        + [("float64-on-tpu", "WARNING", 0, None, None, v)
           for v in ("x", "fc_0.w_0")])
