"""The port's parallel plane against the JAX package's.

`paddle_tpu_torch.parallel.ParallelExecutor` runs one Program over a mesh
of torch.distributed ranks (``parallel/spmd.py`` inserts the collectives
GSPMD inserts for the JAX package). Here the ranks are gloo processes on
the CPU, spawned once per world size under the PADDLE_* env protocol
(``tests/_torch_parallel_worker.py``): a 2-rank world runs every 2-rank
case, a 4-rank world every 4-rank case, while this process runs the JAX
package's `ParallelExecutor` on the same meshes of its 8 virtual devices
(tests/conftest.py), from the same parameters (the JAX startup's, handed
over as numpy) and batches, on the tiny Transformer of
tests/test_parallel_modes.py. Loss trajectories agree within rtol 2e-4,
atol 2e-5, the JAX tests' tolerance.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel.parallel_executor import BuildStrategy as JBuild

import paddle_tpu_torch as ptt
from paddle_tpu_torch.parallel import (BuildStrategy, ParallelExecutor,
                                       collective_inventory)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TOL = dict(rtol=2e-4, atol=2e-5)
STEPS = 3


def _build(pkg, optimizer="sgd", dropout=0.0):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, fetches = pkg.models.transformer.build(
            src_vocab_size=64, trg_vocab_size=64, seq_len=32,
            n_layer=2, n_head=2, d_model=32, d_inner=64,
            dropout_rate=dropout, fused_attention=True)
        loss = fetches["loss"]
        opt = (pkg.optimizer.SGD(learning_rate=0.1) if optimizer == "sgd"
               else pkg.optimizer.Momentum(learning_rate=0.05, momentum=0.9))
        opt.minimize(loss)
    main.random_seed = startup.random_seed = 7
    return main, startup, loss


def _batches(n=STEPS):
    rng = np.random.RandomState(3)
    out = []
    for _ in range(n):
        src = rng.randint(1, 64, (8, 32)).astype(np.int32)
        out.append({"src_word": src, "trg_word": src, "lbl_word": src})
    return out


def _jax_state(optimizer, dropout=0.0):
    main, startup, loss = _build(fluid, optimizer, dropout)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    return {n: np.asarray(scope.find_var(n))
            for n in scope.local_var_names()}


def _port_state(optimizer, dropout):
    main, startup, loss = _build(ptt, optimizer, dropout)
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope)
    return {n: scope.find_var(n).numpy().copy()
            for n in scope.local_var_names()}


def _jax_pe(state, optimizer, sizes, axes, reduce=False):
    main, _, loss = _build(fluid, optimizer)
    scope = fluid.Scope()
    for n, v in state.items():
        scope.set_var(n, jnp.asarray(v))
    bs = JBuild()
    if reduce:
        bs.reduce_strategy = JBuild.ReduceStrategy.Reduce
    pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                scope=scope,
                                mesh=jmesh.make_mesh(sizes, axes),
                                build_strategy=bs)
    return [float(np.asarray(pe.run(feed=b, fetch_list=[loss.name])[0])
                  .ravel()[0]) for b in _batches()]


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _spawn(job_path, n):
    eps = ",".join(f"127.0.0.1:{p}" for p in _free_ports(n))
    procs = []
    for r in range(n):
        env = dict(os.environ, PADDLE_TRAINER_ID=str(r),
                   PADDLE_TRAINERS=str(n), PADDLE_TRAINER_ENDPOINTS=eps,
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_torch_parallel_worker.py"),
             job_path], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    return procs


def _collect(d, n, procs):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=400)[0].decode())
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0].decode())
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [json.loads((d / f"rank{r}_{n}.json").read_text())
            for r in range(n)]


CASES = [
    dict(name="dp2_allreduce", kind="trajectory", world=2, mesh=[2],
         axes=["dp"], optimizer="momentum", state="momentum.npz"),
    dict(name="dp2_reduce", kind="trajectory", world=2, mesh=[2],
         axes=["dp"], optimizer="momentum", state="momentum.npz",
         reduce=True),
    dict(name="sp2", kind="trajectory", world=2, mesh=[2], axes=["sp"],
         optimizer="sgd", state="sgd.npz"),
    dict(name="dp2_dropout", kind="trajectory", world=2, mesh=[2],
         axes=["dp"], optimizer="sgd", dropout=0.1,
         state="port_dropout.npz"),
    dict(name="ring", kind="ring", world=2),
    dict(name="sp_dropout", kind="error", world=2, mesh=[2], axes=["sp"],
         dropout=0.1, state="sgd.npz"),
    dict(name="sp_indivisible", kind="error", world=2, mesh=[2],
         axes=["sp"], seq_len=31, state="sgd31.npz"),
    dict(name="dp_indivisible", kind="error", world=2, mesh=[2],
         axes=["dp"], rows=7, state="sgd.npz"),
    dict(name="distributed", kind="distributed", world=2, state="sgd.npz"),
    dict(name="async_feeder", kind="async_feeder", world=2,
         state="sgd.npz"),
    dict(name="dp2_mp2", kind="trajectory", world=4, mesh=[2, 2],
         axes=["dp", "mp"], optimizer="sgd", state="sgd.npz"),
    dict(name="dp1_mp2_sp2", kind="trajectory", world=4, mesh=[1, 2, 2],
         axes=["dp", "mp", "sp"], optimizer="sgd", state="sgd.npz"),
    dict(name="dp2_sp2", kind="trajectory", world=4, mesh=[2, 2],
         axes=["dp", "sp"], optimizer="sgd", state="sgd.npz"),
]

# the JAX package's ParallelExecutor on the same meshes
JAX_REFS = {"dp2_allreduce": ("momentum", [2], ["dp"], False),
            "dp2_reduce": ("momentum", [2], ["dp"], True),
            "sp2": ("sgd", [2], ["sp"], False),
            "dp2_mp2": ("sgd", [2, 2], ["dp", "mp"], False),
            "dp1_mp2_sp2": ("sgd", [1, 2, 2], ["dp", "mp", "sp"], False),
            "dp2_sp2": ("sgd", [2, 2], ["dp", "sp"], False)}


def _jax_ring(arrs, causal):
    from paddle_tpu.ops.pallas_attention import ring_attention
    mesh = jmesh.make_mesh([2], ["sp"])
    q, k, v, do = (jnp.asarray(arrs[n]) for n in ("q", "k", "v", "do"))
    out, vjp = jax.vjp(lambda a, b, c: ring_attention(
        a, b, c, mesh, axis="sp", causal=causal, sm_scale=0.3), q, k, v)
    return [np.asarray(t) for t in (out, *vjp(do))]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every case's per-rank results, and the JAX package's references."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    d = tmp_path_factory.mktemp("worlds")
    np.savez(d / "momentum.npz", **_jax_state("momentum"))
    np.savez(d / "sgd.npz", **_jax_state("sgd"))
    main31, startup31, _ = _build_seq(fluid, 31)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup31, scope=scope)
    np.savez(d / "sgd31.npz", **{n: np.asarray(scope.find_var(n))
                                 for n in scope.local_var_names()})
    port_dropout = _port_state("sgd", 0.1)
    np.savez(d / "port_dropout.npz", **port_dropout)
    rng = np.random.RandomState(5)
    ring = {n: rng.randn(2, 2, 16, 8).astype(np.float32)
            for n in ("q", "k", "v", "do")}
    np.savez(d / "ring.npz", **ring)
    job = d / "job.json"
    job.write_text(json.dumps({"dir": str(d), "cases": CASES}))
    # one world at a time (the 2-rank one while the JAX references run)
    procs = _spawn(str(job), 2)
    refs = {name: _jax_pe(np.load(d / ("momentum.npz" if opt == "momentum"
                                       else "sgd.npz")), opt, sizes, axes,
                          reduce)
            for name, (opt, sizes, axes, reduce) in JAX_REFS.items()}
    refs["ring"] = {c: _jax_ring(ring, c) for c in (False, True)}
    # the port's own single-rank run at dropout 0.1 from the same state
    main, _, loss = _build(ptt, "sgd", 0.1)
    scope = ptt.io.state_from_numpy(port_dropout, ptt.CPUPlace())
    exe = ptt.Executor(ptt.CPUPlace())
    refs["dp2_dropout"] = [float(exe.run(main, feed=b, fetch_list=[loss],
                                         scope=scope)[0][0])
                           for b in _batches()]
    out = {2: _collect(d, 2, procs)}
    out[4] = _collect(d, 4, _spawn(str(job), 4))
    return out, refs


def _build_seq(pkg, seq_len):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, fetches = pkg.models.transformer.build(
            src_vocab_size=64, trg_vocab_size=64, seq_len=seq_len,
            n_layer=2, n_head=2, d_model=32, d_inner=64, dropout_rate=0.0,
            fused_attention=True)
        loss = fetches["loss"]
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _case(worlds, name):
    out, _ = worlds
    case = next(c for c in CASES if c["name"] == name)
    res = [r[name] for r in out[case["world"]]]
    for r in res:
        assert "failed" not in r, r["failed"]
    return res


@pytest.mark.parametrize("name", sorted(JAX_REFS))
def test_trajectory_matches_the_jax_parallel_executor(worlds, name):
    res = _case(worlds, name)
    for r in res:       # every rank fetches the global loss
        np.testing.assert_allclose(r["losses"], worlds[1][name], **TOL)
    assert res[0]["losses"] == res[-1]["losses"]


def test_reduce_holds_the_velocities_in_halves(worlds):
    res = _case(worlds, "dp2_reduce")
    vel = {n: v for n, v in res[0]["layout"].items() if "velocity" in n}
    assert vel, "no velocity accumulator is split"
    for n, v in vel.items():
        assert v["placement"] == [0]
    # each rank holds half of the rows of every split velocity
    main, _, _ = _build(ptt, "momentum")
    for n, v in vel.items():
        full = main.global_block().vars[n].shape
        assert v["local"] == [full[0] // 2] + list(full[1:])
    assert "reduce-scatter" in res[0]["inventory"]


def test_mp_splits_ffn1_columns_and_ffn2_rows(worlds):
    res = _case(worlds, "dp2_mp2")
    main, _, _ = _build(ptt, "sgd")
    block = main.global_block()
    for r in res:
        ffn1 = {n: v for n, v in r["layout"].items()
                if "_ffn1" in n and ".w" in n}
        ffn2 = {n: v for n, v in r["layout"].items()
                if "_ffn2" in n and ".w" in n}
        assert ffn1 and ffn2
        for n, v in ffn1.items():       # mesh axes (dp, mp): mp on dim 1
            assert v["placement"] == [None, 1]
            full = block.vars[n].shape
            assert v["local"] == [full[0], full[1] // 2]
        for n, v in ffn2.items():
            assert v["placement"] == [None, 0]
            assert v["local"] == [block.vars[n].shape[0] // 2,
                                  block.vars[n].shape[1]]
    inv = res[0]["inventory"]
    assert inv["all-gather"] and inv["reduce-scatter"] and inv["all-reduce"]


def test_dp2_dropout_keeps_the_single_device_masks(worlds):
    res = _case(worlds, "dp2_dropout")
    np.testing.assert_allclose(res[0]["losses"], worlds[1]["dp2_dropout"],
                               **TOL)


def test_collective_inventory_of_the_plan(worlds):
    dp = _case(worlds, "dp2_allreduce")[0]
    sp = _case(worlds, "sp2")[0]
    assert dp["inventory"].get("all-reduce", 0) > 0
    assert "collective-permute" not in dp["inventory"]
    assert sp["inventory"]["collective-permute"] > 0
    assert sp["lowered_has_permute"]
    # the ring's shifts: K and V once a ring step (sp - 1 steps), again in
    # the grad's recompute, and once more the other way in its backward
    assert sp["collectives"]["collective-permute"] == 6 * 2 * 3 * STEPS
    # only the constants run whole
    assert set(dp["replicated_ops"]) <= {"sinusoid_pos_encoding",
                                         "fill_constant"}


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_the_jax_ring(worlds, causal):
    res = _case(worlds, "ring")[0][str(causal)]
    for got, want in zip(res, worlds[1]["ring"][causal]):
        np.testing.assert_allclose(np.array(got), want, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("name,etype,words", [
    ("sp_dropout", "NotImplementedError", "sequence parallelism"),
    ("sp_indivisible", "ValueError", "is not divisible by the 2-way 'sp'"),
    ("dp_indivisible", "ValueError",
     "is not divisible by the 2-way data-parallel")])
def test_errors_in_the_jax_packages_words(worlds, name, etype, words):
    for r in _case(worlds, name):
        assert r["type"] == etype and words in r["message"], r


def test_jax_package_raises_the_same_errors():
    """The words above are the JAX package's own."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    main, startup, loss = _build(fluid, "sgd", 0.1)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                scope=scope,
                                mesh=jmesh.make_mesh([2], ["sp"]))
    with pytest.raises(NotImplementedError, match="sequence parallelism"):
        pe.run(feed=_batches(1)[0], fetch_list=[loss.name])
    main, startup, loss = _build(fluid, "sgd")
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                scope=scope,
                                mesh=jmesh.make_mesh([2], ["dp"]))
    feed = {k: v[:7] for k, v in _batches(1)[0].items()}
    with pytest.raises(ValueError, match="not divisible by the 2-way "
                                         "data-parallel"):
        pe.run(feed=feed, fetch_list=[loss.name])


def test_distributed_env_protocol_and_local_shards(worlds):
    res = _case(worlds, "distributed")
    assert [r["rank"] for r in res] == [0, 1]
    for r in res:
        assert r["world"] == 2 and r["backend"] == "gloo"
        assert r["global_rows"] == 8
        np.testing.assert_allclose(r["local"], r["global"], rtol=1e-6)


def test_async_feeder_yields_each_ranks_rows(worlds):
    res = _case(worlds, "async_feeder")
    for rank, r in enumerate(res):
        for got, b in zip(r["rows"], _batches()):
            assert np.array_equal(np.array(got),
                                  b["src_word"][rank * 4:(rank + 1) * 4])
    np.testing.assert_allclose(res[0]["losses"],
                               _case(worlds, "distributed")[0]["global"],
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# one rank, in this process
# ---------------------------------------------------------------------------

def test_one_rank_parallel_executor_is_the_executor_bit_for_bit():
    torch.manual_seed(0)
    state = _port_state("sgd", 0.1)
    main, _, loss = _build(ptt, "sgd", 0.1)
    scope = ptt.io.state_from_numpy(state, ptt.CPUPlace())
    exe = ptt.Executor(ptt.CPUPlace())
    want = [exe.run(main, feed=b, fetch_list=[loss], scope=scope)[0]
            for b in _batches()]
    scope2 = ptt.io.state_from_numpy(state, ptt.CPUPlace())
    pe = ParallelExecutor(use_cuda=False, loss_name=loss.name,
                          main_program=main, scope=scope2)
    got = [pe.run(feed=b, fetch_list=[loss.name])[0] for b in _batches()]
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    for n in scope.local_var_names():
        assert torch.equal(scope.find_var(n), scope2.find_var(n)), n
    assert pe.device_count == 1
    assert collective_inventory(pe.compiled_text(_batches()[0])) == {}


def test_parallel_executor_wants_a_card_unless_told_otherwise():
    main, _, loss = _build(ptt, "sgd")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ParallelExecutor(loss_name=loss.name, main_program=main,
                             scope=ptt.Scope())
    # BuildStrategy.comm_quant (fluid-wire, item 8.3) rewrites the Program
    # before the state is placed, its residuals written into the scope
    # (tests/test_torch_wire.py holds it against the JAX package)
    bs = BuildStrategy()
    bs.comm_quant = "int8"
    scope = ptt.Scope()
    ParallelExecutor(use_cuda=False, loss_name=loss.name,
                     main_program=main, scope=scope, build_strategy=bs)
    ops = [op.type for op in main.global_block().ops]
    assert ops.count("comm_quant_dequant") == ops.count("sgd") > 0
    assert sum(n.endswith("@COMM_RES") for n in scope.local_var_names()) \
        == ops.count("sgd")
    assert BuildStrategy().gradient_scale_strategy is \
        BuildStrategy.GradientScaleStrategy.CoeffNumDevice


def test_trainer_and_inferencer_parallel_match_serial(tmp_path):
    def train_func():
        x = ptt.layers.data("x", shape=[4], dtype="float32")
        y = ptt.layers.data("y", shape=[1], dtype="float32")
        pred = ptt.layers.fc(x, size=1)
        return ptt.layers.mean(ptt.layers.square_error_cost(pred, y))

    def reader():
        rng = np.random.RandomState(0)
        for _ in range(3):
            yield [(rng.randn(4).astype(np.float32),
                    rng.randn(1).astype(np.float32)) for _ in range(4)]

    losses = {}
    for parallel in (False, True):
        got = []
        trainer = ptt.Trainer(train_func,
                              lambda: ptt.optimizer.SGD(learning_rate=0.1),
                              place=ptt.CPUPlace(), parallel=parallel)

        def handler(ev, got=got):
            if isinstance(ev, ptt.EndStepEvent):
                got.append(float(np.asarray(ev.metrics[0]).ravel()[0]))
        trainer.train(1, handler, reader=reader, feed_order=["x", "y"])
        trainer.save_params(str(tmp_path / f"p{int(parallel)}"))
        losses[parallel] = got
    assert losses[True] == losses[False] and len(losses[True]) == 3

    def infer_func():
        x = ptt.layers.data("x", shape=[4], dtype="float32")
        return ptt.layers.fc(x, size=1)

    x = np.random.RandomState(1).randn(4, 4).astype(np.float32)
    outs = [ptt.Inferencer(infer_func, str(tmp_path / "p1"),
                           place=ptt.CPUPlace(), parallel=p).infer({"x": x})
            for p in (False, True)]
    assert np.array_equal(outs[0][0], outs[1][0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ptt.Trainer(train_func,
                        lambda: ptt.optimizer.SGD(learning_rate=0.1),
                        parallel=True)


def test_parallel_do_builds_the_jax_shims_program():
    ops = {}
    for name, pkg in (("jax", fluid), ("port", ptt)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data("x", shape=[4], dtype="float32")
            pd = pkg.layers.ParallelDo(places=None)
            with pd.do():
                xi = pd.read_input(x)
                pd.write_output(pkg.layers.fc(xi, size=3))
            out = pd()
            pkg.layers.mean(out)
        ops[name] = [(op.type, dict(op.inputs), dict(op.outputs))
                     for op in main.global_block().ops]
    assert ops["port"] == ops["jax"]


@pytest.mark.parametrize("n_devices", [4, 8])
@pytest.mark.parametrize("model", ["transformer", "resnet50"])
def test_planner_matches_the_jax_planner(model, n_devices):
    from paddle_tpu.analysis import planner as jplan
    from paddle_tpu_torch.analysis import planner as tplan
    reports = {}
    for name, pkg, plan in (("jax", fluid, jplan), ("port", ptt, tplan)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            if model == "transformer":
                pkg.models.transformer.build(
                    src_vocab_size=1000, trg_vocab_size=1000, seq_len=64,
                    n_layer=2, n_head=8, d_model=256, d_inner=1024)
                shapes = {n: (16, 64) for n in ("src_word", "trg_word",
                                                "lbl_word")}
            else:
                pkg.models.resnet.build(depth=50, class_dim=1000,
                                        data_format="NHWC")
                shapes = {"image": (16, 224, 224, 3), "label": (16, 1)}
        hw = plan.HardwareSpec(**jplan.CPU_REHEARSAL.replace(
            parallel_scaling=1.0).as_dict())
        reports[name] = plan.plan_meshes(main, shapes, n_devices, hw=hw)
    j, t = reports["jax"], reports["port"]
    assert [c.label() for c in t.candidates] == \
        [c.label() for c in j.candidates]
    for a, b in zip(t.candidates, j.candidates):
        assert a.feasible == b.feasible
        np.testing.assert_allclose(a.t_step_s, b.t_step_s, rtol=1e-6)


def test_detect_hardware_on_the_host():
    from paddle_tpu_torch.analysis import planner
    if not torch.cuda.is_available():
        assert planner.detect_hardware() is planner.CPU_REHEARSAL
    assert not hasattr(planner, "TPU_CHIP")
