"""The port's parameter-server plane (``paddle_tpu_torch/pserver``,
``layers.ListenAndServ`` / ``Send`` / ``Recv``, `Executor.run` on a
pserver Program) against the JAX package's, on the CPU.

The servers, the wire, the client and the numpy optimizers are copies;
the trainers drive the port's `Executor`. The cases:

- every case of ``tests/test_pserver.py`` and ``tests/test_dist_train.py``
  against the port, with the same assertions (dense push/pull, Adagrad,
  sparse tables, the restricted unpickler, async fc and DeepFM, sync
  two-trainer parity with the single process, the sync refusals, a
  broken barrier, batch-id dedup, crash + restart from a shard snapshot,
  a shared ids feed, two pserver and two trainer processes, and the
  hybrid collective-dense / PS-sparse composition, here over a one-rank
  mesh: a gloo world of two would be a third process-spawning test);
- across the packages: the port's client against a JAX server and a JAX
  client against the port's server, raw and int8 on the wire, bit-equal
  parameters and rows; the server optimizers bit-equal; the async
  trainer (tiny DeepFM, sparse prefetch) and the sync trainer (a small
  fc net, two trainers) to 1e-5 relative on the losses from the same
  parameters (`io.state_from_numpy`);
- a one-layer fused-attention Transformer through `SyncPSTrainer` (two
  trainers, Adam on the servers) against the port's own `Executor` at
  the whole batch: mean losses to 1e-5 relative, each parameter's
  relative L2 distance <= 1e-4;
- the pull writes into the scope's own tensor; `Send` and `Recv` round
  trip; the unpickler refuses a torch tensor as it refuses `__import__`;
  every quorum route reaches a live group of three arbiters.

One test here starts processes: the two-pserver, two-trainer job (whose
pservers are ``Executor(CPUPlace()).run(get_pserver_program(ep))``,
stopped over the wire, each reporting that it never initialized CUDA);
tests/test_torch_serve.py's import ban covers the new modules in its
own process.
"""

import io
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import pserver as jps

import paddle_tpu_torch as ptt
from paddle_tpu_torch import observe as tobs
from paddle_tpu_torch import pserver as tps
from paddle_tpu_torch.models import deepfm as tdeepfm
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.ops import native
from paddle_tpu_torch.pserver import (AsyncPSTrainer, ParameterServer,
                                      PSClient, SyncPSTrainer, rpc)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": fluid, "port": ptt}
PS = {"jax": jps, "port": tps}
# trainer losses, port vs JAX package, from the same parameters: float32
# sums in another order
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """One torch thread (small CPU ops run far faster on one), and the
    port's telemetry reset around each case (the repo conftest resets
    only the JAX package's)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = ptt.get_flag("observe")
    tobs.reset_all()
    yield
    torch.set_num_threads(n)
    ptt.set_flag("observe", prev)
    tobs.reset_all()


@pytest.fixture
def two_servers():
    servers = [ParameterServer("127.0.0.1:0").start(),
               ParameterServer("127.0.0.1:0").start()]
    yield servers
    for s in servers:
        s.stop()


def _loss(v):
    return float(np.asarray(v).reshape(-1)[0])


# ---------------------------------------------------------------------------
# tests/test_pserver.py's cases, against the port
# ---------------------------------------------------------------------------

def test_dense_push_pull_sgd(two_servers):
    eps = [s.endpoint for s in two_servers]
    c = PSClient(eps)
    w = np.ones((4, 3), np.float32)
    c.init_param(eps[0], "w", w, "sgd", lr=0.5, attrs={})
    c.init_param(eps[0], "w", 7 * w, "sgd", lr=0.5, attrs={})  # idempotent
    g = np.full((4, 3), 2.0, np.float32)
    c.push_grad(eps[0], "w", g)
    out = c.get_param(eps[0], "w")
    np.testing.assert_allclose(out, w - 0.5 * g)  # first init won
    c.close()


def test_dense_adagrad_matches_numpy(two_servers):
    eps = [s.endpoint for s in two_servers]
    c = PSClient(eps)
    w = np.zeros((3,), np.float32)
    c.init_param(eps[1], "w2", w, "adagrad", lr=0.1,
                 attrs={"epsilon": 1e-6})
    ref, acc = w.copy(), np.zeros_like(w)
    for k in range(3):
        g = np.arange(3, dtype=np.float32) + k
        c.push_grad(eps[1], "w2", g)
        acc += g * g
        ref -= 0.1 * g / (np.sqrt(acc) + 1e-6)
    np.testing.assert_allclose(c.get_param(eps[1], "w2"), ref, rtol=1e-5)
    c.close()


def test_sparse_table_prefetch_and_push(two_servers):
    eps = [s.endpoint for s in two_servers]
    c = PSClient(eps)
    c.init_table("tbl", rows=10, width=4, dtype="float32",
                 init_low=-0.5, init_high=0.5, seed=0,
                 opt_type="sgd", lr=1.0, attrs={})
    ids = np.array([3, 7, 2, 3])  # dup id 3: rows return in input order
    rows = c.prefetch_rows("tbl", ids)
    assert rows.shape == (4, 4)
    np.testing.assert_allclose(rows[0], rows[3])
    assert np.all(np.abs(rows) <= 0.5)
    uniq = np.array([2, 3, 7])
    g = np.ones((3, 4), np.float32)
    before = c.prefetch_rows("tbl", uniq)
    c.push_sparse_grad("tbl", uniq, g)
    after = c.prefetch_rows("tbl", uniq)
    np.testing.assert_allclose(after, before - 1.0, rtol=1e-6)
    c.close()


def _send_raw(ep, payload):
    """One hand-made frame to the server; its reply, or None when the
    server dropped the connection (both acceptable refusals)."""
    sock = rpc.connect(ep)
    sock.sendall(rpc._HDR.pack(len(payload)) + payload)
    sock.settimeout(5)
    try:
        return rpc.recv_msg(sock)
    except (ConnectionError, socket.timeout, OSError):
        return None
    finally:
        sock.close()


def test_wire_protocol_rejects_arbitrary_pickle(two_servers):
    """The restricted unpickler must block RCE-style payloads."""
    ep = two_servers[0].endpoint

    class Evil:
        def __reduce__(self):
            return (print, ("pwned",))

    for payload in (pickle.dumps(("stats", {"x": __import__}), protocol=2),
                    pickle.dumps(("stats", {"x": Evil()}))):
        reply = _send_raw(ep, payload)
        assert reply is None or reply[0] in ("err", "ok")
    c = PSClient([ep])
    st = c._call(ep, "stats")
    assert st["endpoint"] == ep
    c.close()


def test_wire_protocol_refuses_a_torch_tensor(two_servers):
    """A torch tensor is no numpy object: the restricted unpickler
    refuses it exactly as it refuses `__import__`, so a trainer must copy
    every card value to host numpy before the wire (it does)."""
    for obj in (("push_grad", {"grad": torch.ones(3)}),
                ("stats", {"x": __import__})):
        with pytest.raises(pickle.UnpicklingError, match="forbids"):
            rpc._RestrictedUnpickler(io.BytesIO(pickle.dumps(obj))).load()
    ep = two_servers[0].endpoint
    c = PSClient([ep])
    c.init_param(ep, "w", np.zeros(3, np.float32), "sgd", 1.0, {})
    reply = _send_raw(ep, pickle.dumps(
        ("push_grad", {"name": "w", "grad": torch.ones(3)})))
    assert reply is None or reply[0] == "err"
    np.testing.assert_array_equal(c.get_param(ep, "w"), np.zeros(3))
    c.close()


def _fc_net(pkg, seed=None, lr=0.1, opt="SGD"):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[8], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="int64")
        h = pkg.layers.fc(input=x, size=16, act="relu")
        logits = pkg.layers.fc(input=h, size=2, act=None)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        getattr(pkg.optimizer, opt)(learning_rate=lr).minimize(loss)
    if seed is not None:
        main.random_seed = startup.random_seed = seed
    return main, startup, loss


def test_async_ps_trainer_fc_model(two_servers):
    """Async PS training of a small classifier: transpile strips the
    optimizer ops, updates happen server-side, loss decreases."""
    eps = ",".join(s.endpoint for s in two_servers)
    main, startup, loss = _fc_net(ptt, seed=0)
    t = ptt.DistributeTranspiler()
    t.transpile(trainer_id=0, program=main, pservers=eps, trainers=1,
                sync_mode=False, startup_program=startup)
    prog = t.get_trainer_program()
    assert not any(op.type == "sgd" for op in prog.global_block().ops)
    assert len(t.param_specs) == 4
    assert {s["endpoint"] for s in t.param_specs.values()} == set(
        eps.split(","))
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    tr = AsyncPSTrainer(t, exe, scope=scope)
    tr.init_params()
    rng = np.random.RandomState(0)
    w = rng.randn(8, 2).astype(np.float32)
    losses = []
    for _ in range(30):
        xs = rng.randn(32, 8).astype(np.float32)
        ys = (xs @ w).argmax(1).astype(np.int64).reshape(32, 1)
        l, = tr.step({"x": xs, "y": ys}, fetch_list=[loss])
        losses.append(_loss(l))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.7, losses
    tr.close()


def _sync_world(pkg, build, batches, scopes, trainers=2, place=None,
                fetch_grads=False):
    """Sync PS training of `build(pkg)` -> (main, startup, loss): two
    servers, `trainers` SyncPSTrainers each on its slice of every batch,
    in threads. `scopes[tid]` is each trainer's started scope. Returns
    (per-trainer losses, the servers' final parameters)."""
    ps = PS["jax" if pkg is fluid else "port"]
    place = place or pkg.CPUPlace()
    servers = [ps.ParameterServer("127.0.0.1:0", trainers=trainers).start()
               for _ in range(2)]
    eps = ",".join(s.endpoint for s in servers)
    built = []
    try:
        for tid in range(trainers):
            main, startup, loss = build(pkg)
            cfg = pkg.DistributeTranspilerConfig()
            cfg.runtime = "pserver"
            t = pkg.DistributeTranspiler(cfg)
            t.transpile(trainer_id=tid, program=main, pservers=eps,
                        trainers=trainers, sync_mode=True,
                        startup_program=startup)
            assert t._sync_ps and t.param_specs
            exe = pkg.Executor(place)
            tr = ps.SyncPSTrainer(t, exe, scope=scopes[tid])
            tr.init_params()
            built.append((tid, t, tr, loss))
        results = {}

        def loop(tid, t, tr, loss):
            try:
                out = []
                for feed in batches:
                    rows = len(next(iter(feed.values()))) // trainers
                    half = {k: v[tid * rows:(tid + 1) * rows]
                            for k, v in feed.items()}
                    l, = tr.step(half, fetch_list=[loss])
                    out.append(_loss(l))
                results[tid] = out
            except BaseException as e:      # surface to the test
                results[tid] = e
                raise

        ths = [threading.Thread(target=loop, args=b, daemon=True)
               for b in built]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=300)
        for tid in range(trainers):
            assert tid in results, f"trainer {tid} never finished"
            assert not isinstance(results[tid], BaseException), results[tid]
        _, t, tr, _ = built[0]
        params = {p: tr.client.get_param(spec["endpoint"], p)
                  for p, spec in t.param_specs.items()}
        return [results[i] for i in range(trainers)], params
    finally:
        for _, _, tr, _ in built:
            tr.close()
        for s in servers:
            s.stop()


def _fc_batches(steps=5, seed=5):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(8, 2).astype(np.float32)
    xs = rng.randn(steps, 32, 8).astype(np.float32)
    ys = (xs @ w_true).argmax(-1).astype(np.int64)[..., None]
    return [{"x": xs[s], "y": ys[s]} for s in range(steps)]


def test_sync_ps_two_trainers_match_single_process():
    """Process-based SYNC parameter servers (reference RunSyncLoop): two
    trainers on half the batch each, a per-batch barrier, the aggregated
    update applied once server-side. With SGD this equals the single
    process on the full batch."""
    batches = _fc_batches()
    build = lambda pkg: _fc_net(pkg, seed=7, lr=0.2)  # noqa: E731
    main_r, startup_r, loss_r = build(ptt)
    scope_r = ptt.Scope()
    exe_r = ptt.Executor(ptt.CPUPlace())
    exe_r.run(startup_r, scope=scope_r)
    ref = [_loss(exe_r.run(main_r, feed=b, fetch_list=[loss_r],
                           scope=scope_r)[0]) for b in batches]
    scopes = []
    for _ in range(2):
        _, startup, _ = build(ptt)
        s = ptt.Scope()
        ptt.Executor(ptt.CPUPlace()).run(startup, scope=s)
        scopes.append(s)
    (l0, l1), params = _sync_world(ptt, build, batches, scopes)
    np.testing.assert_allclose([(a + b) / 2 for a, b in zip(l0, l1)], ref,
                               rtol=1e-4, atol=1e-5)
    for pname, got in params.items():
        np.testing.assert_allclose(got, ptt.fetch_var(pname, scope_r),
                                   rtol=1e-4, atol=1e-5, err_msg=pname)


def test_sync_ps_refuses_sparse_and_collective_runtime_has_no_pserver():
    main, startup, loss = _fc_net(ptt, seed=7)
    t = ptt.DistributeTranspiler()
    t.transpile(trainer_id=0, program=main, pservers="127.0.0.1:6174",
                trainers=1, sync_mode=True, startup_program=startup)
    with pytest.raises(NotImplementedError, match="runtime='pserver'"):
        t.get_pserver_program("127.0.0.1:6174")
    main2, startup2 = ptt.Program(), ptt.Program()
    with ptt.program_guard(main2, startup2), ptt.unique_name.guard():
        ids = ptt.layers.data(name="sids", shape=[2], dtype="int64")
        emb = ptt.layers.embedding(ids, size=[50, 4], is_distributed=True)
        loss2 = ptt.layers.mean(emb)
        ptt.optimizer.SGD(learning_rate=0.1).minimize(loss2)
    cfg = ptt.DistributeTranspilerConfig()
    cfg.runtime = "pserver"
    t2 = ptt.DistributeTranspiler(cfg)
    t2.transpile(trainer_id=0, program=main2, pservers="127.0.0.1:6174",
                 trainers=1, sync_mode=True, startup_program=startup2)
    assert t2.sparse_specs
    with pytest.raises(NotImplementedError, match="dense-only"):
        SyncPSTrainer(t2, ptt.Executor(ptt.CPUPlace()), scope=ptt.Scope())


def test_sync_barrier_break_recovers_cleanly():
    """A straggler past the sync timeout breaks the barrier; the server
    discards the incomplete batch and serves the retry with both
    trainers' fresh gradients applied exactly once."""
    srv = ParameterServer("127.0.0.1:0", trainers=2,
                          sync_timeout=1.5).start()
    try:
        c = PSClient([srv.endpoint])
        w0 = np.zeros((3,), np.float32)
        c.init_param(srv.endpoint, "w", w0, "sgd", lr=1.0, attrs={})
        c.push_grads_sync({srv.endpoint: {"w": np.ones(3, np.float32)}})
        with pytest.raises(RuntimeError, match="barrier broken"):
            c.sync_apply([srv.endpoint])
        np.testing.assert_array_equal(c.get_param(srv.endpoint, "w"), w0)
        errs = []

        def trainer(g):
            try:
                cc = PSClient([srv.endpoint])
                cc.push_grads_sync(
                    {srv.endpoint: {"w": np.full(3, g, np.float32)}})
                cc.sync_apply([srv.endpoint])
                cc.close()
            except BaseException as e:
                errs.append(e)

        ths = [threading.Thread(target=trainer, args=(g,))
               for g in (1.0, 3.0)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=30)
        assert not errs, errs
        np.testing.assert_allclose(c.get_param(srv.endpoint, "w"),
                                   w0 - 2.0)
        c.close()
    finally:
        srv.stop()


def test_sync_push_batch_ids_reject_duplicate_accumulation():
    srv = ParameterServer("127.0.0.1:0", trainers=1).start()
    try:
        c = PSClient([srv.endpoint])
        w0 = np.zeros((3,), np.float32)
        c.init_param(srv.endpoint, "w", w0, "sgd", lr=1.0, attrs={})
        g = {srv.endpoint: {"w": np.ones(3, np.float32)}}
        c.push_grads_sync(g, batch_id=0, trainer_id=0)
        c.push_grads_sync(g, batch_id=0, trainer_id=0)
        c.sync_apply([srv.endpoint])
        np.testing.assert_allclose(c.get_param(srv.endpoint, "w"),
                                   w0 - 1.0)
        c.push_grads_sync(g, batch_id=0, trainer_id=0)
        c.sync_apply([srv.endpoint])
        np.testing.assert_allclose(c.get_param(srv.endpoint, "w"),
                                   w0 - 1.0)
        c.push_grads_sync(g, batch_id=1, trainer_id=0)
        c.sync_apply([srv.endpoint])
        np.testing.assert_allclose(c.get_param(srv.endpoint, "w"),
                                   w0 - 2.0)
        c.push_grads_sync(g, batch_id=0, trainer_id=0, session="s2")
        c.sync_apply([srv.endpoint])
        np.testing.assert_allclose(c.get_param(srv.endpoint, "w"),
                                   w0 - 3.0)
        c.close()
    finally:
        srv.stop()


def _deepfm(pkg, F=6, N=500, K=8, D=4, hidden=(32, 32), seed=1,
            opt="Adagrad", lr=0.05):
    main, startup = pkg.Program(), pkg.Program()
    model = pkg.models.deepfm if pkg is ptt else __import__(
        "paddle_tpu.models.deepfm", fromlist=["build"])
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, outs = model.build(num_fields=F, sparse_feature_dim=N,
                              embedding_size=K, dense_dim=D,
                              hidden_sizes=hidden, distributed=True)
        getattr(pkg.optimizer, opt)(learning_rate=lr).minimize(outs["loss"])
    main.random_seed = startup.random_seed = seed
    return main, startup, outs["loss"]


def _ctr_batch(rng, n=32, F=6, N=500, D=4, magic=25):
    ids = rng.randint(0, N, size=(n, F)).astype(np.int64)
    dense = rng.randn(n, D).astype(np.float32) * 0.1
    label = (ids < magic).any(axis=1).astype(np.int64).reshape(n, 1)
    return {"dense_input": dense, "sparse_input": ids, "label": label}


def _async_trainer(pkg, main, startup, eps, cap=None, scope=None):
    cfg = pkg.DistributeTranspilerConfig()
    if cap is not None:
        cfg.sparse_prefetch_cap = cap
    t = pkg.DistributeTranspiler(cfg)
    t.transpile(trainer_id=0, program=main, pservers=eps, trainers=1,
                sync_mode=False, startup_program=startup)
    exe = pkg.Executor(pkg.CPUPlace())
    if scope is None:
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
    tr = PS["jax" if pkg is fluid else "port"].AsyncPSTrainer(
        t, exe, scope=scope)
    tr.init_params()
    return t, tr


def test_pserver_crash_restart_resumes_training(tmp_path):
    """Kill one pserver mid-async-DeepFM, restart it on the same
    endpoint from its shard snapshot: training resumes and converges."""
    servers = [ParameterServer("127.0.0.1:0").start(),
               ParameterServer("127.0.0.1:0").start()]
    eps_list = [s.endpoint for s in servers]
    try:
        main, startup, loss = _deepfm(ptt, N=400, seed=3)
        t, tr = _async_trainer(ptt, main, startup, ",".join(eps_list))
        rng = np.random.RandomState(3)
        batch = lambda: _ctr_batch(rng, N=400, magic=20)  # noqa: E731
        pre = [_loss(tr.step(batch(), fetch_list=[loss])[0])
               for _ in range(15)]
        ckpt = str(tmp_path / "ps_ckpt")
        tr.save(ckpt)
        victim_ep = eps_list[1]
        victim_dense = sorted(servers[1]._dense)
        snap_vals = {n: servers[1]._dense[n].copy() for n in victim_dense}
        assert victim_dense
        servers[1].stop()
        with pytest.raises((RuntimeError, OSError, ConnectionError,
                            EOFError)):
            for _ in range(3):
                tr.step(batch(), fetch_list=[loss])
        servers[1] = ParameterServer(victim_ep).start().recover(ckpt)
        for n in victim_dense:
            np.testing.assert_array_equal(servers[1]._dense[n],
                                          snap_vals[n])
        assert servers[1]._optim[victim_dense[0]] is not None
        post = [_loss(tr.step(batch(), fetch_list=[loss])[0])
                for _ in range(25)]
        assert np.isfinite(post).all()
        assert np.mean(post[-8:]) < np.mean(pre[:8]) * 0.9, (pre, post)
        tr.close()
    finally:
        for s in servers:
            s.stop()


def test_shared_ids_feed_updates_correct_global_rows(two_servers):
    """Two tables looked up with the SAME ids feed: pushes hit the
    batch's GLOBAL rows of both tables."""
    eps = ",".join(s.endpoint for s in two_servers)
    N, K = 40, 3
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        ids_in = ptt.layers.data(name="ids", shape=[2], dtype="int64")
        e1 = ptt.layers.embedding(ids_in, size=[N, K], is_distributed=True,
                                  param_attr=ptt.ParamAttr(name="tab_a"))
        e2 = ptt.layers.embedding(ids_in, size=[N, K], is_distributed=True,
                                  param_attr=ptt.ParamAttr(name="tab_b"))
        loss = ptt.layers.mean(ptt.layers.elementwise_add(e1, e2))
        ptt.optimizer.SGD(learning_rate=1.0).minimize(loss)
    t, tr = _async_trainer(ptt, main, startup, eps)
    before = {w: tr.client.prefetch_rows(w, np.arange(N))
              for w in ("tab_a", "tab_b")}
    tr.step({"ids": np.array([[30, 35]], np.int64)}, fetch_list=[loss])
    for w in ("tab_a", "tab_b"):
        after = tr.client.prefetch_rows(w, np.arange(N))
        changed = np.where(np.abs(after - before[w]).sum(1) > 1e-9)[0]
        assert set(changed.tolist()) == {30, 35}, changed
    tr.close()


def test_async_ps_deepfm_sparse(two_servers, tmp_path):
    """DeepFM with distributed lookup tables through the PS: sub-table
    prefetch + remap + sparse push; loss decreases; both shards save."""
    eps = ",".join(s.endpoint for s in two_servers)
    main, startup, loss = _deepfm(ptt, seed=1)
    t, tr = _async_trainer(ptt, main, startup, eps, cap=256)
    assert set(t.sparse_specs) == {"fm_v", "fm_w"}
    rng = np.random.RandomState(1)
    losses = [_loss(tr.step(_ctr_batch(rng), fetch_list=[loss])[0])
              for _ in range(80)]
    assert np.mean(losses[-8:]) < np.mean(losses[:8]) * 0.5, losses
    paths = tr.save(str(tmp_path / "shards"))
    assert len(paths) == 2 and all(os.path.exists(p) for p in paths)
    tr.close()


# ---------------------------------------------------------------------------
# tests/test_dist_train.py's cases, against the port
# ---------------------------------------------------------------------------

PSERVER_SCRIPT = """
import sys
import torch
import paddle_tpu_torch as fluid
from paddle_tpu_torch.models import deepfm

endpoint, all_eps = sys.argv[1], sys.argv[2]
feeds, outs = deepfm.build(num_fields=6, sparse_feature_dim=500,
                           embedding_size=8, dense_dim=4,
                           hidden_sizes=(32, 32), distributed=True)
fluid.optimizer.Adagrad(learning_rate=0.05).minimize(outs["loss"])
t = fluid.DistributeTranspiler()
t.transpile(trainer_id=0, pservers=all_eps, trainers=2, sync_mode=False)
prog = t.get_pserver_program(endpoint)
out = fluid.Executor(fluid.CPUPlace()).run(prog)  # serves until stopped
print("SERVED", out, "CUDA_INITIALIZED", torch.cuda.is_initialized())
"""

TRAINER_SCRIPT = """
import sys
import numpy as np
import torch
import paddle_tpu_torch as fluid
from paddle_tpu_torch.models import deepfm
from paddle_tpu_torch.pserver import AsyncPSTrainer

torch.set_num_threads(1)
trainer_id, all_eps, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
np.random.seed(100 + trainer_id)
feeds, outs = deepfm.build(num_fields=6, sparse_feature_dim=500,
                           embedding_size=8, dense_dim=4,
                           hidden_sizes=(32, 32), distributed=True)
loss = outs["loss"]
fluid.optimizer.Adagrad(learning_rate=0.05).minimize(loss)
cfg = fluid.DistributeTranspilerConfig()
cfg.sparse_prefetch_cap = 256
t = fluid.DistributeTranspiler(cfg)
t.transpile(trainer_id=trainer_id, pservers=all_eps, trainers=2,
            sync_mode=False)
exe = fluid.Executor(fluid.CPUPlace())
exe.run(fluid.default_startup_program())
tr = AsyncPSTrainer(t, exe)
tr.init_params()

def batch(n=32):
    ids = np.random.randint(0, 500, size=(n, 6)).astype(np.int64)
    magic = (ids < 25).any(axis=1)
    dense = np.random.randn(n, 4).astype(np.float32) * 0.1
    return {"dense_input": dense, "sparse_input": ids,
            "label": magic.astype(np.int64).reshape(n, 1)}

losses = []
for step in range(40):
    l, = tr.step(batch(), fetch_list=[loss])
    losses.append(float(np.asarray(l).reshape(-1)[0]))
with open(out_path, "w") as f:
    f.write(",".join(str(v) for v in losses))
tr.close()
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_ps_ready(endpoints, procs, timeout=120):
    deadline = time.time() + timeout
    for ep in endpoints:
        host, port = ep.rsplit(":", 1)
        while True:
            try:
                socket.create_connection((host, int(port)), timeout=1).close()
                break
            except OSError:
                dead = [p.communicate()[1][-2000:] for p in procs
                        if p.poll() is not None]
                if dead:
                    raise RuntimeError(f"a pserver died: {dead}")
                if time.time() > deadline:
                    raise TimeoutError(f"pserver {ep} never came up")
                time.sleep(0.3)


def test_async_pserver_deepfm_two_trainers(tmp_path):
    """Two pserver processes, each `Executor(CPUPlace()).run` of its
    `get_pserver_program(ep)` (served until stopped over the wire, then
    run returns []), and two trainer processes, async DeepFM: both
    converge; no pserver process initialized CUDA."""
    eps = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
    all_eps = ",".join(eps)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    spawn = lambda code, args: subprocess.Popen(  # noqa: E731
        [sys.executable, "-c", code] + args, env=env, cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    pservers = [spawn(PSERVER_SCRIPT, [ep, all_eps]) for ep in eps]
    trainers = []
    try:
        _wait_ps_ready(eps, pservers)
        out_files = [str(tmp_path / f"t{i}.txt") for i in range(2)]
        trainers = [spawn(TRAINER_SCRIPT, [str(i), all_eps, out_files[i]])
                    for i in range(2)]
        for i, tr in enumerate(trainers):
            _, err = tr.communicate(timeout=240)
            assert tr.returncode == 0, f"trainer {i} failed:\n{err[-3000:]}"
        for i, path in enumerate(out_files):
            losses = [float(v) for v in open(path).read().split(",")]
            assert len(losses) == 40
            first, last = np.mean(losses[:8]), np.mean(losses[-8:])
            assert last < first * 0.9, (i, first, last)
        c = PSClient(eps)
        c.stop_all()
        c.close()
        for p in pservers:
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err[-3000:]
            assert "SERVED [] CUDA_INITIALIZED False" in out, out + err
    finally:
        for p in trainers + pservers:
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
        for p in trainers + pservers:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass


def test_hybrid_collective_dense_ps_sparse(two_servers):
    """The CTR composition: dense grads through the collective executor
    (here a one-rank dp mesh), the embeddings on host parameter servers
    (prefetch + sparse push)."""
    from paddle_tpu_torch.parallel import mesh as mesh_lib

    eps = ",".join(s.endpoint for s in two_servers)
    main, startup, loss = _deepfm(ptt, N=400, hidden=(16, 16), seed=4)
    t = ptt.DistributeTranspiler()
    t.transpile(trainer_id=0, program=main, pservers=eps, trainers=1,
                mode="hybrid", startup_program=startup)
    assert not t.param_specs
    assert set(t.sparse_specs) == {"fm_v", "fm_w"}
    prog = t.get_trainer_program()
    assert any(op.type == "adagrad" for op in prog.global_block().ops)
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope)
    pe = ptt.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                              main_program=prog, scope=scope,
                              mesh=mesh_lib.make_mesh([1], ["dp"]))

    class _PEAdapter:
        """AsyncPSTrainer drives exe.run(program, feed, fetch_list); the
        collective executor owns the same scope."""

        def run(self, program, feed, fetch_list, scope=None):
            return pe.run(feed=feed, fetch_list=[
                f.name if hasattr(f, "name") else str(f)
                for f in fetch_list])

    tr = AsyncPSTrainer(t, _PEAdapter(), program=prog, scope=scope)
    tr.init_params()
    dense_names = [n for n in scope.local_var_names()
                   if "fc" in n and n.endswith(".w_0")]
    assert dense_names
    w_before = ptt.fetch_var(dense_names[0], scope).copy()
    rng = np.random.RandomState(4)
    losses = [_loss(tr.step(_ctr_batch(rng, N=400), fetch_list=[loss])[0])
              for _ in range(40)]
    assert np.mean(losses[-8:]) < np.mean(losses[:8]) * 0.9, losses
    assert not np.allclose(ptt.fetch_var(dense_names[0], scope), w_before)
    c = PSClient(eps.split(","))
    assert np.abs(c.prefetch_rows("fm_w", np.arange(5))).sum() > 0
    c.close()
    tr.close()


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _wire_run(client_pkg, server_pkg, codec):
    """A fixed stream of pushes from one package's client into the
    other's server: the server's parameter, the rows a client pulls, the
    Adam slots."""
    rng = np.random.RandomState(9)
    srv = server_pkg.ParameterServer("127.0.0.1:0").start()
    ep = srv.endpoint
    c = client_pkg.PSClient([ep], comm_quant=codec)
    try:
        c.init_param(ep, "w", rng.randn(64, 33).astype(np.float32), "adam",
                     0.01, {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8})
        c.init_table("tbl", rows=40, width=8, dtype="float32",
                     init_low=-0.5, init_high=0.5, seed=5, opt_type="sgd",
                     lr=0.5, attrs={})
        for k in range(6):
            c.push_grad(ep, "w", rng.randn(64, 33).astype(np.float32))
            ids = np.unique(rng.randint(0, 40, 12))
            c.push_sparse_grad("tbl", ids, rng.randn(
                ids.size, 8).astype(np.float32))
        out = {"pulled": c.get_param(ep, "w"), "server": srv._dense["w"],
               "rows": c.prefetch_rows("tbl", np.arange(40))}
        out.update({f"acc:{k}": v
                    for k, v in srv._optim["w"]._acc.items()})
        return out
    finally:
        c.close()
        srv.stop()


@pytest.mark.parametrize("codec", [None, "int8"])
def test_clients_and_servers_of_both_packages_agree_bit_for_bit(codec):
    runs = {(cn, sn): _wire_run(PS[cn], PS[sn], codec)
            for cn in PS for sn in PS}
    ref = runs[("jax", "jax")]
    for key, got in runs.items():
        assert sorted(got) == sorted(ref), key
        for name, v in ref.items():
            assert got[name].tobytes() == v.tobytes(), (key, name)
    if codec == "int8":
        raw = _wire_run(tps, tps, None)
        assert raw["server"].tobytes() != ref["server"].tobytes()


@pytest.mark.parametrize("opt,attrs", [
    ("sgd", {}), ("momentum", {"mu": 0.9, "use_nesterov": True}),
    ("adagrad", {"epsilon": 1e-6}),
    ("adam", {"beta1": 0.9, "beta2": 0.99, "epsilon": 1e-8})])
def test_server_optimizers_are_the_jax_packages(opt, attrs):
    from paddle_tpu.pserver import optim as joptim
    from paddle_tpu_torch.pserver import optim as toptim
    rng = np.random.RandomState(3)
    p0 = rng.randn(20, 6).astype(np.float32)
    params, opts = {}, {}
    for name, mod in (("jax", joptim), ("port", toptim)):
        params[name] = p0.copy()
        opts[name] = mod.make_optimizer(opt, 0.05, attrs)
    for k in range(5):
        g = rng.randn(20, 6).astype(np.float32)
        rows = np.unique(rng.randint(0, 20, 7))
        rg = rng.randn(rows.size, 6).astype(np.float32)
        for name in params:
            opts[name].dense(params[name], g)
            opts[name].sparse(params[name], rows, rg)
    assert params["port"].tobytes() == params["jax"].tobytes()
    js, ts = opts["jax"].state(), opts["port"].state()
    assert (ts["lr"], ts["attrs"]) == (js["lr"], js["attrs"])
    assert sorted(ts["acc"]) == sorted(js["acc"])
    for k, v in js["acc"].items():
        assert ts["acc"][k].tobytes() == v.tobytes(), k
    with pytest.raises(NotImplementedError, match="not implemented"):
        toptim.make_optimizer("lamb", 0.1, {})


def _jax_state(main, startup):
    """The JAX startup's parameters, as numpy, and its started scope."""
    jscope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=jscope)
    return jscope, {n: np.asarray(jscope.find_var(n))
                    for n in jscope.local_var_names()}


def test_async_trainer_losses_are_the_jax_packages():
    """Tiny DeepFM through AsyncPSTrainer (dense params and two sparse
    tables on two servers each) from the same parameters: the port's
    losses within LOSS_RTOL of the JAX package's, step by step."""
    losses = {}
    arrays = None
    for name in ("jax", "port"):
        pkg = PKGS[name]
        main, startup, loss = _deepfm(pkg, N=300, hidden=(16, 16), seed=2)
        servers = [PS[name].ParameterServer("127.0.0.1:0").start()
                   for _ in range(2)]
        try:
            if name == "jax":
                scope, arrays = _jax_state(main, startup)
            else:
                scope = ptt.io.state_from_numpy(arrays, ptt.CPUPlace())
            t, tr = _async_trainer(pkg, main, startup,
                                   ",".join(s.endpoint for s in servers),
                                   cap=256, scope=scope)
            rng = np.random.RandomState(6)
            losses[name] = [
                _loss(tr.step(_ctr_batch(rng, N=300), fetch_list=[loss])[0])
                for _ in range(8)]
            tr.close()
        finally:
            for s in servers:
                s.stop()
    np.testing.assert_allclose(losses["port"], losses["jax"],
                               rtol=LOSS_RTOL, atol=0)
    assert losses["port"][-1] < losses["port"][0]


def test_sync_trainer_losses_are_the_jax_packages():
    """The fc net through two SyncPSTrainers in each package from the
    same parameters (Adam on the servers): per-trainer losses within
    LOSS_RTOL, final server parameters within 1e-5."""
    build = lambda pkg: _fc_net(pkg, seed=11, lr=0.01,  # noqa: E731
                                opt="Adam")
    batches = _fc_batches(steps=4, seed=8)
    main, startup, _ = build(fluid)
    runs = {}
    arrays = None
    for name in ("jax", "port"):
        scopes = []
        for _ in range(2):
            if name == "jax":
                s, arrays = _jax_state(main, startup)
            else:
                s = ptt.io.state_from_numpy(arrays, ptt.CPUPlace())
            scopes.append(s)
        runs[name] = _sync_world(PKGS[name], build, batches, scopes)
    for tid in range(2):
        np.testing.assert_allclose(runs["port"][0][tid], runs["jax"][0][tid],
                                   rtol=LOSS_RTOL, atol=0)
    for p, v in runs["jax"][1].items():
        np.testing.assert_allclose(runs["port"][1][p], v, rtol=0, atol=1e-5,
                                   err_msg=p)


# ---------------------------------------------------------------------------
# the fused-attention Transformer, the pull, the layers, the refusals
# ---------------------------------------------------------------------------

TINY_T = dict(src_vocab_size=32, trg_vocab_size=32, seq_len=16, n_layer=1,
              n_head=2, d_model=16, d_inner=32, dropout_rate=0.0)


def _tiny_transformer(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, fetches = ttransformer.build(**TINY_T)
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(fetches["loss"])
    main.random_seed = startup.random_seed = 3
    return main, startup, fetches["loss"]


def _server_adam_reference(build, arrays, batches, exe):
    """The Executor's full-batch grads (the trainer Program at the whole
    batch) with the servers' numpy Adam applied on the host: where a
    sync PS job's parameters should land, bar the sum of two halves."""
    from paddle_tpu_torch.pserver import optim
    main, startup, _ = build(ptt)
    cfg = ptt.DistributeTranspilerConfig()
    cfg.runtime = "pserver"
    t = ptt.DistributeTranspiler(cfg)
    t.transpile(0, program=main, pservers="127.0.0.1:1", trainers=1,
                sync_mode=True, startup_program=startup)
    scope = ptt.io.state_from_numpy(arrays, ptt.CPUPlace())
    host = {p: arrays[p].copy() for p in t.param_specs}
    opts = {p: optim.make_optimizer(
        spec["opt_type"], float(arrays[spec["lr_name"]].reshape(-1)[0]),
        spec["attrs"]) for p, spec in t.param_specs.items()}
    for feed in batches:
        for p in host:
            scope.set_var(p, host[p].copy())
        grads = exe.run(main, feed=feed, scope=scope, fetch_list=[
            t.grad_names[p] for p in t.param_specs])
        for p, g in zip(t.param_specs, grads):
            opts[p].dense(host[p], g)
    return host


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_sync_ps_transformer_matches_the_executor():
    """A one-layer fused-attention Transformer through two SyncPSTrainers
    (batch 2 + 2, Adam on the servers) against the port's Executor at
    batch 4 from the same state: mean losses within 1e-5 relative; each
    parameter within 1e-4 relative L2 of the Executor's full-batch grads
    under the servers' Adam; the Program keeps no adam op; no kernel
    counter moves on the host.

    Against the Executor's own parameters (its in-graph `adam` op) the
    distance is the two Adam rules', not the PS job's: the servers' numpy
    Adam (copied from paddle_tpu/pserver/optim.py) adds epsilon to
    sqrt(v / (1 - beta2^t)), the `adam` op to sqrt(v) before the bias
    correction, so a grad near epsilon's scale moves differently. Over
    these 3 steps that puts up to 2.2e-4 between the two references, and
    the PS job sits where the servers' rule puts it (within 2e-7)."""
    rng = np.random.RandomState(4)
    batches = [{n: rng.randint(0, 32, (4, 16)).astype(np.int64)
                for n in ("src_word", "trg_word", "lbl_word")}
               for _ in range(3)]
    main, startup, loss = _tiny_transformer(ptt)
    assert any(op.type == "adam" for op in main.global_block().ops)
    exe = ptt.Executor(ptt.CPUPlace())
    ref_scope = ptt.Scope()
    exe.run(startup, scope=ref_scope)
    arrays = {n: ptt.fetch_var(n, ref_scope).copy()
              for n in ref_scope.local_var_names()}
    host = _server_adam_reference(_tiny_transformer, arrays, batches, exe)
    ref = [_loss(exe.run(main, feed=b, fetch_list=[loss],
                         scope=ref_scope)[0]) for b in batches]
    native.reset_launches()
    scopes = [ptt.io.state_from_numpy(arrays, ptt.CPUPlace())
              for _ in range(2)]
    (l0, l1), params = _sync_world(ptt, _tiny_transformer, batches, scopes)
    assert not any(native.launches.values())
    np.testing.assert_allclose([(a + b) / 2 for a, b in zip(l0, l1)], ref,
                               rtol=1e-5, atol=0)
    assert sorted(params) == sorted(host)
    assert any("self" in p for p in params)
    for p, got in params.items():
        assert _rel_l2(got, host[p]) <= 1e-4, p
        # the Executor's in-graph Adam: the rules' distance, not the job's
        in_graph = ptt.fetch_var(p, ref_scope)
        assert abs(_rel_l2(got, in_graph) - _rel_l2(host[p], in_graph)) \
            <= 1e-6, p


def test_the_pull_writes_into_the_scopes_tensor(two_servers):
    """`_recv_dense` copies each pulled parameter into the tensor the
    scope already holds (on a card, the step's own device tensor), bit
    for bit the server's value; a name without a tensor of its shape
    takes the numpy value, which the next run moves to its place."""
    eps = ",".join(s.endpoint for s in two_servers)
    main, startup, loss = _fc_net(ptt, seed=0)
    t, tr = _async_trainer(ptt, main, startup, eps)
    held = {p: tr.scope.find_var(p) for p in t.param_specs}
    assert all(isinstance(v, torch.Tensor) for v in held.values())
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(8, 8).astype(np.float32),
            "y": rng.randint(0, 2, (8, 1)).astype(np.int64)}
    for _ in range(2):
        tr.step(feed, fetch_list=[loss])
    tr._recv_dense()
    for p, spec in t.param_specs.items():
        assert tr.scope.find_var(p) is held[p]
        assert held[p].numpy().tobytes() == tr.client.get_param(
            spec["endpoint"], p).tobytes()
    name = next(iter(t.param_specs))
    tr.scope.set_var(name, np.zeros(1, np.float32))
    tr._recv_dense()
    assert isinstance(tr.scope.find_var(name), np.ndarray)
    tr.step(feed, fetch_list=[loss])
    assert isinstance(tr.scope.find_var(name), torch.Tensor)
    tr.close()


def test_listen_and_serv_send_and_recv_round_trip():
    """`layers.ListenAndServ` starts a server; `Send` pushes a scope value
    (a torch tensor, as host numpy; a `@GRAD` under its parameter's
    name) and `Recv` pulls into the scope."""
    srv = ptt.layers.ListenAndServ("127.0.0.1:0")
    ep = srv.endpoint
    try:
        scope = ptt.Scope()
        scope.set_var("w", torch.arange(6, dtype=torch.float32))
        c = PSClient([ep])
        c.init_param(ep, "w", np.zeros(6, np.float32), "sgd", 0.5, {})
        c.close()
        scope.set_var("w@GRAD", torch.full((6,), 2.0))
        ptt.layers.Send(ep, ["w@GRAD"], scope=scope)
        got, = ptt.layers.Recv(ep, ["w"], scope=scope)
        np.testing.assert_array_equal(got, np.full(6, -1.0, np.float32))
        assert scope.find_var("w") is got
        ptt.layers.Send(ep, "w", scope=scope)   # a parameter's own name
        with pytest.raises(KeyError, match="not found"):
            ptt.layers.Send(ep, ["missing"], scope=scope)
    finally:
        srv.stop()
        from paddle_tpu_torch.layers import io as tio
        tio._ps_clients.pop(ep).close()


def test_quorum_routes_reach_the_arbiters(tmp_path):
    """Each fluid-quorum route of the plane arms against a live group of
    three arbiters: a pair's `quorum_endpoints=` (`_arm_quorum`, hence
    `HavenState.arm_quorum`) wins its bootstrap election there,
    `PSClient`'s quorum resolution reads the holder back,
    `QuorumLeaseTable(quorum=)` takes the arbiters' word for a member
    whose own lease lapsed, and `HeartbeatThread(quorum=)` renews a
    member lease there."""
    import time

    from paddle_tpu_torch import ark
    from paddle_tpu_torch.quorum import QuorumClient, QuorumNode
    nodes = [QuorumNode("127.0.0.1:0", str(tmp_path),
                        node_id=f"n{i}").start() for i in range(3)]
    qeps = [n.endpoint for n in nodes]
    backup = ParameterServer("127.0.0.1:0").start()
    primary = ParameterServer("127.0.0.1:0").start()
    qc = QuorumClient(qeps)
    c = None
    try:
        backup.start_standby(lease_s=5.0, quorum_endpoints=qeps,
                             quorum_resource="shard0")
        primary.start_replication(backup.endpoint, lease_s=5.0,
                                  quorum_endpoints=qeps,
                                  quorum_resource="shard0")
        for srv in (primary, backup):
            h = srv._haven
            assert isinstance(h.quorum, QuorumClient)
            assert (h.resource, h.quorum_lease_s, h.quorum.endpoints) == (
                "shard0", 5.0, qeps)
        assert qc.holder("shard0") == {"holder": primary.endpoint,
                                       "epoch": 1}
        c = PSClient([primary.endpoint], quorum_endpoints=qeps,
                     quorum_resources={primary.endpoint: "shard0"})
        assert c._quorum_holder(primary.endpoint) == primary.endpoint
        table = ark.QuorumLeaseTable(quorum=qc, status_ttl_s=0.05)
        table.beat("m0", lease_s=0.05)
        hb = ark.HeartbeatThread(beat=lambda: None, lease_s=5.0, quorum=qc,
                                 quorum_resource="member:m0",
                                 quorum_holder="m0")
        assert hb.beat_once() == 1 and hb.beat_once() == 1
        hb.stop()
        assert qc.holder("member:m0") == {"holder": "m0", "epoch": 1}
        time.sleep(0.1)                     # the table's own lease lapses
        assert "m0" not in table.expired()  # the arbiters vouch for it
        assert ark.QuorumLeaseTable().quorum is None   # a plain table
    finally:
        if c is not None:
            c.close()
        qc.close()
        primary.stop()
        backup.stop()
        for n in nodes:
            n.stop()
