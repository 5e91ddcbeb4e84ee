"""The port's analysis CLIs against the JAX package's, on the CPU.

Each tool runs in a subprocess beside its counterpart on the same input:

- ``tools/torch_paddle_lint.py`` vs ``tools/paddle_lint.py``: the same
  findings (``--format json``) and exit code, on a saved Program and on
  book models;
- ``tools/torch_paddle_plan.py --hw cpu`` vs ``tools/paddle_plan.py --hw
  cpu``: the same ranked report (``--json``) and exit code, also where
  no candidate fits;
- ``tools/torch_race_lint.py``: the port sweeps clean against its own
  baseline;
- ``tools/torch_op_profile.py``: the same static cost table as
  ``tools/op_profile.py`` and a passing ``--measured-check``;
- ``tools/torch_telemetry_dump.py --cpu`` vs ``tools/telemetry_dump.py``:
  the same exit codes and causes for ``--assert-no-recompiles`` with and
  without ``--two-shapes``, the same ``--format prom`` families of the
  planes the port has;
- ``tools/torch_observatory.py --rounds 1 --json`` against a live port
  pulse vs ``tools/observatory.py`` against a live JAX pulse: the same
  document keys;
- ``tools/torch_metrics_lint.py``: the port's emitted names all in
  ``docs/OBSERVABILITY.md``'s catalog;
- ``tools/torch_step_profile.py --cpu --tiny``: its host-event and op
  tables;
- ``tools/torch_wire_bench.py`` vs ``tools/wire_bench.py`` (the
  parameter-server wire's A/B, 12 steps of a small net on the host): the
  same exit code, JSON keys and bytes a step;
- the coordination plane's tools (item 8.5) beside their counterparts:
  ``torch_quorum_node.py`` and ``torch_master_node.py`` serve the other
  package's clients and print the same ``--status``;
  ``torch_ps_worker.py`` leaves the same dumps on SIGTERM;
  ``torch_haven_bench.py --cpu``, ``torch_elastic_bench.py`` (host
  only) and
  ``torch_quorum_bench.py --cpu`` print the same keys and the same
  failover verdicts (their wall-clock overhead gates, and so their exit
  codes, are each host's own and not held);
  ``torch_chaos_drill.py --cpu`` passes ``master_kill``,
  ``master_partition`` and ``trainer_churn`` at seed 7 (``replica_kill``
  and ``decode_kill`` run in ``tests/test_torch_fleet_tools.py``); every
  scenario at three seeds is ``slow``.

Everything else is held exactly: the tools' JSON documents and exit
codes.
"""

import json
import os
import signal
import subprocess
import sys

import pytest

import paddle_tpu as fluid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")


def _run(tool, *args, timeout=600):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, os.path.join(TOOLS, tool),
                           *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr


def _pair(jax_tool, port_tool, *args):
    jrc, jout, jerr = _run(jax_tool, *args)
    trc, tout, terr = _run(port_tool, *args)
    return (jrc, jout, jerr), (trc, tout, terr)


def _saved_program(path):
    """A Program with a lint finding: an op no fetch reads (a dead op)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        h = fluid.layers.fc(input=x, size=4, act="relu")
        fluid.layers.scale(h, scale=2.0)
        loss = fluid.layers.mean(h)
    with open(path, "w") as f:
        f.write(main.serialize_to_string())
    return loss.name


@pytest.mark.parametrize("target", ["saved", "mnist", "transformer-no-train"])
def test_lint_gives_the_same_findings_as_paddle_lint(tmp_path, target):
    if target == "saved":
        path = str(tmp_path / "prog.json")
        loss = _saved_program(path)
        args = [path, "--fetch", loss]
    elif target == "mnist":
        args = ["--model", "mnist"]
    else:
        args = ["--model", "transformer", "--no-train"]
    (jrc, jout, jerr), (trc, tout, terr) = _pair(
        "paddle_lint.py", "torch_paddle_lint.py", "--format", "json", *args)
    assert jrc in (0, 1), jerr
    assert trc == jrc, terr
    assert json.loads(tout) == json.loads(jout)
    if target == "saved":
        assert json.loads(tout)["diagnostics"]
        # --strict promotes the warnings to a failing exit, in both
        assert _run("torch_paddle_lint.py", "--strict", *args)[0] == \
            _run("paddle_lint.py", "--strict", *args)[0] == 1


def test_lint_usage_errors_exit_2():
    rc, _, err = _run("torch_paddle_lint.py")
    assert rc == 2 and "exactly one" in err
    rc, _, err = _run("torch_paddle_lint.py", "/nonexistent/prog.json")
    assert rc != 0 and "cannot load program" in err


@pytest.mark.parametrize("case", ["transformer-4", "mlp-8", "no-fit"])
def test_plan_gives_the_same_ranking_as_paddle_plan(case):
    args = {"transformer-4": ["--model", "transformer", "--devices", "4"],
            "mlp-8": ["--model", "mlp", "--devices", "8", "--batch", "16"],
            "no-fit": ["--model", "transformer", "--devices", "2",
                       "--hbm-gb", "0.0001"]}[case]
    (jrc, jout, jerr), (trc, tout, terr) = _pair(
        "paddle_plan.py", "torch_paddle_plan.py", "--hw", "cpu", "--json",
        *args)
    assert trc == jrc, (terr, jerr)
    assert json.loads(tout) == json.loads(jout)
    if case == "no-fit":
        assert trc == 1 and "no feasible mesh" in terr
    else:
        assert trc == 0 and json.loads(tout)["best"] is not None


def test_plan_text_report_names_the_machine_model():
    rc, out, _ = _run("torch_paddle_plan.py", "--model", "mlp",
                      "--devices", "2", "--hw", "h100")
    assert rc == 0
    assert "hw=h100-sxm-80gb" in out and "PLAN:" in out


def test_race_lint_sweeps_the_port_clean_against_its_baseline():
    with open(os.path.join(TOOLS, "torch_race_lint_baseline.json")) as f:
        doc = json.load(f)
    assert doc["entries"] == []
    rc, out, err = _run("torch_race_lint.py", "--format", "json")
    assert rc == 0, err
    got = json.loads(out)
    assert (got["errors"], got["warnings"], got["stale"]) == (0, 0, [])


def test_race_lint_flags_a_new_race(tmp_path):
    src = tmp_path / "racy.py"
    src.write_text(
        "import threading\n\n\n"
        "class Box:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._n = 0  # guarded_by: self._lock\n\n"
        "    def bump(self):\n"
        "        self._n += 1\n")
    jrc, jout, _ = _run("race_lint.py", "--format", "json", str(src))
    trc, tout, _ = _run("torch_race_lint.py", "--format", "json", str(src))
    assert trc == jrc == 1
    codes = [d["code"] for d in json.loads(tout)["diagnostics"]]
    assert codes == [d["code"] for d in json.loads(jout)["diagnostics"]]
    assert codes


@pytest.mark.parametrize("model", ["mlp", "transformer"])
def test_op_profile_static_cost_equals_op_profiles(model):
    args = ["--model", model, "--steps", "1", "--json"]
    jrc, jout, jerr = _run("op_profile.py", *args)
    trc, tout, terr = _run("torch_op_profile.py", "--cpu", *args)
    assert jrc == 0 and trc == 0, (jerr, terr)
    j, t = json.loads(jout), json.loads(tout)
    for k in ("total_flops", "total_bytes", "param_bytes", "top",
              "by_type"):
        assert t.get(k) == j.get(k), k
    assert t["observed_steps"] == j["observed_steps"] == 1
    # the products the static model counts are what torch's counter saw
    assert t["static_product_flops"] == t["measured_flops"] > 0


def test_op_profile_measured_check_passes_on_the_cpu():
    rc, _, err = _run("torch_op_profile.py", "--cpu", "--model", "mlp",
                      "--steps", "1", "--measured-check")
    assert rc == 0, err
    assert "measured-check:" in err and "OK" in err


def test_tools_import_no_jax_or_paddle_tpu(tmp_path):
    """Each port tool runs with jax and paddle_tpu unimportable."""
    code = ("import sys, runpy\n"
            "class Ban:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', "
            "'paddle_tpu'):\n"
            "            raise ImportError('banned: ' + name)\n"
            "sys.meta_path.insert(0, Ban())\n"
            "sys.argv = [sys.argv[1]] + sys.argv[2:]\n"
            "runpy.run_path(sys.argv[0], run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for tool, args in (("torch_paddle_lint.py", ["--model", "mnist"]),
                       ("torch_paddle_plan.py", ["--model", "mlp",
                                                 "--devices", "2",
                                                 "--hw", "cpu"]),
                       ("torch_telemetry_dump.py",
                        ["--cpu", "--assert-no-recompiles"]),
                       ("torch_metrics_lint.py", []),
                       ("torch_observatory.py", ["dead=1", "--rounds", "1",
                                                 "--interval", "0"]),
                       ("torch_step_profile.py",
                        ["--cpu", "--tiny", "--batch", "2", "--top",
                         "3"]),
                       ("torch_quorum_node.py",
                        ["--data-dir", str(tmp_path), "--status",
                         "r"]),
                       ("torch_chaos_drill.py",
                        ["--cpu", "--scenario", "ckpt_crash"])):
        proc = subprocess.run(
            [sys.executable, "-c", code, os.path.join(TOOLS, tool), *args],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# the observe CLIs (item 8.2b)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("two_shapes", [False, True])
def test_telemetry_dump_asserts_as_telemetry_dumps(two_shapes):
    args = ["--assert-no-recompiles"] + (["--two-shapes"] if two_shapes
                                         else [])
    jrc, _, jerr = _run("telemetry_dump.py", *args)
    trc, _, terr = _run("torch_telemetry_dump.py", "--cpu", *args)
    assert trc == jrc == (1 if two_shapes else 0), (terr, jerr)

    def causes(err):
        line = [ln for ln in err.splitlines() if "cause(s):" in ln]
        return line[0].split("cause(s):")[1].strip() if line else None
    assert causes(terr) == causes(jerr)
    if two_shapes:
        assert causes(terr) == "feed_shape"
    else:
        assert "assert-no-recompiles: OK" in terr


def test_telemetry_dump_prom_families_are_telemetry_dumps():
    def families(out):
        return {ln.split()[2] for ln in out.splitlines()
                if ln.startswith("# TYPE ")}
    jrc, jout, jerr = _run("telemetry_dump.py", "--format", "prom")
    trc, tout, terr = _run("torch_telemetry_dump.py", "--cpu", "--format",
                           "prom")
    assert jrc == trc == 0, (jerr, terr)
    assert families(tout) == families(jout)
    assert "executor_recompiles_total" in families(tout)


def test_telemetry_dump_table_and_json_render_the_status_document(tmp_path):
    rc, out, err = _run("torch_telemetry_dump.py", "--cpu", "--format",
                        "table", "--trace", str(tmp_path / "t.json"))
    assert rc == 0, err
    assert out.startswith("steps: 4") and "recompiles:" in out
    assert "alerts: none" in out and "metrics:" in out
    assert json.load(open(tmp_path / "t.json"))["traceEvents"]
    rc, out, err = _run("torch_telemetry_dump.py", "--cpu")
    assert rc == 0, err
    doc = json.loads(out)
    jrc, jout, _ = _run("telemetry_dump.py")
    assert sorted(doc) == sorted(json.loads(jout))
    assert _run("torch_telemetry_dump.py", "--url",
                "http://127.0.0.1:1")[0] == 1


def test_observatory_json_keys_are_observatorys():
    import paddle_tpu_torch as ptt
    from paddle_tpu import observe as jobs
    from paddle_tpu_torch import observe as tobs
    docs = {}
    fluid.set_flag("observe", True)
    ptt.set_flag("observe", True)
    try:
        for tag, pkg, obs, tool in (("jax", fluid, jobs, "observatory.py"),
                                    ("port", ptt, tobs,
                                     "torch_observatory.py")):
            main, startup = pkg.Program(), pkg.Program()
            with pkg.program_guard(main, startup), pkg.unique_name.guard():
                x = pkg.layers.data(name="x", shape=[4], dtype="float32")
                loss = pkg.layers.mean(pkg.layers.fc(input=x, size=2))
                pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
            exe = pkg.Executor(pkg.CPUPlace())
            scope = pkg.Scope()
            exe.run(startup, scope=scope)
            import numpy as np
            exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                    fetch_list=[loss], scope=scope)
            port = obs.start_pulse(0)
            try:
                rc, out, err = _run(tool, f"trainer={port}", "--rounds", "1",
                                    "--interval", "0", "--json")
            finally:
                obs.stop_pulse()
            assert rc == 0, err
            docs[tag] = json.loads(out)
    finally:
        fluid.set_flag("observe", False)
        ptt.set_flag("observe", False)
        tobs.reset_all()
    j, t = docs["jax"], docs["port"]
    assert sorted(t) == sorted(j)
    assert sorted(t["overview"]) == sorted(j["overview"])
    assert t["overview"]["targets_up"] == j["overview"]["targets_up"] == 1
    assert [sorted(x) for x in t["targets"]] == \
        [sorted(x) for x in j["targets"]]
    assert sorted(t["store"]) == sorted(j["store"])
    assert "executor_steps_total" in t["series"]
    assert t["series"]["horizon_up"][0]["value"] == 1.0


def _catalog():
    sys.path.insert(0, TOOLS)
    try:
        import torch_metrics_lint
    finally:
        sys.path.remove(TOOLS)
    return torch_metrics_lint.parse_catalog(
        os.path.join(REPO, "docs", "OBSERVABILITY.md"))


def test_metrics_lint_passes_the_port_against_the_catalog():
    rc, out, err = _run("torch_metrics_lint.py")
    assert rc == 0, out + err
    summary = out.strip().splitlines()[-1]
    assert summary.startswith("metrics_lint:") and " 0 missing" in summary
    rc, out, _ = _run("torch_metrics_lint.py", "--list")
    assert rc == 0
    names = {ln.split()[0] for ln in out.splitlines() if ln.strip()}
    assert names and names <= _catalog()
    # every name it lists is emitted from the port's tree
    assert all("paddle_tpu_torch/" in ln for ln in out.splitlines()
               if ln.strip())
    for name in ("executor_recompiles_total", "pserver_wire_bytes_raw",
                 "pserver_wire_bytes_encoded"):
        assert name in names
    # every plane is ported: no catalog row is stale, so --strict passes
    rc, out, _ = _run("torch_metrics_lint.py", "--strict")
    assert rc == 0 and out.strip().endswith("0 missing, 0 stale"), out


def test_metrics_lint_flags_a_name_missing_from_the_catalog(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "m.py").write_text(
        "from x import metrics\nmetrics.counter('not_in_the_catalog_total')\n")
    for tool in ("metrics_lint.py", "torch_metrics_lint.py"):
        rc, out, _ = _run(tool, "--pkg", str(pkg))
        assert rc == 1 and "not_in_the_catalog_total" in out


def test_step_profile_prints_its_tables_on_the_cpu(tmp_path):
    rc, out, err = _run("torch_step_profile.py", "--cpu", "--tiny",
                        "--batch", "4", "--top", "10", "--out",
                        str(tmp_path))
    assert rc == 0, err
    assert "Event" in out and "train_step" in out and "fetch_sync" in out
    assert "top 10 ops by self CPU time:" in out
    assert "FlashAttention" in out
    host = json.load(open(tmp_path / "host_timeline.json"))
    names = [e.get("name") for e in host["traceEvents"]]
    assert names.count("train_step") == 3
    assert os.path.exists(tmp_path / "trace.json")


def test_step_profile_traces_the_yardstick_on_the_cpu(tmp_path):
    rc, out, err = _run("torch_step_profile.py", "--yardstick", "--cpu",
                        "--tiny", "--top", "10", "--out", str(tmp_path))
    assert rc == 0, err
    assert "yardstick (hand-written PyTorch, tiny)" in out
    assert "Event" in out and "train_step" in out and "fetch_sync" in out
    assert "top 10 ops by self CPU time:" in out and "aten::mm" in out
    host = json.load(open(tmp_path / "host_timeline.json"))
    names = [e.get("name") for e in host["traceEvents"]]
    assert names.count("train_step") == 3


# ---------------------------------------------------------------------------
# the host-overhead tools (item 8.9)
# ---------------------------------------------------------------------------

def test_step_overhead_bench_reports_as_the_jax_one():
    """Both benches at 20 steps a window, 2 rounds (the port's on the
    host): the same keys, every wall time positive, every overhead at
    least 0. The times are each package's own."""
    env = dict(os.environ, STEP_OVERHEAD_STEPS="20", STEP_OVERHEAD_ROUNDS="2")
    docs = {}
    for tool, args in (("step_overhead_bench.py", ()),
                       ("torch_step_overhead_bench.py", ("--cpu",))):
        proc = subprocess.run(
            [sys.executable, os.path.join(TOOLS, tool), *args], cwd=REPO,
            env=dict(env, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                     OMP_NUM_THREADS="1"),
            capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr
        docs[tool] = json.loads(proc.stdout.strip().splitlines()[-1])
    jdoc, tdoc = docs["step_overhead_bench.py"], \
        docs["torch_step_overhead_bench.py"]
    assert sorted(tdoc) == sorted(jdoc)
    assert tdoc["steps_per_window"] == jdoc["steps_per_window"] == 20
    for k in ("floor_us", "legacy_us", "run_us", "prepared_us"):
        assert tdoc[k] > 0 and jdoc[k] > 0, k
    for k in ("step_overhead_us_unprepared", "step_overhead_us_run",
              "step_overhead_us", "step_overhead_reduction_x"):
        assert tdoc[k] >= 0 and jdoc[k] >= 0, k


def _yardsticks():
    sys.path.insert(0, TOOLS)
    try:
        import torch_yardstick_transformer as ty
        import yardstick_transformer as jy
    finally:
        sys.path.remove(TOOLS)
    return jy, ty


# the JAX yardstick's tiny widths and batch
YD_WIDTHS = dict(src_vocab=64, trg_vocab=64, n_layer=1, n_head=4,
                 d_model=32, d_inner=64)
YD_BATCH = dict(batch_size=4, seq_len=8, vocab=64)
# the port's AMP tolerances (tests/test_torch_amp.py): losses to
# LOSS_RTOL relative; the state after a step, for each kind of state,
# within NOISE_FACTOR x the relative L2 distance bf16 puts between the
# JAX step's own bf16 and float32 runs from the same state
YD_LOSS_RTOL, YD_NOISE_FACTOR = 5e-3, 2.0


def _yd_port_params(jy, ty, jparams):
    """The JAX tool's parameters carried into the port as numpy."""
    import numpy as np
    import torch
    tmpl = ty.init_params(0, **YD_WIDTHS)
    return ty.tree_map(lambda _, j: torch.from_numpy(np.array(j)), tmpl,
                       jparams)


class _Float32Jnp:
    """jax.numpy with bfloat16 standing for float32: the JAX tool's step
    computed in float32 throughout, for its own bf16 noise."""

    def __init__(self, jnp):
        self._jnp = jnp
        self.bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(self._jnp, name)


def test_yardstick_matches_the_jax_one_at_rate_0(monkeypatch):
    import jax
    import jax.numpy as jnp
    import numpy as np
    jy, ty = _yardsticks()
    jparams = jy.init_params(0, **YD_WIDTHS)
    tparams = _yd_port_params(jy, ty, jparams)
    # the same draws: the port's own init_params gives the same values
    for a, b in zip(ty.tree_leaves(tparams),
                    ty.tree_leaves(ty.init_params(0, **YD_WIDTHS))):
        assert (a.numpy() == b.numpy()).all()
    jbatch, tbatch = jy.make_batch(**YD_BATCH), ty.make_batch(**YD_BATCH)
    key = jax.random.key(0)
    kw = dict(seq_len=YD_BATCH["seq_len"], n_head=YD_WIDTHS["n_head"],
              rate=0.0)
    jloss = float(jy.loss_fn(jparams, jbatch, key, **kw))
    tloss = float(ty.loss_fn(tparams, tbatch, 0, **kw))
    assert tloss > 1.0
    np.testing.assert_allclose(tloss, jloss, rtol=YD_LOSS_RTOL, atol=0)

    def jax_step():
        # a fresh function each call: jit traces it anew, under whichever
        # jnp the JAX tool's module holds then
        def step(params):
            loss, grads = jax.value_and_grad(jy.loss_fn)(params, jbatch,
                                                         key, **kw)
            return jy.adam_update(params, grads, jy.adam_init(params))[0]
        return jax.jit(step)(jparams)

    j1 = jax_step()
    monkeypatch.setattr(jy, "jnp", _Float32Jnp(jnp))
    j32 = jax_step()
    t1, _, loss1 = ty.train_step(tparams, ty.adam_init(tparams), tbatch, 0,
                                 **kw)
    np.testing.assert_allclose(float(loss1), jloss, rtol=YD_LOSS_RTOL)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    dist, noise = {}, {}
    for t, j, j_32 in zip(*(ty.tree_leaves(ty.tree_map(
            lambda _, x: np.asarray(x, np.float32), tparams, tree))
            for tree in (t1, j1, j32))):
        kind = "matrices" if t.ndim == 2 else "vectors"
        dist[kind] = max(dist.get(kind, 0.0), rel(t, j))
        noise[kind] = max(noise.get(kind, 0.0), rel(j_32, j))
    assert set(dist) == {"matrices", "vectors"}
    for kind in dist:
        assert dist[kind] <= YD_NOISE_FACTOR * noise[kind], \
            (kind, dist[kind], noise[kind])


def test_yardstick_keep_mask_is_the_jax_ones_at_rate_0_1():
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    jy, ty = _yardsticks()
    for k in (0, 7, 12345):
        key = jax.random.key(k)
        x = jnp.ones((4, 8, 32), jnp.bfloat16)
        jout = np.asarray(jy._dropout(key, x, 0.1).astype(jnp.float32))
        # the seed the JAX `_dropout` derives from its key
        kd = np.asarray(jax.random.key_data(key)).reshape(-1).astype(
            np.uint32)
        seed = int(kd[0]) ^ ((int(kd[-1]) * 0x9E3779B9) & 0xFFFFFFFF)
        keep = ty.keep_mask(seed, x.shape, 0.1, "cpu").numpy()
        assert (keep == (jout != 0)).all()
        assert 0.8 < keep.mean() < 0.95
        tout = ty._dropout(seed, torch.ones(x.shape, dtype=torch.bfloat16),
                           0.1).float().numpy()
        assert (tout == jout).all()


# ---------------------------------------------------------------------------
# the parameter-server wire bench (item 8.4)
# ---------------------------------------------------------------------------

def test_wire_bench_reports_as_wire_bench():
    """Both benches run the same sync-PS job (the same net, seeds and 12
    steps) raw and int8: the same keys, and the same bytes a step and
    compression, which depend only on the shapes and the codec; the times
    are each host's own."""
    (jrc, jout, jerr), (trc, tout, terr) = _pair("wire_bench.py",
                                                  "torch_wire_bench.py")
    assert jrc == trc == 0, (jerr, terr)
    jdoc, tdoc = json.loads(jout.splitlines()[-1]), \
        json.loads(tout.splitlines()[-1])
    assert sorted(tdoc) == sorted(jdoc)
    for k in ("wire_bytes_per_step_raw", "wire_bytes_per_step_encoded",
              "wire_compression_x", "wire_sparse_compression_x"):
        assert tdoc[k] == jdoc[k], k
    assert tdoc["wire_compression_x"] > 3.9
    assert tdoc["wire_quant_loss_delta"] < 0.05


# ---------------------------------------------------------------------------
# the coordination plane's tools (item 8.5)
# ---------------------------------------------------------------------------

def _env():
    return dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1")


def _start(*runs):
    """Start each (tool, args) at once, each a process that prints
    "ENDPOINT <ep>" once it serves; [(process, endpoint)]."""
    procs = [subprocess.Popen([sys.executable, os.path.join(TOOLS, tool),
                               *args], cwd=REPO, env=_env(),
                              stdout=subprocess.PIPE, text=True)
             for tool, args in runs]
    out = []
    for (tool, _), proc in zip(runs, procs):
        line = proc.stdout.readline().strip()
        assert line.startswith("ENDPOINT "), (tool, line)
        out.append((proc, line.split()[1]))
    return out


def _stop(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    proc.stdout.close()


def _together(*runs, timeout=600):
    """Run each (tool, args) at once; their (rc, stdout, stderr)."""
    procs = [subprocess.Popen([sys.executable, os.path.join(TOOLS, tool),
                               *args], cwd=REPO, env=_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for tool, args in runs]
    out = []
    for p in procs:
        o, e = p.communicate(timeout=timeout)
        out.append((p.returncode, o, e))
    return out


def test_quorum_node_serves_and_reports_as_quorum_node(tmp_path):
    """Each package's arbiter process grants the other package's client
    (port against JAX and JAX against port), keeps its epoch across a
    SIGTERM, and both tools' `--status` read either data dir the same."""
    from paddle_tpu.quorum import QuorumClient as JClient
    from paddle_tpu_torch.quorum import QuorumClient as TClient
    tools = (("quorum_node.py", TClient), ("torch_quorum_node.py", JClient))
    dirs = [str(tmp_path / tool) for tool, _ in tools]
    started = _start(*((tool, ["--data-dir", d, "--node-id", "n0"])
                       for (tool, _), d in zip(tools, dirs)))
    try:
        for (_, client), (_, ep) in zip(tools, started):
            c = client([ep])
            try:
                lease = c.campaign("r", "h", lease_s=5.0)
                assert lease is not None and lease.epoch == 1
                assert c.renew(lease)
                assert c.holder("r") == {"holder": "h", "epoch": 1}
            finally:
                c.close()
    finally:
        for proc, _ in started:
            _stop(proc)
    assert [proc.returncode for proc, _ in started] == [0, 0]
    runs = _together(*((tool, ["--data-dir", d, "--node-id", "n0",
                               "--status", "r"])
                       for tool, _ in tools for d in dirs))
    assert all(rc == 0 for rc, _, _ in runs), runs
    assert {out for _, out, _ in runs} == {"r epoch=1 lease_s=5.0\n"}


def test_master_node_serves_and_reports_as_master_node():
    """Each package's master process serves the other package's client,
    and both tools' `--status` print the same row against either (its
    endpoint fields aside)."""
    from paddle_tpu.master import MasterClient as JClient
    from paddle_tpu_torch.master import MasterClient as TClient
    tools = (("master_node.py", TClient), ("torch_master_node.py", JClient))
    started = _start(*((tool, ["--timeout-dur", "60"]) for tool, _ in tools))
    try:
        for (_, client), (_, ep) in zip(tools, started):
            c = client(ep, failover_s=0.0)
            c.set_dataset(list(range(4)), chunks_per_task=2)
            status, t = c.get_task()
            assert status == "ok" and t["payload"] == [0, 1]
            assert c.task_finished(t["task_id"], t["epoch"])
            c.close()
        asks = [(tool, ep) for tool, _ in tools for _, ep in started]
        runs = _together(*((tool, ["--endpoint", ep, "--status"])
                           for tool, ep in asks))
    finally:
        for proc, _ in started:
            _stop(proc)
    rows = set()
    for (_, ep), (rc, out, err) in zip(asks, runs):
        assert rc == 0 and f"endpoint={ep}" in out, err
        rows.add(" ".join(kv for kv in out.split()
                          if not kv.startswith(("endpoint=", "primary="))))
    assert rows == {"applied_seq=0 done=1 epoch=0 fenced=False "
                    "ha_acked=0 ha_seq=0 issuing=True pass=0 pending=0 "
                    "role=solo todo=1"}


def test_ps_worker_leaves_the_dumps_ps_worker_leaves(tmp_path):
    """On SIGTERM each package's pserver process writes its chrome trace
    and its flight dump; the dumps carry the same keys and reason, the
    other package's client having been served first."""
    import numpy as np

    from paddle_tpu.pserver import PSClient as JClient
    from paddle_tpu_torch.pserver import PSClient as TClient
    tools = (("ps_worker.py", TClient), ("torch_ps_worker.py", JClient))
    outs = [str(tmp_path / tool) for tool, _ in tools]
    started = _start(*((tool, ["--name", "pserver0", "--out", out])
                       for (tool, _), out in zip(tools, outs)))
    try:
        for (_, client), (_, ep) in zip(tools, started):
            c = client([ep])
            try:
                c.init_param(ep, "w", np.zeros(4, np.float32), "sgd", 0.5,
                             {})
                c.push_grad(ep, "w", np.ones(4, np.float32))
                assert c.get_param(ep, "w").tolist() == [-0.5] * 4
            finally:
                c.close()
    finally:
        for proc, _ in started:
            _stop(proc)
    docs = []
    for out in outs:
        assert sorted(os.listdir(out)) == ["flight_pserver0.json",
                                           "trace_pserver0.json"]
        fr = json.load(open(os.path.join(out, "flight_pserver0.json")))
        tr = json.load(open(os.path.join(out, "trace_pserver0.json")))
        docs.append((sorted(fr), fr["reason"], sorted(tr),
                     bool(tr["traceEvents"])))
    assert docs[1] == docs[0] and docs[0][1].startswith("signal")


# each bench's verdicts that do not gate on a wall-clock ratio
BENCH_VERDICTS = {"haven": ("ps_failover_ok",),
                  "elastic": ("master_failover_ok", "elastic_scaleup_ok"),
                  "quorum": ("quorum_failover_ok",)}


def test_plane_benches_report_as_their_counterparts():
    """Each bench beside its counterpart, all six at once: the same keys,
    and both failover verdicts true. The steady-state overhead gates are
    wall-clock ratios of each host's own, and not held."""
    benches = sorted(BENCH_VERDICTS)
    runs = _together(*(run for b in benches for run in (
        (f"{b}_bench.py", []),
        (f"torch_{b}_bench.py", [] if b == "elastic" else ["--cpu"]))))
    for i, bench in enumerate(benches):
        (_, jout, jerr), (_, tout, terr) = runs[2 * i:2 * i + 2]
        jdoc = json.loads(jout.strip().splitlines()[-1])
        tdoc = json.loads(tout.strip().splitlines()[-1])
        assert sorted(tdoc) == sorted(jdoc), (bench, terr)
        for k in BENCH_VERDICTS[bench]:
            assert jdoc[k] is True and tdoc[k] is True, (k, jdoc, tdoc)


@pytest.mark.parametrize("scenario", ["master_kill", "master_partition",
                                      "trainer_churn"])
def test_chaos_drill_master_scenario_passes_on_the_cpu(tmp_path, scenario):
    """Each fluid-elastic drill once at seed 7, alone, on the port's
    Executor on the host."""
    rc, out, err = _run("torch_chaos_drill.py", "--cpu", "--scenario",
                        scenario, "--seed", "7", "--workdir", str(tmp_path))
    if rc != 0 or "DRILL PASSED" not in out:
        pytest.fail(f"{scenario}: exit {rc}\n{out}\n{err[-4000:]}",
                    pytrace=False)


DRILL_SCENARIOS = ("flaky_rpc", "quant_flaky_rpc", "pserver_kill",
                   "ckpt_crash", "sync_evict", "dist_trace", "health_alerts",
                   "ps_primary_kill", "ps_handover", "ps_partition",
                   "master_kill", "master_partition", "trainer_churn")


@pytest.mark.slow
@pytest.mark.parametrize("scenario", DRILL_SCENARIOS)
def test_chaos_drill_three_seeds(tmp_path, scenario):
    """Every ported scenario at seeds 5, 6 and 7, as
    tests/test_fault_tolerance.py and tests/test_elastic.py sweep the JAX
    drills."""
    for seed in (5, 6, 7):
        rc, out, err = _run("torch_chaos_drill.py", "--cpu", "--scenario",
                            scenario, "--seed", str(seed), "--workdir",
                            str(tmp_path / f"{scenario}_{seed}"))
        assert rc == 0, (scenario, seed, out[-2000:], err[-2000:])
