"""The serving fleet's tools on the port, on the CPU (``--cpu``).

- ``torch_fleet_replica.py`` / ``torch_fleet_router.py``: a router that
  spawns two port replica processes and runs a coordinated swap across
  them, and the JAX package's ``fleet_router.py`` attached to a port
  replica process, swapping it too (the two packages' wire, heartbeat
  and swap protocol interoperate across processes);
- ``torch_torrent_bench.py``: a short run prints the JSON keys of
  ``tools/torrent_bench.py``, with no failed and no divergent generation;
- ``torch_serve_loadgen.py``: short one-shot, generate and ``--replicas``
  runs pass their gates and print the keys of ``tools/serve_loadgen.py``;
- ``torch_chaos_drill.py``: ``replica_kill`` and ``decode_kill`` pass at
  one seed each; the three-seed sweeps are ``slow``, as the JAX
  package's are (``tests/test_torrent.py``, ``tests/test_fleet.py``).
"""

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")


def _env():
    return dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1")


def _cmd(tool, args):
    return [sys.executable, os.path.join(TOOLS, tool), *args]


def _run(tool, *args, timeout=600):
    proc = subprocess.run(_cmd(tool, args), cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr


def _together(*runs, timeout=600):
    """Run each (tool, args) at once; their (rc, stdout, stderr)."""
    procs = [subprocess.Popen(_cmd(tool, args), cwd=REPO, env=_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for tool, args in runs]
    out = []
    for p in procs:
        o, e = p.communicate(timeout=timeout)
        out.append((p.returncode, o, e))
    return out


def _json_line(out):
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


def _dict_keys(tool, var="out"):
    """The literal keys of every `var = {...}` dict in a JAX tool's
    source: the JSON keys it prints."""
    tree = ast.parse(open(os.path.join(TOOLS, tool)).read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Dict) and \
                any(isinstance(t, ast.Name) and t.id == var
                    for t in node.targets):
            keys |= {k.value for k in node.value.keys
                     if isinstance(k, ast.Constant)}
    return keys


def _swap_report(out):
    """The report dict of a router tool's `SWAP {...}` line."""
    line = next(ln for ln in out.splitlines() if ln.startswith("SWAP "))
    return ast.literal_eval(line[len("SWAP "):])


def _save_mlp(path, scale=1.0):
    sys.path.insert(0, TOOLS)
    try:
        from torch_serve_loadgen import build_and_save
    finally:
        sys.path.remove(TOOLS)
    import numpy as np

    import paddle_tpu_torch as fluid
    build_and_save(fluid, np, path, scale=scale, seed=7 if scale == 1.0
                   else 11)


def test_fleet_router_and_replica_tools_swap_across_packages(tmp_path):
    """The port's router spawns two port replicas and swaps them; the JAX
    router attaches to a port replica process and swaps it."""
    v1, v2 = str(tmp_path / "v1"), str(tmp_path / "v2")
    _save_mlp(v1)
    _save_mlp(v2, scale=1.5)
    rc, out, err = _run("torch_fleet_router.py", "--cpu", "--spawn", "2",
                        "--model-dir", v1, "--lease-s", "2",
                        "--poll-interval-s", "0.05", "--swap", v2, "--exit")
    assert rc == 0, out + err
    assert out.startswith("CONTROL 127.0.0.1:")
    report = _swap_report(out)
    # the swap takes the replicas the router's polls found ready (the
    # tool waits one poll round after the spawn): one or both
    assert report["replicas"] and set(report["replicas"]) <= {"r0", "r1"}
    assert report["failed_commits"] == []

    rep = subprocess.Popen(_cmd("torch_fleet_replica.py",
                                ["--cpu", "--model-dir", v1]),
                           cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        lines = [rep.stdout.readline().strip() for _ in range(2)]
        assert lines[0].startswith("REPLICA ") and lines[1] == "READY", \
            lines
        ep = lines[0].split()[1]
        rc, out, err = _run("fleet_router.py", "--attach", ep,
                            "--poll-interval-s", "0.2", "--swap", v2,
                            "--exit")
        assert rc == 0, out + err
        assert _swap_report(out)["replicas"] == [f"r@{ep}"], out
    finally:
        rep.terminate()
        rep.wait(timeout=30)
    assert rep.returncode == 0


def test_torrent_bench_and_serve_loadgen_print_the_jax_tools_keys():
    # two at a time: each spawns replica processes, and the suite's other
    # workers run timing-sensitive tests beside this one
    runs = _together(
        ("torch_torrent_bench.py", ["--cpu", "--duration", "1",
                                    "--clients", "4"]),
        ("torch_serve_loadgen.py", ["--cpu", "--duration", "1",
                                    "--threads", "2", "--qps", "60"]))
    runs += _together(
        ("torch_serve_loadgen.py", ["--cpu", "--workload", "generate",
                                    "--duration", "1.5", "--threads", "2",
                                    "--qps", "10"]),
        ("torch_serve_loadgen.py", ["--cpu", "--replicas", "2",
                                    "--duration", "1.5", "--threads", "2",
                                    "--qps", "40"]))
    for rc, out, err in runs:
        assert rc == 0, out + err[-4000:]
    bench, oneshot, gen, fleet = (_json_line(out) for _, out, _ in runs)
    assert set(bench) == _dict_keys("torrent_bench.py")
    assert bench["torrent_failed"] == bench["torrent_divergent"] == 0
    assert bench["torrent_generations_disagg"] > 0
    assert bench["torrent_kv_transfer_bytes"] > 0
    assert bench["torrent_slots_per_chip_int8"] > \
        3 * bench["torrent_slots_per_chip_fp32"]
    jkeys = _dict_keys("serve_loadgen.py")
    assert set(oneshot) <= jkeys and "serve_p99_us" in oneshot
    assert oneshot["serve_recompiles"] == oneshot["serve_failed"] == 0
    assert oneshot["serve_hot_swap_ok"] is True
    assert set(gen) <= jkeys and "ttft_p99_us" in gen
    assert gen["decode_mismatches"] == gen["decode_failed"] == 0
    assert set(fleet) <= jkeys | {"fleet_sparse"}
    assert fleet["fleet_skew_violations"] == fleet["fleet_failed"] == 0
    assert fleet["fleet_swap_ok"] is True
    assert sorted(fleet["fleet_served_by"]) == ["r0", "r1"]


@pytest.mark.parametrize("scenario,seed", [("replica_kill", 7),
                                           ("decode_kill", 5)])
def test_chaos_drill_fleet_scenarios_pass(tmp_path, scenario, seed):
    """The fleet and torrent drills once each, with their replica
    processes on the host."""
    rc, out, err = _run("torch_chaos_drill.py", "--cpu", "--scenario",
                        scenario, "--seed", str(seed), "--workdir",
                        str(tmp_path))
    if rc != 0 or "DRILL PASSED" not in out:
        pytest.fail(f"{scenario}: exit {rc}\n{out}\n{err[-4000:]}",
                    pytrace=False)
    got = _json_line(out)
    if scenario == "replica_kill":
        assert got["fleet_kill_failed"] == 0
        assert got["fleet_kill_failovers"] >= 1
    else:
        assert got["decode_kill_failed"] == got["decode_kill_divergent"] == 0
        assert got["decode_kill_failovers"] >= 1


@pytest.mark.slow
@pytest.mark.parametrize("scenario", ["replica_kill", "decode_kill"])
def test_chaos_drill_fleet_scenarios_three_seeds(tmp_path, scenario):
    """Both drills at seeds 5, 6 and 7, as tests/test_torrent.py and
    tests/test_fleet.py sweep the JAX drills."""
    for seed in (5, 6, 7):
        rc, out, err = _run("torch_chaos_drill.py", "--cpu", "--scenario",
                            scenario, "--seed", str(seed), "--workdir",
                            str(tmp_path / f"{scenario}_{seed}"))
        assert rc == 0, (scenario, seed, out[-2000:], err[-2000:])
