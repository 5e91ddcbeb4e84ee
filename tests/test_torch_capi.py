"""The port's C inference ABI (paddle_tpu_torch/capi/) against the JAX
package's (paddle_tpu/capi/), on the CPU.

Each case of tests/test_capi.py runs on the port: the library loaded with
ctypes (an FFI client, exactly how a C program would) against the
in-process predictor, the error report, the plain-C compile of the
header, and a pure-C multithreaded client. Then the two packages meet: a
dir saved by each runs through both libraries in one process, the two
headers declare the same ABI, and a client linked against the JAX
package's library runs the port's by LD_LIBRARY_PATH alone. The port's
predictor runs on the host here through PADDLE_TPU_TORCH_CAPI_PLACE=cpu;
with the variable unset and no card it refuses to start.
"""

import ctypes
import importlib
import os
import shutil
import subprocess
import sysconfig

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import layers as jlayers

import paddle_tpu_torch as ptt
from paddle_tpu_torch import capi, capi_runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CAPI = os.path.join(REPO, "paddle_tpu", "capi")
PYTHON_H = os.path.join(sysconfig.get_path("include"), "Python.h")

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or not os.path.exists(PYTHON_H),
    reason="no C++ toolchain or no Python.h to build the C ABI")


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{"port": the port's library, "inproc": its build without libpython,
    "jax": the JAX package's}, each built into a temporary dir."""
    from paddle_tpu.capi.build import build as jbuild
    out = tmp_path_factory.mktemp("capi")
    return {"port": capi.load(capi.build(str(out / "port"))),
            "inproc": capi.load(capi.build(str(out / "port"), embed=False)),
            "jax": capi.load(jbuild(str(out / "jax")))}


@pytest.fixture
def on_host(monkeypatch):
    monkeypatch.setenv(capi_runtime.PLACE_ENV, "cpu")


def _save_model(pkg, layers, tmpdir):
    """tests/test_capi.py's model, built and saved by `pkg`."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = layers.data(name="x", shape=[8], dtype="float32")
        h = layers.fc(input=x, size=16, act="relu")
        y = layers.fc(input=h, size=4, act="softmax")
    scope = pkg.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup, scope=scope)
    pkg.io.save_inference_model(tmpdir, ["x"], [y], exe,
                                main_program=main, scope=scope)
    return main, scope, y


def _run_abi(lib, model_dir, xv):
    """One PD_CreatePredictor + PD_PredictorRun of `xv` on feed "x": the
    output as a numpy array."""
    pred = lib.PD_CreatePredictor(model_dir.encode())
    assert pred, lib.PD_LastError()
    shape = (ctypes.c_int64 * 2)(*xv.shape)
    t = capi.PDTensor(b"x", capi.PD_FLOAT32, shape, 2, xv.ctypes.data)
    res = lib.PD_PredictorRun(pred, ctypes.addressof(t), 1)
    assert res, lib.PD_LastError()
    assert lib.PD_ResultsNum(res) == 1
    rank = lib.PD_ResultsRank(res, 0)
    shp = lib.PD_ResultsShape(res, 0)
    dims = [shp[i] for i in range(rank)]
    nbytes = lib.PD_ResultsByteSize(res, 0)
    buf = ctypes.string_at(lib.PD_ResultsData(res, 0), nbytes)
    out = np.frombuffer(buf, np.float32).reshape(dims).copy()
    lib.PD_DestroyResults(res)
    lib.PD_DestroyPredictor(pred)
    return out


# ---------------------------------------------------------------------------
# tests/test_capi.py's four cases, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["port", "inproc"])
def test_capi_roundtrip_matches_python(libs, on_host, tmp_path, which):
    model_dir = str(tmp_path / "model")
    main, scope, y = _save_model(ptt, ptt.layers, model_dir)
    xv = np.random.RandomState(3).randn(5, 8).astype(np.float32)
    exe = ptt.Executor(ptt.CPUPlace())
    ref, = exe.run(main.clone(for_test=True), feed={"x": xv},
                   fetch_list=[y], scope=scope)
    out = _run_abi(libs[which], model_dir, xv)
    assert out.shape == (5, 4)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-5)
    # and the runtime's own in-process predictor, which the shim drives
    name, dtype, arr = capi_runtime.create(model_dir).run(
        [("x", xv.shape, "float32", xv.tobytes())])[0]
    assert (name, dtype) == (y.name, "float32")
    np.testing.assert_array_equal(out, arr)


def test_capi_reports_errors(libs, on_host):
    lib = libs["port"]
    assert not lib.PD_CreatePredictor(b"/nonexistent/model/dir")
    assert lib.PD_LastError()  # names the failure


def test_capi_c_client_compiles(tmp_path):
    """The header is consumable from plain C (compile-only smoke)."""
    src = tmp_path / "client.c"
    src.write_text(
        '#include "paddle_tpu_capi.h"\n'
        "int main(void) {\n"
        "  PD_Tensor t; (void)t;\n"
        "  return PD_LastError == 0;  /* just link-surface checks */\n"
        "}\n")
    subprocess.run(["gcc" if shutil.which("gcc") else "g++", "-c",
                    str(src), f"-I{capi.INCLUDE_DIR}",
                    "-o", str(tmp_path / "client.o")], check=True)


_MT_CLIENT = r'''
#define _GNU_SOURCE
#include "paddle_tpu_capi.h"
#include <dlfcn.h>
#include <pthread.h>
#include <stdio.h>
#include <string.h>

static PD_Predictor pred;
static int worker_rc = 1;

static void* worker(void* arg) {
  (void)arg;
  float x[2 * 8];
  memset(x, 0, sizeof x);
  int64_t shape[2] = {2, 8};
  PD_Tensor t = {"x", PD_FLOAT32, shape, 2, x};
  PD_Results r = PD_PredictorRun(pred, &t, 1);
  if (!r) { fprintf(stderr, "run: %s\n", PD_LastError()); return 0; }
  if (PD_ResultsNum(r) != 1) return 0;
  if (PD_ResultsRank(r, 0) != 2) return 0;
  const int64_t* s = PD_ResultsShape(r, 0);
  if (s[0] != 2 || s[1] != 4) return 0;
  worker_rc = 0;
  PD_DestroyResults(r);
  return 0;
}

int main(int argc, char** argv) {
  (void)argc;
  Dl_info info;
  if (dladdr((void*)PD_CreatePredictor, &info) && info.dli_fname)
    printf("library %s\n", info.dli_fname);
  pred = PD_CreatePredictor(argv[1]);
  if (!pred) { fprintf(stderr, "create: %s\n", PD_LastError()); return 2; }
  pthread_t th;
  pthread_create(&th, 0, worker, 0);
  pthread_join(th, 0);
  PD_DestroyPredictor(pred);
  return worker_rc;
}
'''


def _client_env(libdir_first):
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    return dict(os.environ,
                PYTHONPATH=REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""),
                LD_LIBRARY_PATH=os.pathsep.join(
                    [libdir_first, libdir,
                     os.environ.get("LD_LIBRARY_PATH", "")]),
                JAX_PLATFORMS="cpu",
                **{capi_runtime.PLACE_ENV: "cpu"})


def test_capi_pure_c_multithreaded_client(tmp_path):
    """A REAL C program (not ctypes): starts the interpreter itself through
    the ABI, creates the predictor on the main thread and runs inference
    from a second pthread (the GIL must not be held across
    PD_CreatePredictor, or a multithreaded embedder deadlocks)."""
    model_dir = str(tmp_path / "model")
    _save_model(ptt, ptt.layers, model_dir)
    src = tmp_path / "client.c"
    src.write_text(_MT_CLIENT)
    so = capi.build(str(tmp_path / "lib"))
    exe = str(tmp_path / "client")
    subprocess.run(["gcc", str(src), f"-I{capi.INCLUDE_DIR}", so,
                    "-lpthread", "-ldl", "-o", exe], check=True)
    # a GIL deadlock would hang forever: the timeout IS the assertion
    # (generous: under `pytest -n` the embedded interpreter's torch import
    # competes with every other worker for cores)
    proc = subprocess.run([exe, model_dir],
                          env=_client_env(os.path.dirname(so)), timeout=420,
                          capture_output=True, text=True)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert f"library {so}" in proc.stdout


# ---------------------------------------------------------------------------
# the two packages' libraries and headers
# ---------------------------------------------------------------------------

def test_dirs_of_both_packages_run_through_both_libraries(libs, on_host,
                                                          tmp_path):
    """A dir saved by each package, each through each library in one
    process: four outputs, equal within rtol 1e-5."""
    dirs = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    _save_model(fluid, jlayers, dirs["jax"])
    # the port saves what it loads of the JAX dir: the same parameters
    exe, scope = ptt.Executor(ptt.CPUPlace()), ptt.Scope()
    prog, feeds, fetches = ptt.io.load_inference_model(dirs["jax"], exe,
                                                       scope=scope)
    ptt.io.save_inference_model(dirs["port"], feeds, fetches, exe,
                                main_program=prog, scope=scope)
    xv = np.random.RandomState(4).randn(6, 8).astype(np.float32)
    outs = {(d, lib): _run_abi(libs[lib], dirs[d], xv)
            for d in dirs for lib in ("jax", "port")}
    ref = outs[("jax", "jax")]
    assert ref.shape == (6, 4) and np.isfinite(ref).all()
    for k, v in outs.items():
        np.testing.assert_allclose(v, ref, rtol=1e-5, err_msg=str(k))


def _declarations(header_dir, tmp_path, tag):
    src = tmp_path / f"{tag}.c"
    src.write_text('#include "paddle_tpu_capi.h"\n')
    return subprocess.run(["gcc", "-E", "-P", f"-I{header_dir}", str(src)],
                          check=True, capture_output=True,
                          text=True).stdout


def test_headers_declare_the_same_abi(tmp_path):
    port = _declarations(capi.INCLUDE_DIR, tmp_path, "port")
    jax = _declarations(JAX_CAPI, tmp_path, "jax")
    assert "PD_PredictorRun" in port and "PD_Tensor" in port
    assert port == jax


def test_a_client_linked_against_the_jax_library_runs_the_ports(tmp_path):
    """A C client linked -lpaddle_tpu_capi against the JAX package's build
    runs against the port's library when LD_LIBRARY_PATH names it: the
    same symbols, one soname."""
    from paddle_tpu.capi.build import build as jbuild
    jdir, tdir = tmp_path / "jaxlib", tmp_path / "portlib"
    jbuild(str(jdir))
    port_so = capi.build(str(tdir))
    model_dir = str(tmp_path / "model")
    _save_model(ptt, ptt.layers, model_dir)
    src = tmp_path / "client.c"
    src.write_text(_MT_CLIENT)
    exe = str(tmp_path / "client")
    subprocess.run(["gcc", str(src), f"-I{JAX_CAPI}", f"-L{jdir}",
                    "-lpaddle_tpu_capi", "-lpthread", "-ldl", "-o", exe],
                   check=True)
    proc = subprocess.run([exe, model_dir], env=_client_env(str(tdir)),
                          timeout=420, capture_output=True, text=True)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert f"library {port_so}" in proc.stdout


# ---------------------------------------------------------------------------
# the place: CUDAPlace(0) unless the variable asks for the host
# ---------------------------------------------------------------------------

def test_no_card_and_no_place_variable_refuses_to_start(libs, monkeypatch,
                                                        tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the predictor starts on it")
    monkeypatch.delenv(capi_runtime.PLACE_ENV, raising=False)
    model_dir = str(tmp_path / "model")
    _save_model(ptt, ptt.layers, model_dir)
    lib = libs["port"]
    assert not lib.PD_CreatePredictor(model_dir.encode())
    assert b"CUDA" in lib.PD_LastError()


def test_an_unknown_place_variable_raises(libs, monkeypatch, tmp_path):
    monkeypatch.setenv(capi_runtime.PLACE_ENV, "tpu")
    model_dir = str(tmp_path / "model")
    _save_model(ptt, ptt.layers, model_dir)
    lib = libs["port"]
    assert not lib.PD_CreatePredictor(model_dir.encode())
    assert capi_runtime.PLACE_ENV.encode() in lib.PD_LastError()


def test_the_library_builds_into_the_build_dir_at_first_use():
    path = capi.build()
    assert path == capi.LIB_PATH
    assert os.path.dirname(path) == os.path.join(REPO, "paddle_tpu_torch",
                                                 "_build")
    assert not [f for f in os.listdir(capi.INCLUDE_DIR)
                if f.endswith(".so") or f.endswith(".tmp")]
    soname = subprocess.run(["objdump", "-p", path], capture_output=True,
                            text=True).stdout if shutil.which("objdump") \
        else ""
    if soname:
        assert "SONAME               libpaddle_tpu_capi.so" in soname


def test_a_failed_build_raises_with_the_command_and_its_stderr(
        tmp_path, monkeypatch):
    # the module (the package's `build` is its function)
    b = importlib.import_module("paddle_tpu_torch.capi.build")
    bad = tmp_path / "src"
    bad.mkdir()
    (bad / "capi.cc").write_text("this is not C++\n")
    (bad / "paddle_tpu_capi.h").write_text("")
    monkeypatch.setattr(b, "HERE", str(bad))
    with pytest.raises(capi.BuildError) as e:
        b.build(str(tmp_path / "out"), embed=False)
    assert "g++" in str(e.value) and "error" in str(e.value)
    assert not os.listdir(tmp_path / "out")
