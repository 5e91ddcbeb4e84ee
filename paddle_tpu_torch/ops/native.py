"""Build, load and count the port's hand-written CUDA kernels.

The sources are ``paddle_tpu_torch/csrc/*.cu`` (plus the headers
``flash_common.cuh``, which the flash kernels share, ``mma_tf32.cuh`` and
``mma_bf16.cuh``, the float32 kernels' `mma.sync` helpers and the bf16
type and packing, ``wgmma_bf16.cuh``, the Hopper helpers (mbarriers, TMA,
`wgmma`, tensor maps) of the bf16 flash kernels, and
``paged_split.cuh``, the split layout and merge kernel of both paged
decode kernels): plain C entry points, no PyTorch headers. The bf16
flash entries encode their TMA tensor maps with the driver's
`cuTensorMapEncodeTiled`, reached through the runtime's
`cudaGetDriverEntryPoint`, so the link needs no `-lcuda`.
At first use each source is compiled by its own `nvcc` process (all
started together) for ``sm_90a``, and the objects are linked
into one shared library under ``paddle_tpu_torch/_build/`` (listed in
.gitignore), named by a hash of the sources, headers and flags so an
edited source never loads a stale build. The library is loaded with `ctypes`: pointers and the
stream travel as `c_void_p`, and every entry returns a `cudaError_t` that
`check()` turns into an exception.

Nothing here runs at import: a host without `nvcc` or a card imports this
module fine and only fails when a kernel is asked for.

`launches` counts kernel launches per kernel name. Each wrapper adds one
a grid it launched (`count_launch`) right after its launch succeeded and
nowhere else, so a caller can zero the counts, drive a path, and see
which kernels it went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# the float32 flash backward is four sources (flash_bwd_f32.cuh says why)
SOURCES = ("flash_fwd.cu", "flash_dq_f32.cu", "flash_dq_f32_wide.cu",
           "flash_dkv_f32.cu", "flash_dkv_f32_wide.cu", "flash_bwd_bf16.cu",
           "flash_delta.cu", "paged_decode.cu", "paged_decode_q8.cu",
           "dropout.cu")
HEADERS = ("flash_common.cuh", "mma_tf32.cuh", "mma_bf16.cuh",
           "wgmma_bf16.cuh", "paged_split.cuh", "flash_bwd_f32.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# gridDim.y limit: every kernel puts a batch-like extent (B*H, slots) there
MAX_GRID_Y = 65535
# gridDim.z limit: the paged decode kernels put a slot's chunks there
MAX_GRID_Z = 65535

launches = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0, "flash_delta": 0,
            "paged_decode": 0, "paged_decode_q8": 0, "dropout": 0,
            # the bf16 instantiations (bf16 mixed precision)
            "flash_fwd_bf16": 0, "flash_dq_bf16": 0, "flash_dkv_bf16": 0,
            "flash_delta_bf16": 0, "dropout_bf16": 0,
            # the dropout launches of either dtype that also wrote the
            # op's Mask
            "dropout_mask": 0}
_launch_lock = threading.Lock()   # engines of two models launch from two threads


def count_launch(name: str, grids: int = 1):
    """Count `grids` launches of kernel `name` (a wrapper whose work runs
    as several grids counts each)."""
    with _launch_lock:
        launches[name] += grids


def reset_launches():
    with _launch_lock:
        for name in launches:
            launches[name] = 0


class BuildInfo:
    """What the last build did: library path, wall seconds (0.0 when an
    existing build was loaded) and the compiler's output (`-Xptxas -v`
    register and shared-memory report per kernel; kept beside the library,
    so a loaded build reports it too)."""

    def __init__(self, path: str, seconds: float, log: str):
        self.path = path
        self.seconds = seconds
        self.log = log


_lock = threading.Lock()
_lib = None
build_info = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + \
            ["/usr/local/cuda/bin/nvcc"]:
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of paddle_tpu_torch are built from "
            "csrc/ at first use and need the CUDA toolkit")
    return found


def _build() -> BuildInfo:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(src.encode() + b"\0" + f.read())
    tag = h.hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"libptt_kernels_{tag}.so")
    log_path = so_path[:-len(".so")] + ".log"
    if os.path.isfile(so_path):
        log = ""
        if os.path.isfile(log_path):
            with open(log_path) as f:
                log = f.read()
        return BuildInfo(so_path, 0.0, log)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # unique scratch names: two processes may build the same tag at once
    stem = os.path.join(BUILD_DIR, f".{tag}_{os.getpid()}_{threading.get_ident()}")
    procs = []
    for src in SOURCES:
        obj = f"{stem}_{os.path.splitext(src)[0]}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, src), "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, obj, p in procs:
        out, _ = p.communicate()
        log.append(f"== nvcc {src} (exit {p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(src)
    objs = [obj for _, obj, _ in procs]
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_so = f"{stem}.so"
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", tmp_so, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (exit {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("linking the kernels failed:\n" + "\n".join(log))
        with open(f"{stem}.log", "w") as f:
            f.write("\n".join(log))
        os.replace(f"{stem}.log", log_path)
        os.replace(tmp_so, so_path)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.unlink(obj)
    return BuildInfo(so_path, time.perf_counter() - t0, "\n".join(log))


def _declare(lib):
    P, I, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
    lib.ptt_flash_fwd_f32.argtypes = [P, P, P, P, P, I, I, I, F, I, U, U, U,
                                      F, I, P]
    lib.ptt_flash_fwd_f32.restype = I
    lib.ptt_flash_fwd_bf16.argtypes = lib.ptt_flash_fwd_f32.argtypes
    lib.ptt_flash_fwd_bf16.restype = I
    lib.ptt_flash_fwd_bf16_smem_bytes.argtypes = [I]
    lib.ptt_flash_fwd_bf16_smem_bytes.restype = I
    lib.ptt_flash_fwd_bf16_causal_smem_bytes.argtypes = [I]
    lib.ptt_flash_fwd_bf16_causal_smem_bytes.restype = I
    lib.ptt_flash_fwd_smem_bytes.argtypes = [I]
    lib.ptt_flash_fwd_smem_bytes.restype = I
    lib.ptt_flash_dq_f32.argtypes = [P, P, P, P, P, P, P, I, I, I, F, I, U, U,
                                     U, F, I, P]
    lib.ptt_flash_dq_f32.restype = I
    lib.ptt_flash_dkv_f32.argtypes = [P, P, P, P, P, P, P, P, I, I, I, F, I, U,
                                      U, U, F, I, P]
    lib.ptt_flash_dkv_f32.restype = I
    lib.ptt_flash_dq_bf16.argtypes = lib.ptt_flash_dq_f32.argtypes
    lib.ptt_flash_dq_bf16.restype = I
    lib.ptt_flash_dkv_bf16.argtypes = lib.ptt_flash_dkv_f32.argtypes
    lib.ptt_flash_dkv_bf16.restype = I
    lib.ptt_flash_bwd_bf16_smem_bytes.argtypes = [I, I]
    lib.ptt_flash_bwd_bf16_smem_bytes.restype = I
    lib.ptt_flash_bwd_smem_bytes.argtypes = [I, I]
    lib.ptt_flash_bwd_smem_bytes.restype = I
    lib.ptt_flash_delta_f32.argtypes = [P, P, P, I, I, I, P]
    lib.ptt_flash_delta_f32.restype = I
    lib.ptt_flash_delta_bf16.argtypes = lib.ptt_flash_delta_f32.argtypes
    lib.ptt_flash_delta_bf16.restype = I
    lib.ptt_paged_decode_f32.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I,
                                         I, I, F, I, P]
    lib.ptt_paged_decode_f32.restype = I
    lib.ptt_paged_decode_q8.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I,
                                        I, I, I, F, I, P]
    lib.ptt_paged_decode_q8.restype = I
    lib.ptt_dropout_f32.argtypes = [P, P, P, ctypes.c_uint64,
                                    ctypes.c_uint64, U, U, F, I, P]
    lib.ptt_dropout_f32.restype = I
    lib.ptt_dropout_bf16.argtypes = lib.ptt_dropout_f32.argtypes
    lib.ptt_dropout_bf16.restype = I
    lib.ptt_error_string.argtypes = [I]
    lib.ptt_error_string.restype = ctypes.c_char_p


def lib():
    """The loaded kernel library, building it first if needed."""
    global _lib, build_info
    if _lib is None:
        with _lock:
            if _lib is None:
                info = _build()
                loaded = ctypes.CDLL(info.path)
                _declare(loaded)
                build_info = info
                _lib = loaded
    return _lib


def check(err: int, what: str):
    """Raise if a kernel entry returned a CUDA error."""
    if err != 0:
        msg = _lib.ptt_error_string(err).decode() if _lib is not None else ""
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def check_operand(t, name: str, dtype, device, shape=None):
    """Validate one kernel operand: device, dtype, shape, contiguity and
    16-byte alignment (the kernels load 16-byte vectors)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
