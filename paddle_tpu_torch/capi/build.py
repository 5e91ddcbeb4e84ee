"""Build libpaddle_tpu_capi.so, the port's C inference ABI (reference
analog: the capi cmake target, legacy/capi/CMakeLists.txt).

The shim is plain CPython C API (no pybind11), compiled with `g++` into
``paddle_tpu_torch/_build/`` (beside the CUDA kernels and RecordIO's
library), never into the package's sources. It is rebuilt when
``capi.cc`` or the header is newer than the library, under a private
name and then renamed, so processes that build at once never load a
half-written library.

`embed=True` (the default) links the shared ``libpython``, so a C
program that never ran Python can load the library: its first call
starts an interpreter. `embed=False` leaves the Python symbols to the
process that loads it (a Python process, through ctypes); it is for a
host whose Python has no shared library, and is written beside the
other as ``libpaddle_tpu_capi_inproc.so``.

Usage: python -m paddle_tpu_torch.capi.build [outdir]
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import sysconfig
from typing import List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")
LIB_NAME = "libpaddle_tpu_capi.so"
INPROC_NAME = "libpaddle_tpu_capi_inproc.so"
SOURCES = ("capi.cc", "paddle_tpu_capi.h")


class BuildError(RuntimeError):
    """The library cannot be built here: what is missing, or the command
    that failed and its stderr."""


def python_link_flags() -> List[str]:
    """`-L<LIBDIR> -lpython3.X` for this interpreter's shared library.
    Raises BuildError naming what is missing when it has none (a static
    libpython linked into a shared object would start a second
    interpreter inside a Python process)."""
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ldlib = sysconfig.get_config_var("LDLIBRARY") or ""
    if not sysconfig.get_config_var("Py_ENABLE_SHARED") or \
            not ldlib.endswith(".so") or \
            not os.path.exists(os.path.join(libdir, ldlib)):
        raise BuildError(
            f"no shared libpython to embed: Py_ENABLE_SHARED="
            f"{sysconfig.get_config_var('Py_ENABLE_SHARED')}, LDLIBRARY "
            f"{ldlib!r} in LIBDIR {libdir!r}")
    ver = f"python{sys.version_info.major}.{sys.version_info.minor}"
    return [f"-L{libdir}", f"-l{ver}"]


def build(outdir: Optional[str] = None, embed: bool = True) -> str:
    """The library's path, built first if it is missing or older than
    its sources. Raises BuildError for a missing `g++`, a missing
    ``Python.h``, a missing shared libpython (embed only) or a failed
    compile or link."""
    outdir = outdir or BUILD_DIR
    out = os.path.join(outdir, LIB_NAME if embed else INPROC_NAME)
    srcs = [os.path.join(HERE, s) for s in SOURCES]
    if os.path.exists(out) and os.path.getmtime(out) >= max(
            os.path.getmtime(s) for s in srcs):
        return out
    if shutil.which("g++") is None:
        raise BuildError("g++ is not on PATH: it builds the C inference ABI")
    include = sysconfig.get_path("include")
    if not os.path.exists(os.path.join(include, "Python.h")):
        raise BuildError(f"Python.h is not in {include} (the interpreter's "
                         f"development headers are missing)")
    ldflags = python_link_flags() if embed else []
    os.makedirs(outdir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-fPIC", "-shared", "-std=c++17",
           f"-Wl,-soname,{LIB_NAME}", srcs[0], f"-I{include}", f"-I{HERE}",
           "-o", tmp] + ldflags
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise BuildError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                         f"{proc.stderr}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(build(sys.argv[1] if len(sys.argv) > 1 else None))
