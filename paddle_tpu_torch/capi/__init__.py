"""The C inference ABI (reference: paddle/legacy/capi,
paddle/fluid/inference/api/paddle_inference_api.h): the port of
``paddle_tpu/capi/``.

``paddle_tpu_capi.h`` declares the ``PD_*`` functions and ``PD_Tensor``
exactly as the JAX package's header does. ``capi.cc`` embeds CPython and
drives ``paddle_tpu_torch.capi_runtime``. `build()` compiles the shim
with ``g++`` into ``paddle_tpu_torch/_build/`` at first use and returns
the library's path; `LIB_PATH` is where it goes and `INCLUDE_DIR` holds
the header. `load()` opens a library of this ABI (the port's, or the JAX
package's: the same symbols) with ctypes, every function's signature
declared; `PDTensor` is ``PD_Tensor``'s layout. Nothing is built when
this package is imported.
"""

import ctypes
import os

from .build import BUILD_DIR, BuildError, LIB_NAME, build

INCLUDE_DIR = os.path.dirname(os.path.abspath(__file__))
LIB_PATH = os.path.join(BUILD_DIR, LIB_NAME)

# PD_DType
PD_FLOAT32, PD_INT32, PD_INT64 = 0, 1, 2


class PDTensor(ctypes.Structure):
    """``PD_Tensor``: name (NULL = positional), dtype, shape, rank, data."""
    _fields_ = [("name", ctypes.c_char_p), ("dtype", ctypes.c_int),
                ("shape", ctypes.POINTER(ctypes.c_int64)),
                ("rank", ctypes.c_int), ("data", ctypes.c_void_p)]


_SIGNATURES = {   # name: (restype, argtypes), as paddle_tpu_capi.h declares
    "PD_CreatePredictor": (ctypes.c_void_p, [ctypes.c_char_p]),
    "PD_PredictorRun": (ctypes.c_void_p, [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_int]),
    "PD_ResultsNum": (ctypes.c_int, [ctypes.c_void_p]),
    "PD_ResultsName": (ctypes.c_char_p, [ctypes.c_void_p, ctypes.c_int]),
    "PD_ResultsDType": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int]),
    "PD_ResultsRank": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int]),
    "PD_ResultsShape": (ctypes.POINTER(ctypes.c_int64),
                        [ctypes.c_void_p, ctypes.c_int]),
    "PD_ResultsData": (ctypes.c_void_p, [ctypes.c_void_p, ctypes.c_int]),
    "PD_ResultsByteSize": (ctypes.c_size_t, [ctypes.c_void_p, ctypes.c_int]),
    "PD_DestroyResults": (None, [ctypes.c_void_p]),
    "PD_DestroyPredictor": (None, [ctypes.c_void_p]),
    "PD_LastError": (ctypes.c_char_p, []),
}


def load(path=None) -> ctypes.CDLL:
    """The library at `path` (default: `build()`'s) by ctypes, each
    ``PD_*`` function's restype and argtypes set."""
    lib = ctypes.CDLL(path or build())
    for name, (res, args) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


__all__ = ["build", "BuildError", "load", "PDTensor", "LIB_PATH",
           "INCLUDE_DIR", "PD_FLOAT32", "PD_INT32", "PD_INT64"]
