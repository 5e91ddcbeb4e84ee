"""Core type vocabulary for the program IR.

Mirror of ``paddle_tpu/core/types.py``. Dtypes stay plain strings in the
IR (so program JSON is shared with the JAX package), and map 1:1 onto
torch and numpy dtypes here.

One documented difference: index outputs are native int64. The JAX
package runs in x32 mode, where int64 does not exist, and emits int32.
"""

from __future__ import annotations

import enum
import functools

import numpy as np
import torch


class VarKind(enum.Enum):
    DENSE_TENSOR = "dense_tensor"
    SELECTED_ROWS = "selected_rows"
    TENSOR_ARRAY = "tensor_array"
    READER = "reader"
    STEP_SCOPES = "step_scopes"
    RAW = "raw"


# Canonical dtype strings -> torch dtypes.
_TORCH = {
    "bool": torch.bool,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}

_ALIASES = {
    "fp16": "float16",
    "fp32": "float32",
    "fp64": "float64",
    "bf16": "bfloat16",
    "half": "float16",
    "float": "float32",
    "double": "float64",
    "int": "int32",
    "long": "int64",
}

_FROM_TORCH = {v: k for k, v in _TORCH.items()}

FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")

def canonical_dtype(dtype) -> str:
    """Normalize a dtype (str / np.dtype / torch.dtype) to its canonical
    string."""
    if isinstance(dtype, torch.dtype):
        name = _FROM_TORCH.get(dtype)
    elif isinstance(dtype, str):
        name = _ALIASES.get(dtype, dtype)
    else:
        name = np.dtype(dtype).name
        name = _ALIASES.get(name, name)
    if name not in _TORCH:
        raise ValueError(f"unsupported dtype: {dtype!r}")
    return name


def torch_dtype(dtype) -> torch.dtype:
    return _TORCH[canonical_dtype(dtype)]


def np_dtype(dtype) -> np.dtype:
    name = canonical_dtype(dtype)
    if name == "bfloat16":
        raise ValueError("numpy has no bfloat16; keep bfloat16 data in torch")
    return np.dtype(name)


@functools.lru_cache(maxsize=256)
def scalar_as(value, dtype: torch.dtype):
    """A Python number about to meet a tensor of `dtype`, rounded to that
    dtype first when it is a floating one, as JAX's weak typing rounds
    it. PyTorch would multiply a bf16 tensor by the unrounded scalar in
    float32 and then round, one bf16 ulp off JAX's result in about a
    third of the elements; for float32 the rounding changes nothing."""
    if dtype in (torch.bfloat16, torch.float16, torch.float32):
        return float(torch.tensor(value, dtype=dtype))
    return value


def is_float_dtype(dtype) -> bool:
    return canonical_dtype(dtype) in FLOAT_DTYPES
