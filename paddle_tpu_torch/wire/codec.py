"""Host-side wire codecs for the communication-compression layer.

Mirror of ``paddle_tpu/wire/codec.py``, copied: it is numpy only. The
codecs carry the port's parameter-server traffic (`pserver/`), serve
`ErrorFeedback`, and state the numbers the in-graph `comm_quant_dequant`
rule (``wire/graph.py``) is held to bit for bit.

Reference analog: the reference pserver assumed compressed wire traffic
(the TF system paper's parameter-server story); EQuARX (PAPERS.md) shows
quantized collectives deliver ~2x at negligible quality loss. This module
is the HOST half of fluid-wire: numpy codecs that turn a float32 tensor
into a compact tagged payload riding the existing length-prefixed pickle
frames of `pserver/rpc.py` — the rpc layer itself is codec-agnostic, it
just moves whatever the payload dict holds.

Wire format ("codec-tagged payload"): an encoded tensor travels as a
plain dict

    {"__wire__": 1, "codec": "int8", "shape": [...], "dtype": "float32",
     "chunk": 2048, "scale": float32[n_chunks], "data": int8[n]}

(bf16 drops chunk/scale and carries uint16 mantissa-rounded halves).
Every field is a container, str, int, or numpy array — exactly what the
restricted unpickler already admits, so no new trust surface. A RAW
tensor stays a bare ndarray (the legacy payload, byte-identical to
pre-wire traffic): servers tell the two apart with `is_encoded`, so a
legacy peer that never sends tagged payloads interoperates unchanged —
the same compatibility posture as the xray 2-tuple/3-tuple frame.

Codecs:

    raw   — identity (ndarray passthrough), the default
    bf16  — round-to-nearest-even truncation to bfloat16 (2.0x)
    int8  — per-chunk abs-max scaling to int8 (~3.97x at chunk 2048)

Error handling is LOUD by contract: a non-finite tensor refuses to
encode with `NonFiniteTensorError` naming the tensor (quantizing an inf
would silently saturate every element of its chunk), and a float64
tensor refuses with `WireCodecError` (the comm boundary is float32 —
the `comm-float64` lint enforces the same contract statically on the
in-graph path).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

WIRE_TAG = "__wire__"
WIRE_VERSION = 1
CODECS = ("raw", "bf16", "int8")
DEFAULT_CHUNK = 2048
# int8 symmetric range: +-127 (not -128: abs-max scaling is symmetric,
# matching the reference fake_quantize abs_max bin count (1<<7)-1)
_INT8_BINS = 127.0


class WireCodecError(ValueError):
    """The tensor cannot travel through the requested codec (wrong dtype,
    unknown codec, malformed payload)."""


class NonFiniteTensorError(WireCodecError):
    """The tensor holds inf/nan: quantizing it would silently saturate
    the whole chunk, so the encode refuses, naming the tensor."""


def _check_encodable(arr: np.ndarray, codec: str, name: str) -> np.ndarray:
    if codec not in CODECS:
        raise WireCodecError(
            f"unknown wire codec {codec!r} for {name!r}; known: {CODECS}")
    arr = np.asarray(arr)
    if arr.dtype != np.float32:
        raise WireCodecError(
            f"wire codec {codec!r} encodes float32 tensors only; {name!r} "
            f"is {arr.dtype} — the communication boundary is float32 "
            f"(see the comm-float64 lint for the in-graph contract)")
    if arr.size and not np.isfinite(arr).all():
        raise NonFiniteTensorError(
            f"tensor {name!r} holds inf/nan values — refusing to quantize "
            f"(an inf abs-max would saturate its whole chunk to zero "
            f"information); fix the producing step or clip first")
    return arr


def _bf16_round(arr: np.ndarray) -> np.ndarray:
    """f32 -> uint16 bfloat16 halves, round-to-nearest-even."""
    u = arr.ravel().view(np.uint32)
    rounded = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
               ) >> np.uint32(16)
    return rounded.astype(np.uint16)


def _bf16_expand(data: np.ndarray) -> np.ndarray:
    return (data.astype(np.uint32) << np.uint32(16)).view(np.float32)


def _int8_scales(arr_flat: np.ndarray, chunk: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(padded [n_chunks, chunk] view, per-chunk scale). scale is
    abs-max/127, clamped so an all-zero chunk divides by 1 (and decodes
    to exact zeros)."""
    n = arr_flat.size
    pad = (-n) % chunk
    if pad:
        arr_flat = np.concatenate(
            [arr_flat, np.zeros(pad, dtype=arr_flat.dtype)])
    x = arr_flat.reshape(-1, chunk)
    scale = (np.abs(x).max(axis=1) / np.float32(_INT8_BINS)).astype(
        np.float32)
    safe = np.where(scale > 0, scale, np.float32(1.0)).astype(np.float32)
    return x, safe


def _encode(arr: np.ndarray, codec: str, name: str, chunk: int,
            with_deq: bool):
    """Shared encode core: (payload, dequantized-or-None). The dequant
    reuses the q/scale arrays already in hand, so error feedback never
    pays a second decode pass over the frame it just built."""
    arr = _check_encodable(arr, codec, name)
    if codec == "bf16":
        data = _bf16_round(arr)
        payload = {WIRE_TAG: WIRE_VERSION, "codec": "bf16",
                   "shape": list(arr.shape), "dtype": "float32",
                   "data": data}
        deq = _bf16_expand(data).reshape(arr.shape) if with_deq else None
        return payload, deq
    # int8, per-chunk abs-max scale
    chunk = max(int(chunk), 1)
    x, safe = _int8_scales(arr.ravel(), chunk)
    q = np.rint(np.clip(x / safe[:, None], -_INT8_BINS, _INT8_BINS)
                ).astype(np.int8)
    payload = {WIRE_TAG: WIRE_VERSION, "codec": "int8",
               "shape": list(arr.shape), "dtype": "float32",
               "chunk": chunk, "scale": safe,
               "data": q.ravel()[: arr.size]}
    deq = None
    if with_deq:
        deq = (q.astype(np.float32) * safe[:, None]
               ).ravel()[: arr.size].reshape(arr.shape)
    return payload, deq


def encode_tensor(arr: Any, codec: str, name: str = "<tensor>",
                  chunk: int = DEFAULT_CHUNK):
    """Encode one tensor. Returns the tagged payload dict — or, for
    codec "raw", the bare ndarray (the legacy wire shape, so a raw
    client's bytes are bit-identical to pre-wire traffic)."""
    if codec == "raw" or codec is None:
        return np.asarray(arr)
    return _encode(arr, codec, name, chunk, with_deq=False)[0]


def encode_with_dequant(arr: Any, codec: str, name: str = "<tensor>",
                        chunk: int = DEFAULT_CHUNK):
    """(payload, dequantized f32 array): what `decode_tensor(payload)`
    would return, computed from the encoder's own q/scale arrays —
    bit-identical to the decode (test-pinned), without a second pass.
    For "raw" the payload IS the array and the dequant is the array."""
    if codec == "raw" or codec is None:
        a = np.asarray(arr)
        return a, a
    return _encode(arr, codec, name, chunk, with_deq=True)


def is_encoded(obj: Any) -> bool:
    return isinstance(obj, dict) and WIRE_TAG in obj


def decode_tensor(payload: Dict[str, Any]) -> np.ndarray:
    """Tagged payload -> float32 ndarray. Malformed payloads raise
    WireCodecError naming what is wrong (a corrupt frame must surface as
    a diagnosable error reply, never a half-decoded tensor)."""
    try:
        codec = payload["codec"]
        shape = tuple(int(d) for d in payload["shape"])
        data = np.asarray(payload["data"])
    except (KeyError, TypeError, ValueError) as e:
        raise WireCodecError(f"malformed wire payload: {e!r}") from e
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if codec == "bf16":
        if data.dtype != np.uint16 or data.size != n:
            raise WireCodecError(
                f"bf16 payload holds {data.size} x {data.dtype}, expected "
                f"{n} x uint16 for shape {shape}")
        return _bf16_expand(data).reshape(shape)
    if codec == "int8":
        chunk = int(payload.get("chunk", DEFAULT_CHUNK))
        if chunk < 1:
            raise WireCodecError(
                f"int8 payload chunk is {chunk}, expected >= 1")
        scale = np.asarray(payload.get("scale"))
        if data.dtype != np.int8 or data.size != n:
            raise WireCodecError(
                f"int8 payload holds {data.size} x {data.dtype}, expected "
                f"{n} x int8 for shape {shape}")
        if payload.get("scale") is None or scale.ndim != 1 \
                or scale.dtype.kind != "f":
            raise WireCodecError(
                f"int8 payload scale is "
                f"{scale.dtype if payload.get('scale') is not None else None}"
                f" (ndim {scale.ndim}), expected a 1-d float array of "
                f"per-chunk scales")
        n_chunks = (n + chunk - 1) // chunk if n else 0
        if scale.size != n_chunks:
            raise WireCodecError(
                f"int8 payload carries {scale.size} chunk scales, "
                f"expected {n_chunks} (chunk={chunk}, n={n})")
        if not n:
            return np.zeros(shape, np.float32)
        # O(n) dequant: per-element scales via repeat with a short final
        # chunk — the padded tail is never materialized, so a corrupt
        # frame advertising a huge `chunk` cannot force a chunk-sized
        # allocation (it decodes in O(data) or fails the checks above)
        counts = np.full(n_chunks, chunk, dtype=np.int64)
        counts[-1] = n - chunk * (n_chunks - 1)
        out = data.astype(np.float32) * np.repeat(
            scale.astype(np.float32), counts)
        return out.reshape(shape)
    raise WireCodecError(f"unknown wire codec {codec!r} in payload")


def maybe_decode(obj: Any) -> np.ndarray:
    """Server-side entry: decode a tagged payload, pass a raw array
    through — the one call that makes every handler legacy-compatible."""
    if is_encoded(obj):
        return decode_tensor(obj)
    return np.asarray(obj)


def payload_nbytes(obj: Any) -> int:
    """On-wire tensor bytes of a payload (data + scales for encoded
    payloads, nbytes for raw arrays) — what the wire byte counters
    record. Framing/pickle overhead is excluded on both sides of the
    raw/encoded comparison, so the ratio is the codec's own."""
    if is_encoded(obj):
        total = 0
        for k in ("data", "scale"):
            v = obj.get(k)
            if v is not None:
                total += np.asarray(v).nbytes
        return total
    return np.asarray(obj).nbytes


def compression_ratio(raw_nbytes: float, encoded_nbytes: float) -> float:
    return raw_nbytes / encoded_nbytes if encoded_nbytes else 0.0
