"""Model save / load, in the JAX package's model-dir format.

Mirror of ``paddle_tpu/io.py`` (save_vars/load_vars, the persistables
pair, save_inference_model, load_inference_model, load_decode_program).
A model dir is the same on both sides: the program as JSON in
``__model__`` (plus ``__decode__`` for a generative model), one ``.npy``
per persistable, and a ``MANIFEST.json`` naming every file's sha256. So
this package loads a dir that ``paddle_tpu`` saved, and the reverse.

The atomic-file and manifest helpers are this package's own copies of
``paddle_tpu/ark/checkpoint.py``'s.

`state_from_numpy` carries parameters the other way round: it puts a
dict of numpy arrays (for example a JAX-side scope's values) into a
`Scope` as tensors on a place's device.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import tempfile
import time
import uuid
from typing import Dict, List, Optional

import numpy as np

from .core import ir
from .core.executor import Place, Scope, as_tensor, global_scope

MODEL_FILENAME = "__model__"
# the autoregressive decode-step program of a generative model rides next
# to the prefill `__model__` in the same atomic dir
DECODE_FILENAME = "__decode__"
PARAMS_SUFFIX = ".npy"
MODEL_MANIFEST = "MANIFEST.json"


class ModelIntegrityError(RuntimeError):
    """A saved model dir fails sha256 verification against its
    MANIFEST.json — bit rot or a torn copy. The message names the first
    corrupt or missing file."""


# -- atomic file primitives (copies of paddle_tpu/ark/checkpoint.py's) ----

def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_file(path: str, mode: str = "wb"):
    """Write `path` all-or-nothing: a same-directory tmp file, fsynced,
    lands under the final name with one `os.replace`."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_",
                               suffix=os.path.basename(path))
    try:
        with os.fdopen(fd, mode) as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(d)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def file_sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def verify_inference_model(dirname) -> Optional[dict]:
    """Check every file the model dir's MANIFEST.json names against its
    recorded sha256. Returns the manifest, or None for a legacy dir with
    no manifest. Raises ModelIntegrityError naming the first missing or
    corrupt file."""
    path = os.path.join(dirname, MODEL_MANIFEST)
    if not os.path.isfile(path):
        return None
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ModelIntegrityError(
            f"model dir {dirname}: {MODEL_MANIFEST} is unreadable ({e}) — "
            f"torn or corrupted save") from e
    for fname, meta in manifest.get("files", {}).items():
        fpath = os.path.join(dirname, fname)
        if not os.path.exists(fpath):
            raise ModelIntegrityError(
                f"model dir {dirname} is torn: {fname} named by "
                f"{MODEL_MANIFEST} is missing")
        got = file_sha256(fpath)
        if got != meta["sha256"]:
            raise ModelIntegrityError(
                f"model dir {dirname} fails verification: {fname} sha256 "
                f"{got} != manifest {meta['sha256']}")
    return manifest


# -- variables ------------------------------------------------------------

def _is_persistable(var: ir.Variable) -> bool:
    # the KV cache is persistable across steps but never saved: the
    # serving registry materializes zeros of the manifest-declared shape
    return var.persistable and not var.is_data \
        and var.kind == ir.VarKind.DENSE_TENSOR \
        and not var.name.endswith(ir.KV_CACHE_SUFFIX)


def _collect(program: ir.Program, predicate) -> List[ir.Variable]:
    return [v for v in program.global_block().vars.values() if predicate(v)]


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    """One `.npy` a variable, or with `filename` every variable in one
    `.npz` (`filename` + ".npz" unless it ends so), each file written
    atomically (reference io.py:86 save_vars)."""
    main_program = main_program or ir.default_main_program()
    scope = scope or global_scope()
    if vars is None:
        vars = _collect(main_program, predicate or _is_persistable)
    os.makedirs(dirname, exist_ok=True)
    arrays = {}
    for v in vars:
        val = scope.find_var(v.name)
        if val is None:
            raise RuntimeError(f"variable {v.name} not in scope")
        arrays[v.name] = val.detach().cpu().numpy() \
            if hasattr(val, "detach") else np.asarray(val)
    if filename is not None:
        path = os.path.join(dirname, filename)
        if not path.endswith(".npz"):
            path += ".npz"
        with atomic_file(path) as f:
            np.savez(f, **arrays)
        return
    for name, arr in arrays.items():
        with atomic_file(os.path.join(dirname, name + PARAMS_SUFFIX)) as f:
            np.save(f, arr)


def _is_parameter(var: ir.Variable) -> bool:
    return isinstance(var, ir.Parameter)


def save_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    """The program's parameters only (no optimizer state, no stats)."""
    return save_vars(executor, dirname, main_program, None, _is_parameter,
                     filename, scope)


def save_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    return save_vars(executor, dirname, main_program, None, _is_persistable,
                     filename, scope)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    """Load `.npy` files (or the `.npz` that `filename` names) into
    `scope` as tensors on the executor's device (reference io.py:292
    load_vars)."""
    main_program = main_program or ir.default_main_program()
    scope = scope or global_scope()
    device = executor.place.torch_device()
    if vars is None:
        vars = _collect(main_program, predicate or _is_persistable)
    if filename is not None:
        if not filename.endswith(".npz"):
            filename += ".npz"
        with np.load(os.path.join(dirname, filename)) as blob:
            for v in vars:
                scope.set_var(v.name, as_tensor(blob[v.name], device,
                                                v.dtype))
        return
    for v in vars:
        path = os.path.join(dirname, v.name + PARAMS_SUFFIX)
        if not os.path.exists(path):
            raise RuntimeError(
                f"no saved file for variable {v.name} at {path}")
        scope.set_var(v.name, as_tensor(np.load(path), device, v.dtype))


def load_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    return load_vars(executor, dirname, main_program, None, _is_parameter,
                     filename, scope)


def load_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    return load_vars(executor, dirname, main_program, None, _is_persistable,
                     filename, scope)


def state_from_numpy(arrays: Dict[str, np.ndarray], place: Place,
                     scope: Optional[Scope] = None) -> Scope:
    """Put copies of `arrays` (name -> numpy array) into `scope` (a new
    one when None) as tensors on `place`'s device; returns the scope.
    The scope owns its tensors: an in-place update (the KV cache) never
    writes into the caller's arrays."""
    scope = scope if scope is not None else Scope()
    device = place.torch_device()
    for name, arr in arrays.items():
        scope.set_var(name, as_tensor(np.array(arr), device))
    return scope


# -- inference models -------------------------------------------------------

def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, scope=None, extra_programs=None,
                         manifest_extra=None):
    """Prune to the inference slice and persist program + params
    (reference io.py:551). `extra_programs` ({filename: json-able meta})
    lands more program files in the same dir (the decode-step program of
    a generative model); `manifest_extra` is merged into MANIFEST.json
    (its decode signature).

    The dir is staged in a same-parent tmp dir and swapped in at the end,
    so a crash mid-save never leaves a torn dir."""
    main_program = main_program or ir.default_main_program()
    dirname = os.path.abspath(dirname)
    target_names = [v.name if isinstance(v, ir.Variable) else str(v)
                    for v in target_vars]
    pruned = main_program.clone(for_test=True)._prune(target_names)
    meta = {
        "program": pruned.to_dict(),
        "feed_names": list(feeded_var_names),
        "fetch_names": target_names,
    }
    parent = os.path.dirname(dirname) or "."
    os.makedirs(parent, exist_ok=True)
    base = os.path.basename(dirname)
    stage = os.path.join(parent, f".stage_{base}_{uuid.uuid4().hex}")
    os.makedirs(stage)
    try:
        with open(os.path.join(stage, MODEL_FILENAME), "w") as f:
            json.dump(meta, f)
        for extra_name, extra_meta in (extra_programs or {}).items():
            with open(os.path.join(stage, extra_name), "w") as f:
                json.dump(extra_meta, f)
        save_persistables(executor, stage, pruned, scope=scope)
        files = {}
        for name in sorted(os.listdir(stage)):
            path = os.path.join(stage, name)
            files[name] = {"sha256": file_sha256(path),
                           "bytes": os.path.getsize(path)}
        with atomic_file(os.path.join(stage, MODEL_MANIFEST), "w") as f:
            json.dump({"kind": "inference_model", "saved_at": time.time(),
                       "feed_names": list(feeded_var_names),
                       "fetch_names": target_names, "files": files,
                       **(manifest_extra or {})}, f, indent=1)
        if os.path.isdir(dirname):
            old = dirname + f".old_{uuid.uuid4().hex}"
            os.rename(dirname, old)
            try:
                os.rename(stage, dirname)
            except BaseException:
                os.rename(old, dirname)   # roll the previous model back
                raise
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(stage, dirname)
    except BaseException:
        shutil.rmtree(stage, ignore_errors=True)
        raise
    return target_names


def load_inference_model(dirname, executor, scope=None, verify=True):
    """reference io.py:654 — returns (program, feed_names, fetch_vars),
    the params loaded into `scope` on the executor's device. `verify`
    checks the dir against its MANIFEST.json before reading anything."""
    if verify:
        verify_inference_model(dirname)
    with open(os.path.join(dirname, MODEL_FILENAME)) as f:
        meta = json.load(f)
    program = ir.Program.from_dict(meta["program"])
    program._is_inference = True
    load_persistables(executor, dirname, program, scope=scope)
    fetch_vars = [program.global_block().var(n) for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars


def load_decode_program(dirname):
    """A generative model dir's decode-step program: (program, feed_names,
    fetch_names), or None when the dir has none."""
    path = os.path.join(dirname, DECODE_FILENAME)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        meta = json.load(f)
    program = ir.Program.from_dict(meta["program"])
    program._is_inference = True
    return program, list(meta["feed_names"]), list(meta["fetch_names"])


def get_inference_program(target_vars, main_program=None):
    """The test-mode clone of `main_program` pruned to what `target_vars`
    need."""
    main_program = main_program or ir.default_main_program()
    names = [v.name if isinstance(v, ir.Variable) else str(v)
             for v in target_vars]
    return main_program.clone(for_test=True)._prune(names)
