"""Durable, atomic, verifiable checkpoints.

Capability parity with the reference checkpoint protocol
(reference: python/paddle/fluid/trainer.py:98 `CheckpointConfig`,
`save_checkpoint` :637 / `load_checkpoint` :737, `_scroll_delete` :1164
rotation, `_write_success` :1186; the distribute transpiler's
checkpoint-notify so pservers save their shards alongside the trainer),
hardened for crash safety:

- **Atomic commit**: a checkpoint is staged in a hidden tmp dir on the
  same filesystem and committed with ONE `os.replace` — a crash at any
  point mid-save leaves either the previous serials intact and the stage
  invisible, or the new serial fully present. There is no `_SUCCESS`
  marker race: the committed dir name IS the success marker.
- **MANIFEST**: every committed serial carries a `MANIFEST.json` with the
  format version, the training cursor (epoch/step/step-in-epoch), RNG
  stream state (the executor run counters that derive the per-step PRNG
  keys), and a sha256 per payload file — `load_checkpoint(verify=True)`
  refuses a bit-rotted or torn checkpoint instead of half-loading it.
- **Rotation**: retain the newest `max_num_checkpoints` serials; older
  ones (and any stale stage dirs from a crashed saver) are deleted after
  a successful commit, never before.
- **Sharded writers**: parameter servers join the same protocol — the
  stage dir is handed to a `shard_saver` callback (PSClient.save) before
  commit, each shard writes its npz atomically with a sidecar manifest,
  and the committing MANIFEST checksums every file it finds, so trainer
  state and all pserver shards commit as one consistent unit.

A copy of ``paddle_tpu/ark/checkpoint.py``: a checkpoint either package
writes, the other reads (`Trainer.train(checkpoint=...)` resumes one).
"""

from __future__ import annotations

import json
import os
import shutil
import time
import uuid
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .. import flags as _flags
from ..io import _fsync_dir, atomic_file, file_sha256
from ..observe import metrics as _metrics

FORMAT_VERSION = 1
SERIAL_PREFIX = "ark_"
STAGE_PREFIX = ".stage_"
MANIFEST_NAME = "MANIFEST.json"
STATE_NAME = "state.npz"
SIDECAR_SUFFIX = ".manifest.json"


class CheckpointError(RuntimeError):
    """A checkpoint is missing, torn, or fails checksum verification."""


class CheckpointConfig:
    """Auto-checkpoint policy for `Trainer.train(..., checkpoint=cfg)`
    (reference trainer.py:98, with the ark durable format underneath).

    `step_interval` saves every N global steps; `epoch_interval` saves at
    the end of every N-th epoch; `verify_on_load` checks manifest sha256s
    before trusting a resume (cheap relative to a training run)."""

    def __init__(self, checkpoint_dir: Optional[str] = None,
                 max_num_checkpoints: int = 3, epoch_interval: int = 1,
                 step_interval: int = 10, verify_on_load: bool = True):
        self.checkpoint_dir = checkpoint_dir or os.path.join(
            os.getcwd(), "checkpoint")
        self.max_num_checkpoints = max(int(max_num_checkpoints), 1)
        self.epoch_interval = max(int(epoch_interval), 1)
        self.step_interval = max(int(step_interval), 1)
        self.verify_on_load = verify_on_load


# -- atomic file primitives: ``io.py``'s (copies of the JAX package's) --

fsync_dir = _fsync_dir


def write_sidecar_manifest(path: str, **extra) -> str:
    """Checksum sidecar for an independently-written shard file (the
    pserver `_h_save` protocol): `<path>.manifest.json` carries the
    sha256 + byte count so `recover()` and `verify_checkpoint()` can
    refuse a torn shard. Written atomically AFTER the payload, so a
    sidecar's presence implies the payload committed."""
    side = path + SIDECAR_SUFFIX
    meta = {"file": os.path.basename(path), "sha256": file_sha256(path),
            "bytes": os.path.getsize(path), **extra}
    with atomic_file(side, "w") as f:
        json.dump(meta, f, indent=1)
    return side


def verify_sidecar(path: str) -> None:
    """Raise CheckpointError if `path` disagrees with its sidecar (a
    missing sidecar passes — pre-ark shards have none)."""
    side = path + SIDECAR_SUFFIX
    if not os.path.exists(side):
        return
    with open(side) as f:
        meta = json.load(f)
    if not os.path.exists(path):
        raise CheckpointError(f"shard {path} is missing but its sidecar "
                              f"manifest exists")
    got = file_sha256(path)
    if got != meta["sha256"]:
        raise CheckpointError(
            f"shard {path} fails checksum verification: sha256 {got} != "
            f"manifest {meta['sha256']} — torn or corrupted shard")


# -- serial-dir layout ---------------------------------------------------

def _serial_dir(root: str, serial: int) -> str:
    return os.path.join(root, f"{SERIAL_PREFIX}{serial:08d}")


def list_checkpoints(checkpoint_dir: str):
    """[(serial, path)] of COMMITTED serials, ascending. Stage dirs and
    foreign entries are ignored — commit is the only success marker."""
    if not checkpoint_dir or not os.path.isdir(checkpoint_dir):
        return []
    out = []
    for name in os.listdir(checkpoint_dir):
        if not name.startswith(SERIAL_PREFIX):
            continue
        tail = name[len(SERIAL_PREFIX):]
        if not tail.isdigit():
            continue
        path = os.path.join(checkpoint_dir, name)
        if os.path.isfile(os.path.join(path, MANIFEST_NAME)):
            out.append((int(tail), path))
    out.sort()
    return out


def latest_checkpoint(checkpoint_dir: str,
                      verify: bool = False) -> Optional[str]:
    """Path of the newest committed serial, or None. With `verify=True`
    serials failing checksum verification are skipped (newest intact one
    wins) — the load-side half of crash safety."""
    for _, path in reversed(list_checkpoints(checkpoint_dir)):
        if verify:
            try:
                verify_checkpoint(path)
            except CheckpointError:
                continue
        return path
    return None


def read_manifest(ckpt_path: str) -> Dict:
    mpath = os.path.join(ckpt_path, MANIFEST_NAME)
    if not os.path.isfile(mpath):
        raise CheckpointError(f"{ckpt_path} has no {MANIFEST_NAME} — not a "
                              f"committed ark checkpoint")
    with open(mpath) as f:
        return json.load(f)


def verify_checkpoint(ckpt_path: str) -> Dict:
    """Check every file the MANIFEST names against its recorded sha256
    (and every pserver sidecar against its shard). Returns the manifest;
    raises CheckpointError naming the first mismatch."""
    manifest = read_manifest(ckpt_path)
    for fname, meta in manifest.get("files", {}).items():
        fpath = os.path.join(ckpt_path, fname)
        if not os.path.exists(fpath):
            raise CheckpointError(
                f"checkpoint {ckpt_path} is torn: {fname} named by "
                f"MANIFEST is missing")
        got = file_sha256(fpath)
        if got != meta["sha256"]:
            raise CheckpointError(
                f"checkpoint {ckpt_path} fails verification: {fname} "
                f"sha256 {got} != manifest {meta['sha256']}")
    return manifest


# -- save / load ---------------------------------------------------------

def save_checkpoint(checkpoint_dir: str,
                    arrays: Dict[str, np.ndarray],
                    cursor: Optional[Dict] = None,
                    rng: Optional[Dict] = None,
                    max_num_checkpoints: int = 3,
                    shard_saver: Optional[Callable[[str], object]] = None,
                    extra: Optional[Dict] = None) -> str:
    """Commit one new serial atomically; returns its path.

    `arrays` (var name -> ndarray) is the trainer-side state — parameters
    AND optimizer slot vars. `cursor` records where training stood
    ({"epoch_id", "step_id", "step_in_epoch"}); `rng` records the
    executor PRNG stream state ({"train_runs", "stream"}) so a resume
    reproduces the uninterrupted run's draws bit-for-bit. `shard_saver`,
    if given, is called with the STAGE path before commit — pservers
    write their shards into it (PSClient.save), joining the same atomic
    unit. Every file present at commit time is checksummed into the
    MANIFEST."""
    t0 = time.perf_counter()
    os.makedirs(checkpoint_dir, exist_ok=True)
    committed = list_checkpoints(checkpoint_dir)
    serial = committed[-1][0] + 1 if committed else 0
    stage = os.path.join(checkpoint_dir,
                         f"{STAGE_PREFIX}{serial:08d}_{uuid.uuid4().hex}")
    os.makedirs(stage)
    try:
        if arrays:
            with atomic_file(os.path.join(stage, STATE_NAME)) as f:
                np.savez(f, **arrays)
        if shard_saver is not None:
            shard_saver(stage)
        files = {}
        for root, _dirs, names in os.walk(stage):
            for name in names:
                if name == MANIFEST_NAME:
                    continue
                fpath = os.path.join(root, name)
                rel = os.path.relpath(fpath, stage)
                side = fpath + SIDECAR_SUFFIX
                if os.path.exists(side):
                    # the shard writer already hashed this payload into
                    # its sidecar — trust it rather than re-reading every
                    # shard byte (the sidecar itself is hashed below)
                    with open(side) as sf:
                        smeta = json.load(sf)
                    files[rel] = {"sha256": smeta["sha256"],
                                  "bytes": smeta["bytes"]}
                else:
                    files[rel] = {"sha256": file_sha256(fpath),
                                  "bytes": os.path.getsize(fpath)}
        manifest = {
            "format_version": FORMAT_VERSION,
            "serial": serial,
            "wall_time": time.time(),
            "cursor": dict(cursor or {}),
            "rng": dict(rng or {}),
            "files": files,
        }
        if extra:
            manifest.update(extra)
        with atomic_file(os.path.join(stage, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, indent=1)
        final = _serial_dir(checkpoint_dir, serial)
        # the commit point: one rename. A concurrent saver losing the race
        # (final already exists) fails here and its stage is discarded.
        os.replace(stage, final)
        # make the commit DURABLE before rotation may unlink an older
        # serial: without the dir fsync a power loss could lose the
        # rename while the unlink persisted, leaving fewer intact
        # serials than promised (or none)
        fsync_dir(checkpoint_dir)
    except BaseException:
        shutil.rmtree(stage, ignore_errors=True)
        raise
    _rotate(checkpoint_dir, max_num_checkpoints)
    if _flags.get_flag("observe"):
        _metrics.counter("ark_checkpoints_saved_total",
                         "committed ark checkpoints").inc()
        _metrics.histogram("ark_checkpoint_save_seconds",
                           "wall time of save_checkpoint").observe(
                               time.perf_counter() - t0)
    return final


def _rotate(checkpoint_dir: str, keep: int) -> None:
    """Delete serials beyond the newest `keep`, plus DEAD stage dirs.
    Runs only after a successful commit. A stage is provably dead once
    its serial is <= the newest committed one (its commit rename would
    hit an existing target); stages for higher serials may belong to a
    concurrent live saver and are left alone."""
    committed = list_checkpoints(checkpoint_dir)
    newest = committed[-1][0] if committed else -1
    for _serial, path in committed[: max(0, len(committed) - keep)]:
        shutil.rmtree(path, ignore_errors=True)
    for name in os.listdir(checkpoint_dir):
        if not name.startswith(STAGE_PREFIX):
            continue
        serial_s = name[len(STAGE_PREFIX):].split("_", 1)[0]
        if serial_s.isdigit() and int(serial_s) > newest:
            continue
        shutil.rmtree(os.path.join(checkpoint_dir, name),
                      ignore_errors=True)


def load_checkpoint(ckpt_path: str,
                    verify: bool = True) -> Tuple[Dict[str, np.ndarray],
                                                  Dict]:
    """Read one committed serial -> (arrays, manifest). `verify=True`
    checksums every manifest-named file first and refuses a torn or
    corrupted checkpoint with CheckpointError (callers fall back to
    `latest_checkpoint(..., verify=True)` for the newest intact one)."""
    manifest = (verify_checkpoint(ckpt_path) if verify
                else read_manifest(ckpt_path))
    arrays: Dict[str, np.ndarray] = {}
    state = os.path.join(ckpt_path, STATE_NAME)
    if os.path.exists(state):
        with np.load(state, allow_pickle=False) as z:
            arrays = {k: z[k].copy() for k in z.files}
    if _flags.get_flag("observe"):
        _metrics.counter("ark_checkpoints_loaded_total",
                         "ark checkpoints restored").inc()
    return arrays, manifest
