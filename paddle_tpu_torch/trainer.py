"""High-level Trainer / checkpointing.

Mirror of ``paddle_tpu/trainer.py`` (reference python/paddle/fluid/
trainer.py: event classes :38-92, `Trainer` :167, `CheckpointConfig` :98
and the serial-dir checkpoint protocol, `save_checkpoint` :637 /
`load_checkpoint` :737, `_SUCCESS` marker `_write_success` :1186, rotation
`_scroll_delete` :1164).

`Trainer.train(checkpoint=ark.CheckpointConfig(...))` writes the JAX
package's ark checkpoints: parameters, optimizer slots, the cursor and
the executor's run count of the train program (the per-step random
stream of the port's executor: its seed and that count), so a run resumes
bit for bit, and a checkpoint the JAX package's Trainer wrote resumes
here. Fetches come back as numpy.

`Trainer(parallel=True)` trains through `ParallelExecutor` over the
default 'dp' mesh of the world (``parallel/``), as the JAX package's
does, and `Inferencer(parallel=True)` infers through one; both run on
the place's device (a `CUDAPlace` by default: no card raises).

Not ported yet: `pulse_port` with the loss feed of the health plane
(`observe/pulse`, `observe/health`, item 8).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import ark as _ark
from . import flags as _flags
from . import io as fluid_io
from . import unique_name
from .core import ir
from .core.executor import CUDAPlace, Executor, Scope, to_numpy
from .data_feeder import DataFeeder
from .observe import metrics as _obs_metrics
from .observe.tracer import get_tracer as _get_tracer


class BeginEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class EndEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class BeginStepEvent:
    def __init__(self, epoch_id, step_id):
        self.epoch = epoch_id
        self.step = step_id
        self.fetch_metrics = True


class EndStepEvent:
    def __init__(self, epoch_id, step_id, metrics):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


class CheckpointConfig:
    """reference trainer.py:98 — serial checkpoint dirs with rotation."""

    def __init__(self, checkpoint_dir=None, max_num_checkpoints=3,
                 epoch_interval=1, step_interval=10):
        self.checkpoint_dir = checkpoint_dir or os.path.join(
            os.getcwd(), "checkpoint")
        self.max_num_checkpoints = max_num_checkpoints
        self.epoch_interval = max(epoch_interval, 1)
        self.step_interval = max(step_interval, 1)
        self.epoch_id = 0
        self.step_id = 0
        self.load_serial = None


SERIAL_PREFIX = "checkpoint_"
TRAINER_ARGS_NAME = "trainer_args.json"
SUCCESS_MARK = "_SUCCESS"


def _serial_dir(root, serial):
    return os.path.join(root, f"{SERIAL_PREFIX}{serial}")


def get_latest_checkpoint_serial(checkpoint_dir) -> int:
    """Highest serial with a _SUCCESS marker (reference :1203)."""
    if not checkpoint_dir or not os.path.isdir(checkpoint_dir):
        return -1
    best = -1
    for name in os.listdir(checkpoint_dir):
        if not name.startswith(SERIAL_PREFIX):
            continue
        try:
            serial = int(name[len(SERIAL_PREFIX):])
        except ValueError:
            continue
        if os.path.exists(os.path.join(checkpoint_dir, name, SUCCESS_MARK)):
            best = max(best, serial)
    return best


def save_checkpoint(executor, checkpoint_dir, trainer_id, main_program,
                    trainer_args=None, max_num_checkpoints=3, scope=None):
    """Write a new serial dir: params + trainer args + _SUCCESS, then rotate
    (reference :637, :1164, :1186)."""
    serial = get_latest_checkpoint_serial(checkpoint_dir) + 1
    cur = _serial_dir(checkpoint_dir, serial)
    os.makedirs(cur, exist_ok=True)
    fluid_io.save_persistables(executor, cur, main_program, scope=scope)
    if trainer_args is not None:
        with open(os.path.join(cur, f"trainer_{trainer_id}_{TRAINER_ARGS_NAME}"),
                  "w") as f:
            json.dump(trainer_args, f)
    with open(os.path.join(cur, SUCCESS_MARK), "w") as f:
        f.write("")
    # rotate old serials
    serials = sorted(
        int(n[len(SERIAL_PREFIX):]) for n in os.listdir(checkpoint_dir)
        if n.startswith(SERIAL_PREFIX) and n[len(SERIAL_PREFIX):].isdigit())
    for s in serials[: max(0, len(serials) - max_num_checkpoints)]:
        shutil.rmtree(_serial_dir(checkpoint_dir, s), ignore_errors=True)
    return serial


def load_checkpoint(executor, checkpoint_dir, serial, main_program,
                    trainer_id=0, scope=None):
    """Restore params (+ returns trainer args if present) from a serial dir
    (reference :737)."""
    if serial is None or serial < 0:
        raise ValueError(f"no valid checkpoint serial: {serial}")
    cur = _serial_dir(checkpoint_dir, serial)
    if not os.path.exists(os.path.join(cur, SUCCESS_MARK)):
        raise RuntimeError(f"checkpoint {cur} has no {SUCCESS_MARK} marker")
    fluid_io.load_persistables(executor, cur, main_program, scope=scope)
    args_path = os.path.join(cur, f"trainer_{trainer_id}_{TRAINER_ARGS_NAME}")
    if os.path.exists(args_path):
        with open(args_path) as f:
            return json.load(f)
    return None


class Trainer:
    """reference trainer.py:167.

    train_func() -> (loss, [metrics...]) builds the model into the trainer's
    programs; optimizer_func() -> Optimizer. The place defaults to
    CUDAPlace(0).
    """

    def __init__(self, train_func: Callable, optimizer_func: Callable,
                 param_path=None, place=None, parallel=False,
                 checkpoint_config: Optional[CheckpointConfig] = None,
                 pulse_port: Optional[int] = None):
        if pulse_port is not None:
            raise NotImplementedError(
                "Trainer(pulse_port=...): the health plane (observe/pulse) "
                "is not ported yet (ROADMAP Queue 1 item 8)")
        self.place = place or CUDAPlace(0)
        self.pulse_port = None
        self.parallel = parallel
        self.checkpoint_cfg = checkpoint_config
        self.scope = Scope()
        self.startup_program = ir.Program()
        self.train_program = ir.Program()
        with ir.program_guard(self.train_program, self.startup_program), \
                unique_name.guard():
            out = train_func()
            if isinstance(out, (list, tuple)):
                self.loss = out[0]
                self.metrics = list(out[1]) if len(out) > 1 and \
                    isinstance(out[1], (list, tuple)) else list(out[1:])
            else:
                self.loss = out
                self.metrics = []
            optimizer = optimizer_func()
            optimizer.minimize(self.loss)
        self.test_program = self.train_program.clone(for_test=True)

        self.exe = Executor(self.place)
        self.exe.run(self.startup_program, scope=self.scope)
        if param_path:
            fluid_io.load_persistables(self.exe, param_path,
                                       self.train_program, scope=self.scope)
        if self.checkpoint_cfg:
            serial = get_latest_checkpoint_serial(
                self.checkpoint_cfg.checkpoint_dir)
            if serial >= 0:
                args = load_checkpoint(self.exe,
                                       self.checkpoint_cfg.checkpoint_dir,
                                       serial, self.train_program,
                                       scope=self.scope)
                if args:
                    self.checkpoint_cfg.epoch_id = args.get("epoch_id", 0)
                    self.checkpoint_cfg.step_id = args.get("step_id", 0)
        # prepared-step handles per fetch set (Executor.prepare): the
        # train loop's per-step host work skips the scope gather plan
        self._prepared = {}
        self._pe = None     # the ParallelExecutor of parallel=True

    def _executor_run(self, feed, fetch_list):
        if self.parallel:
            if self._pe is None:
                from .parallel import ParallelExecutor
                self._pe = ParallelExecutor(
                    use_cuda=self.place.torch_device().type == "cuda",
                    main_program=self.train_program,
                    loss_name=self.loss.name, scope=self.scope)
                self._pe._run_counter = int(self.exe._run_counts.get(
                    self.train_program._uid, 0))
            out = self._pe.run(fetch_list=fetch_list, feed=feed)
            # the run count an ark checkpoint records
            self.exe._run_counts[self.train_program._uid] = \
                self._pe._run_counter
            return out
        key = tuple(f.name if isinstance(f, ir.Variable) else str(f)
                    for f in fetch_list)
        # re-prepare when the program mutates or a flag flips, as
        # Executor.run()'s memo does
        ver = (self.train_program._version, _flags.version())
        hit = self._prepared.get(key)
        if hit is None or hit[1] != ver:
            hit = (self.exe.prepare(self.train_program,
                                    fetch_list=fetch_list,
                                    scope=self.scope), ver)
            self._prepared[key] = hit
        return hit[0].run(feed)

    # -- ark durable checkpoints ------------------------------------------
    def _ark_state(self):
        """(arrays, rng) for an ark checkpoint: every persistable var of
        the train program — parameters AND optimizer slot vars — plus the
        executor's run count of the train program, from which (with the
        program's seed) each step's random stream derives, so a resumed
        run draws what the uninterrupted run would have. The JAX
        package's "stream" ordinal has no counterpart here: the port's
        unseeded programs all take seed 0."""
        arrays = {}
        for v in fluid_io._collect(self.train_program,
                                   fluid_io._is_persistable):
            val = self.scope.find_var(v.name)
            if val is not None:
                arrays[v.name] = to_numpy(val) \
                    if isinstance(val, torch.Tensor) else np.asarray(val)
        uid = self.train_program._uid
        rng = {"train_runs": int(self.exe._run_counts.get(uid, 0))}
        return arrays, rng

    def _ark_restore(self, arrays, manifest):
        for v in fluid_io._collect(self.train_program,
                                   fluid_io._is_persistable):
            if v.name in arrays:
                self.scope.set_var(v.name, arrays[v.name])
        rng = manifest.get("rng", {})
        if "train_runs" in rng:
            self.exe._run_counts[self.train_program._uid] = \
                int(rng["train_runs"])

    def _ark_save(self, cfg, epoch_id, step_id, step_in_epoch):
        arrays, rng = self._ark_state()
        return _ark.save_checkpoint(
            cfg.checkpoint_dir, arrays,
            cursor={"epoch_id": int(epoch_id), "step_id": int(step_id),
                    "step_in_epoch": int(step_in_epoch)},
            rng=rng, max_num_checkpoints=cfg.max_num_checkpoints)

    def train(self, num_epochs, event_handler=None, reader=None,
              feed_order=None, checkpoint=None):
        """`checkpoint=ark.CheckpointConfig(...)` turns on durable
        auto-checkpointing: the newest intact serial is restored before
        the first step (params + optimizer slots + run count; already-
        consumed batches of the resume epoch are skipped, so with a
        deterministic reader the resumed run's fetches equal the
        uninterrupted run's), and a new serial commits atomically
        every `step_interval` steps / `epoch_interval` epochs with
        retained-N rotation. The legacy `checkpoint_config` constructor
        path is unchanged."""
        event_handler = event_handler or (lambda e: None)
        feeder = DataFeeder(feed_order, program=self.train_program)
        if checkpoint is not None and \
                not isinstance(checkpoint, _ark.CheckpointConfig):
            raise TypeError(
                f"checkpoint= takes an ark.CheckpointConfig, got "
                f"{type(checkpoint).__name__} (the legacy "
                f"trainer.CheckpointConfig goes to Trainer("
                f"checkpoint_config=...))")
        ark_cfg = checkpoint
        # resume the global step counter from the restored checkpoint so the
        # save cadence and trainer_args don't regress after a restart
        step = self.checkpoint_cfg.step_id if self.checkpoint_cfg else 0
        start_epoch = self.checkpoint_cfg.epoch_id if self.checkpoint_cfg else 0
        skip_in_epoch = 0
        if ark_cfg is not None:
            latest = _ark.latest_checkpoint(ark_cfg.checkpoint_dir,
                                            verify=ark_cfg.verify_on_load)
            if latest is not None:
                # checksums already verified picking `latest`
                arrays, manifest = _ark.load_checkpoint(latest, verify=False)
                self._ark_restore(arrays, manifest)
                cursor = manifest.get("cursor", {})
                start_epoch = int(cursor.get("epoch_id", 0))
                step = int(cursor.get("step_id", 0))
                skip_in_epoch = int(cursor.get("step_in_epoch", 0))
        for epoch in range(start_epoch, num_epochs):
            event_handler(BeginEpochEvent(epoch))
            epoch_ts, epoch_t0 = time.time(), time.perf_counter()
            epoch_start_step = step
            skip = skip_in_epoch if epoch == start_epoch else 0
            for batch_idx, batch in enumerate(reader()):
                if batch_idx < skip:
                    continue   # replayed by the reader, consumed pre-crash
                begin = BeginStepEvent(epoch, step)
                event_handler(begin)
                fetch = [self.loss] + self.metrics if begin.fetch_metrics else []
                out = self._executor_run(feeder.feed(batch), fetch)
                event_handler(EndStepEvent(epoch, step,
                                           [np.asarray(o) for o in out]))
                step += 1
                if ark_cfg is not None and \
                        step % ark_cfg.step_interval == 0:
                    self._ark_save(ark_cfg, epoch, step, batch_idx + 1)
                if self.checkpoint_cfg and \
                        step % self.checkpoint_cfg.step_interval == 0:
                    save_checkpoint(
                        self.exe, self.checkpoint_cfg.checkpoint_dir, 0,
                        self.train_program,
                        trainer_args={"epoch_id": epoch, "step_id": step},
                        max_num_checkpoints=self.checkpoint_cfg.max_num_checkpoints,
                        scope=self.scope)
            if _flags.get_flag("observe"):
                # the per-epoch summary
                dur = time.perf_counter() - epoch_t0
                n_steps = step - epoch_start_step
                _obs_metrics.counter(
                    "trainer_epochs_total", "completed epochs").inc()
                _obs_metrics.histogram(
                    "trainer_epoch_seconds", "wall time per epoch"
                ).observe(dur)
                _obs_metrics.gauge(
                    "trainer_last_epoch_steps",
                    "steps run in the most recent epoch").set(n_steps)
                _get_tracer().record(
                    "epoch", epoch_ts, dur, cat="trainer", epoch=epoch,
                    steps=n_steps,
                    steps_per_sec=round(n_steps / dur, 3) if dur else 0.0)
            if ark_cfg is not None and \
                    (epoch + 1) % ark_cfg.epoch_interval == 0:
                # epoch-boundary serial: cursor points AT the next epoch
                self._ark_save(ark_cfg, epoch + 1, step, 0)
            event_handler(EndEpochEvent(epoch))

    def test(self, reader, feed_order):
        feeder = DataFeeder(feed_order, program=self.test_program)
        totals = None
        count = 0
        for batch in reader():
            out = self.exe.run(self.test_program, feed=feeder.feed(batch),
                               fetch_list=[self.loss] + self.metrics,
                               scope=self.scope)
            vals = [float(np.asarray(o).reshape(-1)[0]) for o in out]
            totals = vals if totals is None else [a + b for a, b in
                                                 zip(totals, vals)]
            count += 1
        return [t / max(count, 1) for t in (totals or [])]

    def save_params(self, param_path):
        fluid_io.save_persistables(self.exe, param_path, self.train_program,
                                   scope=self.scope)

    def save_inference_model(self, param_path, feeded_var_names,
                             target_var_indexs):
        targets = [self.loss] if not target_var_indexs else \
            [self.metrics[i] for i in target_var_indexs]
        fluid_io.save_inference_model(param_path, feeded_var_names, targets,
                                      self.exe, self.train_program,
                                      scope=self.scope)

    def stop(self):
        pass


class Inferencer:
    """reference inferencer.py companion. The place defaults to
    CUDAPlace(0)."""

    def __init__(self, infer_func: Callable, param_path: str, place=None,
                 parallel=False):
        self.place = place or CUDAPlace(0)
        self.scope = Scope()
        self.startup_program = ir.Program()
        self.inference_program = ir.Program()
        with ir.program_guard(self.inference_program, self.startup_program), \
                unique_name.guard():
            self.predict_var = infer_func()
        self.exe = Executor(self.place)
        self.exe.run(self.startup_program, scope=self.scope)
        fluid_io.load_persistables(self.exe, param_path,
                                   self.inference_program, scope=self.scope)
        self.inference_program = self.inference_program.clone(for_test=True)
        self._pe = None
        if parallel:
            from .parallel import ParallelExecutor
            self._pe = ParallelExecutor(
                use_cuda=self.place.torch_device().type == "cuda",
                main_program=self.inference_program, scope=self.scope)

    def infer(self, inputs):
        if self._pe is not None:
            return self._pe.run(fetch_list=[self.predict_var.name],
                                feed=inputs)
        return self.exe.run(self.inference_program, feed=inputs,
                            fetch_list=[self.predict_var], scope=self.scope)
