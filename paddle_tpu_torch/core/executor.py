"""Scope + Executor: run programs on one device, op by op.

Mirror of ``paddle_tpu/core/executor.py``. The JAX package lowers a whole
block to one jitted XLA step, donating mutable state so updates land in
place. Here the block runs eagerly (``core/lowering.py``) against the
scope's device tensors:

- parameters and other persistable state live in the `Scope` as tensors
  on the place's device;
- a persistable output that aliases an input (the paged KV cache's
  ``KCacheOut`` -> ``KCache``, Adam's ``ParamOut``/``Moment1Out``/... ->
  ``Param``/``Moment1``/...) is updated in place by its op and written
  back as the same tensor, so neither a decode step nor an optimizer
  step copies its state, and no stale copy outlives the step;
- a training program (grad ops from ``core/backward.py`` and update ops)
  runs through the same `PreparedProgram.run`: its grad ops recompute
  their forward rules under autograd (``core/lowering.py``);
- `prepare()` resolves the per-program work once (which scope vars a
  step reads and writes) and returns a `PreparedProgram` whose `run(feed)`
  is the fast path.

A variable-length input (`layers.data(..., lod_level=1)`) is fed as a
`(padded, lengths)` pair, a nested one as `(padded, (outer counts,
inner lengths))`; `convert_feed` turns the lengths into the int32
`@SEQLEN` companions the sequence ops read.

Under `Executor(amp=True)` every rule runs under the JAX package's bf16
policy (``core/registry.py``): feeds, parameters and optimizer state stay
float32 in the scope, and are cast at their point of use. A fetched bf16
value comes back as float32 numpy (an exact upcast; numpy has no bf16).

`run(feed=None)` on a program that a `py_reader` is bound to pops the
reader's next batch, and raises `EOFException` when its pass is drained.

`CPUPlace()` runs on the host; `CUDAPlace(i)` on card i. An `Executor()`
without a place means `CUDAPlace(0)`, which raises when no card is
visible: nothing falls back to the host silently.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from . import ir, registry, types
from .. import flags as _flags
from .lowering import run_block


class EOFException(Exception):
    """A py_reader's data pass is drained (reference
    operators/reader/lod_tensor_blocking_queue.h; surfaced as
    core.EOFException in python)."""


# ---------------------------------------------------------------------------
# Places (reference: platform/place.h)
# ---------------------------------------------------------------------------

class Place:
    def torch_device(self) -> torch.device:
        raise NotImplementedError


class CPUPlace(Place):
    def torch_device(self) -> torch.device:
        return torch.device("cpu")

    def __repr__(self):
        return "CPUPlace()"


class CUDAPlace(Place):
    """One NVIDIA card. Raises at construction when there is none."""

    def __init__(self, device_id: int = 0):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"CUDAPlace({device_id}): no CUDA device is visible "
                f"(torch.cuda.is_available() is False) — pass CPUPlace() "
                f"to run on the host")
        if not 0 <= device_id < torch.cuda.device_count():
            raise RuntimeError(
                f"CUDAPlace({device_id}): only "
                f"{torch.cuda.device_count()} CUDA device(s) visible")
        self.device_id = int(device_id)

    def torch_device(self) -> torch.device:
        return torch.device("cuda", self.device_id)

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"


class Scope:
    """Name -> tensor holder with lookup through a parent scope
    (reference scope.h:39)."""

    _uid_counter = itertools.count()

    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, Any] = {}
        self._parent = parent
        self._kids: List["Scope"] = []
        self._uid = next(Scope._uid_counter)

    def new_scope(self) -> "Scope":
        """A child scope whose lookups fall back to this one."""
        kid = Scope(self)
        self._kids.append(kid)
        return kid

    def drop_kids(self):
        self._kids = []

    def var(self, name: str):
        """The variable in THIS scope only, or None."""
        return self._vars.get(name)

    def find_var(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s._parent
        return None

    def set_var(self, name: str, value):
        self._vars[name] = value

    def has_var(self, name: str) -> bool:
        return self.find_var(name) is not None

    def local_var_names(self) -> List[str]:
        return list(self._vars)

    def erase(self, names):
        for n in names:
            self._vars.pop(n, None)


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


def _switch_scope(scope: Scope) -> Scope:
    """Make `scope` the process-global scope; returns the previous one
    (reference executor.py _switch_scope)."""
    global _global_scope
    prev = _global_scope
    _global_scope = scope
    return prev


@contextlib.contextmanager
def scope_guard(scope: Scope):
    """Run a `with` region against `scope` as the global scope (reference
    executor.py scope_guard)."""
    prev = _switch_scope(scope)
    try:
        yield
    finally:
        _switch_scope(prev)


def as_tensor(value, device, dtype: Optional[str] = None) -> torch.Tensor:
    """A feed or scope value as a tensor on `device`, cast to `dtype`
    (the IR dtype string) when it is a numeric value of another type —
    the reference DataFeeder's implicit cast."""
    if isinstance(value, torch.Tensor):
        t = value
    else:
        arr = np.asarray(value)
        if dtype is not None and arr.dtype.kind in "fiub" \
                and arr.dtype != types.np_dtype(dtype):
            arr = arr.astype(types.np_dtype(dtype))
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:     # a tensor may be updated in place
            arr = arr.copy()
        t = torch.from_numpy(arr)
    if dtype is not None and t.dtype != types.torch_dtype(dtype):
        t = t.to(types.torch_dtype(dtype))
    return t.to(device)


def convert_feed(block: ir.Block, feed: Dict[str, Any],
                 device) -> Dict[str, torch.Tensor]:
    """A user's feed dict as tensors on `device`. A variable-length input
    (`lod_level` > 0) takes a `(data, lengths)` pair, or for a nested one
    `(data, (outer counts [B], inner lengths [B, S]))`, and its lengths
    become the int32 companions `name@SEQLEN` (and `name@SEQLEN.1`), the
    JAX package's `_convert_feed_dict`."""
    feeds = {}
    for name, val in feed.items():
        var = block.vars.get(name)
        if isinstance(val, (tuple, list)) and len(val) == 2 \
                and var is not None and var.lod_level > 0:
            data, lens = val
            feeds[name] = as_tensor(data, device, var.dtype)
            if isinstance(lens, (tuple, list)) and len(lens) == 2 \
                    and not np.isscalar(lens[0]):
                feeds[ir.seqlen_var_name(name)] = as_tensor(
                    lens[0], device, "int32")
                feeds[ir.seqlen_var_name(name, 1)] = as_tensor(
                    lens[1], device, "int32")
            else:
                feeds[ir.seqlen_var_name(name)] = as_tensor(
                    lens, device, "int32")
        else:
            feeds[name] = as_tensor(val, device,
                                    var.dtype if var is not None else None)
    return feeds


class _StepPlan:
    """Which scope vars a (program, feed-name set) step reads, which
    persistable vars it writes, and which vars anything reads at all
    (`live`: every op input, a sub-block's external reads, the fetches
    and the write-backs) — resolved
    once per prepared handle. A rule skips an output that is not live
    (``LoweringContext.wants``), as XLA drops an unread expression."""

    def __init__(self, program: ir.Program, feed_names, scope: Scope,
                 fetch_names=()):
        block = program.global_block()
        produced = set(feed_names)
        read: List[str] = []
        written: List[str] = []
        live = set(fetch_names)
        for op in block.ops:
            # a control-flow op's sub-blocks read vars of this block too:
            # a parameter only a loop body reads is loaded from the scope
            # and its producers' outputs count as read
            in_names = list(op.input_arg_names)
            for si in ir.sub_block_indices(op):
                in_names += ir.external_reads(program, si)
            live.update(in_names)
            for n in in_names:
                if n != registry.EMPTY_VAR and n not in produced \
                        and n not in read:
                    read.append(n)
            for n in op.output_arg_names:
                if n == registry.EMPTY_VAR:
                    continue
                produced.add(n)
                # the rules' seqlen propagation (core/lowering.py) writes
                # an output's length companions without an op naming them
                produced.add(n + ir.SEQLEN_SUFFIX)
                produced.add(n + ir.SEQLEN_SUFFIX + ".1")
                v = block._find_var_recursive(n)
                if v is not None and v.persistable and n not in written:
                    written.append(n)
        missing = [n for n in read if not scope.has_var(n)]
        if missing:
            missing_data = [n for n in missing
                            if (v := block._find_var_recursive(n))
                            is not None and v.is_data]
            if missing_data:
                raise RuntimeError(
                    f"input variables {missing_data} were not fed — pass "
                    f"them in `feed={{...}}`")
            raise RuntimeError(
                f"variables {missing} are read by the program but not "
                f"initialized in the scope — run the startup program first")
        self.read = read
        self.written = written
        self.live = frozenset(live.union(written))


class PreparedProgram:
    """Bound fast-path handle from `Executor.prepare()` (reference
    Executor::Prepare / RunPreparedContext, executor.cc:294-366). Each
    `run(feed)` converts the feeds onto the device, gathers the state it
    reads from the scope, runs the block, and writes persistable outputs
    back."""

    def __init__(self, executor: "Executor", program: ir.Program,
                 fetch_list, scope: Scope):
        self._exe = executor
        self.program = program
        self.fetch_names = [f.name if isinstance(f, ir.Variable) else str(f)
                            for f in (fetch_list or [])]
        self.scope = scope
        self.device = executor.place.torch_device()
        self._block = program.global_block()
        self._program_version = program._version
        self._plans: Dict[frozenset, _StepPlan] = {}

    def run(self, feed: Optional[Dict[str, Any]] = None,
            return_numpy: bool = True):
        program = self.program
        if program._version != self._program_version:
            raise RuntimeError(
                "program was mutated after prepare(); prepare() it again "
                "(Executor.run() re-prepares automatically)")
        if not feed and getattr(program, "_py_reader", None) is not None:
            # a program bound to a py_reader pops its next batch (raises
            # EOFException at the end of a pass, the reference's read-op
            # contract)
            feed = program._py_reader.next_feed(self.device)
        feeds = convert_feed(self._block, feed or {}, self.device)
        key = frozenset(feeds)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = _StepPlan(program, key, self.scope,
                                                self.fetch_names)
        env = {}
        for n in plan.read:
            val = self.scope.find_var(n)
            if not isinstance(val, torch.Tensor) or val.device != self.device:
                # a host value set into the scope (numpy, or a tensor on
                # another device) moves to the device once, for good
                var = self._block._find_var_recursive(n)
                val = as_tensor(val, self.device,
                                var.dtype if var is not None else None)
                self.scope.set_var(n, val)
            env[n] = val
        env.update(feeds)
        seed = program.random_seed if program.random_seed is not None else 0
        amp = self._exe.amp
        with torch.no_grad():
            run_block(program, 0, env, self.device, seed,
                      self._exe._count_run(program._uid),
                      _flags.get_flag("check_nan_inf"), plan.live, amp)
        for n in plan.written:
            val = env.get(n)
            if val is not None and self.scope.find_var(n) is not val:
                self.scope.set_var(n, val)
        fetches = []
        for n in self.fetch_names:
            if n not in env:
                raise KeyError(f"fetch target {n!r} was not computed")
            fetches.append(env[n])
        if return_numpy:
            fetches = [to_numpy(f) for f in fetches]
        return fetches


# run()'s PreparedProgram memo cap (a handle pins its scope)
_MAX_PREPARED_HANDLES = 64


class Executor:
    """Program runner (reference executor.py:224). `amp=True` runs every
    program under bf16 mixed precision (the JAX package's policy,
    ``core/registry.py``): matrix products, convolutions and fused
    attention take bf16 (on a card, attention and the flag-selected
    dropout launch their bf16 kernels), the losses and means float32;
    parameters and optimizer state stay float32."""

    def __init__(self, place: Optional[Place] = None, amp: bool = False):
        self.place = place if place is not None else CUDAPlace(0)
        self.amp = bool(amp)
        if self.amp and self.place.torch_device().type == "cuda":
            # cuBLAS may sum a bf16 product's split-K partials in bf16; the
            # JAX package sums every bf16 product in float32. The port makes
            # bf16 products only under AMP, so this executor turns that off
            # for the process, for good
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
                False
        self._prepared: Dict[tuple, PreparedProgram] = {}
        self._run_counts: Dict[int, int] = {}  # program uid -> runs so far
        # one executor serves several threads at once (each serving
        # batcher and decode engine, the model watcher's warm runs, the
        # caller): the run counter's read-then-write and the prepared
        # memo take this lock
        self._lock = threading.Lock()

    def _count_run(self, uid: int) -> int:
        """Per-program run counter: a seeded startup re-initializes
        identically whatever else this executor ran."""
        with self._lock:
            n = self._run_counts.get(uid, 0)
            self._run_counts[uid] = n + 1
        return n

    def prepare(self, program: Optional[ir.Program] = None,
                fetch_list: Optional[Sequence[Union[str, ir.Variable]]] = None,
                scope: Optional[Scope] = None) -> PreparedProgram:
        program = program or ir.default_main_program()
        scope = scope or global_scope()
        return PreparedProgram(self, program, fetch_list, scope)

    def run(self, program: Optional[ir.Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence[Union[str, ir.Variable]]] = None,
            scope: Optional[Scope] = None, return_numpy: bool = True):
        program = program or ir.default_main_program()
        scope = scope or global_scope()
        fetch_names = tuple(f.name if isinstance(f, ir.Variable) else str(f)
                            for f in (fetch_list or ()))
        key = (program._uid, program._version, fetch_names, scope._uid)
        with self._lock:
            prepared = self._prepared.get(key)
            if prepared is None:
                prepared = PreparedProgram(self, program, fetch_names, scope)
                if len(self._prepared) >= _MAX_PREPARED_HANDLES:
                    self._prepared.pop(next(iter(self._prepared)))
                self._prepared[key] = prepared
        return prepared.run(feed, return_numpy=return_numpy)

    def close(self):
        with self._lock:
            self._prepared.clear()


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bf16 as float32 (exact), since
    numpy has no bf16."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def fetch_var(name: str, scope: Optional[Scope] = None,
              return_numpy: bool = True):
    """Read a variable's current value from a scope."""
    scope = scope or global_scope()
    val = scope.find_var(name)
    if val is None:
        raise KeyError(f"fetch_var: variable {name!r} not found in scope")
    return to_numpy(val) if return_numpy else val
