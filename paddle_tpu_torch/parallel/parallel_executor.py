"""ParallelExecutor: one Program over a mesh of ranks.

Mirror of ``paddle_tpu/parallel/parallel_executor.py`` (reference
paddle/fluid/framework/parallel_executor.cc:118-330 and
python/paddle/fluid/parallel_executor.py). The JAX package compiles the
single-device Program once under a `jax.sharding.Mesh` and GSPMD
partitions it. Here every rank of the mesh is a process running this
executor on its own shards (``spmd.py``), with the same meaning: the
whole Program over the global batch.

- Parameters: rank 0's startup values are broadcast first (Fluid's
  BCastParamsToDevices, parallel_executor.cc:204); each rank then keeps
  only its shard of every split state var. A var is split as its
  `ParamAttr.sharding` says (the Transformer's Megatron-style 'mp'
  specs), else by `BuildStrategy.sharding_rules`, else, under
  `ReduceStrategy.Reduce`, over 'dp' along dim 0 where that divides
  (ZeRO-style), else held whole.
- A weight split over 'mp' is gathered whole before the op that reads it
  and its grad reduce-scattered back: the single-device numbers with
  split state (Megatron-style partitioned compute is later work).
- Feeds: each rank is handed the global feed, as the single controller
  is, and takes its rows (dim 0 over 'dp', a data var's dim 1 over 'sp');
  or it is handed its own rows as `distributed.shard_local_batch(...)`.
  A data feed that 'dp' does not divide raises; non-data feeds are whole.
- Fetches return the global value on every rank.
- The run counter and the per-op seeds are the same on every rank, and
  the random rules draw by global index (``core/registry.py``'s
  `origin`), so dropout under 'dp' keeps the single-device masks.
- A one-rank mesh has nothing to place: its step is the Executor's own
  interpreter (``core/lowering.py::run_block``), bit for bit.

`ParallelExecutor(use_cuda=True)` (the default) runs on this rank's card,
``cuda:{local_rank % device_count}``, and raises when there is none;
`use_cuda=False` is the only way onto the CPU.
"""

from __future__ import annotations

import enum
from typing import Dict, Optional

import numpy as np
import torch

from .. import distributed as _dist
from .. import flags as _flags
from ..core import ir
from ..core.executor import (_StepPlan, as_tensor, global_scope, to_numpy)
from ..core.lowering import run_block
from . import mesh as mesh_lib
from . import spmd


class ExecutionStrategy:
    """Accepted for reference API parity (execution_strategy.h:21). As in
    the JAX package, nothing reads these fields."""

    def __init__(self):
        self.num_threads = 0
        self.allow_op_delay = False
        self.num_iteration_per_drop_scope = 100


class BuildStrategy:
    class ReduceStrategy(enum.Enum):
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy(enum.Enum):
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        # stored and read by nothing, as in the JAX package
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.debug_graphviz_path = ""
        # name-pattern -> PartitionSpec-like tuple (model parallelism), and
        # bf16 mixed precision (Executor(amp=True)'s policy)
        self.sharding_rules = []
        self.amp = False
        # fluid-wire's quantized gradient all-reduce: not ported yet
        self.comm_quant = None


class ParallelExecutor:
    """Drop-in ParallelExecutor over a mesh of ranks (`mesh`, default the
    1-D 'dp' mesh over the world). `num_trainers` and `trainer_id` are
    accepted and unused, as in the JAX package: the world comes from
    `distributed.init`."""

    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None, mesh: Optional[mesh_lib.Mesh] = None):
        self._program = main_program or ir.default_main_program()
        self._scope = scope or (share_vars_from._scope if share_vars_from
                                else global_scope())
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        if getattr(self._build_strategy, "comm_quant", None):
            raise NotImplementedError(
                "BuildStrategy.comm_quant (fluid-wire's quantized gradient "
                "all-reduce) is not ported yet: ROADMAP Queue 1 item 8.3 "
                "(wire/)")
        if use_cuda:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ParallelExecutor(use_cuda=True): no CUDA device is "
                    "visible — pass use_cuda=False to run on the host")
            self._device = _dist.device()
            if self._device.type != "cuda":
                raise RuntimeError(
                    "ParallelExecutor(use_cuda=True) in a world that "
                    "distributed.init put on the CPU")
        else:
            self._device = torch.device("cpu")
        self._mesh = mesh or mesh_lib.get_default_mesh()
        if not self._mesh.member:
            raise ValueError(f"rank {self._mesh.rank} is not in the mesh "
                             f"{self._mesh}")
        self._loss_name = loss_name
        self._amp = bool(self._build_strategy.amp)
        self._state_place: Dict[str, tuple] = {}
        self._plans: Dict[tuple, tuple] = {}
        self._last_key = None
        self._run_counter = 0
        self._bcast_params()

    # -- state -------------------------------------------------------------
    def _bcast_params(self):
        """Rank 0's state to every rank, then each rank's shard of it."""
        block = self._program.global_block()
        world = _dist.get_world_size()
        n = len(self._mesh.axis_names)
        for name in sorted(self._scope.local_var_names()):
            val = self._scope.find_var(name)
            if val is None or not hasattr(val, "shape"):
                continue
            var = block._find_var_recursive(name)
            t = as_tensor(val, self._device,
                          var.dtype if var is not None else None)
            if world > 1:
                t = spmd.broadcast(t, src=0)
            pl = self._placement_for_state(name, tuple(t.shape))
            self._state_place[name] = pl
            self._scope.set_var(name, spmd.convert(
                t, spmd.replicated(n), pl, self._mesh, diff=False))

    def _axis_placement(self, spec, shape):
        """A PartitionSpec-like tuple as a placement on this mesh, or None
        when it does not fit `shape`."""
        names = self._mesh.axis_names
        spec = [s if s in names else None for s in spec]
        if len(spec) != len(shape):
            return None
        pl = [spmd.R] * len(names)
        for d, (size, s) in enumerate(zip(shape, spec)):
            if s is None or self._mesh.shape[s] == 1:
                continue
            if size % self._mesh.shape[s]:
                return None
            pl[names.index(s)] = d
        return tuple(pl)

    def _placement_for_state(self, name, shape):
        n = len(self._mesh.axis_names)
        # 1. parameter-level annotations (ParamAttr.sharding)
        var = self._program.global_block().vars.get(name)
        spec = getattr(var, "sharding", None)
        if spec:
            pl = self._axis_placement(spec, shape)
            if pl is not None and pl != spmd.replicated(n):
                return pl
        # 2. BuildStrategy pattern rules
        for pattern, spec in self._build_strategy.sharding_rules:
            if pattern in name:
                pl = self._axis_placement(spec, shape)
                if pl is None:
                    raise ValueError(
                        f"sharding rule {pattern!r} -> {tuple(spec)} does "
                        f"not fit {name!r} of shape {shape} on {self._mesh}")
                return pl
        if (self._build_strategy.reduce_strategy
                is BuildStrategy.ReduceStrategy.Reduce
                and "dp" in self._mesh.axis_names
                and self._mesh.shape["dp"] > 1):
            # ZeRO-style: state split along dim 0 over 'dp' where the
            # mesh's rank count divides it (the JAX package's test)
            ndev = self._mesh.size
            if shape and shape[0] % ndev == 0 and shape[0] >= ndev:
                pl = [spmd.R] * n
                pl[self._mesh.axis_names.index("dp")] = 0
                return tuple(pl)
        return spmd.replicated(n)

    def state_placement(self, name):
        """The placement this executor keeps `name` at (per mesh axis: None
        whole, an int the split dim)."""
        return self._state_place.get(name)

    @property
    def device_count(self):
        return self._mesh.size

    # -- feeds -------------------------------------------------------------
    def _feed_placement(self, arr_shape, var, local_rows=False):
        mesh, n = self._mesh, len(self._mesh.axis_names)
        pl = [spmd.R] * n
        if not arr_shape:
            return tuple(pl)
        dp = mesh.shape.get("dp", 1)
        rows = arr_shape[0] * (dp if local_rows else 1)
        if rows % dp != 0:
            if var is None or var.is_data:
                # a silently replicated DATA feed would train every rank
                # on the SAME rows
                raise ValueError(
                    f"feed batch dim {rows} is not divisible by the "
                    f"{dp}-way data-parallel mesh axis; pad or drop the "
                    f"tail batch (reader.batch(..., drop_last=True))")
            return tuple(pl)
        if dp > 1:
            pl[mesh.axis_names.index("dp")] = 0
        sp = mesh.shape.get("sp", 1)
        if (sp > 1 and len(arr_shape) >= 2 and var is not None
                and var.is_data and arr_shape[1] % sp == 0):
            pl[mesh.axis_names.index("sp")] = 1
        return tuple(pl)

    def _local(self, val, var, dtype=None):
        """(this rank's local tensor, its placement) for one feed value:
        numpy or a tensor (a staged one stays on its device)."""
        local_rows = isinstance(val, _dist.LocalShard)
        arr = val.data if local_rows else val
        if not isinstance(arr, torch.Tensor):
            arr = np.asarray(arr)
        pl = self._feed_placement(tuple(arr.shape), var, local_rows)
        for a, p in zip(self._mesh.axis_names, pl):
            if isinstance(p, int) and not (local_rows and a == "dp"):
                size = arr.shape[p] // self._mesh.shape[a]
                start = self._mesh.index(a) * size
                if isinstance(arr, torch.Tensor):
                    arr = arr.narrow(p, start, size)
                else:
                    idx = [slice(None)] * arr.ndim
                    idx[p] = slice(start, start + size)
                    arr = arr[tuple(idx)]
        return as_tensor(arr, self._device, dtype), pl

    def _convert_feeds(self, feed):
        block = self._program.global_block()
        out = {}
        for name, val in feed.items():
            var = block.vars.get(name)
            dtype = var.dtype if var is not None else None
            if isinstance(val, (tuple, list)) and len(val) == 2 \
                    and var is not None and var.lod_level > 0:
                data, lens = val
                out[name] = self._local(data, var, dtype)
                if isinstance(lens, (tuple, list)) and len(lens) == 2 \
                        and not np.isscalar(lens[0]):
                    out[ir.seqlen_var_name(name)] = self._local(
                        np.asarray(lens[0], np.int32), var, "int32")
                    out[ir.seqlen_var_name(name, 1)] = self._local(
                        np.asarray(lens[1], np.int32), var, "int32")
                else:
                    out[ir.seqlen_var_name(name)] = self._local(
                        np.asarray(lens, np.int32), var, "int32")
            else:
                out[name] = self._local(val, var, dtype)
        return out

    # -- run ---------------------------------------------------------------
    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        feed = feed if feed is not None else feed_dict or {}
        if isinstance(feed, (list, tuple)):
            merged: Dict[str, list] = {}
            for d in feed:
                for k, v in d.items():
                    merged.setdefault(k, []).append(np.asarray(v))
            feed = {k: np.concatenate(v, axis=0) for k, v in merged.items()}
        fetch_names = [f.name if isinstance(f, ir.Variable) else str(f)
                       for f in fetch_list]
        feeds = self._convert_feeds(feed)
        key = (self._program._uid, self._program._version,
               frozenset(feeds), tuple(fetch_names),
               _flags.get_flag("dropout_impl"))
        hit = self._plans.get(key)
        if hit is None:
            for k in [k for k in self._plans
                      if k[0] == self._program._uid
                      and k[1] != self._program._version]:
                del self._plans[k]
            hit = self._plans[key] = (
                _StepPlan(self._program, frozenset(feeds), self._scope,
                          fetch_names), spmd.Plan())
        step_plan, plan = hit
        self._last_key = key
        n = len(self._mesh.axis_names)
        env, place = {}, {}
        for name in step_plan.read:
            val = self._scope.find_var(name)
            if name not in self._state_place:
                # a var set into the scope after this executor was made:
                # every rank holds it whole
                var = self._program.global_block()._find_var_recursive(name)
                val = as_tensor(val, self._device,
                                var.dtype if var is not None else None)
                self._state_place[name] = spmd.replicated(n)
                self._scope.set_var(name, val)
            env[name] = val
            place[name] = self._state_place[name]
        for name, (t, pl) in feeds.items():
            env[name] = t
            place[name] = pl
        for name in step_plan.written:
            self._state_place.setdefault(name, spmd.replicated(n))
        seed = self._program.random_seed \
            if self._program.random_seed is not None else 0
        counter = self._run_counter
        self._run_counter += 1
        with torch.no_grad():
            if self._mesh.size == 1:
                # one rank holds every var whole: nothing to place, so the
                # Executor's own interpreter runs the step (the plan stays
                # empty: no collective)
                run_block(self._program, 0, env, self._device, seed,
                          counter, _flags.get_flag("check_nan_inf"),
                          step_plan.live, self._amp)
                plan.done = True
            else:
                spmd.SpmdStep(self._program, self._mesh, self._device,
                              self._state_place, amp=self._amp).run(
                    env, place, plan, seed, counter, step_plan.live,
                    _flags.get_flag("check_nan_inf"))
        for name in step_plan.written:
            val = env.get(name)
            if val is not None and self._scope.find_var(name) is not val:
                self._scope.set_var(name, val)
        fetches = []
        for name in fetch_names:
            if name not in env:
                raise KeyError(f"fetch target {name!r} was not computed")
            whole = spmd.replicated(n)
            fetches.append(spmd.convert(env[name], place.get(name, whole),
                                        whole, self._mesh, diff=False))
        if return_numpy:
            fetches = [to_numpy(f) for f in fetches]
        return fetches

    # -- the plan as text --------------------------------------------------
    def _plan_for(self, feed, what):
        if not self._plans:
            raise RuntimeError(f"{what} requires a prior run()")
        names = frozenset(self._convert_feeds(feed))
        cands = [k for k in self._plans
                 if k[2] == names and k[1] == self._program._version]
        if not cands:
            raise RuntimeError(
                f"no step matches feed names {sorted(names)}; run() with "
                f"this feed first")
        key = self._last_key if self._last_key in cands else cands[-1]
        return self._plans[key][1]

    def lowered_text(self, feed) -> str:
        """The step's plan, each op with its placements and the
        collectives it issued, spelled as StableHLO spells them
        (`stablehlo.collective_permute`, `stablehlo.all_reduce`).
        Requires a prior run() with the same feed names."""
        return self._plan_for(feed, "lowered_text").text(self._mesh,
                                                         hlo=False)

    def compiled_text(self, feed) -> str:
        """The same plan with the collectives spelled as optimized HLO
        spells them (` all-reduce(`, ` collective-permute(`), so
        `collective_inventory` counts them."""
        return self._plan_for(feed, "compiled_text").text(self._mesh,
                                                          hlo=True)


def collective_inventory(hlo_text: str) -> dict:
    """Count the collective ops in an optimized-HLO module (one compiled
    step): which collectives GSPMD actually inserted for a mesh, per
    step. Async pairs (`-start`/`-done`) count once."""
    inv = {}
    for kind in ("all-reduce", "all-gather", "collective-permute",
                 "reduce-scatter", "all-to-all"):
        n = hlo_text.count(f" {kind}(") + hlo_text.count(f" {kind}-start(")
        if n:
            inv[kind] = n
    return inv
