"""DistributeTranspiler: multi-node training planner.

Mirror of ``paddle_tpu/transpiler/distribute_transpiler.py``, copied: it
rewrites the Program IR only (reference:
python/paddle/fluid/transpiler/distribute_transpiler.py:177 `transpile`,
slice_var_up :124, trainer send/recv injection :248-309,
get_pserver_program :333, distributed lookup table :316,916-940; the
nccl2 mode: doc/fluid/design/dist_train/dist_train_nccl2.md,
gen_nccl_id_op.cc).

There are no send/recv ops: every reference distribution mode maps onto
one Program run over a mesh of ranks, which the port's SPMD interpreter
(``parallel/spmd.py``) partitions where the JAX package has GSPMD:

  - sync pserver mode / nccl2 mode  -> data parallelism over the 'dp'
    axis; the gradient all-reduce is inserted by the SPMD interpreter
    (the transpiled program is UNCHANGED: the mesh and the placements do
    the work). config.runtime='pserver' plans the process-based sync
    parameter server instead (per-batch barriers, server-side updates:
    the reference's RunSyncLoop), run by ``pserver/``: `Executor.run`
    serves a pserver Program and `pserver.SyncPSTrainer` drives it.
  - sliced params on pservers       -> ZeRO-style optimizer-state
    sharding (BuildStrategy.ReduceStrategy.Reduce).
  - distributed lookup table (P5)   -> large embedding tables annotated
    for a split over 'mp' (rows); this transpiler marks them.
  - gen_nccl_id bootstrap           -> `paddle_tpu_torch.distributed.init`
    (torch.distributed over gloo or NCCL, see distributed.py).
  - async (barrierless) updates     -> the host parameter-server plan
    (`param_specs`, `sparse_specs`, `grad_names`; reference RunAsyncLoop,
    listen_and_serv_op.cc:195), run by ``pserver/``'s trainers.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from ..core import ir
from .ps_dispatcher import RoundRobin

# op types that the host pserver can run as its per-param optimize "block"
# (reference get_pserver_program builds one optimize sub-block per param,
# distribute_transpiler.py:333; the JAX package's kernels are in
# paddle_tpu/pserver/optim.py)
OPTIMIZE_OP_TYPES = ("sgd", "momentum", "adam", "adamax", "adagrad",
                     "decayed_adagrad", "adadelta", "rmsprop", "ftrl",
                     "proximal_gd", "proximal_adagrad")


def _verify_split(program: ir.Program, what: str):
    """Static verification of a transpiler output (analysis/verifier):
    these programs are GENERATED — a structural error here is a transpiler
    bug surfacing as a tracer error hours into a distributed run
    otherwise. Structural checks only (no shape sweep): split programs are
    re-verified in full by Executor.prepare when `validate` is on."""
    from ..analysis import (ProgramVerificationError, has_errors,
                            verify_program)
    diags = verify_program(program)
    if has_errors(diags):
        raise ProgramVerificationError(diags, context=what)


class DistributeTranspilerConfig:
    """reference transpiler config: slice_var_up/min_block_size control how
    params were sliced across pservers; here they control when a parameter is
    sharded rather than replicated."""

    slice_var_up = True
    min_block_size = 8192
    split_method = RoundRobin
    mode = "nccl2"  # every sync mode collapses to collectives over the mesh
    # sync-mode runtime: "collective" (default — the SPMD interpreter's
    # all-reduce over the mesh) or "pserver" (process-based sync PS with
    # per-batch barriers — the reference RunSyncLoop analog, driven by
    # pserver.SyncPSTrainer; dense params only)
    runtime = "collective"
    # extension: shard embedding tables with >= this many rows
    distributed_lookup_threshold = 100_000
    # static row budget for the per-batch prefetched sub-table (the step
    # needs static shapes; reference prefetch fetched exactly the batch's
    # unique ids — here they are padded to this cap)
    sparse_prefetch_cap = 2048
    # fluid-wire communication compression (EQuARX-grounded, PAPERS.md):
    # None/"raw" keeps full-precision traffic. "int8" / "bf16" quantizes
    # BOTH distribution surfaces this transpiler plans: (a) on the
    # collective (SPMD) and hybrid dense paths, a comm_quant_dequant op
    # with persistent error feedback is inserted before every optimizer
    # op (wire/graph.py) so each dp shard's gradient contribution is
    # quantized at the all-reduce boundary inside ONE jitted program;
    # (b) on the pserver paths, the trainer's PSClient sends gradient
    # pushes / sparse rows as codec-tagged payloads with client-side
    # error feedback (wire/codec.py; negotiated — legacy servers get raw)
    comm_quant = None
    # fluid-haven replicated PS plane: {primary_endpoint: [backup, ...]}.
    # When set, the PS trainers' client fails over READS AND WRITES to a
    # promoted backup (pushes are seq-tagged so replays dedup
    # server-side), and a primary SIGKILL costs lease-time + one retry
    # budget instead of wedging training. The pair itself is armed on
    # the server side via ParameterServer.start_replication() /
    # start_standby() (docs/FAULT_TOLERANCE.md §Replicated PS plane).
    haven_replicas = None
    # fluid-quorum: the arbiter group backing the haven pairs' elections
    # (a list of node endpoints) + {logical_endpoint: lease resource}.
    # When set, the PS trainers' client asks the ARBITERS who a shard's
    # primary is during failover — it can find a promoted primary at an
    # endpoint no replica list names. Server-side arming stays on
    # ParameterServer.start_replication/start_standby(quorum_endpoints=).
    quorum_endpoints = None
    quorum_resources = None


class DistributeTranspiler:
    def __init__(self, config: Optional[DistributeTranspilerConfig] = None):
        self.config = config or DistributeTranspilerConfig()
        self._trainer_id = 0
        self._trainers = 1
        self._program: Optional[ir.Program] = None
        self.sync_mode = True
        self._sync_ps = False
        # async-mode plan, consumed by pserver.AsyncPSTrainer and
        # get_pserver_program
        self.param_specs: Dict[str, dict] = {}   # dense: name -> spec
        self.sparse_specs: Dict[str, dict] = {}  # table name -> spec
        self.grad_names: Dict[str, str] = {}     # param -> grad var name

    def transpile(self, trainer_id, program=None, pservers="", trainers=1,
                  sync_mode=True, startup_program=None, mode=None):
        """mode="hybrid" is the reference's nccl2 + distributed-lookup-table
        composition (P4+P5, the CTR recipe): DENSE parameters keep their
        in-graph optimizer ops — their gradients synchronize through the SPMD
        collectives over the mesh — while distributed lookup tables go to
        the host parameter servers (prefetch + sparse push)."""
        self._trainer_id = trainer_id
        self._trainers = trainers if isinstance(trainers, int) \
            else len(trainers.split(","))
        self._program = program or ir.default_main_program()
        self._pserver_endpoints = [e for e in pservers.split(",") if e]
        self._hybrid = mode == "hybrid"
        self.sync_mode = sync_mode and not self._hybrid
        # process-based sync PS (reference RunSyncLoop): same stripped
        # trainer program and per-param server specs as async — only the
        # trainer driver (SyncPSTrainer: accumulate + barrier-apply)
        # differs
        self._sync_ps = (self.sync_mode
                         and self.config.runtime == "pserver")
        if self._hybrid:
            if not self._pserver_endpoints:
                raise ValueError("hybrid mode needs pservers='host:port,...'")
            self._build_async_plan(dense_local=True)
            # hybrid keeps dense optimizer ops in-graph: their gradients
            # cross the SPMD all-reduce, so the in-graph quantizer
            # applies to them (the sparse half quantizes on the RPC wire)
            self._apply_comm_quant(startup_program)
        elif self._sync_ps:
            if not self._pserver_endpoints:
                raise ValueError(
                    "sync pserver runtime needs pservers='host:port,...'")
            self._build_async_plan()
        elif sync_mode:
            self._annotate_distributed_tables()
            self._apply_comm_quant(startup_program)
        else:
            if not self._pserver_endpoints:
                raise ValueError("async mode needs pservers='host:port,...'")
            self._build_async_plan()
        return self

    def _apply_comm_quant(self, startup_program=None):
        """fluid-wire in-graph gradient quantization (config.comm_quant)
        for the paths whose gradients cross SPMD collectives. The
        residual vars zero-init through the startup program, so the usual
        build -> transpile -> run(startup) order materializes them; the
        pserver paths need no program rewrite (the trainer's PSClient
        quantizes on the RPC wire instead)."""
        codec = getattr(self.config, "comm_quant", None)
        if codec in (None, "raw"):
            return
        from ..wire.graph import apply_comm_quant
        apply_comm_quant(
            self._program, codec=codec,
            startup_program=startup_program or ir.default_startup_program())

    # ------------------------------------------------------------------
    # async (barrierless) mode: host parameter-server plan
    # (reference: RunAsyncLoop listen_and_serv_op.cc:195 — per-grad
    # updates, no barriers; trainer send/recv become host-side phases
    # around the jitted step, pserver/client.py)
    # ------------------------------------------------------------------
    def _build_async_plan(self, dense_local=False):
        block = self._program.global_block()
        dispatcher = self.config.split_method(self._pserver_endpoints)

        # 1. distributed lookup tables (their params skip the dense path).
        # No IR rewrite is needed — the executor compiles per feed signature
        # and feeds override scope state, so AsyncPSTrainer feeds the
        # prefetched [cap, width] sub-table under the TABLE'S OWN NAME with
        # batch ids remapped to sub-table rows. Gradients (incl. fan-in sums
        # when a table is looked up twice) then flow to `W@GRAD` with the
        # sub-table's shape automatically. This is the reference's prefetch
        # rewrite (:316) relocated to the host feed boundary.
        sparse_params = set()
        cap = self.config.sparse_prefetch_cap
        for op in block.ops:
            if op.type != "lookup_table" or not op.attrs.get("is_distributed"):
                continue
            wname = op.input("W")[0]
            w = block._find_var_recursive(wname)
            ids_name = op.input("Ids")[0]
            sparse_params.add(wname)
            spec = self.sparse_specs.setdefault(wname, {
                "rows": int(w.shape[0]), "width": int(w.shape[1]),
                "dtype": w.dtype, "cap": cap,
                "ids_names": [], "opt_type": None, "lr_name": None,
                "attrs": {},
            })
            if ids_name not in spec["ids_names"]:
                spec["ids_names"].append(ids_name)

        # 2. find + strip optimizer ops; record per-param server specs.
        # hybrid (dense_local): dense optimizer ops STAY in the program
        # (SPMD collectives synchronize their grads); only the sparse
        # tables' updates move server-side.
        keep_ops = []
        for op in block.ops:
            if op.type not in OPTIMIZE_OP_TYPES:
                keep_ops.append(op)
                continue
            pname = op.input("Param")[0]
            gname = op.input("Grad")[0]
            lr_name = (op.input("LearningRate") or [None])[0]
            if pname in sparse_params:
                self.grad_names[pname] = gname
                self.sparse_specs[pname].update(
                    opt_type=op.type, lr_name=lr_name, attrs=dict(op.attrs))
                continue  # table updates go through push_sparse_grad
            if dense_local:
                keep_ops.append(op)
                continue
            self.grad_names[pname] = gname
            self.param_specs[pname] = {
                "opt_type": op.type, "lr_name": lr_name,
                "attrs": dict(op.attrs),
                "endpoint": dispatcher.dispatch_one(pname),
            }
        block.ops[:] = keep_ops
        self._program._bump()

        for wname, spec in self.sparse_specs.items():
            if spec["opt_type"] is None:
                raise ValueError(
                    f"distributed table {wname!r} has no optimizer op — call "
                    f"optimizer.minimize before transpile (reference order)")

    def _annotate_distributed_tables(self):
        """Shard big embeddings over 'mp' rows — the distributed-lookup-table
        replacement (reference :316 prefetch rewrite)."""
        block = self._program.global_block()
        threshold = self.config.distributed_lookup_threshold
        for op in block.ops:
            if op.type != "lookup_table":
                continue
            w = block._find_var_recursive(op.input("W")[0])
            if w is None or not isinstance(w, ir.Parameter):
                continue
            if op.attrs.get("is_distributed") or (
                    w.shape and w.shape[0] >= threshold):
                if not w.sharding:
                    w.sharding = ("mp", None)
        self._program._bump()

    def get_trainer_program(self, wait_port=True) -> ir.Program:
        """Sync mode: the trainer program IS the original program —
        collectives are inserted by the SPMD interpreter. Async mode: the
        program with optimizer ops stripped (updates run on the pservers);
        drive it with pserver.AsyncPSTrainer, which adds the host-side
        pull/push phases the reference expressed as send/recv ops."""
        _verify_split(self._program, "trainer program")
        return self._program

    def get_pserver_program(self, endpoint) -> ir.Program:
        """A program holding one `listen_and_serv` op (reference
        listen_and_serv_op.cc); `Executor.run` on it serves, blocking
        (``pserver/server.py``). Available in async mode, hybrid mode and the sync
        "pserver" runtime (RunSyncLoop analog: per-batch barriers,
        aggregated server-side updates). The sync DEFAULT remains the
        collective runtime: parameters live split or whole on each rank's
        device and updates run inside the step (the SPMD all-reduce) —
        set DistributeTranspilerConfig.runtime='pserver' for the
        process-based mode."""
        if self.sync_mode and not self._sync_ps:
            raise NotImplementedError(
                "sync mode with runtime='collective' has no parameter-"
                "server processes: the SPMD all-reduce owns the exchange. "
                "Set "
                "DistributeTranspilerConfig.runtime='pserver' for the "
                "process-based sync runtime (RunSyncLoop analog), or "
                "sync_mode=False for async")
        prog = ir.Program()
        # the server is generic: params/tables arrive via init_param /
        # init_table RPCs from the trainers (first writer wins), so the op
        # carries only what the service loop consumes
        prog.global_block().append_op(
            "listen_and_serv",
            attrs={"endpoint": endpoint, "trainers": self._trainers})
        _verify_split(prog, f"pserver program for {endpoint}")
        return prog

    def get_pserver_programs(self, endpoint):
        return self.get_pserver_program(endpoint)

    def get_startup_program(self, endpoint=None, pserver_program=None,
                            startup_program=None) -> ir.Program:
        return startup_program or ir.default_startup_program()

    # convenience mirroring reference env-driven setup (trainer.py:321)
    @classmethod
    def from_env(cls):
        t = cls()
        t.transpile(
            trainer_id=int(os.environ.get("PADDLE_TRAINER_ID", "0")),
            trainers=int(os.environ.get("PADDLE_TRAINERS", "1")),
        )
        return t
