"""AsyncPSTrainer: drives a transpiled trainer program against pservers.

Capability parity with the reference's async trainer loop (reference:
trainer program send/recv ops injected by distribute_transpiler.py:248-309;
async update design doc/fluid/design/dist_train/async_update.md; sparse
prefetch path distribute_transpiler.py:316 + split_ids/merge_ids ops).

Mirror of ``paddle_tpu/pserver/trainer.py`` over the port's `Executor`:
the step runs on the executor's place (the card unless the caller asks
for the host) and every reference distributed op becomes a host phase
around `exe.run`:

    recv ops      -> pull dense params and copy each into the scope's
                     tensor (on the card: one host-to-device copy a
                     parameter, into the tensor the step reads)
    prefetch op   -> fetch the batch's unique table rows, feed them as a
                     [cap, width] sub-table UNDER THE TABLE'S NAME with ids
                     remapped to sub-table rows (a feed overrides scope
                     state, and the executor plans once per feed-name set,
                     so the program needs no rewriting)
    send ops      -> push dense grads + scatter sub-table row grads after
                     the step (barrierless — RunAsyncLoop semantics); the
                     grads are fetched as host numpy, the only values the
                     wire's restricted unpickler admits
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import flags as _flags
from ..core import executor as core_exec
from ..observe import health as _health
from ..observe import metrics as _metrics
from ..observe import xray as _xray
from .client import PSClient


def _note_step_health(user_outs, grads):
    """fluid-pulse (observe on): land this step's loss and gradient norm
    on the health plane's time-series via the registry emit path the
    engine watches — food for the non-finite and grad-norm-spike
    detectors. The fetched arrays are already on the host; the norm
    accumulates per-tensor vdot scalars in the NATIVE dtype (no float64
    copy of the model's gradients per step — the observe overhead
    contract is cheap host scalars, not O(model-bytes) traffic)."""
    if user_outs:
        _health.note_loss_fetch(user_outs)
    if grads:
        sq = 0.0
        for g in grads:
            a = np.asarray(g).reshape(-1)
            sq += float(np.vdot(a, a))
        _metrics.gauge("trainer_grad_norm",
                       "L2 norm of this step's pushed gradients").set(
                           float(np.sqrt(sq)))


# lazily-initialized sparse rows are uniform in this range (reference
# lookup_sparse_table_op.cc min/max attrs default -1/1; embeddings converge
# better from a tighter band)
TABLE_INIT_LOW, TABLE_INIT_HIGH = -0.05, 0.05


class AsyncPSTrainer:
    def __init__(self, transpiler, exe, program=None, scope=None):
        self.t = transpiler
        self.exe = exe
        self.scope = scope or core_exec.global_scope()
        self.program = program or transpiler.get_trainer_program()
        # fluid-wire: the transpiler config's comm_quant rides into the
        # client so pserver pushes/pulls travel quantized (negotiated per
        # endpoint; legacy servers degrade to raw).
        # fluid-haven: config.haven_replicas ({primary: [backup, ...]})
        # arms read AND write failover — pushes are seq-tagged so a
        # replay at a promoted backup dedups server-side instead of
        # double-applying.
        replicas = getattr(transpiler.config, "haven_replicas", None)
        self.client = PSClient(
            transpiler._pserver_endpoints,
            comm_quant=getattr(transpiler.config, "comm_quant", None),
            replicas=replicas,
            dedup_pushes=replicas is not None,
            trainer_id=transpiler._trainer_id,
            quorum_endpoints=getattr(transpiler.config,
                                     "quorum_endpoints", None),
            quorum_resources=getattr(transpiler.config,
                                     "quorum_resources", None))
        self.trainer_id = transpiler._trainer_id
        # tables sharing any ids feed must share one uniq/remap (a fed ids
        # var can only hold ONE remapping) — group them transitively
        self._table_groups = self._group_tables(transpiler.sparse_specs)

    @staticmethod
    def _group_tables(sparse_specs):
        groups: List[dict] = []  # {"tables": [...], "ids_names": [...]}
        for wname, spec in sparse_specs.items():
            hit = None
            for g in groups:
                if set(spec["ids_names"]) & set(g["ids_names"]):
                    hit = g
                    break
            if hit is None:
                hit = {"tables": [], "ids_names": []}
                groups.append(hit)
            hit["tables"].append(wname)
            for n in spec["ids_names"]:
                if n not in hit["ids_names"]:
                    hit["ids_names"].append(n)
        # merge transitively-overlapping groups
        merged = True
        while merged:
            merged = False
            for i in range(len(groups)):
                for j in range(i + 1, len(groups)):
                    if set(groups[i]["ids_names"]) & set(groups[j]["ids_names"]):
                        groups[i]["tables"] += groups[j]["tables"]
                        groups[i]["ids_names"] += [
                            n for n in groups[j]["ids_names"]
                            if n not in groups[i]["ids_names"]]
                        del groups[j]
                        merged = True
                        break
                if merged:
                    break
        return groups

    # -- startup ----------------------------------------------------------
    def _lr_of(self, spec) -> float:
        name = spec.get("lr_name")
        if name is None:
            raise ValueError(
                "optimizer op carries no LearningRate input; async PS mode "
                "needs one")
        v = self.scope.find_var(name)
        if v is None:
            # a missing scope var means the LR is COMPUTED in-program (a
            # decay schedule) — silently defaulting would train at the
            # wrong rate forever, so refuse loudly
            raise ValueError(
                f"learning-rate var {name!r} is not materialized in the "
                f"scope. Async PS mode applies updates server-side with a "
                f"constant LR captured at init_params(); in-program LR "
                f"schedules (learning_rate_scheduler.*) are not supported "
                f"on this path — pass a float learning_rate (reference "
                f"async pservers share the limitation for sparse tables)")
        return float(core_exec.host_array(v).reshape(-1)[0])

    def init_params(self):
        """Every trainer offers its startup values; the server keeps the
        first writer's (reference: pserver startup program / param bcast)."""
        for pname, spec in self.t.param_specs.items():
            value = core_exec.host_array(self.scope.find_var(pname))
            self.client.init_param(spec["endpoint"], pname, value,
                                   spec["opt_type"], self._lr_of(spec),
                                   spec["attrs"])
        for wname, spec in self.t.sparse_specs.items():
            self.client.init_table(
                wname, spec["rows"], spec["width"], spec["dtype"],
                TABLE_INIT_LOW, TABLE_INIT_HIGH, seed=1337,
                opt_type=spec["opt_type"], lr=self._lr_of(spec),
                attrs=spec["attrs"])

    def _scope_kw(self) -> Dict:
        """The step must run against the trainer's scope when one
        was given explicitly; duck-typed executor adapters (e.g. a
        ParallelExecutor wrapper, which owns its scope) may not accept a
        scope kwarg, so the global-scope default passes nothing."""
        if self.scope is core_exec.global_scope():
            return {}
        return {"scope": self.scope}

    def _recv_dense(self):
        """Pull the dense params into the scope — ONE batched RPC per
        endpoint, in parallel (reference overlaps AsyncGetVar handles the
        same way). A value lands in the scope's own tensor where one of
        its shape and dtype is there (the step reads that tensor, on the
        card for a card executor), else in the scope as it came."""
        by_ep: Dict[str, List[str]] = {}
        for pname, spec in self.t.param_specs.items():
            by_ep.setdefault(spec["endpoint"], []).append(pname)
        for ep, values in self.client.get_params_parallel(by_ep).items():
            for pname, value in values.items():
                cur = self.scope.find_var(pname)
                src = torch.from_numpy(np.require(value,
                                                  requirements=["C", "W"]))
                if isinstance(cur, torch.Tensor) \
                        and cur.shape == src.shape and cur.dtype == src.dtype:
                    cur.copy_(src)
                else:
                    self.scope.set_var(pname, value)

    def _dense_grads_by_ep(self, grads) -> Dict[str, Dict[str, np.ndarray]]:
        by_ep: Dict[str, Dict[str, np.ndarray]] = {}
        for (pname, spec), g in zip(self.t.param_specs.items(), grads):
            by_ep.setdefault(spec["endpoint"], {})[pname] = g
        return by_ep

    # -- one async step ---------------------------------------------------
    def step(self, feed: Dict, fetch_list: Sequence) -> List[np.ndarray]:
        # fluid-xray: one span per training step so the pull/compute/push
        # RPC spans of this step (and their server-side halves) nest
        # under one parent in the merged timeline
        if _flags.get_flag("observe"):
            with _xray.span("train_step", cat="train",
                            trainer_id=self.trainer_id):
                return self._step_impl(feed, fetch_list)
        return self._step_impl(feed, fetch_list)

    def _step_impl(self, feed: Dict, fetch_list: Sequence
                   ) -> List[np.ndarray]:
        # 1. recv the freshest dense params
        self._recv_dense()

        # 2. prefetch: per table GROUP (tables sharing an ids feed share one
        # uniq/remap — the fed ids var can only hold one mapping)
        feed = dict(feed)
        pushes = []  # (wname, unique_ids[m])
        for g in self._table_groups:
            ids_vals = [np.asarray(feed[n]) for n in g["ids_names"]]
            flat = np.concatenate([v.reshape(-1) for v in ids_vals])
            uniq, inv = np.unique(flat, return_inverse=True)
            m = uniq.shape[0]
            if m == 0:  # empty tail batch: feed zero tables, nothing to push
                for wname in g["tables"]:
                    spec = self.t.sparse_specs[wname]
                    feed[wname] = np.zeros((spec["cap"], spec["width"]),
                                           dtype=spec["dtype"])
                continue
            for wname in g["tables"]:
                spec = self.t.sparse_specs[wname]
                if m > spec["cap"]:
                    raise ValueError(
                        f"batch touches {m} unique rows of {wname!r} but "
                        f"sparse_prefetch_cap={spec['cap']}; raise "
                        f"DistributeTranspilerConfig.sparse_prefetch_cap")
                sub = np.zeros((spec["cap"], spec["width"]),
                               dtype=spec["dtype"])
                sub[:m] = self.client.prefetch_rows(wname, uniq)
                feed[wname] = sub
                pushes.append((wname, uniq))
            off = 0
            for n, v in zip(g["ids_names"], ids_vals):
                feed[n] = inv[off:off + v.size].reshape(v.shape).astype(v.dtype)
                off += v.size

        # 3. the step, fetching user targets + every grad (host numpy)
        grad_fetches = [self.t.grad_names[p] for p in self.t.param_specs]
        grad_fetches += [self.t.grad_names[w] for w, _ in pushes]
        outs = self.exe.run(self.program, feed=feed,
                            fetch_list=list(fetch_list) + grad_fetches,
                            **self._scope_kw())
        user_outs = outs[: len(fetch_list)]
        grads = outs[len(fetch_list):]

        # 4. send: barrierless pushes, batched per endpoint
        self.client.push_grads_parallel(self._dense_grads_by_ep(grads))
        for (wname, uniq), g in zip(pushes,
                                    grads[len(self.t.param_specs):]):
            self.client.push_sparse_grad(wname, uniq, g[: uniq.shape[0]])
        if _flags.get_flag("observe"):
            _note_step_health(user_outs, grads[: len(self.t.param_specs)])
        return user_outs

    def save(self, dirname):
        """checkpoint_notify analog: every pserver snapshots its shard."""
        return self.client.save(dirname)

    def close(self):
        self.client.close()


class SyncPSTrainer(AsyncPSTrainer):
    """Sync-mode parameter-server training — the process-based analog of
    the reference's RunSyncLoop (listen_and_serv_op.cc:106): every batch,
    all trainers send their gradients, a per-batch barrier fires the
    aggregated update ONCE server-side, and only then does any trainer
    proceed (its next pull reads the post-update params — the reference's
    kRequestGet-after-optimize ordering).

    Dense parameters only: distributed lookup tables are inherently
    barrierless on the host path (use async or hybrid mode — reference
    deployments run sparse CTR async for the same reason). The
    RECOMMENDED sync data-parallel path remains the collective runtime
    (DistributeTranspiler default, the SPMD all-reduce); this runtime
    exists for reference execution-mode parity and for deployments whose
    parameters live on host servers.
    """

    def __init__(self, transpiler, exe, program=None, scope=None,
                 heartbeat_lease_s=None):
        super().__init__(transpiler, exe, program=program, scope=scope)
        if transpiler.sparse_specs:
            raise NotImplementedError(
                "sync PS mode is dense-only: distributed lookup tables "
                "update barrierlessly (reference runs sparse CTR async); "
                "use sync_mode=False or mode='hybrid'")
        # monotone batch tag; advanced only after a SUCCESSFUL sync_apply,
        # so a retried batch re-pushes under the SAME id and servers that
        # already applied it reject the duplicate accumulation. The
        # session nonce distinguishes a RESTARTED trainer (ids restart at
        # 0 legitimately) from a duplicate push of an applied batch.
        import uuid
        self._batch_id = 0
        self._session = uuid.uuid4().hex
        # liveness lease (ark, OPT-IN): with a lease, this trainer's death
        # is detected by lease expiry and the servers' sync barrier
        # degrades to N-1 live trainers instead of wedging until
        # sync_timeout. Without one (default), the trainer is unknown to
        # the lease table and the legacy full-party behavior holds.
        self._heartbeat = None
        self._hb_client = None
        if heartbeat_lease_s is not None:
            from ..ark.heartbeat import HeartbeatThread
            # DEDICATED client: heartbeats must never contend with the
            # blocking sync-barrier RPC for the shared per-endpoint
            # connection, or a slow batch (longer than the lease) would
            # starve renewals and get this live trainer evicted
            self._hb_client = PSClient(transpiler._pserver_endpoints)
            self._heartbeat = HeartbeatThread(
                self._hb_client, transpiler._pserver_endpoints,
                trainer_id=self.trainer_id, session=self._session,
                lease_s=heartbeat_lease_s)
            # synchronous first beat: the lease must exist before the
            # first sync barrier so eviction semantics apply from step 0
            self._heartbeat.beat_once()
            self._heartbeat.start()

    def close(self):
        if self._heartbeat is not None:
            self._heartbeat.stop()
        if self._hb_client is not None:
            self._hb_client.close()
        super().close()

    def step(self, feed: Dict, fetch_list: Sequence) -> List[np.ndarray]:
        if _flags.get_flag("observe"):
            with _xray.span("train_step", cat="train",
                            trainer_id=self.trainer_id,
                            batch_id=self._batch_id):
                return self._step_impl(feed, fetch_list)
        return self._step_impl(feed, fetch_list)

    def _step_impl(self, feed: Dict, fetch_list: Sequence
                   ) -> List[np.ndarray]:
        # 1. recv: params as of the LAST barrier (identical on every
        # trainer — the barrier ordered the previous batch's update
        # before any release)
        self._recv_dense()

        # 2. the step
        grad_fetches = [self.t.grad_names[p] for p in self.t.param_specs]
        outs = self.exe.run(self.program, feed=feed,
                            fetch_list=list(fetch_list) + grad_fetches,
                            **self._scope_kw())
        user_outs = outs[: len(fetch_list)]
        grads = outs[len(fetch_list):]

        # 3+4. send (accumulate-only pushes tagged with this trainer's
        # batch id, stable across retries — servers reject duplicates),
        # then the per-batch barrier on EVERY server; returning means
        # the aggregated update is applied. The arrival is tagged with
        # this trainer's id so an eviction of THIS trainer discounts it
        # (ark liveness). Only a successful apply advances the batch id.
        #
        # fluid-haven (replicas configured): a primary death or a
        # broken barrier mid-batch is retried INTERNALLY under the same
        # batch id — pushes dedup server-side, the client re-resolves
        # the promoted primary, and the barrier fires on the survivor —
        # so a shard failover is not a trainer-visible failure. Without
        # replicas the legacy contract holds: the error propagates and
        # the caller owns the retry.
        failover = bool(self.client.replicas)
        deadline = time.monotonic() + \
            (2.0 * self.client.failover_s if failover else 0.0)
        while True:
            try:
                self.client.push_grads_sync(self._dense_grads_by_ep(grads),
                                            batch_id=self._batch_id,
                                            trainer_id=self.trainer_id,
                                            session=self._session)
                self.client.sync_apply(self.t._pserver_endpoints,
                                       trainer_id=self.trainer_id)
                break
            except (ConnectionError, EOFError, OSError, RuntimeError) as e:
                # the retriable RuntimeErrors are the two documented
                # retry-the-step contracts: the server's barrier-reset
                # reply and the client's failed primary re-resolution —
                # anything else propagates
                retriable = isinstance(e, (ConnectionError, EOFError,
                                           OSError)) or \
                    "sync barrier broken" in str(e) or \
                    "NotPrimary" in str(e)
                if not failover or not retriable \
                        or time.monotonic() >= deadline:
                    raise
                if _flags.get_flag("observe"):
                    _metrics.counter(
                        "pserver_sync_step_retries_total",
                        "sync batches retried across a shard failover "
                        "or broken barrier").inc()
                time.sleep(0.1)
        self._batch_id += 1
        if _flags.get_flag("observe"):
            _note_step_health(user_outs, grads)
        return user_outs
