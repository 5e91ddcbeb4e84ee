"""One rank of a gloo CPU world for tests/test_torch_parallel.py.

Run as ``python tests/_torch_parallel_worker.py JOB_JSON`` under the
PADDLE_TRAINER_ID / PADDLE_TRAINERS / PADDLE_TRAINER_ENDPOINTS env. It
joins the world through `paddle_tpu_torch.distributed.init`, runs every
case the job names for its world size, and writes ``rank{r}.json`` into
the job's directory: a case's result, or the error it raised.
"""

import json
import os
import sys
import traceback

import numpy as np
import torch

torch.set_num_threads(1)
os.nice(10)     # the suite's timing tests run beside these ranks

import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch import distributed  # noqa: E402
from paddle_tpu_torch.parallel import (BuildStrategy,  # noqa: E402
                                       ParallelExecutor,
                                       collective_inventory, make_mesh)
from paddle_tpu_torch.parallel import spmd  # noqa: E402

STEPS = 3


def build(optimizer="sgd", dropout=0.0, seq_len=32):
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, fetches = ptt.models.transformer.build(
            src_vocab_size=64, trg_vocab_size=64, seq_len=seq_len,
            n_layer=2, n_head=2, d_model=32, d_inner=64,
            dropout_rate=dropout, fused_attention=True)
        loss = fetches["loss"]
        opt = (ptt.optimizer.SGD(learning_rate=0.1) if optimizer == "sgd"
               else ptt.optimizer.Momentum(learning_rate=0.05,
                                           momentum=0.9))
        opt.minimize(loss)
    main.random_seed = startup.random_seed = 7
    return main, startup, loss


def batches(n=STEPS, rows=8, seq_len=32):
    rng = np.random.RandomState(3)
    out = []
    for _ in range(n):
        src = rng.randint(1, 64, (rows, seq_len)).astype(np.int32)
        out.append({"src_word": src, "trg_word": src, "lbl_word": src})
    return out


def pe_for(job, case, main, loss, state, mesh, strategy=None):
    scope = ptt.io.state_from_numpy(
        dict(np.load(os.path.join(job["dir"], state))), ptt.CPUPlace())
    return ParallelExecutor(use_cuda=False, loss_name=loss.name,
                            main_program=main, scope=scope, mesh=mesh,
                            build_strategy=strategy), scope


def run_losses(pe, feeds, loss):
    return [float(pe.run(feed=b, fetch_list=[loss.name])[0][0])
            for b in feeds]


def case_trajectory(job, case):
    """Losses of STEPS steps on `case["mesh"]`, and the state layout."""
    main, _, loss = build(case["optimizer"], case.get("dropout", 0.0))
    mesh = make_mesh(case["mesh"], case["axes"])
    bs = BuildStrategy()
    if case.get("reduce"):
        bs.reduce_strategy = BuildStrategy.ReduceStrategy.Reduce
    pe, scope = pe_for(job, case, main, loss, case["state"], mesh, bs)
    spmd.reset_collectives()
    losses = run_losses(pe, batches(), loss)
    layout = {}
    for name in scope.local_var_names():
        pl = pe.state_placement(name)
        if pl is not None and any(isinstance(p, int) for p in pl):
            layout[name] = {"placement": [p for p in pl],
                            "local": list(scope.find_var(name).shape)}
    text = pe.compiled_text(batches()[0])
    return {"losses": losses, "layout": layout,
            "inventory": collective_inventory(text),
            "lowered_has_permute":
                "collective_permute" in pe.lowered_text(batches()[0]),
            "replicated_ops": pe._plan_for(batches()[0], "t")
                .replicated_ops(),
            "collectives": dict(spmd.collectives)}


def case_ring(job, case):
    """ring_attention alone on sp shards: out and Q/K/V grads, gathered."""
    from paddle_tpu_torch.ops.flash_attention import ring_attention
    arrs = np.load(os.path.join(job["dir"], "ring.npz"))
    mesh = make_mesh([distributed.get_world_size()], ["sp"])
    out = {}
    for causal in (False, True):
        q, k, v, do = (torch.tensor(arrs[n]) for n in ("q", "k", "v", "do"))
        shards = [spmd._block(t, mesh, "sp", 2).requires_grad_(True)
                  for t in (q, k, v)]
        o = ring_attention(*shards, mesh, "sp", causal=causal,
                           sm_scale=0.3)
        grads = torch.autograd.grad(o, shards,
                                    spmd._block(do, mesh, "sp", 2))
        full = [spmd.all_gather(t.detach(), mesh, "sp", 2)
                for t in (o, *grads)]
        out[str(causal)] = [t.numpy().tolist() for t in full]
    return out


def case_error(job, case):
    """The error a run raises, as (type, message)."""
    main, _, loss = build("sgd", case.get("dropout", 0.0),
                          case.get("seq_len", 32))
    mesh = make_mesh(case["mesh"], case["axes"])
    pe, _ = pe_for(job, case, main, loss, case["state"], mesh)
    feed = batches(1, case.get("rows", 8), case.get("seq_len", 32))[0]
    try:
        pe.run(feed=feed, fetch_list=[loss.name])
    except Exception as e:  # noqa: BLE001 - the test reads what it was
        return {"type": type(e).__name__, "message": str(e)}
    return {"type": None}


def case_distributed(job, case):
    """The env protocol's world, shard_local_batch against the global
    feed, and a barrier."""
    main, _, loss = build("sgd")
    mesh = distributed.global_mesh()
    feeds = batches()
    pe, _ = pe_for(job, case, main, loss, case["state"], mesh)
    glob = run_losses(pe, feeds, loss)
    pe2, _ = pe_for(job, case, main, loss, case["state"], mesh)
    r, n = distributed.get_rank(), distributed.get_world_size()
    rows = 8 // n
    local = [{k: distributed.shard_local_batch(v[r * rows:(r + 1) * rows],
                                               mesh)
              for k, v in b.items()} for b in feeds]
    loc = run_losses(pe2, local, loss)
    distributed.barrier()
    return {"rank": r, "world": n, "backend": distributed.backend(),
            "global": glob, "local": loc,
            "global_rows": local[0]["src_word"].global_rows}


def case_async_feeder(job, case):
    """AsyncFeeder(sharding=batch_sharded(mesh)) yields this rank's rows,
    and a ParallelExecutor takes them as the rank's shard."""
    main, _, loss = build("sgd")
    mesh = distributed.global_mesh()
    feeds = batches()
    samples = [list(b["src_word"]) for b in feeds]

    def feeder(batch):
        rows = np.stack(batch)
        return {"src_word": rows, "trg_word": rows, "lbl_word": rows}
    af = ptt.AsyncFeeder(feeder, lambda: iter(samples),
                         device=ptt.CPUPlace(),
                         sharding=ptt.parallel.batch_sharded(mesh))
    got = [f["src_word"].data.numpy().reshape(-1, 32).tolist() for f in af]
    pe, _ = pe_for(job, case, main, loss, case["state"], mesh)
    losses = [float(pe.run(feed=f, fetch_list=[loss.name])[0][0])
              for f in af]
    return {"rows": got, "losses": losses}


CASES = {"trajectory": case_trajectory, "ring": case_ring,
         "error": case_error, "distributed": case_distributed,
         "async_feeder": case_async_feeder}


def main():
    job = json.load(open(sys.argv[1]))
    distributed.init(use_cuda=False)
    n = distributed.get_world_size()
    results = {}
    for case in job["cases"]:
        if case["world"] != n:
            continue
        try:
            results[case["name"]] = CASES[case["kind"]](job, case)
        except Exception:  # noqa: BLE001 - reported to the test
            results[case["name"]] = {"failed": traceback.format_exc()}
    with open(os.path.join(job["dir"],
                           f"rank{distributed.get_rank()}_{n}.json"),
              "w") as f:
        json.dump(results, f)


if __name__ == "__main__":
    main()
