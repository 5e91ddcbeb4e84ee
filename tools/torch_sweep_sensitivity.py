#!/usr/bin/env python3
"""How far one float32 rounding of the inputs moves chip_smoke.py's
optimizer sweep, at the learning rate the sweep uses and at a larger
one, beside how far the card's run lies from the host's: the floor under
the sweep's card-against-host tolerance, and a check of it.

    python3 tools/torch_sweep_sensitivity.py [--card] [--out DIR]

For each optimizer that scales a grad by about its own size (Adagrad,
Adamax, DecayedAdagrad, RMSProp, centered RMSProp) at lr 1e-2 and at
the sweep's 1e-4, for Ftrl (lr 1e-4) with l2 0 and 0.5 and for Adadelta (lr 1) with
epsilon 1e-6 and 1e-9, builds the sweep's net
(`chip_smoke.build_sweep`: 512 -> 512 -> 512 -> 10, batch 64), runs its
startup with `paddle_tpu_torch` on the CPU and trains SWEEP_STEPS steps
twice on the host from that state on the sweep's feeds: as they are,
and with the first step's inputs each scaled by (1 +- 1e-7), signs at
random: about one float32 rounding each, as a card's summation order
makes (a change of one sign for all would be near a symmetry of the
net: its ReLUs are homogeneous). With ``--card`` it also trains on the
card from the same state and feeds (the sweep's own comparison), and
takes each step on the card from the host's state after the step before
(one step's disagreement, before any compounding), and compares every
var the step writes, to name the first that parts by more than
SWEEP_STATE_L2: how many of its elements part, and at the one that
parts most its value on each side and that of the var it is the grad
of. Prints, for each,
the host's losses, and for each comparison the largest relative change
of a loss and the largest relative L2 change of a persistable (the
sweep's two measures, SWEEP_LOSS_RTOL and SWEEP_STATE_L2), and of a
parameter's grad in the last step compared. The last line
printed is one JSON summary; ``--out`` also writes it to
DIR/sweep_sensitivity.json. Without ``--card`` every number is the
CPU's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (DATA_SEED, SWEEP_BATCH, SWEEP_LOSS_RTOL,  # noqa: E402
                        SWEEP_STATE_L2, SWEEP_STEPS, SWEEP_WIDTH, _rel_l2,
                        build_sweep)

LRS = (1e-2, 1e-4)
NORMALIZING = {
    "Adagrad": lambda lr: lambda o: o.Adagrad(learning_rate=lr),
    "Adamax": lambda lr: lambda o: o.Adamax(learning_rate=lr),
    "DecayedAdagrad": lambda lr: lambda o: o.DecayedAdagrad(learning_rate=lr),
    "RMSProp": lambda lr: lambda o: o.RMSProp(learning_rate=lr),
    "RMSProp-centered": lambda lr: lambda o: o.RMSProp(
        learning_rate=lr, momentum=0.9, centered=True),
}
# the sweep's other settings that a default might replace
OTHERS = {"Ftrl l2=0": lambda o: o.Ftrl(learning_rate=1e-4),
          "Ftrl l2=0.5": lambda o: o.Ftrl(learning_rate=1e-4, l2=0.5),
          "Adadelta epsilon=1e-6": lambda o: o.Adadelta(learning_rate=1.0),
          "Adadelta epsilon=1e-9": lambda o: o.Adadelta(learning_rate=1.0,
                                                        epsilon=1e-9)}


def _steps(ptt, main, loss, state, feeds, place, fetch=()):
    """Losses; after each step of `feeds` from `state` on `place`, the
    persistables and the parameters' grads; and after the last, the vars
    named in `fetch`: all copied off the device."""
    from paddle_tpu_torch.core.executor import fetch_var
    grads = [p.name + "@GRAD" for p in main.global_block().all_parameters()]
    scope = ptt.io.state_from_numpy(state, place)
    exe = ptt.Executor(place)
    losses, states = [], []
    for f in feeds:
        out = exe.run(main, feed=f, fetch_list=[loss] + grads + list(fetch),
                      scope=scope)
        losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
        states.append({n: np.array(fetch_var(n, scope), copy=True)
                       for n in scope.local_var_names()})
        states[-1].update((n, np.array(v, copy=True))
                          for n, v in zip(grads, out[1:]))
    fetched = {n: np.array(v, copy=True)
               for n, v in zip(fetch, out[1 + len(grads):])}
    return losses, states, fetched


def _apart(run_a, run_b):
    """The sweep's two measures between two runs: the largest relative
    loss change, and the largest relative L2 change of a float
    persistable after the last step, with its name; and the largest
    relative L2 change of a parameter's grad in the last step."""
    (la, sa, _), (lb, sb, _) = run_a, run_b
    loss = max(abs(a - b) / abs(a) for a, b in zip(la, lb))
    state, worst = max((_rel_l2(np, sb[-1][n], a), n)
                       for n, a in sa[-1].items()
                       if np.issubdtype(a.dtype, np.floating)
                       and not n.endswith("@GRAD"))
    grad, worst_grad = max((_rel_l2(np, sb[-1][n], a), n)
                           for n, a in sa[-1].items() if n.endswith("@GRAD"))
    return dict(loss=loss, state=state, worst=worst, grad=grad,
                worst_grad=worst_grad)


def _activations(main):
    """The float vars the step's ops write that are no persistable, in
    the order the ops write them (forward, then backward)."""
    block = main.global_block()
    seen, out = set(), []
    for op in block.ops:
        for names in op.outputs.values():
            for n in names:
                v = block.vars.get(n)
                if (n not in seen and v is not None and not v.persistable
                        and str(v.dtype).startswith("float")):
                    seen.add(n)
                    out.append(n)
    return out


def _where(name, dist, host, card):
    """Where var `name` parts between the host's step and the card's: how
    many elements differ by more than 1e-6 of its largest, and at the one
    that differs most, both sides' values and those of the forward var
    it is the grad of."""
    h, c = host[name], card[name]
    diff = np.abs(c - h)
    at = np.unravel_index(int(diff.argmax()), diff.shape)
    out = dict(var=name, rel_l2=dist, elements=int(h.size),
               apart=int((diff > 1e-6 * np.abs(h).max()).sum()),
               at=[int(i) for i in at], host=float(h[at]), card=float(c[at]))
    fwd = name[:-len("@GRAD")] if name.endswith("@GRAD") else None
    if fwd in host:
        out.update(forward=fwd, forward_host=float(host[fwd][at]),
                   forward_card=float(card[fwd][at]))
    return out


def probe(ptt, make_optimizer, card):
    main, startup, loss, _ = build_sweep(ptt, "optimizer:probe",
                                         optimizers={"probe": make_optimizer})
    from paddle_tpu_torch.core.executor import fetch_var
    host = ptt.CPUPlace()
    scope0 = ptt.Scope()
    ptt.Executor(host).run(startup, scope=scope0)
    state = {n: np.array(fetch_var(n, scope0), copy=True)
             for n in scope0.local_var_names()}
    rng = np.random.RandomState(DATA_SEED)
    feeds = [{"x": rng.randn(SWEEP_BATCH, SWEEP_WIDTH).astype(np.float32),
              "label": rng.randint(0, 10, (SWEEP_BATCH, 1)).astype(np.int64)}
             for _ in range(SWEEP_STEPS)]
    signs = np.random.RandomState(DATA_SEED + 1).choice(
        np.float32([-1e-7, 1e-7]), feeds[0]["x"].shape)
    nudged = [dict(feeds[0], x=feeds[0]["x"] * (1 + signs))] + feeds[1:]
    ref = _steps(ptt, main, loss, state, feeds, host)
    row = dict(losses=ref[0], nudged_host=_apart(
        ref, _steps(ptt, main, loss, state, nudged, host)))
    if card:
        dev = ptt.CUDAPlace(0)
        row["card"] = _apart(ref, _steps(ptt, main, loss, state, feeds, dev))
        acts = _activations(main)
        row["card_one_step"] = []
        for k, f in enumerate(feeds):
            start = state if k == 0 else {
                n: v for n, v in ref[1][k - 1].items()
                if not n.endswith("@GRAD")}
            one_host = _steps(ptt, main, loss, start, [f], host, acts)
            one_card = _steps(ptt, main, loss, start, [f], dev, acts)
            apart = _apart(one_host, one_card)
            dist = [(n, _rel_l2(np, one_card[2][n], one_host[2][n]))
                    for n in acts]
            apart["first_apart"] = next(
                (_where(n, d, one_host[2], one_card[2]) for n, d in dist
                 if d > SWEEP_STATE_L2), None)
            apart["largest"] = sorted(dist, key=lambda t: -t[1])[:4]
            row["card_one_step"].append(apart)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--card", action="store_true",
                    help="also train on the card (CUDAPlace(0))")
    ap.add_argument("--out", help="directory for sweep_sensitivity.json")
    args = ap.parse_args(argv)
    import torch
    import paddle_tpu_torch as ptt
    torch.set_num_threads(4)
    if args.card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cases = {f"{name} lr={lr:g}": make(lr)
             for lr in LRS for name, make in NORMALIZING.items()}
    cases.update(OTHERS)
    rows = {}
    for case, make_optimizer in cases.items():
        r = rows[case] = probe(ptt, make_optimizer, args.card)
        line = [f"{case}: host losses {[round(x, 4) for x in r['losses']]}"]
        for key, what in (("nudged_host", "host, inputs +-1e-7"),
                          ("card", "card"),
                          ("card_one_step", "card, each step from the host's "
                                            "state")):
            for a in (r[key] if key == "card_one_step" else [r[key]]) \
                    if key in r else []:
                line.append(f"{what}: loss {a['loss']:.3g}, state "
                            f"{a['state']:.3g} at {a['worst']}, last grad "
                            f"{a['grad']:.3g} at {a['worst_grad']}"
                            + (f", first var apart {a['first_apart']}, "
                               f"largest {a['largest']}"
                               if "largest" in a else ""))
        print("; ".join(line), flush=True)
    summary = {"width": SWEEP_WIDTH, "batch": SWEEP_BATCH,
               "steps": SWEEP_STEPS, "loss_rtol": SWEEP_LOSS_RTOL,
               "state_l2": SWEEP_STATE_L2, "cases": rows}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "sweep_sensitivity.json"), "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
