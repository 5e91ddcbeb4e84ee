#!/usr/bin/env python3
"""Hand-written PyTorch Transformer-base: the framework-overhead yardstick.

The port's counterpart of tools/yardstick_transformer.py (no jax, nothing
of paddle_tpu or paddle_tpu_torch). The same architecture, precision
policy and step semantics as the JAX tool, which are those of
`models/transformer.build(seq_len=256, fused_attention=False)` + Adam(1e-3):
embeddings * sqrt(d) + sinusoid, 6 enc / 6 dec post-LN blocks, unfused
attention (bf16 products, bf16 max-subtracted softmax), dropout 0.1 by a
uint8 keep test on hashed bits, float32 master parameters, float32
softmax cross entropy.

Dropout keeps an element when the low byte of murmur3's fmix32 over
(its row-major index * 2654435761 + seed) is at most round(256 (1 -
rate)) - 1: the JAX tool's `_dropout` bit for bit for the same uint32
seed (the JAX tool derives that seed from a key's words; here each site's
seed comes from the step's seed by `site_seeds`). Plain PyTorch ops
throughout: this is what one writes without the Program layer, and the
difference between its step time and the framework's is the layer's cost
(`tools/torch_step_profile.py --yardstick` traces it).

Usage: python3 tools/torch_yardstick_transformer.py [--cpu] [--tiny]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

M32 = 0xFFFFFFFF
B16 = torch.bfloat16


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 tensors holding uint32 values; x is
    split into 16-bit halves, so no partial product passes 2**48."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & M32


def _fmix32(x):
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def _fmix32_int(h: int) -> int:
    h = ((h ^ (h >> 16)) * 0x85EBCA6B) & M32
    h = ((h ^ (h >> 13)) * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def site_seeds(seed: int, n: int = 64):
    """The n dropout sites' uint32 seeds of a step seeded `seed` (the JAX
    tool splits its key into 64 the same way, by its own PRNG)."""
    return [_fmix32_int((int(seed) * 0x9E3779B9 + (i + 1) * 0x85EBCA6B)
                        & M32) for i in range(n)]


def keep_mask(seed: int, shape, rate: float, device):
    """The JAX tool's keep test: bool of `shape`."""
    t = round((1.0 - rate) * 256.0) - 1
    if t < 0:
        return torch.zeros(shape, dtype=torch.bool, device=device)
    n = int(np.prod(shape))
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    h = (_mul32(idx & M32, 2654435761) + int(seed)) & M32
    return (_fmix32(h) & 0xFF) <= min(255, t)


def _dropout(seed, x, rate):
    if not rate:
        return x
    if round((1.0 - rate) * 256.0) - 1 < 0:
        return torch.zeros_like(x)
    keep = keep_mask(seed, x.shape, rate, x.device)
    return torch.where(keep, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _layer_norm(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _softmax(x):
    """Max-subtracted softmax in x's dtype (bf16 here), as jax.nn.softmax."""
    e = torch.exp(x - x.amax(-1, keepdim=True).detach())
    return e / e.sum(-1, keepdim=True)


def _attn(seed, q_in, kv_in, p, rate, causal, n_head):
    d_model = q_in.shape[-1]
    d_head = d_model // n_head

    def proj(x, w):
        return x.to(B16) @ w.to(B16)

    def heads(x):  # [B,T,D] -> [B,H,T,dh]
        b, t, _ = x.shape
        return x.reshape(b, t, n_head, d_head).transpose(1, 2)

    q, k, v = heads(proj(q_in, p["wq"])), heads(proj(kv_in, p["wk"])), \
        heads(proj(kv_in, p["wv"]))
    scores = (q @ k.transpose(-1, -2)) * (d_head ** -0.5)
    if causal:
        t = scores.shape[-1]
        mask = torch.ones((t, t), dtype=torch.bool,
                          device=scores.device).tril()
        scores = torch.where(mask, scores, torch.tensor(
            -1e9, dtype=scores.dtype, device=scores.device))
    w = _softmax(scores)
    w = _dropout(seed, w, rate)
    ctx = w @ v
    b, h, t, dh = ctx.shape
    merged = ctx.transpose(1, 2).reshape(b, t, h * dh)
    return merged @ p["wo"].to(B16)


def _ffn(x, p):
    h = torch.relu(x.to(B16) @ p["w1"].to(B16) + p["b1"].to(B16))
    return h @ p["w2"].to(B16) + p["b2"].to(B16)


def _add_norm(seed, x, sub, p, rate):
    sub = _dropout(seed, sub, rate)
    return _layer_norm(x + sub, p["g"], p["b"])


def _embed(seed, ids, table, pos, rate):
    d_model = table.shape[1]
    e = table[ids].to(B16) * (d_model ** 0.5)
    e = e + pos.to(B16)
    return _dropout(seed, e, rate)


def _sinusoid(seq_len, d_model, device):
    pos = np.arange(seq_len)[:, None]
    i = np.arange(d_model)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / d_model)
    t = np.zeros((seq_len, d_model), np.float32)
    t[:, 0::2] = np.sin(angle[:, 0::2])
    t[:, 1::2] = np.cos(angle[:, 1::2])
    return torch.from_numpy(t).to(device)


def init_params(rng, src_vocab=30000, trg_vocab=30000, n_layer=6, n_head=8,
                d_model=512, d_inner=2048, device="cpu"):
    """The JAX tool's parameters: the same RandomState draws in the same
    order, as float32 tensors on `device`."""
    r = np.random.RandomState(rng)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def mat(a, b, std=None):
        std = std if std is not None else (6.0 / (a + b)) ** 0.5
        return t(r.uniform(-std, std, (a, b)).astype(np.float32))

    def attn_p():
        return {"wq": mat(d_model, d_model), "wk": mat(d_model, d_model),
                "wv": mat(d_model, d_model), "wo": mat(d_model, d_model)}

    def ln_p():
        return {"g": t(np.ones((d_model,), np.float32)),
                "b": t(np.zeros((d_model,), np.float32))}

    def ffn_p():
        return {"w1": mat(d_model, d_inner),
                "b1": t(np.zeros((d_inner,), np.float32)),
                "w2": mat(d_inner, d_model),
                "b2": t(np.zeros((d_model,), np.float32))}

    p = {"src_emb": t(r.normal(0, d_model ** -0.5, (src_vocab, d_model))
                      .astype(np.float32)),
         "trg_emb": t(r.normal(0, d_model ** -0.5, (trg_vocab, d_model))
                      .astype(np.float32)),
         "out": mat(d_model, trg_vocab),
         "enc": [], "dec": []}
    for _ in range(n_layer):
        p["enc"].append({"attn": attn_p(), "ln1": ln_p(), "ffn": ffn_p(),
                         "ln2": ln_p()})
        p["dec"].append({"self": attn_p(), "ln1": ln_p(), "cross": attn_p(),
                         "ln2": ln_p(), "ffn": ffn_p(), "ln3": ln_p()})
    return p


def loss_fn(params, batch, seed, seq_len=256, n_head=8, rate=0.1):
    seeds = iter(site_seeds(seed))
    pos = _sinusoid(seq_len, params["src_emb"].shape[1],
                    params["src_emb"].device)

    enc = _embed(next(seeds), batch["src"], params["src_emb"], pos, rate)
    for lp in params["enc"]:
        a = _attn(next(seeds), enc, enc, lp["attn"], rate, False, n_head)
        enc = _add_norm(next(seeds), enc, a, lp["ln1"], rate)
        f = _ffn(enc, lp["ffn"])
        enc = _add_norm(next(seeds), enc, f, lp["ln2"], rate)

    dec = _embed(next(seeds), batch["trg"], params["trg_emb"], pos, rate)
    for lp in params["dec"]:
        a = _attn(next(seeds), dec, dec, lp["self"], rate, True, n_head)
        dec = _add_norm(next(seeds), dec, a, lp["ln1"], rate)
        c = _attn(next(seeds), dec, enc, lp["cross"], rate, False, n_head)
        dec = _add_norm(next(seeds), dec, c, lp["ln2"], rate)
        f = _ffn(dec, lp["ffn"])
        dec = _add_norm(next(seeds), dec, f, lp["ln3"], rate)

    logits = (dec.to(B16) @ params["out"].to(B16)).float()
    lse = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, batch["lbl"][..., None])[..., 0]
    return (lse - gold).mean()


def tree_map(fn, *trees):
    """fn over the leaves of nested dicts and lists, in the same order."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, list):
        return [tree_map(fn, *(t[i] for t in trees)) for i in range(len(t0))]
    return fn(*trees)


def tree_leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def adam_init(params):
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params), "t": 0}


@torch.no_grad()
def adam_update(params, grads, state, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
    t = state["t"] + 1
    m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
    v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"], grads)
    # the step's scalars in float32, as the JAX tool's traced int32 t
    tf = np.float32(t)
    corr = np.sqrt(np.float32(1) - np.float32(b2) ** tf) \
        / (np.float32(1) - np.float32(b1) ** tf)
    lr_corr = float(np.float32(lr) * corr)
    new_p = tree_map(lambda p, m, v: p - lr_corr * m / (v.sqrt() + eps),
                     params, m, v)
    return new_p, {"m": m, "v": v, "t": t}


def train_step(params, opt_state, batch, seed, seq_len=256, n_head=8,
               rate=0.1):
    """One Adam step: (params, opt_state, float32 loss tensor)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = loss_fn(live, batch, seed, seq_len=seq_len, n_head=n_head,
                   rate=rate)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    it = iter(grads)
    grads = tree_map(lambda _: next(it).float(), live)
    params, opt_state = adam_update(params, grads, opt_state)
    return params, opt_state, loss.detach()


def make_batch(batch_size=64, seq_len=256, vocab=30000, seed=0,
               device="cpu"):
    """The JAX tool's batch (the same draws), as int64 index tensors."""
    r = np.random.RandomState(seed)
    return {k: torch.from_numpy(r.randint(1, vocab, (batch_size, seq_len))
                                .astype(np.int64)).to(device)
            for k in ("src", "trg", "lbl")}


# train-base-unfused-amp's shapes (`chip_smoke.py`: B 64, seq 256) and the
# tiny widths of the CPU runs
BASE = dict(batch_size=64, seq_len=256, vocab=30000, n_layer=6, n_head=8,
            d_model=512, d_inner=2048)
TINY = dict(batch_size=4, seq_len=8, vocab=64, n_layer=1, n_head=4,
            d_model=32, d_inner=64)
STEPS = 15   # timed steps after the first, as the JAX tool times


def setup(cfg, device, seed=0):
    """A step function at `cfg`'s widths on `device` over fresh
    parameters, Adam state and batch: step(i) runs train_step with seed i
    and returns the loss tensor."""
    # bf16 products sum in float32, as XLA sums the JAX tool's
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    params = init_params(seed, src_vocab=cfg["vocab"],
                         trg_vocab=cfg["vocab"], n_layer=cfg["n_layer"],
                         n_head=cfg["n_head"], d_model=cfg["d_model"],
                         d_inner=cfg["d_inner"], device=device)
    state = {"p": params, "o": adam_init(params)}
    batch = make_batch(cfg["batch_size"], cfg["seq_len"], cfg["vocab"],
                       device=device)

    def step(i):
        state["p"], state["o"], loss = train_step(
            state["p"], state["o"], batch, i, seq_len=cfg["seq_len"],
            n_head=cfg["n_head"])
        return loss

    return step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="the hand-written PyTorch Transformer-base step")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host (default: the card)")
    ap.add_argument("--tiny", action="store_true",
                    help="1 + 1 layers, d_model 32, batch 4 x seq 8")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device is visible (torch.cuda.is_available() is "
              "False); pass --cpu to run on the host", file=sys.stderr)
        return 2
    device = "cpu" if args.cpu else "cuda"
    cfg = TINY if args.tiny else BASE
    step = setup(cfg, device)
    loss = step(0)
    float(loss)          # sync
    t0 = time.perf_counter()
    for i in range(STEPS):
        loss = step(i + 1)
    float(loss)
    dt = (time.perf_counter() - t0) / STEPS
    print(f"yardstick on {device}: {dt * 1e3:.1f} ms/step, "
          f"{cfg['batch_size'] * cfg['seq_len'] / dt:.0f} tok/s, "
          f"loss={float(loss):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
