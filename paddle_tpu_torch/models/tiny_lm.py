"""Tiny autoregressive decoder LM: the generative reference model.

Copy of ``paddle_tpu/models/tiny_lm.py`` with its imports rewired; the
programs it builds are the JAX package's, op for op, so a dir saved by
either package serves in both. A PREFILL program (prompt at a
bucket-ladder rung -> causal attention -> K/V scattered into the paged
cache -> next-token logits at each row's last valid position) and a
DECODE program (one token per fixed slot -> K/V appended at seq_len-1 ->
ragged paged attention over the block table -> logits) share one
parameter set and one per-layer ``*@KV_CACHE`` cache
(ops/paged_attention.py). Both are saved into ONE atomic model dir
(`save_tiny_lm`): prefill as `__model__`, decode as `__decode__`, and the
decode-step signature in MANIFEST.json.

Architecture per layer: residual attention + 2x relu MLP, no positional
embedding. Sampling is greedy argmax on the host.

The int8 KV residency (`kv_dtype="int8"`) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict

from .. import initializer as init
from .. import unique_name
from ..core import ir
from ..core.executor import CPUPlace, Executor, Scope
from ..layer_helper import LayerHelper
from ..layers import nn as layers_nn
from ..layers.io import data as data_layer
from ..param_attr import ParamAttr

DTYPE = "float32"


def _param(name: str, shape, std: float):
    helper = LayerHelper("tiny_lm")
    return helper.create_parameter(
        ParamAttr(name=name,
                  initializer=init.NormalInitializer(0.0, std)),
        list(shape), DTYPE)


def _add(x, y):
    helper = LayerHelper("tiny_lm")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("elementwise_add", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": -1})
    return out


def default_signature(vocab=32, d_model=16, n_heads=2, n_layers=2,
                      max_slots=4, block_size=4, max_context=32,
                      num_blocks=None, prefill_rows=(1, 2, 4),
                      prefill_seq_rungs=(8, 16), eos_token=None,
                      kv_dtype="fp32") -> Dict:
    """The decode-step signature recorded in MANIFEST.json — everything
    a registry needs to materialize the cache and warm both programs."""
    max_bps = -(-max_context // block_size)
    if num_blocks is None:
        # worst case: every slot at max context, plus the trash block
        num_blocks = 1 + max_slots * max_bps
    if kv_dtype != "fp32":
        raise ValueError(f"kv_dtype must be 'fp32' (the int8 residency is "
                         f"not ported yet), got {kv_dtype!r}")
    cache_vars = [f"lm_kv_{kv}_{i}{ir.KV_CACHE_SUFFIX}"
                  for i in range(n_layers) for kv in ("k", "v")]
    return {
        "vocab": int(vocab), "d_model": int(d_model),
        "num_heads": int(n_heads), "head_dim": int(d_model // n_heads),
        "n_layers": int(n_layers), "max_slots": int(max_slots),
        "block_size": int(block_size), "max_context": int(max_context),
        "max_blocks_per_seq": int(max_bps), "num_blocks": int(num_blocks),
        "prefill_rows": [int(r) for r in prefill_rows],
        "prefill_seq_rungs": [int(r) for r in prefill_seq_rungs],
        "eos_token": eos_token,
        "cache_vars": cache_vars,
        "decode_feeds": ["tokens", "block_tables", "seq_lens"],
        "kv_dtype": str(kv_dtype),
    }


def _cache_vars(block, sig, layer: int):
    shape = (sig["num_blocks"], sig["block_size"], sig["num_heads"],
             sig["head_dim"])
    out = []
    for kv in ("k", "v"):
        name = f"lm_kv_{kv}_{layer}{ir.KV_CACHE_SUFFIX}"
        if name in block.vars:
            out.append(block.vars[name])
        else:
            out.append(block.create_var(name=name, shape=shape, dtype=DTYPE,
                                        persistable=True,
                                        stop_gradient=True))
    return out


def _body(tokens, block_tables, seq_lens, sig, phase: str):
    """Shared trunk: embedding -> n_layers of (attention + MLP) ->
    logits. `phase` picks the attention op ("prefill_attention" on
    [rows, T, D] with gather_last_token at the end, "paged_attention" on
    [slots, D])."""
    block = ir.default_main_program().global_block()
    d, H = sig["d_model"], sig["num_heads"]
    std = 0.5 / math.sqrt(d)
    emb = _param("lm_emb", (sig["vocab"], d), std)
    helper = LayerHelper("tiny_lm")
    h = helper.create_variable_for_type_inference(DTYPE)
    helper.append_op("lookup_table",
                     inputs={"W": [emb.name], "Ids": [tokens.name]},
                     outputs={"Out": [h.name]},
                     attrs={"padding_idx": -1, "is_sparse": False,
                            "is_distributed": False})
    sm_scale = 1.0 / math.sqrt(sig["head_dim"])
    for i in range(sig["n_layers"]):
        kc, vc = _cache_vars(block, sig, i)
        q = layers_nn.matmul(h, _param(f"lm_l{i}_wq", (d, d), std))
        k = layers_nn.matmul(h, _param(f"lm_l{i}_wk", (d, d), std))
        v = layers_nn.matmul(h, _param(f"lm_l{i}_wv", (d, d), std))
        attn = helper.create_variable_for_type_inference(DTYPE)
        op_type = ("prefill_attention" if phase == "prefill"
                   else "paged_attention")
        helper.append_op(
            op_type,
            inputs={"Q": [q.name], "K": [k.name], "V": [v.name],
                    "KCache": [kc.name], "VCache": [vc.name],
                    "BlockTables": [block_tables.name],
                    "SeqLens": [seq_lens.name]},
            outputs={"Out": [attn.name], "KCacheOut": [kc.name],
                     "VCacheOut": [vc.name]},
            attrs={"num_heads": H, "sm_scale": sm_scale})
        h = _add(h, layers_nn.matmul(
            attn, _param(f"lm_l{i}_wo", (d, d), std)))
        m = layers_nn.relu(layers_nn.matmul(
            h, _param(f"lm_l{i}_w1", (d, 2 * d), std)))
        h = _add(h, layers_nn.matmul(
            m, _param(f"lm_l{i}_w2", (2 * d, d), std)))
    if phase == "prefill":
        last = helper.create_variable_for_type_inference(DTYPE)
        helper.append_op("gather_last_token",
                         inputs={"X": [h.name], "SeqLens": [seq_lens.name]},
                         outputs={"Out": [last.name]})
        h = last
    return layers_nn.matmul(h, _param("lm_head", (d, sig["vocab"]), std))


def build_tiny_lm(sig=None, seed=11, **sig_kwargs):
    """Build (prefill_program, decode_program, startup_program, logits
    pair, signature). Both main programs share parameters by explicit
    name; the startup program initializes each exactly once."""
    sig = dict(sig) if sig else default_signature(**sig_kwargs)
    startup = ir.Program()
    prefill = ir.Program()
    max_b = sig["max_blocks_per_seq"]
    with ir.program_guard(prefill, startup), unique_name.guard():
        tokens = data_layer("tokens", shape=[-1], dtype="int64")
        bt = data_layer("block_tables", shape=[max_b], dtype="int32")
        sl = data_layer("seq_lens", shape=[-1], dtype="int32",
                        append_batch_size=False)
        prefill_logits = _body(tokens, bt, sl, sig, "prefill")
    decode = ir.Program()
    with ir.program_guard(decode, startup), unique_name.guard():
        tokens = data_layer("tokens", shape=[1], dtype="int64")
        bt = data_layer("block_tables", shape=[max_b], dtype="int32")
        sl = data_layer("seq_lens", shape=[-1], dtype="int32",
                        append_batch_size=False)
        decode_logits = _body(tokens, bt, sl, sig, "decode")
    prefill.random_seed = decode.random_seed = startup.random_seed = seed
    return prefill, decode, startup, (prefill_logits, decode_logits), sig


def save_tiny_lm(dirname, sig=None, seed=11, scale=1.0, **sig_kwargs):
    """Init + save a tiny LM as a generative model dir (atomic commit:
    prefill `__model__` + decode `__decode__` + params + MANIFEST with
    the decode signature). The parameters are drawn on the host, as in the
    JAX package. `scale` multiplies them, so a re-save is an observably
    different version. Returns the signature."""
    from .. import io as _io

    prefill, decode_prog, startup, (p_logits, d_logits), sig = \
        build_tiny_lm(sig=sig, seed=seed, **sig_kwargs)
    exe = Executor(CPUPlace())
    scope = Scope()
    exe.run(startup, scope=scope)
    if scale != 1.0:
        for name in list(scope.local_var_names()):
            if name.startswith("lm_"):
                scope.set_var(name, scope.find_var(name) * scale)
    decode_meta = {
        "program": decode_prog.to_dict(),
        "feed_names": list(sig["decode_feeds"]),
        "fetch_names": [d_logits.name],
    }
    _io.save_inference_model(
        dirname, ["tokens", "block_tables", "seq_lens"], [p_logits], exe,
        main_program=prefill, scope=scope,
        extra_programs={_io.DECODE_FILENAME: decode_meta},
        manifest_extra={"decode": sig})
    return sig
