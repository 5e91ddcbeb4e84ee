"""Transformer-base for WMT En-De (the JAX package's training workload).

Copy of ``paddle_tpu/models/transformer.py`` with its imports rewired: the
standard Transformer encoder-decoder built from framework layers, so the
programs it builds (main and startup) are the JAX package's op for op.
With ``fused_attention=True`` (the default) every attention is one
``fused_attention`` op: the flash kernels of ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu`` on the card, with attention-weight dropout inside
them. The unfused attention path (``fused_attention=False``) is not
ported and raises.

The q/k/v/ffn weights keep their ParamAttr.sharding annotations so the
program is the same; the port runs on one card and ignores them.
"""

from __future__ import annotations

from .. import layers
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from .. import initializer as init


def _shard(spec):
    return ParamAttr(sharding=spec)


def _pos_table(size, d_model):
    helper = LayerHelper("pos_encoding")
    out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op("sinusoid_pos_encoding", outputs={"Out": [out.name]},
                     attrs={"size": size, "d_model": d_model})
    return out


def _fused_attention(qh, kh, vh, d_head, causal, dropout_rate, is_test):
    """Flash-attention op: one O(T)-memory kernel instead of the
    matmul/softmax/dropout/matmul chain (in-kernel weight dropout)."""
    helper = LayerHelper("fused_attention")
    out = helper.create_variable_for_type_inference(dtype=qh.dtype)
    helper.append_op("fused_attention",
                     inputs={"Q": [qh.name], "K": [kh.name], "V": [vh.name]},
                     outputs={"Out": [out.name]},
                     attrs={"causal": causal, "sm_scale": d_head ** -0.5,
                            "dropout_rate": dropout_rate, "is_test": is_test})
    return out


def multi_head_attention(q_in, kv_in, d_model, num_heads, dropout_rate=0.0,
                         causal=False, is_test=False, name="", fused=True):
    if not fused:
        raise NotImplementedError(
            "the unfused attention path (matmul/softmax/dropout/matmul) is "
            "not ported to paddle_tpu_torch; build with fused_attention=True")
    d_head = d_model // num_heads
    q = layers.fc(input=q_in, size=d_model, num_flatten_dims=2, bias_attr=False,
                  param_attr=_shard((None, "mp")), name=name + "_q")
    k = layers.fc(input=kv_in, size=d_model, num_flatten_dims=2, bias_attr=False,
                  param_attr=_shard((None, "mp")), name=name + "_k")
    v = layers.fc(input=kv_in, size=d_model, num_flatten_dims=2, bias_attr=False,
                  param_attr=_shard((None, "mp")), name=name + "_v")

    def split_heads(x):
        r = layers.reshape(x, shape=[0, 0, num_heads, d_head])
        return layers.transpose(r, perm=[0, 2, 1, 3])

    qh, kh, vh = split_heads(q), split_heads(k), split_heads(v)
    ctx = _fused_attention(qh, kh, vh, d_head, causal, dropout_rate, is_test)
    ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
    merged = layers.reshape(ctx, shape=[0, 0, d_model])
    return layers.fc(input=merged, size=d_model, num_flatten_dims=2,
                     bias_attr=False, param_attr=_shard(("mp", None)),
                     name=name + "_o")


def ffn(x, d_model, d_inner, dropout_rate=0.0, is_test=False, name=""):
    h = layers.fc(input=x, size=d_inner, num_flatten_dims=2, act="relu",
                  param_attr=_shard((None, "mp")), name=name + "_ffn1")
    if dropout_rate:
        h = layers.dropout(h, dropout_prob=dropout_rate, is_test=is_test,
                           dropout_implementation="upscale_in_train")
    return layers.fc(input=h, size=d_model, num_flatten_dims=2,
                     param_attr=_shard(("mp", None)), name=name + "_ffn2")


def _add_norm(x, sub, dropout_rate=0.0, is_test=False):
    if dropout_rate:
        sub = layers.dropout(sub, dropout_prob=dropout_rate, is_test=is_test,
                             dropout_implementation="upscale_in_train")
    return layers.layer_norm(layers.elementwise_add(x, sub), begin_norm_axis=2)


def _embed(ids, vocab_size, d_model, seq_len, dropout_rate, is_test, name):
    emb = layers.embedding(ids, size=[vocab_size, d_model],
                           param_attr=ParamAttr(
                               name=name, sharding=("mp", None),
                               initializer=init.NormalInitializer(0.0, d_model ** -0.5)))
    emb = layers.scale(emb, scale=d_model ** 0.5)
    pos = _pos_table(seq_len, d_model)
    out = layers.elementwise_add(emb, pos, axis=-1)
    if dropout_rate:
        out = layers.dropout(out, dropout_prob=dropout_rate, is_test=is_test,
                             dropout_implementation="upscale_in_train")
    return out


def transformer(src_vocab_size=30000, trg_vocab_size=30000, seq_len=256,
                n_layer=6, n_head=8, d_model=512, d_inner=2048,
                dropout_rate=0.1, is_test=False, label_smooth_eps=0.0,
                fused_attention=True):
    """Returns (feeds, fetches) for a teacher-forced training step.
    Sequences are bucketed/padded to the static `seq_len` (the reference
    padded per-batch via LoD)."""
    src = layers.data(name="src_word", shape=[-1, seq_len], dtype="int64",
                      append_batch_size=False)
    trg = layers.data(name="trg_word", shape=[-1, seq_len], dtype="int64",
                      append_batch_size=False)
    lbl = layers.data(name="lbl_word", shape=[-1, seq_len], dtype="int64",
                      append_batch_size=False)

    enc = _embed(src, src_vocab_size, d_model, seq_len, dropout_rate,
                 is_test, "src_emb")
    for i in range(n_layer):
        attn = multi_head_attention(enc, enc, d_model, n_head, dropout_rate,
                                    is_test=is_test, name=f"enc{i}_self",
                                    fused=fused_attention)
        enc = _add_norm(enc, attn, dropout_rate, is_test)
        f = ffn(enc, d_model, d_inner, dropout_rate, is_test, name=f"enc{i}")
        enc = _add_norm(enc, f, dropout_rate, is_test)

    dec = _embed(trg, trg_vocab_size, d_model, seq_len, dropout_rate,
                 is_test, "trg_emb")
    for i in range(n_layer):
        self_attn = multi_head_attention(dec, dec, d_model, n_head,
                                         dropout_rate, causal=True,
                                         is_test=is_test, name=f"dec{i}_self",
                                         fused=fused_attention)
        dec = _add_norm(dec, self_attn, dropout_rate, is_test)
        cross = multi_head_attention(dec, enc, d_model, n_head, dropout_rate,
                                     is_test=is_test, name=f"dec{i}_cross",
                                     fused=fused_attention)
        dec = _add_norm(dec, cross, dropout_rate, is_test)
        f = ffn(dec, d_model, d_inner, dropout_rate, is_test, name=f"dec{i}")
        dec = _add_norm(dec, f, dropout_rate, is_test)

    logits = layers.fc(input=dec, size=trg_vocab_size, num_flatten_dims=2,
                       bias_attr=False, param_attr=_shard((None, "mp")),
                       name="out_proj")
    loss = layers.softmax_with_cross_entropy(logits=logits, label=lbl)
    avg_loss = layers.mean(loss)
    return ({"src_word": src, "trg_word": trg, "lbl_word": lbl},
            {"loss": avg_loss, "logits": logits})


def build(**kw):
    return transformer(**kw)
