"""Attention seq2seq NMT (mirror of
``paddle_tpu/models/machine_translation.py``; reference
benchmark/fluid/models/machine_translation.py and the book test
python/paddle/fluid/tests/book/test_machine_translation.py).

Encoder: embedding -> fc -> LSTM over the padded source (`src_word` is
fed as a `(ids [B, Ts, 1], lengths [B])` pair).
Decoder (train, `build`): a StaticRNN over the target steps, a GRU cell
with dot-product attention into the encoder states, the softmax masked
past each source's length through the encoder's `@SEQLEN` companion.
Decoder (infer, `build_infer`): a StaticRNN of `max_len` steps with a
fixed beam width, `beam_search_step` and `beam_backtrack`
(``ops/beam.py``) in place of the reference's LoD beam ops.
"""

from __future__ import annotations

from .. import layers
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr


def encoder(src_word, dict_size, emb_dim, hidden_dim):
    emb = layers.embedding(src_word, size=[dict_size, emb_dim],
                           param_attr=ParamAttr(name="src_emb"))
    proj = layers.fc(input=emb, size=hidden_dim * 4, num_flatten_dims=2,
                     bias_attr=False, param_attr=ParamAttr(name="enc_proj"))
    hidden, _ = layers.dynamic_lstm(input=proj, size=hidden_dim * 4,
                                    param_attr=ParamAttr(name="enc_lstm_w"))
    return hidden  # [B, Ts, H], carries @SEQLEN of src


def _attention(dec_h, enc_out):
    """dot attention: dec_h [N, H], enc_out [N, Ts, H] -> context [N, H].
    The softmax is masked by enc_out's @SEQLEN companion (LoD analog)."""
    scores = layers.matmul(enc_out, layers.unsqueeze(dec_h, axes=[2]))
    scores = layers.squeeze(scores, axes=[2])          # [N, Ts]
    scores.lod_level = enc_out.lod_level
    weights = layers.sequence_softmax(scores)           # masked by @SEQLEN
    ctx = layers.matmul(layers.unsqueeze(weights, axes=[1]), enc_out)
    return layers.squeeze(ctx, axes=[1])                # [N, H]


def train_decoder(enc_out, trg_word, dict_size, emb_dim, hidden_dim):
    trg_emb = layers.embedding(trg_word, size=[dict_size, emb_dim],
                               param_attr=ParamAttr(name="trg_emb"))
    h0 = layers.fill_constant_batch_size_like(enc_out, [-1, hidden_dim],
                                              "float32", 0.0)
    rnn = layers.StaticRNN(name="dec_rnn")
    with rnn.step():
        emb_t = rnn.step_input(trg_emb)                 # [B, E]
        h = rnn.memory(init=h0)                          # [B, H]
        ctx = _attention(h, enc_out)
        gate_in = layers.fc(input=layers.concat([emb_t, ctx], axis=1),
                            size=hidden_dim * 3, bias_attr=False,
                            param_attr=ParamAttr(name="dec_gate_proj"))
        nh, _, _ = layers.gru_unit(gate_in, h, hidden_dim * 3,
                                   param_attr=ParamAttr(name="dec_gru_w"))
        rnn.update_memory(h, nh)
        out = layers.fc(input=nh, size=dict_size, act=None,
                        param_attr=ParamAttr(name="dec_out_w"))
        rnn.step_output(out)
    return rnn()                                        # [B, Tt, V]


def build(dict_size=10000, emb_dim=256, hidden_dim=256):
    """Teacher-forced training graph. Feeds: src_word [B,Ts,1] (lod),
    trg_word [B,Tt,1], lbl_word [B,Tt,1]."""
    src = layers.data(name="src_word", shape=[1], dtype="int64", lod_level=1)
    trg = layers.data(name="trg_word", shape=[-1, -1, 1], dtype="int64",
                      append_batch_size=False)
    lbl = layers.data(name="lbl_word", shape=[-1, -1, 1], dtype="int64",
                      append_batch_size=False)
    enc_out = encoder(src, dict_size, emb_dim, hidden_dim)
    logits = train_decoder(enc_out, trg, dict_size, emb_dim, hidden_dim)
    loss = layers.softmax_with_cross_entropy(
        logits=logits, label=layers.squeeze(lbl, axes=[2]))
    avg_loss = layers.mean(loss)
    return ({"src_word": src, "trg_word": trg, "lbl_word": lbl},
            {"loss": avg_loss, "logits": logits})


def build_infer(dict_size=10000, emb_dim=256, hidden_dim=256, beam_size=4,
                max_len=16, start_id=0, end_id=1):
    """Beam-search decode graph. Feed src_word; fetch translation ids+scores."""
    src = layers.data(name="src_word", shape=[1], dtype="int64", lod_level=1)
    enc_out = encoder(src, dict_size, emb_dim, hidden_dim)   # [B, Ts, H]

    # tile encoder states across beams: [B, Ts, H] -> [B*K, Ts, H]
    enc_tiled = tile_beam(enc_out, beam_size)

    ids0 = layers.fill_constant_batch_size_like(enc_out, [-1, beam_size],
                                                "int32", float(start_id))
    fin0 = layers.cast(layers.fill_constant_batch_size_like(
        enc_out, [-1, beam_size], "int32", 0.0), "bool")
    # only beam 0 live at step 0 so beams don't start as duplicates
    mask0 = layers.fill_constant_batch_size_like(enc_out, [-1, beam_size],
                                                 "float32", 0.0)
    import numpy as np
    first_active = layers.assign(
        np.array([0.0] + [-1e9] * (beam_size - 1), np.float32))
    scores0 = layers.elementwise_add(mask0, first_active, axis=-1)
    h0 = tile_beam(layers.fill_constant_batch_size_like(
        enc_out, [-1, hidden_dim], "float32", 0.0), beam_size)

    rnn = layers.StaticRNN(name="beam_rnn", num_steps=max_len)
    with rnn.step():
        ids = rnn.memory(init=ids0)          # [B, K] int32
        scores = rnn.memory(init=scores0)    # [B, K]
        fin = rnn.memory(init=fin0)          # [B, K] bool
        h = rnn.memory(init=h0)              # [B*K, H]

        flat_ids = layers.reshape(ids, shape=[-1, 1])
        emb_t = layers.embedding(layers.cast(flat_ids, "int64"),
                                 size=[dict_size, emb_dim],
                                 param_attr=ParamAttr(name="trg_emb"))
        emb_t = layers.squeeze(emb_t, axes=[1]) if len(emb_t.shape) == 3 \
            else emb_t
        ctx = _attention(h, enc_tiled)
        gate_in = layers.fc(input=layers.concat([emb_t, ctx], axis=1),
                            size=hidden_dim * 3, bias_attr=False,
                            param_attr=ParamAttr(name="dec_gate_proj"))
        nh, _, _ = layers.gru_unit(gate_in, h, hidden_dim * 3,
                                   param_attr=ParamAttr(name="dec_gru_w"))
        logits = layers.fc(input=nh, size=dict_size, act=None,
                           param_attr=ParamAttr(name="dec_out_w"))
        logp = _log_softmax(logits)
        logp3 = layers.reshape(logp, shape=[-1, beam_size, dict_size])
        new_ids, parents, new_scores, new_fin = beam_search_step(
            logp3, scores, fin, beam_size=beam_size, end_id=end_id)
        # reorder decoder state by parent beam
        h3 = layers.reshape(nh, shape=[-1, beam_size, hidden_dim])
        h_sel = batch_gather(h3, parents)
        rnn.update_memory(ids, new_ids)
        rnn.update_memory(scores, new_scores)
        rnn.update_memory(fin, new_fin)
        rnn.update_memory(h, layers.reshape(h_sel, shape=[-1, hidden_dim]))
        rnn.step_output(new_ids)
        rnn.step_output(parents)
        rnn.step_output(new_scores)

    ids_hist, parents_hist, scores_hist = rnn()   # each [B, T, K]
    final_scores = layers.squeeze(
        layers.slice(scores_hist, axes=[1], starts=[max_len - 1],
                     ends=[max_len]), axes=[1])
    seq_ids, seq_scores = beam_backtrack(ids_hist, parents_hist, final_scores)
    return {"src_word": src}, {"ids": seq_ids, "scores": seq_scores}


# -- thin op wrappers --------------------------------------------------------

def _log_softmax(x):
    helper = LayerHelper("log_softmax")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("log_softmax", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": -1})
    return out


def beam_search_step(logprobs, acc_scores, finished, beam_size, end_id=1):
    helper = LayerHelper("beam_search_step")
    ids = helper.create_variable_for_type_inference(dtype="int32")
    parents = helper.create_variable_for_type_inference(dtype="int32")
    scores = helper.create_variable_for_type_inference(dtype="float32")
    fin = helper.create_variable_for_type_inference(dtype="bool")
    helper.append_op("beam_search_step",
                     inputs={"LogProbs": [logprobs.name],
                             "AccScores": [acc_scores.name],
                             "Finished": [finished.name]},
                     outputs={"Ids": [ids.name], "Parents": [parents.name],
                              "AccScoresOut": [scores.name],
                              "FinishedOut": [fin.name]},
                     attrs={"beam_size": beam_size, "end_id": end_id})
    return ids, parents, scores, fin


def beam_backtrack(ids_hist, parents_hist, final_scores):
    helper = LayerHelper("beam_backtrack")
    seq = helper.create_variable_for_type_inference(dtype="int32")
    scores = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op("beam_backtrack",
                     inputs={"Ids": [ids_hist.name],
                             "Parents": [parents_hist.name],
                             "AccScores": [final_scores.name]},
                     outputs={"SentenceIds": [seq.name],
                              "SentenceScores": [scores.name]})
    return seq, scores


def tile_beam(x, beam_size):
    helper = LayerHelper("tile_beam")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("tile_beam", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"beam_size": beam_size})
    out.lod_level = x.lod_level
    return out


def batch_gather(x, index):
    helper = LayerHelper("batch_gather")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("batch_gather",
                     inputs={"X": [x.name], "Index": [index.name]},
                     outputs={"Out": [out.name]})
    return out
