"""Stacked LSTM text classifier over variable-length sequences (mirror of
``paddle_tpu/models/stacked_dynamic_lstm.py``; reference
benchmark/fluid/models/stacked_dynamic_lstm.py).

The reference runs its LSTMs over unpadded LoD batches; both packages run
them over a padded batch with per-row lengths (`words` is fed as a
`(ids [B, T, 1], lengths [B])` pair), the same numbers on each row's
valid prefix."""

from __future__ import annotations

from .. import layers


def build(dict_size=30000, emb_dim=512, hidden_dim=512, stacked_num=3,
          class_num=2):
    words = layers.data(name="words", shape=[1], dtype="int64", lod_level=1)
    label = layers.data(name="label", shape=[1], dtype="int64")
    emb = layers.embedding(input=words, size=[dict_size, emb_dim])

    inp = emb
    for _ in range(stacked_num):
        proj = layers.fc(input=inp, size=hidden_dim * 4, act=None,
                         num_flatten_dims=2)
        hidden, cell = layers.dynamic_lstm(input=proj, size=hidden_dim * 4)
        inp = hidden

    last = layers.sequence_pool(input=inp, pool_type="max")
    logit = layers.fc(input=last, size=class_num, act="softmax")
    loss = layers.cross_entropy(input=logit, label=label)
    avg_loss = layers.mean(loss)
    acc = layers.accuracy(input=logit, label=label)
    return {"words": words, "label": label}, {"loss": avg_loss, "acc": acc}
