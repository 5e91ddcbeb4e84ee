"""DeepFM-style sparse CTR model (copy of ``paddle_tpu/models/deepfm.py``;
the reference's distributed lookup table workload,
doc/fluid/design/dist_train/distributed_lookup_table_design.md): shared
first- and second-order embedding tables over 26 sparse fields, the FM
terms by `reduce_sum` and `elementwise_mul` / `elementwise_sub`, a deep
tower on the concatenated embeddings and dense features, and
`sigmoid_cross_entropy_with_logits`. The tables are dense parameters:
a lookup is a gather, its grad a dense scatter-add."""

from __future__ import annotations

from .. import layers
from ..param_attr import ParamAttr


def build(num_fields=26, sparse_feature_dim=int(1e5), embedding_size=16,
          dense_dim=13, hidden_sizes=(400, 400, 400), distributed=False):
    """`distributed=True` marks the embedding tables is_distributed (the
    JAX package's parameter-server path); by default they carry the
    ('mp', None) row sharding. Both are kept in the Program and change
    nothing on one card."""
    dense_input = layers.data(name="dense_input", shape=[dense_dim],
                              dtype="float32")
    sparse_input = layers.data(name="sparse_input", shape=[num_fields],
                               dtype="int64")
    label = layers.data(name="label", shape=[1], dtype="int64")

    # shared sharded embedding table: first-order (w) + second-order (v)
    sharding = None if distributed else ("mp", None)
    emb_v = layers.embedding(
        sparse_input, size=[sparse_feature_dim, embedding_size],
        is_distributed=distributed,
        param_attr=ParamAttr(name="fm_v", sharding=sharding))  # [B,F,K]
    emb_w = layers.embedding(
        sparse_input, size=[sparse_feature_dim, 1],
        is_distributed=distributed,
        param_attr=ParamAttr(name="fm_w", sharding=sharding))  # [B,F,1]

    # FM first order
    first_order = layers.reduce_sum(emb_w, dim=[1, 2], keep_dim=False)
    first_order = layers.reshape(first_order, shape=[-1, 1])

    # FM second order: 0.5 * ((sum v)^2 - sum v^2)
    sum_v = layers.reduce_sum(emb_v, dim=[1])             # [B,K]
    sum_v_sq = layers.elementwise_mul(sum_v, sum_v)
    v_sq = layers.elementwise_mul(emb_v, emb_v)
    sq_sum = layers.reduce_sum(v_sq, dim=[1])             # [B,K]
    second_order = layers.scale(
        layers.elementwise_sub(sum_v_sq, sq_sum), scale=0.5)
    second_order = layers.reduce_sum(second_order, dim=[1], keep_dim=True)

    # deep part
    deep = layers.reshape(emb_v, shape=[-1, num_fields * embedding_size])
    deep = layers.concat([deep, dense_input], axis=1)
    for h in hidden_sizes:
        deep = layers.fc(input=deep, size=h, act="relu")
    deep_out = layers.fc(input=deep, size=1, act=None)

    logit = layers.elementwise_add(
        layers.elementwise_add(first_order, second_order), deep_out)
    loss = layers.sigmoid_cross_entropy_with_logits(
        logit, layers.cast(label, "float32"))
    avg_loss = layers.mean(loss)
    predict = layers.sigmoid(logit)
    return ({"dense_input": dense_input, "sparse_input": sparse_input,
             "label": label},
            {"loss": avg_loss, "predict": predict})
