"""MQ2007 learning-to-rank readers (reference:
python/paddle/dataset/mq2007.py). Formats mirror the reference generators:
  pairwise (:186): yields (label[1], left_feature[46], right_feature[46])
                   where left ranks above right;
  listwise (:229): yields (relevance[n,1], features[n,46]) per query;
  pointwise (:167): yields (feature[46], relevance[1]).
Synthetic fallback: relevance is a noisy linear function of the features,
so ranking models have signal to learn.

A copy of ``paddle_tpu/dataset/mq2007.py``: the same
samples, from the same seeds in the same order."""

from __future__ import annotations

import numpy as np

FEATURE_DIM = 46


def _queries(n_queries, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(FEATURE_DIM)
    for _ in range(n_queries):
        n_docs = int(rng.randint(5, 15))
        feats = rng.randn(n_docs, FEATURE_DIM).astype(np.float32)
        score = feats @ w + 0.1 * rng.randn(n_docs)
        rel = np.digitize(score, np.percentile(score, [33, 66]))
        yield rel.astype(np.float32), feats


def __reader__(n_queries, seed, format="pairwise"):
    def pointwise():
        for rel, feats in _queries(n_queries, seed):
            for r, f in zip(rel, feats):
                yield f, np.array([r], np.float32)

    def pairwise():
        for rel, feats in _queries(n_queries, seed):
            n = len(rel)
            for i in range(n):
                for j in range(i + 1, n):
                    if rel[i] > rel[j]:
                        yield np.array([1.0], np.float32), feats[i], feats[j]
                    elif rel[i] < rel[j]:
                        yield np.array([1.0], np.float32), feats[j], feats[i]

    def listwise():
        for rel, feats in _queries(n_queries, seed):
            yield rel.reshape(-1, 1), feats

    return {"pointwise": pointwise, "pairwise": pairwise,
            "listwise": listwise}[format]


def train(format="pairwise"):
    return __reader__(40, seed=0, format=format)


def test(format="pairwise"):
    return __reader__(10, seed=1, format=format)
