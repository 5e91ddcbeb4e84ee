"""CoNLL-2005 semantic-role-labeling readers (reference:
python/paddle/dataset/conll05.py). Each sample is nine aligned sequences:
(word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, predicate, mark, label) —
reference reader_creator :146-198.

Zero-egress environments get a synthetic corpus with the same structure:
sentences of random words, one predicate position per sentence, context
windows/marks derived exactly as the reference derives them (:155-183),
and B-V/I-A style labels.


A copy of ``paddle_tpu/dataset/conll05.py``: the same
samples, from the same seeds in the same order."""

from __future__ import annotations

import os

import numpy as np

from . import common

WORD_DICT_LEN = 500
LABEL_DICT_LEN = 12
PRED_DICT_LEN = 40
UNK_IDX = 0
EMB_DIM = 32


def get_dict():
    """(word_dict, verb_dict, label_dict) — reference :201."""
    word_dict = {f"w{i}": i for i in range(WORD_DICT_LEN)}
    verb_dict = {f"v{i}": i for i in range(PRED_DICT_LEN)}
    label_dict = {f"L{i}": i for i in range(LABEL_DICT_LEN)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    """Path to a pretrained-embedding array (reference :214 returns the
    downloaded file); synthetic fallback writes a deterministic npy."""
    path = os.path.join(common.DATA_HOME, "conll05st", "emb.npy")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if not os.path.exists(path):
        rng = np.random.RandomState(0)
        np.save(path, rng.uniform(-1, 1, (WORD_DICT_LEN, EMB_DIM))
                .astype(np.float32))
    return path


def _synthetic_reader(n_samples, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n_samples):
            sen_len = int(rng.randint(4, 12))
            words = rng.randint(1, WORD_DICT_LEN, size=sen_len)
            verb_index = int(rng.randint(0, sen_len))
            pred = int(rng.randint(0, PRED_DICT_LEN))
            labels = rng.randint(1, LABEL_DICT_LEN, size=sen_len)

            mark = [0] * sen_len
            mark[verb_index] = 1
            ctx_n1 = int(words[verb_index - 1]) if verb_index > 0 else UNK_IDX
            if verb_index > 0:
                mark[verb_index - 1] = 1
            ctx_n2 = int(words[verb_index - 2]) if verb_index > 1 else UNK_IDX
            if verb_index > 1:
                mark[verb_index - 2] = 1
            ctx_0 = int(words[verb_index])
            ctx_p1 = (int(words[verb_index + 1])
                      if verb_index < sen_len - 1 else UNK_IDX)
            if verb_index < sen_len - 1:
                mark[verb_index + 1] = 1
            ctx_p2 = (int(words[verb_index + 2])
                      if verb_index < sen_len - 2 else UNK_IDX)
            if verb_index < sen_len - 2:
                mark[verb_index + 2] = 1

            yield (list(words), [ctx_n2] * sen_len, [ctx_n1] * sen_len,
                   [ctx_0] * sen_len, [ctx_p1] * sen_len, [ctx_p2] * sen_len,
                   [pred] * sen_len, mark, list(labels))

    return reader


def test():
    """Reference :221 (the free split; used for training in the book)."""
    return _synthetic_reader(200, seed=1)


def train():
    return _synthetic_reader(800, seed=0)
