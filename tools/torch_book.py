"""The nine chapters of the Fluid book (Fluid 0.14's
python/paddle/fluid/tests/book/): fit_a_line, recognize_digits,
image_classification, word2vec, understand_sentiment,
label_semantic_roles, machine_translation, recommender_system and
rnn_encoder_decoder.

Each chapter is built by one function that takes the framework module
(``paddle_tpu_torch``, or ``paddle_tpu`` where a CPU test holds the port
against it) and the widths, and builds the program into the current
default programs, its optimizer included. `CARD` holds the widths that
``chip_smoke.py`` phase 7j trains on the card, the book's own; `SMALL`
holds the sizes of the JAX package's book tests (tests/test_book.py),
which the CPU parity tests use. Vocabulary and label sizes are the
datasets' own. Each chapter reads its dataset module through
`reader(fluid, name)` and `feed(...)`: `fluid.reader.batch` over the
module's reader, then `fluid.DataFeeder`.

Nothing is downloaded: every reader yields the dataset modules'
deterministic synthetic samples.

    python3 tools/torch_book.py [--chapter NAME ...] [--steps 5] [--cpu]

trains each chapter at `CARD`'s widths on `CUDAPlace(0)` (the host with
--cpu) for a few steps, saves its inference model, loads it back and
runs one batch, and prints the losses.
"""

from __future__ import annotations

import numpy as np

CHAPTERS = ("fit_a_line", "recognize_digits", "image_classification",
            "word2vec", "understand_sentiment", "label_semantic_roles",
            "machine_translation", "recommender_system",
            "rnn_encoder_decoder")

# The book's widths, batches and optimizers.
CARD = {
    "fit_a_line": dict(batch=20, lr=0.001),
    "recognize_digits": dict(batch=64, lr=0.001, filters=(20, 50)),
    "image_classification": dict(batch=128, lr=0.001, depth=32),
    "word2vec": dict(batch=32, lr=0.001, emb=32, hidden=256),
    "understand_sentiment": dict(batch=128, lr=0.002, emb=32, filters=32),
    "label_semantic_roles": dict(batch=10, lr=0.01, depth=8, hidden=512,
                                 mark_dim=5, crf_lr=1e-3),
    "machine_translation": dict(batch=16, lr=0.001, dict_size=30000,
                                emb=16, hidden=32),
    "recommender_system": dict(batch=256, lr=0.2, emb=32, small_emb=16,
                               hidden=200),
    "rnn_encoder_decoder": dict(batch=10, lr=0.001, dict_size=30000,
                                emb=16, hidden=32),
}

# tests/test_book.py's sizes, with each chapter's own optimizer.
SMALL = {
    "fit_a_line": dict(batch=64, lr=0.001),
    "recognize_digits": dict(batch=16, lr=0.001, filters=(8, 8)),
    "image_classification": dict(batch=8, lr=0.001, depth=8),
    "word2vec": dict(batch=32, lr=0.001, emb=16, hidden=64),
    "understand_sentiment": dict(batch=16, lr=0.002, emb=16, filters=16),
    "label_semantic_roles": dict(batch=8, lr=0.01, depth=2, hidden=32,
                                 mark_dim=5, crf_lr=1e-3),
    "machine_translation": dict(batch=16, lr=0.001, dict_size=30, emb=16,
                                hidden=16),
    "recommender_system": dict(batch=64, lr=0.2, emb=16, small_emb=8,
                               hidden=32),
    "rnn_encoder_decoder": dict(batch=16, lr=0.001, dict_size=30, emb=16,
                                hidden=16),
}


class Chapter:
    """A built chapter: its feed vars in the reader's sample order, the
    loss, the inference feeds (names) and targets (vars), and how two
    inference runs must agree: "float" (within a relative tolerance),
    "top1" (the argmax of the last dim equal as well) or "equal" (the
    Viterbi paths)."""

    def __init__(self, name, feeds, loss, infer_feeds, targets, agree):
        self.name, self.feeds, self.loss = name, feeds, loss
        self.infer_feeds, self.targets = infer_feeds, targets
        self.agree = agree


def build(fluid, name, w):
    """Build chapter `name` at widths `w` with framework `fluid`."""
    return _BUILDERS[name](fluid, w)


def _fit_a_line(fluid, w):
    layers = fluid.layers
    x = layers.data(name="x", shape=[13], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    pred = layers.fc(input=x, size=1, act=None)
    loss = layers.mean(layers.square_error_cost(input=pred, label=y))
    fluid.optimizer.SGD(learning_rate=w["lr"]).minimize(loss)
    return Chapter("fit_a_line", [x, y], loss, ["x"], [pred], "float")


def _recognize_digits(fluid, w):
    layers = fluid.layers
    img = layers.data(name="img", shape=[1, 28, 28], dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    f1, f2 = w["filters"]
    pool1 = fluid.nets.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=f1, pool_size=2, pool_stride=2,
        act="relu")
    pool1 = layers.batch_norm(pool1)
    pool2 = fluid.nets.simple_img_conv_pool(
        input=pool1, filter_size=5, num_filters=f2, pool_size=2,
        pool_stride=2, act="relu")
    prediction = layers.fc(input=pool2, size=10, act="softmax")
    loss = layers.mean(layers.cross_entropy(input=prediction, label=label))
    layers.accuracy(input=prediction, label=label)
    fluid.optimizer.Adam(learning_rate=w["lr"]).minimize(loss)
    return Chapter("recognize_digits", [img, label], loss, ["img"],
                   [prediction], "top1")


def _image_classification(fluid, w):
    layers = fluid.layers
    img = layers.data(name="pixel", shape=[3, 32, 32], dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    predict = fluid.models.resnet.resnet_cifar10(img, class_dim=10,
                                                 depth=w["depth"])
    loss = layers.mean(layers.cross_entropy(input=predict, label=label))
    layers.accuracy(input=predict, label=label)
    fluid.optimizer.Adam(learning_rate=w["lr"]).minimize(loss)
    return Chapter("image_classification", [img, label], loss, ["pixel"],
                   [predict], "top1")


def _word2vec(fluid, w):
    layers = fluid.layers
    dict_size = len(fluid.dataset.imikolov.build_dict())
    names = ["firstw", "secondw", "thirdw", "forthw", "nextw"]
    words = [layers.data(name=n, shape=[1], dtype="int64") for n in names]
    embs = [layers.reshape(layers.embedding(
        input=x, size=[dict_size, w["emb"]], param_attr="shared_w"),
        shape=[-1, w["emb"]]) for x in words[:4]]
    hidden = layers.fc(input=layers.concat(input=embs, axis=1),
                       size=w["hidden"], act="sigmoid")
    predict = layers.fc(input=hidden, size=dict_size, act="softmax")
    loss = layers.mean(layers.cross_entropy(input=predict, label=words[4]))
    fluid.optimizer.SGD(learning_rate=w["lr"]).minimize(loss)
    return Chapter("word2vec", words, loss, names[:4], [predict], "float")


def _understand_sentiment(fluid, w):
    layers = fluid.layers
    dict_size = len(fluid.dataset.imdb.word_dict())
    data = layers.data(name="words", shape=[1], dtype="int64", lod_level=1)
    label = layers.data(name="label", shape=[1], dtype="int64")
    emb = layers.embedding(input=data, size=[dict_size, w["emb"]])
    conv_3 = fluid.nets.sequence_conv_pool(
        input=emb, num_filters=w["filters"], filter_size=3, act="tanh",
        pool_type="max")
    conv_4 = fluid.nets.sequence_conv_pool(
        input=emb, num_filters=w["filters"], filter_size=4, act="tanh",
        pool_type="max")
    prediction = layers.fc(input=[conv_3, conv_4], size=2, act="softmax")
    loss = layers.mean(layers.cross_entropy(input=prediction, label=label))
    layers.accuracy(input=prediction, label=label)
    fluid.optimizer.Adagrad(learning_rate=w["lr"]).minimize(loss)
    return Chapter("understand_sentiment", [data, label], loss, ["words"],
                   [prediction], "top1")


SRL_FEATURES = ["word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data",
                "ctx_p1_data", "ctx_p2_data", "verb_data", "mark_data"]


def _label_semantic_roles(fluid, w):
    """db_lstm: eight embedded features, `sums` of their fcs into a
    `dynamic_lstm`, then depth - 1 more, each fed the `sums` of two tanh
    fcs (of the last mix and the last LSTM), reversed every other layer;
    two fcs to the labels, `linear_chain_crf` on `crfw` and
    `crf_decoding` under it. The word embedding `emb` is
    `conll05.get_embedding()`'s, not trained (`init_values`)."""
    layers = fluid.layers
    word_dict, verb_dict, label_dict = fluid.dataset.conll05.get_dict()
    word_dim = fluid.dataset.conll05.EMB_DIM
    hidden, depth = w["hidden"], w["depth"]
    ins = [layers.data(name=n, shape=[1], dtype="int64", lod_level=1)
           for n in SRL_FEATURES]
    target = layers.data(name="target", shape=[1], dtype="int64",
                         lod_level=1)
    embs = [layers.embedding(
        input=x, size=[len(word_dict), word_dim],
        param_attr=fluid.ParamAttr(name="emb", trainable=False))
        for x in ins[:6]]
    embs.append(layers.embedding(input=ins[6],
                                 size=[len(verb_dict), word_dim],
                                 param_attr="vemb"))
    embs.append(layers.embedding(input=ins[7], size=[2, w["mark_dim"]]))
    hidden_0 = layers.sums(input=[
        layers.fc(input=e, size=hidden, act="tanh", num_flatten_dims=2)
        for e in embs])
    lstm_0, _ = layers.dynamic_lstm(
        input=hidden_0, size=hidden, candidate_activation="relu",
        gate_activation="sigmoid", cell_activation="sigmoid")
    mix, lstm = hidden_0, lstm_0
    for i in range(1, depth):
        mix = layers.sums(input=[
            layers.fc(input=mix, size=hidden, act="tanh",
                      num_flatten_dims=2),
            layers.fc(input=lstm, size=hidden, act="tanh",
                      num_flatten_dims=2)])
        lstm, _ = layers.dynamic_lstm(
            input=mix, size=hidden, candidate_activation="relu",
            gate_activation="sigmoid", cell_activation="sigmoid",
            is_reverse=(i % 2) == 1)
    feature_out = layers.sums(input=[
        layers.fc(input=mix, size=len(label_dict), act="tanh",
                  num_flatten_dims=2),
        layers.fc(input=lstm, size=len(label_dict), act="tanh",
                  num_flatten_dims=2)])
    crf_cost = layers.linear_chain_crf(
        input=feature_out, label=target,
        param_attr=fluid.ParamAttr(name="crfw", learning_rate=w["crf_lr"]))
    loss = layers.mean(crf_cost)
    fluid.optimizer.SGD(learning_rate=layers.exponential_decay(
        learning_rate=w["lr"], decay_steps=100000, decay_rate=0.5,
        staircase=True)).minimize(loss)
    crf_decode = layers.crf_decoding(
        input=feature_out, param_attr=fluid.ParamAttr(name="crfw"))
    return Chapter("label_semantic_roles", ins + [target], loss,
                   list(SRL_FEATURES), [crf_decode], "equal")


def _machine_translation(fluid, w):
    feeds, outs = fluid.models.machine_translation.build(
        dict_size=w["dict_size"], emb_dim=w["emb"], hidden_dim=w["hidden"])
    fluid.optimizer.Adam(learning_rate=w["lr"]).minimize(outs["loss"])
    prob = fluid.layers.softmax(outs["logits"])
    return Chapter("machine_translation",
                   [feeds["src_word"], feeds["trg_word"], feeds["lbl_word"]],
                   outs["loss"], ["src_word", "trg_word"], [prob], "float")


def _recommender_system(fluid, w):
    layers = fluid.layers
    ml = fluid.dataset.movielens
    emb, small, hidden = w["emb"], w["small_emb"], w["hidden"]

    def ids(name, lod=0):
        return layers.data(name=name, shape=[1], dtype="int64",
                           lod_level=lod)

    uid, gender, age, job = (ids("user_id"), ids("gender_id"),
                             ids("age_id"), ids("job_id"))
    mid, category, title = (ids("movie_id"), ids("category_id", 1),
                            ids("movie_title", 1))
    score = layers.data(name="score", shape=[1], dtype="float32")

    usr = layers.fc(input=layers.concat(input=[
        layers.fc(input=layers.embedding(
            input=uid, size=[ml.max_user_id() + 1, emb],
            param_attr="user_table"), size=emb),
        layers.fc(input=layers.embedding(
            input=gender, size=[2, small], param_attr="gender_table"),
            size=small),
        layers.fc(input=layers.embedding(
            input=age, size=[len(ml.age_table()), small],
            param_attr="age_table"), size=small),
        layers.fc(input=layers.embedding(
            input=job, size=[ml.max_job_id() + 1, small],
            param_attr="job_table"), size=small)], axis=1),
        size=hidden, act="tanh")
    mov = layers.fc(input=layers.concat(input=[
        layers.fc(input=layers.embedding(
            input=mid, size=[ml.max_movie_id() + 1, emb],
            param_attr="movie_table"), size=emb),
        layers.sequence_pool(input=layers.embedding(
            input=category, size=[ml.CATEGORIES, emb]), pool_type="sum"),
        fluid.nets.sequence_conv_pool(
            input=layers.embedding(input=title, size=[ml.TITLE_DICT, emb]),
            num_filters=emb, filter_size=3, act="tanh", pool_type="sum")],
        axis=1), size=hidden, act="tanh")
    scale_infer = layers.scale(x=layers.cos_sim(X=usr, Y=mov), scale=5.0)
    loss = layers.mean(layers.square_error_cost(input=scale_infer,
                                                label=score))
    fluid.optimizer.SGD(learning_rate=w["lr"]).minimize(loss)
    feeds = [uid, gender, age, job, mid, category, title, score]
    return Chapter("recommender_system", feeds, loss,
                   [v.name for v in feeds[:-1]], [scale_infer], "float")


def _rnn_encoder_decoder(fluid, w):
    """tests/test_book.py's: a GRU encoder's last state starts a
    StaticRNN decoder of one tanh fc a step."""
    layers = fluid.layers
    V, E, H = w["dict_size"], w["emb"], w["hidden"]
    src = layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
    trg = layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
    nxt = layers.data(name="nxt", shape=[1], dtype="int64", lod_level=1)
    src_emb = layers.embedding(src, size=[V, E])
    enc_proj = layers.fc(input=src_emb, size=3 * H, num_flatten_dims=2)
    enc = layers.dynamic_gru(enc_proj, size=H)
    enc_last = layers.sequence_pool(enc, pool_type="last")
    trg_emb = layers.embedding(trg, size=[V, E])
    rnn = layers.StaticRNN()
    with rnn.step():
        word = rnn.step_input(trg_emb)
        h = rnn.memory(init=enc_last)
        nh = layers.fc(input=layers.concat([word, h], axis=1), size=H,
                       act="tanh")
        rnn.update_memory(h, nh)
        rnn.step_output(nh)
    logits = layers.fc(input=rnn(), size=V, num_flatten_dims=2)
    loss = layers.mean(layers.softmax_with_cross_entropy(
        logits, nxt, ignore_index=0))
    fluid.optimizer.Adam(learning_rate=w["lr"]).minimize(loss)
    return Chapter("rnn_encoder_decoder", [src, trg, nxt], loss,
                   ["src", "trg"], [layers.softmax(logits)], "float")


_BUILDERS = {
    "fit_a_line": _fit_a_line,
    "recognize_digits": _recognize_digits,
    "image_classification": _image_classification,
    "word2vec": _word2vec,
    "understand_sentiment": _understand_sentiment,
    "label_semantic_roles": _label_semantic_roles,
    "machine_translation": _machine_translation,
    "recommender_system": _recommender_system,
    "rnn_encoder_decoder": _rnn_encoder_decoder,
}


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def _column(x):
    """A sequence of ids as an [n, 1] array. DataFeeder (both packages)
    cannot stack flat lists for a [1]-shaped lod var (ROADMAP Queue 3)."""
    return np.asarray(x, np.int64).reshape(-1, 1)


def _samples(name, sample):
    if name == "recognize_digits":
        return sample[0].reshape(1, 28, 28), sample[1]
    if name == "image_classification":
        return sample[0].reshape(3, 32, 32), sample[1]
    if name == "understand_sentiment":
        return _column(sample[0]), sample[1]
    if name == "label_semantic_roles":
        return tuple(_column(c) for c in sample)
    if name == "recommender_system":
        return sample[:5] + (_column(sample[5]), _column(sample[6]),
                             sample[7])
    if name in ("machine_translation", "rnn_encoder_decoder"):
        return tuple(_column(c) for c in sample)
    return sample


def reader(fluid, name, w):
    """The chapter's training reader over `fluid.dataset`, each sample in
    its feed order (the book's: conll05's free `test()` split trains
    label_semantic_roles)."""
    ds = fluid.dataset
    base = {
        "fit_a_line": lambda: ds.uci_housing.train(),
        "recognize_digits": lambda: ds.mnist.train(),
        "image_classification": lambda: ds.cifar.train10(),
        "word2vec": lambda: ds.imikolov.train(ds.imikolov.build_dict(), 5),
        "understand_sentiment": lambda: ds.imdb.train(ds.imdb.word_dict()),
        "label_semantic_roles": lambda: ds.conll05.test(),
        "machine_translation": lambda: ds.wmt14.train(w["dict_size"]),
        "recommender_system": lambda: ds.movielens.train(),
        "rnn_encoder_decoder": lambda: ds.wmt14.train(w["dict_size"]),
    }[name]()
    return fluid.reader.map_readers(lambda s: _samples(name, s), base)


def batches(fluid, name, w, n):
    """The first `n` batches of the chapter's reader through
    `fluid.reader.batch`, pass after pass, as the book's training loop
    reads them (uci_housing, imdb and conll05 hold fewer than 24
    batches a pass at the book's batches)."""
    out = []
    while len(out) < n:
        for rows in fluid.reader.batch(reader(fluid, name, w), w["batch"])():
            out.append(rows)
            if len(out) == n:
                break
    return out


def _padded(col):
    """Dense [B, T, 1] ids padded with 0 (machine_translation's target
    and label are not lod vars: `models/machine_translation.py`)."""
    T = max(len(c) for c in col)
    out = np.zeros((len(col), T, 1), np.int64)
    for b, c in enumerate(col):
        out[b, :len(c)] = c
    return out


def feeder(fluid, chapter, place, program):
    feeds = chapter.feeds
    if chapter.name == "machine_translation":
        feeds = feeds[:1]
    return fluid.DataFeeder(feed_list=feeds, place=place, program=program)


def feed(chapter, data_feeder, rows):
    """A batch of rows as a feed dict."""
    if chapter.name != "machine_translation":
        return data_feeder.feed(rows)
    out = data_feeder.feed([r[:1] for r in rows])
    out["trg_word"] = _padded([r[1] for r in rows])
    out["lbl_word"] = _padded([r[2] for r in rows])
    return out


def infer_feed(chapter, full_feed):
    return {n: full_feed[n] for n in chapter.infer_feeds}


def init_values(fluid, name):
    """Values set over the startup's: label_semantic_roles' word
    embedding `emb`, from `conll05.get_embedding()`."""
    if name != "label_semantic_roles":
        return {}
    return {"emb": np.load(fluid.dataset.conll05.get_embedding())}


# ---------------------------------------------------------------------------
# the command line: a few steps of each chapter on the card
# ---------------------------------------------------------------------------

def main(argv=None):
    import argparse
    import os
    import sys
    import tempfile
    import time
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import paddle_tpu_torch as fluid

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chapter", action="append", choices=CHAPTERS)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    place = fluid.CPUPlace() if args.cpu else fluid.CUDAPlace(0)
    for name in args.chapter or CHAPTERS:
        w = CARD[name]
        main_p, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main_p, startup), fluid.unique_name.guard():
            ch = build(fluid, name, w)
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe.run(startup, scope=scope)
        fluid.io.state_from_numpy(init_values(fluid, name), place, scope)
        df = feeder(fluid, ch, place, main_p)
        feeds = [feed(ch, df, rows)
                 for rows in batches(fluid, name, w, args.steps)]
        t0 = time.perf_counter()
        losses = [float(np.asarray(exe.run(
            main_p, feed=f, fetch_list=[ch.loss], scope=scope)[0])
            .reshape(-1)[0]) for f in feeds]
        sec = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as tmp:
            fluid.io.save_inference_model(tmp, ch.infer_feeds, ch.targets,
                                          exe, main_program=main_p,
                                          scope=scope)
            infer_scope = fluid.Scope()
            prog, names, fetches = fluid.io.load_inference_model(
                tmp, exe, scope=infer_scope)
            outs = exe.run(prog, feed=infer_feed(ch, feeds[0]),
                           fetch_list=fetches, scope=infer_scope)
        print(f"{name}: losses {[round(x, 4) for x in losses]} in "
              f"{sec:.2f} s; inference over {names}: "
              f"{[list(np.asarray(o).shape) for o in outs]}")


if __name__ == "__main__":
    main()
