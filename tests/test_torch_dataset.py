"""paddle_tpu_torch's `dataset/` against paddle_tpu's, on the CPU.

Every reader module of the port is a copy of the JAX package's, so each
yields the JAX module's samples element for element: the same
RandomState seeds, the same order of draws and the same dict sizes.
Nothing is downloaded: `can_download()` is false unless
PADDLE_TPU_ALLOW_DOWNLOAD=1, which no test sets, and every reader yields
its synthetic samples. The port's `DATA_HOME` is its own.
"""

import ast
import itertools
import os

import numpy as np
import pytest

import paddle_tpu.dataset as jds
import paddle_tpu_torch.dataset as tds

N = 64
MODULES = ["mnist", "cifar", "uci_housing", "imdb", "wmt16", "imikolov",
           "movielens", "conll05", "sentiment", "wmt14", "voc2012",
           "flowers", "mq2007"]


class D(str):
    """A reader argument that is the module's own dict builder, called in
    each package."""


# (module, reader factory, args): every train()/test() of every module;
# flowers yields 3 x 224 x 224 float images, so its readers are read only
# as far as test_new_dataset_schemas needs
READERS = [
    ("mnist", "train", ()), ("mnist", "test", ()),
    ("cifar", "train10", ()), ("cifar", "test10", ()),
    ("cifar", "train100", ()), ("cifar", "test100", ()),
    ("uci_housing", "train", ()), ("uci_housing", "test", ()),
    ("imdb", "train", ()), ("imdb", "test", ()),
    ("imdb", "train", (D("word_dict"),)),
    ("wmt16", "train", ()), ("wmt16", "test", ()),
    ("wmt16", "train", (1000, 500)),
    ("imikolov", "train", (D("build_dict"), 5)),
    ("imikolov", "test", (D("build_dict"), 3)),
    ("movielens", "train", ()), ("movielens", "test", ()),
    ("conll05", "train", ()), ("conll05", "test", ()),
    ("sentiment", "train", ()), ("sentiment", "test", ()),
    ("wmt14", "train", (30000,)), ("wmt14", "test", (30,)),
    ("wmt14", "gen", (30,)),
    ("voc2012", "train", ()), ("voc2012", "test", ()), ("voc2012", "val", ()),
    ("mq2007", "train", ("pairwise",)), ("mq2007", "test", ("pairwise",)),
    ("mq2007", "train", ("listwise",)), ("mq2007", "train", ("pointwise",)),
]


def _args(pkg, module, args):
    """Resolve a dict-builder name to its value in `pkg`'s module."""
    mod = getattr(pkg, module)
    return tuple(getattr(mod, a)() if isinstance(a, D) else a
                 for a in args)


def _take(pkg, module, factory, args, n=N):
    r = getattr(getattr(pkg, module), factory)(*_args(pkg, module, args))
    # sentiment's train()/test() are generators, as in the reference
    it = r() if callable(r) else r
    return list(itertools.islice(it, n))


def _assert_same(a, b, where):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize(
    "module,factory,args", READERS,
    ids=["-".join([f"{m}.{f}"] + [str(x) for x in a]) for m, f, a in READERS])
def test_reader_yields_the_jax_modules_samples(module, factory, args):
    ref = _take(jds, module, factory, args)
    got = _take(tds, module, factory, args)
    assert len(got) == len(ref) > 0
    for i, (r, g) in enumerate(zip(ref, got)):
        _assert_same(r, g, f"{module}.{factory} sample {i}")


def test_dicts_and_sizes_are_the_jax_modules():
    assert tds.imikolov.build_dict() == jds.imikolov.build_dict()
    assert len(tds.imikolov.build_dict()) == 2074
    assert tds.imdb.word_dict() == jds.imdb.word_dict()
    assert len(tds.imdb.word_dict()) == 5147
    assert tds.conll05.get_dict() == jds.conll05.get_dict()
    assert [len(d) for d in tds.conll05.get_dict()] == [500, 40, 12]
    assert tds.sentiment.get_word_dict() == jds.sentiment.get_word_dict()
    for rev in (False, True):
        assert tds.wmt14.get_dict(30, rev) == jds.wmt14.get_dict(30, rev)
        assert tds.wmt16.get_dict("de", 40, rev) == \
            jds.wmt16.get_dict("de", 40, rev)
    for f in ("max_user_id", "max_movie_id", "max_job_id", "age_table"):
        assert getattr(tds.movielens, f)() == getattr(jds.movielens, f)()
    assert tds.movielens.max_user_id() == 6040


def test_conll05_embedding_is_the_jax_packages_bytes_under_its_own_home():
    """get_embedding writes the same array under the port's DATA_HOME."""
    got, ref = tds.conll05.get_embedding(), jds.conll05.get_embedding()
    assert got.startswith(tds.common.DATA_HOME)
    assert not got.startswith(jds.common.DATA_HOME + os.sep)
    a, b = np.load(got), np.load(ref)
    assert a.shape == (500, 32) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_nothing_downloads_unless_allowed(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_ALLOW_DOWNLOAD", raising=False)
    assert not tds.common.can_download()
    monkeypatch.setenv("PADDLE_TPU_ALLOW_DOWNLOAD", "0")
    assert not tds.common.can_download()
    assert tds.common.DATA_HOME == os.path.expanduser(
        "~/.cache/paddle_tpu_torch/dataset")
    assert tds.common.DATA_HOME != jds.common.DATA_HOME


def test_mnist_falls_back_to_synthetic_digits_when_a_download_fails(
        monkeypatch):
    """Behind the gate, a failed download (RuntimeError) yields the
    synthetic digits, as in the JAX module; no network is touched."""
    monkeypatch.setenv("PADDLE_TPU_ALLOW_DOWNLOAD", "1")
    calls = []

    def refuse(url, module_name, md5sum, save_name=None):
        calls.append(url)
        raise RuntimeError("no egress")

    monkeypatch.setattr(tds.common, "download", refuse)
    got = list(itertools.islice(tds.mnist.train()(), 4))
    monkeypatch.delenv("PADDLE_TPU_ALLOW_DOWNLOAD")
    ref = list(itertools.islice(jds.mnist.train()(), 4))
    assert len(calls) == 1
    _assert_same(ref, got, "mnist fallback")


def test_image_helpers_are_the_jax_modules():
    rng = np.random.RandomState(3)
    im = rng.randint(0, 256, (40, 60, 3)).astype(np.uint8)
    for fn, args in (("resize_short", (24,)), ("to_chw", ()),
                     ("center_crop", (20,)), ("left_right_flip", ())):
        np.testing.assert_array_equal(getattr(tds.image, fn)(im, *args),
                                      getattr(jds.image, fn)(im, *args))
    outs = []
    for pkg in (jds, tds):
        np.random.seed(5)
        outs.append(pkg.image.simple_transform(im, 32, 24, True,
                                               mean=[1.0, 2.0, 3.0]))
    np.testing.assert_array_equal(*outs)
    assert tds.image.__all__ == jds.image.__all__


def test_new_dataset_schemas():
    """The counterpart of tests/test_book.py::test_new_dataset_schemas."""
    img, mask = next(tds.voc2012.train()())
    assert img.shape == (3, 32, 32) and mask.shape == (32, 32)
    img, label = next(tds.flowers.train()())
    assert img.shape == (3, 224, 224) and 0 <= label < 102
    ref_img, ref_label = next(jds.flowers.train()())
    assert label == ref_label
    np.testing.assert_array_equal(img, ref_img)
    lbl, left, right = next(tds.mq2007.train("pairwise")())
    assert left.shape == (46,) and lbl.shape == (1,)
    rel, feats = next(tds.mq2007.train("listwise")())
    assert feats.shape[1] == 46 and rel.shape == (feats.shape[0], 1)


def test_every_module_is_a_copy_with_the_jax_modules_names():
    """The port has all 13 reader modules, `image` and `common`, each
    with the JAX module's public names, and none imports the JAX
    package."""
    root = os.path.dirname(tds.__file__)
    assert sorted(f[:-3] for f in os.listdir(root) if f.endswith(".py")) \
        == sorted(MODULES + ["image", "common", "__init__"])
    for m in MODULES + ["image", "common"]:
        pub = {n for n in dir(getattr(jds, m)) if not n.startswith("_")}
        assert pub <= set(dir(getattr(tds, m))), m
        tree = ast.parse(open(os.path.join(root, m + ".py")).read())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = [a.name for a in node.names] + [
                    getattr(node, "module", None) or ""]
                assert not any(x.split(".")[0] in ("jax", "paddle_tpu")
                               for x in mods), (m, mods)
