"""Datasets (reference: python/paddle/dataset/ — mnist, cifar, imdb,
imikolov, movielens, conll05, sentiment, uci_housing, wmt14, wmt16, ...).

Each module exposes `train()`/`test()` reader factories like the reference.
Downloads go to ~/.cache/paddle_tpu_torch/dataset; in zero-egress environments
every dataset falls back to a deterministic synthetic surrogate with the
same sample schema, so pipelines and tests stay runnable.

A copy of ``paddle_tpu/dataset/__init__.py``."""

from . import common  # noqa: F401
from . import image  # noqa: F401
from . import mnist  # noqa: F401
from . import cifar  # noqa: F401
from . import uci_housing  # noqa: F401
from . import imdb  # noqa: F401
from . import wmt16  # noqa: F401
from . import imikolov  # noqa: F401
from . import movielens  # noqa: F401
from . import conll05  # noqa: F401
from . import sentiment  # noqa: F401
from . import wmt14  # noqa: F401
from . import voc2012  # noqa: F401
from . import flowers  # noqa: F401
from . import mq2007  # noqa: F401
