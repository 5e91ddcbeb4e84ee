"""Reader creators (reference: python/paddle/reader/creator.py —
np_array, text_file, recordio). A copy of
``paddle_tpu/reader/creator.py``."""

from __future__ import annotations

import glob as _glob
import pickle

__all__ = ["np_array", "text_file", "recordio"]


def np_array(x):
    """Reader over a numpy array's outermost dimension (reference
    creator.py np_array)."""

    def reader():
        if x.ndim < 1:
            yield x
            return
        for e in x:
            yield e

    return reader


def text_file(path):
    """Reader yielding the file's lines without trailing newlines
    (reference creator.py text_file)."""

    def reader():
        with open(path, "r") as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def recordio(paths, buf_size=100):
    """Reader over RecordIO file(s): a list, a comma-separated string, or
    a glob pattern (reference creator.py recordio). Records are unpickled
    — the format recordio_writer.convert_reader_to_recordio_file emits."""
    from .. import recordio as rio

    if isinstance(paths, str):
        path_list = []
        for p in paths.split(","):
            path_list.extend(sorted(_glob.glob(p)) or [p])
    else:
        path_list = list(paths)

    def reader():
        for p in path_list:
            for rec in rio.reader(p)():
                yield pickle.loads(rec)

    return reader
