"""Reader -> RecordIO conversion (reference:
python/paddle/fluid/recordio_writer.py — convert_reader_to_recordio_file
serialized each batch through a DataFeeder into a RecordIO record).

Record format: one pickled tuple of numpy arrays per sample, the layout
`layers.open_recordio_file` / `layers.open_files` scan back (they batch
records and feed the py_reader queue).

A copy of ``paddle_tpu/recordio_writer.py``."""

from __future__ import annotations

import pickle

import numpy as np

from . import recordio

__all__ = [
    "convert_reader_to_recordio_file", "convert_reader_to_recordio_files"
]


def convert_reader_to_recordio_file(filename, reader_creator, feeder=None,
                                    compressor=None, max_num_records=1000,
                                    feed_order=None):
    """Write every sample from `reader_creator()` into one RecordIO file;
    returns the record count (reference recordio_writer.py:24)."""
    kw = {}
    if compressor is not None:
        kw["compressor"] = compressor
    n = 0
    with recordio.Writer(filename, **kw) as w:
        for sample in reader_creator():
            arrays = tuple(np.asarray(f) for f in sample)
            w.write(pickle.dumps(arrays))
            n += 1
    return n


def convert_reader_to_recordio_files(filename, batch_per_file,
                                     reader_creator, feeder=None,
                                     compressor=None, max_num_records=1000,
                                     feed_order=None):
    """Shard the reader across `.part-N` files, `batch_per_file` records
    each (reference recordio_writer.py:46)."""
    lines = list(reader_creator())
    counts = []
    for i in range(0, len(lines), batch_per_file):
        part = f"{filename}-{i // batch_per_file:05d}"
        counts.append(convert_reader_to_recordio_file(
            part, lambda chunk=lines[i:i + batch_per_file]: iter(chunk),
            feeder, compressor))
    return counts
