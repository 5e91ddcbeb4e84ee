"""Input declaration (mirror of ``paddle_tpu/layers/io.py::data``)."""

from __future__ import annotations

from ..layer_helper import LayerHelper


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True):
    """Declare an input variable (reference io.py:35 `data`).

    With append_batch_size (default, as in the reference) a -1 batch dim
    is prepended. `lod_level` > 0 declares a variable-length sequence
    input, padded: one more -1 dim a level ([batch, time, *feature] at
    level 1, [batch, seqs, time, *feature] at level 2), with an int32
    length companion a level (`name@SEQLEN`, `name@SEQLEN.1`). Feed it a
    `(padded, lengths)` pair (`lod_tensor.create_lod_tensor` and
    `data_feeder.DataFeeder` build one).
    """
    helper = LayerHelper("data", name=name)
    shape = list(shape)
    if lod_level > 0:
        dyn = [-1] * lod_level
        shape = ([-1] + dyn + shape) if append_batch_size else (dyn + shape)
    elif append_batch_size:
        shape = [-1] + shape
    block = helper.main_program.current_block()
    if name in block.vars:
        v = block.vars[name]
    else:
        v = block.create_var(name=name, shape=shape, dtype=dtype,
                             lod_level=lod_level, stop_gradient=stop_gradient,
                             is_data=True)
    for lvl in range(lod_level):
        helper.ensure_seqlen_var(v, level=lvl)
    return v
