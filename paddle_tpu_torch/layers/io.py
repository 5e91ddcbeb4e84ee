"""Input declaration (mirror of ``paddle_tpu/layers/io.py::data``)."""

from __future__ import annotations

from ..layer_helper import LayerHelper


def data(name, shape, dtype="float32", append_batch_size=True,
         stop_gradient=True):
    """Declare an input variable (reference io.py:35 `data`). With
    append_batch_size (default, as in the reference) a -1 batch dim is
    prepended. Variable-length (LoD) inputs are not ported yet."""
    helper = LayerHelper("data", name=name)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = helper.main_program.current_block()
    if name in block.vars:
        return block.vars[name]
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            stop_gradient=stop_gradient, is_data=True)
