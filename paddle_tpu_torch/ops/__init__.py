"""Op rules of the slices. Importing this package registers them."""

from . import (beam, control, detection, extra_nn,  # noqa: F401
               flash_attention, loss, loss_extra, math, nn, optimizer_ops,
               paged_attention, quantize, rnn, sequence, tensor,
               tensor_array)
