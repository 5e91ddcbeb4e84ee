"""Op rules of the slices. Importing this package registers them."""

from . import (beam, control, flash_attention, loss,  # noqa: F401
               loss_extra, math, nn, optimizer_ops, paged_attention, rnn,
               sequence, tensor, tensor_array)
