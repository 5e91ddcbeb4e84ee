"""Op rules of the slices. Importing this package registers them."""

from . import (beam, control, flash_attention, loss, math,  # noqa: F401
               nn, optimizer_ops, paged_attention, rnn, sequence, tensor,
               tensor_array)
