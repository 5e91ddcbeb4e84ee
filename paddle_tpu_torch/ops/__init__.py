"""Op rules of the slices. Importing this package registers them."""

from . import (flash_attention, loss, math, nn, optimizer_ops,  # noqa: F401
               paged_attention, tensor)
