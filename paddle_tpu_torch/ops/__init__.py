"""Op rules of the slice. Importing this package registers them."""

from . import math, paged_attention, tensor  # noqa: F401
