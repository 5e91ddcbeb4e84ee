"""The layers DSL (the slice's subset: `data`, `matmul`, `relu`, `cast`)."""

from .io import data  # noqa: F401
from .nn import cast, matmul, relu  # noqa: F401
