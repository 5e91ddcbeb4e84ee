"""Program transpilers (reference: python/paddle/fluid/transpiler/).

The three that need no parameter server. `DistributeTranspiler`,
`DistributeTranspilerConfig`, `RoundRobin` and `HashName` come with the
port's parameter-server plane (ROADMAP item 8)."""

from .memory_optimization_transpiler import memory_optimize, release_memory  # noqa: F401
from .inference_transpiler import InferenceTranspiler  # noqa: F401
from .float16_transpiler import Float16Transpiler  # noqa: F401
