"""Program transpilers (reference: python/paddle/fluid/transpiler/).

`DistributeTranspiler` plans every distribution mode; its default sync
runtime, "collective", runs through `ParallelExecutor`, and a pserver
Program it plans is served by `Executor.run` (``pserver/``), its
trainers driven by `pserver.AsyncPSTrainer` / `SyncPSTrainer`."""

from .memory_optimization_transpiler import memory_optimize, release_memory  # noqa: F401
from .inference_transpiler import InferenceTranspiler  # noqa: F401
from .float16_transpiler import Float16Transpiler  # noqa: F401
from .distribute_transpiler import DistributeTranspiler, DistributeTranspilerConfig  # noqa: F401
from .ps_dispatcher import RoundRobin, HashName  # noqa: F401
