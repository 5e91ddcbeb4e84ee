"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference; this package rebuilds it
slice by slice in PyTorch for one NVIDIA H100, its TPU kernels rewritten
by hand in CUDA C++ for ``sm_90a`` (``csrc/``). It imports neither jax
nor anything of ``paddle_tpu``.

This slice is generative serving: the Program IR and its JSON format,
the op rules a ``models/tiny_lm.py`` model runs, an eager executor, the
shared model-dir format, and ``serve.InferenceServer.generate`` with its
two kernels, flash-attention prefill and paged-attention decode.

    import paddle_tpu_torch as fluid
    srv = fluid.serve.InferenceServer()            # CUDAPlace(0)
    srv.add_model("lm", model_dir)
    srv.generate("lm", [1, 2, 3], max_new_tokens=32).tokens
"""

from __future__ import annotations

from . import ops  # noqa: F401  (registers the op rules)
from . import flags, initializer, io, layers, models, serve, unique_name  # noqa: F401
from .core.executor import (CPUPlace, CUDAPlace, Executor, Place,  # noqa: F401
                            Scope, global_scope)
from .core.ir import (Parameter, Program, Variable,  # noqa: F401
                      default_main_program, default_startup_program,
                      program_guard)
from .param_attr import ParamAttr  # noqa: F401
