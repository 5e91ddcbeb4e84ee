"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference; this package rebuilds it
slice by slice in PyTorch for one NVIDIA H100, its TPU kernels rewritten
by hand in CUDA C++ for ``sm_90a`` (``csrc/``). It imports neither jax
nor anything of ``paddle_tpu``.

The slices so far: generative serving (the Program IR and its JSON
format, an eager executor, the shared model-dir format, and
``serve.InferenceServer.generate`` over ``models/tiny_lm.py`` with its
flash-attention prefill and paged-attention decode kernels), and training
(``append_backward``'s grad ops, ``optimizer.Adam`` and
``models/transformer.py``, whose attentions run the flash forward, dQ and
dK/dV kernels, attention dropout inside them).

    import paddle_tpu_torch as fluid
    srv = fluid.serve.InferenceServer()            # CUDAPlace(0)
    srv.add_model("lm", model_dir)
    srv.generate("lm", [1, 2, 3], max_new_tokens=32).tokens

    _, fetches = fluid.models.transformer.build()
    fluid.optimizer.Adam(learning_rate=1e-3).minimize(fetches["loss"])
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(fluid.default_startup_program())
    exe.run(feed=batch, fetch_list=[fetches["loss"]])
"""

from __future__ import annotations

from . import ops  # noqa: F401  (registers the op rules)
from . import (clip, flags, initializer, io, layers, models,  # noqa: F401
               optimizer, regularizer, serve, unique_name)
from .core.executor import (CPUPlace, CUDAPlace, Executor, Place,  # noqa: F401
                            Scope, global_scope)
from .core.ir import (Parameter, Program, Variable,  # noqa: F401
                      default_main_program, default_startup_program,
                      program_guard)
from .param_attr import ParamAttr  # noqa: F401
