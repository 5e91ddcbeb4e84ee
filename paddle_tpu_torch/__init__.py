"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference; this package rebuilds it
slice by slice in PyTorch for one NVIDIA H100, its TPU kernels rewritten
by hand in CUDA C++ for ``sm_90a`` (``csrc/``). It imports neither jax
nor anything of ``paddle_tpu``.

The slices so far: generative serving (the Program IR and its JSON
format, an eager executor, the shared model-dir format, and
``serve.InferenceServer.generate`` over ``models/tiny_lm.py`` with its
flash-attention prefill and paged-attention decode kernels), training
(``append_backward``'s grad ops, ``optimizer.Adam`` and
``models/transformer.py``, whose attentions run the flash forward, dQ and
dK/dV kernels, attention dropout inside them), training the vision
models (``models/resnet.py`` and ``models/mnist.py`` with
``optimizer.Momentum``: conv, pool and batch norm through torch's own
ops, cuDNN on the card), bf16 mixed precision (``Executor(amp=True)``),
and the rest of the non-recurrent zoo (``models/se_resnext.py``,
``models/vgg.py``, ``models/deepfm.py``, the unfused attention of
``models/transformer.py``) with Fluid's optimizers, learning-rate
schedules (``layers/learning_rate_scheduler.py``), gradient clips and
``optimizer.ModelAverage``, and variable-length sequences
(``layers.data(lod_level=...)`` fed a ``(padded, lengths)`` pair, the
sequence and recurrent ops of ``ops/sequence.py`` and ``ops/rnn.py``,
``models/stacked_dynamic_lstm.py``), control flow, one-shot serving, and
the data plane and the Trainer (``recordio/``, ``reader/``, `py_reader`
with ``Executor.run(feed=None)``, `AsyncFeeder`, whose copies run from
pinned host buffers on a side CUDA stream, ``trainer.py`` with the ark
checkpoints of ``ark/``, ``metrics.py``, ``evaluator.py``,
``profiler.py``, ``debugger.py``), and the Fluid book (``dataset/``'s
readers, ``layers.cos_sim``, ``layers.linear_chain_crf`` and
``layers.crf_decoding``), and the common op breadth and API surface (the
activation, elementwise, reduction, tensor, loss and vision ops of
``ops/``, ``layers.ops``, the streaming ``layers.auc``, every
initializer, ``io.save_params`` / ``load_params``, ``Operator``,
``enforce``, ``default_scope_funcs``, ``graphviz`` and
``net_drawer``), and the transpilers and the program analysis
(``transpiler.{InferenceTranspiler,Float16Transpiler}``,
``memory_optimize``, ``ir_pass``, ``analysis`` and the `validate` flag),
and the parallel plane (``distributed``, ``parallel.ParallelExecutor``
over dp / mp / sp meshes of torch.distributed ranks, ring attention,
the planner ``analysis.planner`` and ``layers.ParallelDo``).

    import paddle_tpu_torch as fluid
    srv = fluid.serve.InferenceServer()            # CUDAPlace(0)
    srv.add_model("lm", model_dir)
    srv.generate("lm", [1, 2, 3], max_new_tokens=32).tokens

    _, fetches = fluid.models.transformer.build()
    fluid.optimizer.Adam(learning_rate=1e-3).minimize(fetches["loss"])
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(fluid.default_startup_program())
    exe.run(feed=batch, fetch_list=[fetches["loss"]])

    _, fetches = fluid.models.resnet.build(data_format="NHWC")
    fluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(
        fetches["loss"])

    _, fetches = fluid.models.se_resnext.build(data_format="NHWC")
    lr = fluid.layers.piecewise_decay([30000, 60000], [0.1, 0.01, 0.001])
    fluid.optimizer.Momentum(
        learning_rate=lr, momentum=0.9,
        regularization=fluid.regularizer.L2Decay(1e-4)).minimize(
            fetches["loss"])

    trainer = fluid.Trainer(train_func, optimizer_func)   # CUDAPlace(0)
    trainer.train(num_epochs=2, reader=fluid.reader.batch(
        fluid.reader.creator.recordio("train.recordio"), 128),
        feed_order=["image", "label"],
        checkpoint=fluid.ark.CheckpointConfig("ckpt", step_interval=100))
"""

from __future__ import annotations

from . import ops  # noqa: F401  (registers the op rules)
from . import (clip, data_feeder, flags, initializer, io,  # noqa: F401
               layers, lod_tensor, models, nets, optimizer, regularizer,
               serve, unique_name)
from .data_feeder import DataFeeder  # noqa: F401
from .lod_tensor import (create_lod_tensor,  # noqa: F401
                         create_random_int_lodtensor)
from .core.executor import (CPUPlace, CUDAPlace, Executor, Place,  # noqa: F401
                            Scope, global_scope)
from .core.ir import (Parameter, Program, Variable,  # noqa: F401
                      default_main_program, default_startup_program,
                      program_guard)
from .param_attr import ParamAttr  # noqa: F401
from .core.executor import EOFException, fetch_var  # noqa: F401
from .core.executor import PreparedProgram, scope_guard  # noqa: F401
from .core.backward import append_backward, calc_gradient  # noqa: F401
from . import (backward, contrib, default_scope_funcs,  # noqa: F401
               enforce, graphviz, net_drawer, op)
from .enforce import EnforceNotMet  # noqa: F401
from .flags import get_flag, set_flag  # noqa: F401
from .op import Operator  # noqa: F401
from .param_attr import WeightNormParamAttr  # noqa: F401
from . import (annotations, ark, average, dataset, debugger,  # noqa: F401
               evaluator, metrics, profiler, reader, recordio,
               recordio_writer)
from .recordio_writer import (convert_reader_to_recordio_file,  # noqa: F401
                              convert_reader_to_recordio_files)
from .async_feeder import AsyncFeeder  # noqa: F401
from .trainer import (Trainer, Inferencer, CheckpointConfig,  # noqa: F401
                      BeginEpochEvent, EndEpochEvent, BeginStepEvent,
                      EndStepEvent, save_checkpoint, load_checkpoint)
from . import analysis, ir_pass, transpiler  # noqa: F401
from .analysis import ProgramVerificationError  # noqa: F401
from .transpiler import (InferenceTranspiler, memory_optimize,  # noqa: F401
                         release_memory)
from . import distributed, parallel  # noqa: F401
from .parallel import (BuildStrategy, ExecutionStrategy,  # noqa: F401
                       ParallelExecutor)


def is_compiled_with_cuda() -> bool:
    """Whether a CUDA card is present for this process (the port's
    meaning of the name: its kernels build at first use, so there is no
    build-time switch)."""
    import torch
    return torch.cuda.is_available()


def get_var(name, program=None):
    """Look up a Variable by name in a program's global block (reference
    framework.py get_var)."""
    program = program or default_main_program()
    v = program.global_block()._find_var_recursive(name)
    if v is None:
        raise ValueError(f"get_var: no variable named {name!r}")
    return v
