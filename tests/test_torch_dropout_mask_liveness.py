"""The `dropout` op writes its `Mask` only when something reads it.

Under ``FLAGS_dropout_impl=pallas`` the op's grad reruns the dropout
kernel on `dOut` and reads no `Mask`, so in a training step nothing does.
The JAX package builds `Mask` as an expression that XLA drops when it is
unread (``paddle_tpu/ops/nn.py``); the port's executor computes, per
prepared program, the vars that an op input, a fetch or a persistable
write-back reads (``core/executor.py::_StepPlan.live``), and the op asks
``LoweringContext.wants("Mask")`` before it has the kernel write one.
These tests hold that on the CPU, where the wrapper runs the kernel's
plain version: which calls ask for a mask, that a fetched mask is still
the plain version's, that training is bit for bit the same with and
without the liveness set, that the bits path (`auto`) keeps its mask for
its grad, and that `run_block` without a set keeps every output.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import flags, optimizer
from paddle_tpu_torch.core import backward, lowering, registry
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.ops import dropout_kernel as dk
from paddle_tpu_torch.ops import nn as tnn


@pytest.fixture
def kernel_flag():
    flags.set_flag("dropout_impl", "pallas")
    yield
    flags.set_flag("dropout_impl", "auto")


@pytest.fixture
def calls(monkeypatch):
    """Every `dropout_forward` call's `want_mask`: True or False from the
    op's forward, None from its grad (which passes none). Building a
    program runs each rule on meta tensors (shape inference), with every
    output wanted: a test clears the list after it builds."""
    seen = []
    real = dk.dropout_forward

    def recording(x, seed, rate, **kw):
        seen.append(kw.get("want_mask"))
        return real(x, seed, rate, **kw)

    monkeypatch.setattr(dk, "dropout_forward", recording)
    return seen


def _transformer(seed=3):
    torch.set_num_threads(1)
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, fetches = transformer.build(
            src_vocab_size=32, trg_vocab_size=32, seq_len=8, n_layer=1,
            n_head=2, d_model=128, d_inner=128, dropout_rate=0.1)
        optimizer.Adam(learning_rate=3e-3).minimize(fetches["loss"])
    main.random_seed = startup.random_seed = seed
    block = main.global_block()
    gated = [op for op in block.ops if op.type == "dropout"]
    for op in gated:
        shape = tuple(abs(d) for d in block.var(op.inputs["X"][0]).shape)
        assert dk.supports(torch.zeros(shape, device="meta"),
                           op.attrs["dropout_prob"]), shape
    return main, startup, fetches["loss"], len(gated)


def _feed():
    words = np.random.RandomState(0).randint(1, 32, size=(4, 8)).astype(
        np.int64)
    return {"src_word": words, "trg_word": words, "lbl_word": words}


def _train(main, startup, loss, steps):
    """`steps` Adam steps from the startup state: (losses, parameters)."""
    exe, scope = ptt.Executor(ptt.CPUPlace()), ptt.Scope()
    exe.run(startup, scope=scope)
    losses = [np.asarray(exe.run(main, feed=_feed(), fetch_list=[loss],
                                 scope=scope)[0]) for _ in range(steps)]
    params = {p.name: scope.find_var(p.name).numpy().copy()
              for p in main.global_block().all_parameters()}
    return losses, params


def test_a_training_step_asks_no_gated_op_for_its_mask(kernel_flag, calls):
    main, startup, loss, n_gated = _transformer()
    assert n_gated >= 5
    calls.clear()
    _train(main, startup, loss, 1)
    forward = [w for w in calls if w is not None]
    assert forward == [False] * n_gated
    assert calls.count(None) == n_gated       # each grad reran the kernel


def _dropout_program(p=0.3):
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        x = ptt.layers.data("x", shape=[8, 128], dtype="float32",
                            stop_gradient=False)
        y = ptt.layers.dropout(x, dropout_prob=p,
                               dropout_implementation="upscale_in_train")
        w = ptt.layers.data("w", shape=[128, 4], dtype="float32",
                            append_batch_size=False)
        backward.append_backward(ptt.layers.mean(ptt.layers.matmul(y, w)))
    main.random_seed = 17
    ops = main.global_block().ops
    idx = [o.type for o in ops].index("dropout")
    return main, y, ops[idx].outputs["Mask"][0], idx


def _inputs():
    rng = np.random.RandomState(4)
    return (rng.randn(4, 8, 128).astype(np.float32),
            rng.randn(128, 4).astype(np.float32))


def test_a_fetched_mask_is_written_and_is_the_plain_versions(kernel_flag,
                                                             calls):
    main, y, mask, idx = _dropout_program()
    calls.clear()
    x, w = _inputs()
    out, m, gx = ptt.Executor(ptt.CPUPlace()).run(
        main, feed={"x": x, "w": w}, fetch_list=[y.name, mask, "x@GRAD"],
        scope=ptt.Scope())
    assert calls == [True, None]
    seed = tnn.seed32(lowering.op_seed(17, 0, idx))
    ref_out, ref_mask = dk.dropout_reference(torch.from_numpy(x), seed, 0.3)
    np.testing.assert_array_equal(m, ref_mask.numpy())
    np.testing.assert_array_equal(out, ref_out.numpy())
    # without the fetch the same step asks for no mask and gives the same
    # Out and dX
    calls.clear()
    out2, gx2 = ptt.Executor(ptt.CPUPlace()).run(
        main, feed={"x": x, "w": w}, fetch_list=[y.name, "x@GRAD"],
        scope=ptt.Scope())
    assert calls == [False, None]
    np.testing.assert_array_equal(out2, out)
    np.testing.assert_array_equal(gx2, gx)


def test_training_is_bit_equal_with_and_without_the_liveness_set(
        kernel_flag, monkeypatch):
    main, startup, loss, _ = _transformer()
    losses, params = _train(main, startup, loss, 2)
    monkeypatch.setattr(registry.LoweringContext, "wants",
                        lambda self, slot: True)
    losses_all, params_all = _train(main, startup, loss, 2)
    for a, b in zip(losses, losses_all):
        np.testing.assert_array_equal(a, b)
    assert params.keys() == params_all.keys()
    for name in params:
        np.testing.assert_array_equal(params[name], params_all[name],
                                      err_msg=name)


def test_the_bits_path_keeps_its_mask_for_its_grad(calls, monkeypatch):
    """`auto`: the forward hashes its bits and writes Mask, which no op
    input names; the grad reads it through `ctx.fwd_outs`."""
    opdef = registry.get_op_def("dropout")
    real, masks = opdef.grad_lower, []

    def grad(ctx, ins, out_grads):
        masks.append(ctx.fwd_outs["Mask"][0])
        return real(ctx, ins, out_grads)

    monkeypatch.setattr(opdef, "grad_lower", grad)
    main, startup, loss, n_dropout = _transformer()
    calls.clear()
    losses, _ = _train(main, startup, loss, 1)
    assert np.isfinite(losses[0]).all()
    assert calls == []                        # no kernel path
    assert len(masks) == n_dropout
    assert all(isinstance(m, torch.Tensor) for m in masks)


def test_run_block_without_a_set_keeps_every_output(kernel_flag, calls):
    main, y, mask, _ = _dropout_program()
    calls.clear()
    x, w = _inputs()
    env = {"x": torch.from_numpy(x), "w": torch.from_numpy(w)}
    with torch.no_grad():
        lowering.run_block(main, 0, env, "cpu", seed=17)
    assert calls == [True, None] and mask in env
    calls.clear()
    live = {n for op in main.global_block().ops for n in op.input_arg_names}
    env2 = {"x": torch.from_numpy(x), "w": torch.from_numpy(w)}
    with torch.no_grad():
        lowering.run_block(main, 0, env2, "cpu", seed=17, live=live)
    assert calls == [False, None] and mask not in env2
    torch.testing.assert_close(env2["x@GRAD"], env["x@GRAD"], rtol=0,
                               atol=0)
