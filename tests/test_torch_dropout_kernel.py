"""The flag-selected dropout kernel of paddle_tpu_torch, on the CPU.

`FLAGS_dropout_impl=pallas` sends every `dropout` op that passes the JAX
package's gate through ``ops/dropout_kernel.py``. On the host its wrapper
runs the kernel's plain version, which is what these tests hold: the mask
(a hash of the seed and the linear element index), the scaling, the
gradient, the gate against ``paddle_tpu/ops/pallas_dropout.py::supports``,
the flag's validation against ``paddle_tpu/flags.py``, and that `auto` and
`xla` leave the bits path as it was. The JAX package's kernel draws from
the TPU's generator, which no CPU can reproduce, so masks are compared by
their distribution; the CUDA kernel is held bit for bit against the plain
version on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from paddle_tpu import flags as jflags
from paddle_tpu.ops import pallas_dropout as jdk

import paddle_tpu_torch as ptt
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.core import backward as tbackward
from paddle_tpu_torch.ops import dropout_kernel as dk
from paddle_tpu_torch.ops import native
from paddle_tpu_torch.ops import nn as tnn


@pytest.fixture
def kernel_flag():
    tflags.set_flag("dropout_impl", "pallas")
    yield
    tflags.set_flag("dropout_impl", "auto")


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_kept_elements_are_scaled_and_the_rest_are_zero(rate):
    x = np.random.RandomState(0).randn(8, 256).astype(np.float32)
    out, mask = dk.dropout_reference(torch.from_numpy(x), 1234, rate)
    out, mask = out.numpy(), mask.numpy()
    assert set(np.unique(mask)) == {0.0, 1.0}
    inv = np.float32(1.0 / (1.0 - rate))
    np.testing.assert_array_equal(out[mask == 1], (x * inv)[mask == 1])
    np.testing.assert_array_equal(out[mask == 0], 0.0)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_share_is_one_minus_rate(rate):
    n = 1 << 18
    _, mask = dk.dropout_reference(torch.ones(n // 128, 128), 99, rate)
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(float(mask.mean()) - (1 - rate)) < 3 * sigma


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_share_matches_the_pallas_threshold(rate):
    """The JAX kernel keeps an element when its signed 32-bit word reaches
    ``-2**31 + rate * 2**32``; the port compares the same word unsigned:
    exactly as many of the 2**32 words survive."""
    jax_thresh = int(min(max(-2 ** 31 + rate * 2 ** 32, -2 ** 31),
                         2 ** 31 - 1))
    kept_signed = 2 ** 31 - jax_thresh
    kept_unsigned = 2 ** 32 - dk.keep_threshold(rate)
    assert kept_signed == kept_unsigned
    assert 0 <= dk.keep_threshold(rate) < 2 ** 32


def test_mask_depends_on_seed_and_linear_index_only():
    x = torch.ones(4, 256)
    _, a = dk.dropout_reference(x, 7, 0.3)
    _, b = dk.dropout_reference(x.reshape(2, 2, 256), 7, 0.3)
    _, c = dk.dropout_reference(x.reshape(8, 128), 7, 0.3)
    assert torch.equal(a.reshape(-1), b.reshape(-1))
    assert torch.equal(a.reshape(-1), c.reshape(-1))
    # a longer tensor starts with the same mask
    _, d = dk.dropout_reference(torch.ones(8, 256), 7, 0.3)
    assert torch.equal(d.reshape(-1)[:1024], a.reshape(-1))


def test_different_seeds_give_different_masks():
    x = torch.ones(4, 256)
    masks = [dk.dropout_reference(x, s, 0.5)[1] for s in (0, 1, 2, 1 << 31)]
    for i in range(len(masks)):
        for j in range(i + 1, len(masks)):
            agree = float((masks[i] == masks[j]).float().mean())
            assert 0.4 < agree < 0.6, (i, j, agree)


def test_keep_bits_past_the_32_bit_index_use_the_high_word():
    """Indices at and past 2**32 hash their high word into the key: the
    bits there differ from those at the same low word, and a range that
    straddles the boundary is the two halves joined."""
    lo = dk._keep_range(5, 0, 4096, 0.5, "cpu")
    hi = dk._keep_range(5, 1 << 32, (1 << 32) + 4096, 0.5, "cpu")
    assert 0.4 < float((lo == hi).float().mean()) < 0.6
    both = dk._keep_range(5, (1 << 32) - 64, (1 << 32) + 64, 0.5, "cpu")
    assert torch.equal(both[64:], hi[:64])
    assert torch.equal(both[:64],
                       dk._keep_range(5, (1 << 32) - 64, 1 << 32, 0.5, "cpu"))


def test_autograd_backward_reruns_the_mask_on_dy():
    x = torch.randn(4, 256, requires_grad=True)
    y = dk.dropout_kernel(x, 11, 0.1)
    dy = torch.randn(4, 256)
    y.backward(dy)
    out, mask = dk.dropout_reference(x.detach(), 11, 0.1)
    assert torch.equal(y.detach(), out)
    inv = np.float32(1.0 / 0.9)
    assert torch.equal(x.grad, torch.where(mask == 1, dy * float(inv),
                                           torch.zeros(())))


def test_wrapper_paths_without_a_card():
    native.reset_launches()
    x = torch.randn(2, 128)
    out, mask = dk.dropout_forward(x, 3, 0.5, want_mask=True)
    ref_out, ref_mask = dk.dropout_reference(x, 3, 0.5)
    assert torch.equal(out, ref_out) and torch.equal(mask, ref_mask)
    assert dk.dropout_forward(x, 3, 0.5)[1] is None
    m_out, m_mask = dk.dropout_forward(x.to("meta"), 3, 0.5, want_mask=True)
    assert m_out.device.type == m_mask.device.type == "meta"
    assert m_out.shape == m_mask.shape == x.shape
    assert not any(native.launches.values())


# ---------------------------------------------------------------------------
# the gate and the flag, against paddle_tpu
# ---------------------------------------------------------------------------

GATE_CASES = [((4, 256), 0.1), ((2, 2, 256), 0.5), ((32, 128), 0.9),
              ((4, 64), 0.1), ((4, 130), 0.1), ((128,), 0.3), ((), 0.3),
              ((0, 128), 0.3), ((4, 256), 0.0), ((4, 256), 1.0),
              ((4, 256), 1.5), ((128, 3), 0.1)]


@pytest.mark.parametrize("shape,rate", GATE_CASES)
def test_supports_matches_paddle_tpu(shape, rate):
    ref = jdk.supports(np.zeros(shape, np.float32), rate)
    assert dk.supports(torch.zeros(shape), rate) == ref
    assert dk.supports(torch.zeros(shape, device="meta"), rate) == ref


def test_flag_has_the_jax_packages_name_choices_and_default():
    assert tflags.get_flag("dropout_impl") == \
        jflags.get_flag("dropout_impl") == "auto"
    assert tflags._CHOICES["dropout_impl"] == jflags._CHOICES["dropout_impl"]
    for value in ("pallas", "XLA", "auto"):
        tflags.set_flag("dropout_impl", value)
        assert tflags.get_flag("dropout_impl") == value.lower()


@pytest.mark.parametrize("flags", [tflags, jflags], ids=["port", "jax"])
def test_flag_refuses_a_typo(flags):
    with pytest.raises(ValueError, match="must be one of"):
        flags.set_flag("dropout_impl", "palas")
    assert flags.get_flag("dropout_impl") == "auto"


def test_flag_reads_its_environment_variable(monkeypatch):
    monkeypatch.setenv("FLAGS_dropout_impl", "pallas")
    tflags._init()
    try:
        assert tflags.get_flag("dropout_impl") == "pallas"
        monkeypatch.setenv("FLAGS_dropout_impl", "palas")
        with pytest.raises(ValueError, match="must be one of"):
            tflags._init()
    finally:
        monkeypatch.delenv("FLAGS_dropout_impl")
        tflags._init()
    assert tflags.get_flag("dropout_impl") == "auto"


# ---------------------------------------------------------------------------
# through the Executor
# ---------------------------------------------------------------------------

def _dropout_program(p, width, impl="upscale_in_train"):
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        x = ptt.layers.data("x", shape=[8, width], dtype="float32",
                            stop_gradient=False)
        y = ptt.layers.dropout(x, dropout_prob=p,
                               dropout_implementation=impl)
        # a matmul after the dropout, so that dOut is not uniform
        w = ptt.layers.data("w", shape=[width, 4], dtype="float32",
                            append_batch_size=False)
        tbackward.append_backward(ptt.layers.mean(ptt.layers.matmul(y, w)))
    main.random_seed = 17
    mask = [o for o in main.global_block().ops
            if o.type == "dropout"][0].outputs["Mask"][0]
    return main, y, mask


def _run(main, y, mask, width, seed=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(4, 8, width).astype(np.float32)
    w = rng.randn(width, 4).astype(np.float32)
    out, m, gx = ptt.Executor(ptt.CPUPlace()).run(
        main, feed={"x": x, "w": w}, fetch_list=[y.name, mask, "x@GRAD"],
        scope=ptt.Scope())
    # dOut of the dropout op: d mean(y @ w) / dy
    d_out = np.broadcast_to(w.sum(axis=1) / np.float32(4 * 8 * 4),
                            x.shape).astype(np.float32)
    return x, d_out, out, m, gx


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_op_under_the_flag_runs_the_kernel_path(kernel_flag, p):
    main, y, mask = _dropout_program(p, 128)
    x, d_out, out, m, gx = _run(main, y, mask, 128)
    inv = np.float32(1.0 / (1.0 - p))
    # Out and Mask are the plain version's for the op's seed
    seed = tnn.seed32(ptt.core.lowering.op_seed(
        17, 0, [o.type for o in main.global_block().ops].index("dropout")))
    ref_out, ref_mask = dk.dropout_reference(torch.from_numpy(x), seed, p)
    np.testing.assert_array_equal(out, ref_out.numpy())
    np.testing.assert_array_equal(m, ref_mask.numpy())
    # dX == dOut * Mask / (1 - rate)
    np.testing.assert_allclose(gx, np.where(m > 0, d_out * inv, 0),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(gx[m == 0], 0.0)


def test_kernel_path_grad_does_not_read_mask(kernel_flag):
    """The grad op regenerates the mask from the forward op's seed: it
    gives the same dX when the forward's Mask output is gone."""
    main, y, mask = _dropout_program(0.3, 128)
    _, _, _, m, gx = _run(main, y, mask, 128)
    from paddle_tpu_torch.core import registry
    grad = registry.get_op_def("dropout").grad_lower
    op = [o for o in main.global_block().ops if o.type == "dropout"][0]
    idx = main.global_block().ops.index(op)
    ctx = registry.LoweringContext(
        dict(op.attrs), "cpu",
        seed=ptt.core.lowering.op_seed(17, 0, idx))
    ctx.fwd_outs = {}                       # no Mask to read
    g = torch.randn(4, 8, 128)
    dx = grad(ctx, {"X": [torch.zeros(4, 8, 128)]}, {"Out": [g]})["X"]
    np.testing.assert_array_equal(
        dx.numpy(), np.where(m > 0, g.numpy() * np.float32(1 / 0.7), 0))


def test_a_shape_that_fails_the_gate_takes_the_bits_path(kernel_flag):
    main, y, mask = _dropout_program(0.1, 32)        # 32 % 128 != 0
    x, _, out, m, _ = _run(main, y, mask, 32)
    seed = tnn.seed32(ptt.core.lowering.op_seed(
        17, 0, [o.type for o in main.global_block().ops].index("dropout")))
    ref_out, keep = tnn._bits_dropout(torch.from_numpy(x), seed, 0.1,
                                      1.0 / 0.9)
    np.testing.assert_array_equal(out, ref_out.numpy())
    np.testing.assert_array_equal(m, keep.float().numpy())


def test_downgrade_in_infer_takes_the_bits_path(kernel_flag):
    main, y, mask = _dropout_program(0.1, 128, impl="downgrade_in_infer")
    x, _, out, m, _ = _run(main, y, mask, 128)
    np.testing.assert_array_equal(out, np.where(m > 0, x, 0))
    # one byte decides on the bits path: keep share is a multiple of 1/256
    seed = tnn.seed32(ptt.core.lowering.op_seed(
        17, 0, [o.type for o in main.global_block().ops].index("dropout")))
    np.testing.assert_array_equal(
        m, tnn._keep_bits(seed, x.shape, 0.1, "cpu").float().numpy())


@pytest.mark.parametrize("value", ["auto", "xla"])
def test_auto_and_xla_give_the_bits_path_bit_for_bit(value):
    main, y, mask = _dropout_program(0.1, 128)
    tflags.set_flag("dropout_impl", value)
    try:
        x, d_out, out, m, gx = _run(main, y, mask, 128)
    finally:
        tflags.set_flag("dropout_impl", "auto")
    seed = tnn.seed32(ptt.core.lowering.op_seed(
        17, 0, [o.type for o in main.global_block().ops].index("dropout")))
    ref_out, keep = tnn._bits_dropout(torch.from_numpy(x), seed, 0.1,
                                      1.0 / 0.9)
    np.testing.assert_array_equal(out, ref_out.numpy())
    np.testing.assert_array_equal(m, keep.float().numpy())
    np.testing.assert_allclose(
        gx, np.where(m > 0, d_out * np.float32(1 / 0.9), 0), rtol=1e-6,
        atol=0)


def test_kernel_and_bits_paths_draw_different_masks(kernel_flag):
    main, y, mask = _dropout_program(0.5, 128)
    _, _, _, m_kernel, _ = _run(main, y, mask, 128)
    tflags.set_flag("dropout_impl", "auto")
    _, _, _, m_bits, _ = _run(main, y, mask, 128)
    assert 0.4 < float((m_kernel == m_bits).mean()) < 0.6


def test_is_test_and_rate_one_ignore_the_flag(kernel_flag):
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        x = ptt.layers.data("x", shape=[128], dtype="float32")
        y = ptt.layers.dropout(x, dropout_prob=0.3, is_test=True,
                               dropout_implementation="upscale_in_train")
        z = ptt.layers.dropout(x, dropout_prob=1.0,
                               dropout_implementation="upscale_in_train")
    xv = np.random.RandomState(1).randn(4, 128).astype(np.float32)
    a, b = ptt.Executor(ptt.CPUPlace()).run(
        main, feed={"x": xv}, fetch_list=[y.name, z.name], scope=ptt.Scope())
    np.testing.assert_array_equal(a, xv)
    np.testing.assert_array_equal(b, 0.0)


def test_transformer_sites_all_pass_the_gate_at_base_width():
    """Every dropout op of Transformer-base (d_model 512, d_inner 2048) has
    a minor dim that is a multiple of 128: under the flag all of them take
    the kernel."""
    from paddle_tpu_torch.models import transformer
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        transformer.build(src_vocab_size=64, trg_vocab_size=64, seq_len=8,
                          n_layer=1, n_head=8, d_model=512, d_inner=2048,
                          dropout_rate=0.1)
    block = main.global_block()
    sites = [op for op in block.ops if op.type == "dropout"]
    assert len(sites) >= 5
    for op in sites:
        shape = tuple(abs(d) for d in block.var(op.inputs["X"][0]).shape)
        assert dk.supports(torch.zeros(shape, device="meta"),
                           op.attrs["dropout_prob"]), shape


def test_training_under_the_flag_learns(kernel_flag):
    """A one-layer transformer at width 128 trains under the flag: every
    dropout site passes the gate, the loss falls."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models import transformer
    torch.set_num_threads(1)
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, fetches = transformer.build(
            src_vocab_size=32, trg_vocab_size=32, seq_len=8, n_layer=1,
            n_head=2, d_model=128, d_inner=128, dropout_rate=0.1)
        optimizer.Adam(learning_rate=3e-3).minimize(fetches["loss"])
    main.random_seed = startup.random_seed = 3
    exe, scope = ptt.Executor(ptt.CPUPlace()), ptt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    words = rng.randint(1, 32, size=(8, 8)).astype(np.int64)
    feed = {"src_word": words, "trg_word": words, "lbl_word": words}
    losses = [float(np.asarray(exe.run(
        main, feed=feed, fetch_list=[fetches["loss"]],
        scope=scope)[0]).reshape(-1)[0]) for _ in range(12)]
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.8 * losses[0], losses
