"""The host side of the bf16 flash forward on `wgmma` + TMA and of the
delta kernel (csrc/flash_fwd.cu, csrc/flash_delta.cu), on the CPU:
`flash_delta`'s dispatch (the plain version on the CPU, an empty result
on meta), its plain version against the upcast formula bit for bit and
against the JAX package's delta, `_flash_backward_reference` computing
its delta without the kernel wrapper (so that on a card the plain
backward never holds the kernels against themselves), and every kernel
source in the build. The kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3b).
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import native


def _pair(dtype, shape, seed=0):
    rng = np.random.RandomState(seed)
    o, do = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    return (torch.from_numpy(o).to(dtype), torch.from_numpy(do).to(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_delta_on_the_cpu_is_the_plain_version(dtype, D):
    """On the CPU the wrapper takes the plain version, bit for bit, and
    launches nothing."""
    o, do = _pair(dtype, (2, 3, 17, D), seed=D)
    native.reset_launches()
    got = fa.flash_delta(o, do)
    assert not any(native.launches.values())
    assert got.dtype == torch.float32 and got.shape == (2, 3, 17)
    assert torch.equal(got, fa._flash_delta_reference(o, do))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_delta_on_meta_is_an_empty_float32_row_vector(dtype):
    o = torch.empty(4, 8, 256, 64, dtype=dtype, device="meta")
    got = fa.flash_delta(o, o)
    assert got.device.type == "meta"
    assert got.dtype == torch.float32 and got.shape == (4, 8, 256)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("T", [1, 17, 256])
def test_flash_delta_reference_is_the_upcast_product_sum(dtype, T):
    """The plain version keeps today's formula: the product of two upcast
    copies summed over D, bit for bit, in float32 at least."""
    o, do = _pair(dtype, (2, 2, T, 64), seed=T)
    ct = torch.promote_types(dtype, torch.float32)
    got = fa._flash_delta_reference(o, do)
    assert got.dtype == ct
    assert torch.equal(got, (do.to(ct) * o.to(ct)).sum(-1))


@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_delta_reference_matches_the_jax_packages_delta(D):
    """paddle_tpu/ops/pallas_attention.py:387 computes delta as
    sum(f32(dO) * f32(O)) over D; from the same bf16 values the plain
    version agrees to float32 summation order."""
    o, do = _pair(torch.bfloat16, (2, 3, 33, D), seed=D + 3)
    jo, jdo = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
               for t in (o, do))
    want = np.asarray(jnp.sum(jdo.astype(jnp.float32)
                              * jo.astype(jnp.float32), axis=-1))
    np.testing.assert_allclose(fa._flash_delta_reference(o, do).numpy(),
                               want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_backward_reference_never_calls_the_delta_wrapper(
        monkeypatch, dtype, rate):
    """The plain backward computes delta with the plain version: with
    `flash_delta` made to raise it still runs, and gives what it gave
    before."""
    rng = np.random.RandomState(7)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 2, 40, 32).astype(
        np.float32)).to(dtype) for _ in range(4))
    sm = 32 ** -0.5
    o = fa._attention_reference(q, k, v, True, sm, rate, 3)
    lse = fa._lse_reference(q, k, True, sm)
    want = fa._flash_backward_reference(q, k, v, o, lse, do, True, sm,
                                        rate, 3)

    def refuse(*args, **kwargs):
        raise AssertionError("the plain backward called flash_delta")

    monkeypatch.setattr(fa, "flash_delta", refuse)
    got = fa._flash_backward_reference(q, k, v, o, lse, do, True, sm, rate,
                                       3)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert torch.equal(a, b)


def test_every_kernel_source_is_built():
    """A kernel file left out of native.SOURCES would never be compiled:
    every csrc/*.cu is listed, and every listed source exists."""
    on_disk = {os.path.basename(p)
               for p in glob.glob(os.path.join(native.CSRC, "*.cu"))}
    assert "flash_delta.cu" in on_disk
    assert on_disk == set(native.SOURCES)


def test_delta_counters_and_entries_are_declared():
    """The delta kernel counts its launches per dtype beside the flash
    kernels', and its two C entries are declared for ctypes."""
    assert {"flash_delta", "flash_delta_bf16"} <= set(native.launches)
    src = open(os.path.join(native.CSRC, "flash_delta.cu")).read()
    for entry in ("ptt_flash_delta_f32", "ptt_flash_delta_bf16"):
        assert f'extern "C" int {entry}(' in src
        assert f"lib.{entry}.argtypes" in open(native.__file__).read()
