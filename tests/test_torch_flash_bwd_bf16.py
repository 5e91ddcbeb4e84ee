"""The host side of the bf16 flash backward kernels (csrc/flash_bwd.cu on
`wgmma` + TMA, csrc/wgmma_bf16.cuh), on the CPU: `flash_delta`, which
`_flash_backward` computes in PyTorch before the two launches, against
the JAX package's delta and against its own upcast formula bit for bit;
the operand checks that a TMA tensor map relies on (16-byte alignment);
the build hash covering every header a source includes; and the card
tool refusing to run without a card. The kernels themselves run only on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 3b).
"""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(dtype, shape=(2, 3, 33, 64), seed=0):
    rng = np.random.RandomState(seed)
    o, do = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    return (torch.from_numpy(o).to(dtype), torch.from_numpy(do).to(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
def test_flash_delta_is_the_upcast_product_sum_and_leaves_its_inputs(dtype):
    """O enters the product in its own dtype (no float32 copy): the sum is
    still that of two upcast copies, bit for bit, in float32 at least,
    and neither input is written (for float32, `.to` returns dO itself)."""
    o, do = _pair(dtype)
    o0, do0 = o.clone(), do.clone()
    ct = torch.promote_types(dtype, torch.float32)
    got = fa.flash_delta(o, do)
    assert got.dtype == ct and got.shape == o.shape[:-1]
    assert torch.equal(got, (do.to(ct) * o.to(ct)).sum(-1))
    assert torch.equal(o, o0) and torch.equal(do, do0)


def test_flash_delta_matches_the_jax_packages_delta():
    """paddle_tpu/ops/pallas_attention.py computes delta as
    sum(f32(dO) * f32(O)) over D; from the same bf16 values the port's
    agrees to float32 summation order."""
    o, do = _pair(torch.bfloat16, seed=3)
    jo, jdo = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
               for t in (o, do))
    want = np.asarray(jnp.sum(jdo.astype(jnp.float32)
                              * jo.astype(jnp.float32), axis=-1))
    np.testing.assert_allclose(fa.flash_delta(o, do).numpy(), want,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("offset_elems,ok", [(1, False), (4, False),
                                             (8, True)])
def test_check_operand_wants_16_byte_aligned_views(offset_elems, ok):
    """A TMA tensor map needs a 16-byte-aligned base: a bf16 view 2 or 8
    bytes into its storage is refused, one 16 bytes in is taken."""
    n = 1 * 2 * 64 * 64
    buf = torch.zeros(n + 16, dtype=torch.bfloat16)
    view = buf[offset_elems:offset_elems + n].view(1, 2, 64, 64)
    assert view.is_contiguous()
    # the storage itself starts aligned, so the view's offset decides
    assert buf.data_ptr() % 16 == 0
    if ok:
        native.check_operand(view, "q", torch.bfloat16, view.device,
                             (1, 2, 64, 64))
    else:
        with pytest.raises(ValueError, match="16-byte aligned"):
            native.check_operand(view, "q", torch.bfloat16, view.device,
                                 (1, 2, 64, 64))


def test_build_hash_covers_every_header_a_source_includes():
    """An edit to a header (wgmma_bf16.cuh among them) must rebuild the
    library: every quoted #include of csrc/ is in native.HEADERS."""
    included = set()
    for name in native.SOURCES + native.HEADERS:
        with open(os.path.join(native.CSRC, name)) as f:
            included |= set(re.findall(r'#include "([^"]+)"', f.read()))
    assert "wgmma_bf16.cuh" in included
    assert included <= set(native.HEADERS)
    for name in native.HEADERS:
        assert os.path.isfile(os.path.join(native.CSRC, name))


def test_flash_bwd_bench_refuses_to_run_without_a_card():
    """tools/torch_flash_bwd_bench.py measures on a card only: here it
    exits 2 and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable,
                        os.path.join(REPO, "tools",
                                     "torch_flash_bwd_bench.py")],
                       capture_output=True, text=True, timeout=120, env=env)
    assert p.returncode == 2, p.stderr
    assert p.stdout == ""
