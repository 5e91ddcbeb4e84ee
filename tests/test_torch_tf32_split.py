"""Why the flash kernels take each fp32 product as three TF32 products
(3xTF32), pinned on the CPU.

``paddle_tpu_torch/csrc/flash_bwd_f32.cuh`` runs its seven products per tile
on the H100's tensor cores, which multiply TF32 (10 explicit mantissa
bits). One TF32 product per fp32 product (1xTF32) keeps about 3 decimal
digits: the scores S = Q K^T pass through exp(), so their error becomes a
relative error of W, and dQ, dK and dV miss the backward's tolerance
|kernel - plain| <= 1e-4 (1 + |plain|) (``BWD_TOL`` in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``). The kernel splits
each operand x into hi = tf32(x) and lo = tf32(x - hi) and takes a b as
lo_a hi_b + hi_a lo_b + hi_a hi_b, which keeps fp32 accuracy at three
times the tensor-core work: that is why it uses the split.

Here TF32 rounding is emulated in PyTorch as the kernel's
``cvt.rna.tf32.f32`` does it (round to nearest, ties away from zero, to 10
mantissa bits), and the backward's formulas are run with every product
done (a) as 1xTF32 and (b) as the kernel's split, each TF32 product summed
in fp32, the small terms first. (b) must meet the tolerance against the
port's fp32 plain version; (a) must miss it, and the test records by how
much. The same holds for the forward (``csrc/flash_fwd.cu``): its two
products, S = Q K^T (into exp()) and O = P V, against out and lse at the
forward's tolerance |kernel - plain| <= 1e-4 (1 + |plain|) (``TOL`` in
``chip_smoke.py``, atol = rtol = 1e-4 in ``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa

BWD_TOL = 1e-4
B, H, T, D = 2, 2, 128, 64
RATE, SEED = 0.1, 1234


def tf32(x):
    """Round float32 to TF32 as cvt.rna does: nearest, ties away from zero
    (add half an ulp of the 10-bit mantissa to the magnitude, then clear
    the 13 low bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_1xtf32(a, b):
    return tf32(a) @ tf32(b)


def mm_3xtf32(a, b):
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def backward(q, k, v, o, lse, do, causal, sm, mm):
    """`fa._flash_backward_reference`'s formulas with every product taken
    by `mm`."""
    kt = k.transpose(-1, -2)
    s = mm(q, kt) * sm
    if causal:
        s = s.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1),
                          fa.NEG_INF)
    w = torch.exp(s - lse[..., None])
    dp = mm(do, v.transpose(-1, -2))
    keep = fa._keep_like(w, RATE, SEED)
    zero = torch.zeros(())
    w_drop = torch.where(keep, w * fa._drop_scale(RATE), zero)
    dw = torch.where(keep, dp * fa._drop_scale(RATE), zero)
    delta = (do * o).sum(-1)
    ds = w * (dw - delta[..., None]) * sm
    return (mm(ds, k), mm(ds.transpose(-1, -2), q),
            mm(w_drop.transpose(-1, -2), do))


def tolerance_ratio(got, ref):
    """max |got - ref| / (BWD_TOL (1 + |ref|)) over dq, dk and dv: <= 1
    meets the tolerance."""
    return max(float(((a - b).abs() / (BWD_TOL * (1 + b.abs()))).max())
               for a, b in zip(got, ref))


def test_tf32_rounding_is_nearest_ties_away_to_10_bits():
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2, 3.0, 0.0], dtype=torch.float32)
    want = [one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0, 0.0]
    assert tf32(x).tolist() == want
    y = torch.from_numpy(np.random.RandomState(0).randn(1000).astype(
        np.float32))
    hi, lo = split(y)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    # hi + lo carries about 22 significant bits of y
    assert float(((hi + lo - y).abs() / y.abs()).max()) < 2.0 ** -21


@pytest.mark.parametrize("causal", [False, True])
def test_split_meets_the_backward_tolerance_where_one_tf32_product_misses(
        causal):
    rng = np.random.RandomState(7 + int(causal))
    q, k, v, do = (torch.from_numpy(rng.randn(B, H, T, D).astype(np.float32))
                   for _ in range(4))
    sm = D ** -0.5
    o = fa._attention_reference(q, k, v, causal, sm, RATE, SEED)
    lse = fa._lse_reference(q, k, causal, sm)
    ref = fa._flash_backward_reference(q, k, v, o, lse, do, causal, sm, RATE,
                                       SEED)
    three = tolerance_ratio(backward(q, k, v, o, lse, do, causal, sm,
                                     mm_3xtf32), ref)
    one = tolerance_ratio(backward(q, k, v, o, lse, do, causal, sm,
                                   mm_1xtf32), ref)
    print(f"causal={causal}: 3xTF32 uses {three:.3g} of the tolerance, "
          f"1xTF32 {one:.3g}")
    assert three <= 1.0
    assert one > 1.0
    # the split is far inside the tolerance, one product far outside it
    assert one > 20 * three


def forward(q, k, v, causal, sm, mm):
    """The forward kernel's function (`fa._attention_reference` and
    `fa._lse_reference`) with both products taken by `mm`: S's small terms
    summed apart from hi_q hi_k, as the kernel's own accumulator does; P
    dropped and scaled after its row sum, then split as the A operand of
    P V. Returns (out, lse)."""
    s = mm(q, k.transpose(-1, -2)) * sm
    if causal:
        s = s.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1),
                          fa.NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    keep = fa._keep_like(p, RATE, SEED)
    p_drop = torch.where(keep, p * fa._drop_scale(RATE), torch.zeros(()))
    return mm(p_drop, v) / l, (m + torch.log(l)).squeeze(-1)


@pytest.mark.parametrize("causal", [False, True])
def test_split_meets_the_forward_tolerance_where_one_tf32_product_misses(
        causal):
    rng = np.random.RandomState(17 + int(causal))
    q, k, v = (torch.from_numpy(rng.randn(B, H, T, D).astype(np.float32))
               for _ in range(3))
    sm = D ** -0.5
    ref = (fa._attention_reference(q, k, v, causal, sm, RATE, SEED),
           fa._lse_reference(q, k, causal, sm))
    three = tolerance_ratio(forward(q, k, v, causal, sm, mm_3xtf32), ref)
    one = tolerance_ratio(forward(q, k, v, causal, sm, mm_1xtf32), ref)
    print(f"forward causal={causal}: 3xTF32 uses {three:.3g} of the "
          f"tolerance, 1xTF32 {one:.3g}")
    assert three <= 1.0
    assert one > 1.0
    assert one > 20 * three
