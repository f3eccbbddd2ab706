"""The bound that ``chip_smoke.py`` holds the bf16 flash forward (K1) to
against the f32 plain version, checked here on the CPU.

In bf16, K1 rounds each softmax weight p to bf16 before P V and rounds o
once; so does the bf16 plain version ``flash_forward_reference``. Against
the plain version run in f32 on the same values (bf16 -> f32 is exact),
``chip_smoke.flash_fwd_bf16_vs_f32`` allows |o - o32| <= u (1 + u) max|v|
+ u |o32| + 1e-5 with u = 2^-8 (its docstring derives it). Here the bf16
plain version, which rounds where K1 does, stays inside that bound over a
few seeds and shapes, including large values and a peaked softmax, and
comes within a few times of its edge (the bound is not vacuous).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from pytorch_distributed_tpu_torch.ops import flash_kernel as fk

CASES = [
    # seed, B, H, Hkv, T, D, causal, q scale, v scale
    (0, 2, 4, 4, 96, 64, True, 1.0, 1.0),
    (1, 1, 8, 2, 130, 64, True, 1.0, 8.0),
    (2, 1, 4, 1, 77, 128, False, 1.0, 1.0),
    (3, 2, 2, 2, 64, 64, False, 4.0, 1.0),
    (4, 1, 8, 8, 129, 128, True, 3.0, 0.25),
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_bf16_plain_forward_within_the_derived_bound(case):
    seed, b, h, hkv, t, d, causal, q_scale, v_scale = case
    rng = np.random.default_rng(seed)

    def bf16(shape, scale):
        x = rng.standard_normal(shape, dtype=np.float32) * scale
        return torch.from_numpy(x).to(torch.bfloat16)

    q = bf16((b, h, t, d), q_scale)
    k = bf16((b, hkv, t, d), 1.0)
    v = bf16((b, hkv, t, d), v_scale)
    o, _ = fk.flash_forward_reference(q, k, v, causal)
    o32, _ = fk.flash_forward_reference(q.float(), k.float(), v.float(),
                                        causal)
    tol = chip_smoke.flash_fwd_bf16_vs_f32(v)
    assert tol["rtol"] == 2.0**-8
    assert tol["atol"] == pytest.approx(2.0**-8 * (1 + 2.0**-8)
                                        * float(v.abs().max()) + 1e-5)
    torch.testing.assert_close(o.float(), o32, **tol)
    # Not vacuous: the largest difference reaches 14-32 % of its allowance
    # at these cases (the worst element: a rounding of p near a row's peak
    # together with o's own rounding).
    share = (o.float() - o32).abs() / (tol["atol"] + tol["rtol"] * o32.abs())
    assert float(share.max()) > 0.1
