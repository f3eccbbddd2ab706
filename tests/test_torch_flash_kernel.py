"""The port's flash attention (K1/K2 plain versions and the differentiable
``flash_mha``) against the JAX package's ``flash_mha`` in interpret mode.

Inputs are made with numpy from a seed and fed to both sides in f32 on the
CPU, with JAX matmuls at "highest" precision (this CPU backend truncates
f32 matmul operands by default). Targets: o and lse within atol = rtol =
1e-5, dq/dk/dv within atol 1e-4. Measured maxima at these cases (plain
versions vs JAX): o 3.6e-7, lse 4.8e-7, gradients 3.3e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops.attention import naive_attention as jnaive
from pytorch_distributed_tpu.ops.flash_kernel import flash_mha as jflash
from pytorch_distributed_tpu_torch.ops import flash_kernel as fk

CASES = [
    (1, 2, 2, 128, 64, True),
    (1, 4, 2, 256, 64, True),
    (1, 2, 2, 128, 128, False),
]


def _inputs(b, h, hkv, t, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, t, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, t, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, t, d), dtype=np.float32)
    do = rng.standard_normal((b, h, t, d), dtype=np.float32)
    return q, k, v, do


def _jax_fwd_bwd(q, k, v, do, causal):
    with jax.default_matmul_precision("highest"):
        o, lse = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal, None, 128, 128, True)

        def loss(q_, k_, v_):
            o_, _ = jflash(q_, k_, v_, causal, None, 128, 128, True)
            return jnp.sum(o_ * jnp.asarray(do))

        grads = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
        )
    return np.asarray(o), np.asarray(lse), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def jax_results():
    return {case: _jax_fwd_bwd(*_inputs(*case[:5]), case[5])
            for case in CASES}


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_versions_match_jax_kernels(case, jax_results):
    *shape, causal = case
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(*shape))
    o_ref, lse_ref, grads_ref = jax_results[case]
    o, lse = fk.flash_forward_reference(q, k, v, causal)
    np.testing.assert_allclose(o.numpy(), o_ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=1e-5, rtol=1e-5)
    grads = fk.flash_backward_reference(q, k, v, o, lse, do, causal)
    for name, g, want in zip(("dq", "dk", "dv"), grads, grads_ref):
        assert g.shape == want.shape, name
        np.testing.assert_allclose(g.numpy(), want, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_flash_mha_and_its_gradients_match_jax(case, jax_results):
    *shape, causal = case
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(*shape))
    o_ref, lse_ref, grads_ref = jax_results[case]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = dict(fk.plain_calls)
    o, lse = fk.flash_mha(*leaves, causal=causal)
    assert not lse.requires_grad and lse.dtype == torch.float32
    np.testing.assert_allclose(o.detach().numpy(), o_ref, atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=1e-5, rtol=1e-5)
    grads = torch.autograd.grad((o * do).sum(), leaves)
    for name, g, want in zip(("dq", "dk", "dv"), grads, grads_ref):
        np.testing.assert_allclose(g.numpy(), want, atol=1e-4, err_msg=name)
    assert fk.plain_calls["forward"] == before["forward"] + 1
    assert fk.plain_calls["backward"] == before["backward"] + 1
    assert fk.launches == {"forward": 0, "backward": 0}  # no card here


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_t_matches_jax_naive_attention(causal):
    """T = 100 is no multiple of the kernel's 64-row tiles. JAX's naive
    attention is the reference (its kernel needs tileable T); gradients
    are held to autograd through the port's forward plain version."""
    q, k, v, do = _inputs(2, 4, 2, 100, 64, seed=3)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jnaive(
            *(jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v)),
            causal=causal,
        )).transpose(0, 2, 1, 3)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    o, _ = fk.flash_mha(*leaves, causal=causal)
    np.testing.assert_allclose(o.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    got = torch.autograd.grad((o * tdo).sum(), leaves)
    ref_leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    o_ref, _ = fk.flash_forward_reference(*ref_leaves, causal)
    ref = torch.autograd.grad((o_ref * tdo).sum(), ref_leaves)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)


def test_strided_views_and_bf16_take_the_plain_version_on_cpu():
    """The training path passes q, k, v as views of the fused projection
    [B, T, 3, H, D]; bf16 rounds the softmax weights as the JAX kernel
    does."""
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal((2, 70, 3, 4, 64),
                                               dtype=np.float32))
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    o, lse = fk.flash_forward(q, k, v)
    o2, lse2 = fk.flash_forward_reference(*(x.contiguous() for x in (q, k, v)))
    torch.testing.assert_close(o, o2, rtol=0, atol=0)
    torch.testing.assert_close(lse, lse2, rtol=0, atol=0)
    ob, _ = fk.flash_forward(*(x.bfloat16() for x in (q, k, v)))
    assert ob.dtype == torch.bfloat16
    torch.testing.assert_close(ob.float(), o, atol=3e-2, rtol=3e-2)


def test_wrappers_refuse_bad_inputs():
    q = torch.zeros(1, 4, 8, 64)
    with pytest.raises(ValueError, match="T == S"):
        fk.flash_forward(q, q[:, :, :4], q[:, :, :4])
    with pytest.raises(ValueError, match="multiple of kv heads"):
        fk.flash_forward(q, q[:, :3], q[:, :3])
    with pytest.raises(ValueError, match="share a dtype"):
        fk.flash_forward(q, q.double(), q)
    with pytest.raises(ValueError, match="lse must be"):
        fk.flash_backward(q, q, q, q, torch.zeros(1, 4, 8).double(), q)
