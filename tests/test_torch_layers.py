"""The port's layer primitives against the JAX package's, in float32.

Same seeded numpy inputs through ``pytorch_distributed_tpu.ops.layers``
and ``pytorch_distributed_tpu_torch.ops.layers``; only the summation order
of the two CPU backends differs, so rtol = atol = 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops import layers as jl
from pytorch_distributed_tpu_torch.ops import layers as tl

TOL = dict(rtol=1e-6, atol=1e-6)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("out_shape", [(48,), (3, 4, 8)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_dense_matches_jax(out_shape, with_bias):
    rng = np.random.default_rng(0)
    x = _rand(rng, (2, 5, 32))
    params = {"kernel": _rand(rng, (32, *out_shape), 0.1)}
    if with_bias:
        params["bias"] = _rand(rng, out_shape, 0.1)
    want = jl.dense(jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()})
    got = tl.dense(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in params.items()}
    )
    assert tuple(got.shape) == (2, 5, *out_shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
@pytest.mark.parametrize("width", [16, 64])
def test_layer_norm_matches_jax(eps, width):
    rng = np.random.default_rng(1)
    x = _rand(rng, (3, 7, width), 2.0) + 0.5
    params = {"scale": _rand(rng, (width,)) + 1.0, "bias": _rand(rng, (width,))}
    want = jl.layer_norm(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()}, eps=eps
    )
    got = tl.layer_norm(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in params.items()},
        eps=eps,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_layer_norm_keeps_bf16_dtype_with_f32_statistics():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_rand(rng, (4, 32), 3.0)).to(torch.bfloat16)
    params = {"scale": torch.ones(32), "bias": torch.zeros(32)}
    y = tl.layer_norm(x, params, eps=1e-5)
    assert y.dtype == torch.bfloat16
    ref = torch.nn.functional.layer_norm(x.float(), (32,), eps=1e-5)
    torch.testing.assert_close(y, ref.to(torch.bfloat16))


@pytest.mark.parametrize("name", ["gelu_new", "gelu", "relu", "silu"])
def test_activation_matches_jax(name):
    rng = np.random.default_rng(3)
    x = _rand(rng, (8, 64), 3.0)
    want = jl.activation(name)(jnp.asarray(x))
    got = tl.activation(name)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unknown_activation_raises():
    with pytest.raises(KeyError, match="unknown activation"):
        tl.activation("swish2")
