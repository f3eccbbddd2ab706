"""Two behaviours of the port that the JAX package shows too, on the CPU.

1. **int8 pages: the kernel and the gather path part in bf16.** A decode
   tick's single-token attention over int8 pages runs the int8 kernel,
   which dequantizes page blocks in f32 and keeps the softmax weights in
   f32 (JAX ``ops/paged_kernel._paged_kernel_q8``; the port's K4, whose
   arithmetic ``paged_kernel.paged_decode_attention_split_reference``
   restates). A speculative verify window (K+1 queries) runs the gather
   path, which dequantizes to the activation dtype and rounds the weights
   to it (JAX ``models/decode._cached_attention``; the port's
   ``gather_attention``). On the same int8 pages with bf16 queries, JAX's
   kernel (interpret mode) agrees with the port's f32-dequant arithmetic
   to one bf16 rounding, the two gather paths agree with each other to
   one, and in each package the kernel and the gather path differ by
   more than that — by the same order. So speculative and plain tokens of
   an int8 bf16 engine can part in both packages: the gap is the
   reference's, not the port's.
2. **The MoE router's dropped share.** Five training steps of a Llama MoE
   model (8 SwiGLU experts, top-2, capacity factor 1.25) on one fixed
   batch, through both packages from the same weights: the share of
   assignments dropped for capacity, measured on that batch before each
   step and after the last, is equal in the two packages at every step
   (the routes agree; here it moves from 4.9 % at init to 0.8 % after five
   steps): what share is dropped is the model's and its batch's, not
   ``ops/moe``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.config import TrainConfig as JaxTrainConfig
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu.models.decode import _cached_attention
from pytorch_distributed_tpu.ops import moe as jmoe
from pytorch_distributed_tpu.ops.paged_kernel import (
    paged_decode_attention as jax_paged,
)
from pytorch_distributed_tpu.ops.quant import quantize_kv as jax_quantize
from pytorch_distributed_tpu.train import optim as joptim
from pytorch_distributed_tpu.train.state import init_train_state as jinit
from pytorch_distributed_tpu.train.trainer import make_train_step as jstep
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig, TrainConfig
from pytorch_distributed_tpu_torch.models import get_model, llama
from pytorch_distributed_tpu_torch.ops import moe, paged_kernel
from pytorch_distributed_tpu_torch.train import optim
from pytorch_distributed_tpu_torch.train.state import init_train_state
from pytorch_distributed_tpu_torch.train.trainer import make_train_step

U = 2.0**-8  # bf16 unit roundoff


def _int8_case(h, hkv, seed, b=4, d=64, page=16, n_pages=8):
    """bf16 queries and int8 pages with their f32 scales, made by JAX's
    ``quantize_kv`` from unit normals; the rows at depths across the
    table."""
    rng = np.random.default_rng(seed)
    n_pool = b * n_pages + 1
    kq, ks = jax_quantize(jnp.asarray(
        rng.standard_normal((n_pool, page, hkv, d)), jnp.float32))
    vq, vs = jax_quantize(jnp.asarray(
        rng.standard_normal((n_pool, page, hkv, d)), jnp.float32))
    q = jnp.asarray(rng.standard_normal((b, h, d)), jnp.bfloat16)
    tables = np.arange(1, n_pool).reshape(b, n_pages).astype(np.int32)
    lengths = np.array([0, page - 1, 77, n_pages * page - 1], np.int32)
    return q, kq, ks, vq, vs, tables, lengths


def _torch(x, dtype=None):
    t = torch.from_numpy(np.array(x, np.float32 if dtype else None))
    return t.to(dtype) if dtype else t


@pytest.mark.parametrize("h, hkv", [(12, 12), (32, 8)],
                         ids=["gpt2-heads", "gqa-4"])
@pytest.mark.parametrize("seed", [0, 1])
def test_int8_kernel_and_gather_part_in_both_packages(h, hkv, seed):
    q, kq, ks, vq, vs, tables, lengths = _int8_case(h, hkv, seed)
    jk = np.asarray(jax_paged(q, kq, vq, tables, lengths, k_scales=ks,
                              v_scales=vs, interpret=True), np.float64)
    jg = np.asarray(_cached_attention(
        q[:, None], {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs},
        jnp.asarray(lengths), jnp.asarray(tables), "gather",
        "int8")[:, 0], np.float64)
    args = (_torch(q, torch.bfloat16), _torch(kq), _torch(vq),
            _torch(tables), _torch(lengths))
    scales = (_torch(ks), _torch(vs))
    pk = paged_kernel.paged_decode_attention_split_reference(
        *args, *scales).double().numpy()
    pg = paged_kernel.paged_decode_attention_reference(
        *args, *scales).double().numpy()
    vmax = float(np.abs(np.asarray(vq, np.float64)
                        * np.asarray(vs, np.float64)[..., None]).max())
    # Same arithmetic, across the packages: f32 summation order apart,
    # then each rounded once to bf16 — at most one bf16 ulp (2u of the
    # value) apart.
    ulp = 2 * U * np.maximum(np.abs(jk), np.abs(pk)) + 2.0**-20
    np.testing.assert_array_less(np.abs(pk - jk), ulp)
    # The two gather paths: bit-equal almost everywhere; where a sum
    # cancels, their bf16 products part by less than one bf16 rounding of
    # the values they average.
    assert (pg == jg).mean() > 0.99
    np.testing.assert_array_less(np.abs(pg - jg), U * vmax)
    # Kernel vs gather, inside each package: apart by more than an ulp,
    # and by the same order in both.
    gap_jax, gap_port = np.abs(jk - jg), np.abs(pk - pg)
    assert (gap_jax > ulp).any() and (gap_port > ulp).any()
    assert 0.5 < gap_port.max() / gap_jax.max() < 2.0
    assert 0.5 < (gap_port > 0).mean() / (gap_jax > 0).mean() < 2.0


MOE_KW = dict(family="llama", activation_function="silu", vocab_size=97,
              n_ctx=32, n_embd=32, n_layer=2, n_head=4, n_kv_head=2,
              n_inner=64, dtype="float32", embd_pdrop=0.0, attn_pdrop=0.0,
              resid_pdrop=0.0, n_experts=8, moe_top_k=2,
              expert_capacity_factor=1.25, moe_dispatch="sort")
TRAIN_KW = dict(learning_rate=3e-3, num_steps=5, grad_clip_norm=1.0,
                lr_schedule="cosine", warmup_steps=0)


def _jax_dropped(cfg, params, inputs) -> float:
    """JAX's share of dropped assignments over every layer of one forward
    (the block inputs recorded through ``ops/moe.moe_mlp``, positions and
    capacity from the package's own ``_route``/``_assignment_positions``/
    ``expert_capacity``)."""
    real, shares = jmoe.moe_mlp, []

    def recording(x, p, **kw):
        xt = x.reshape(-1, x.shape[-1])
        k, n_x = kw["top_k"], p["router"].shape[-1]
        idx = jmoe._route(xt, p["router"], k)[0]
        pos = jmoe._assignment_positions(idx.reshape(-1), n_x)[0]
        cap = jmoe.expert_capacity(xt.shape[0] * k, n_x,
                                   kw["capacity_factor"])
        # The blocks run under scan: the share leaves through a callback.
        jax.debug.callback(lambda v: shares.append(float(v)),
                           jnp.mean(pos >= cap))
        return real(x, p, **kw)

    jmoe.moe_mlp = recording
    try:
        jax.block_until_ready(
            jget_model(cfg).apply(params, jnp.asarray(inputs), cfg))
        jax.effects_barrier()
    finally:
        jmoe.moe_mlp = real
    return float(np.mean(shares))


def _port_dropped(cfg, params, inputs) -> float:
    real, shares = llama.moe_mlp, []

    def recording(x, p, **kw):
        shares.append(float(moe.dropped_share(
            x, p["router"], top_k=kw["top_k"],
            capacity_factor=kw["capacity_factor"])))
        return real(x, p, **kw)

    llama.moe_mlp = recording
    try:
        with torch.no_grad():
            get_model(cfg).apply(params, torch.from_numpy(inputs), cfg)
    finally:
        llama.moe_mlp = real
    return float(np.mean(shares))


def test_moe_dropped_share_is_the_models_in_both_packages():
    jcfg, cfg = JaxModelConfig(**MOE_KW), ModelConfig(**MOE_KW)
    jtx = joptim.make_optimizer(JaxTrainConfig(**TRAIN_KW))
    jparams = jget_model(jcfg).init(jax.random.key(0), jcfg)
    jstate = jinit(jparams, jtx)
    step_j = jax.jit(jstep(jget_model(jcfg), jcfg, jtx, jit=False))
    tx = optim.make_optimizer(TrainConfig(**TRAIN_KW))
    state = init_train_state(
        interop.params_from_jax(jax.device_get(jparams), cfg), tx)
    step_p = make_train_step(get_model(cfg), cfg, tx)
    rng = np.random.default_rng(8)
    batch = {k: rng.integers(0, 97, (1, 4, 32)).astype(np.int32)
             for k in ("inputs", "targets")}
    jshares, pshares = [], []
    for i in range(6):
        with jax.default_matmul_precision("highest"):
            jshares.append(_jax_dropped(jcfg, jstate.params,
                                        batch["inputs"][0]))
        pshares.append(_port_dropped(cfg, state.params,
                                     batch["inputs"][0]))
        if i == 5:
            break
        with jax.default_matmul_precision("highest"):
            jstate, _ = step_j(jstate, jax.tree.map(jnp.asarray, batch),
                               jax.random.key(0))
        state, _ = step_p(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assignments = 4 * 32 * 2  # tokens x top-k, one layer
    np.testing.assert_allclose(pshares, jshares, atol=0.5 / assignments)
    assert max(jshares) > 0  # the capacity binds: the check is not vacuous
