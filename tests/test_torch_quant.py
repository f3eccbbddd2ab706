"""The port's int8 primitives and the int8 paged attention's plain version
against the JAX package's, on the CPU.

Same seeded numpy inputs through ``pytorch_distributed_tpu.ops.quant`` /
``ops.paged_kernel`` and their ports:

- quantizing the same f32 input is BIT-EQUAL on both sides (int8 values
  and f32 scales): KV rows (all-zero rows, a single outlier, per-KV-head
  scales under GQA) and weights (gpt2 and llama trees);
- ``qdot`` on plain weights is exactly today's ``dense``; on int8
  weights it matches JAX's ``qdot`` within 1e-6 (f32 summation order);
- the K4 plain version matches JAX ``paged_decode_attention(...,
  k_scales, v_scales, interpret=True)`` and its reference within 1e-5
  (atol and rtol; summation order only);
- the quality metrics are numpy copies and give JAX's numbers exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.models import get_model as jax_get_model
from pytorch_distributed_tpu.ops import layers as jl
from pytorch_distributed_tpu.ops import paged_kernel as jk
from pytorch_distributed_tpu.ops import quant as jq
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.ops import layers as tl
from pytorch_distributed_tpu_torch.ops import paged_kernel as tk
from pytorch_distributed_tpu_torch.ops import quant as tq
from pytorch_distributed_tpu_torch.utils.tree import leaves_with_path

ATT_TOL = dict(atol=1e-5, rtol=1e-5)
N_PAGES = 4


def _kv_case(name):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
    if name == "all_zero_rows":
        x[0, 1] = 0.0
        x[1, :, 1] = 0.0
    elif name == "single_outlier":
        x[0, 0, 0, 3] = 1e30
        x[1, 2, 1, 0] = -5e4
    elif name == "gqa_head_scaled":
        x[:, :, 1] *= 1000.0
    elif name == "ties":
        # x / scale lands exactly on .5 steps: round half to even.
        x[:] = np.arange(16, dtype=np.float32) - 7.5
        x[..., 0] = 127.0  # scale exactly 1
    return x


@pytest.mark.parametrize(
    "case", ["random", "all_zero_rows", "single_outlier", "gqa_head_scaled",
             "ties"],
)
def test_quantize_kv_is_bit_equal_to_jax(case):
    x = _kv_case(case)
    jqv, jsc = jq.quantize_kv(jnp.asarray(x))
    tqv, tsc = tq.quantize_kv(torch.from_numpy(x))
    assert tqv.dtype == torch.int8 and tsc.dtype == torch.float32
    assert tuple(tsc.shape) == x.shape[:-1]
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(
        tq.dequantize_kv(tqv, tsc, torch.float32).numpy(),
        np.asarray(jq.dequantize_kv(jqv, jsc, jnp.float32)),
    )


def test_all_zero_rows_dequantize_to_exact_zeros():
    q, s = tq.quantize_kv(torch.zeros(2, 3, 2, 16))
    assert bool((s == 1.0).all())
    assert bool((tq.dequantize_kv(q, s, torch.float32) == 0).all())


def test_kv_scales_are_per_kv_head_under_gqa():
    """Scaling one KV head's values scales only that head's scale and
    leaves the other head's int8 words untouched."""
    base = torch.from_numpy(_kv_case("random"))
    scaled = base.clone()
    scaled[:, :, 1] *= 1000.0
    q0, s0 = tq.quantize_kv(base)
    q1, s1 = tq.quantize_kv(scaled)
    torch.testing.assert_close(s1[:, :, 0], s0[:, :, 0], rtol=0, atol=0)
    torch.testing.assert_close(s1[:, :, 1], s0[:, :, 1] * 1000.0,
                               rtol=1e-5, atol=0)
    assert torch.equal(q1[:, :, 0], q0[:, :, 0])


@pytest.mark.parametrize("shape", [(16, 3, 2, 4), (32, 48), (48, 32)])
def test_quantize_weight_is_bit_equal_to_jax(shape):
    rng = np.random.default_rng(1)
    w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    w[:, 0] = 0.0  # an all-zero output channel: scale 1
    jw = jq.quantize_weight(jnp.asarray(w))
    tw = tq.quantize_weight(torch.from_numpy(w))
    assert tq.is_quantized(tw) and tw["q8"].dtype == torch.int8
    assert tuple(tw["scale"].shape) == shape[1:]
    np.testing.assert_array_equal(tw["q8"].numpy(), np.asarray(jw["q8"]))
    np.testing.assert_array_equal(tw["scale"].numpy(),
                                  np.asarray(jw["scale"]))


def _cfg_kw(family):
    kw = dict(family=family, vocab_size=97, n_ctx=64, n_embd=64, n_layer=2,
              n_head=4, dtype="float32", attn_pdrop=0.0, resid_pdrop=0.0,
              embd_pdrop=0.0)
    if family == "llama":
        kw["n_kv_head"] = 2
    return kw


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_quantize_decode_params_is_bit_equal_to_jax(family):
    """The port quantizes its per-layer tree (contracting axis 0) to the
    same int8 values and scales as JAX's stacked tree (axis 1); only the
    projection weights are quantized, every other leaf passes through as
    the same tensor."""
    jcfg = JaxModelConfig(**_cfg_kw(family))
    pcfg = ModelConfig(**_cfg_kw(family))
    jparams = jax_get_model(jcfg).init(jax.random.key(0), jcfg)
    want = interop.params_from_jax(
        jax.device_get(jq.quantize_decode_params(jparams)), pcfg
    )
    params = interop.params_from_jax(jax.device_get(jparams), pcfg)
    got = tq.quantize_decode_params(params)
    flat_want = dict(leaves_with_path(want))
    flat_got = dict(leaves_with_path(got))
    assert flat_got.keys() == flat_want.keys()
    for path, leaf in flat_want.items():
        assert flat_got[path].dtype == leaf.dtype, path
        assert torch.equal(flat_got[path], leaf), path
    n_q8 = sum(path[-1] == "q8" for path in flat_got)
    assert n_q8 == 2 * (4 if family == "gpt2" else 7)
    assert got["wte"] is params["wte"]
    if family == "gpt2":
        attn = got["blocks"][0]["attn"]["c_attn"]
        assert attn["bias"] is params["blocks"][0]["attn"]["c_attn"]["bias"]
    else:
        assert got["lm_head"] is params["lm_head"]
    again = dict(leaves_with_path(tq.quantize_decode_params(got)))
    assert all(again[path] is leaf for path, leaf in flat_got.items())


@pytest.mark.parametrize("out_shape", [(48,), (3, 4, 8)])
def test_qdot_on_plain_weights_is_todays_dense(out_shape):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 5, 32)).astype(np.float32))
    w = torch.from_numpy(
        (rng.standard_normal((32, *out_shape)) * 0.1).astype(np.float32)
    )
    assert torch.equal(tq.qdot(x, w), tl.dense(x, {"kernel": w}))
    xb = x.to(torch.bfloat16)
    assert torch.equal(tq.qdot(xb, w), tl.dense(xb, {"kernel": w}))


@pytest.mark.parametrize("out_shape", [(48,), (3, 4, 8)])
def test_quantized_dense_and_qdot_match_jax(out_shape):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = (rng.standard_normal((32, *out_shape)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(out_shape) * 0.1).astype(np.float32)
    jw = jq.quantize_weight(jnp.asarray(w))
    tw = tq.quantize_weight(torch.from_numpy(w))
    np.testing.assert_allclose(
        tq.qdot(torch.from_numpy(x), tw).numpy(),
        np.asarray(jq.qdot(jnp.asarray(x), jw)), rtol=1e-6, atol=1e-6,
    )
    want = jl.dense(jnp.asarray(x), {"kernel": jw, "bias": jnp.asarray(bias)})
    got = tl.dense(torch.from_numpy(x),
                   {"kernel": tw, "bias": torch.from_numpy(bias)})
    assert tuple(got.shape) == (2, 5, *out_shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_quality_metrics_are_the_jax_numbers():
    rng = np.random.default_rng(4)
    ref = rng.standard_normal((3, 7, 11))
    q = ref + 0.3 * rng.standard_normal(ref.shape)
    assert tq.relative_logit_mse(ref, q) == jq.relative_logit_mse(ref, q)
    assert tq.argmax_agreement(ref, q) == jq.argmax_agreement(ref, q)
    toks_a = [[1, 2, 3, 4], [5, 6], [7]]
    toks_b = [[1, 2, 9, 4], [5, 6, 8], [3]]
    assert tq.token_match_rate(toks_a, toks_b) == jq.token_match_rate(
        toks_a, toks_b
    )
    assert tq.Q8_QUALITY == jq.Q8_QUALITY


# -- the int8 paged attention (K4) plain version ------------------------------


def _q8_case(group, page, hkv=2, d=32, seed=0):
    """Rows at lengths 0, page-1, page and max_len-1 over distinct pages,
    unallocated entries on the scratch page 0; int8 pools and scales made
    by the JAX quantizer from f32 normals."""
    rng = np.random.default_rng(seed)
    lengths = np.array([0, page - 1, page, N_PAGES * page - 1], np.int32)
    b, h = len(lengths), hkv * group
    n_pool = b * N_PAGES + 1
    ids = rng.permutation(np.arange(1, n_pool))
    tables = np.zeros((b, N_PAGES), np.int32)
    used = 0
    for r, length in enumerate(lengths):
        n = length // page + 1
        tables[r, :n] = ids[used : used + n]
        used += n
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kq, ks = jq.quantize_kv(jnp.asarray(
        rng.standard_normal((n_pool, page, hkv, d)).astype(np.float32)))
    vq, vs = jq.quantize_kv(jnp.asarray(
        rng.standard_normal((n_pool, page, hkv, d)).astype(np.float32)))
    return [q, np.asarray(kq), np.asarray(vq), tables, lengths,
            np.asarray(ks), np.asarray(vs)]


def _torch(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_q8_plain_version_matches_jax_kernel_and_reference(group, page):
    q, kq, vq, tables, lengths, ks, vs = _q8_case(group, page)
    j = [jnp.asarray(a) for a in (q, kq, vq, tables, lengths, ks, vs)]
    want_kernel = np.asarray(jk.paged_decode_attention(
        *j[:5], k_scales=j[5], v_scales=j[6], interpret=True))
    want_ref = np.asarray(jk.paged_decode_attention_reference(*j))
    args = _torch((q, kq, vq, tables, lengths, ks, vs))
    got = tk.paged_decode_attention_reference(*args)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), want_kernel, **ATT_TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, **ATT_TOL)
    before = (tk.launches, tk.launches_q8)
    wrapped = tk.paged_decode_attention(*args[:5], k_scales=args[5],
                                        v_scales=args[6])
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())
    assert (tk.launches, tk.launches_q8) == before  # CPU: no launch


def test_q8_plain_version_in_bf16_dequantizes_to_bf16():
    """With q in bf16 the pages dequantize to bf16 before the products,
    as JAX's reference does."""
    q, kq, vq, tables, lengths, ks, vs = _torch(_q8_case(4, 4))
    out = tk.paged_decode_attention_reference(q.to(torch.bfloat16), kq, vq,
                                              tables, lengths, ks, vs)
    assert out.dtype == torch.bfloat16
    deq = [tq.dequantize_kv(p, s, torch.bfloat16) for p, s in
           ((kq, ks), (vq, vs))]
    want = tk.paged_decode_attention_reference(q.to(torch.bfloat16), *deq,
                                               tables, lengths)
    assert torch.equal(out, want)


def _bad_q8(**change):
    q, kq, vq, tables, lengths, ks, vs = _torch(_q8_case(2, 4))
    args = dict(q=q, k_pages=kq, v_pages=vq, block_tables=tables,
                lengths=lengths, k_scales=ks, v_scales=vs)
    args.update(change)
    return args


@pytest.mark.parametrize(
    "change, match",
    [
        (dict(v_scales=None), "together"),
        (dict(k_scales=None), "together"),
        (dict(k_scales=torch.ones(17, 4, 1)), "k_scales must be"),
        (dict(v_scales=torch.ones(17, 4, 2, dtype=torch.float64)),
         "v_scales must be"),
        (dict(k_pages=torch.zeros(17, 4, 2, 32)), "must be int8"),
        (dict(block_tables=torch.full((4, N_PAGES), 17, dtype=torch.int32)),
         "outside"),
    ],
)
def test_q8_bad_inputs_raise(change, match):
    with pytest.raises(ValueError, match=match):
        tk.paged_decode_attention(**_bad_q8(**change))


def test_int8_pages_without_scales_raise():
    args = _bad_q8(k_scales=None, v_scales=None)
    with pytest.raises(ValueError, match="share a dtype"):
        tk.paged_decode_attention(**args)
