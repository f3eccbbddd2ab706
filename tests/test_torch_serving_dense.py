"""The port's dense ``BatchedDecodeEngine`` on the CPU against the JAX
package's, and against the port's paged engine.

Weights are made by the JAX ``init`` and converted with
``interop.params_from_jax`` (f32, the JAX test configs' small shapes:
vocab 97, 2 layers, E 64). Greedy outputs must be token-equal to the JAX
dense engine's, with equal counters, and to the port's paged engine; the
fault paths (quarantine, dispatch failure, dropped result, snapshot/
restore, adopt) must give the fault-free tokens. The prefill is checked
to give a row the same K/V, bit for bit, alone or beside other rows.
"""

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu.serving import chaos as jchaos
from pytorch_distributed_tpu.serving.engine import (
    BatchedDecodeEngine as JaxDense,
)
from pytorch_distributed_tpu.serving.engine import BucketSpec as JaxBuckets
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.serving.chaos import Fault, FaultInjector
from pytorch_distributed_tpu_torch.serving.engine import (
    BatchedDecodeEngine,
    BucketSpec,
    PagedBatchedDecodeEngine,
    kv_bytes_per_position,
)

BUCKETS = (8, 16, 32)
JAX_COUNTERS = ("done", "failed", "aborted", "expired", "nan_quarantines",
                "dispatch_failures", "resumes", "cache_allocs",
                "drafted_tokens", "accepted_tokens", "spec_commits")


def _kw(family):
    kw = dict(family=family, vocab_size=97, n_ctx=64, n_embd=64, n_layer=2,
              n_head=4, dtype="float32", attn_pdrop=0.0, resid_pdrop=0.0,
              embd_pdrop=0.0)
    if family == "llama":
        kw["n_kv_head"] = 2
    return kw


def _weights(family):
    kw = _kw(family)
    jcfg, pcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    jparams = jget_model(jcfg).init(jax.random.key(0), jcfg)
    return jcfg, jparams, pcfg, interop.params_from_jax(
        jax.device_get(jparams), pcfg)


@pytest.fixture(scope="module", params=["gpt2", "llama"])
def weights(request):
    return _weights(request.param)


@pytest.fixture(scope="module")
def gpt2_weights():
    return _weights("gpt2")


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 97, n).astype(np.int32)


def _mix():
    """More requests than slots, prompts across all three buckets, one
    with an EOS."""
    return [
        dict(prompt=_prompt(5, 1), max_new_tokens=8),
        dict(prompt=_prompt(12, 2), max_new_tokens=6),
        dict(prompt=_prompt(3, 3), max_new_tokens=9),
        dict(prompt=_prompt(20, 4), max_new_tokens=5),
        dict(prompt=_prompt(7, 5), max_new_tokens=7),
    ]


def _dense(pcfg, **kw):
    return BatchedDecodeEngine(pcfg, slots=3, max_len=32,
                               buckets=BucketSpec(BUCKETS), device="cpu",
                               **kw)


def _jax_dense(jcfg, **kw):
    return JaxDense(jcfg, slots=3, max_len=32, buckets=JaxBuckets(BUCKETS),
                    **kw)


def _tokens(out):
    return {rid: (r.state, np.asarray(r.tokens).tolist())
            for rid, r in out.items()}


@pytest.fixture(scope="module")
def clean(weights):
    jcfg, jparams, pcfg, params = weights
    jeng = _jax_dense(jcfg)
    want = jeng.run(jparams, _mix())
    eng = _dense(pcfg)
    got = eng.run(params, _mix())
    return want, jeng, got, eng


def test_dense_mix_token_equal_to_jax_with_equal_counters(clean):
    want, jeng, got, eng = clean
    assert _tokens(got) == _tokens(want)
    assert all(r.state == "DONE" for r in got.values())
    assert {k: eng.counters[k] for k in JAX_COUNTERS} == {
        k: jeng.counters[k] for k in JAX_COUNTERS}


def test_dense_equals_the_paged_engine(weights, clean):
    _, _, pcfg, params = weights
    paged = PagedBatchedDecodeEngine(pcfg, slots=3, max_len=32, page_size=8,
                                     prefill_chunk=8, device="cpu")
    assert _tokens(paged.run(params, _mix())) == _tokens(clean[2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_prefill_values_do_not_depend_on_neighbours(dtype):
    """A row's prefilled K/V are bit-equal whether it prefills alone or in
    one forward with three other rows (GPT-2 width, 2 layers): the dense
    prefill always has the shape [slots, bucket]."""
    from pytorch_distributed_tpu_torch.models import gpt2

    cfg = ModelConfig(vocab_size=97, n_ctx=128, n_embd=768, n_layer=2,
                      n_head=12, dtype=dtype, attn_pdrop=0.0,
                      resid_pdrop=0.0, embd_pdrop=0.0)
    params = gpt2.init(torch.Generator().manual_seed(4), cfg, device="cpu")
    rng = np.random.default_rng(4)
    x = rng.integers(0, 97, 40)
    kv = []
    for others in ((), (50, 20, 60)):
        eng = BatchedDecodeEngine(cfg, slots=4, max_len=128,
                                  buckets=BucketSpec((64,)), device="cpu")
        for n in others:
            eng.submit(rng.integers(0, 97, n), 4)
        rid = eng.submit(x, 4)
        eng.step(params)  # every row prefills in one forward
        row = next(i for i, s in enumerate(eng._slots)
                   if s is not None and s.rid == rid)
        kv.append([eng._cache[n][:, row, :40] for n in ("k", "v")])
    for alone, busy in zip(*kv):
        assert torch.equal(alone, busy)


@pytest.mark.parametrize(
    "faults, kw",
    [
        ([("nan_row", 3, None)], {}),
        ([("dispatch_error", 3, "decode_step")], {}),
        ([("drop_result", 2, "prefill"), ("dispatch_error", 5, None)], {}),
        ([("dispatch_error", 2, None)], dict(request_retries=0)),
    ],
    ids=["nan_row", "dispatch_error", "drop_then_dispatch",
         "retries_exhausted"],
)
def test_recovery_matches_the_jax_dense_engine(gpt2_weights, faults, kw):
    """The same scripted faults through the JAX dense engine and the
    port's: the same terminal states, reasons and tokens and the same
    counters (cache allocations included: each failed dispatch costs the
    cache)."""
    jcfg, jparams, pcfg, params = gpt2_weights
    outs = []
    for jax_side in (True, False):
        eng = _jax_dense(jcfg, **kw) if jax_side else _dense(pcfg, **kw)
        f_cls = jchaos.Fault if jax_side else Fault
        i_cls = jchaos.FaultInjector if jax_side else FaultInjector
        i_cls([f_cls(tick=t, kind=k, program=p, row=0)
               for k, t, p in faults]).install(eng)
        out = eng.run(jparams if jax_side else params, _mix())
        outs.append((
            {rid: (r.state, r.reason, np.asarray(r.tokens).tolist())
             for rid, r in out.items()},
            {k: eng.counters[k] for k in JAX_COUNTERS},
        ))
    assert outs[0] == outs[1]


def test_faults_and_failover_keep_the_fault_free_tokens(weights, clean):
    """Quarantine, a dispatch failure, snapshot/restore onto a fresh
    engine and adopt onto a busy one: every request finishes DONE with
    the fault-free tokens."""
    _, _, pcfg, params = weights
    want = _tokens(clean[2])
    eng = _dense(pcfg)
    FaultInjector([Fault(tick=3, kind="nan_row", row=1),
                   Fault(tick=5, kind="dispatch_error")]).install(eng)
    assert _tokens(eng.run(params, _mix())) == want
    assert eng.counters["nan_quarantines"] == 1
    assert eng.counters["dispatch_failures"] == 1
    assert eng.counters["cache_allocs"] == 2

    eng = _dense(pcfg)
    for r in _mix():
        eng.submit(**r)
    for _ in range(4):
        eng.step(params)
    snap = eng.snapshot()
    fresh = _dense(pcfg)
    fresh.restore(snap)
    got = fresh.run(params)
    got.update({rid: r for rid, r in snap.results.items()})
    assert _tokens(got) == want

    busy = _dense(pcfg)
    own = busy.submit(_prompt(6, 9), 5)
    busy.step(params)
    mapping = busy.adopt(eng.snapshot().pending)
    out = busy.run(params)
    for donor, adopted in mapping.items():
        assert (out[adopted].state,
                np.asarray(out[adopted].tokens).tolist()) == want[donor]
    assert out[own].state == "DONE"


def test_dense_engine_api_and_refusals(weights):
    _, _, pcfg, params = weights
    eng = _dense(pcfg)
    per = kv_bytes_per_position(pcfg)
    assert eng.cache_hbm_bytes() == {"allocated": 3 * 32 * per,
                                     "peak_in_use": 3 * 32 * per}
    assert eng.warmup(params) == eng.compile_count()
    assert eng.counters["cache_allocs"] == 1
    st = eng.stats()
    assert st["engine"] == "BatchedDecodeEngine" and st["free_pages"] is None
    assert st["slots"] == 3 and st["kv_quant"] == "none"
    with pytest.raises(ValueError, match="largest bucket"):
        BatchedDecodeEngine(pcfg, slots=2, max_len=32,
                            buckets=BucketSpec((8, 16)),
                            device="cpu").submit(_prompt(20, 0), 1)
    with pytest.raises(ValueError, match="sessions"):
        eng.submit(_prompt(4, 0), 2, session=0)
    with pytest.raises(ValueError, match="finite BucketSpec"):
        BatchedDecodeEngine(pcfg, slots=2, max_len=16,
                            device="cpu").warmup(params)
    for kw, match in ((dict(speculative_k=-1), "speculative_k"),
                      (dict(speculative_k=32), "speculative_k"),
                      (dict(spec_ngram=0), "spec_ngram"),
                      (dict(draft_hook="no"), "draft_hook")):
        with pytest.raises(ValueError, match=match):
            _dense(pcfg, **kw)
    rid = eng.submit(_prompt(5, 1), 8)
    eng.step(params)
    assert eng.abort(rid) is True and eng.pop_result(rid).state == "ABORTED"
