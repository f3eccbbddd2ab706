"""Batched speculative decoding (``speculative_k``) on the port's dense
and paged engines, on the CPU, against the JAX package's engines.

The cases of the JAX ``tests/test_serving_spec.py`` that have a meaning
without a mesh (its TP case is in ``tests/test_torch_serving_tp.py``).
Weights are made by the JAX ``init`` and converted with
``interop.params_from_jax`` (f32, vocab 97, 2 layers, E 64). Greedy
speculative output must be token-equal to the port's plain engine and to
the JAX speculative engine on the same requests, with equal ``spec_*``
counters (sampled rows draft nothing, so the counters match even where
the sampled tokens cannot: JAX's threefry stream is not the port's). The
rollback must leave published prefix pages bit-unchanged.
"""

import jax
import numpy as np
import pytest

from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu.serving.engine import (
    BatchedDecodeEngine as JaxDense,
)
from pytorch_distributed_tpu.serving.engine import BucketSpec as JaxBuckets
from pytorch_distributed_tpu.serving.engine import (
    PagedBatchedDecodeEngine as JaxPaged,
)
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.models.speculative import (
    generate_speculative,
)
from pytorch_distributed_tpu_torch.serving.chaos import Fault, FaultInjector
from pytorch_distributed_tpu_torch.serving.engine import (
    BatchedDecodeEngine,
    BucketSpec,
    DecodeEngine,
    PagedBatchedDecodeEngine,
)

SPEC_COUNTERS = ("drafted_tokens", "accepted_tokens", "spec_commits")
CFG_KW = dict(vocab_size=97, n_ctx=64, n_embd=64, n_layer=2, n_head=4,
              dtype="float32", attn_pdrop=0.0, resid_pdrop=0.0,
              embd_pdrop=0.0)
_REP = np.array([3, 8, 3, 8, 3, 8, 3], np.int32)  # the lookup fires


@pytest.fixture(scope="module")
def weights():
    jcfg, pcfg = JaxModelConfig(**CFG_KW), ModelConfig(**CFG_KW)
    jparams = jget_model(jcfg).init(jax.random.key(0), jcfg)
    return jcfg, jparams, pcfg, interop.params_from_jax(
        jax.device_get(jparams), pcfg)


def _prompt(tp, seed):
    return np.random.default_rng(seed).integers(0, 97, tp).astype(np.int32)


def _dense(cfg, spec=0, **kw):
    kw.setdefault("buckets", BucketSpec((8, 16, 32)))
    return BatchedDecodeEngine(cfg, slots=3, max_len=32, speculative_k=spec,
                               device="cpu", **kw)


def _paged(cfg, spec=0, **kw):
    kw.setdefault("page_size", 8)
    kw.setdefault("prefill_chunk", 8)
    return PagedBatchedDecodeEngine(cfg, slots=3, max_len=32,
                                    speculative_k=spec, device="cpu", **kw)


def _jax(kind, jcfg, spec=0, **kw):
    if kind == "dense":
        return JaxDense(jcfg, slots=3, max_len=32, speculative_k=spec,
                        buckets=JaxBuckets((8, 16, 32)), **kw)
    return JaxPaged(jcfg, slots=3, max_len=32, speculative_k=spec,
                    page_size=8, prefill_chunk=8, **kw)


def _mixed_requests(jax_side=False):
    """Repetitive + random prompts x {greedy, top-k, top-p}, more
    requests than slots: greedy rows' lookup fires, sampled rows ride
    zero-draft lanes."""
    def sampled(seed, **kw):
        if jax_side:
            return dict(kw, key=jax.random.key(seed))
        return dict(kw, seed=seed)

    return [
        dict(prompt=_REP.copy(), max_new_tokens=10),
        dict(prompt=_prompt(8, 2), max_new_tokens=6,
             **sampled(11, temperature=0.9, top_k=17)),
        dict(prompt=_prompt(5, 1), max_new_tokens=6),
        dict(prompt=_prompt(3, 3), max_new_tokens=4,
             **sampled(12, temperature=1.1, top_p=0.9)),
    ]


def _assert_equal_runs(want, got, rows=None):
    assert set(got) == set(want)
    for rid in rows if rows is not None else want:
        assert want[rid].state == "DONE" and got[rid].state == "DONE"
        np.testing.assert_array_equal(
            np.asarray(got[rid].tokens), np.asarray(want[rid].tokens),
            err_msg=f"request {rid}")


GREEDY = [0, 2]  # the rows of _mixed_requests that do not sample


@pytest.mark.parametrize("kind, kw", [
    ("dense", {}),
    ("paged", {}),
    ("paged", dict(kv_quant="int8")),
], ids=["dense", "paged", "paged_int8"])
def test_spec_matches_plain_and_the_jax_engine(weights, kind, kw):
    """The core pin on each engine: a busy slot batch with speculation on
    emits the plain engine's tokens (every row), the JAX speculative
    engine's greedy tokens, and the JAX engine's ``spec_*`` counters —
    with drafts actually accepted (a 0-accept run would make it
    vacuous)."""
    jcfg, jparams, pcfg, params = weights
    mk = _dense if kind == "dense" else _paged
    out_p = mk(pcfg, **kw).run(params, _mixed_requests())
    spec = mk(pcfg, spec=4, **kw)
    out_s = spec.run(params, _mixed_requests())
    _assert_equal_runs(out_p, out_s)
    assert spec.counters["accepted_tokens"] > 0
    assert spec.counters["drafted_tokens"] >= spec.counters[
        "accepted_tokens"]
    jspec = _jax(kind, jcfg, spec=4, **kw)
    out_j = jspec.run(jparams, _mixed_requests(jax_side=True))
    _assert_equal_runs(out_j, out_s, rows=GREEDY)
    assert {k: spec.counters[k] for k in SPEC_COUNTERS} == {
        k: jspec.counters[k] for k in SPEC_COUNTERS}
    st = spec.stats()
    assert st["speculative_k"] == 4
    assert st["spec_accept_rate"] == jspec.stats()["spec_accept_rate"]


def test_spec_rollback_never_dirties_shared_prefix_pages(weights):
    """A row borrowing cached prefix pages speculates with drafts that
    are mostly rejected (a hook drafting off-by-one tokens): the cached
    pages' bytes are identical before and after its whole run, and its
    tokens match a no-sharing engine's. Every verify-window write lands
    at or past the row's first private position."""
    _, _, pcfg, params = weights

    def off_by_one(history, k):
        return (history[-k:] + 1) % 97

    eng = _paged(pcfg, spec=4, draft_hook=off_by_one)
    prefix = _prompt(16, 9)  # two full chunks -> published to the cache
    out1 = eng.run(params, [dict(prompt=prefix, max_new_tokens=4)])
    assert out1[0].state == "DONE"
    cached = sorted(eng.pool.cached_page_ids())
    assert cached, "prefix chunks were not published"
    before = {leaf: eng._cache[leaf][:, cached].clone()
              for leaf in eng._cache}
    req2 = dict(prompt=np.concatenate([prefix, _prompt(4, 10)]),
                max_new_tokens=10)
    out2 = eng.run(params, [req2])
    assert out2[1].state == "DONE"
    assert eng.pool.stats["prefix_hits"] >= 1, "req2 never hit the cache"
    assert eng.counters["drafted_tokens"] > eng.counters["accepted_tokens"]
    for leaf, was in before.items():
        assert bool((eng._cache[leaf][:, cached] == was).all()), leaf
    ref = _paged(pcfg, spec=4).run(params, [req2])
    np.testing.assert_array_equal(out2[1].tokens, ref[0].tokens)


def test_spec_zero_draft_rows_degenerate_to_plain_tick(weights):
    """Rows with no n-gram match (or a remaining budget of 1) draft
    nothing: one token per tick, the plain output; a too-short history
    does not crash the drafter."""
    _, _, pcfg, params = weights
    reqs = [dict(prompt=np.array([7], np.int32), max_new_tokens=3),
            dict(prompt=_prompt(4, 5), max_new_tokens=2)]
    out_p = _paged(pcfg).run(params, reqs)
    spec = _paged(pcfg, spec=4, spec_ngram=3)
    _assert_equal_runs(out_p, spec.run(params, reqs))


def test_spec_full_accept_via_draft_hook_saves_ticks(weights):
    """A hook drafting the model's own continuation commits k+1 tokens a
    tick: strictly fewer ticks than plain for the same output."""
    _, _, pcfg, params = weights
    prompt = _prompt(6, 6)
    plain = _paged(pcfg)
    full = np.asarray(plain.run(
        params, [dict(prompt=prompt, max_new_tokens=16)])[0].tokens)

    def oracle(history, k):
        n = history.shape[0]
        return full[n: n + k]

    spec = _paged(pcfg, spec=4, draft_hook=oracle)
    out = spec.run(params, [dict(prompt=prompt, max_new_tokens=16)])
    np.testing.assert_array_equal(out[0].tokens, full)
    assert spec.counters["accepted_tokens"] == spec.counters[
        "drafted_tokens"] > 0
    assert spec._ticks < plain._ticks
    assert spec.counters["decode_ticks"] < plain.counters["decode_ticks"]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_eos_inside_draft_window(weights, kind):
    """EOS inside an accepted window: the commit stops at the EOS token,
    as the plain engine's and the JAX engine's do."""
    jcfg, jparams, pcfg, params = weights
    mk = _dense if kind == "dense" else _paged
    probe = mk(pcfg).run(params, [dict(prompt=_REP.copy(),
                                       max_new_tokens=12)])
    gen = np.asarray(probe[0].tokens)[len(_REP):]
    eos = int(gen[len(gen) // 2])
    req = [dict(prompt=_REP.copy(), max_new_tokens=12, eos_id=eos)]
    out_p = mk(pcfg).run(params, req)
    out_s = mk(pcfg, spec=6).run(params, req)
    _assert_equal_runs(out_p, out_s)
    _assert_equal_runs(_jax(kind, jcfg, spec=6).run(jparams, req), out_s)
    assert len(out_s[0].tokens) < len(probe[0].tokens)


def test_spec_rows_flush_against_max_len(weights):
    """prompt + max_new == max_len, so late verify windows cross the cache
    extent: out-of-range lanes are dropped (dense) or sent to the scratch
    page (paged), never shifted onto committed positions, and the output
    equals plain and JAX's. Garbage drafts from a hook are clipped to the
    vocabulary and cost only speed."""
    jcfg, jparams, pcfg, params = weights
    reqs = [
        dict(prompt=np.array([5, 9, 5, 9, 5, 9], np.int32),
             max_new_tokens=26),
        dict(prompt=_prompt(4, 7), max_new_tokens=28),
    ]
    for kind, mk in (("dense", _dense), ("paged", _paged)):
        out_p = mk(pcfg).run(params, reqs)
        spec = mk(pcfg, spec=5)
        out_s = spec.run(params, reqs)
        _assert_equal_runs(out_p, out_s)
        jspec = _jax(kind, jcfg, spec=5)
        _assert_equal_runs(jspec.run(jparams, reqs), out_s)
        assert {k: spec.counters[k] for k in SPEC_COUNTERS} == {
            k: jspec.counters[k] for k in SPEC_COUNTERS}
    wild = _paged(pcfg, spec=3, draft_hook=lambda h, k: np.full((8,), 10**9))
    _assert_equal_runs(out_p, wild.run(params, reqs))
    assert wild.counters["accepted_tokens"] == 0


def test_spec_churn_adds_no_compiled_program(weights):
    """Warmup runs the verify width; admission and retirement churn with
    mixed draft counts adds nothing to ``compile_count``."""
    _, _, pcfg, params = weights
    eng = _paged(pcfg, spec=4)
    warm = eng.warmup(params)
    eng.run(params, [
        dict(prompt=_prompt(4 + (i % 5), i), max_new_tokens=4 + (i % 4))
        for i in range(7)
    ] + [dict(prompt=_REP.copy(), max_new_tokens=8)])
    assert eng.compile_count() == warm


@pytest.fixture(scope="module")
def spec_clean(weights):
    _, _, pcfg, params = weights
    return _paged(pcfg, spec=4).run(params, _mixed_requests())


def test_spec_nan_quarantine_token_identical(weights, spec_clean):
    """A nan_row fault on a speculative tick quarantines the row (no part
    of its window is committed) and its re-prefilled continuation equals
    the fault-free run."""
    _, _, pcfg, params = weights
    eng = _paged(pcfg, spec=4)
    FaultInjector([Fault(kind="nan_row", tick=5, row=0)]).install(eng)
    out = eng.run(params, _mixed_requests())
    assert eng._injector.counts["nan_row"] == 1
    assert eng.counters["nan_quarantines"] == 1
    _assert_equal_runs(spec_clean, out)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_dispatch_failure_resumes_token_identical(weights, spec_clean,
                                                       kind):
    """A failed verify dispatch: every in-flight row converts to a resume
    entry and continues with the fault-free tokens (greedy and sampled:
    the sampled rows' generators depend on (seed, token index) only)."""
    _, _, pcfg, params = weights
    eng = (_dense if kind == "dense" else _paged)(pcfg, spec=4)
    FaultInjector([Fault(kind="dispatch_error", tick=6,
                         program="decode_spec_step")]).install(eng)
    out = eng.run(params, _mixed_requests())
    assert eng._injector.counts["dispatch_error"] == 1
    assert eng.counters["dispatch_failures"] == 1
    _assert_equal_runs(spec_clean, out)


def test_spec_snapshot_replay_token_identical(weights, spec_clean):
    """snapshot() mid-speculation, restore() onto a fresh engine: the
    continuation re-prefills committed tokens only (rejected drafts were
    never host state) and finishes token-identically."""
    _, _, pcfg, params = weights
    eng = _paged(pcfg, spec=4)
    for r in _mixed_requests():
        eng.submit(**r)
    for _ in range(6):
        eng.step(params)
    eng2 = _paged(pcfg, spec=4)
    eng2.restore(eng.snapshot())
    while eng2.has_work():
        eng2.step(params)
    for rid in spec_clean:
        np.testing.assert_array_equal(eng2.results[rid].tokens,
                                      spec_clean[rid].tokens)


def test_spec_constructor_validation_and_uniform_stats(weights):
    """JAX's constructor refusals; the uniform stats schema (the serial
    engine at the off values); an all-sampled stream drafts nothing."""
    _, _, pcfg, params = weights
    with pytest.raises(ValueError, match="speculative_k"):
        _dense(pcfg, spec=-1)
    with pytest.raises(ValueError, match="speculative_k"):
        BatchedDecodeEngine(pcfg, slots=2, max_len=16, speculative_k=16,
                            device="cpu")
    with pytest.raises(ValueError, match="spec_ngram"):
        _paged(pcfg, spec=2, spec_ngram=0)
    with pytest.raises(ValueError, match="draft_hook"):
        _dense(pcfg, spec=2, draft_hook="not callable")
    st = DecodeEngine(pcfg, max_len=32, buckets=BucketSpec((8,)),
                      device="cpu").stats()
    assert st["speculative_k"] == 0 and st["spec_accept_rate"] is None
    assert st["counters"]["drafted_tokens"] == 0
    eng = _paged(pcfg, spec=4)
    eng.run(params, [
        dict(prompt=_prompt(5, i), max_new_tokens=6, temperature=1.0,
             seed=40 + i, top_k=13) for i in range(3)])
    assert eng.counters["drafted_tokens"] == 0
    assert eng.counters["accepted_tokens"] == 0
    st = eng.stats()
    assert st["speculative_k"] == 4 and st["spec_accept_rate"] is None


def test_spec_matches_serial_speculative_reference(weights):
    """The one-slot engine path (``serving.generate --speculative``) and
    the reference loop give the same greedy output."""
    _, _, pcfg, params = weights
    prompt = _prompt(6, 20)[None, :]
    ref = generate_speculative(params, prompt, pcfg, 16, device="cpu")
    eng = BatchedDecodeEngine(pcfg, slots=1, max_len=prompt.shape[1] + 16,
                              speculative_k=8, device="cpu")
    rid = eng.submit(prompt[0], 16)
    np.testing.assert_array_equal(eng.run(params)[rid].tokens,
                                  ref[0].numpy())
