"""The port's paged serving engine on the CPU against the JAX package's.

The JAX ``PagedBatchedDecodeEngine`` (gather attention) and the port's
engine (``device="cpu"``) serve the same greedy request mix on the same
converted ``tiny``-shaped f32 weights, with slots=3, max_len=32,
page_size=8, prefill_chunk=8 and a pool small enough to force
preemption: every request must finish DONE with token-equal outputs and
the same prefix-cache hits and preemptions. Sampled requests cannot match
JAX's threefry stream; they are held to the port itself (the same seed
gives the same tokens whatever the slot count).
"""

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.models import gpt2 as jgpt2
from pytorch_distributed_tpu.serving.engine import (
    PagedBatchedDecodeEngine as JaxEngine,
)
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.serving import (
    AdmissionQueueFull,
    PagedBatchedDecodeEngine,
)

CFG_KW = dict(
    vocab_size=97, n_ctx=64, n_embd=64, n_layer=2, n_head=4,
    dtype="float32", attn_pdrop=0.0, resid_pdrop=0.0, embd_pdrop=0.0,
)
ENGINE_KW = dict(slots=3, max_len=32, page_size=8, prefill_chunk=8)


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxModelConfig(**CFG_KW)
    jparams = jgpt2.init(jax.random.key(0), jcfg)
    pcfg = ModelConfig(**CFG_KW)
    return jcfg, jparams, pcfg, interop.params_from_jax(
        jax.device_get(jparams), pcfg
    )


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 97, n).astype(np.int32)


def _greedy_mix():
    """Mixed lengths (one exactly a page, one straddling a chunk), two
    requests sharing a 16-token prefix (two chunks), more requests than
    slots."""
    shared = _prompt(16, 42)
    return [
        dict(prompt=_prompt(14, 1), max_new_tokens=10),
        dict(prompt=np.concatenate([shared, _prompt(4, 7)]), max_new_tokens=6),
        dict(prompt=_prompt(8, 2), max_new_tokens=7),
        dict(prompt=np.concatenate([shared, _prompt(3, 8)]), max_new_tokens=5),
        dict(prompt=_prompt(5, 3), max_new_tokens=9),
        dict(prompt=_prompt(13, 4), max_new_tokens=4),
    ]


@pytest.fixture(scope="module")
def jax_run(weights):
    jcfg, jparams, _, _ = weights
    eng = JaxEngine(jcfg, pool_pages=6, paged_attention="gather", **ENGINE_KW)
    out = eng.run(jparams, _greedy_mix())
    return out, eng.pool.stats["prefix_hits"], eng.counters["preemptions"]


@pytest.mark.parametrize("paged_attention", ["auto", "kernel", "gather"])
def test_greedy_mix_token_equal_to_jax_engine(weights, jax_run,
                                              paged_attention):
    _, _, pcfg, params = weights
    want, hits, preempts = jax_run
    assert hits >= 1 and preempts >= 1  # the mix exercises both paths
    eng = PagedBatchedDecodeEngine(
        pcfg, pool_pages=6, paged_attention=paged_attention, device="cpu",
        **ENGINE_KW,
    )
    got = eng.run(params, _greedy_mix())
    assert sorted(got) == sorted(want)
    for rid in want:
        assert want[rid].state == "DONE" and got[rid].state == "DONE"
        np.testing.assert_array_equal(
            got[rid].tokens, np.asarray(want[rid].tokens),
            err_msg=f"request {rid}",
        )
    assert eng.pool.stats["prefix_hits"] == hits
    assert eng.counters["preemptions"] == preempts
    assert eng.pool.pages_in_use() == 0  # no leaked page references


def test_priority_tiers_match_jax_engine(weights):
    """An interactive arrival preempts a batch row for its slot; batch
    rows sit out ticks while it is live; tokens stay equal to JAX's."""
    jcfg, jparams, pcfg, params = weights
    reqs = [
        dict(prompt=_prompt(9, 20), max_new_tokens=8, priority="batch"),
        dict(prompt=_prompt(6, 21), max_new_tokens=8, priority="batch"),
    ]
    late = dict(prompt=_prompt(7, 22), max_new_tokens=5,
                priority="interactive")
    results = []
    for eng in (
        JaxEngine(jcfg, paged_attention="gather", **{**ENGINE_KW, "slots": 2}),
        PagedBatchedDecodeEngine(pcfg, device="cpu",
                                 **{**ENGINE_KW, "slots": 2}),
    ):
        p = jparams if isinstance(eng, JaxEngine) else params
        for r in reqs:
            eng.submit(**r)
        eng.step(p)
        eng.step(p)
        eng.submit(**late)
        out = eng.run(p)
        results.append((
            {rid: np.asarray(o.tokens).tolist() for rid, o in out.items()},
            eng.counters["preempt_priority"], eng.counters["batch_yield_ticks"],
        ))
    assert results[0] == results[1]
    assert results[1][1] >= 1 and results[1][2] >= 1


def _sampled_mix():
    return [
        dict(prompt=_prompt(6, 30), max_new_tokens=8, temperature=0.9,
             top_k=20, seed=5),
        dict(prompt=_prompt(11, 31), max_new_tokens=6),
        dict(prompt=_prompt(4, 32), max_new_tokens=7, temperature=1.2,
             top_p=0.9, seed=6),
        dict(prompt=_prompt(9, 33), max_new_tokens=5, temperature=0.7,
             seed=7),
    ]


def test_sampled_tokens_are_a_function_of_seed_not_of_slots(weights):
    _, _, pcfg, params = weights
    outs = []
    for slots in (1, 3):
        eng = PagedBatchedDecodeEngine(
            pcfg, device="cpu", **{**ENGINE_KW, "slots": slots}
        )
        outs.append(eng.run(params, _sampled_mix()))
    for rid in outs[0]:
        assert outs[0][rid].state == outs[1][rid].state == "DONE"
        np.testing.assert_array_equal(outs[0][rid].tokens, outs[1][rid].tokens)
    greedy = PagedBatchedDecodeEngine(pcfg, device="cpu", **ENGINE_KW).run(
        params, [{**r, "temperature": 0.0} for r in _sampled_mix()]
    )
    assert any(
        not np.array_equal(greedy[r].tokens, outs[1][r].tokens)
        for r in (0, 2, 3)
    ), "sampling drew the greedy tokens everywhere: it did not sample"


def test_device_none_means_cuda(weights):
    pcfg = weights[2]
    if torch.cuda.is_available():
        eng = PagedBatchedDecodeEngine(pcfg, **ENGINE_KW)
        assert eng.device.type == "cuda" and eng.paged_attention == "kernel"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PagedBatchedDecodeEngine(pcfg, **ENGINE_KW)


@pytest.mark.parametrize(
    "kw, exc, match",
    [
        (dict(page_size=5), ValueError, "positive divisor"),
        (dict(pool_pages=4), ValueError, "pool_pages"),
        (dict(prefill_chunk=12), ValueError, "prefill_chunk"),
        (dict(paged_attention="kernel_interpret"), ValueError, "interpret"),
        (dict(paged_attention="flash"), ValueError, "paged_attention"),
        (dict(max_len=128), ValueError, "n_ctx"),
        (dict(slots=0), ValueError, "slots"),
        (dict(queue_limit=0), ValueError, "queue_limit"),
    ],
)
def test_constructor_rejects(weights, kw, exc, match):
    with pytest.raises(exc, match=match):
        PagedBatchedDecodeEngine(weights[2], device="cpu",
                                 **{**ENGINE_KW, **kw})


@pytest.mark.parametrize(
    "kw, match",
    [
        (dict(prompt=np.zeros(0, np.int32)), "empty prompt"),
        (dict(max_new_tokens=0), "max_new_tokens"),
        (dict(max_new_tokens=30), "exceeds max_len"),
        (dict(temperature=0.5), "requires a seed"),
        (dict(prompt=np.array([1, 97])), r"\[0, 97\)"),
        (dict(priority="urgent"), "priority"),
        (dict(timeout_s=0), "timeout_s"),
        (dict(prompt=np.zeros((2, 3), np.int32)), "one sequence"),
    ],
)
def test_submit_rejects(weights, kw, match):
    eng = PagedBatchedDecodeEngine(weights[2], device="cpu", **ENGINE_KW)
    req = dict(prompt=_prompt(4, 0), max_new_tokens=3, **{})
    req.update(kw)
    with pytest.raises(ValueError, match=match):
        eng.submit(**req)


def test_abort_expire_and_queue_limit(weights):
    _, _, pcfg, params = weights
    now = [0.0]
    eng = PagedBatchedDecodeEngine(pcfg, device="cpu", queue_limit=3,
                                   clock=lambda: now[0], **ENGINE_KW)
    ref = eng.run(params, [dict(prompt=_prompt(5, 40), max_new_tokens=6)])
    a = eng.submit(_prompt(5, 40), 6)
    b = eng.submit(_prompt(6, 41), 6)
    c = eng.submit(_prompt(7, 42), 6, timeout_s=1.0)
    with pytest.raises(AdmissionQueueFull, match="queue_limit 3"):
        eng.submit(_prompt(3, 43), 2)
    assert eng.abort(b) is True
    assert eng.abort(b) is False  # already terminal
    eng.step(params)
    now[0] = 5.0
    eng.run(params)
    res_a = eng.pop_result(a)
    assert res_a.state == "DONE"
    np.testing.assert_array_equal(res_a.tokens, ref[0].tokens)
    res_c = eng.pop_result(c)
    assert res_c.state == "EXPIRED" and "deadline" in res_c.reason
    assert eng.pop_result(b).state == "ABORTED"
    with pytest.raises(KeyError):
        eng.abort(b)  # delivered
    st = eng.stats()
    assert st["counters"]["aborted"] == 1 and st["counters"]["expired"] == 1
    assert st["active_rows"] == 0 and st["pages_in_use"] == 0


def test_eos_stops_the_row_early(weights):
    _, _, pcfg, params = weights
    eng = PagedBatchedDecodeEngine(pcfg, device="cpu", **ENGINE_KW)
    full = eng.run(params, [dict(prompt=_prompt(5, 50), max_new_tokens=8)])[0]
    eos = int(full.tokens[5 + 2])
    first = int(np.argmax(np.asarray(full.tokens[5:]) == eos))
    out = eng.run(params, [dict(prompt=_prompt(5, 50), max_new_tokens=8,
                                eos_id=eos)])[1]
    assert out.state == "DONE"
    np.testing.assert_array_equal(out.tokens, full.tokens[: 5 + first + 1])


def test_nonfinite_logits_fail_the_row_with_a_reason(weights):
    """The JAX engine's quarantine: a row whose logits go non-finite is
    freed and its clean prefix re-prefilled once on fresh pages; when the
    logits stay non-finite it is FAILED with JAX's reason, keeping the
    clean tokens. The same poisoned weights through the JAX engine give
    the same terminal states, reasons, tokens and quarantine count."""
    jcfg, jparams, pcfg, params = weights
    bad = dict(params)
    bad["wpe"] = params["wpe"].clone()
    # Past the first prefill chunk: the decode step at position 8 goes
    # non-finite after the tokens drawn at positions 3..7; the retry's
    # re-prefill of those 9 tokens reaches position 8 again.
    bad["wpe"][8:] = float("nan")
    jbad = dict(jparams)
    jbad["wpe"] = np.asarray(jparams["wpe"]).copy()
    jbad["wpe"][8:] = np.nan
    reqs = [dict(prompt=_prompt(4, 60), max_new_tokens=8),
            dict(prompt=_prompt(2, 61), max_new_tokens=3)]
    eng = PagedBatchedDecodeEngine(pcfg, device="cpu", **ENGINE_KW)
    out = eng.run(bad, reqs)
    jeng = JaxEngine(jcfg, paged_attention="gather", **ENGINE_KW)
    jout = jeng.run(jbad, reqs)
    assert out[0].state == "FAILED"
    assert out[0].reason == (
        "non-finite logits persisted after one quarantine retry (prefill)"
    )
    assert len(out[0].tokens) == 4 + 5  # the clean tokens before the fault
    assert out[1].state == "DONE"
    for rid in (0, 1):
        assert (out[rid].state, out[rid].reason) == (
            jout[rid].state, jout[rid].reason
        )
        np.testing.assert_array_equal(out[rid].tokens,
                                      np.asarray(jout[rid].tokens))
    assert eng.counters["nan_quarantines"] == jeng.counters[
        "nan_quarantines"] == 2
    assert eng.pool.pages_in_use() == 0


def test_warmup_stats_and_pool_bytes(weights):
    _, _, pcfg, params = weights
    eng = PagedBatchedDecodeEngine(pcfg, device="cpu", **ENGINE_KW)
    eng.warmup(params)
    st = eng.stats()
    assert st["paged_attention"] == "gather" and st["device"] == "cpu"
    assert st["free_pages"] == eng.pool_pages - 1 and st["queue_depth"] == 0
    per_pos = 2 * 2 * 4 * 16 * 4  # layers x (k, v) x heads x head_dim x f32
    assert eng.cache_hbm_bytes()["allocated"] == eng.pool_pages * 8 * per_pos
    eng.submit(_prompt(3, 70), 2)
    with pytest.raises(RuntimeError, match="idle"):
        eng.warmup(params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_values_do_not_depend_on_neighbours(dtype):
    """A row's prefilled K/V are bit-equal whether it prefills alone or in
    one chunk forward with three other rows (GPT-2 width, 2 layers): the
    prefill forward always has the shape [slots, chunk]. Sized to the
    rows that prefill, the larger product may run another kernel with
    another summation order (in bf16 on this CPU it does)."""
    from pytorch_distributed_tpu_torch.models import gpt2

    cfg = ModelConfig(vocab_size=97, n_ctx=128, n_embd=768, n_layer=2,
                      n_head=12, dtype=dtype, attn_pdrop=0.0,
                      resid_pdrop=0.0, embd_pdrop=0.0)
    params = gpt2.init(torch.Generator().manual_seed(4), cfg, device="cpu")
    rng = np.random.default_rng(4)
    x = rng.integers(0, 97, 40)
    kv = []
    for others in ((), (50, 20, 60)):
        eng = PagedBatchedDecodeEngine(cfg, slots=4, max_len=128,
                                       page_size=16, device="cpu")
        for n in others:
            eng.submit(rng.integers(0, 97, n), 4)
        rid = eng.submit(x, 4)
        eng.step(params)  # every row prefills its first chunk together
        s = next(r for r in eng._slots if r is not None and r.rid == rid)
        pos = torch.arange(40)
        pages = torch.as_tensor(s.table)[pos // 16].long()
        kv.append([eng._cache[n][:, pages, pos % 16] for n in ("k", "v")])
    for alone, busy in zip(*kv):
        assert torch.equal(alone, busy)
