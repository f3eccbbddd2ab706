"""Every engine of the port in ``tp`` mode (and the serial engine in
``zero3``) on two gloo CPU ranks, against the JAX package's plain
engines.

One group of two rank processes (``_torch_tp_jobs.job_serving_tp``) runs
every case for GPT-2 and Llama GQA (4 query heads over 2 KV heads, so
each rank holds 2 over 1), f32, the JAX ``init``'s weights sharpened
(``_torch_tp_cases``); the JAX side runs in this process at the same
time. The JAX package's own tests pin its TP engines equal to its plain
ones, so the port's TP engines are held to JAX's plain engines, which
compile fast:

- the serial engine (tp, zero3, streamed), the dense and paged engines
  (f32, int8 pages and weights), both speculating, LoRA tenants and a
  KV handoff between a TP prefill worker and a TP decode worker: greedy
  rows token-equal to JAX's; sampled rows equal to the port's plain
  engine (JAX's threefry stream cannot be matched);
- both ranks' outputs identical, case for case;
- a tenant's rows equal to that tenant served alone;
- the all-reduces a decode tick issues: 2 x n_layer, with 1 or 3 live
  rows, int8, adapters; each rank's pool half the plain one's;
- a real failure on one rank ends both ranks with an error, not a hang.
"""

import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

import _torch_tp_cases as C
from _torch_dist_worker import GROUP_TIMEOUT_S, launch
from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.models import decode as jdecode
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu.serving.adapters import (
    AdapterRegistry as JaxRegistry,
)
from pytorch_distributed_tpu.serving.engine import (
    BatchedDecodeEngine as JaxDense,
)
from pytorch_distributed_tpu.serving.engine import BucketSpec as JaxBuckets
from pytorch_distributed_tpu.serving.engine import (
    PagedBatchedDecodeEngine as JaxPaged,
)
from pytorch_distributed_tpu_torch.serving.adapters import _targets
from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.train.checkpoint import _flatten

LEGS = ("dense", "paged", "paged_q8", "dense_spec", "paged_spec")


def write_params(workdir, name, scale=C.SHARPEN, suffix=""):
    """The JAX params of model ``name`` times ``scale`` (sharpened by
    default), saved for the ranks as ``<name><suffix>.npz``; returns (JAX
    config, JAX params)."""
    jcfg = JaxModelConfig(**C.MODELS[name])
    params = jax.tree.map(lambda x: x * scale, jax.device_get(
        jget_model(jcfg).init(jax.random.key(0), jcfg)))
    flat: dict = {}
    _flatten("params", params, flat)
    np.savez(workdir / f"{name}{suffix}.npz", **flat)
    return jcfg, params


def read_outputs(workdir, results, n=2):
    """Each rank's ``out_<rank>.json``, or a failure showing its
    stderr."""
    outs = []
    for r in range(n):
        path = workdir / f"out_{r}.json"
        if not path.exists():
            pytest.fail(f"rank {r} wrote no results: {results[r][1][-3000:]}")
        outs.append(json.loads(path.read_text()))
    return outs


def _jax_requests(reqs):
    out = []
    for r in reqs:
        r = dict(r, prompt=np.asarray(r["prompt"], np.int32))
        if "seed" in r:
            r["key"] = jax.random.key(r.pop("seed"))
        out.append(r)
    return out


def _jtokens(results):
    return {str(rid): [r.state, np.asarray(r.tokens).tolist()]
            for rid, r in sorted(results.items())}


def _renumber(results):
    """``_jtokens`` of a second drive, its rids counted from 0."""
    first = min(results)
    return {str(rid - first): v for rid, v in
            ((int(k), v) for k, v in _jtokens(results).items())}


def _jax_refs(name, jcfg, jparams):
    # One prefill group shape per bucket (the port's dense engine always
    # prefills [slots, bucket]): fewer programs for JAX to compile.
    dense = dict(slots=C.SLOTS, max_len=C.MAX_LEN,
                 buckets=JaxBuckets(C.BUCKETS), prefill_groups=(C.SLOTS,))
    paged = dict(slots=C.SLOTS, max_len=C.MAX_LEN, page_size=C.PAGE,
                 prefill_chunk=C.CHUNK)
    want = {"generate": np.asarray(jdecode.generate(
        jparams, np.asarray(C.gen_prompts(), np.int32), jcfg, 8)).tolist()}
    mix = _jax_requests(C.mix())
    # Greedy speculation gives the plain engine's tokens; the handoff's
    # requests drive the paged engine again once idle (its programs are
    # compiled once).
    jpaged = JaxPaged(jcfg, **paged)
    want["dense"] = want["dense_spec"] = _jtokens(
        JaxDense(jcfg, **dense).run(jparams, mix))
    want["paged"] = want["paged_spec"] = _jtokens(jpaged.run(jparams, mix))
    want["paged_q8"] = _jtokens(JaxPaged(
        jcfg, kv_quant="int8", weight_quant="int8", **paged).run(jparams,
                                                                 mix))
    want["handoff"] = _renumber(jpaged.run(
        jparams, _jax_requests(C.mix(sampled=False)[:3])))
    reg = JaxRegistry(jcfg, rank=C.LORA_RANK, max_tenants=3)
    for i, tid in enumerate(C.TENANTS):
        reg.register(tid, C.lora_factors(_targets(ModelConfig(
            **C.MODELS[name])), 100 + i), scale=2.0)
    want["lora"] = _jtokens(JaxPaged(jcfg, adapters=reg, **paged).run(
        jparams, _jax_requests(C.tenant_mix())))
    return want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("serving_tp")
    weights = {name: write_params(wd, name) for name in C.SERVING_FAMILIES}
    (wd / "spec.json").write_text(json.dumps({}))
    box = {}

    def ranks():
        box["results"] = launch("serving_tp", 2, wd, timeout_s=400,
                                expect_fail=True)
        box["end"] = time.time()

    th = threading.Thread(target=ranks)
    th.start()
    # The families' JAX engines compile in threads of their own (XLA's
    # compiler runs outside the GIL).
    with ThreadPoolExecutor(len(weights)) as pool:
        want = dict(zip(weights, pool.map(lambda kv: _jax_refs(kv[0], *kv[1]),
                                          weights.items())))
    th.join()
    outs = read_outputs(wd, box["results"])
    return dict(want=want, outs=outs, wd=wd, **box)


@pytest.fixture(params=C.SERVING_FAMILIES)
def family(request, runs):
    return (request.param, runs["want"][request.param],
            runs["outs"][0]["families"][request.param])


def test_ranks_identical(runs):
    a, b = (o["families"] for o in runs["outs"])
    assert a == b


def test_serial_engine_tp_and_zero3_match_jax(family):
    _, want, got = family
    for leg in ("serial_tp", "serial_zero3"):
        assert got[leg] == want["generate"], leg
    streamed = np.asarray(got["serial_tp_stream"]).T
    assert np.asarray(want["generate"])[:, 5:].tolist() == streamed.tolist()


@pytest.mark.parametrize("leg", LEGS)
def test_batched_engines_tp_match_jax_greedy_and_plain_sampled(family, leg):
    _, want, got = family
    for rid, greedy in enumerate(C.greedy(C.mix())):
        state, toks = got[leg][str(rid)]
        assert state == "DONE", (leg, rid)
        if greedy:
            assert [state, toks] == want[leg][str(rid)], (leg, rid)
        assert [state, toks] == got[leg + "_plain"][str(rid)], (leg, rid)
    if leg.endswith("spec"):
        assert got[leg + "_counters"]["drafted_tokens"] > 0


def test_paged_pool_per_rank_is_half(family):
    _, _, got = family
    for leg in ("paged", "paged_q8", "paged_spec"):
        assert 2 * got[leg + "_pool_bytes"] == got[leg + "_plain_pool_bytes"]


def test_lora_tp_matches_jax_and_each_tenant_alone(family):
    _, want, got = family
    assert got["lora"] == want["lora"]
    reqs = C.tenant_mix()
    for tid in C.TENANTS:
        rows = [str(i) for i, r in enumerate(reqs) if r.get("tenant") == tid]
        alone = got[f"lora_alone_{tid}"]
        assert [got["lora"][r] for r in rows] == [alone[str(i)]
                                                 for i in range(len(rows))]


def test_handoff_between_tp_workers_matches_jax(family):
    name, want, got = family
    h = got["handoff"]
    assert {k: ["DONE", v] for k, v in h["tokens"].items()} == \
        want["handoff"]
    kv_local = ModelConfig(**C.MODELS[name]).kv_heads // 2
    assert all(s[3] == kv_local for s in h["page_shapes"])


def test_allreduces_per_decode_tick_are_two_per_layer(family):
    name, _, got = family
    n_layer = C.MODELS[name]["n_layer"]
    for leg, counts in got["allreduce_per_tick"].items():
        assert counts == [2 * n_layer, 2 * n_layer], leg


def test_a_failure_on_one_rank_ends_every_rank(runs):
    (rc0, err0), (rc1, err1) = runs["results"]
    wd = runs["wd"]
    assert rc1 != 0 and "injected failure on rank 1 only" in err1
    assert rc0 != 0, "rank 0 survived its partner's failure"
    assert not list(wd.glob("fail_survived_*"))
    # From the failing drive's start to both ranks' exit: well inside the
    # group's timeout (rank 0 fails on its partner's closed connection).
    waited = runs["end"] - float((wd / "fail_start_0").read_text())
    assert waited < GROUP_TIMEOUT_S, waited
