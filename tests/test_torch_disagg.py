"""Disaggregated prefill/decode serving: the port against the JAX package,
on the CPU.

A fleet of one PREFILL worker and one DECODE worker behind the router
hands every finished prefill's KV pages to the decode worker; its DONE
tokens must equal a colocated engine's request for request, and on
greedy requests the JAX package's disaggregated fleet's, with equal
``handoffs`` and page ledgers. Weights are the JAX ``init``'s converted
with ``interop.params_from_jax``; f32, tiny shapes. Token comparisons are
exact (no tolerance); the export/import round trip is bit-exact in f32,
bf16 and int8 (scale pools included).
"""

import logging

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.models import gpt2 as jgpt2
from pytorch_distributed_tpu.serving.engine import (
    PagedBatchedDecodeEngine as JaxEngine,
)
from pytorch_distributed_tpu.serving.router import (
    ReplicaRouter as JaxRouter,
)
from pytorch_distributed_tpu.serving.workload import (
    disagg_stream as jax_disagg_stream,
)
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.serving import (
    PagedBatchedDecodeEngine,
    ReplicaRouter,
    RouterOverloaded,
)
from pytorch_distributed_tpu_torch.serving.adapters import AdapterRegistry
from pytorch_distributed_tpu_torch.serving.chaos import (
    ChaosDispatchError,
    ChaosDroppedResult,
)
from pytorch_distributed_tpu_torch.serving.engine import (
    ENGINE_ROLES,
    KVHandoff,
    kv_bytes_per_position,
)
from pytorch_distributed_tpu_torch.serving.workload import (
    disagg_stream,
    request_seed,
)

CFG_KW = dict(
    vocab_size=97, n_ctx=64, n_embd=64, n_layer=2, n_head=4,
    dtype="float32", attn_pdrop=0.0, resid_pdrop=0.0, embd_pdrop=0.0,
)
PAGED_KW = dict(slots=3, max_len=32, page_size=8, prefill_chunk=8)
HANDOFF_KEYS = {"event", "rid", "from_replica", "to_replica", "pages",
                "bytes", "useful_bytes", "export_s", "latency_s", "t"}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many tiny forwards: one intra-op thread for the module, restored
    after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxModelConfig(**CFG_KW)
    jparams = jgpt2.init(jax.random.key(0), jcfg)
    pcfg = ModelConfig(**CFG_KW)
    return jcfg, jparams, pcfg, interop.params_from_jax(
        jax.device_get(jparams), pcfg)


def _reqs(n=6, seed=7, sampled=False):
    """The JAX test's request shapes; greedy (JAX parity) or sampled with
    per-request seeds (the port against itself)."""
    rng = np.random.default_rng(seed)
    shapes = [(11, 6), (4, 9), (17, 5), (7, 7), (13, 8), (5, 10)][:n]
    return [
        dict(prompt=rng.integers(1, 97, size=tp).astype(np.int32),
             max_new_tokens=mn,
             **(dict(temperature=0.8, seed=100 + i) if sampled else {}))
        for i, (tp, mn) in enumerate(shapes)
    ]


def _factory(cfg, roles=("prefill", "decode"), **kw):
    kw = {**PAGED_KW, "retry_backoff_s": 0.0, **kw}

    def make_engine(rep_id):
        return PagedBatchedDecodeEngine(cfg, role=roles[rep_id],
                                        device="cpu", **kw)

    return make_engine


def _jax_factory(cfg, roles=("prefill", "decode"), **kw):
    kw = {**PAGED_KW, **kw}

    def make_engine(rep_id):
        return JaxEngine(cfg, role=roles[rep_id], paged_attention="gather",
                         **kw)

    return make_engine


def _reference(cfg, params, reqs, **kw):
    eng = PagedBatchedDecodeEngine(cfg, device="cpu", **{**PAGED_KW, **kw})
    rids = [eng.submit(**r) for r in reqs]
    eng.run(params)
    return [np.asarray(eng.pop_result(r).tokens).tolist() for r in rids]


def _drain(router, params, rids):
    router.run(params)
    return [np.asarray(router.pop_result(r).tokens).tolist() for r in rids]


class _EventTap(logging.Handler):
    """Capture ``event=<name> k=v ...`` lines of ``pdtpu.serving``."""

    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.events = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("event="):
            fields = dict(p.split("=", 1) for p in msg.split(" ")
                          if "=" in p)
            self.events.append({"event": fields.pop("event"), **fields})

    def __enter__(self):
        self._lg = logging.getLogger("pdtpu.serving")
        self._saved = (self._lg.level, self._lg.propagate)
        self._lg.addHandler(self)
        self._lg.setLevel(logging.DEBUG)
        self._lg.propagate = False
        return self

    def __exit__(self, *exc):
        self._lg.removeHandler(self)
        self._lg.setLevel(self._saved[0])
        self._lg.propagate = self._saved[1]
        return False


# -- the workload -------------------------------------------------------------


@pytest.mark.parametrize("seed, kw", [
    (3, {}),
    (0, dict(heavy_prompt_len=(96, 128), light_prompt_len=(8, 16),
             light_max_new=(16, 24))),
    (11, dict(p_heavy_prefill=0.2)),
])
def test_disagg_stream_draws_equal_jax(seed, kw):
    """Class draw, lengths and tokens equal to JAX's request for request;
    a sampled request carries ``request_seed(seed, i)`` where JAX carries
    a key."""
    got = disagg_stream(seed, n=24, vocab_size=97, **kw)
    want = jax_disagg_stream(seed, n=24, vocab_size=97, **kw)
    assert len(got) == len(want) == 24
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["kind"] == w["kind"]
        np.testing.assert_array_equal(g["prompt"], w["prompt"])
        assert g["max_new_tokens"] == w["max_new_tokens"]
        assert ("key" in w) == ("seed" in g)
        if "seed" in g:
            assert g["seed"] == request_seed(seed, i)
        assert {k for k in g if k != "seed"} == {k for k in w if k != "key"}
    assert {r["kind"] for r in got} == {"heavy_prefill", "light"}
    short = disagg_stream(seed, n=5, vocab_size=97, **kw)
    for a, b in zip(short, got):
        np.testing.assert_array_equal(a["prompt"], b["prompt"])


# -- the engine's role gates --------------------------------------------------


def test_roles_report_and_gate_as_jax(weights):
    """``stats()["role"]``; a bad role, a decode worker's ``submit`` and a
    prefill worker's ``import_handoff`` are refused with JAX's messages; a
    geometry mismatch is refused and ``can_import_handoff`` says no."""
    jcfg, jparams, pcfg, params = weights
    assert ENGINE_ROLES == ("colocated", "prefill", "decode")
    for role in ENGINE_ROLES:
        eng = PagedBatchedDecodeEngine(pcfg, role=role, device="cpu",
                                       **PAGED_KW)
        assert eng.stats()["role"] == role
    errs = []
    for cfg, make in ((jcfg, lambda **k: JaxEngine(jcfg, **k, **PAGED_KW)),
                      (pcfg, lambda **k: PagedBatchedDecodeEngine(
                          pcfg, device="cpu", **k, **PAGED_KW))):
        got = []
        for action in (
            lambda: make(role="bogus"),
            lambda: make(role="decode").submit(
                np.arange(1, 5, dtype=np.int32), 3),
            lambda: make(role="prefill").import_handoff(None),
        ):
            with pytest.raises(ValueError) as info:
                action()
            got.append(str(info.value))
        errs.append(got)
    assert errs[0] == errs[1]
    pre = PagedBatchedDecodeEngine(pcfg, role="prefill", device="cpu",
                                   **PAGED_KW)
    rid = pre.submit(np.arange(1, 10, dtype=np.int32), 3)
    while not pre.handoff_ready():
        pre.step(params)
    h = pre.export_handoff(rid)
    other = PagedBatchedDecodeEngine(pcfg, role="decode", device="cpu",
                                     slots=3, max_len=32, page_size=16,
                                     prefill_chunk=16)
    with pytest.raises(ValueError, match="geometry"):
        other.import_handoff(h)
    assert not other.can_import_handoff(h)
    colo = PagedBatchedDecodeEngine(pcfg, device="cpu", **PAGED_KW)
    assert colo.handoff_ready() == [] and colo.can_import_handoff(h)


@pytest.mark.parametrize("variant", ["float32", "bfloat16", "int8"])
def test_export_import_round_trip_is_bit_exact(weights, variant):
    """A parked row's pages land bit-exact in the decode worker's pool at
    the pages it allocated (int8: values and scale pools); the export is a
    copy — overwriting the source pages after ``complete_handoff`` leaves
    the shipped tensors and the imported row's tokens unchanged; only the
    first n_pages entries are written (the padding is never copied)."""
    _, _, pcfg, params = weights
    kw = {}
    if variant == "int8":
        kw["kv_quant"] = "int8"
    else:
        pcfg = pcfg.replace(dtype=variant)
    pre = PagedBatchedDecodeEngine(pcfg, role="prefill", device="cpu",
                                   **PAGED_KW, **kw)
    dec = PagedBatchedDecodeEngine(pcfg, role="decode", device="cpu",
                                   **PAGED_KW, **kw)
    ref = PagedBatchedDecodeEngine(pcfg, device="cpu", **PAGED_KW, **kw)
    req = dict(prompt=np.arange(3, 22, dtype=np.int32), max_new_tokens=6)
    want = np.asarray(ref.run(params, [req])[0].tokens).tolist()
    rid = pre.submit(**req)
    while not pre.handoff_ready():
        pre.step(params)
    h = pre.export_handoff(rid)
    assert isinstance(h, KVHandoff) and h.n_pages == 3
    assert set(h.pages) == set(pre._cache)
    src = pre._slots[0].table[: h.n_pages].copy()
    shipped = {k: v.clone() for k, v in h.pages.items()}
    for k, v in h.pages.items():
        assert tuple(v.shape[:2]) == (pcfg.n_layer, pre.max_pages)
        assert v.data_ptr() != pre._cache[k].data_ptr()
    assert h.useful_bytes == (h.n_pages * 8
                              * kv_bytes_per_position(pcfg, pre.kv_quant))
    assert h.wire_bytes == sum(v.numel() * v.element_size()
                               for v in h.pages.values())
    before = dec.pool.stats["handoff_pages_in"]
    new = dec.import_handoff(h)
    assert new is not None
    table = dec._slots[0].table[: h.n_pages]
    for k in pre._cache:
        torch.testing.assert_close(dec._cache[k][:, table],
                                   pre._cache[k][:, src], rtol=0, atol=0)
    pre.complete_handoff(rid)
    for k, v in pre._cache.items():
        v[:, src] = 7 if v.dtype == torch.int8 else 7.5
    for k, v in h.pages.items():
        torch.testing.assert_close(v, shipped[k], rtol=0, atol=0)
    assert dec.pool.stats["handoff_pages_in"] - before == h.n_pages
    assert pre.pool.stats["handoff_pages_out"] == h.n_pages
    assert pre.counters["handoffs_out"] == dec.counters["handoffs_in"] == 1
    out = dec.run(params)
    assert np.asarray(out[new].tokens).tolist() == want


# -- the fleet ----------------------------------------------------------------


def _jax_fleet(jcfg, jparams, reqs, **kw):
    with _EventTap() as tap:
        router = JaxRouter(_jax_factory(jcfg, **kw), 2)
        router.warmup(jparams)
        rids = [router.submit(**r) for r in reqs]
        toks = _drain(router, jparams, rids)
    return router, toks, tap.events


def _port_fleet(pcfg, params, reqs, **kw):
    with _EventTap() as tap:
        router = ReplicaRouter(_factory(pcfg, **kw), 2)
        router.warmup(params)
        rids = [router.submit(**r) for r in reqs]
        toks = _drain(router, params, rids)
    return router, toks, tap.events


def _ledger(router):
    return {rep: {k: st["counters"].get(k) for k in ("handoffs_in",
                                                      "handoffs_out")}
            for rep, st in router.stats()["replicas"].items()}


def _pool_ledger(router):
    return [(e.pool.stats["handoff_pages_in"],
             e.pool.stats["handoff_pages_out"])
            for e in (r.engine for r in router._replicas)]


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_disagg_fleet_equals_colocated_and_jax(weights, kv_quant):
    """Greedy requests: the port's disaggregated fleet == one colocated
    port engine == the JAX disaggregated fleet, token for token, with
    equal ``handoffs`` and page ledgers and ``compile_count`` flat; every
    ``kv_handoff`` and ``role_assign`` event carries JAX's keys."""
    jcfg, jparams, pcfg, params = weights
    kw = {} if kv_quant == "none" else {"kv_quant": kv_quant}
    reqs = _reqs()
    ref = _reference(pcfg, params, reqs, **kw)
    jrouter, jtoks, jevents = _jax_fleet(jcfg, jparams, reqs, **kw)
    router, toks, events = _port_fleet(pcfg, params, reqs, **kw)
    assert toks == ref == jtoks
    assert router.counters["handoffs"] == jrouter.counters["handoffs"] == 6
    assert _ledger(router) == _ledger(jrouter)
    assert _pool_ledger(router) == _pool_ledger(jrouter)
    assert all(v == 0 for v in router.steady_compiles().values())
    st = router.stats()["replicas"]
    assert (st[0]["role"], st[1]["role"]) == ("prefill", "decode")
    for name in ("kv_handoff", "role_assign"):
        mine = [e for e in events if e["event"] == name]
        theirs = [e for e in jevents if e["event"] == name]
        assert len(mine) == len(theirs) > 0
        assert {frozenset(e) for e in mine} == {frozenset(e)
                                               for e in theirs}
    hand = [e for e in events if e["event"] == "kv_handoff"]
    assert set(hand[0]) == HANDOFF_KEYS
    jhand = [e for e in jevents if e["event"] == "kv_handoff"]
    for key in ("rid", "from_replica", "to_replica", "pages", "bytes",
                "useful_bytes"):
        assert [e[key] for e in hand] == [e[key] for e in jhand], key


def test_disagg_fleet_equals_colocated_on_sampled_rows(weights):
    """Sampled requests (per-request seeds): the disaggregated fleet's
    tokens equal one colocated engine's — a handed-off row keeps its
    seed and its token index."""
    _, _, pcfg, params = weights
    reqs = _reqs(sampled=True)
    _, toks, _ = _port_fleet(pcfg, params, reqs)
    assert toks == _reference(pcfg, params, reqs)


def test_router_role_pins_both_directions(weights):
    """Fresh prompts never land on the DECODE worker; handoffs and
    failover re-adoption never land on the PREFILL worker; sessions need a
    colocated replica; an all-decode fleet admits nothing."""
    _, _, pcfg, params = weights
    router = ReplicaRouter(_factory(pcfg), 2)
    router.warmup(params)
    pre, dec = router._replicas
    assert router._admissible(dec) is None
    assert router._admissible(pre) is not None
    assert router._least_loaded() is pre
    assert router._least_loaded(colocated_only=True) is None
    with pytest.raises(RuntimeError, match="colocated"):
        router.open_session()
    rid = router.submit(**_reqs(1)[0])
    while not pre.engine.handoff_ready():
        pre.engine.step(params)
    h = pre.engine.export_handoff(pre.engine.handoff_ready()[0])
    assert router._handoff_target(h) is dec
    router.run(params)
    assert router.pop_result(rid).state == "DONE"
    assert pre.engine.counters["handoffs_out"] == 1
    assert dec.engine.counters["handoffs_in"] == 1
    lonely = ReplicaRouter(_factory(pcfg, roles=("decode",)), 1)
    with pytest.raises(RouterOverloaded):
        lonely.submit(np.arange(1, 5, dtype=np.int32), 3)


def _fault_leg(router, params, reqs, which):
    rids = [router.submit(**r) for r in reqs]
    if which == "prefill":
        router.step(params)  # prefill chunks in flight, rows parked
        router.kill(0, reason="chaos: prefill death mid-handoff")
        assert router.stats()["orphans"] > 0  # decode cannot adopt them
        router.restart(0, params)
    else:
        for _ in range(60):
            router.step(params)
            if router.stats()["replicas"][1]["active_rows"]:
                break
        else:
            pytest.fail("decode worker never received a handoff")
        router.kill(1, reason="chaos: decode death with imported rows")
        router.restart(1, params)
    return _drain(router, params, rids)


@pytest.mark.parametrize("which", ["prefill", "decode"])
def test_worker_death_mid_handoff_equals_clean_and_jax(weights, which):
    """The PREFILL worker dies with rows parked (orphans until it
    restarts), or the DECODE worker dies holding imported rows (they come
    back as resume entries, re-prefilled on the prefill side and handed
    off again): tokens equal the clean run and the JAX fleet's under the
    same script; ``compile_count`` flat."""
    jcfg, jparams, pcfg, params = weights
    reqs = _reqs()
    ref = _reference(pcfg, params, reqs)
    jrouter = JaxRouter(_jax_factory(jcfg), 2)
    jrouter.warmup(jparams)
    router = ReplicaRouter(_factory(pcfg), 2)
    router.warmup(params)
    assert _fault_leg(router, params, reqs, which) == ref
    assert _fault_leg(jrouter, jparams, reqs, which) == ref
    assert router.counters["handoffs"] == jrouter.counters["handoffs"]
    assert all(v == 0 for v in router.steady_compiles().values())


def test_role_reassignment_churn_keeps_compile_count_flat(weights):
    """Restarting a colocated fleet as prefill/decode pays each role's
    warmup once and nothing after; tokens equal the reference both ways."""
    _, _, pcfg, params = weights
    reqs = _reqs()
    ref = _reference(pcfg, params, reqs)
    roles = ["colocated", "colocated"]
    router = ReplicaRouter(
        lambda i: PagedBatchedDecodeEngine(pcfg, role=roles[i],
                                           device="cpu", **PAGED_KW), 2)
    router.warmup(params)
    assert _drain(router, params, [router.submit(**r) for r in reqs]) == ref
    assert router.counters["handoffs"] == 0
    roles[:] = ["prefill", "decode"]
    with _EventTap() as tap:
        for rep in (0, 1):
            router.kill(rep, reason="role reassignment")
            router.restart(rep, params)
    assigned = [(e["replica"], e["role"]) for e in tap.events
                if e["event"] == "role_assign"]
    assert assigned == [("0", "prefill"), ("1", "decode")]
    assert _drain(router, params, [router.submit(**r) for r in reqs]) == ref
    assert router.counters["handoffs"] == len(reqs)
    assert all(v == 0 for v in router.steady_compiles().values())


def test_tenant_row_handed_off_keeps_its_adapter(weights):
    """A tenant's row prefilled on the prefill worker decodes on the
    decode worker with its adapter: tokens equal one colocated engine
    serving the same tenants (and differ from the base)."""
    _, _, pcfg, params = weights
    reg = AdapterRegistry(pcfg, rank=4, max_tenants=2)
    reg.register("t0", seed=1, scale=400.0)
    reg.register("t1", seed=2, scale=400.0)
    reqs = [dict(r, tenant=("t0", "t1", None)[i % 3])
            for i, r in enumerate(_reqs())]
    ref = _reference(pcfg, params, reqs, adapters=reg)
    _, toks, _ = _port_fleet(pcfg, params, reqs, adapters=reg)
    assert toks == ref
    base = _reference(pcfg, params,
                      [{k: v for k, v in r.items() if k != "tenant"}
                       for r in reqs])
    assert any(t != b for t, b in zip(toks, base))


class _FailCopies:
    """A fault injector failing chosen page copies of one kind: the n-th
    copy (1-based) in ``before`` raises before it runs, in ``after`` after
    it ran (a lost result)."""

    def __init__(self, kind, before=(), after=()):
        self.kind, self.before, self.after = kind, set(before), set(after)
        self.seen = 0

    def on_tick(self, tick):
        pass

    def before_dispatch(self, kind, tick):
        if kind == self.kind:
            self.seen += 1
            if self.seen in self.before:
                raise ChaosDispatchError(f"injected {kind} failure")

    def after_dispatch(self, kind, tick, toks, bad):
        if kind == self.kind and self.seen in self.after:
            raise ChaosDroppedResult(f"injected {kind} result loss")
        return toks, bad


def test_failed_page_copies_recover(weights):
    """``kv_export`` and ``kv_import`` are dispatch kinds the fault
    injector can fail: a failed export leaves the row parked and it ships
    on a later tick; a failed import is recovered like a failed forward
    (pool reset, rows requeued, the source row untouched and re-offered).
    Tokens equal the clean run."""
    _, _, pcfg, params = weights
    reqs = _reqs()
    ref = _reference(pcfg, params, reqs)
    router = ReplicaRouter(_factory(pcfg), 2)
    router.warmup(params)
    pre, dec = (r.engine for r in router._replicas)
    pre.set_fault_injector(_FailCopies("kv_export", before=[2]))
    dec.set_fault_injector(_FailCopies("kv_import", before=[3],
                                       after=[5]))
    toks = _drain(router, params, [router.submit(**r) for r in reqs])
    assert toks == ref
    assert pre.counters["dispatch_failures"] == 1
    assert dec.counters["dispatch_failures"] == 2
    assert dec.counters["resumes"] > 0  # the reset requeued live rows
    assert router.counters["handoffs"] == len(reqs)
