"""Multi-tenant LoRA adapters: the port against the JAX package, on the CPU.

The same explicit factors (numpy, from a seed) are registered in the JAX
``AdapterRegistry`` and the port's; weights are the JAX ``init``'s,
converted with ``interop.params_from_jax``. f32 throughout, where only
the two CPU backends' summation order differs: ``lora_delta`` within
atol 1e-6, ``forward(lora=)`` logits within atol = rtol = 1e-5, and the
engines' greedy tokens and counters equal. The port's own pins are exact:
a tenant's rows in a mixed batch are bit-equal to that tenant served
alone, untenanted rows to the adapter-less engine.
"""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.models import decode
from pytorch_distributed_tpu_torch.ops import lora_kernel as lk
from pytorch_distributed_tpu_torch.serving import (
    BatchedDecodeEngine,
    BucketSpec,
    PagedBatchedDecodeEngine,
    ReplicaRouter,
)
from pytorch_distributed_tpu_torch.serving.adapters import (
    AdapterRegistry,
    _targets,
)

RANK = 4
TENANTS = ("alice", "bob", "carol")
ENGINE_KW = dict(slots=3, max_len=32, page_size=8, prefill_chunk=8)
BUCKETS = (8, 16, 32)
COUNTERS = ("done", "failed", "aborted", "expired", "nan_quarantines",
            "dispatch_failures", "resumes", "preemptions",
            "drafted_tokens", "accepted_tokens", "spec_commits")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many tiny forwards: one intra-op thread for the module, restored
    after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kw(family):
    kw = dict(family=family, vocab_size=97, n_ctx=64, n_embd=64, n_layer=2,
              n_head=4, dtype="float32", attn_pdrop=0.0, resid_pdrop=0.0,
              embd_pdrop=0.0)
    if family == "llama":
        kw.update(n_kv_head=2, activation_function="silu")
    return kw


def _factors(cfg, seed, std=0.3):
    """One tenant's explicit factors for every target, drawn with numpy:
    large enough that tenant outputs visibly differ from the base."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (a_shape, b_shape, _) in _targets(cfg).items():
        out[name] = {
            "a": (std * rng.standard_normal(a_shape + (RANK,))).astype(
                np.float32),
            "b": (std * rng.standard_normal(
                (b_shape[0], RANK) + b_shape[1:])).astype(np.float32),
        }
    return out


def _registries(jcfg, pcfg, scale=2.0):
    jreg = JaxRegistry(jcfg, rank=RANK, max_tenants=4)
    preg = AdapterRegistry(pcfg, rank=RANK, max_tenants=4)
    for i, tid in enumerate(TENANTS):
        f = _factors(pcfg, 100 + i)
        jreg.register(tid, f, scale=scale)
        preg.register(tid, f, scale=scale)
    return jreg, preg


def _weights(family):
    kw = _kw(family)
    jcfg, pcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    jparams = jget_model(jcfg).init(jax.random.key(0), jcfg)
    params = interop.params_from_jax(jax.device_get(jparams), pcfg)
    return jcfg, jparams, pcfg, params, *_registries(jcfg, pcfg)


@pytest.fixture(scope="module", params=["gpt2", "llama"])
def weights(request):
    return _weights(request.param)


@pytest.fixture(scope="module")
def gpt2_weights():
    return _weights("gpt2")


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 97, n).astype(np.int32)


def _mix(tenanted=True):
    """Greedy requests striped over the three tenants and no tenant, more
    than the slots; two of one tenant share a 16-token prefix (only rows
    of one tenant share pages here: see
    ``test_cross_tenant_prefix_pages_carry_the_publisher_adapter``)."""
    shared = _prompt(16, 42)
    prompts = [_prompt(14, 1), np.concatenate([shared, _prompt(4, 7)]),
               _prompt(8, 2), _prompt(11, 4),
               _prompt(5, 3), np.concatenate([shared, _prompt(3, 8)]),
               _prompt(6, 5), _prompt(9, 6)]
    tenants = [*TENANTS, None] * 2
    return [
        dict(prompt=p, max_new_tokens=6 + i % 4,
             **({"tenant": t} if tenanted and t is not None else {}))
        for i, (p, t) in enumerate(zip(prompts, tenants))
    ]


def _tokens(out):
    return {rid: (r.state, np.asarray(r.tokens).tolist())
            for rid, r in out.items()}


# -- the registry -------------------------------------------------------------


def _guard_cases():
    """(name, action(registry class, cfg class), exception)."""
    def rank0(reg, cfg):
        reg(cfg(**_kw("gpt2")), rank=0)

    def tenants0(reg, cfg):
        reg(cfg(**_kw("gpt2")), rank=2, max_tenants=0)

    def moe(reg, cfg):
        reg(cfg(**_kw("gpt2"), n_experts=4), rank=2)

    def duplicate(reg, cfg):
        c = cfg(**_kw("gpt2"))
        r = reg(c, rank=RANK)
        r.register("a", _factors(c, 0))
        r.register("a", _factors(c, 1))

    def full(reg, cfg):
        c = cfg(**_kw("gpt2"))
        r = reg(c, rank=RANK, max_tenants=1)
        r.register("a", _factors(c, 0))
        r.register("b", _factors(c, 1))

    def missing(reg, cfg):
        c = cfg(**_kw("llama"))
        f = _factors(c, 0)
        del f["wo"]
        reg(c, rank=RANK).register("a", f)

    def shape(reg, cfg):
        c = cfg(**_kw("gpt2"))
        f = _factors(c, 0)
        f["q"]["b"] = f["q"]["b"][..., :2]
        reg(c, rank=RANK).register("a", f)

    def unregistered(reg, cfg):
        c = cfg(**_kw("gpt2"))
        r = reg(c, rank=RANK)
        r.register("a", _factors(c, 0))
        r.slot("zed")

    return [("rank0", rank0, ValueError), ("tenants0", tenants0, ValueError),
            ("moe", moe, NotImplementedError),
            ("duplicate", duplicate, ValueError), ("full", full, ValueError),
            ("missing", missing, ValueError), ("shape", shape, ValueError),
            ("unregistered", unregistered, ValueError)]


@pytest.mark.parametrize("name, action, exc", _guard_cases(),
                         ids=[c[0] for c in _guard_cases()])
def test_registry_guards_match_jax(name, action, exc):
    """Each guard refuses with the JAX registry's exception and message."""
    with pytest.raises(exc) as want:
        action(JaxRegistry, JaxModelConfig)
    with pytest.raises(exc) as got:
        action(AdapterRegistry, ModelConfig)
    assert str(got.value) == str(want.value)


def test_registry_layout_seed_init_and_device_memo():
    """Slots count from 1 (slot 0 stays the zero adapter), scale/rank is
    folded into B, a seeded init is nonzero and reproducible, and the
    device tree is uploaded once per version with its flattened factors
    laid out as ``lora_delta_reference`` multiplies them and the kernel's
    view of them (``kernel_args``) pointing into them."""
    cfg = ModelConfig(**_kw("gpt2"))
    reg = AdapterRegistry(cfg, rank=RANK, max_tenants=3)
    with pytest.raises(ValueError, match="seed="):
        reg.register("x")
    f = _factors(cfg, 0)
    assert reg.register("a", f, scale=8.0) == 1
    assert reg.register("s", seed=5) == 2
    again = AdapterRegistry(cfg, rank=RANK, max_tenants=3)
    again.register("a", f, scale=8.0)
    again.register("s", seed=5)
    assert reg.tenants() == ("a", "s") and reg.version == 2
    host = reg._host["q"]
    assert not host["a"][:, 0].any() and not host["b"][:, 0].any()
    np.testing.assert_array_equal(host["b"][:, 1], f["q"]["b"] * 2.0)
    assert host["a"][:, 2].any()
    np.testing.assert_array_equal(host["a"][:, 2], again._host["q"]["a"][:, 2])
    tree = reg.device_tree("cpu")
    assert reg.device_tree(torch.device("cpu")) is tree
    assert len(tree) == cfg.n_layer
    a, b = tree[1]["q"]["a"], tree[1]["q"]["b"]
    assert tuple(a.shape) == (4, 64, RANK)
    assert tuple(b.shape) == (4, RANK, 4, 16)
    np.testing.assert_array_equal(a.numpy(), host["a"][1])
    s = a.shape[0]
    torch.testing.assert_close(
        tree[1]["q"]["a_flat"], a.permute(1, 0, 2).reshape(64, s * RANK),
        rtol=0, atol=0)
    torch.testing.assert_close(
        tree[1]["q"]["b_flat"],
        b.reshape(s, RANK, -1).permute(1, 0, 2).reshape(RANK, -1),
        rtol=0, atol=0)
    assert tree[1]["q"]["kernel_args"] == (
        tree[1]["q"]["a_flat"].data_ptr(), tree[1]["q"]["b_flat"].data_ptr(),
        64, RANK, s, 64)
    reg.register("c", seed=6)
    assert reg.device_tree("cpu") is not tree


# -- the delta and the forward ------------------------------------------------


def _delta(x, lp, rows):
    """The port's plain delta for per-request ``rows`` [B] (the forward
    repeats each row's slot over its T tokens)."""
    return lk.lora_delta_reference(
        x, lp, torch.from_numpy(rows).long().repeat_interleave(x.shape[1]))


def test_lora_delta_matches_jax(weights):
    """Every target of every layer, rows on every slot: within 1e-6; a
    slot-0 row's delta is exactly zero."""
    jcfg, _, pcfg, _, jreg, preg = weights
    jtree, ptree = jreg.device_tree(), preg.device_tree("cpu")
    rng = np.random.default_rng(3)
    rows = np.array([0, 1, 2, 3, 1], np.int32)
    for name in ptree[0]:
        din = ptree[0][name]["a"].shape[1]
        x = rng.standard_normal((5, 3, din)).astype(np.float32)
        for layer in range(pcfg.n_layer):
            want = jdecode.lora_delta(
                jnp.asarray(x),
                {k: v[layer] for k, v in jtree[name].items()},
                jnp.asarray(rows))
            lp = ptree[layer][name]
            got = _delta(torch.from_numpy(x), lp, rows)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=0)
            assert not got[0].any()
            # Without the flattened forms the same values come out.
            bare = _delta(
                torch.from_numpy(x), {"a": lp["a"], "b": lp["b"]}, rows)
            torch.testing.assert_close(bare, got, rtol=0, atol=0)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_forward_lora_logits_match_jax(weights, layout):
    """A prefill and a decode step through ``forward(lora=)``, rows on
    tenants 0-3: logits within 1e-5 of JAX's; a slot-0 row's logits are
    bit-equal to the call without ``lora``."""
    jcfg, jparams, pcfg, params, jreg, preg = weights
    b, t = 3, 5
    rows = np.array([2, 0, 3], np.int32)
    ids = np.random.default_rng(1).integers(0, 97, (b, t)).astype(np.int32)
    nxt = np.random.default_rng(2).integers(0, 97, (b, 1)).astype(np.int32)
    if layout == "paged":
        tables = np.array([[1, 2], [3, 4], [5, 6]], np.int32)
        pos0 = np.zeros((b,), np.int32)

        def jcache():
            return jdecode.init_paged_cache(jcfg, 7, 4)

        def pcache():
            return decode.init_paged_cache(pcfg, 7, 4, device="cpu")

        jkw = dict(block_tables=jnp.asarray(tables))
        pkw = dict(block_tables=torch.from_numpy(tables))
    else:
        pos0 = np.zeros((b,), np.int32)

        def jcache():
            return jdecode.init_cache(jcfg, b, 16)

        def pcache():
            return decode.init_cache(pcfg, b, 16, device="cpu")

        jkw, pkw = {}, {}
    jl = (jreg.device_tree(), jnp.asarray(rows))
    pl = (preg.device_tree("cpu"), torch.from_numpy(rows))
    jc, pc, base = jcache(), pcache(), pcache()
    want, jc = jdecode.forward(jparams, jnp.asarray(ids), jcfg, jc,
                               jnp.asarray(pos0), lora=jl, **jkw)
    got, _ = decode.forward(params, torch.from_numpy(ids), pcfg, pc,
                            torch.from_numpy(pos0), lora=pl, **pkw)
    plain, _ = decode.forward(params, torch.from_numpy(ids), pcfg, base,
                              torch.from_numpy(pos0), **pkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(got[1], plain[1], rtol=0, atol=0)
    assert not torch.equal(got[0], plain[0])
    pos1 = np.full((b,), t, np.int32)
    want, _ = jdecode.forward(jparams, jnp.asarray(nxt), jcfg, jc,
                              jnp.asarray(pos1), lora=jl, **jkw)
    got, _ = decode.forward(params, torch.from_numpy(nxt), pcfg, pc,
                            torch.from_numpy(pos1), lora=pl, **pkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# -- the engines against JAX's ------------------------------------------------


def _engines(kind, jcfg, pcfg, jreg, preg):
    if kind == "dense":
        return (JaxDense(jcfg, slots=3, max_len=32,
                         buckets=JaxBuckets(BUCKETS), adapters=jreg),
                BatchedDecodeEngine(pcfg, slots=3, max_len=32,
                                    buckets=BucketSpec(BUCKETS),
                                    device="cpu", adapters=preg))
    kw = dict(ENGINE_KW, pool_pages=8)
    port_kw = {}
    if kind == "paged_kernel":
        port_kw["paged_attention"] = "kernel"
    if kind == "paged_int8":
        kw.update(kv_quant="int8", weight_quant="int8")
    if kind == "spec2":
        kw["speculative_k"] = 2
    return (JaxPaged(jcfg, paged_attention="gather", adapters=jreg, **kw),
            PagedBatchedDecodeEngine(pcfg, device="cpu", adapters=preg,
                                     **kw, **port_kw))


@pytest.mark.parametrize(
    "kind", ["paged", "paged_kernel", "paged_int8", "dense", "spec2"])
def test_mixed_tenant_batch_matches_jax_engine(weights, kind):
    """A mixed-tenant greedy batch (three tenants and untenanted rows, more
    requests than slots, preemption on the paged pool): tokens and
    counters equal to the JAX engine's with the same factors."""
    jcfg, jparams, pcfg, params, jreg, preg = weights
    jeng, peng = _engines(kind, jcfg, pcfg, jreg, preg)
    want = jeng.run(jparams, _mix())
    got = peng.run(params, _mix())
    assert _tokens(got) == _tokens(want)
    assert all(r.state == "DONE" for r in got.values())
    for c in COUNTERS:
        if c in jeng.counters:
            assert peng.counters[c] == jeng.counters[c], c
    if kind == "spec2":
        assert peng.counters["drafted_tokens"] > 0
    if kind.startswith("paged"):
        assert peng.pool.stats["prefix_hits"] == jeng.pool.stats[
            "prefix_hits"]


def _isolated(make, params, reqs, keep):
    """Tokens of ``reqs[i]`` for i in ``keep``, served alone on a fresh
    engine."""
    eng = make()
    rids = {eng.submit(**reqs[i]): i for i in keep}
    out = eng.run(params)
    return {i: np.asarray(out[rid].tokens).tolist() for rid, i in rids.items()}


@pytest.mark.parametrize("kind", ["paged", "paged_int8", "dense", "spec2"])
def test_tenant_rows_equal_isolated_runs_and_slot0_rows_the_base(weights,
                                                                  kind):
    """The isolation pins: each tenant's rows in the mixed batch equal the
    same requests on an engine serving that tenant alone; untenanted rows
    equal the adapter-less engine; some tenant row differs from the
    base (the adapters do something)."""
    jcfg, _, pcfg, params, jreg, preg = weights

    def make(adapters=preg):
        return _engines(kind, jcfg, pcfg, jreg, adapters)[1]

    reqs = _mix()
    mixed = make()
    rids = [mixed.submit(**r) for r in reqs]
    out = mixed.run(params)
    got = [np.asarray(out[rid].tokens).tolist() for rid in rids]
    base = make(adapters=None).run(params, _mix(tenanted=False))
    base = [np.asarray(base[rid].tokens).tolist() for rid in sorted(base)]
    for tid in (*TENANTS, None):
        keep = [i for i, r in enumerate(reqs) if r.get("tenant") == tid]
        alone = _isolated(make, params, reqs, keep)
        for i in keep:
            assert got[i] == alone[i], (tid, i)
            if tid is None:
                assert got[i] == base[i], i
    assert any(got[i] != base[i] for i, r in enumerate(reqs)
               if r.get("tenant"))


def test_two_tenants_share_a_prefix_pages_as_jax(gpt2_weights):
    """K/V are never adapted, so two tenants with one system prompt share
    its published pages: the prefix hits equal JAX's, and are counted."""
    jcfg, jparams, pcfg, params, jreg, preg = gpt2_weights
    shared = _prompt(16, 9)
    reqs = [dict(prompt=np.concatenate([shared, _prompt(3, 20 + i)]),
                 max_new_tokens=5, tenant=TENANTS[i % 2]) for i in range(3)]
    jeng, peng = _engines("paged", jcfg, pcfg, jreg, preg)
    for r in reqs:  # one at a time: each later one finds the pages
        jeng.run(jparams, [r])
        peng.run(params, [r])
    assert peng.pool.stats["prefix_hits"] == jeng.pool.stats[
        "prefix_hits"] == 2
    assert _tokens(peng.results) == _tokens(jeng.results)


def test_cross_tenant_prefix_pages_carry_the_publisher_adapter(weights):
    """Shared with the JAX package: the targets leave K/V projections
    alone, but the attention-output delta enters the residual stream, so
    from layer 1 on a published prefix chunk's K/V depend on the tenant
    that prefilled it. Layer 0's pages are the tokens' alone; layer 1's
    differ between a tenant's prefill and the base's — in both packages,
    by the same pages (a later tenant mapping those pages reads the
    publisher's). Held here so the property is known, not assumed."""
    jcfg, jparams, pcfg, params, jreg, preg = weights
    prompt = _prompt(16, 9)
    pools = {}
    for who, tenant in (("alice", "alice"), ("base", None)):
        jeng, peng = _engines("paged", jcfg, pcfg, jreg, preg)
        kw = {} if tenant is None else {"tenant": tenant}
        jeng.run(jparams, [dict(prompt=prompt, max_new_tokens=1, **kw)])
        peng.run(params, [dict(prompt=prompt, max_new_tokens=1, **kw)])
        pages = [1, 2]  # the first chunk's pages, allocated first
        pools[who] = (np.asarray(jeng._cache["k"])[:, pages],
                      peng._cache["k"][:, pages].numpy())
    for side in (0, 1):
        alice, base = pools["alice"][side], pools["base"][side]
        np.testing.assert_array_equal(alice[0], base[0])
        assert np.abs(alice[1] - base[1]).max() > 1e-3
    np.testing.assert_allclose(pools["alice"][1], pools["alice"][0],
                               atol=1e-5, rtol=1e-5)


def test_engine_refusals_and_registration_after_warmup(gpt2_weights):
    """A tenant needs adapters and a registered id; a registry of another
    config is refused; registering after warmup leaves ``compile_count``
    flat and the new tenant is served."""
    jcfg, _, pcfg, params, _, _ = gpt2_weights
    with pytest.raises(ValueError, match="adapter registry attached"):
        PagedBatchedDecodeEngine(pcfg, device="cpu", **ENGINE_KW).submit(
            _prompt(4, 0), 2, tenant="alice")
    other = AdapterRegistry(ModelConfig(**{**_kw("gpt2"), "n_layer": 1}),
                            rank=RANK)
    with pytest.raises(ValueError, match="different ModelConfig"):
        BatchedDecodeEngine(pcfg, slots=2, max_len=32, device="cpu",
                            adapters=other)
    reg = AdapterRegistry(pcfg, rank=RANK, max_tenants=2)
    reg.register("a", _factors(pcfg, 0))
    eng = PagedBatchedDecodeEngine(pcfg, device="cpu", adapters=reg,
                                   **ENGINE_KW)
    with pytest.raises(ValueError, match="unregistered tenant 'b'"):
        eng.submit(_prompt(4, 0), 2, tenant="b")
    warm = eng.warmup(params)
    reg.register("b", _factors(pcfg, 1))
    out = eng.run(params, [dict(prompt=_prompt(6, 1), max_new_tokens=4,
                                tenant="b")])
    assert [r.state for r in out.values()] == ["DONE"]
    assert eng.compile_count() == warm


def test_tenant_slot_survives_preemption_snapshot_and_adopt(gpt2_weights):
    """A tenant row preempted, snapshotted into a fresh engine, or adopted
    by a busy one continues with its adapter: tokens equal to the
    uninterrupted run."""
    _, _, pcfg, params, _, preg = gpt2_weights
    reqs = _mix()

    def make(**kw):
        return PagedBatchedDecodeEngine(pcfg, device="cpu", adapters=preg,
                                        **{**ENGINE_KW, **kw})

    clean = _tokens(make().run(params, reqs))
    tight = make(pool_pages=5)
    assert _tokens(tight.run(params, reqs)) == clean
    assert tight.counters["preemptions"] > 0
    eng = make()
    for r in reqs:
        eng.submit(**r)
    for _ in range(3):
        eng.step(params)
    snap = eng.snapshot()
    assert {q.tenant_slot for q in snap.pending} >= {1, 2, 3}
    fresh = make()
    fresh.restore(snap)
    assert _tokens(fresh.run(params)) == clean
    busy = make()
    mapping = busy.adopt(snap.pending)
    out = busy.run(params)
    for donor, rid in mapping.items():
        assert np.asarray(out[rid].tokens).tolist() == clean[donor][1]


# -- the router and the front door --------------------------------------------


def test_router_tenants_and_failover_keep_the_adapter(gpt2_weights):
    """Tenants pass through the router; a replica killed mid-decode hands
    its tenant rows to the survivor, which finishes them with their
    adapters: tokens equal to one engine's clean run."""
    _, _, pcfg, params, _, preg = gpt2_weights
    reqs = _mix()
    clean = PagedBatchedDecodeEngine(pcfg, device="cpu", adapters=preg,
                                     **ENGINE_KW).run(params, reqs)
    clean = [np.asarray(clean[rid].tokens).tolist() for rid in sorted(clean)]
    router = ReplicaRouter(
        lambda i: PagedBatchedDecodeEngine(
            pcfg, device="cpu", adapters=preg, retry_backoff_s=0.0,
            **ENGINE_KW), 2)
    router.warmup(params)
    rids = [router.submit(**r) for r in reqs]
    for _ in range(3):
        router.step(params)
    router.kill(0, reason="test")
    router.run(params)
    assert router.counters["failover_requests"] > 0
    got = [np.asarray(router.pop_result(rid).tokens).tolist()
           for rid in rids]
    assert got == clean
    with pytest.raises(ValueError, match="unregistered tenant"):
        router.submit(_prompt(3, 1), 2, tenant="mallory")


def test_serve_tenants_over_http():
    """``serve --tenants 2`` on the CPU: a tenant request over SSE ends
    DONE, the same request answers the same tokens on the plain path,
    and an unregistered tenant is a 400 with the registry's message."""
    from pytorch_distributed_tpu_torch.serving import serve

    args = serve.parse_args(["--preset", "tiny", "--device", "cpu",
                             "--port", "0", "--replicas", "2", "--slots",
                             "2", "--max-len", "64", "--tenants", "2",
                             "--lora-rank", "4"])
    _, _, router, server = serve.build(args)
    assert router.engines()[0].adapters is router.engines()[1].adapters
    assert router.engines()[0].adapters.tenants() == ("tenant-0", "tenant-1")

    async def http(host, port, body):
        reader, writer = await asyncio.open_connection(host, port)
        raw = json.dumps(body).encode()
        writer.write(
            b"POST /v1/generate HTTP/1.1\r\nHost: x\r\nContent-Length: "
            + str(len(raw)).encode() + b"\r\n\r\n" + raw)
        await writer.drain()
        data = await reader.read()
        writer.close()
        head, _, payload = data.partition(b"\r\n\r\n")
        return int(head.split()[1]), payload.decode()

    async def scenario():
        host, port = await server.start()
        try:
            body = {"prompt": [5, 6, 7], "max_new_tokens": 6,
                    "tenant": "tenant-1"}
            status, sse = await http(host, port, dict(body, stream=True))
            assert status == 200
            done = [json.loads(line[len("data: "):])
                    for line in sse.split("\n")
                    if line.startswith("data: ") and "state" in line]
            assert done and done[-1]["state"] == "DONE"
            status, plain = await http(host, port, body)
            assert status == 200
            assert json.loads(plain)["tokens"] == done[-1]["tokens"]
            status, err = await http(host, port, dict(body, tenant="x"))
            assert status == 400
            assert "unregistered tenant 'x'" in json.loads(err)["error"]
        finally:
            await server.stop()

    asyncio.run(scenario())


def test_lora_delta_add_on_the_cpu_is_the_plain_version(gpt2_weights):
    """On CPU tensors ``lora_delta_add`` returns ``y`` plus the plain
    version's delta cast to y's dtype (a new tensor; ``y`` untouched), and
    the strides the kernel would add through are read right: a contiguous
    output, the query third of a fused QKV output, a narrowed one, and
    none for strided elements or uneven rows."""
    _, _, pcfg, _, _, preg = gpt2_weights
    lp = preg.device_tree("cpu")[1]["q"]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 2, 64)).astype(np.float32))
    qkv = torch.from_numpy(
        rng.standard_normal((3, 2, 3, 4, 16)).astype(np.float32))
    rows = torch.tensor([0, 0, 1, 1, 3, 3])
    y = qkv[:, :, 0]
    before = y.clone()
    got = lk.lora_delta_add(y, x, lp, rows)
    torch.testing.assert_close(
        got, before + lk.lora_delta_reference(x, lp, rows), rtol=0, atol=0)
    torch.testing.assert_close(y, before, rtol=0, atol=0)
    torch.testing.assert_close(got[0], before[0], rtol=0, atol=0)  # slot 0
    torch.testing.assert_close(
        lk.lora_delta_reference(x, lp, rows),
        _delta(x, lp, np.array([0, 1, 3])), rtol=0, atol=0)
    # The c_proj form: a contiguous output, before its bias.
    cp = preg.device_tree("cpu")[0]["c_proj"]
    y2 = torch.from_numpy(rng.standard_normal((3, 2, 64)).astype(np.float32))
    got2 = lk.lora_delta_add(y2, x, cp, rows)
    torch.testing.assert_close(
        got2, y2 + lk.lora_delta_reference(x, cp, rows), rtol=0, atol=0)
    torch.testing.assert_close(got2[0], y2[0], rtol=0, atol=0)
    assert lk._row_stride(y, 64) == 3 * 64
    assert lk._row_stride(qkv[:, :1, 0], 64) == 2 * 3 * 64
    assert lk._row_stride(x, 64) == 64
    assert lk._row_stride(x[:, :, :32], 32) == 64
    assert lk._row_stride(x[:, :, ::2], 32) is None
    assert lk._row_stride(x.transpose(0, 1), 64) is None
    with pytest.raises(ValueError, match="cuda .kernel. or cpu"):
        lk.lora_delta_add(y.to("meta"), x.to("meta"), lp, rows)
