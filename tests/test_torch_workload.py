"""The port's seeded workloads (``serving/workload``) against the JAX
package's.

For one seed the two generators make the same numpy draws: prompts,
lengths, budgets, sampling configs, deadlines, arrival times and bursts
are equal element for element. The one deliberate difference is the
per-request sampling stream: the JAX key ``fold_in(key(key_seed), i)``
becomes the port's integer ``seed``, a pure function of (key_seed, i).
Ported from ``tests/test_router.py``'s workload tests (their docstrings
name them).
"""

import numpy as np
import pytest

from pytorch_distributed_tpu.serving import workload as jwl
from pytorch_distributed_tpu_torch.serving import workload as wl


def _strip(req: dict) -> dict:
    """A request without its sampling stream (JAX ``key``, port
    ``seed``)."""
    return {k: v for k, v in req.items() if k not in ("key", "seed")}


def _assert_same_requests(port, ref):
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert ("seed" in a or "key" in a) == ("seed" in b or "key" in b), i
        a, b = _strip(a), _strip(b)
        assert sorted(a) == sorted(b), i
        np.testing.assert_array_equal(a.pop("prompt"), b.pop("prompt"))
        assert a == b, i


@pytest.mark.parametrize(
    "kw",
    [
        dict(n=12, vocab_size=97, prompt_len=(3, 9), max_new=(1, 7),
             key_seed=3, p_deadline=0.4),
        dict(n=9, vocab_size=50257, prompt_len=(4, 341), max_new=24,
             key_seed=0),
        dict(n=6, vocab_size=97, prompt_len=(2, 4), max_new=2,
             shared_prefix=np.arange(10, dtype=np.int32)),
        dict(n=7, vocab_size=1024, prompt_len=(4, 64), max_new=(2, 5)),
    ],
    ids=["deadlines", "gpt2_storm", "shared_prefix", "key_seed_drawn"],
)
def test_request_stream_equals_jax(kw):
    port = wl.request_stream(np.random.default_rng(5), **kw)
    ref = jwl.request_stream(np.random.default_rng(5), **kw)
    _assert_same_requests(port, ref)


def test_request_seeds_are_a_pure_function_of_key_seed_and_index():
    """The port's per-request seed: the same for the same (key_seed, i)
    whatever the stream around it, different across i and key_seed."""
    a = wl.request_stream(np.random.default_rng(1), n=9, vocab_size=97,
                          prompt_len=(3, 5), max_new=4, key_seed=7)
    b = wl.request_stream(np.random.default_rng(2), n=12, vocab_size=97,
                          prompt_len=(6, 9), max_new=2, key_seed=7)
    seeds_a = {i: r["seed"] for i, r in enumerate(a) if "seed" in r}
    seeds_b = {i: r["seed"] for i, r in enumerate(b) if "seed" in r}
    assert seeds_a and all(seeds_b[i] == s for i, s in seeds_a.items())
    assert len(set(seeds_a.values())) == len(seeds_a)
    assert all(s == wl.request_seed(7, i) for i, s in seeds_a.items())
    assert wl.request_seed(7, 0) != wl.request_seed(8, 0)
    assert all(0 <= s < 2**63 for s in seeds_b.values())


def test_workload_generator_deterministic():
    """Ported from JAX ``test_workload_generator_deterministic``: one seed,
    one schedule — prompts, budgets, sampling configs, seeds, deadlines,
    arrivals, bursts — equal to the JAX generator's draws."""
    def draw(mod):
        rng = np.random.default_rng(5)
        reqs = mod.request_stream(
            rng, n=12, vocab_size=97, prompt_len=(3, 9),
            max_new=(1, 7), key_seed=3, p_deadline=0.4,
        )
        arr = mod.exponential_arrivals(rng, 12, 0.25)
        bursts = mod.tick_bursts(rng, 2, length=31)
        return reqs, arr, bursts

    a_reqs, a_arr, a_bursts = draw(wl)
    b_reqs, b_arr, b_bursts = draw(wl)
    j_reqs, j_arr, j_bursts = draw(jwl)
    assert np.array_equal(a_arr, b_arr) and a_bursts == b_bursts
    np.testing.assert_array_equal(a_arr, j_arr)
    assert a_bursts == j_bursts
    assert a_arr[0] == 0.0 and np.all(np.diff(a_arr) >= 0)
    _assert_same_requests(a_reqs, j_reqs)
    for ra, rb in zip(a_reqs, b_reqs):
        assert ra.get("seed") == rb.get("seed")
    assert any("temperature" in r for r in a_reqs)
    assert any("temperature" not in r for r in a_reqs)
    assert any("timeout_s" in r for r in a_reqs)


def test_workload_shared_prefix():
    """Ported from JAX ``test_workload_shared_prefix``."""
    prefix = np.arange(10, dtype=np.int32)
    reqs = wl.request_stream(
        np.random.default_rng(0), n=4, vocab_size=97, prompt_len=(2, 4),
        max_new=2, shared_prefix=prefix,
    )
    for r in reqs:
        assert np.array_equal(r["prompt"][:10], prefix)
        assert 12 <= len(r["prompt"]) <= 14


@pytest.mark.parametrize("n, mean, start", [(1, 0.5, 0.0), (40, 0.02, 0.0),
                                             (17, 1.5, 3.0), (0, 1.0, 0.0)])
def test_exponential_arrivals_equal_jax(n, mean, start):
    a = wl.exponential_arrivals(np.random.default_rng(3), n, mean, start)
    b = jwl.exponential_arrivals(np.random.default_rng(3), n, mean, start)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("max_per_tick, length", [(2, 31), (4, 997)])
def test_tick_bursts_equal_jax(max_per_tick, length):
    assert wl.tick_bursts(np.random.default_rng(9), max_per_tick, length) \
        == jwl.tick_bursts(np.random.default_rng(9), max_per_tick, length)


def test_repetitive_request_stream_equals_jax():
    kw = dict(n=8, vocab_size=97, pattern_len=(2, 5), repeats=(3, 6),
              max_new=(4, 9))
    _assert_same_requests(
        wl.repetitive_request_stream(np.random.default_rng(4), **kw),
        jwl.repetitive_request_stream(np.random.default_rng(4), **kw),
    )


def test_tiered_stream_equals_jax_and_tiers_are_independent():
    tiers = {
        "interactive": dict(n=4, prompt_len=(3, 6), max_new=4),
        "batch": dict(n=6, prompt_len=(8, 12), max_new=(2, 6)),
    }
    port = wl.tiered_stream(11, vocab_size=97, tiers=tiers)
    _assert_same_requests(port, jwl.tiered_stream(11, vocab_size=97,
                                                  tiers=tiers))
    assert [r["priority"] for r in port].count("interactive") == 4
    alone = wl.tiered_stream(11, vocab_size=97,
                             tiers={"interactive": tiers["interactive"]})
    inter = [r for r in port if r["priority"] == "interactive"]
    _assert_same_requests(alone, inter)
    with pytest.raises(ValueError, match="priority class"):
        wl.tiered_stream(0, vocab_size=97, tiers={"urgent": dict(
            n=1, prompt_len=(1, 2), max_new=1)})
