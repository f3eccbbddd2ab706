"""Seeded serving workloads: one arrival-stream generator for every
consumer (the load generator, ``chip_smoke.py``, the tests).

The port of the JAX package's ``serving/workload.py``. A robustness claim
("DONE outputs equal to a fault-free run of the same schedule") is only
meaningful when "the same schedule" is one function of the seed, so the
generator lives here. Prompts, lengths, sampling configs, deadlines and
arrival times come from the same numpy generator calls as the JAX
package's, so for one seed they are equal element for element.

Conventions:

- **Per-request seeds.** The JAX package gives each sampled request the
  key ``fold_in(key(key_seed), i)``. The port samples with a
  ``torch.Generator`` (threefry and Philox streams cannot match), so each
  sampled request gets an integer ``seed``, ``request_seed(key_seed, i)``:
  a pure function of (key_seed, request index). Requests are independent
  streams whatever engine or replica serves them.
- **Sampling configs** cycle through ``sampling_cycle`` by request index
  (greedy rows share batches with sampled ones by default).
- **Arrivals** are exponential inter-arrival times (a Poisson process).

Everything returns plain host data (numpy arrays and ``submit`` kwarg
dicts); nothing here touches a device.
"""

from __future__ import annotations

import zlib

import numpy as np

from pytorch_distributed_tpu_torch.serving.scheduler import check_priority

# Greedy rows share the stream with sampled ones: a workload without the
# mix would under-exercise per-row sampling.
DEFAULT_SAMPLING_CYCLE = (
    dict(temperature=0.8, top_k=20),
    dict(temperature=1.0, top_p=0.9),
    dict(),  # greedy
)


def request_seed(key_seed: int, i: int) -> int:
    """The sampling seed of request ``i`` in a stream built from
    ``key_seed``: a pure function of the pair, in [0, 2^63)."""
    state = np.random.SeedSequence([int(key_seed), int(i)]).generate_state(
        2, np.uint32
    )
    return int(state[0]) << 31 | int(state[1]) >> 1


def request_stream(
    rng: np.random.Generator,
    *,
    n: int,
    vocab_size: int,
    prompt_len: tuple[int, int],
    max_new: int | tuple[int, int],
    sampling_cycle=DEFAULT_SAMPLING_CYCLE,
    key_seed: int | None = None,
    shared_prefix: np.ndarray | None = None,
    p_deadline: float = 0.0,
    deadline_range: tuple[float, float] = (0.5, 4.0),
) -> list[dict]:
    """The seeded request schedule: a list of ``engine.submit`` /
    ``router.submit`` kwarg dicts (prompt, max_new_tokens, sampling
    config, per-request ``seed``, optional ``timeout_s`` deadline).

    ``prompt_len`` draws uniformly over [lo, hi] inclusive (the random
    TAIL length when ``shared_prefix`` is given); ``max_new`` is fixed or
    a [lo, hi] draw; ``p_deadline`` attaches a ``timeout_s`` drawn from
    ``deadline_range`` to that fraction of requests (engine-clock seconds).
    ``key_seed`` defaults to a draw from ``rng`` so the whole stream stays
    a pure function of the caller's seed either way."""
    if key_seed is None:
        key_seed = int(rng.integers(0, 2**31 - 1))
    lo, hi = prompt_len
    reqs: list[dict] = []
    for i in range(n):
        tp = int(rng.integers(lo, hi + 1))
        tail = rng.integers(0, vocab_size, (tp,)).astype(np.int32)
        prompt = (
            tail if shared_prefix is None
            else np.concatenate([np.asarray(shared_prefix, np.int32), tail])
        )
        mn = (
            int(max_new) if isinstance(max_new, int)
            else int(rng.integers(max_new[0], max_new[1] + 1))
        )
        kw = dict(sampling_cycle[i % len(sampling_cycle)])
        if kw.get("temperature"):
            kw["seed"] = request_seed(key_seed, i)
        # The deadline draws happen unconditionally, so request content
        # downstream of request i is the same with or without deadlines.
        u, d = rng.random(), float(rng.uniform(*deadline_range))
        if u < p_deadline:
            kw["timeout_s"] = d
        reqs.append(dict(prompt=prompt, max_new_tokens=mn, **kw))
    return reqs


def repetitive_request_stream(
    rng: np.random.Generator,
    *,
    n: int,
    vocab_size: int,
    pattern_len: tuple[int, int] = (2, 5),
    repeats: tuple[int, int] = (3, 6),
    max_new: int | tuple[int, int] = 16,
) -> list[dict]:
    """Seeded self-repetitive greedy traffic: each prompt is a per-request
    random pattern tiled ``repeats`` times (the traffic prompt-lookup
    speculation is for; all rows greedy)."""
    lo, hi = pattern_len
    reqs: list[dict] = []
    for _ in range(n):
        pat = rng.integers(
            0, vocab_size, (int(rng.integers(lo, hi + 1)),)
        ).astype(np.int32)
        prompt = np.tile(pat, int(rng.integers(repeats[0], repeats[1] + 1)))
        mn = (
            int(max_new) if isinstance(max_new, int)
            else int(rng.integers(max_new[0], max_new[1] + 1))
        )
        reqs.append(dict(prompt=prompt, max_new_tokens=mn))
    return reqs


def tiered_stream(
    seed: int,
    *,
    vocab_size: int,
    tiers: dict[str, dict],
) -> list[dict]:
    """Mixed-SLO arrival stream: ``tiers`` maps a priority class name
    (``serving/scheduler``) to ``request_stream`` kwargs (``n``,
    ``prompt_len``, ``max_new``, ...). Entries carry ``priority=`` and
    interleave proportionally by index. Each tier's content derives from
    (seed, tier name) alone: adding or dropping a tier never changes
    another tier's prompts, seeds or sampling draws."""
    tagged: list[tuple[float, int, int, dict]] = []
    for tier, kw in tiers.items():
        check_priority(tier)
        sub = np.random.default_rng([zlib.crc32(tier.encode()), seed])
        reqs = request_stream(sub, vocab_size=vocab_size, **kw)
        for i, r in enumerate(reqs):
            r["priority"] = tier
            tagged.append(
                ((i + 0.5) / len(reqs), check_priority(tier), i, r)
            )
    return [r for *_, r in sorted(tagged, key=lambda e: e[:3])]


def disagg_stream(
    seed: int,
    *,
    n: int,
    vocab_size: int,
    p_heavy_prefill: float = 0.5,
    heavy_prompt_len: tuple[int, int] = (96, 160),
    heavy_max_new: tuple[int, int] = (4, 8),
    light_prompt_len: tuple[int, int] = (8, 24),
    light_max_new: tuple[int, int] = (24, 48),
    sampling_cycle=DEFAULT_SAMPLING_CYCLE,
) -> list[dict]:
    """The disaggregation workload: a seeded mix of ``heavy_prefill`` rows
    (long prompt, short decode: the chunked prefill that stalls a
    colocated engine's decode ticks) and ``light`` rows (short prompt,
    long decode: the interactive traffic whose inter-token p99 that stall
    inflates). Each dict is a ``submit`` kwarg set plus a ``"kind"`` tag
    the caller pops before submitting.

    Request ``i``'s class draw, lengths and tokens come from its own
    ``default_rng([crc32("disagg"), seed, i])`` substream (equal to the
    JAX package's), and a sampled request's ``seed`` is
    ``request_seed(seed, i)``: truncating, extending or re-partitioning
    the stream never perturbs another request."""
    reqs: list[dict] = []
    for i in range(n):
        sub = np.random.default_rng([zlib.crc32(b"disagg"), seed, i])
        heavy = bool(sub.random() < p_heavy_prefill)
        lo, hi = heavy_prompt_len if heavy else light_prompt_len
        tp = int(sub.integers(lo, hi + 1))
        prompt = sub.integers(0, vocab_size, (tp,)).astype(np.int32)
        mlo, mhi = heavy_max_new if heavy else light_max_new
        mn = int(sub.integers(mlo, mhi + 1))
        kw = dict(sampling_cycle[i % len(sampling_cycle)])
        if kw.get("temperature"):
            kw["seed"] = request_seed(seed, i)
        reqs.append(dict(
            kind="heavy_prefill" if heavy else "light",
            prompt=prompt, max_new_tokens=mn, **kw,
        ))
    return reqs


def session_stream(
    rng: np.random.Generator,
    *,
    n_sessions: int,
    turns: int,
    vocab_size: int,
    open_len: tuple[int, int],
    turn_len: tuple[int, int],
    max_new: int | tuple[int, int],
    sampling_cycle=DEFAULT_SAMPLING_CYCLE,
    key_seed: int | None = None,
) -> list[list[dict]]:
    """The seeded multi-turn chat schedule: ``n_sessions`` scripts of
    ``turns`` turn dicts, each ``{"tail": [t] int32 tokens,
    "max_new_tokens": n, <sampling kwargs>}`` — the caller submits
    ``concat(recorded transcript, tail)`` as the turn's prompt. Turn 1's
    tail draws ``open_len`` tokens, later turns ``turn_len``; a sampled
    turn's seed is ``request_seed(key_seed, session * turns + turn)``."""
    if key_seed is None:
        key_seed = int(rng.integers(0, 2**31 - 1))
    sessions: list[list[dict]] = []
    for s in range(n_sessions):
        script: list[dict] = []
        for t in range(turns):
            lo, hi = open_len if t == 0 else turn_len
            tail = rng.integers(
                0, vocab_size, (int(rng.integers(lo, hi + 1)),)
            ).astype(np.int32)
            mn = (
                int(max_new) if isinstance(max_new, int)
                else int(rng.integers(max_new[0], max_new[1] + 1))
            )
            kw = dict(sampling_cycle[(s * turns + t) % len(sampling_cycle)])
            if kw.get("temperature"):
                kw["seed"] = request_seed(key_seed, s * turns + t)
            script.append(dict(tail=tail, max_new_tokens=mn, **kw))
        sessions.append(script)
    return sessions


def exponential_arrivals(
    rng: np.random.Generator, n: int, mean_interarrival_s: float,
    start: float = 0.0,
) -> np.ndarray:
    """Arrival timestamps of a Poisson process: the first request lands
    at ``start``, the rest follow exponential inter-arrival gaps."""
    if n < 1:
        return np.zeros((0,))
    gaps = rng.exponential(mean_interarrival_s, n - 1)
    return start + np.concatenate([[0.0], np.cumsum(gaps)])


def tick_bursts(
    rng: np.random.Generator, max_per_tick: int, length: int = 997
) -> list[int]:
    """Seeded per-tick arrival burst sizes (0..max_per_tick inclusive) for
    tick-driven loops: bursty, seed-reproducible churn without a wall
    clock."""
    return [int(rng.integers(0, max_per_tick + 1)) for _ in range(length)]
