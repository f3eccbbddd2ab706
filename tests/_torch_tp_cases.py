"""Shared inputs of the port's tensor-parallel and ZeRO-3 decode tests:
the model configs, the sharpened seeded weights' scale, the request
mixes and the LoRA factors, in numpy only (the rank processes of
``_torch_tp_jobs`` import no JAX).

The weights are the JAX ``init``'s times ``SHARPEN``: at init scale a
tiny random model repeats one token, and greedy equality over such
output would say little; scaled up, its greedy tokens vary.
"""

from __future__ import annotations

import numpy as np

SHARPEN = 6.0
TP = dict(tensor=2)
ZERO3 = dict(fsdp=2)

_BASE = dict(vocab_size=97, n_ctx=64, n_embd=64, n_layer=2, n_head=4,
             dtype="float32", attn_pdrop=0.0, resid_pdrop=0.0,
             embd_pdrop=0.0)
MODELS = {
    "gpt2": dict(_BASE),
    # GQA: 4 query heads over 2 KV heads, so each of 2 tensor ranks holds
    # 2 query heads over 1 KV head (group 2).
    "llama": dict(_BASE, family="llama", activation_function="silu",
                  n_kv_head=2, n_inner=96),
    "gpt2_moe": dict(_BASE, n_experts=4, moe_top_k=2),
    "llama_moe": dict(_BASE, family="llama", activation_function="silu",
                      n_kv_head=2, n_inner=96, n_experts=4),
}
SERVING_FAMILIES = ("gpt2", "llama")

SLOTS, MAX_LEN, PAGE, CHUNK = 3, 32, 8, 8
BUCKETS = (8, 16, 32)
LORA_RANK = 4
TENANTS = ("alice", "bob")


def prompt(n: int, seed: int) -> list[int]:
    return np.random.default_rng(seed).integers(0, 97, n).tolist()


def gen_prompts() -> list[list[int]]:
    """The [2, 5] prompt of the generate paths."""
    return [prompt(5, 3), prompt(5, 4)]


def mix(sampled: bool = True) -> list[dict]:
    """More requests than slots, prompts across the buckets; with
    ``sampled``, two rows sample (seeded)."""
    reqs = [
        dict(prompt=prompt(5, 1), max_new_tokens=8),
        dict(prompt=prompt(12, 2), max_new_tokens=6),
        dict(prompt=prompt(3, 3), max_new_tokens=9),
        dict(prompt=prompt(20, 4), max_new_tokens=5),
        dict(prompt=prompt(7, 5), max_new_tokens=7),
    ]
    if sampled:
        reqs[2].update(temperature=0.8, top_k=20, seed=11)
        reqs[4].update(temperature=1.1, top_p=0.9, seed=12)
    return reqs


def draft_tail(tokens, k):
    """A speculation draft hook that always drafts, so every verify
    window has drafts to accept or reject: the row's last ``k``
    tokens."""
    return np.asarray(tokens[-k:], np.int32)


SPEC = dict(speculative_k=3, draft_hook=draft_tail)


def tenant_mix() -> list[dict]:
    """Rows of two tenants and untenanted rows."""
    reqs = mix(sampled=False)
    for r, t in zip(reqs, ("alice", None, "bob", "alice", None)):
        if t is not None:
            r["tenant"] = t
    return reqs


def lora_factors(targets: dict, seed: int, std: float = 0.3) -> dict:
    """One tenant's explicit factors for every target of ``targets``
    (``serving/adapters._targets``)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (a_shape, b_shape, _) in targets.items():
        out[name] = {
            "a": (std * rng.standard_normal(
                tuple(a_shape) + (LORA_RANK,))).astype(np.float32),
            "b": (std * rng.standard_normal(
                (b_shape[0], LORA_RANK) + tuple(b_shape[1:]))).astype(
                    np.float32),
        }
    return out


def greedy(reqs: list[dict]) -> list[bool]:
    return [not r.get("temperature") for r in reqs]
