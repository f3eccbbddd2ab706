"""Multi-tenant LoRA adapters for the batched serving engines.

The port of the JAX package's ``serving/adapters.py``. N tenants
fine-tune one base model with low-rank deltas; serving them as N engines
would cost N param trees, N KV pools and N warmups. Instead the adapters
ride the existing forwards as per-row terms: every forward of an engine
built with ``adapters=`` takes (a) the registry's adapters — per layer,
``[slots, ...]`` low-rank factors, tenant slot 0 permanently the ZERO
adapter — and (b) a ``[B]`` tenant-slot vector, and
``models/decode.forward`` adds each row's delta to the adapted
projections (``ops/lora_kernel.lora_delta_add``: the JAX package's
lowering on the CPU, one fused kernel on the card). Consequences:

- **No new shapes**: the factors are preallocated at ``max_tenants + 1``
  slots, so registering a tenant changes values, never shapes, and never
  what ``warmup`` loaded (``compile_count`` stays flat across a
  registration).
- **Per-tenant isolation**: row b's delta reads only slot ``tenants[b]``
  (an exact selection, no cross-row term), so a tenant's rows in a mixed
  batch are bit-equal to the same requests on an engine serving that
  tenant alone, and slot-0 rows are bit-equal to the adapter-less engine
  (adding exact zeros is exact).
- **Prefix pages are shared across tenants**: no K or V projection is
  adapted, and prefix-cache keys carry no tenant, so two tenants sharing a
  system prompt share its pages. Layer 0's K/V are the tokens' alone; from
  layer 1 on they also carry the attention-output delta of the tenant that
  prefilled the chunk, which a later tenant mapping the pages reads. The
  JAX package behaves the same (``tests/test_torch_lora.py`` holds both).

Targets (classic LoRA attention placement, K/V excluded by design):
gpt2 ``q`` (the query third of the fused c_attn output) and ``c_proj``
(attention output); llama ``wq`` and ``wo``.

Registration is host-side and rare; ``device_tree(device)`` keeps one
upload per (registry version, device), so replicas sharing a card share
it. Random factors come from an integer ``seed`` through a
``torch.Generator`` (JAX's threefry draw cannot be reproduced); explicit
factors are the deployment path.

Tensor parallelism (``partition_specs``, ``device_tree(shard=)``): the
factors shard with their projections — a column-parallel target (gpt2
``q``, llama ``wq``) shards B's output axis with the base weight, a
row-parallel one (``c_proj``, ``wo``) shards A's contracting dim, so its
delta is a partial that joins the base partial before the projection's
one all-reduce (``ops/layers.dense_epilogue``): adapters add no
collective. ``ops/lora_kernel.lora_delta_add`` runs on the sliced factors
unchanged: it reads its sizes from them.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.ops import lora_kernel
from pytorch_distributed_tpu_torch.utils.logging import log_event


def _targets(cfg: ModelConfig) -> dict[str, tuple[tuple, tuple, int | None]]:
    """target name -> (A shape, B shape, TP axis), the shapes per tenant
    WITH the leading layer dim ([L, in..] / [L, out..]; the registry
    appends or inserts the rank dim); the TP axis is the B-factor axis
    that shards under tensor parallelism, None for a row-parallel target
    (``partition_specs``)."""
    l, e = cfg.n_layer, cfg.n_embd
    h, d = cfg.n_head, cfg.head_dim
    if cfg.family == "gpt2":
        return {
            "q": ((l, e), (l, h, d), 1),  # query third of fused c_attn
            "c_proj": ((l, e), (l, e), None),  # attention out (row-par)
        }
    if cfg.family == "llama":
        return {
            "wq": ((l, e), (l, h * d), 1),
            "wo": ((l, h * d), (l, e), None),
        }
    raise KeyError(f"unknown model family {cfg.family!r}")


class AdapterRegistry:
    """Per-tenant low-rank adapter store for ONE model config. Build once
    and share across every replica engine (the router's ``make_engine``
    closure): tenant slots are then the same on every replica, so failover
    adoption keeps each row's adapter. All tenants share one ``rank``: it
    fixes the operand shapes."""

    def __init__(
        self, cfg: ModelConfig, *, rank: int, max_tenants: int = 8
    ) -> None:
        if rank < 1:
            raise ValueError(
                f"LoRA rank must be >= 1, got {rank}: a rank-0 adapter "
                "is the zero map — register no adapter (tenant slot 0 "
                "is already the shared zero adapter) instead of paying "
                "two einsums per projection for nothing"
            )
        if max_tenants < 1:
            raise ValueError(
                f"max_tenants must be >= 1, got {max_tenants}"
            )
        if cfg.n_experts:
            raise NotImplementedError(
                "LoRA adapters do not cover MoE configs (routed expert "
                "weights have no single projection to adapt) — serve "
                "dense gpt2/llama configs"
            )
        self.cfg = cfg
        self.rank = int(rank)
        self.max_tenants = int(max_tenants)
        self._targets = _targets(cfg)
        slots = self.max_tenants + 1  # slot 0 = the zero adapter
        self._host: dict[str, dict[str, np.ndarray]] = {}
        for name, (a_shape, b_shape, _) in self._targets.items():
            l = a_shape[0]
            self._host[name] = {
                "a": np.zeros(
                    (l, slots) + a_shape[1:] + (self.rank,), np.float32
                ),
                "b": np.zeros(
                    (l, slots, self.rank) + b_shape[1:], np.float32
                ),
            }
        self._slots: dict[str, int] = {}
        self.version = 0
        # (version, device) -> the uploaded tree; replicas on other host
        # threads (the router's parallel_step) may ask at once.
        self._device: dict[str, tuple[int, list]] = {}
        self._lock = threading.Lock()

    def tenants(self) -> tuple[str, ...]:
        return tuple(self._slots)

    def slot(self, tenant_id) -> int:
        """Tenant id -> adapter slot; unknown tenants are rejected at
        every submit entry point (engine, router, HTTP 400)."""
        s = self._slots.get(tenant_id)
        if s is None:
            raise ValueError(
                f"unregistered tenant {tenant_id!r}: known tenants are "
                f"{sorted(map(repr, self._slots))} — register adapters "
                "with AdapterRegistry.register before submitting"
            )
        return s

    def register(
        self, tenant_id, adapters: dict | None = None, *,
        seed: int | None = None, scale: float = 1.0,
    ) -> int:
        """Install one tenant's adapters into the next free slot and
        return it. Either pass ``adapters`` — {target: {"a": [L, ..in,
        r], "b": [L, r, ..out]}} matching this config's target shapes —
        or an integer ``seed`` for a random NONZERO init (0.02 x normal
        draws from a ``torch.Generator`` seeded with it; tests and
        benches — a real deployment loads trained factors). ``scale`` is
        the LoRA alpha/r factor, folded into B on the host (``scale /
        rank``). Values change, shapes never."""
        if tenant_id in self._slots:
            raise ValueError(
                f"tenant {tenant_id!r} is already registered (slot "
                f"{self._slots[tenant_id]}); build a new registry to "
                "replace adapters — engines memoize the device tree by "
                "version, so silent in-place swaps would be a footgun"
            )
        if len(self._slots) >= self.max_tenants:
            raise ValueError(
                f"adapter registry is full ({self.max_tenants} "
                "tenants): raise max_tenants at construction (the "
                "stacked operand is preallocated, so capacity is a "
                "build-time choice)"
            )
        if adapters is None and seed is None:
            raise ValueError(
                "register needs either explicit adapters= factors or a "
                "seed= for random init"
            )
        gen = None
        if adapters is None:
            gen = torch.Generator().manual_seed(int(seed))
        factors = {}
        for name, (a_shape, b_shape, _) in self._targets.items():
            a_full = a_shape + (self.rank,)
            b_full = (b_shape[0], self.rank) + b_shape[1:]
            if adapters is not None:
                got = adapters.get(name)
                if got is None:
                    raise ValueError(
                        f"adapters missing target {name!r} (this config "
                        f"adapts {sorted(self._targets)})"
                    )
                a = np.asarray(got["a"], np.float32)
                b = np.asarray(got["b"], np.float32)
                if a.shape != a_full or b.shape != b_full:
                    raise ValueError(
                        f"tenant {tenant_id!r} target {name!r}: factor "
                        f"shapes {a.shape}/{b.shape} do not match the "
                        f"config's {a_full}/{b_full} (rank={self.rank})"
                    )
            else:
                a = 0.02 * torch.randn(a_full, generator=gen).numpy()
                b = 0.02 * torch.randn(b_full, generator=gen).numpy()
            factors[name] = (a, b)
        # Every target checked before any slot is written: a rejected
        # registration leaves the registry as it was.
        slot = len(self._slots) + 1
        for name, (a, b) in factors.items():
            self._host[name]["a"][:, slot] = a
            self._host[name]["b"][:, slot] = b * (scale / self.rank)
        self._slots[tenant_id] = slot
        self.version += 1
        log_event(
            "tenant_register", tenant=str(tenant_id), slot=slot,
            rank=self.rank,
        )
        return slot

    def partition_specs(self, tensor_axis: str = "tensor") -> dict:
        """The JAX package's spec tree for the stacked factors (``a`` [L,
        slots, in.., r], ``b`` [L, slots, r, out..], the host layout), as
        tuples: column-parallel targets shard B's output axis, row-parallel
        ones A's contracting dim."""
        specs: dict = {}
        for name, (a_shape, b_shape, b_axis) in self._targets.items():
            a_spec = [None] * (len(a_shape) + 2)
            b_spec = [None] * (len(b_shape) + 2)
            if b_axis is not None:  # column-parallel: B's output dim
                b_spec[2 + b_axis] = tensor_axis
            else:  # row-parallel: A's contracting dim
                a_spec[2] = tensor_axis
            specs[name] = {"a": tuple(a_spec), "b": tuple(b_spec)}
        return specs

    def _host_shard(self, shard) -> dict[str, dict[str, np.ndarray]]:
        """The host factors, or with ``shard`` = (tensor index, tensor
        size) this rank's slices of them under ``partition_specs``."""
        if shard is None:
            return self._host
        index, size = shard
        out: dict = {}
        for name, specs in self.partition_specs().items():
            out[name] = {}
            for leaf, spec in specs.items():
                arr = self._host[name][leaf]
                for dim, axis in enumerate(spec):
                    if axis is not None:
                        n = arr.shape[dim] // size
                        arr = np.take(arr, range(index * n, (index + 1) * n),
                                      axis=dim)
                out[name][leaf] = np.ascontiguousarray(arr)
        return out

    def device_tree(self, device, shard=None) -> list[dict]:
        """The adapters on ``device`` as one dict per layer, {target: {"a":
        [S, ..in, r], "b": [S, r, ..out], "a_flat": [Din, S*r], "b_flat":
        [r, S*Dout], "kernel_args": the kernel's checked view of the flat
        forms}} in f32 (S = max_tenants + 1 slots; the flattened forms are
        what ``ops/lora_kernel`` multiplies by, laid out and checked once
        here rather than on every forward). Uploaded once per (registry
        version, device); a registration uploads new tensors, so
        ``kernel_args``' pointers live as long as the layer dicts.
        ``shard``: (tensor index, tensor size) for a TP engine — this rank's
        slices of the factors (``partition_specs``)."""
        key = f"{torch.device(device)}/{shard}"
        with self._lock:
            hit = self._device.get(key)
            if hit is not None and hit[0] == self.version:
                return hit[1]
            layers = [{} for _ in range(self.cfg.n_layer)]
            for name, leaves in self._host_shard(shard).items():
                a = torch.from_numpy(leaves["a"]).to(device)
                b = torch.from_numpy(leaves["b"]).to(device)
                s, r = a.shape[1], self.rank
                a_flat = a.reshape(a.shape[0], s, -1, r).permute(0, 2, 1, 3)
                b_flat = b.reshape(b.shape[0], s, r, -1).permute(0, 2, 1, 3)
                for layer, slot in enumerate(layers):
                    flat = (a_flat[layer].reshape(-1, s * r).contiguous(),
                            b_flat[layer].reshape(r, -1).contiguous())
                    slot[name] = {
                        "a": a[layer], "b": b[layer],
                        "a_flat": flat[0], "b_flat": flat[1],
                        "kernel_args": lora_kernel.factor_args(*flat),
                    }
            self._device[key] = (self.version, layers)
            return layers
