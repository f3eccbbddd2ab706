"""The serving engines: serial generation and continuous batching over a
dense or a paged KV cache.

The port of the JAX package's ``serving/engine.py``. Three engines:

- ``DecodeEngine`` — serial: one request (of any batch) at a time, a
  prefill forward over the bucket-padded prompt and one single-token
  forward per new token, over a dense cache taken from an LRU-bounded
  pool of dirty caches (a dirty cache is sound: attention masks every
  position past a row's depth, and each position is written before it is
  read). It decodes MoE configs (``models/decode._moe_mlp``); ``stream``
  yields one token array per step.
- ``BatchedDecodeEngine`` — continuous batching over ONE dense cache of
  [L, slots, max_len, Hkv, D]: a host-side scheduler admits queued
  prompts into free rows (one prefill forward per prompt bucket, of the
  fixed shape [slots, bucket]), one forward per tick advances every row
  one token (free rows compute garbage the host discards), finished rows
  retire. ``serve --dense`` builds it.
- ``PagedBatchedDecodeEngine`` — the same scheduler over a pool of
  fixed-size pages (``models/decode``) with a per-row block table:

  - **Pages, not rows**: the pool is ``[L, pool_pages, page_size, Hkv,
    D]``; a row holds only the pages its depth needs. When the pool runs
    dry mid-decode the youngest (lowest-priority) other row is PREEMPTED
    — its tokens so far become a resume entry, its pages return to the
    pool, and it re-admits later and continues token-identically.
  - **Prefix sharing**: full prefill chunks are published to the block
    pool's sha1-chained prefix cache (``serving/block_pool``); a later
    prompt with the same prefix maps those pages instead of recomputing
    them, copy-on-write by construction.
  - **Chunked prefill**: each tick advances every mid-prefill row by one
    ``prefill_chunk``-token chunk (one forward of shape [slots, chunk]),
    so a long prompt never stalls the rows that are decoding.
  - **Decode tick**: one forward over ALL ``slots`` rows at [slots, 1];
    free and mid-prefill rows ride along with position 0 and an all-zero
    table (the scratch page). With ``paged_attention="kernel"`` its
    attention is the hand-written paged decode kernel
    (``ops/paged_kernel``), once per layer per tick; a speculating
    engine's [slots, K+1] verify forward runs each of its queries as a
    row of the same kernel, at the query's own position.
  - **Tiers** (``serving/scheduler``): interactive requests admit first
    and may preempt lower tiers; batch requests admit only with pool
    headroom and sit out ticks while an interactive row is live. (On the
    dense engine tiers only order admission.)
  - **int8** (``ops/quant``): ``kv_quant="int8"`` keeps the pool in int8
    with one f32 scale per token and KV head (``head_dim + 4`` bytes per
    head and position instead of ``head_dim x itemsize``), quantized on
    append; its decode attention is the int8 kernel K4.

  ``paged_attention``: "auto" (default) is "kernel" on a CUDA device and
  the plain gather path on the CPU, as the JAX package's "auto" picks its
  kernel only on a TPU; "kernel" and "gather" force one. On a CPU device
  "kernel" runs the kernel's plain version.

``weight_quant="int8"`` (every engine) quantizes the block projections
per output channel, once, from the params as given. Weights are placed
once per params object (``place_params``): moved to the engine's device,
matmul kernels and biases cast to ``cfg.dtype`` (the JAX package casts
them inside every matmul, which XLA fuses) — or, under int8, kept as int8
values with their scales cast to ``cfg.dtype`` (``qdot`` casts the int8
values per call, as the JAX package does) —, the embeddings kept in
``cfg.param_dtype`` (``wte[ids] + wpe[pos]`` is summed there, then cast),
the head's weight (gpt2's tied ``wte``, llama's ``lm_head``) kept as the
f32 values of its ``cfg.dtype`` rounding, for the f32-accumulated logits,
and MoE expert stacks as given (``ops/moe`` casts them per call, as in
training).

**Speculative decoding** (both batched engines, ``speculative_k=K`` > 0):
each tick drafts up to K tokens per GREEDY row on the host (prompt-lookup
over the row's tokens so far, ``models/speculative.prompt_lookup_draft``,
or the engine's ``draft_hook``) and verifies every row's drafts in ONE
[slots, K+1] forward; each row commits its accepted drafts plus the
model's next token (``models/decode.speculative_accept``), with one
device-to-host copy per tick. Rejected drafts roll back by not advancing
the row's depth: their K/V lie past it, masked, and are overwritten by
the next window (on the paged engine they are confined to the row's
private tail pages, which ``_grow_for_drafts`` grows without preempting;
a lane past the table goes to the scratch page, a dense lane past
``max_len`` is dropped). Sampled rows ride the verify forward with zero
drafts. Greedy output is the plain engine's by construction — on the CPU
exactly; on the card the K+1-wide forward takes other GEMM shapes and the
gather attention (never K3/K4), so a near-tie can round the other way.

**Fault model** (the JAX engine's, ``serving/lifecycle.py`` draws it):
every request reaches exactly one terminal ``RequestResult``. Each
prefill forward and each decode-tick forward, with its sampling, runs
through ``_dispatch``, which consults an installed
``serving/chaos.FaultInjector`` before and after. A failed dispatch is
recovered in ``step``: the cache is written in place, so a failure can
leave it half-written, and no cache content is trusted after one — the
dense engine re-allocates its cache, the paged engine resets its block
pool (every page freed, the prefix cache dropped) —, every in-flight row
becomes a resume entry (its tokens so far, one retry charged against
``request_retries``) that re-prefills on a later tick, and the engine
backs off ``retry_backoff_s x 2^(streak-1)`` through ``sleep``;
``dispatch_retries`` consecutive failures raise ``DispatchFailure`` with
the state consistent. A row with non-finite logits is QUARANTINED: freed,
and its clean prefix re-prefilled once (on fresh pages, never from the
prefix cache); if the logits stay non-finite it is FAILED. ``snapshot``
captures the host state between ticks; ``restore`` loads it into a fresh
engine and ``adopt`` into a busy one (the router's failover): both
continue token-identically, because a resumed row's tokens depend only on
its entry and the params — greedy rows on the prefix, sampled rows on the
(seed, token index) generator.

Which errors are recoverable: whatever the injector raises, and
``RETRYABLE_ERRORS`` from the forward itself (CUDA out-of-memory, which
leaves the context usable). Any other error — from a kernel wrapper, an
illegal address or a device-side assert, which poison the CUDA context
for every replica on the card — propagates: retrying it would hide the
fault. On one card, replica death is therefore simulated (the router's
``kill``, ``RouterFaultInjector``), never a lost device.

``compile_count`` has no per-shape meaning here: the port compiles no
program per shape. It counts the CUDA kernel libraries this process has
built or loaded (``ops/_build``, process-wide), which rises at most once
per library, at the first kernel launch (``warmup``); the router reads
it against a post-warmup watermark, so a steady state reads 0.

**Sessions** (paged engine, ``serving/session``): ``open_session``/
``submit(session=)``/``close_session``; a turn resubmits the conversation
so far and its published chunks (decode-written ones included) stay
pinned between turns, within ``session_pin_budget_pages`` (default half
the pool).

**Multi-tenant LoRA** (both batched engines, ``adapters=`` a
``serving/adapters.AdapterRegistry``): ``submit(tenant=)`` picks a row's
adapter slot; every forward — the prefill at [slots, bucket] or [slots,
chunk], the decode tick, the speculative verify and the warmup — carries
the [slots] tenant-slot vector (free lanes on slot 0, the exact-zero
adapter), so a tenant's rows are bit-equal to that tenant served alone
and untenanted rows to the adapter-less engine (rows that map another
tenant's prefix pages read that tenant's layer-1+ K/V, as in the JAX
package: ``serving/adapters``). The slot survives preemption,
``snapshot``/``restore``/``adopt`` and a KV handoff.

**Disaggregated prefill/decode** (paged engine, ``role=``): a "prefill"
worker runs chunked prefill only and parks each finished row, pages
held, until the router's handoff pump ships it (``export_handoff``: the
row's pages gathered off the pool into a new tensor, int8 scale pools
with them); a "decode" worker takes rows only through ``import_handoff``
(the pages copied into freshly allocated ones of its own pool) or
``adopt``, and refuses ``submit``. The source row stays live until
``complete_handoff``, so a fault on either side falls back on the
ordinary resume entry (``KVHandoff.entry``). The copies are tensor
indexing on the card, consulted by the fault injector as the dispatch
kinds "kv_export" and "kv_import"; a failed import is recovered like any
failed dispatch.

**Meshed decode** (``mesh_cfg``, the JAX engines' modes, chosen by
``_select_mode``): every rank of a ``torch.distributed`` group builds the
same engine and makes the same calls (SPMD: one process a rank, the same
host scheduler on every rank, collectives on the mesh's process groups,
``parallel/mesh``); the engine takes the FULL params and keeps this
rank's slices (``_MeshPlacement``). ``device`` names this rank's device.

- ``tp`` (a tensor-only mesh; all three engines): Megatron-sharded block
  params (``parallel/sharding``; int8 weights shard their ``q8`` with the
  kernel and their scales by ``ops/quant.quantized_param_specs``), a
  head-sharded cache — the dense cache and the page pool hold this
  rank's ``Hkv / tp`` heads ([P, page, Hkv/tp, D], int8 scale pools
  [P, page, Hkv/tp]), so K3/K4 run on each rank's local heads — and one
  all-reduce after each row-parallel projection: 2 x n_layer a forward,
  whatever the active rows, int8 or adapters (``ops/tp.collectives``).
  LoRA factors shard with their projections
  (``serving/adapters.AdapterRegistry.partition_specs``). The block pool,
  queue and sampler are the same host structures on every rank, and the
  logits after the last all-reduce are the same on every rank, so every
  rank decides the same tokens, retirements, preemptions and quarantines;
  a fault injector must be installed alike on every rank. A KV handoff
  moves each rank's own heads' pages. Only injected faults are recovered
  under ``tp``: a real error on one rank propagates (``RETRYABLE_ERRORS``
  is empty), and the other ranks' next collective fails within the
  group's timeout, so no rank retries alone into a mismatched sum.
- ``zero3`` (an fsdp-only full_shard mesh; ``DecodeEngine`` only): each
  rank keeps its full_shard slices and all-gathers the embeddings and head
  once per forward and each layer's params just before the layer
  (``models/decode.zero3_transforms``), or a window of layers ahead under
  the mesh config's ``prefetch_buffers``; no ``weight_quant``.

The TP x ZeRO-3 mixed mesh is refused (``_reject_tp_zero3_mix``), and the
router and the HTTP door keep plain replicas, as in the JAX package.

Not thread-safe: one dispatcher per engine (the router and the HTTP
server serialise every call). Several engines on one card may run in
different threads: the paged kernels keep one workspace per (device,
stream) and count their launches under a lock.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.models import decode
from pytorch_distributed_tpu_torch.models.speculative import (
    prompt_lookup_draft,
)
from pytorch_distributed_tpu_torch.ops import quant
from pytorch_distributed_tpu_torch.serving.block_pool import BlockPool
from pytorch_distributed_tpu_torch.serving.lifecycle import (
    ABORTED,
    DONE,
    EXPIRED,
    FAILED,
    AdmissionQueueFull,
    DispatchFailure,
    EngineSnapshot,
    PagePoolExhausted,
    RequestFailed,
    RequestResult,
)
from pytorch_distributed_tpu_torch.serving.session import SessionTracker
from pytorch_distributed_tpu_torch.serving.scheduler import (
    BATCH,
    INTERACTIVE,
    PRIORITIES,
    STANDARD,
    TIER_NAME,
    TIER_RANK,
    check_priority,
    preemption_key,
    queue_key,
)
from pytorch_distributed_tpu_torch.utils.device import resolve_device
from pytorch_distributed_tpu_torch.utils.logging import log_event

_EMPTY_DRAFT = np.zeros((0,), np.int32)

# Disaggregated-serving roles (the ``stats()["role"]`` vocabulary):
# "colocated" engines prefill AND decode; "prefill" workers run chunked
# prefill only and hand finished rows off; "decode" workers take handoffs
# and adoptions and run the decode tick. Every role runs the same
# forwards, plus the kv copies.
ENGINE_ROLES = ("colocated", "prefill", "decode")


def _check_role(role: str) -> str:
    if role not in ENGINE_ROLES:
        raise ValueError(
            f"role must be one of {ENGINE_ROLES}, got {role!r}"
        )
    return role


def kv_bytes_per_position(cfg: ModelConfig, kv_quant: str = "none") -> int:
    """K+V bytes one cache position costs across all layers. An int8 pool
    carries one f32 scale per token per KV head beside the values, so a
    position costs head_dim + 4 bytes per head instead of head_dim x
    itemsize."""
    if kv_quant == "int8":
        return cfg.n_layer * 2 * cfg.kv_heads * (cfg.head_dim + 4)
    itemsize = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    return cfg.n_layer * 2 * cfg.kv_heads * cfg.head_dim * itemsize


def spec_accept_rate(counters: dict[str, int]) -> float | None:
    """accepted/drafted over the engine's lifetime — None until the first
    draft (and forever on engines that never speculate), so a dashboard
    can tell "speculation off or idle" from "0 % accepts"."""
    drafted = counters.get("drafted_tokens", 0)
    if not drafted:
        return None
    return round(counters.get("accepted_tokens", 0) / drafted, 4)


def _compile_count() -> int:
    """The CUDA kernel libraries this process has built or loaded
    (``ops/_build``; module docstring): the port compiles nothing per
    shape, so this is flat after ``warmup``."""
    from pytorch_distributed_tpu_torch.ops import _build

    return len(_build._loaded)


def _device_ids(device: torch.device) -> list[int]:
    """The device an engine runs on, as an index (``stats()``'s placement
    figure)."""
    if device.type == "cuda":
        idx = device.index
        return [torch.cuda.current_device() if idx is None else idx]
    return [0 if device.index is None else device.index]


def _reject_tp_zero3_mix(mesh_cfg, entry: str) -> None:
    """Every engine refuses the TP x ZeRO-3 mixed mesh with one
    diagnostic naming the supported modes (the JAX package's)."""
    if mesh_cfg is not None and mesh_cfg.tensor > 1 and mesh_cfg.fsdp > 1:
        raise NotImplementedError(
            f"{entry} does not support TP x ZeRO-3 mixed-mesh decode "
            f"(got tensor={mesh_cfg.tensor}, fsdp={mesh_cfg.fsdp}). "
            "Supported modes: plain (single device / no mesh), tp "
            "(tensor-only mesh, Megatron layouts with a head-sharded KV "
            "cache), and zero3 (fsdp-only full_shard mesh, DecodeEngine "
            "only). Serve a mixed-mesh checkpoint by resharding to one "
            "of those layouts; native composition is a future PR."
        )


def _select_mode(cfg: ModelConfig, mesh_cfg, *, entry: str,
                 allow_zero3: bool = True):
    """The engine's mode: (mode, mesh_cfg, local KV heads), the mixed-mesh
    refusal first so every engine gives the same diagnostic."""
    _reject_tp_zero3_mix(mesh_cfg, entry)
    if mesh_cfg is None or mesh_cfg.num_devices == 1:
        return "plain", None, None
    if mesh_cfg.tensor > 1:
        decode._validate_tp_mesh(cfg, mesh_cfg)
        return "tp", mesh_cfg, cfg.kv_heads // mesh_cfg.tensor
    if not allow_zero3:
        raise NotImplementedError(
            f"{entry} supports plain and tp modes; ZeRO-3 slot-batched "
            "decode is future surface — serve ZeRO-3 layouts through "
            "DecodeEngine, or decode from a tensor-only mesh"
        )
    decode._validate_fsdp_mesh(mesh_cfg)
    return "zero3", mesh_cfg, None


def _kernels_of(tree):
    """(``tree`` with every int8 weight dict replaced by its ``q8`` values
    — the kernel's shape, which the sharding rules read —, whether it held
    any)."""
    if quant.is_quantized(tree):
        return tree["q8"], True
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        pairs = {k: _kernels_of(v) for k, v in items}
        out = {k: v for k, (v, _) in pairs.items()}
        found = any(q for _, q in pairs.values())
        return (out if isinstance(tree, dict) else list(out.values())), found
    return tree, False


class _MeshPlacement:
    """How an engine's params and cache lie over its mesh: ``mode``
    ("plain", "tp" or "zero3", ``_select_mode``), the mesh (``parallel/
    mesh.make_mesh`` over the world group), the local KV heads ``n_kv``
    (None: all), and the forward that threads the tensor group (tp) or the
    just-in-time gathers (zero3)."""

    def __init__(self, cfg: ModelConfig, mesh_cfg, device, *, entry: str,
                 allow_zero3: bool = True) -> None:
        self.mode, self.mesh_cfg, self.n_kv = _select_mode(
            cfg, mesh_cfg, entry=entry, allow_zero3=allow_zero3)
        self.mesh = self.tp_group = None
        self._top = self._block = None
        if self.mode != "plain":
            from pytorch_distributed_tpu_torch.parallel.mesh import make_mesh

            self.mesh = make_mesh(self.mesh_cfg, device=device)
        if self.mode == "tp":
            self.tp_group = self.mesh.axis_group("tensor")

    @property
    def tp_shard(self) -> tuple[int, int] | None:
        """(this rank's tensor index, tensor size) under tp, else None."""
        if self.mode != "tp":
            return None
        return self.mesh.axis_index("tensor"), self.mesh_cfg.tensor

    def place(self, params, cfg: ModelConfig, device: torch.device,
              weight_quant: str):
        """``place_params``, then this rank's slices under the mesh."""
        from pytorch_distributed_tpu_torch.parallel.sharding import (
            param_partition_specs,
            shard_params,
        )

        placed = place_params(params, cfg, device, weight_quant)
        if self.mode == "plain":
            return placed
        # The embeddings, norms and head (``head_w`` too) follow the
        # generic rule: replicated under tp, sharded under zero3.
        kernels, quantized = _kernels_of(placed)
        specs = param_partition_specs(kernels, self.mesh_cfg)
        if quantized:  # int8 weights, quantized here or given so
            specs = quant.quantized_param_specs(specs, kernels)
        if self.mode == "zero3":
            self._top, self._block = decode.zero3_transforms(specs,
                                                             self.mesh)
        return shard_params(placed, specs, self.mesh)

    def forward(self, params, *args, **kw):
        """``decode.forward`` under this mode."""
        if self.mode == "zero3":
            return decode.forward(
                self._top(params), *args, block_transform=self._block,
                prefetch_buffers=self.mesh_cfg.prefetch_buffers, **kw)
        return decode.forward(params, *args, tp_group=self.tp_group, **kw)


def place_params(params, cfg: ModelConfig, device: torch.device,
                 weight_quant: str = "none"):
    """The params on ``device`` with the matmul weights cast to
    ``cfg.dtype`` once, or quantized once (module docstring)."""
    dev, dtype = device, getattr(torch, cfg.dtype)
    pdt = getattr(torch, cfg.param_dtype)

    def weight(w):
        # int8 stays int8 on the device (casting it here would undo the
        # halved weight bytes); it is quantized from the weight as given,
        # before any cast, as the JAX engine quantizes its source tree.
        if weight_quant == "int8" and not quant.is_quantized(w):
            w = quant.quantize_weight(w.to(dev))
        if quant.is_quantized(w):
            return {"q8": w["q8"].to(dev).contiguous(),
                    "scale": w["scale"].to(dev, dtype)}
        return w.to(dev, dtype).contiguous()

    def proj(p):
        out = {"kernel": weight(p["kernel"])}
        if "bias" in p:
            out["bias"] = p["bias"].to(dev, dtype)
        return out

    def norm(p):
        return {kk: vv.to(dev, pdt) for kk, vv in p.items()}

    def mlp(p, place):
        if cfg.n_experts:
            return {kk: vv.to(dev) for kk, vv in p.items()}
        return {kk: place(vv) for kk, vv in p.items()}

    wte = params["wte"].to(dev, pdt)
    placed = {"wte": wte, "ln_f": norm(params["ln_f"])}
    if cfg.family == "gpt2":
        placed["wpe"] = params["wpe"].to(dev, pdt)
        placed["head_w"] = wte.to(dtype).float()
        placed["blocks"] = [
            {
                "ln_1": norm(bp["ln_1"]),
                "ln_2": norm(bp["ln_2"]),
                "attn": {kk: proj(vv) for kk, vv in bp["attn"].items()},
                "mlp": mlp(bp["mlp"], proj),
            }
            for bp in params["blocks"]
        ]
    else:
        placed["head_w"] = params["lm_head"].to(dev, pdt).to(dtype).float()
        placed["blocks"] = [
            {
                "ln_attn": norm(bp["ln_attn"]),
                "ln_mlp": norm(bp["ln_mlp"]),
                "attn": {kk: weight(vv) for kk, vv in bp["attn"].items()},
                "mlp": mlp(bp["mlp"], weight),
            }
            for bp in params["blocks"]
        ]
    return placed


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Prompt-length buckets. A request of length T runs the prefill
    shape of the smallest bucket >= T; ``()`` means exact length (no
    padding)."""

    buckets: tuple[int, ...] = ()

    def __post_init__(self) -> None:
        b = tuple(self.buckets)
        if any(x <= 0 for x in b) or list(b) != sorted(set(b)):
            raise ValueError(
                f"buckets must be strictly increasing positives, got {b}"
            )
        object.__setattr__(self, "buckets", b)

    @classmethod
    def powers_of_two(cls, max_len: int,
                      min_bucket: int = 128) -> "BucketSpec":
        """min_bucket, 2 min_bucket, ..., max_len (the first bucket
        clipped to max_len; max_len itself is always the last bucket so
        every admissible prompt has a home)."""
        if min_bucket <= 0 or max_len <= 0:
            raise ValueError("min_bucket and max_len must be positive")
        out = []
        b = min_bucket
        while b < max_len:
            out.append(b)
            b *= 2
        out.append(max_len)
        return cls(tuple(out))

    def bucket_for(self, length: int) -> int:
        if not self.buckets:
            return length
        for b in self.buckets:
            if b >= length:
                return b
        raise ValueError(
            f"prompt length {length} exceeds the largest bucket "
            f"{self.buckets[-1]}"
        )


def _check_buckets(buckets: BucketSpec, max_len: int) -> None:
    if buckets.buckets and buckets.buckets[-1] > max_len:
        raise ValueError(
            f"largest bucket {buckets.buckets[-1]} exceeds max_len {max_len}"
        )


def _uniform_stats(engine, **fields) -> dict[str, Any]:
    """The one ``stats()`` schema of every engine: occupancy, page-pool
    fields (None off the paged engine), speculation and counters."""
    out = {
        "engine": type(engine).__name__,
        "role": "colocated",
        "device": str(engine.device),
        "device_ids": engine.device_ids(),
        "paged_attention": None,
        "kv_quant": "none",
        "weight_quant": engine.weight_quant,
        "queue_depth": 0,
        "queue_depth_by_tier": {name: 0 for name in PRIORITIES},
        "slots": None,
        "active_rows": 0,
        "free_slots": None,
        "pool_pages": None,
        "free_pages": None,
        "pages_in_use": None,
        "session_pinned_pages": None,
        "sessions": None,
        "prefix_hit_rate": None,
        "speculative_k": 0,
        "spec_accept_rate": spec_accept_rate(engine.counters),
        "counters": dict(engine.counters),
    }
    out.update(fields)
    return out


class DecodeEngine:
    """Serial generation (module docstring). Construct once per (cfg,
    max_len, bucket spec); call ``generate``/``stream`` per request with
    any params matching ``cfg`` (params are call arguments, placed once
    per params object).

    ``pool_caches``: keep each batch size's dirty cache for the next
    request (LRU-bounded at ``pool_max_entries`` batch sizes); off, each
    request allocates and frees its own. ``nan_guard``: a request whose
    logits go non-finite anywhere is retried once on a fresh zeroed cache,
    then raises ``lifecycle.RequestFailed`` (one host read of the flag
    per request). ``weight_quant="int8"`` (dense configs only; not under
    zero3), ``device`` (None = "cuda"; under a mesh, this rank's device).
    ``mesh_cfg``: a tensor-only mesh (``tp``) or an fsdp-only full_shard
    mesh (``zero3``), every rank of the group running the same calls
    (module docstring)."""

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        max_len: int,
        buckets: BucketSpec | None = None,
        mesh_cfg=None,
        pool_caches: bool = True,
        pool_max_entries: int = 8,
        nan_guard: bool = True,
        weight_quant: str = "none",
        device=None,
    ) -> None:
        if max_len > cfg.n_ctx:
            raise ValueError(f"max_len {max_len} exceeds n_ctx {cfg.n_ctx}")
        if cfg.family not in ("gpt2", "llama"):
            raise NotImplementedError(
                f"the engine serves the gpt2 and llama families, got "
                f"{cfg.family!r}"
            )
        self.cfg = cfg
        self.max_len = int(max_len)
        self.buckets = buckets or BucketSpec()
        _check_buckets(self.buckets, self.max_len)
        self.device = resolve_device(device)
        self._mp = _MeshPlacement(cfg, mesh_cfg, self.device,
                                  entry="DecodeEngine")
        self.mode, self.mesh_cfg = self._mp.mode, self._mp.mesh_cfg
        self.weight_quant = quant.check_mode("weight_quant", weight_quant)
        if self.weight_quant != "none" and self.mode == "zero3":
            raise NotImplementedError(
                "weight_quant with ZeRO-3 decode is future surface: the "
                "layer gathers move full-precision shards — serve quantized "
                "weights from plain or tensor-only meshes"
            )
        if self.weight_quant != "none" and cfg.n_experts:
            raise NotImplementedError(
                "weight_quant does not cover MoE expert stacks (routed "
                "expert weights need per-expert calibration surface) — "
                "quantized decode serves dense gpt2/llama configs"
            )
        if pool_max_entries < 1:
            raise ValueError(
                f"pool_max_entries must be >= 1, got {pool_max_entries}"
            )
        self._pool_caches = bool(pool_caches)
        self._pool_max = int(pool_max_entries)
        self._cache_pool: dict[int, decode.Cache] = {}
        self._peak_cache_bytes = 0
        self._nan_guard = bool(nan_guard)
        self._placed: tuple[Any, Any] | None = None
        # The serial slice of the uniform stats() schema; the speculative
        # counters stay 0 (the serial engine never drafts).
        self.counters: dict[str, int] = {
            "requests": 0, "done": 0, "failed": 0, "nan_retries": 0,
            "drafted_tokens": 0, "accepted_tokens": 0, "spec_commits": 0,
        }

    def stats(self) -> dict[str, Any]:
        """The uniform engine-state snapshot (``BatchedDecodeEngine
        .stats``): no scheduler, so the occupancy fields hold their idle
        values and only ``counters`` carries information."""
        return _uniform_stats(self)

    def device_ids(self) -> list[int]:
        return _device_ids(self.device)

    def compile_count(self) -> int:
        return _compile_count()

    # -- cache pool ---------------------------------------------------------

    def new_cache(self, batch: int) -> decode.Cache:
        """A freshly zeroed dense cache for ``batch`` rows on this engine's
        device (the pool bypasses this after the first request per batch
        size)."""
        self._bump_cache_peak(batch)
        return decode.init_cache(self.cfg, batch, self.max_len,
                                 device=self.device, n_kv=self._mp.n_kv)

    def _cache_bytes(self, batch: int) -> int:
        return batch * self.max_len * kv_bytes_per_position(self.cfg)

    def _bump_cache_peak(self, taken_batch: int | None = None) -> None:
        live = sum(self._cache_bytes(b) for b in self._cache_pool)
        if taken_batch is not None:
            live += self._cache_bytes(taken_batch)
        self._peak_cache_bytes = max(self._peak_cache_bytes, live)

    def cache_hbm_bytes(self) -> dict[str, int]:
        """Pooled KV-cache bytes (``allocated``: the caches the pool holds
        now) and the high-water mark of pooled + in-flight bytes."""
        return {
            "allocated": sum(self._cache_bytes(b) for b in self._cache_pool),
            "peak_in_use": self._peak_cache_bytes,
        }

    def _take_cache(self, batch: int) -> decode.Cache:
        pooled = self._cache_pool.pop(batch, None)
        if pooled is not None:
            self._bump_cache_peak(batch)
            return pooled
        return self.new_cache(batch)

    def _return_cache(self, batch: int, cache: decode.Cache) -> None:
        if not self._pool_caches:
            return
        # Most recently used last; evict from the front past the bound.
        self._cache_pool.pop(batch, None)
        self._cache_pool[batch] = cache
        while len(self._cache_pool) > self._pool_max:
            self._cache_pool.pop(next(iter(self._cache_pool)))

    # -- requests -----------------------------------------------------------

    def _place_params(self, params):
        if self._placed is None or self._placed[0] is not params:
            self._placed = (params, self._mp.place(
                params, self.cfg, self.device, self.weight_quant))
        return self._placed[1]

    def _request_setup(self, prompt, temperature, top_k, top_p):
        ids = decode.as_prompt(prompt, self.device)
        b, tp = ids.shape
        bucket = self.buckets.bucket_for(tp)
        padded = (ids if bucket == tp
                  else torch.nn.functional.pad(ids, (0, bucket - tp)))
        t, k, p = decode.sampling_scalars(temperature, top_k, top_p,
                                          self.cfg.vocab_size)
        return ids, padded, b, tp, t, k, p

    def _step(self, params, tok, cache, pos, sampled, t, k, p, seed,
              index):
        """One single-token forward at ``pos`` and its draw: ([B] token,
        [B] non-finite flag)."""
        logits, _ = self._mp.forward(params, tok[:, None], self.cfg, cache,
                                     pos)
        last = logits[:, -1]
        nxt = decode.sample_token(last, sampled, t,
                                  decode.sample_seed(seed, index), k, p)
        return nxt, decode.nonfinite_rows(last)

    def _prefill(self, params, padded, tp, cache, sampled, t, k, p, seed):
        logits, _ = self._mp.forward(params, padded, self.cfg, cache, 0)
        last = logits[:, tp - 1]
        tok = decode.sample_token(last, sampled, t,
                                  decode.sample_seed(seed, 0), k, p)
        return tok, decode.nonfinite_rows(last)

    @torch.no_grad()
    def generate(self, params, prompt, max_new_tokens: int, *,
                 temperature: float = 0.0, seed: int | None = None,
                 top_k: int | None = None,
                 top_p: float | None = None) -> torch.Tensor:
        """Serve one request: [B, Tp + max_new_tokens] int32 on the
        engine's device, token-equal to ``decode.generate_monolithic``.
        With ``nan_guard``, non-finite logits anywhere in the request
        retry it ONCE on a fresh zeroed cache, then raise
        ``RequestFailed`` — garbage tokens never escape."""
        seed = decode._check_sample_args(
            prompt, max_new_tokens, temperature, seed, max_len=self.max_len,
        )
        ids, padded, b, tp, t, k, p = self._request_setup(
            prompt, temperature, top_k, top_p)
        sampled = temperature > 0
        params = self._place_params(params)
        self.counters["requests"] += 1
        for attempt in range(2 if self._nan_guard else 1):
            out, bad = self._generate_once(
                params, ids, padded, b, tp, max_new_tokens, sampled, t, k,
                p, seed, fresh_cache=attempt > 0,
            )
            if not self._nan_guard or not bool(bad.any()):
                self.counters["done"] += 1
                return out
            # Poisoned: drop the pooled cache and retry once on a fresh
            # zeroed one.
            self._cache_pool.pop(b, None)
            self.counters["nan_retries"] += 1
            log_event("nan_detected", engine="serial", batch=b,
                      attempt=attempt, prompt_len=tp)
        self.counters["failed"] += 1
        raise RequestFailed(
            "non-finite logits persisted after one fresh-cache retry "
            f"(batch={b}, prompt_len={tp}): the model/params produce "
            "NaN/Inf for this input — refusing to return garbage tokens"
        )

    def _generate_once(self, params, ids, padded, b, tp, max_new_tokens,
                       sampled, t, k, p, seed, *, fresh_cache: bool):
        """One prefill and the decode loop; returns (tokens, bad), ``bad``
        the [B] non-finite flag OR-ed over every step (on the device: one
        host read per request)."""
        cache = self.new_cache(b) if fresh_cache else self._take_cache(b)
        try:
            tok, bad = self._prefill(params, padded, tp, cache, sampled, t,
                                     k, p, seed)
            pieces = [ids, tok[:, None]]
            for i in range(max_new_tokens - 1):
                tok, bad_i = self._step(params, tok, cache, tp + i, sampled,
                                        t, k, p, seed, i + 1)
                bad = bad | bad_i
                pieces.append(tok[:, None])
        except BaseException:
            cache = None  # a failed forward may have half-written it
            raise
        finally:
            if cache is not None:
                self._return_cache(b, cache)
        return torch.cat(pieces, dim=1).to(torch.int32), bad

    @torch.no_grad()
    def stream(self, params, prompt, max_new_tokens: int, *,
               temperature: float = 0.0, seed: int | None = None,
               top_k: int | None = None, top_p: float | None = None):
        """Generator of [B] token tensors, one per forward — the streaming
        form of ``generate`` (the same tokens). The cache returns to the
        pool when the generator finishes or is closed. With
        ``nan_guard``, a poisoned step raises ``RequestFailed`` at once
        (tokens already escaped, so a stream cannot retry)."""
        seed = decode._check_sample_args(
            prompt, max_new_tokens, temperature, seed, max_len=self.max_len,
        )
        ids, padded, b, tp, t, k, p = self._request_setup(
            prompt, temperature, top_k, top_p)
        sampled = temperature > 0
        params = self._place_params(params)
        cache = self._take_cache(b)
        self.counters["requests"] += 1

        def guard(bad):
            if self._nan_guard and bool(bad.any()):
                self.counters["failed"] += 1
                raise RequestFailed(
                    f"non-finite logits mid-stream (batch={b}, "
                    f"prompt_len={tp}): aborting the stream — resubmit via "
                    "generate() for the fresh-cache retry"
                )

        try:
            tok, bad = self._prefill(params, padded, tp, cache, sampled, t,
                                     k, p, seed)
            guard(bad)
            yield tok
            for i in range(max_new_tokens - 1):
                tok, bad = self._step(params, tok, cache, tp + i, sampled,
                                      t, k, p, seed, i + 1)
                guard(bad)
                yield tok
            self.counters["done"] += 1
        except GeneratorExit:
            raise
        except BaseException:
            cache = None
            raise
        finally:
            if cache is not None:
                self._return_cache(b, cache)


@dataclasses.dataclass(eq=False)
class _Pending:
    """A queued request; after a preemption or a fault, also its resume
    entry: ``gen`` then holds the clean tokens generated so far, and
    admission prefills the whole prompt + gen prefix. The same record is
    what ``snapshot`` captures and ``restore``/``adopt`` take. Entries
    compare by identity (the queue removes the entry it holds)."""

    rid: int
    prompt: np.ndarray  # [Tp] int32
    max_new: int  # TOTAL new-token budget (not remaining)
    eos_id: int | None
    greedy: bool
    t: float
    k: int
    p: float
    seed: int
    deadline: float | None = None  # engine-clock absolute deadline
    gen: list = dataclasses.field(default_factory=list)  # resume prefix
    tier: int = TIER_RANK[STANDARD]
    retries: int = 0  # fault resumes charged (dispatch failures)
    nan_retried: bool = False  # quarantine: one retry, then FAILED
    session: int | None = None  # the engine session a turn belongs to
    resub_len: int = 0  # resubmitted-transcript tokens of a session turn
    tenant_slot: int = 0  # LoRA adapter slot (0: the zero adapter)


@dataclasses.dataclass
class _Slot:
    """One occupied row of the slot batch: ``pos`` is its next KV write
    offset (tokens in its cache)."""

    rid: int
    prompt: np.ndarray
    max_new: int
    eos_id: int | None
    pos: int
    generated: list
    greedy: bool
    t: float
    k: int
    p: float
    seed: int
    deadline: float | None = None
    tier: int = TIER_RANK[STANDARD]
    retries: int = 0
    nan_retried: bool = False
    session: int | None = None
    resub_len: int = 0
    tenant_slot: int = 0

    @property
    def ready(self) -> bool:
        return True


@dataclasses.dataclass
class _PagedSlot(_Slot):
    """One occupied row of the paged engine: ``pos`` is the prefill cursor
    (next position to prefill) until it reaches ``prefill_len``; after
    that the row is decode-ready and ``pos`` is its next KV write offset.
    The engine fills every field at admission."""

    prefix: np.ndarray | None = None  # prompt + resume tokens to prefill
    prefill_len: int = 0  # len(prefix)
    table: np.ndarray | None = None  # [max_pages] int32 page ids (0 = scratch)
    pids: list = dataclasses.field(default_factory=list)  # pages held
    n_pages: int = 0  # allocated table entries
    resume_base: int = 0  # len(resume gen) riding ahead of fresh tokens
    chain_key: str = ""  # prefix-cache chain key at pos

    @property
    def ready(self) -> bool:
        return self.pos >= self.prefill_len


class BatchedDecodeEngine:
    """Continuous batching over one dense [L, slots, max_len, Hkv, D]
    cache (module docstring).

    Knobs: ``buckets`` (prompt-length ``BucketSpec``; each bucket is one
    prefill shape [slots, bucket], and ``max_len`` is added as the bucket
    of fault-resume prefixes), ``queue_limit`` (bounded admission queue)
    with ``backpressure`` ("reject": ``submit`` past the limit raises
    ``AdmissionQueueFull``; "block": ``submit(params=...)`` drives
    ``step`` until space frees or ``block_timeout_s`` passes),
    ``request_retries`` (fault resumes a request may take before it is
    FAILED), ``dispatch_retries`` (consecutive failed dispatches before
    ``step`` raises ``DispatchFailure``; None = never), ``retry_backoff_s``
    (the first backoff, doubled per consecutive failure), ``clock`` and
    ``sleep`` (the deadline clock and the backoff's sleep,
    ``time.monotonic``/``time.sleep`` by default; a
    ``utils/chaos.VirtualClock`` for both makes them deterministic),
    ``device`` (None = "cuda"), ``weight_quant`` ("none" or "int8"),
    ``speculative_k``/``spec_ngram``/``draft_hook`` (speculative decoding:
    K drafts per row per tick, the lookup n-gram, and a callable
    ``(tokens_so_far, k) -> drafts`` replacing the lookup), ``adapters``
    (a ``serving/adapters.AdapterRegistry`` for this config: every
    forward then carries the registry's adapters and a [slots]
    tenant-slot vector, and ``submit(tenant=)`` picks a row's adapter),
    ``mesh_cfg`` (a tensor-only mesh: the ``tp`` mode of the module
    docstring; ZeRO-3 is the serial engine's alone).

    The dense engine serves every admitted prompt in one prefill forward
    per bucket of the fixed shape [slots, bucket] over a scratch cache of
    the bucket's length: the admitted rows first, the rest padding whose
    results are dropped. The fixed shape
    makes a row's values independent of how many rows share its forward
    (on the card cuBLAS picks its kernel, and its summation order, by
    shape); the JAX engine pads a group to the next power of two."""

    # Errors from the forward itself that a retry can honestly recover
    # (module docstring); anything else propagates.
    RETRYABLE_ERRORS: tuple[type[BaseException], ...] = (
        torch.cuda.OutOfMemoryError,
    )

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        slots: int,
        max_len: int,
        buckets: BucketSpec | None = None,
        queue_limit: int | None = None,
        backpressure: str = "reject",
        request_retries: int = 3,
        dispatch_retries: int | None = 2,
        retry_backoff_s: float = 0.05,
        clock=None,
        sleep=None,
        device=None,
        weight_quant: str = "none",
        speculative_k: int = 0,
        spec_ngram: int = 2,
        draft_hook=None,
        adapters=None,
        mesh_cfg=None,
    ) -> None:
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_len > cfg.n_ctx:
            raise ValueError(f"max_len {max_len} exceeds n_ctx {cfg.n_ctx}")
        if cfg.family not in ("gpt2", "llama"):
            raise NotImplementedError(
                f"the engine serves the gpt2 and llama families, got "
                f"{cfg.family!r}"
            )
        if cfg.n_experts:
            raise NotImplementedError(
                f"{type(self).__name__} does not serve MoE configs: expert "
                "capacity couples batch rows, so a row's output would "
                "depend on its neighbours — use the serial DecodeEngine "
                "for MoE decode"
            )
        self.cfg = cfg
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.buckets = buckets or BucketSpec()
        _check_buckets(self.buckets, self.max_len)
        # Prefill shapes: the user buckets plus max_len, so a fault-resume
        # prefix (prompt + tokens so far) longer than the largest PROMPT
        # bucket stays inside the warmed set.
        pb = tuple(self.buckets.buckets)
        if pb and pb[-1] < self.max_len:
            pb += (self.max_len,)
        self._prefill_buckets = pb  # () = exact-length mode
        if speculative_k < 0:
            raise ValueError(
                f"speculative_k must be >= 0, got {speculative_k} "
                "(0 disables speculation)"
            )
        if speculative_k >= max_len:
            raise ValueError(
                f"speculative_k ({speculative_k}) must be < max_len "
                f"({max_len}): the verify window is k+1 tokens wide and "
                "has to fit a row's cache extent"
            )
        if spec_ngram < 1:
            raise ValueError(f"spec_ngram must be >= 1, got {spec_ngram}")
        if draft_hook is not None and not callable(draft_hook):
            raise ValueError(
                "draft_hook must be callable: (tokens_so_far [n] int32, "
                "k) -> up to k draft tokens"
            )
        self.speculative_k = int(speculative_k)
        self.spec_ngram = int(spec_ngram)
        self._draft_hook = draft_hook
        if adapters is not None and adapters.cfg != cfg:
            raise ValueError(
                "adapters= was built for a different ModelConfig than "
                "this engine serves — one registry per architecture "
                "(build it once and share it across replicas)"
            )
        self.adapters = adapters
        if queue_limit is not None and queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        self.queue_limit = queue_limit
        if backpressure not in ("reject", "block"):
            raise ValueError(
                f"backpressure must be 'reject' or 'block', got "
                f"{backpressure!r}"
            )
        self.backpressure = backpressure
        self.request_retries = int(request_retries)
        self.dispatch_retries = dispatch_retries
        self.retry_backoff_s = float(retry_backoff_s)
        self.device = resolve_device(device)
        self._mp = _MeshPlacement(cfg, mesh_cfg, self.device,
                                  entry=type(self).__name__,
                                  allow_zero3=False)
        self.mode, self.mesh_cfg = self._mp.mode, self._mp.mesh_cfg
        if self.mode == "tp":
            # Only faults that fire alike on every rank (injected ones)
            # may be retried: a rank retrying alone would sum mismatched
            # tensors with the others.
            self.RETRYABLE_ERRORS = ()
        self.kv_quant = "none"
        self.weight_quant = quant.check_mode("weight_quant", weight_quant)
        self.role = "colocated"
        self._clock = clock or time.monotonic
        self._sleep = sleep or time.sleep
        self._injector = None  # serving/chaos.FaultInjector (or None)
        self._ticks = 0
        self._fail_streak = 0  # consecutive failed dispatches
        self._cache: decode.Cache | None = None  # allocated on first use
        self._queue: collections.deque[_Pending] = collections.deque()
        self._slots: list[_Slot | None] = [None] * self.slots
        self._next_rid = 0
        self._placed: tuple[Any, Any] | None = None
        self.results: dict[int, RequestResult] = {}
        self.counters: dict[str, int] = {
            "done": 0, "failed": 0, "aborted": 0, "expired": 0,
            "nan_quarantines": 0, "dispatch_failures": 0, "resumes": 0,
            "cache_allocs": 0,
            # Speculation (0 forever when speculative_k=0): drafted =
            # lanes offered to the verifier, accepted = tokens committed
            # beyond the one a plain tick yields, spec_commits = row-ticks
            # through the verify path.
            "drafted_tokens": 0, "accepted_tokens": 0, "spec_commits": 0,
            # Forwards that ran (the port's tick accounting).
            "prefill_ticks": 0, "decode_ticks": 0,
        }

    # -- cache, params and forward ------------------------------------------

    def _new_cache(self) -> decode.Cache:
        self.counters["cache_allocs"] += 1
        return decode.init_cache(self.cfg, self.slots, self.max_len,
                                 device=self.device, n_kv=self._mp.n_kv)

    def _live_cache(self) -> decode.Cache:
        """The engine's cache, allocated on first use and again after a
        failed dispatch dropped it."""
        if self._cache is None:
            self._cache = self._new_cache()
        return self._cache

    def _place_params(self, params):
        """``place_params`` (and this rank's slices under a mesh) memoized
        on the identity of ``params``."""
        if self._placed is None or self._placed[0] is not params:
            self._placed = (params, self._mp.place(
                params, self.cfg, self.device, self.weight_quant))
        return self._placed[1]

    @property
    def _decode_width(self) -> int:
        """Tokens per row of a decode forward: 1, or K+1 when speculating."""
        return self.speculative_k + 1

    def _lora(self, tenants):
        """The ``lora=`` operand of one forward: the registry's device
        tree and the [slots] tenant-slot vector (free and garbage rows on
        slot 0, the exact-zero adapter) — or None without adapters."""
        if self.adapters is None:
            return None
        return (self.adapters.device_tree(self.device,
                                          shard=self._mp.tp_shard),
                torch.from_numpy(np.asarray(tenants, np.int64)).to(
                    self.device))

    @torch.no_grad()
    def _forward(self, params, ids, pos, tables=None, tenants=None,
                 window=False, lane0_alone=False):
        """One forward of the slot batch over the live cache (numpy
        operands in, logits out); ``tables`` is the paged engine's,
        ``tenants`` the [slots] adapter slots (None: all slot 0),
        ``window`` and ``lane0_alone`` mark a decode forward and one
        holding a sampled row (the paged engine's)."""
        dev = self.device
        logits, _ = self._mp.forward(
            params, torch.from_numpy(ids).to(dev), self.cfg,
            self._live_cache(), torch.from_numpy(pos).to(dev),
            lora=self._lora(np.zeros((self.slots,), np.int64)
                            if tenants is None else tenants),
        )
        return logits

    def _sample(self, last, rows, index=None):
        """Sample one token per logits row; ``rows`` are the (slot-like)
        objects those rows belong to (None = discarded lane), ``index``
        each row's token index (default: its tokens generated so far).
        Returns host arrays (tokens, nonfinite flags) with ONE
        device->host copy."""
        if index is None:
            index = [0 if r is None else len(r.generated) for r in rows]
        greedy, t, k, p, seeds = self._sampling_rows(rows, index)
        toks = decode.sample_token_rows(last, greedy, t, k, p, seeds)
        bad = decode.nonfinite_rows(last)
        host = torch.stack([toks, bad.long()]).cpu().numpy()
        return host[0], host[1].astype(bool)

    def _sampling_rows(self, rows, index):
        greedy = [r is None or r.greedy for r in rows]
        t = [1.0 if r is None else r.t for r in rows]
        k = [self.cfg.vocab_size if r is None else r.k for r in rows]
        p = [2.0 if r is None else r.p for r in rows]
        seeds = [
            0 if r is None or r.greedy else decode.sample_seed(r.seed, i)
            for r, i in zip(rows, index)
        ]
        return greedy, t, k, p, seeds

    # -- request API ---------------------------------------------------------

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        *,
        temperature: float = 0.0,
        top_k: int | None = None,
        top_p: float | None = None,
        eos_id: int | None = None,
        seed: int | None = None,
        priority: str = STANDARD,
        timeout_s: float | None = None,
        params=None,
        block_timeout_s: float | None = None,
        session: int | None = None,
        tenant=None,
    ) -> int:
        """Queue one single-sequence request ([Tp] or [1, Tp] token ids)
        and return its request id. A later ``step`` admits it; its
        terminal ``RequestResult`` lands in ``results[rid]`` — collect it
        with ``pop_result(rid)``. ``temperature > 0`` samples (``seed``
        required: the request's tokens are a pure function of it);
        ``timeout_s`` is a deadline on the engine clock; ``priority`` is
        the SLO tier (``serving/scheduler``). With a full bounded queue,
        ``backpressure="reject"`` raises ``AdmissionQueueFull`` and
        "block" drives ``step(params)`` until space frees or
        ``block_timeout_s`` (engine clock) passes, then raises.
        ``session`` is a live sid from the paged engine's
        ``open_session``: the prompt must extend the session's recorded
        transcript (``serving/session``). ``tenant`` picks a registered LoRA
        adapter (an engine built with ``adapters=``); None rides the shared
        zero adapter, bit-equal to the adapter-less engine."""
        prompt = np.asarray(prompt)
        if prompt.ndim == 2 and prompt.shape[0] == 1:
            prompt = prompt[0]
        if prompt.ndim != 1:
            raise ValueError(
                f"the engine serves one sequence per request (one slot "
                f"row); got prompt shape {prompt.shape}"
            )
        tp = prompt.shape[0]
        if tp == 0:
            raise ValueError(
                "empty prompt: need at least one token to prefill"
            )
        if max_new_tokens <= 0:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}"
            )
        if tp + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({tp}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"max_len {self.max_len}: the KV cache holds max_len "
                "positions, so the request cannot fit"
            )
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            raise ValueError(
                f"prompt token ids must lie in [0, {self.cfg.vocab_size})"
            )
        if temperature > 0.0 and seed is None:
            raise ValueError("temperature sampling requires a seed")
        if timeout_s is not None and timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        tier = check_priority(priority)
        self._check_prompt_shape(tp)
        tenant_slot = 0
        if tenant is not None:
            if self.adapters is None:
                raise ValueError(
                    f"tenant={tenant!r} needs an engine built with "
                    "adapters=AdapterRegistry(...) — this engine has no "
                    "adapter registry attached"
                )
            tenant_slot = self.adapters.slot(tenant)
        prompt = prompt.astype(np.int32)
        # Validated before the rid is assigned; marked in flight after.
        resub_len = self._session_checkin(session, prompt)
        self._admission_backpressure(params, block_timeout_s)
        rid = self._next_rid
        self._next_rid += 1
        t, k, p = decode.sampling_scalars(
            temperature, top_k, top_p, self.cfg.vocab_size
        )
        deadline = None if timeout_s is None else self._clock() + timeout_s
        self._queue.append(_Pending(
            rid=rid, prompt=prompt, max_new=int(max_new_tokens),
            eos_id=eos_id, greedy=not temperature > 0.0, t=t, k=k, p=p,
            seed=0 if seed is None else int(seed), deadline=deadline,
            tier=tier, session=session, resub_len=resub_len,
            tenant_slot=tenant_slot,
        ))
        self._session_begin(session, rid)
        log_event(
            "submit", rid=rid, t=round(self._clock(), 6), prompt_len=tp,
            max_new=int(max_new_tokens),
            deadline=None if deadline is None else round(deadline, 6),
            priority=priority if tier != TIER_RANK[STANDARD] else None,
            session=session,
            tenant=str(tenant) if tenant is not None else None,
        )
        return rid

    def _check_prompt_shape(self, tp: int) -> None:
        """Hook: the dense engine needs a prompt bucket (raises past the
        largest)."""
        self.buckets.bucket_for(tp)

    def _session_checkin(self, session, prompt) -> int:
        """Hook: validate a session turn and return its resubmitted
        transcript length. Sessions ride the paged engine's prefix cache;
        the dense engine refuses them."""
        if session is not None:
            raise ValueError(
                "multi-turn sessions need the chunk-chained prefix cache "
                "and page pinning — open them on a PagedBatchedDecodeEngine "
                f"(serving/session), not {type(self).__name__}"
            )
        return 0

    def _session_begin(self, session, rid) -> None:
        """Hook: mark a validated session turn in flight (paged only)."""

    def _admission_backpressure(self, params, block_timeout_s) -> None:
        if self.queue_limit is None or len(self._queue) < self.queue_limit:
            return
        if self.backpressure == "reject":
            raise AdmissionQueueFull(
                f"admission queue full: {len(self._queue)} queued >= "
                f"queue_limit {self.queue_limit} (policy 'reject') — shed "
                "load upstream or retry after draining"
            )
        if params is None:
            raise ValueError(
                "backpressure policy 'block' drives the scheduler from "
                "submit and therefore needs params=... (or use the "
                "'reject' policy)"
            )
        deadline = (
            None if block_timeout_s is None
            else self._clock() + block_timeout_s
        )
        while len(self._queue) >= self.queue_limit:
            if deadline is not None and self._clock() >= deadline:
                raise AdmissionQueueFull(
                    f"admission queue still full ({len(self._queue)} >= "
                    f"queue_limit {self.queue_limit}) after blocking "
                    f"{block_timeout_s}s — the engine is not draining "
                    "fast enough for the offered load"
                )
            self.step(params)

    def has_work(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    def queued_rids(self) -> list[int]:
        return [q.rid for q in self._queue]

    def active_rids(self) -> list[int]:
        return [s.rid for s in self._slots if s is not None]

    def abort(self, rid: int) -> bool:
        """Cancel one request: a queued entry is removed, an active row is
        freed (its pages released on the paged engine). It retires
        ABORTED with its clean partial output. True on transition, False
        if already terminal; unknown rids raise KeyError."""
        for q in self._queue:
            if q.rid == rid:
                self._queue.remove(q)
                self._finish_pending(q, ABORTED, "abort() while queued")
                return True
        for i, s in enumerate(self._slots):
            if s is not None and s.rid == rid:
                self._slots[i] = None
                self._on_slot_freed(s)
                self._finish_slot(s, ABORTED, "abort() mid-decode")
                return True
        if rid in self.results:
            return False
        raise KeyError(
            f"unknown rid {rid}: never submitted, or already delivered "
            "via pop_result"
        )

    def step(self, params) -> list[int]:
        """One scheduler tick: expire overdue requests, admit queued ones
        (prefill), then advance every decode-ready row (one token, or
        1..K+1 under speculation). Returns the rids that reached a
        terminal state this tick. A failed dispatch is recovered here
        (module docstring); only past ``dispatch_retries`` consecutive
        failures does it raise ``DispatchFailure``, with every in-flight
        request requeued."""
        self._ticks += 1
        if self._injector is not None:
            self._injector.on_tick(self._ticks)
        params = self._place_params(params)
        finished: list[int] = []
        self._expire(finished)
        self._admit(params, finished)
        if any(s is not None for s in self._slots):
            self._decode_tick(params, finished)
        return finished

    def run(
        self, params, requests=None, *,
        max_ticks: int | None = None,
        timeout_s: float | None = None,
    ) -> dict[int, RequestResult]:
        """Submit ``requests`` (iterable of ``submit`` kwarg dicts), then
        drive ``step`` until idle, or until ``max_ticks`` ticks or
        ``timeout_s`` (engine clock) pass. Returns {rid: RequestResult}
        for everything that reached a terminal state during the drive."""
        before = set(self.results)
        for req in requests or ():
            self.submit(**req)
        deadline = None if timeout_s is None else self._clock() + timeout_s
        ticks = 0
        while self.has_work():
            if max_ticks is not None and ticks >= max_ticks:
                log_event("run_guard", reason="max_ticks", ticks=ticks)
                break
            if deadline is not None and self._clock() >= deadline:
                log_event("run_guard", reason="timeout", ticks=ticks)
                break
            self.step(params)
            ticks += 1
        return {
            rid: out for rid, out in self.results.items()
            if rid not in before
        }

    def pop_result(self, rid: int) -> RequestResult:
        """Deliver and release one request's terminal result (KeyError for
        unknown or not-yet-terminal rids)."""
        return self.results.pop(rid)

    def peek_tokens(self, rid: int) -> np.ndarray | None:
        """Tokens so far (prompt + generated) of a live or terminal
        request; None for unknown rids."""
        for s in self._slots:
            if s is not None and s.rid == rid:
                return self._partial_tokens(s.prompt, s.generated)
        for q in self._queue:
            if q.rid == rid:
                return self._partial_tokens(q.prompt, q.gen)
        res = self.results.get(rid)
        return None if res is None else np.asarray(res.tokens)

    def warmup(self, params) -> int:
        """Place the params and run every prefill shape (over its scratch
        cache) and the decode forward once (idle engines only: warmup
        writes garbage rows, which admission overwrites), so the first
        request pays no one-time cost. Returns ``compile_count()``."""
        if self.has_work():
            raise RuntimeError("warmup requires an idle engine")
        if not self._prefill_buckets:
            raise ValueError(
                "warmup needs a finite BucketSpec (exact-length mode runs "
                "one prefill shape per observed prompt length)"
            )
        params = self._place_params(params)
        zero_rows = np.zeros((self.slots,), np.int64)
        with torch.no_grad():
            for bucket in self._prefill_buckets:
                self._mp.forward(
                    params, torch.zeros((self.slots, bucket), dtype=torch.long,
                                        device=self.device),
                    self.cfg, decode.init_cache(self.cfg, self.slots, bucket,
                                                device=self.device,
                                                n_kv=self._mp.n_kv), 0,
                    lora=self._lora(zero_rows),
                )
        w = self._decode_width
        self._forward(params, np.zeros((self.slots, w), np.int32),
                      np.zeros((self.slots,), np.int32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.compile_count()

    # -- fault injection, crash recovery, failover ----------------------------

    def set_fault_injector(self, injector) -> None:
        """Install a ``serving/chaos.FaultInjector`` (or None to remove):
        host-side hooks consulted around every dispatch and at every
        tick."""
        self._injector = injector
        if injector is not None:
            # Seeded nan_row faults pick their target among the active
            # rows, so the injector needs the engine back-reference.
            injector._engine = self

    def snapshot(self) -> EngineSnapshot:
        """The engine's host-side request state, between ``step`` calls:
        queued entries, every in-flight row as a resume entry carrying
        its tokens so far, the rid counter and the undelivered results.
        The KV cache is not captured: ``restore``/``adopt`` and admission
        rebuild it from the prefixes. The engine itself is not changed."""
        inflight = sorted(
            (self._pending_from_slot(s) for s in self._slots
             if s is not None),
            key=lambda q: q.rid,
        )
        queued = [dataclasses.replace(q, gen=list(q.gen))
                  for q in self._queue]
        log_event(
            "snapshot", t=round(self._clock(), 6), inflight=len(inflight),
            queued=len(queued),
        )
        return EngineSnapshot(
            pending=inflight + queued, next_rid=self._next_rid,
            results=dict(self.results), stats=dict(self.counters),
        )

    def restore(self, snap: EngineSnapshot) -> None:
        """Load a ``snapshot`` into this fresh, idle engine: its next
        ``step``s re-prefill every in-flight request from its tokens so
        far and continue token-identically to an uninterrupted run."""
        if self.has_work() or self.results:
            raise RuntimeError(
                "restore requires a fresh idle engine (no queued/active "
                "work, no undelivered results)"
            )
        for q in snap.pending:
            self._check_fits(q)
        self._next_rid = snap.next_rid
        self.results.update(snap.results)
        for q in snap.pending:
            # Session ids are engine-local and this engine's tracker is
            # fresh: the turn completes as a plain request (its client
            # re-opens; the transcript-carrying resubmission makes that
            # lossless).
            self._queue.append(
                dataclasses.replace(q, gen=list(q.gen), session=None)
            )
        log_event(
            "restore", t=round(self._clock(), 6),
            pending=len(snap.pending), next_rid=snap.next_rid,
        )

    def adopt(self, entries) -> dict[int, int]:
        """Take over queued/resume entries from ANOTHER engine (the
        router's failover): each gets this engine's next rid and queues
        behind the work already here, in the order given, and continues
        token-identically. Works on a busy engine. Every entry is checked
        before any is queued. Returns {donor_rid: adopted_rid}."""
        entries = list(entries)
        for q in entries:
            self._check_fits(q)
        mapping: dict[int, int] = {}
        for q in entries:
            rid = self._next_rid
            self._next_rid += 1
            # Donor session ids mean nothing here: adopted turns finish as
            # plain requests; the router re-homes the session.
            self._queue.append(dataclasses.replace(
                q, rid=rid, gen=list(q.gen), session=None,
            ))
            mapping[q.rid] = rid
        return mapping

    def _check_fits(self, q: _Pending) -> None:
        if len(q.prompt) + q.max_new > self.max_len:
            raise ValueError(
                f"entry rid {q.rid} needs {len(q.prompt) + q.max_new} "
                f"cache positions but this engine's max_len is "
                f"{self.max_len}"
            )

    def device_ids(self) -> list[int]:
        return _device_ids(self.device)

    def compile_count(self) -> int:
        return _compile_count()

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict[str, Any]:
        """Scheduler occupancy, page-pool pressure (None on the dense
        engine: one schema for every engine, so the router reads it
        without asking which engine backs a replica), speculation and a
        copy of the monotonic ``counters``; pure host bookkeeping."""
        free_slots = sum(1 for s in self._slots if s is None)
        by_tier = {name: 0 for name in PRIORITIES}
        for q in self._queue:
            by_tier[TIER_NAME[q.tier]] += 1
        return _uniform_stats(
            self, role=self.role, kv_quant=self.kv_quant,
            queue_depth=len(self._queue), queue_depth_by_tier=by_tier,
            slots=self.slots, active_rows=self.slots - free_slots,
            free_slots=free_slots, speculative_k=self.speculative_k,
        )

    def cache_hbm_bytes(self) -> dict[str, int]:
        """Cache bytes: the dense engine holds slots x max_len positions
        whether rows are deep or not (the figure the paged pool is
        measured against); a prefill's transient scratch of slots x bucket
        positions is not counted."""
        n = self.slots * self.max_len * kv_bytes_per_position(self.cfg)
        return {"allocated": n, "peak_in_use": n}

    # -- bookkeeping ---------------------------------------------------------

    def _partial_tokens(self, prompt, gen) -> np.ndarray:
        return np.concatenate(
            [np.asarray(prompt, np.int32), np.asarray(gen, np.int32)]
        )

    def _pending_from_slot(self, s: _Slot, *, bump: bool = False,
                           nan_retried: bool | None = None) -> _Pending:
        """An in-flight row as a resume entry: its generated tokens become
        part of the prefix its re-admission prefills; ``bump`` charges one
        fault resume against the request's retry budget."""
        return _Pending(
            rid=s.rid, prompt=s.prompt, max_new=s.max_new, eos_id=s.eos_id,
            greedy=s.greedy, t=s.t, k=s.k, p=s.p, seed=s.seed,
            deadline=s.deadline, gen=list(s.generated), tier=s.tier,
            retries=s.retries + (1 if bump else 0),
            nan_retried=s.nan_retried if nan_retried is None else nan_retried,
            session=s.session, resub_len=s.resub_len,
            tenant_slot=s.tenant_slot,
        )

    def _finish(self, rid, state, tokens, reason, finished=None) -> None:
        self.results[rid] = RequestResult(
            rid=rid, state=state, tokens=tokens, reason=reason
        )
        self.counters[state.lower()] += 1
        if finished is not None:
            finished.append(rid)
        log_event(
            "retire", rid=rid, state=state, t=round(self._clock(), 6),
            n_tokens=len(tokens), reason=reason or None,
        )

    def _finish_pending(self, q: _Pending, state, reason,
                        finished=None) -> None:
        self._finish(q.rid, state, self._partial_tokens(q.prompt, q.gen),
                     reason, finished)

    def _finish_slot(self, s: _Slot, state, reason, finished=None) -> None:
        self._finish(s.rid, state,
                     self._partial_tokens(s.prompt, s.generated), reason,
                     finished)

    def _quarantine_slot(self, row: int, phase: str, finished) -> None:
        """Non-finite logits on a row: free it (its neighbours are
        untouched) and requeue its clean prefix for one fresh re-prefill;
        FAILED if it recurs. ``phase`` labels the log and the reason."""
        s = self._slots[row]
        self._slots[row] = None
        self._on_slot_freed(s)
        self.counters["nan_quarantines"] += 1
        if s.nan_retried:
            self._finish_slot(
                s, FAILED,
                "non-finite logits persisted after one quarantine retry "
                f"({phase})", finished,
            )
            return
        log_event(
            "quarantine", rid=s.rid, phase=phase, row=row,
            t=round(self._clock(), 6),
        )
        self._requeue([self._pending_from_slot(s, nan_retried=True)])

    def _quarantine_pending(self, req: _Pending, finished) -> None:
        """Non-finite logits in an admission prefill (dense engine): the
        token is discarded and the request retried once over a fresh
        re-prefill, then FAILED."""
        self.counters["nan_quarantines"] += 1
        if req.nan_retried:
            self._finish_pending(
                req, FAILED,
                "non-finite logits persisted after one quarantine retry "
                "(prefill)", finished,
            )
            return
        log_event("quarantine", rid=req.rid, phase="prefill",
                  t=round(self._clock(), 6))
        self._requeue([dataclasses.replace(req, gen=list(req.gen),
                                           nan_retried=True)])

    def _dispatch(self, kind: str, run, finished, group_pendings=()):
        """Run one forward with its sampling (``run() -> (tokens, bad)``,
        host arrays), consulting the fault injector before and after.
        Returns (tokens, bad), or None after a recovered failure
        (``_recover_dispatch_failure``; ``group_pendings`` are the queued
        entries this dispatch was admitting, requeued with the rows).
        Recovered: anything the injector raises, and ``RETRYABLE_ERRORS``
        from ``run``; any other error propagates (module docstring)."""
        self._take_cache_for_dispatch()
        inj = self._injector
        # An Exception, not BaseException: KeyboardInterrupt must stop the
        # serving loop, not be retried.
        try:
            if inj is not None:
                inj.before_dispatch(kind, self._ticks)
        except Exception as err:
            return self._recover_dispatch_failure(kind, err, finished,
                                                  group_pendings)
        try:
            toks, bad = run()
        except self.RETRYABLE_ERRORS as err:
            return self._recover_dispatch_failure(kind, err, finished,
                                                  group_pendings)
        if inj is not None:
            try:
                toks, bad = inj.after_dispatch(kind, self._ticks, toks, bad)
            except Exception as err:
                return self._recover_dispatch_failure(kind, err, finished,
                                                      group_pendings)
        self._fail_streak = 0
        return toks, bad

    def _take_cache_for_dispatch(self) -> None:
        """Hook: a dispatch holds the cache from its start, so a dispatch
        that fails before its forward still costs the cache — one
        allocation per failed dispatch, as the JAX engine's donated cache
        is consumed by every dispatch it enters."""
        self._live_cache()

    def _drop_cache_after_failure(self) -> None:
        """Hook of ``_recover_dispatch_failure``: no cache content is
        trusted after a failed dispatch. The dense engine drops its cache;
        the next dispatch allocates a zeroed one (``cache_allocs``)."""
        self._cache = None

    def _recover_dispatch_failure(self, kind: str, err: BaseException,
                                  finished, group_pendings=()) -> None:
        """A failed dispatch: the cache is dropped (dense) or the block
        pool reset (paged), and every in-flight row — with the entries
        the dispatch was admitting — becomes a resume entry with one retry
        charged (FAILED past ``request_retries``); then the backoff, or
        ``DispatchFailure`` past ``dispatch_retries`` consecutive
        failures. Queued requests are untouched."""
        self.counters["dispatch_failures"] += 1
        self._fail_streak += 1
        log_event(
            "dispatch_fail", kind=kind, tick=self._ticks,
            streak=self._fail_streak, error=type(err).__name__,
            t=round(self._clock(), 6),
        )
        lost = [self._pending_from_slot(s, bump=True)
                for s in self._slots if s is not None]
        lost += [dataclasses.replace(q, gen=list(q.gen), retries=q.retries + 1)
                 for q in group_pendings]
        self._slots = [None] * self.slots
        self._drop_cache_after_failure()
        kept = []
        for q in lost:
            if q.retries > self.request_retries:
                self._finish_pending(
                    q, FAILED,
                    f"dispatch failed ({type(err).__name__}) and the "
                    f"request exhausted its {self.request_retries} "
                    "fault-resume retries", finished,
                )
            else:
                self.counters["resumes"] += 1
                kept.append(q)
        self._requeue(kept)
        if (
            self.dispatch_retries is not None
            and self._fail_streak > self.dispatch_retries
        ):
            raise DispatchFailure(
                f"{self._fail_streak} consecutive dispatch failures "
                f"(> dispatch_retries {self.dispatch_retries}); engine "
                "state is consistent — every in-flight request was "
                "requeued (or FAILED past its retry budget); snapshot() "
                "and rebuild, or step again later"
            ) from err
        if self.retry_backoff_s > 0:
            self._sleep(self.retry_backoff_s * 2 ** (self._fail_streak - 1))

    def _requeue(self, pendings) -> None:
        """Merge resume entries back into the queue in ascending-rid (=
        submit) order."""
        if pendings:
            self._queue = collections.deque(
                sorted(list(self._queue) + list(pendings),
                       key=lambda q: q.rid)
            )

    def _expire(self, finished: list[int]) -> None:
        now = self._clock()
        for q in [q for q in self._queue
                  if q.deadline is not None and now >= q.deadline]:
            self._queue.remove(q)
            self._finish_pending(
                q, EXPIRED, f"deadline passed at t={now:.3f} while queued",
                finished,
            )
        for i, s in enumerate(self._slots):
            if s is not None and s.deadline is not None and now >= s.deadline:
                self._slots[i] = None
                self._on_slot_freed(s)
                self._finish_slot(
                    s, EXPIRED, f"deadline passed at t={now:.3f} mid-decode",
                    finished,
                )

    def _on_slot_freed(self, s: _Slot) -> None:
        """Hook: a slot left the slot list. A dense row's K/V just sits
        dirty in its row (the next admission overwrites what it reads);
        the paged engine releases the row's pages."""

    def _maybe_retire(self, row: int, finished: list[int]) -> None:
        s = self._slots[row]
        hit_eos = s.eos_id is not None and s.generated[-1] == s.eos_id
        if len(s.generated) < s.max_new and not hit_eos:
            return
        self._slots[row] = None
        self._on_slot_freed(s)
        self._finish_slot(s, DONE, "", finished)

    def _queue_key(self, q: _Pending):
        return queue_key(q.tier, q.deadline, q.rid)

    # -- dense admission -----------------------------------------------------

    def _resume_bucket(self, length: int) -> int:
        """The smallest prefill shape covering a resume prefix (the user
        buckets extended by max_len; the exact length in exact mode)."""
        for b in self._prefill_buckets:
            if b >= length:
                return b
        return length

    def _bucket_of(self, q: _Pending) -> int:
        if q.gen:
            return self._resume_bucket(len(q.prompt) + len(q.gen))
        return self.buckets.bucket_for(len(q.prompt))

    def _admit(self, params, finished: list[int]) -> None:
        """Priority-then-FIFO admission into the free rows; arrivals
        sharing a bucket prefill in one dispatch."""
        free = [i for i, s in enumerate(self._slots) if s is None]
        n = min(len(free), len(self._queue))
        if not n:
            return
        admitted = sorted(self._queue, key=self._queue_key)[:n]
        for q in admitted:
            self._queue.remove(q)
        by_bucket: dict[int, list[tuple[_Pending, int]]] = {}
        for req in admitted:
            by_bucket.setdefault(self._bucket_of(req), []).append(
                (req, free.pop(0))
            )
        groups = list(by_bucket.items())
        for gi, (bucket, group) in enumerate(groups):
            if not self._prefill_group(params, bucket, group, finished):
                # The dispatch failed: recovery requeued this group and
                # every in-flight row; the groups not yet dispatched go back
                # untouched (no retry charge) and admission stops this tick.
                self._requeue([q for _, g in groups[gi + 1:] for q, _ in g])
                return

    def _prefill_group(self, params, bucket, group, finished) -> bool:
        """One bucket's admission: a forward of shape [slots, bucket] at
        position 0, the admitted prompts first and zero rows as padding.
        A prefill at position 0 reads only the keys it writes, so it runs
        over a scratch cache of the bucket's length, and the admitted
        rows' first ``bucket`` positions are copied into their rows.
        Returns False when the dispatch failed (recovery already ran)."""
        n, b = len(group), self.slots
        targets = [row for _, row in group]
        ids = np.zeros((b, bucket), np.int32)
        plens = np.ones((b,), np.int64)
        tenants = np.zeros((b,), np.int64)
        pend = [req for req, _ in group]
        for j, req in enumerate(pend):
            prefix = self._partial_tokens(req.prompt, req.gen)
            ids[j, : prefix.shape[0]] = prefix
            plens[j] = prefix.shape[0]
            tenants[j] = req.tenant_slot

        @torch.no_grad()
        def run():
            self.counters["prefill_ticks"] += 1  # forwards that ran
            dev = self.device
            cache = self._live_cache()
            seg = decode.init_cache(self.cfg, b, bucket, device=dev,
                                    n_kv=self._mp.n_kv)
            logits, _ = self._mp.forward(
                params, torch.from_numpy(ids).to(dev), self.cfg, seg, 0,
                lora=self._lora(tenants))
            rows_t = torch.tensor(targets, device=dev)
            for name, c in cache.items():
                c[:, rows_t, :bucket] = seg[name][:, :n]
            last = logits[torch.arange(n, device=dev),
                          torch.from_numpy(plens[:n] - 1).to(dev)]
            return self._sample(last, pend, [len(q.gen) for q in pend])

        res = self._dispatch("prefill", run, finished, group_pendings=pend)
        if res is None:
            return False
        toks, bad = res
        for i, (req, row) in enumerate(group):
            if bad[i]:
                self._quarantine_pending(req, finished)
                continue
            self._slots[row] = _Slot(
                rid=req.rid, prompt=req.prompt, max_new=req.max_new,
                eos_id=req.eos_id, pos=int(plens[i]),
                generated=list(req.gen) + [int(toks[i])],
                greedy=req.greedy, t=req.t, k=req.k, p=req.p, seed=req.seed,
                deadline=req.deadline, tier=req.tier, retries=req.retries,
                nan_retried=req.nan_retried, session=req.session,
                resub_len=req.resub_len, tenant_slot=req.tenant_slot,
            )
            log_event(
                "admit", rid=req.rid, row=row, bucket=bucket,
                resume_prefix=len(req.gen) or None,
                t=round(self._clock(), 6),
            )
            self._maybe_retire(row, finished)
        return True

    # -- decode --------------------------------------------------------------

    def _decode_tick(self, params, finished: list[int]) -> None:
        """Every active row advances: one forward over all ``slots`` rows
        (free rows decode garbage at position 0 of their own row, which
        the host discards)."""
        self._decode_rows(
            params, [(i, s) for i, s in enumerate(self._slots)
                     if s is not None], finished,
        )

    def _cover_drafts(self, s: _Slot, n: int) -> int:
        """Hook: how many of a row's ``n`` drafts the cache covers (the
        dense row covers every committable position)."""
        return n

    def _lane_tables(self, lanes):
        """Hook: the paged engine's block tables for a decode forward."""
        return None

    def _decode_rows(self, params, ready, finished: list[int]) -> None:
        """One decode forward over the slot batch: rows in ``ready``
        ([(row, slot)]) advance, every other lane runs at position 0 and
        is discarded. Plain: [slots, 1], one token per row. Speculative:
        [slots, K+1] — lane 0 the row's last token, lanes 1.. its drafts —
        and each row commits 1..K+1 tokens (``_commit_spec``)."""
        b, width = self.slots, self._decode_width
        toks = np.zeros((b, width), np.int32)
        n_draft = np.zeros((b,), np.int64)
        pos = np.zeros((b,), np.int32)
        tenants = np.zeros((b,), np.int64)
        lanes: list[_Slot | None] = [None] * b
        for i, s in ready:
            drafts = _EMPTY_DRAFT
            if self.speculative_k:
                drafts = self._draft_tokens(s)
                drafts = drafts[: self._cover_drafts(s, len(drafts))]
            toks[i, 0] = s.generated[-1]
            toks[i, 1: 1 + len(drafts)] = drafts
            n_draft[i] = len(drafts)
            pos[i] = s.pos
            tenants[i] = s.tenant_slot
            lanes[i] = s
        tables = self._lane_tables(lanes)
        kind = "decode_spec_step" if self.speculative_k else "decode_step"

        # A sampled row commits lane 0 alone, which must be the plain
        # tick's token: the paged verify forward then gives lane 0 the
        # bits of a [slots, 1] step.
        sampled = any(not s.greedy for _, s in ready)

        def run():
            self.counters["decode_ticks"] += 1  # forwards that ran
            logits = self._forward(params, toks, pos, tables, tenants,
                                   window=True, lane0_alone=sampled)
            if not self.speculative_k:
                return self._sample(logits[:, -1], lanes)
            return self._spec_verify(logits, toks, n_draft, lanes)

        res = self._dispatch(kind, run, finished)
        if res is None:
            return
        out, bad = res
        for i, s in ready:
            if bad[i]:
                self._quarantine_slot(i, "decode", finished)
                continue
            if self.speculative_k:
                self._commit_spec(i, s, out[0][i], int(out[1][i]),
                                  int(n_draft[i]), finished)
                continue
            s.generated.append(int(out[i]))
            s.pos += 1
            self._maybe_retire(i, finished)

    # -- speculation ---------------------------------------------------------

    def _spec_verify(self, logits, toks, n_draft, lanes):
        """The verify tail of a speculative forward (``logits`` [B, K+1,
        V]): lane 0 is sampled with the row's own config (a sampled row
        commits exactly the plain tick's token: a paged tick holding one
        gives lane 0 the bits of a [slots, 1] step), the model's greedy
        chain over the window gives the accept lengths (on the card the
        plain decode's argmaxes but where two logits tie within the f32
        rounding, which depends on the rows sharing a GEMM).
        Returns ((out [B, K+1], n_acc [B]), bad [B]) as host arrays with
        ONE device->host copy (the accept lengths are integer logic on the
        host copy); the host commits ``out[b, :n_acc[b]+1]``."""
        ver = torch.argmax(logits.float(), dim=-1)  # [B, K+1]
        if all(r is None or r.greedy for r in lanes):
            tok0 = ver[:, 0]  # the greedy sampler's argmax of lane 0
        else:
            index = [0 if r is None else len(r.generated) for r in lanes]
            tok0 = decode.sample_token_rows(
                logits[:, 0], *self._sampling_rows(lanes, index))
        # NaN anywhere in the window flags the row: any lane's logits could
        # decide a committed token.
        bad = decode.nonfinite_rows(logits)
        host = torch.cat([tok0[:, None], ver, bad.long()[:, None]],
                         dim=1).cpu()
        n_acc = decode.speculative_accept(
            torch.from_numpy(toks[:, 1:]).long(), host[:, 1:-2],
            torch.from_numpy(n_draft))
        out = torch.cat([host[:, :1], host[:, 2:-1]], dim=1)
        return (out.numpy(), n_acc.numpy()), host[:, -1].numpy().astype(bool)

    def _draft_tokens(self, s: _Slot) -> np.ndarray:
        """Up to ``speculative_k`` drafts for one row — prompt lookup over
        its tokens so far (or ``draft_hook``), capped so every committable
        token's position stays inside the row's budget and the cache.
        Sampled rows draft nothing (exact sampled speculation needs
        rejection-sampling corrections, out of scope as in the JAX
        package)."""
        if not s.greedy:
            return _EMPTY_DRAFT
        cap = min(
            self.speculative_k,
            s.max_new - len(s.generated) - 1,
            self.max_len - s.pos - 1,
        )
        if cap <= 0:
            return _EMPTY_DRAFT
        hist = self._partial_tokens(s.prompt, s.generated)
        if self._draft_hook is not None:
            d = np.asarray(self._draft_hook(hist, cap), np.int64).reshape(-1)
            # Hook output is advisory: clipped to the vocab, a bad hook can
            # cost speed (rejected drafts), never an out-of-range lookup.
            return np.clip(d[:cap], 0, self.cfg.vocab_size - 1).astype(
                np.int32)
        return prompt_lookup_draft(hist, cap, ngram=self.spec_ngram)

    def _commit_spec(self, row: int, s: _Slot, out_row, n_acc: int,
                     n_draft: int, finished) -> None:
        """Commit one row's verified window: the accepted drafts plus the
        model's next token, clipped at EOS and the row's budget. Rejected
        drafts roll back by not advancing ``pos`` past the commit (module
        docstring)."""
        committed = 0
        for tok in out_row[: n_acc + 1]:
            s.generated.append(int(tok))
            s.pos += 1
            committed += 1
            if len(s.generated) >= s.max_new or (
                s.eos_id is not None and int(tok) == s.eos_id
            ):
                break  # EOS inside the window: later lanes discarded
        self.counters["drafted_tokens"] += n_draft
        self.counters["accepted_tokens"] += committed - 1
        self.counters["spec_commits"] += 1
        if n_draft:
            log_event("draft_accept", rid=s.rid, drafted=n_draft,
                      accepted=committed - 1, t=round(self._clock(), 6))
        self._maybe_retire(row, finished)


@dataclasses.dataclass
class KVHandoff:
    """One finished prefill leaving a PREFILL worker: the row's pages (per
    pool leaf, [L, max_pages, ...] in block-table order; int8 pools ship
    their scale leaves with them) and every host field a decode worker
    needs to continue the row bit-identically to a colocated run.
    ``entry`` doubles as the fault fallback: it is the ordinary resume
    entry for the same row, so a handoff that never completes degrades to
    the resume/failover path."""

    entry: Any            # _Pending resume entry (fault fallback + fields)
    pages: Any            # {leaf: [L, max_pages, ...] tensor}, a copy
    n_pages: int          # real (non-padding) table entries
    pos: int              # committed depth (== prefill_len on export)
    fold: int             # the token index of the row's next sampled draw
    generated: list       # resume gen + the final-chunk sampled token
    prefill_len: int
    resume_base: int
    page_size: int
    max_pages: int
    kv_quant: str
    src_rid: int          # engine-local rid on the SOURCE engine
    useful_bytes: int     # n_pages x page_size x bytes/position
    wire_bytes: int       # padded tree bytes actually shipped
    export_s: float       # host time of the export gather, synchronized


class PagedBatchedDecodeEngine(BatchedDecodeEngine):
    """Continuous-batching decode over a paged KV pool (module docstring).

    Knobs beyond ``BatchedDecodeEngine``'s: ``page_size`` (tokens per
    page; divides ``max_len``), ``pool_pages`` (pool capacity including
    the scratch page 0; default ``slots * max_len / page_size + 1``),
    ``prefill_chunk`` (a page multiple dividing ``max_len``; default the
    largest such <= 64), ``paged_attention``, ``kv_quant``,
    ``batch_admit_free_frac`` (free-pool fraction below which BATCH
    requests stop admitting), ``session_pin_budget_pages``, ``role``
    ("colocated", "prefill" or "decode": disaggregated serving, module
    docstring). Prompts have no buckets: the chunk is the one prefill
    shape."""

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        slots: int,
        max_len: int,
        page_size: int = 16,
        pool_pages: int | None = None,
        prefill_chunk: int | None = None,
        paged_attention: str = "auto",
        kv_quant: str = "none",
        batch_admit_free_frac: float = 0.25,
        session_pin_budget_pages: int | None = None,
        role: str = "colocated",
        **kw,
    ) -> None:
        super().__init__(cfg, slots=slots, max_len=max_len, **kw)
        self.role = _check_role(role)
        if page_size < 1 or max_len % page_size:
            raise ValueError(
                f"page_size ({page_size}) must be a positive divisor of "
                f"max_len ({max_len}): the block table addresses exactly "
                "max_len/page_size pages per row"
            )
        self.page_size = int(page_size)
        self.max_pages = max_len // page_size
        if prefill_chunk is None:
            # Largest page multiple <= 64 that divides max_len: the chunk is
            # both the per-tick prefill quantum and the prefix-sharing grain.
            prefill_chunk = page_size
            while (
                prefill_chunk * 2 <= min(64, max_len)
                and max_len % (prefill_chunk * 2) == 0
            ):
                prefill_chunk *= 2
        if (
            prefill_chunk < page_size
            or prefill_chunk % page_size
            or max_len % prefill_chunk
        ):
            raise ValueError(
                f"prefill_chunk ({prefill_chunk}) must be a multiple of "
                f"page_size ({page_size}) that divides max_len "
                f"({max_len}) — chunk starts are page-aligned and the "
                "padded final chunk must stay inside the row's table"
            )
        self.chunk = int(prefill_chunk)
        if pool_pages is None:
            pool_pages = slots * self.max_pages + 1
        if pool_pages < self.max_pages + 1:
            raise ValueError(
                f"pool_pages ({pool_pages}) must be >= max_len/page_size "
                f"+ 1 = {self.max_pages + 1} (one full-length row plus "
                "the scratch page), or a single deep request could "
                "never be served"
            )
        self.pool_pages = int(pool_pages)
        if not 0.0 <= batch_admit_free_frac <= 1.0:
            raise ValueError(
                f"batch_admit_free_frac must be in [0, 1], got "
                f"{batch_admit_free_frac}"
            )
        self.batch_admit_free_frac = float(batch_admit_free_frac)
        if paged_attention == "auto":
            paged_attention = (
                "kernel" if self.device.type == "cuda" else "gather"
            )
        if paged_attention == "kernel_interpret":
            raise ValueError(
                "paged_attention='kernel_interpret' is the JAX package's "
                "Pallas interpret mode; this port has no interpreter — use "
                "'kernel' (on a CPU device it runs the kernel's plain "
                "version) or 'gather'"
            )
        if paged_attention not in ("gather", "kernel"):
            raise ValueError(
                f"paged_attention must be 'auto', 'gather' or 'kernel', "
                f"got {paged_attention!r}"
            )
        self.paged_attention = paged_attention
        self.kv_quant = quant.check_mode("kv_quant", kv_quant)
        self.pool = BlockPool(self.pool_pages, self.page_size, self.chunk)
        # Session retention pins at most half the pool by default; past
        # the budget the longest-idle session is evicted loudly.
        self._sessions = SessionTracker(
            self.pool,
            pin_budget_pages=(
                (self.pool_pages - 1) // 2
                if session_pin_budget_pages is None
                else session_pin_budget_pages
            ),
            clock=self._clock,
        )
        self.counters.update(preemptions=0, preempt_priority=0,
                             batch_yield_ticks=0, handoffs_out=0,
                             handoffs_in=0)
        # The pool is allocated once and written in place for the
        # engine's life; a failed dispatch resets the block pool instead
        # (``_drop_cache_after_failure``).
        self._cache = self._new_cache()
        log_event(
            "pool_build",
            quant=self.kv_quant,
            pool_pages=self.pool_pages,
            page_size=self.page_size,
            prefill_chunk=self.chunk,
            slots=self.slots,
            device=str(self.device),
            pool_hbm_bytes=self.cache_hbm_bytes()["allocated"],
        )

    # -- cache and forward ---------------------------------------------------

    def _new_cache(self) -> decode.Cache:
        self.counters["cache_allocs"] += 1
        return decode.init_paged_cache(
            self.cfg, self.pool_pages, self.page_size, device=self.device,
            kv_quant=self.kv_quant, n_kv=self._mp.n_kv,
        )

    def _check_prompt_shape(self, tp: int) -> None:
        """No buckets: chunked prefill takes any prompt length."""

    @torch.no_grad()
    def _forward(self, params, ids, pos, tables=None, tenants=None,
                 window=False, lane0_alone=False):
        """One forward over the pool; numpy operands in, logits out. A
        decode forward (``window``) runs a speculative verify window's
        queries as single-token rows of the paged kernel, as plain
        decode's, and with ``lane0_alone`` gives lane 0 the bits of a
        [slots, 1] step; a prefill chunk takes the gather path."""
        dev = self.device
        logits, _ = self._mp.forward(
            params,
            torch.from_numpy(ids).to(dev),
            self.cfg,
            self._cache,
            torch.from_numpy(pos).to(dev),
            block_tables=torch.from_numpy(tables).to(dev),
            paged_impl=self.paged_attention,
            kv_quant=self.kv_quant,
            lora=self._lora(np.zeros((self.slots,), np.int64)
                            if tenants is None else tenants),
            decode_window=window,
            lane0_alone=lane0_alone,
        )
        return logits

    def warmup(self, params) -> int:
        """Place the params and run one prefill chunk and one decode
        forward on the scratch page (all-zero tables), and a disaggregated
        role's side of the page copies, so the first request pays no
        one-time cost (the kernel build and load, library handles). Idle
        engines only. Returns ``compile_count()``."""
        if self.has_work():
            raise RuntimeError("warmup requires an idle engine")
        params = self._place_params(params)
        for t, window in ((self.chunk, False), (self._decode_width, True)):
            self._forward(
                params, np.zeros((self.slots, t), np.int32),
                np.zeros((self.slots,), np.int32),
                np.zeros((self.slots, self.max_pages), np.int32),
                window=window,
            )
        # Each disaggregated role warms its side of the handoff pair on
        # the scratch page: export on a prefill worker, import on a
        # decode worker (one page, page 0 into page 0).
        table = np.zeros((self.max_pages,), np.int32)
        if self.role == "prefill":
            self._kv_export(table)
        elif self.role == "decode":
            self._kv_import(self._kv_export(table), table[:1])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.compile_count()

    def _take_cache_for_dispatch(self) -> None:
        """The pool lives as long as the engine."""

    def _drop_cache_after_failure(self) -> None:
        """No page content is trusted after a failed dispatch (the forward
        may have written some pages, or half of them): the block pool is
        reset — every page freed, the prefix cache dropped — and the pins
        with it (the transcripts survive; the next turn pays its prefill
        again). The pool tensor itself is kept: every page is written
        before it is read again."""
        self.pool.reset()
        self._sessions.on_pool_reset()

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict[str, Any]:
        out = super().stats()
        ps = self.pool.stats
        out.update(
            paged_attention=self.paged_attention,
            pool_pages=self.pool_pages,
            free_pages=self.pool.free_pages(),
            pages_in_use=self.pool.pages_in_use(),
            session_pinned_pages=self.pool.pinned_pages(),
            sessions=len(self._sessions),
            prefix_hit_rate=round(
                ps["prefix_hits"] / max(1, ps["prefix_queries"]), 4
            ),
        )
        out["counters"]["session_evictions"] = self._sessions.evictions
        return out

    def cache_hbm_bytes(self) -> dict[str, int]:
        """Allocated pool bytes and the peak referenced by live rows."""
        per = kv_bytes_per_position(self.cfg, self.kv_quant)
        return {
            "allocated": self.pool_pages * self.page_size * per,
            "peak_in_use": (
                self.pool.stats["peak_pages_in_use"] * self.page_size * per
            ),
        }

    # -- bookkeeping ---------------------------------------------------------

    def _finish(self, rid, state, tokens, reason, finished=None) -> None:
        # Any terminal state clears a session turn's in-flight marker (a
        # DONE turn recorded its transcript first, _retire_session_turn).
        self._sessions.on_terminal(rid)
        super()._finish(rid, state, tokens, reason, finished)

    def _on_slot_freed(self, s: _PagedSlot) -> None:
        self.pool.release(s.pids)
        s.pids = []

    def _recover_dispatch_failure(self, kind: str, err: BaseException,
                                  finished, group_pendings=()) -> None:
        # Every page is about to be freed by the pool reset: the slots'
        # page lists must not release them a second time.
        for s in self._slots:
            if s is not None:
                s.pids = []
        super()._recover_dispatch_failure(kind, err, finished,
                                          group_pendings)

    def _maybe_retire(self, row: int, finished: list[int]) -> None:
        s = self._slots[row]
        hit_eos = s.eos_id is not None and s.generated[-1] == s.eos_id
        if len(s.generated) < s.max_new and not hit_eos:
            return
        if s.session is not None:
            self._retire_session_turn(s)
        self._slots[row] = None
        self._on_slot_freed(s)
        self._finish_slot(s, DONE, "", finished)

    # -- sessions ------------------------------------------------------------

    def open_session(self) -> int:
        """Open one multi-turn chat session (``serving/session``); returns
        the sid ``submit(session=)`` takes. Turn N resubmits the
        conversation so far and pays about one chunk of prefill through
        the pinned prefix cache."""
        return self._sessions.open()

    def close_session(self, sid: int) -> None:
        """Close a session: its pins return to ordinary LRU retention.
        Unknown sids raise."""
        self._sessions.close(sid)

    def _session_checkin(self, session, prompt) -> int:
        return 0 if session is None else self._sessions.check_turn(
            session, prompt)

    def _session_begin(self, session, rid) -> None:
        if session is not None:
            self._sessions.begin_turn(session, rid)

    def _retire_session_turn(self, s: _PagedSlot) -> None:
        """A session turn retires DONE: publish its decode-written full
        chunks (prefill published the prompt's; this must run before the
        row's pages are released), then hand the tracker the new
        transcript and the full chain to pin."""
        toks = self._partial_tokens(s.prompt, s.generated)
        cp = self.chunk // self.page_size
        key = s.chain_key  # chain at the last prefill-published boundary
        for st in range(
            (s.prefill_len // self.chunk) * self.chunk,
            (s.pos // self.chunk) * self.chunk,
            self.chunk,
        ):
            first = st // self.page_size
            key = self.pool.register_chunk(
                toks, st, s.table[first: first + cp].tolist(), prev_key=key,
            )
        self._sessions.on_turn_done(
            s.session, toks, self.pool.chain_keys(toks, s.pos)
        )

    # -- scheduler -----------------------------------------------------------

    def _batch_headroom(self) -> bool:
        """BATCH admission gate: at least ``batch_admit_free_frac`` of the
        pool is allocatable (free or LRU-reclaimable)."""
        return (
            self.pool.allocatable_pages()
            >= self.batch_admit_free_frac * (self.pool_pages - 1)
        )

    def _admit(self, params, finished: list[int]) -> None:
        free = [i for i, s in enumerate(self._slots) if s is None]
        ordered = None
        blocked: set[int] = set()
        while self._queue:
            # Priority-ordered admission; BATCH entries are SKIPPED (not
            # blocking) while the pool lacks headroom.
            if ordered is None:
                ordered = sorted(self._queue, key=self._queue_key)
            req = None
            headroom = None
            for cand in ordered:
                if cand.rid in blocked:
                    continue
                if cand.tier == TIER_RANK[BATCH]:
                    if headroom is None:
                        headroom = self._batch_headroom()
                    if not headroom:
                        continue
                req = cand
                break
            if req is None:
                break
            if not free:
                # No free slot: an INTERACTIVE arrival may preempt a
                # strictly-lower-priority row; everyone else waits.
                n0 = len(self._queue)
                row = self._preempt_lower_priority(req.tier)
                if len(self._queue) != n0:
                    ordered = None
                if row is None:
                    break
                free.append(row)
            slot = self._try_allocate(req)
            while slot is None:
                # Page shortage: idle-session pins break first (the
                # session only loses retention); then strictly-lower-
                # priority rows are preempted. BATCH never breaks a pin.
                if (req.tier != TIER_RANK[BATCH]
                        and self._sessions.evict_idle()):
                    slot = self._try_allocate(req)
                    continue
                n0 = len(self._queue)
                row = self._preempt_lower_priority(req.tier)
                if len(self._queue) != n0:
                    ordered = None
                if row is None:
                    break
                free.append(row)
                slot = self._try_allocate(req)
            if slot is None:
                # The head waits for pages while decode runs and rows
                # retire. With NO live rows nothing can retire, so only
                # then do later entries go around it this tick.
                if any(s is not None for s in self._slots):
                    break
                blocked.add(req.rid)
                continue
            self._queue.remove(req)
            if ordered is not None:
                ordered.remove(req)
            row = free.pop(0)
            self._slots[row] = slot
            log_event(
                "admit", rid=slot.rid, row=row,
                cached_tokens=slot.pos or None,
                resume_prefix=slot.resume_base or None,
                priority=(
                    TIER_NAME[slot.tier]
                    if slot.tier != TIER_RANK[STANDARD] else None
                ),
                session=slot.session,
                t=round(self._clock(), 6),
            )
        self._chunk_prefill_tick(params, finished)

    def _preempt_lower_priority(self, tier: int) -> int | None:
        """Preempt the lowest-priority-then-youngest row whose tier is
        strictly below an INTERACTIVE arrival's; returns the freed row, or
        None when the arrival may not preempt or nothing is outranked."""
        if tier != TIER_RANK[INTERACTIVE]:
            return None
        cands = [
            (preemption_key(s.tier, s.rid), i)
            for i, s in enumerate(self._slots)
            if s is not None and s.tier > tier
        ]
        if not cands:
            return None
        (_, rid), row = max(cands)
        s = self._slots[row]
        self._slots[row] = None
        self._on_slot_freed(s)
        self.counters["preempt_priority"] += 1
        log_event(
            "preempt_priority", rid=rid, row=row, depth=s.pos,
            victim_tier=TIER_NAME[s.tier], for_tier=TIER_NAME[tier],
            t=round(self._clock(), 6),
        )
        self._requeue([self._pending_from_slot(s)])
        return row

    def _try_allocate(self, req: _Pending) -> _PagedSlot | None:
        """A slot for ``req`` if the pool covers its prefill extent: shared
        prefix pages from the prefix cache, private pages for the rest,
        rounded up to the chunk the padded final prefill writes."""
        prefix = self._partial_tokens(req.prompt, req.gen)
        plen = prefix.shape[0]
        if req.nan_retried:
            # A quarantine retry re-prefills from scratch on purpose.
            cached, shared, chain_key = 0, [], ""
        else:
            cached, shared, chain_key = self.pool.match_prefix(
                prefix, plen - 1
            )
        ext = -(-plen // self.chunk) * self.chunk  # padded prefill extent
        fresh = self.pool.alloc(ext // self.page_size - len(shared))
        if fresh is None:
            # Deferred: undo the match so retries do not inflate the stats.
            if not req.nan_retried:
                self.pool.cancel_match(cached, shared)
            return None
        if cached:
            log_event(
                "prefix_hit", rid=req.rid, cached_tokens=cached,
                prompt_len=plen, t=round(self._clock(), 6),
            )
        pids = list(shared) + fresh
        table = np.zeros((self.max_pages,), np.int32)
        table[: len(pids)] = pids
        if req.session is not None:
            self._sessions.note_admit(req.rid, cached, req.resub_len)
        return _PagedSlot(
            rid=req.rid, prompt=req.prompt, max_new=req.max_new,
            eos_id=req.eos_id, pos=cached, generated=list(req.gen),
            greedy=req.greedy, t=req.t, k=req.k, p=req.p, seed=req.seed,
            deadline=req.deadline, tier=req.tier,
            prefix=prefix, prefill_len=plen, table=table, pids=pids,
            n_pages=len(pids), resume_base=len(req.gen), chain_key=chain_key,
            retries=req.retries, nan_retried=req.nan_retried,
            session=req.session, resub_len=req.resub_len,
            tenant_slot=req.tenant_slot,
        )

    def _chunk_prefill_tick(self, params, finished: list[int]) -> None:
        """Advance every mid-prefill row by ONE chunk in one forward of
        fixed shape [slots, chunk]: the rows that prefill come first, the
        rest ride on the scratch page (all-zero tables) and are
        discarded. The fixed shape makes a row's values independent of
        how many rows share its forward — on the card cuBLAS picks its
        kernel, and with it the summation order, by shape — so a request's
        tokens do not depend on its neighbours, and ``warmup`` runs the
        one prefill shape serving uses. (The JAX engine pads a group to
        the next power of two.)"""
        rows = [
            (i, s) for i, s in enumerate(self._slots)
            if s is not None and not s.ready
        ]
        if rows and any(
            s is not None and s.ready and s.tier == TIER_RANK[INTERACTIVE]
            for s in self._slots
        ):
            # BATCH prefill yields to a generating interactive row.
            rows = [(i, s) for i, s in rows if s.tier != TIER_RANK[BATCH]]
        if not rows:
            return
        n = len(rows)
        chunks = np.zeros((self.slots, self.chunk), np.int32)
        valid = np.ones((self.slots,), np.int64)
        start = np.zeros((self.slots,), np.int32)
        tables = np.zeros((self.slots, self.max_pages), np.int32)
        tenants = np.zeros((self.slots,), np.int64)
        for j, (_, s) in enumerate(rows):
            v = min(self.chunk, s.prefill_len - s.pos)
            chunks[j, :v] = s.prefix[s.pos : s.pos + v]
            valid[j] = v
            start[j] = s.pos
            tables[j] = s.table
            tenants[j] = s.tenant_slot

        def run():
            self.counters["prefill_ticks"] += 1  # forwards that ran
            logits = self._forward(params, chunks, start, tables, tenants)
            last = logits[torch.arange(n, device=self.device),
                          torch.from_numpy(valid[:n] - 1).to(self.device)]
            # Only rows on their final chunk keep the sampled token.
            return self._sample(
                last,
                [s if s.pos + valid[j] >= s.prefill_len else None
                 for j, (_, s) in enumerate(rows)],
            )

        res = self._dispatch("prefill", run, finished)
        if res is None:
            return  # recovery converted every in-flight row already
        toks, bad = res
        for j, (row, s) in enumerate(rows):
            if bad[j]:
                self._quarantine_slot(row, "prefill", finished)
                continue
            v = int(valid[j])
            if v == self.chunk:
                # A full chunk lies inside the prefix: publish its pages
                # for prefix sharing (clean chunks only).
                cp = self.chunk // self.page_size
                first = s.pos // self.page_size
                s.chain_key = self.pool.register_chunk(
                    s.prefix, s.pos, s.table[first : first + cp].tolist(),
                    prev_key=s.chain_key,
                )
            s.pos += v
            if s.pos >= s.prefill_len:
                s.generated.append(int(toks[j]))
                if self.role == "prefill":
                    # The row parks here, pages held, until the router's
                    # pump hands it to a decode worker.
                    log_event(
                        "prefill_done", rid=s.rid,
                        prompt_len=s.prefill_len, pages=s.n_pages,
                        bytes=s.n_pages * self.page_size
                        * kv_bytes_per_position(self.cfg, self.kv_quant),
                        t=round(self._clock(), 6),
                    )
                self._maybe_retire(row, finished)

    def _decode_tick(self, params, finished: list[int]) -> None:
        if self.role == "prefill":
            # A prefill worker never decodes: finished rows park until
            # ``export_handoff`` (a max_new == 1 row already retired at
            # its final chunk).
            return
        # BATCH rows sit out the tick while an interactive row is live
        # (their lanes stay on the scratch page; their tokens are delayed,
        # never changed).
        interactive_live = any(
            s is not None and s.tier == TIER_RANK[INTERACTIVE]
            for s in self._slots
        )
        self._ensure_decode_pages(finished, skip_batch=interactive_live)
        ready = []
        yielded = False
        for i, s in enumerate(self._slots):
            if s is None or not s.ready:
                continue
            if interactive_live and s.tier == TIER_RANK[BATCH]:
                yielded = True
                continue
            ready.append((i, s))
        if yielded:
            self.counters["batch_yield_ticks"] += 1
        if ready:
            self._decode_rows(params, ready, finished)

    def _lane_tables(self, lanes):
        """Free and mid-prefill lanes stay all-zero: table 0 -> the scratch
        page, so their garbage never touches a live page."""
        tables = np.zeros((self.slots, self.max_pages), np.int32)
        for i, s in enumerate(lanes):
            if s is not None:
                tables[i] = s.table
        return tables

    def _cover_drafts(self, s: _PagedSlot, n: int) -> int:
        return self._grow_for_drafts(s, n)

    def _grow_for_drafts(self, s: _PagedSlot, n: int) -> int:
        """Best-effort block-table growth covering a row's draft window
        (committable positions pos..pos+n need real pages: an accepted
        draft's K/V becomes the row's cache). Returns how many drafts are
        covered. Never preempts a live row and never breaks a session pin:
        drafts are an optimisation, so page pressure shrinks the window
        (the verify forward still commits its one guaranteed token on the
        already-covered page; lanes past the shrunk window ride table-zero
        lanes onto the scratch page)."""
        while s.n_pages * self.page_size <= s.pos + n:
            got = self.pool.alloc(1)
            if got is None:
                n = s.n_pages * self.page_size - s.pos - 1
                break
            s.table[s.n_pages] = got[0]
            s.pids += got
            s.n_pages += 1
        return max(0, n)

    def _ensure_decode_pages(self, finished, skip_batch: bool = False):
        """Grow each decode-ready row's table to cover its next write.
        Pool exhaustion preempts the lowest-priority-then-youngest OTHER
        row (its tokens so far requeue as a resume entry; no token is
        lost). ``skip_batch``: yielding batch rows do not advance, so they
        do not grow."""
        for i in range(self.slots):
            # Re-read the live slot list: a preemption fired for an earlier
            # row may have freed this one.
            s = self._slots[i]
            if s is None or not s.ready:
                continue
            if skip_batch and s.tier == TIER_RANK[BATCH]:
                continue
            if s.pos // self.page_size < s.n_pages:
                continue
            while True:
                got = self.pool.alloc(1)
                if got is not None:
                    s.table[s.n_pages] = got[0]
                    s.pids += got
                    s.n_pages += 1
                    break
                # Retention never deadlocks allocation: idle-session pins
                # break before any live row is preempted.
                if self._sessions.evict_idle():
                    continue
                others = [
                    o.tier for o in self._slots
                    if o is not None and o.rid != s.rid
                ]
                if others and max(others) < s.tier:
                    # Every neighbour outranks this row: it yields its own
                    # pages.
                    self._preempt_row(i)
                    break
                if not self._preempt_one(exclude_rid=s.rid):
                    raise PagePoolExhausted(
                        f"no KV page available for rid {s.rid} at depth "
                        f"{s.pos} and nothing left to preempt — "
                        f"pool_pages={self.pool_pages} cannot hold one "
                        "row this deep"
                    )

    def _preempt_one(self, *, exclude_rid: int) -> bool:
        cands = [
            (preemption_key(s.tier, s.rid), i)
            for i, s in enumerate(self._slots)
            if s is not None and s.rid != exclude_rid
        ]
        if not cands:
            return False
        self._preempt_row(max(cands)[1])
        return True

    def _preempt_row(self, row: int) -> None:
        """Convert one active row to a resume entry, pages released."""
        s = self._slots[row]
        self._slots[row] = None
        self._on_slot_freed(s)
        self.counters["preemptions"] += 1
        log_event(
            "preempt", rid=s.rid, row=row, depth=s.pos,
            generated=len(s.generated) - s.resume_base,
            t=round(self._clock(), 6),
        )
        self._requeue([self._pending_from_slot(s)])

    # -- disaggregation: KV handoff -------------------------------------------

    def _kv_copy(self, kind: str, run):
        """Run one page copy (``kind`` "kv_export" or "kv_import"),
        consulting the fault injector before and after as ``_dispatch``
        does for a forward. Returns (result, None), or (None, error) when
        the copy failed recoverably: anything the injector raises, and
        ``RETRYABLE_ERRORS`` from the copy itself. The caller owns the
        recovery."""
        inj = self._injector
        try:
            if inj is not None:
                inj.before_dispatch(kind, self._ticks)
        except Exception as err:
            return None, err
        try:
            out = run()
        except self.RETRYABLE_ERRORS as err:
            return None, err
        if inj is not None:
            try:
                inj.after_dispatch(kind, self._ticks, None, None)
            except Exception as err:
                return None, err
        return out, None

    def _kv_export(self, table) -> dict[str, torch.Tensor]:
        """One row's pages off the pool, per leaf [L, max_pages, ...] in
        table order: an indexed read into NEW tensors, so the source pages
        can be freed and rewritten once the handoff completes. Padded
        table entries are 0 and read the scratch page."""
        idx = torch.from_numpy(np.asarray(table, np.int64)).to(self.device)
        return {k: v[:, idx] for k, v in self._cache.items()}

    def _kv_import(self, pages, table) -> None:
        """Write exported ``pages`` into this pool at the pages of
        ``table`` ([n] fresh page ids, in order): only the first n entries
        of each leaf — the padding past them is the source's scratch page
        and is not copied."""
        n = len(table)
        idx = torch.from_numpy(np.asarray(table, np.int64)).to(self.device)
        for k, v in self._cache.items():
            v[:, idx] = pages[k][:, :n].to(self.device)

    def submit(self, prompt, max_new_tokens: int, **kw) -> int:
        if self.role == "decode":
            raise ValueError(
                "this engine is a DECODE worker: it accepts rows only "
                "via import_handoff (finished prefills) or adopt "
                "(failover resume entries) — route fresh prompts to a "
                "prefill or colocated worker"
            )
        return super().submit(prompt, max_new_tokens, **kw)

    def handoff_ready(self) -> list[int]:
        """Engine rids of rows parked on this PREFILL worker with their
        prefill finished — the rows ``export_handoff`` can ship. Empty
        on every other role (colocated rows decode in place)."""
        if self.role != "prefill":
            return []
        return [s.rid for s in self._slots if s is not None and s.ready]

    def export_handoff(self, rid: int) -> KVHandoff | None:
        """Gather one parked row's pages off the pool and package what a
        decode worker needs to continue it. Read-only: the row stays live
        (pages held) until ``complete_handoff`` confirms the import, so a
        destination dying mid-handoff costs only the gather. Returns None
        when the gather failed (an injected fault or a retryable error):
        nothing was changed, and the row stays parked for the next
        try."""
        s = next(
            (x for x in self._slots if x is not None and x.rid == rid),
            None,
        )
        if s is None:
            raise KeyError(f"no active row with rid {rid} to hand off")
        if not s.ready:
            raise ValueError(
                f"rid {rid} is mid-prefill (pos {s.pos} < "
                f"{s.prefill_len}) — only finished prefills hand off"
            )
        t0 = time.perf_counter()
        pages, err = self._kv_copy("kv_export",
                                   lambda: self._kv_export(s.table))
        if err is not None:
            self.counters["dispatch_failures"] += 1
            log_event(
                "dispatch_fail", kind="kv_export", tick=self._ticks,
                streak=self._fail_streak, error=type(err).__name__,
                t=round(self._clock(), 6),
            )
            return None
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        export_s = time.perf_counter() - t0
        wire = sum(v.numel() * v.element_size() for v in pages.values())
        return KVHandoff(
            entry=self._pending_from_slot(s),
            pages=pages, n_pages=s.n_pages, pos=s.pos,
            fold=len(s.generated), generated=list(s.generated),
            prefill_len=s.prefill_len, resume_base=s.resume_base,
            page_size=self.page_size, max_pages=self.max_pages,
            kv_quant=self.kv_quant, src_rid=s.rid,
            useful_bytes=(s.n_pages * self.page_size
                          * kv_bytes_per_position(self.cfg, self.kv_quant)),
            wire_bytes=int(wire), export_s=export_s,
        )

    def complete_handoff(self, rid: int) -> None:
        """The destination confirmed the import: release the source row
        WITHOUT a terminal result — ownership (and the client's rid
        mapping, which the router owns) moved to the destination engine.
        The freed pages go back to this worker's pool."""
        for i, s in enumerate(self._slots):
            if s is not None and s.rid == rid:
                self._slots[i] = None
                n = s.n_pages
                self._on_slot_freed(s)
                self.pool.note_handoff_out(n)
                self.counters["handoffs_out"] += 1
                return
        raise KeyError(f"no active row with rid {rid} to complete")

    def can_import_handoff(self, h: KVHandoff) -> bool:
        """The host-side gate the router's pump scores targets with: a
        free slot row and allocatable pool headroom for the row's pages
        (LRU-reclaimable cached prefixes count), on the same page
        geometry."""
        return (
            self.role != "prefill"
            and any(s is None for s in self._slots)
            and self.pool.allocatable_pages() >= h.n_pages
            and h.page_size == self.page_size
            and h.max_pages == self.max_pages
            and h.kv_quant == self.kv_quant
        )

    def import_handoff(
        self, h: KVHandoff, finished: list[int] | None = None
    ) -> int | None:
        """Land one exported row in this worker's pool (its pages copied
        into freshly allocated ones) and seat it as a decode-ready slot
        under a fresh local rid. Returns the new rid, or None when the
        import could not land: no free row or pages, or the copy failed
        and was RECOVERED like any failed dispatch (pool reset, in-flight
        rows to resume entries; terminal rids from that recovery land in
        ``finished``; past ``dispatch_retries`` it raises
        ``DispatchFailure``). The source row is untouched either way until
        ``complete_handoff``."""
        if self.role == "prefill":
            raise ValueError(
                "a PREFILL worker cannot import handoffs — it only "
                "exports them"
            )
        if (
            h.page_size != self.page_size
            or h.max_pages != self.max_pages
            or h.kv_quant != self.kv_quant
        ):
            raise ValueError(
                "kv_handoff geometry mismatch: source pages are "
                f"(page_size={h.page_size}, max_pages={h.max_pages}, "
                f"kv_quant={h.kv_quant!r}) but this engine is "
                f"(page_size={self.page_size}, max_pages="
                f"{self.max_pages}, kv_quant={self.kv_quant!r}) — "
                "disaggregated fleets must share the page geometry"
            )
        q = h.entry
        if len(q.prompt) + q.max_new > self.max_len:
            raise ValueError(
                f"handed-off entry needs {len(q.prompt) + q.max_new} "
                f"cache positions but this engine's max_len is "
                f"{self.max_len}"
            )
        row = next(
            (i for i, s in enumerate(self._slots) if s is None), None
        )
        if row is None:
            return None
        pids = self.pool.alloc_for_handoff(h.n_pages)
        if pids is None:
            return None
        table = np.zeros((self.max_pages,), np.int32)
        table[: h.n_pages] = pids
        _, err = self._kv_copy(
            "kv_import", lambda: self._kv_import(h.pages, pids))
        if err is not None:
            # No page content is trusted after a failed copy: the same
            # recovery as a failed forward (pool reset, rows requeued).
            self.pool.release(pids)
            self._recover_dispatch_failure(
                "kv_import", err,
                finished if finished is not None else [],
            )
            return None
        rid = self._next_rid
        self._next_rid += 1
        self._slots[row] = _PagedSlot(
            rid=rid, prompt=q.prompt, max_new=q.max_new, eos_id=q.eos_id,
            pos=h.pos, generated=list(h.generated), greedy=q.greedy,
            t=q.t, k=q.k, p=q.p, seed=q.seed, deadline=q.deadline,
            tier=q.tier, retries=q.retries, nan_retried=q.nan_retried,
            # Sessions are engine-local (the pins live on the source): a
            # handed-off turn finishes as a plain request, as adopt().
            session=None, resub_len=0, tenant_slot=q.tenant_slot,
            prefix=self._partial_tokens(q.prompt,
                                        list(q.gen)[: h.resume_base]),
            prefill_len=h.prefill_len, table=table, pids=list(pids),
            n_pages=h.n_pages, resume_base=h.resume_base, chain_key="",
        )
        self.counters["handoffs_in"] += 1
        return rid
