"""Serving: the engines (serial ``DecodeEngine``, continuous batching over a
dense cache, ``BatchedDecodeEngine``, or over a paged pool,
``PagedBatchedDecodeEngine``), the request-lifecycle
vocabulary (terminal states, results, snapshots — ``serving/lifecycle``),
the deterministic fault-injection harness (``serving/chaos``), the seeded
workload generator (``serving/workload``), multi-turn sessions
(``serving/session``), multi-tenant LoRA adapters (``serving/adapters``),
and the serving tier over them: the health-checked multi-replica
``ReplicaRouter`` (``serving/router``, with the disaggregated KV handoff
pump) and the asyncio HTTP/SSE front door (``serving/server``, imported
directly to keep this package import light). The entry points are
``serving.serve``, ``serving.loadgen``, ``serving.generate``,
``serving.soak`` and ``serving.decode_bench``."""

from pytorch_distributed_tpu_torch.serving.block_pool import BlockPool
from pytorch_distributed_tpu_torch.serving.chaos import (
    Fault,
    FaultInjector,
    RouterFault,
    RouterFaultInjector,
    VirtualClock,
)
from pytorch_distributed_tpu_torch.serving.engine import (
    BatchedDecodeEngine,
    BucketSpec,
    DecodeEngine,
    PagedBatchedDecodeEngine,
)
from pytorch_distributed_tpu_torch.serving.lifecycle import (
    ABORTED,
    DONE,
    EXPIRED,
    FAILED,
    TERMINAL_STATES,
    AdmissionQueueFull,
    DispatchFailure,
    EngineSnapshot,
    PagePoolExhausted,
    RequestFailed,
    RequestResult,
    RouterOverloaded,
)
from pytorch_distributed_tpu_torch.serving.router import (
    DEGRADED,
    DOWN,
    DRAINED,
    HEALTHY,
    REPLICA_STATES,
    ReplicaRouter,
)

__all__ = [
    "BlockPool", "BatchedDecodeEngine", "BucketSpec", "DecodeEngine",
    "PagedBatchedDecodeEngine", "ReplicaRouter",
    "Fault", "FaultInjector", "RouterFault", "RouterFaultInjector",
    "VirtualClock", "RequestResult", "EngineSnapshot",
    "AdmissionQueueFull", "DispatchFailure", "PagePoolExhausted",
    "RequestFailed", "RouterOverloaded", "DONE", "FAILED", "ABORTED",
    "EXPIRED", "TERMINAL_STATES", "HEALTHY", "DEGRADED", "DRAINED", "DOWN",
    "REPLICA_STATES",
]
