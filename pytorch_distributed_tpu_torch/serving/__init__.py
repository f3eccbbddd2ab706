"""Serving: the paged continuous-batching engine and its host-side parts."""

from pytorch_distributed_tpu_torch.serving.engine import (
    PagedBatchedDecodeEngine,
)
from pytorch_distributed_tpu_torch.serving.lifecycle import (
    ABORTED,
    DONE,
    EXPIRED,
    FAILED,
    AdmissionQueueFull,
    PagePoolExhausted,
    RequestResult,
)

__all__ = [
    "PagedBatchedDecodeEngine", "RequestResult", "AdmissionQueueFull",
    "PagePoolExhausted", "DONE", "FAILED", "ABORTED", "EXPIRED",
]
