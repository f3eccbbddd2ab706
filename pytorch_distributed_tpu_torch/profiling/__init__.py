"""Profiling: the scheduled ``torch.profiler`` tracer, Kineto trace
analysis, memory and throughput accounting (the port of the JAX package's
``profiling/``)."""

from pytorch_distributed_tpu_torch.profiling.profiler import (  # noqa: F401
    ScheduledProfiler,
    find_trace_files,
)
from pytorch_distributed_tpu_torch.profiling.memory import (  # noqa: F401
    analytic_memory_breakdown,
    measured_memory,
    save_memory_snapshot,
)
from pytorch_distributed_tpu_torch.profiling.throughput import (  # noqa: F401
    compare_batch_sizes,
    extrapolate_modern_training,
    measure_tokens_per_second,
)
