"""Data-parallel training over ranks (the port of the JAX package's
``parallel/``): the mesh of process groups, the sharding table, the ZeRO
collectives and the train steps."""

from pytorch_distributed_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_partition_spec,
    make_mesh,
    process_info,
)
from pytorch_distributed_tpu_torch.parallel.sharding import (  # noqa: F401
    param_partition_specs,
    shard_train_state,
)
from pytorch_distributed_tpu_torch.parallel.api import (  # noqa: F401
    make_parallel_train_step,
)
