"""Token data: the kjj0 shard format, the sequential loader and synthetic
shards (the port's own copies of the JAX package's numpy-only ``data/``
modules). The distributed, native and text loaders are not ported yet."""

from pytorch_distributed_tpu_torch.data.bin_format import (  # noqa: F401
    HEADER_INTS,
    MAGIC,
    VERSION,
    ShardFormatError,
    read_header,
    read_tokens,
    write_shard,
)
from pytorch_distributed_tpu_torch.data.loader import (  # noqa: F401
    TokenShardLoader,
)
from pytorch_distributed_tpu_torch.data.synthetic import (  # noqa: F401
    make_synthetic_shards,
)
