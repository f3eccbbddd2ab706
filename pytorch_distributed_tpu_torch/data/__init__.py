"""Token data: the kjj0 shard format, the sequential, distributed
(rank-sliced) and native (C++, prefetching) loaders, synthetic shards and
byte-level text tokenization (the port's own copies of the JAX package's
numpy-only ``data/`` modules; the native loader's source is
``csrc/data_loader.cc``). The fineweb download is not ported: the port
reads local and synthetic shards."""

from pytorch_distributed_tpu_torch.data.bin_format import (  # noqa: F401
    HEADER_INTS,
    MAGIC,
    VERSION,
    ShardFormatError,
    read_header,
    read_tokens,
    write_shard,
)
from pytorch_distributed_tpu_torch.data.distributed_loader import (  # noqa: F401
    DistributedTokenShardLoader,
)
from pytorch_distributed_tpu_torch.data.loader import (  # noqa: F401
    TokenShardLoader,
)
from pytorch_distributed_tpu_torch.data.native_loader import (  # noqa: F401
    NativeLoaderUnavailable,
    NativeTokenShardLoader,
)
from pytorch_distributed_tpu_torch.data.synthetic import (  # noqa: F401
    make_synthetic_shards,
)
from pytorch_distributed_tpu_torch.data.text import (  # noqa: F401
    BYTE_VOCAB_SIZE,
    DOC_SEPARATOR,
    decode_bytes,
    encode_bytes,
    tokenize_files,
)
