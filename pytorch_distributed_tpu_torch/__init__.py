"""PyTorch + CUDA port of ``pytorch_distributed_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, with the same sub-package layout
(``config``, ``ops``, ``models``, ``serving``, ``utils``) so each module's
JAX counterpart sits at the same path. It imports torch and numpy only —
never JAX and nothing of the JAX package; ``interop`` converts weights
between the two through numpy. Its kernels are hand-written CUDA in
``csrc/``, built at first use (``ops/_build``). Entry points run on the
GPU unless the caller passes ``device="cpu"``.

Ported so far: paged continuous-batching serving of the gpt2 and llama
families (``serving.engine.PagedBatchedDecodeEngine``, bf16 or int8) with
the paged decode kernels (``ops.paged_kernel``), its fault recovery and
multi-turn sessions, and the serving tier over it (``serving.router``,
``serving.server``; entry points ``serving.serve`` and
``serving.loadgen``); training of both families, MoE included, with the
flash attention kernels (``ops.flash_kernel``; entry point
``train.baseline``), and over ranks, DDP and ZeRO-1/2/3 on
``torch.distributed`` (``parallel``, ``train.distributed_trainer``; entry
points ``train.ddp`` and ``train.fsdp``); and the HF weight import
(``models.hf_import``).
"""

from pytorch_distributed_tpu_torch.config import ModelConfig, model_config

__all__ = ["ModelConfig", "model_config"]
