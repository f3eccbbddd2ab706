"""Where the port's entry points place their tensors."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` means the card: "cuda", with a clear error when CUDA is
    absent. Tests and CPU runs pass ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on the GPU by default, but CUDA is not "
            "available here — pass device='cpu' to run on the CPU"
        )
    return dev
