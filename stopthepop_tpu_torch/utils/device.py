"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the GPU.

    Entry points run on CUDA unless the caller asks for the CPU by name;
    without a GPU they raise instead of continuing quietly on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: stopthepop_tpu_torch runs on the GPU unless "
                "the caller passes device='cpu'"
            )
        return torch.device("cuda")
    return torch.device(device)
