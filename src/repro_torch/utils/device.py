"""Device selection for the port's entry points: the card by default."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means the CUDA card, and raises if there is none; the CPU
    is used only when the caller asks for it (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)
