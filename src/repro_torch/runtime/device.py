"""Where the port runs: the card, unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` means the card. Without one that is an error, not a
    silent move to the CPU: pass ``device="cpu"`` to run there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card unless asked "
                "for the CPU (pass device='cpu')"
            )
        return torch.device("cuda")
    return torch.device(device)
