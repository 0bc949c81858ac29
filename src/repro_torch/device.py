"""Device choice for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card.

    The entry points run on the card unless the caller names another
    device (the CPU tests pass ``device="cpu"``).  With no device named and
    no card present this raises: a silent fall-back to the CPU would run
    the plain versions instead of the kernels and report their numbers.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
