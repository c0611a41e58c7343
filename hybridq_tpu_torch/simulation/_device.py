"""Where the port's entry points run: on the card unless told otherwise."""

from __future__ import annotations

import torch

__all__ = ['resolve_device']


def resolve_device(device, what: str = 'simulate()') -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``'cuda'``, which
    raises without a CUDA device (pass ``device='cpu'`` for the host)."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on a CUDA device by default "
                           "and none is available; pass device='cpu' to "
                           "run on the host")
    return device
