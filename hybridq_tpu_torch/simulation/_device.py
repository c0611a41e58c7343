"""Where the port's entry points run: on the card unless told otherwise."""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ['resolve_device', 'full_precision_matmul', 'profiled']


def resolve_device(device, what: str = 'simulate()') -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``'cuda'``, which
    raises without a CUDA device (pass ``device='cpu'`` for the host)."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on a CUDA device by default "
                           "and none is available; pass device='cpu' to "
                           "run on the host")
    return device


@contextlib.contextmanager
def full_precision_matmul():
    """Run float32 (and complex64) matmuls without TF32 inside the block,
    whatever the caller's flags, and restore the flags after it (the
    JAX package forces ``precision='highest'`` the same way)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@contextlib.contextmanager
def profiled(directory, device):
    """Run the block under ``torch.profiler`` (host activity, and the
    card's when ``device`` is a CUDA device) and write its Chrome trace
    into ``directory``, which is created if needed; the block is one
    span named ``simulate`` in the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function('simulate'):
            yield
    prof.export_chrome_trace(os.path.join(
        str(directory), f'simulate-{os.getpid()}-{time.time_ns()}.json'))
