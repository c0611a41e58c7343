"""Where the port's entry points run: on the card unless told otherwise."""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ['resolve_device', 'full_precision_matmul', 'profiled', 'span']

_NO_SPAN = contextlib.nullcontext()


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
    into ``directory``, which is created if needed."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        str(directory), f'simulate-{os.getpid()}-{time.time_ns()}.json'))


def span(name: str, **meta):
    """The program's span ``name``: a ``torch.profiler.record_function``
    range while a profiler records, so that it lands in the profiler's
    trace on the clock of the device's events, and one shared no-op
    context otherwise (a flag read; an idle ``record_function`` costs
    tens of microseconds).  Each ``meta`` item is appended to the name as
    `` key=value``, since a trace keeps only a span's name and times."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    from torch.profiler import record_function

    return record_function(name + ''.join(f' {k}={v}'
                                          for k, v in meta.items()))
