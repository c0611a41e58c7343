"""Multi-process wiring: ``torch.distributed`` in place of ``jax.distributed``.

The counterpart of ``hybridq_tpu/parallel/__init__.py``.  One process per
card (or per host CPU) joins a process group; the sharded engines
(``simulation/sharded.py``) lay their shards over every process's
devices (``parallel.mesh``), and host-level work division (tensor-network
slice ranges, Clifford branch chunks) splits by process index, as the
reference's MPI ranks split it (``simulation_mpi.py:459-468``).

Usage (one call per process, before any collective)::

    from hybridq_tpu_torch import parallel
    parallel.initialize()          # env-driven, or pass explicit args

Arguments default to the JAX package's environment variables:
``HYBRIDQ_TPU_COORDINATOR`` (``host:port``, or an ``init_method`` such as
``tcp://host:port`` or ``file:///path``), ``HYBRIDQ_TPU_NUM_PROCESSES``
and ``HYBRIDQ_TPU_PROCESS_ID``.  With none of them set, the variables of
``torchrun`` (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``)
are read, the counterpart of JAX's cluster autodetection.

The backend is NCCL when the process's device is a CUDA device and gloo
on the CPU.  Gloo exchanges point to point only CPU tensors, and NCCL
refuses two ranks on one card, so a process group on one card holds one
rank; several shards on that card live in one process (``parallel.mesh``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch

__all__ = ['initialize', 'is_distributed', 'process_index',
           'process_count', 'local_slice_range']

_device: Optional[torch.device] = None    # this process's device, once set


def _group() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               timeout: Optional[float] = None) -> None:
    """Join (or start) the process group.

    ``device=None`` means ``'cuda'``, which raises without a card (pass
    ``device='cpu'`` for a gloo group of host processes); a bare
    ``'cuda'`` becomes this process's card, ``cuda:<LOCAL_RANK>`` (or
    ``cuda:<rank mod cards>``), which is made the current device.
    ``timeout`` (seconds) bounds every collective of the group.  Safe to
    call more than once."""
    global _device
    import torch.distributed as dist

    from hybridq_tpu_torch.simulation._device import resolve_device

    if _group():
        return
    env = os.environ
    coordinator_address = coordinator_address or env.get(
        'HYBRIDQ_TPU_COORDINATOR')
    if num_processes is None and 'HYBRIDQ_TPU_NUM_PROCESSES' in env:
        num_processes = int(env['HYBRIDQ_TPU_NUM_PROCESSES'])
    if process_id is None and 'HYBRIDQ_TPU_PROCESS_ID' in env:
        process_id = int(env['HYBRIDQ_TPU_PROCESS_ID'])
    if coordinator_address is None:
        if 'MASTER_ADDR' not in env:
            raise RuntimeError(
                "parallel.initialize() needs a coordinator: pass "
                "coordinator_address or set HYBRIDQ_TPU_COORDINATOR "
                "(or run under torchrun)")
        init_method = 'env://'
    elif '://' in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f'tcp://{coordinator_address}'
    if num_processes is None:
        num_processes = int(env.get('WORLD_SIZE', -1))
    if process_id is None:
        process_id = int(env.get('RANK', -1))

    device = resolve_device(device, 'parallel.initialize()')
    if device.type == 'cuda':
        if device.index is None:
            local = int(env.get('LOCAL_RANK', max(process_id, 0)))
            device = torch.device('cuda', local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    kw = {} if timeout is None else {
        'timeout': datetime.timedelta(seconds=float(timeout))}
    dist.init_process_group(
        backend='nccl' if device.type == 'cuda' else 'gloo',
        init_method=init_method, world_size=num_processes,
        rank=process_id, **kw)
    _device = device


def is_distributed() -> bool:
    return process_count() > 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if _group() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if _group() else 1


def local_slice_range(n_slices: int,
                      pid: Optional[int] = None,
                      n_procs: Optional[int] = None) -> Tuple[int, int]:
    """This process's ``(start, stop)`` share of ``n_slices`` tensor-
    network slices, the analog of the reference's MPI rank split
    (``simulation_mpi.py:429-468``).  Pass the result as ``slice_range=``
    to the TN engine; sum the per-process partials to finish the
    contraction."""
    pid = process_index() if pid is None else pid
    n_procs = process_count() if n_procs is None else n_procs
    base, extra = divmod(n_slices, n_procs)
    start = pid * base + min(pid, extra)
    stop = start + base + (1 if pid < extra else 0)
    return start, stop
