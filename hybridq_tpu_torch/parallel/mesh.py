"""The global list of state shards, and the three collectives on it.

The JAX engines lay their state over a 1-D ``jax.sharding.Mesh`` and run
``shard_map`` programs with ``lax.ppermute`` and ``lax.psum`` in them.
Here the same mesh is a list: every process of the group contributes its
local devices, in order, and shard ``rank * len(local) + j`` lives on
local device ``j`` of process ``rank`` (the order of ``jax.devices()``
across processes).  The list is cut to a power of two, as JAX cuts its
device list (``hybridq_tpu/simulation/sharded.py:123-125``).  A local
device list may name one device more than once (``['cpu'] * 8`` on the
host, ``['cuda:0'] * 4`` on one card): each entry holds one shard.

A shard is a 1-D float tensor (the split container of the port's
engines: re half, then im half).  The collectives:

- ``exchange``: ``ppermute``'s global-local swap.  Two shards whose
  indices differ in one global bit trade the halves of their containers
  whose local bit at ``slot`` does not match their own global bit.
  Between two shards of this process it swaps the halves in place, a
  piece of at most ``PIECE`` floats at a time (JAX builds new arrays): a
  32-qubit shard's half is 16 GiB, more than a card should stage beside
  its 32 GiB shard.  Where the half's contiguous runs hold a piece or
  more, a piece is one contiguous copy each way (a ``cudaMemcpy`` between
  cards) and one staging copy; else each side first gathers its piece
  into a contiguous buffer on its own device, so that what crosses
  between devices is again one contiguous copy each way.  Between
  processes it is one ``batch_isend_irecv`` of contiguous halves.
- ``all_sum``: ``psum``, a local sum then ``all_reduce``.
- ``gather``: every shard on the host of every process (``all_gather``).

Collectives go over the group's backend: CUDA tensors under NCCL, CPU
tensors under gloo.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from hybridq_tpu_torch import parallel

__all__ = ['Mesh', 'PIECE']

# floats of a half that an exchange between two shards of this process
# moves in one copy (512 MiB of float32)
PIECE = 2 ** 27


def _default_devices() -> List[torch.device]:
    """Inside a process group, this process's device (the one it joined
    with through ``parallel.initialize``, else its current card); else
    every visible CUDA device.  Raises without one (pass CPU devices to
    run on the host)."""
    from hybridq_tpu_torch.parallel import _group

    if _group() and parallel._device is not None:
        return [parallel._device]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the sharded engines run on CUDA devices by default and none "
            "is available; pass devices=['cpu'] * n_shards to run on the "
            "host (device='cpu' to simulate())")
    if _group():
        return [torch.device('cuda', torch.cuda.current_device())]
    return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]


def _collective_device() -> torch.device:
    """Where a collective's tensors must lie for the group's backend."""
    import torch.distributed as dist

    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


class Mesh:
    """The shards of a 1-D mesh that this process holds.

    ``g`` is the number of global bits (``2^g`` shards in all),
    ``devices[j]`` the device of local shard ``j`` and ``index[j]`` its
    global index.  On more than one process, every process must hold the
    same power-of-two number of shards."""

    def __init__(self, devices=None):
        from hybridq_tpu_torch.parallel import _group
        from hybridq_tpu_torch.simulation._device import resolve_device

        local = _default_devices() if devices is None else [
            resolve_device(d, 'the sharded engines') for d in devices]
        if not local:
            raise ValueError("the mesh needs at least one device")
        self.rank = parallel.process_index()
        self.world = parallel.process_count()
        self.grouped = _group()
        total = len(local) * self.world
        self.g = total.bit_length() - 1
        self.size = 2 ** self.g
        if self.world > 1 and (self.size != total or
                               len(local) & (len(local) - 1)):
            raise ValueError(
                f"{self.world} processes of {len(local)} devices each: "
                "every process must hold the same power-of-two number of "
                "shards")
        self.per_rank = len(local)
        first = self.rank * self.per_rank
        self.devices = local[:max(0, min(self.per_rank, self.size - first))]
        self.index = [first + j for j in range(len(self.devices))]

    def owner(self, i: int) -> int:
        return i // self.per_rank

    def global_bit(self, i: int, b: int) -> int:
        """Bit ``b`` (0 = the most significant) of shard index ``i``."""
        return (i >> (self.g - 1 - b)) & 1

    # -- exchange --------------------------------------------------------
    def exchange(self, shards: Sequence[torch.Tensor], b: int, slot: int,
                 n_local: int) -> int:
        """Swap global bit ``b`` with local ``slot`` (the local position
        counted from the most significant bit of ``n_local``), in place:
        each shard trades the half of its container whose bit at ``slot``
        differs from its own global bit ``b`` with its partner's matching
        half.  Returns the bytes that this process's shards sent to a
        shard on another device: both directions of a pair held here, the
        sent half of a pair across processes."""
        mask = 1 << (self.g - 1 - b)
        pos = {i: j for j, i in enumerate(self.index)}
        pairs, remote = [], []
        for j, i in enumerate(self.index):
            p = i ^ mask
            if p in pos:
                if i < p:     # once a pair: i has bit 0, p bit 1
                    pairs.append((self._half(shards[j], slot, n_local, 1),
                                  self._half(shards[pos[p]], slot,
                                             n_local, 0)))
            else:
                remote.append((j, i, p))
        # pieces outermost, so that the pairs' copies run side by side
        for piece in self._pieces(slot, n_local):
            for a, c in pairs:
                a, c = a[piece], c[piece]
                if a.is_contiguous():
                    staged = a.clone()
                    a.copy_(c)
                    c.copy_(staged)
                else:
                    staged, other = a.contiguous(), c.contiguous()
                    a.copy_(other.to(a.device))
                    c.copy_(staged.to(c.device))
                    del other
                del staged
        crossed = sum(2 * a.numel() * a.element_size() for a, c in pairs
                      if a.device != c.device)
        if remote:
            crossed += self._exchange_remote(shards, remote, b, slot,
                                             n_local)
        return crossed

    @staticmethod
    def _half(shard, slot, n_local, half):
        """The ``(2, 2^slot, 2^(n_local-slot-1))`` view of the entries of
        ``shard`` (re and im parts) whose bit at ``slot`` is ``half``."""
        return shard.view(2, 2 ** slot, 2, 2 ** (n_local - slot - 1))[
            :, :, half, :]

    @staticmethod
    def _pieces(slot, n_local):
        """Indices into a half (``_half``) whose views cover it once, each
        at most ``PIECE`` floats: runs of ``PIECE`` contiguous floats where
        the half's runs are that long, else blocks of its rows."""
        rows, run = 2 ** slot, 2 ** (n_local - slot - 1)
        if run >= PIECE:
            return [(part, r, slice(o, o + PIECE)) for part in range(2)
                    for r in range(rows) for o in range(0, run, PIECE)]
        step = max(1, PIECE // (2 * run))
        return [(slice(None), slice(r, r + step))
                for r in range(0, rows, step)]

    def _exchange_remote(self, shards, remote, b, slot, n_local):
        import torch.distributed as dist

        cdev = _collective_device()
        ops, recvs = [], []
        # both sides post their pairs in the order of the pair's lower
        # index, so that sends and receives between two processes match
        for j, i, p in sorted(remote, key=lambda r: min(r[1], r[2])):
            mine = 1 - self.global_bit(i, b)
            send = self._half(shards[j], slot, n_local, mine).to(
                cdev, copy=True).contiguous()
            recv = torch.empty_like(send)
            tag = min(i, p)
            ops.append(dist.P2POp(dist.isend, send, self.owner(p), tag=tag))
            ops.append(dist.P2POp(dist.irecv, recv, self.owner(p), tag=tag))
            recvs.append((j, mine, recv, send))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for j, mine, recv, _ in recvs:
            self._half(shards[j], slot, n_local, mine).copy_(recv)
        return sum(send.numel() * send.element_size()
                   for _, _, _, send in recvs)

    # -- reductions --------------------------------------------------------
    def all_sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum of one tensor a local shard over every shard of the mesh,
        on the first local device (``psum``)."""
        import torch.distributed as dist

        dev = self.devices[0]
        total = parts[0].to(dev, copy=True)
        for p in parts[1:]:
            total += p.to(dev)
        if self.grouped:
            cdev = _collective_device()
            buf = total.to(cdev)
            dist.all_reduce(buf)
            total = buf.to(dev)
        return total

    def gather(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every shard of the mesh, stacked in index order, as one host
        tensor ``(2^g, shard size)`` on every process."""
        import torch.distributed as dist

        if not self.grouped:
            return torch.stack([s.cpu() for s in shards])
        cdev = _collective_device()
        mine = torch.stack([s.to(cdev) for s in shards])
        parts = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(parts, mine)
        return torch.cat(parts).cpu()
