"""Driver of the tensor-network cells: calls of ``simulate`` on a prebuilt
sliced plan, back to back, each over its own range of slices.

The plan is the configuration's ``plan`` file, read by the program's own
loader in set-up.  The plan's slices are split into contiguous ranges of
``L = slices_per_call``, as workers of HybridQ's process split take them;
the ranges in which every slice is exactly zero by the plan's leaves alone
(``reference.tensornet.nonzero_slices``) are left out.  Call ``i`` of a
run with seed ``s`` sums range ``(s + i) mod R`` of the ``R`` ranges
left.  The warm-up call sums the first ``warm_slices`` slices of the
range before the run's first.

The check: after the window, for ``checked_requests`` calls drawn from
the seed among those completed, the plain reference contracts each slice
of the same range.  ``sum_gap`` is ``|program - reference|`` of the
partial sum over the root of the sum of the slices' squared magnitudes
(the size of the terms summed), the widest over the sampled calls.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from hqbench import system
from reference import tensornet as reference

__all__ = ['Driver']


class Driver:
    unit = 'slices'

    def __init__(self, config, traffic, seed: int, device, root):
        self.path = os.path.join(root, config['plan'])
        self.limits = config['checks']
        self.options = dict(traffic.get('simulate', {}))
        self.per_call = int(traffic['slices_per_call'])
        self.warm_slices = int(traffic['warm_slices'])
        self.checked = int(traffic['checked_requests'])
        self.device = torch.device(device)
        self.net, self.optimize = system.load_plan(self.path)
        self.plan = reference.load_plan(self.path)
        keep = reference.nonzero_slices(self.plan)
        if len(keep) % self.per_call:
            raise ValueError(f"{self.per_call} slices a call do not divide "
                             f"the plan's {len(keep)}")
        ranges = keep.reshape(-1, self.per_call).any(1)
        self.starts = [int(r) * self.per_call for r in np.nonzero(ranges)[0]]
        self.seed = int(seed)
        self.answers = {}            # call -> (start, partial sum)

    def costs(self) -> dict:
        return {'macs_per_slice': reference.macs_per_slice(self.plan),
                'slices_per_call': self.per_call}

    def _range(self, i: int):
        a = self.starts[(self.seed + i) % len(self.starts)]
        return a, a + self.per_call

    def _run(self, a, b):
        with torch.profiler.record_function('bench.simulate'):
            return np.asarray(system.simulate_slices(
                self.net, self.optimize, a, b, self.options, self.device))

    def warm(self):
        a = self._range(-1)[0]
        self._run(a, a + self.warm_slices)

    def request(self, i: int) -> dict:
        a, b = self._range(i)
        out = self._run(a, b)
        self.answers[i] = (a, out)
        return {'slices': b - a, 'failed': not np.isfinite(out).all()}

    def release(self):
        """Drop what the program holds."""
        self.net = self.optimize = None
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def check(self, rng) -> dict:
        """``{name: (value, limit)}`` over the sampled calls."""
        done = sorted(self.answers)
        pick = rng.choice(done, size=min(self.checked, len(done)),
                          replace=False)
        worst = 0.0
        for i in sorted(int(j) for j in pick):
            a, got = self.answers[i]
            vals = reference.slice_values(self.plan, a, a + self.per_call,
                                          self.device)
            scale = float(np.sqrt(np.sum(np.abs(vals) ** 2)))
            gap = float(np.max(np.abs(got - vals.sum(0))) / scale)
            worst = max(worst, gap if np.isfinite(gap) else np.inf)
        return {'sum_gap': (worst, float(self.limits['sum_gap']))}
