"""Driver of the state-vector cells: a closed loop of random circuits
through ``simulate`` of the evolution engine.

Request ``i`` of a run with seed ``s`` is the circuit
``circuits.rqc(n, cycles, [s, 1, i])``; the warm-up circuit is
``[s, 2, 0]``.  After each call the driver reads the amplitudes of the
run's bitstrings (drawn once from ``[s, 0]``) on the card, as a linear
cross-entropy benchmark does, keeps them on the host and drops the state.

The check: after the window, for ``checked_requests`` requests drawn
from the seed among those completed, the plain reference evolves the same
circuit and gives the same amplitudes.  ``amp_gap`` is the widest
``|program - reference|`` over those amplitudes, over their root mean
square in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from hqbench import circuits, system
from hqbench.yardstick import state_bytes
from reference import statevector as reference

__all__ = ['Driver']


class Driver:
    unit = 'gates'

    def __init__(self, config, traffic, seed: int, device, root):
        self.n = int(config['n_qubits'])
        self.cycles = int(config['cycles'])
        self.pattern = config['pattern']
        self.limits = config['checks']
        self.options = dict(traffic['simulate'])
        self.checked = int(traffic['checked_requests'])
        self.seed = int(seed)
        self.device = torch.device(device)
        rng = np.random.default_rng([self.seed, 0])
        bits = rng.integers(0, 2 ** self.n, size=int(traffic['bitstrings']),
                            dtype=np.int64)
        self.index = torch.as_tensor(bits, device=self.device)
        self.answers = {}            # request -> host amplitudes

    def costs(self) -> dict:
        return {'n_qubits': self.n, 'state_bytes': state_bytes(self.n)}

    def _gates(self, key):
        return circuits.rqc(self.n, self.cycles, [self.seed, *key],
                            self.pattern)

    def _run(self, gates):
        with torch.profiler.record_function('bench.simulate'):
            psi = system.simulate_circuit(gates, self.n, self.options,
                                          self.device)
        amps = psi.index_select(0, self.index).cpu().numpy()
        del psi
        return amps

    def warm(self):
        self._run(self._gates((2, 0)))

    def request(self, i: int) -> dict:
        gates = self._gates((1, i))
        amps = self._run(gates)
        self.answers[i] = amps
        return {'gates': len(gates), 'failed': not np.isfinite(amps).all()}

    def release(self):
        """Drop what the program left on the card."""
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def check(self, rng) -> dict:
        """``{name: (value, limit)}`` over the sampled requests."""
        done = sorted(self.answers)
        pick = rng.choice(done, size=min(self.checked, len(done)),
                          replace=False)
        worst = 0.0
        for i in sorted(int(j) for j in pick):
            want = reference.amplitudes(self._gates((1, i)), self.n,
                                        self.index, self.device)
            got = self.answers[i]
            rms = float(np.sqrt(np.mean(np.abs(want.astype(complex)) ** 2)))
            gap = float(np.max(np.abs(got.astype(complex) - want)) / rms)
            worst = max(worst, gap if np.isfinite(gap) else np.inf)
        return {'amp_gap': (worst, float(self.limits['amp_gap']))}
