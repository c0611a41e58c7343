"""Driver of the noisy density-matrix cells: a closed loop of random
circuits with a depolarizing channel after every gate, through the
program's ``dm.simulate``.

Request ``i`` of a run with seed ``s`` is the circuit
``circuits.rqc(n, cycles, [s, 1, i])`` with the program's
``GlobalDepolarizingChannel`` after each gate, on that gate's qubits, of
the strength the configuration's Pauli error gives its kind
(``reference.densitymatrix.depolarizing_p``); the warm-up circuit is
``[s, 2, 0]``.  The program leaves rho on the card, its row index the
high half of the flat index.  After each call the driver reads there all
2^n diagonal entries (every bitstring's probability) and ``entries``
entries (x, y) drawn once from ``[s, 0]``, keeps them on the host and
drops rho.  A request counts the gates and the channels of its noisy
circuit as generated.

The check: after the window, for ``checked_requests`` requests drawn
from the seed among those completed, the plain reference evolves the same
noisy circuit and gives the same entries.  ``rho_gap`` is the widest
``|program - reference|`` over those entries, over their root mean square
in the reference.
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import torch

from hqbench import circuits, system
from hqbench.yardstick import state_bytes
from reference import densitymatrix as reference

__all__ = ['Driver']


class Driver:
    unit = 'gates'

    def __init__(self, config, traffic, seed: int, device, root):
        self.n = int(config['n_qubits'])
        self.cycles = int(config['cycles'])
        self.pattern = config['pattern']
        self.limits = config['checks']
        errors = config['noise']
        self.noise = {1: reference.depolarizing_p(
            errors['one_qubit_pauli_error'], 1),
            2: reference.depolarizing_p(errors['two_qubit_pauli_error'], 2)}
        self.options = dict(traffic['simulate'])
        self.checked = int(traffic['checked_requests'])
        self.seed = int(seed)
        self.device = torch.device(device)
        side = 2 ** self.n
        rng = np.random.default_rng([self.seed, 0])
        rows, cols = rng.integers(0, side, size=(2, int(traffic['entries'])),
                                  dtype=np.int64)
        flat = np.concatenate([np.arange(side, dtype=np.int64) * (side + 1),
                               rows * side + cols])
        self.index = torch.as_tensor(flat, device=self.device)
        self.answers = {}            # request -> host entries

    def costs(self) -> dict:
        # rho is the program's state of 2n doubled qubits
        return {'n_qubits': 2 * self.n,
                'state_bytes': state_bytes(2 * self.n)}

    def _gates(self, key):
        return circuits.rqc(self.n, self.cycles, [self.seed, *key],
                            self.pattern)

    def _rho(self, gates) -> torch.Tensor:
        """The program's flat rho of the noisy circuit of ``gates``."""
        from hybridq_tpu_torch import dm, noise

        noisy = []
        for g in system.circuit(gates):
            noisy += [g, noise.GlobalDepolarizingChannel(
                g.qubits, self.noise[len(g.qubits)])]
        rho = dm.simulate(noisy, initial_state='0', device=self.device,
                          **self.options)
        return rho.reshape(-1)

    def _run(self, gates):
        with torch.profiler.record_function('bench.simulate'):
            rho = self._rho(gates)
        got = rho.index_select(0, self.index).cpu().numpy()
        del rho
        return got

    def warm(self):
        self._run(self._gates((2, 0)))

    def request(self, i: int) -> dict:
        gates = self._gates((1, i))
        got = self._run(gates)
        self.answers[i] = got
        # each gate and the channel after it
        return {'gates': 2 * len(gates),
                'failed': not np.isfinite(got).all()}

    def release(self):
        """Drop what the program left on the card."""
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    @classmethod
    def control(cls):
        """Context in which the plain reference with every product's
        operands rounded to TF32, the next precision below the
        configuration's complex64 with TF32 off, stands in for the
        program."""
        def rho(self, gates):
            return reference.evolve(gates, self.n, self.noise, self.device,
                                    tf32=True)
        return mock.patch.object(cls, '_rho', rho)

    def check(self, rng) -> dict:
        """``{name: (value, limit)}`` over the sampled requests."""
        done = sorted(self.answers)
        pick = rng.choice(done, size=min(self.checked, len(done)),
                          replace=False)
        worst = 0.0
        for i in sorted(int(j) for j in pick):
            want = reference.entries(self._gates((1, i)), self.n, self.noise,
                                     self.index, self.device)
            got = self.answers[i]
            rms = float(np.sqrt(np.mean(np.abs(want.astype(complex)) ** 2)))
            gap = float(np.max(np.abs(got.astype(complex) - want)) / rms)
            worst = max(worst, gap if np.isfinite(gap) else np.inf)
        return {'rho_gap': (worst, float(self.limits['rho_gap']))}
