"""Driver of the sharded cell: a closed loop of random circuits through
``simulate(optimize='evolution-sharded')`` over every visible card, the
result left on the cards.

Request ``i`` of a run with seed ``s`` is the circuit
``circuits.rqc(n, cycles, [s, 1, i])``; the warm-up circuit is
``[s, 2, 0]``.  After each call the driver reads the amplitudes of the
run's bitstrings (drawn once from ``[s, 0]``) on the cards through the
result's ``amplitudes``, keeps them on the host, drops the state, and
waits for every card (the harness waits for the first only).  Each
request's record holds what the program's exchange counters
(``sharded.counts()``) gained in it.

Before anything large, the driver makes one small call and refuses a
program that returns the state as a host array: at the cell's size that
would gather the whole state into host memory.

On the host (``device='cpu'``, the tests) the program and the reference
take ``['cpu'] * shards``; on CUDA the program takes every visible card
(``devices`` left out) and the reference the first ``shards`` cards.

The check: after the window, for ``checked_requests`` requests drawn from
the seed among those completed, the four-quarter reference
(``reference/sharded.py``) evolves the same circuit and gives the same
amplitudes.  ``amp_gap`` is the widest ``|program - reference|`` over
those amplitudes, over their root mean square in the reference.  The
reference's seconds by phase (uploads, gates within a quarter, gates
across quarters) go to stderr.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from hqbench import circuits, system
from hqbench.yardstick import state_bytes
from reference import sharded as reference

__all__ = ['Driver', 'PhaseClock', 'run_program', 'PROBE_QUBITS']

PROBE_QUBITS = 8       # the width of the first, small call


def run_program(gates, n: int, options: dict, devices):
    """The program's ``simulate`` from ``|0...0>``; ``devices=None``
    leaves the mesh to the program (every visible card)."""
    from hybridq_tpu_torch.simulation import simulate

    where = {} if devices is None else {'devices': devices}
    return simulate(system.circuit(gates), initial_state='0' * n,
                    **options, **where)


class PhaseClock:
    """Seconds of the reference's evolution by phase (its ``on_phase``),
    in ``times``; the devices are waited for at each change of phase."""

    def __init__(self, devices):
        self.devices = list(dict.fromkeys(torch.device(d) for d in devices))
        self.times = {}
        self.phase, self.t = None, 0.0

    def __call__(self, phase):
        for d in self.devices:
            if d.type == 'cuda':
                torch.cuda.synchronize(d)
        now = time.perf_counter()
        if self.phase is not None:
            self.times[self.phase] = self.times.get(self.phase, 0.0) + \
                now - self.t
        self.phase, self.t = phase, now


def _counts() -> dict:
    """The program's exchange counters (the probe has refused a program
    without them)."""
    from hybridq_tpu_torch.simulation import sharded

    return sharded.counts()


class Driver:
    unit = 'gates'

    def __init__(self, config, traffic, seed: int, device, root):
        self.n = int(config['n_qubits'])
        self.cycles = int(config['cycles'])
        self.pattern = config['pattern']
        self.shards = int(config['shards'])
        self.limits = config['checks']
        self.options = dict(traffic['simulate'])
        self.checked = int(traffic['checked_requests'])
        self.seed = int(seed)
        self.device = torch.device(device)
        if self.device.type == 'cuda':
            self.program_devices = None
            self.cards = [torch.device('cuda', i)
                          for i in range(torch.cuda.device_count())]
            self.reference_devices = self.cards[:self.shards]
        else:
            self.program_devices = [self.device] * self.shards
            self.cards = []
            self.reference_devices = self.program_devices
        self._probe()
        rng = np.random.default_rng([self.seed, 0])
        bits = rng.integers(0, 2 ** self.n, size=int(traffic['bitstrings']),
                            dtype=np.int64)
        self.index = torch.as_tensor(bits, device=self.device)
        self.answers = {}            # request -> host amplitudes

    def _probe(self):
        """One call at ``PROBE_QUBITS`` qubits: the result must stay on
        the cards, in ``shards`` shards."""
        got = run_program(circuits.rqc(PROBE_QUBITS, 2, [self.seed, 4, 0],
                                       self.pattern),
                          PROBE_QUBITS, self.options, self.program_devices)
        if not hasattr(got, 'amplitudes'):
            raise RuntimeError(
                "the program's simulate(optimize='evolution-sharded', "
                f"return_numpy_array=False) returned a "
                f"{type(got).__module__}.{type(got).__name__}, not a state "
                "left on the cards; this cell reads its amplitudes on the "
                f"cards and will not gather 2^{self.n} amplitudes to the "
                "host")
        if len(got.shards) != self.shards:
            raise RuntimeError(
                f"the program split the state over {len(got.shards)} "
                f"devices; this cell needs {self.shards}")

    def costs(self) -> dict:
        n_local = self.n - (self.shards.bit_length() - 1)
        return {'n_qubits': self.n, 'state_bytes': state_bytes(self.n),
                'shard_bytes': state_bytes(n_local)}

    def _gates(self, key):
        return circuits.rqc(self.n, self.cycles, [self.seed, *key],
                            self.pattern)

    def _sync(self):
        for card in self.cards:
            torch.cuda.synchronize(card)

    def _run(self, gates):
        with torch.profiler.record_function('bench.simulate'):
            state = run_program(gates, self.n, self.options,
                                self.program_devices)
        amps = state.amplitudes(self.index).cpu().numpy()
        del state
        self._sync()
        return amps

    def warm(self):
        self._run(self._gates((2, 0)))
        for card in self.cards:
            torch.cuda.reset_peak_memory_stats(card)

    def request(self, i: int) -> dict:
        gates = self._gates((1, i))
        before = _counts()
        amps = self._run(gates)
        after = _counts()
        self.answers[i] = amps
        rec = {'gates': len(gates), 'failed': not np.isfinite(amps).all()}
        rec.update({k: after[k] - before[k] for k in after})
        return rec

    def release(self):
        """Read each card's peak over the window, then drop what the
        program left on the cards."""
        if self.cards:
            print('card peaks (bytes): ' + ' '.join(
                str(torch.cuda.max_memory_allocated(c)) for c in self.cards),
                file=sys.stderr)
        for card in self.cards:
            with torch.cuda.device(card):
                torch.cuda.empty_cache()

    def check(self, rng) -> dict:
        """``{name: (value, limit)}`` over the sampled requests."""
        done = sorted(self.answers)
        pick = rng.choice(done, size=min(self.checked, len(done)),
                          replace=False)
        worst = 0.0
        for i in sorted(int(j) for j in pick):
            clock = PhaseClock(self.reference_devices)
            want = reference.amplitudes(self._gates((1, i)), self.n,
                                        self.index, self.reference_devices,
                                        on_phase=clock)
            print('reference seconds: ' + ' '.join(
                f'{k} {v:.3f}' for k, v in clock.times.items()),
                file=sys.stderr)
            got = self.answers[i]
            rms = float(np.sqrt(np.mean(np.abs(want.astype(complex)) ** 2)))
            gap = float(np.max(np.abs(got.astype(complex) - want)) / rms)
            worst = max(worst, gap if np.isfinite(gap) else np.inf)
        return {'amp_gap': (worst, float(self.limits['amp_gap']))}
