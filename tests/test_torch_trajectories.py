"""The port's batched noise trajectories against the JAX package's.

``hybridq_tpu_torch.simulation.trajectories`` draws its random numbers in
JAX's order from one ``np.random.default_rng(seed)``, so the two packages
agree sample for sample: the same noisy circuit (built twice from one
seed) through JAX's ``sample_trajectories`` and the port's with
``device='cpu'``, held per sample at max|d|/rms <= 1e-5 in complex64 (f32
products in another order; a Kraus branch chosen differently would be
O(1)).  Over the trajectory seeds 0-19 of ``test_samples_match_jax``'s
Kraus-heavy circuit no branch flips.  The Monte-Carlo density matrices
are held against the exact ``dm.simulate`` in complex128 at
``tests/test_dm_noise.py``'s atol 0.05.  JAX runs its complex128
trajectories in float32 (the tests never enable x64), so the port's
complex128 run is held against its own complex64 run (1e-5) instead.
"""

import numpy as np
import pytest

from hybridq_tpu import dm as jdm
from hybridq_tpu import noise as jnoise
from hybridq_tpu.circuit import Circuit as JCircuit
from hybridq_tpu.extras.random import get_rqc as j_rqc
from hybridq_tpu.simulation import trajectories as jtraj
from hybridq_tpu_torch import Circuit, Gate
from hybridq_tpu_torch import noise as tnoise
from hybridq_tpu_torch.extras.random import get_rqc as t_rqc
from hybridq_tpu_torch.gate import FunctionalGate
from hybridq_tpu_torch.simulation import fused_kernels as fk
from hybridq_tpu_torch.simulation import trajectories as ttraj

RMS_TOL = 1e-5
DM_ATOL = 0.05              # tests/test_dm_noise.py's Monte-Carlo bar
C128 = dict(complex_type='complex128')


def _noisy(rqc, noise, n, depth, seed, damp):
    """``rqc(n, depth)`` with a ``LocalDepolarizingChannel`` (p = 0.05)
    after each layer of ``n`` gates, and with ``damp`` an
    ``AmplitudeDampingChannel`` (gamma = 0.2, p = 1, Kraus sites) on every
    qubit after it too."""
    np.random.seed(seed)
    out = []
    for i, g in enumerate(rqc(n, depth, indexes=list(range(n)))):
        out.append(g)
        if (i + 1) % n == 0:
            out += list(noise.LocalDepolarizingChannel(list(range(n)), 0.05))
            if damp:
                out += list(noise.AmplitudeDampingChannel(
                    list(range(n)), gamma=0.2, p=1))
    return out


def _rel(a, b):
    """max|d|/rms of each sample (rows)."""
    return (np.abs(a - b).max(axis=1) /
            np.sqrt((np.abs(a) ** 2).mean(axis=1)))


_CIRCUITS = {}


def _circuits(damp):
    """The JAX and port twins of one 6-qubit noisy circuit (cached, so
    that JAX compiles its batched program once for every seed)."""
    if damp not in _CIRCUITS:
        _CIRCUITS[damp] = (
            JCircuit(_noisy(j_rqc, jnoise, 6, 24, 0, damp)),
            Circuit(_noisy(t_rqc, tnoise, 6, 24, 0, damp)))
    return _CIRCUITS[damp]


@pytest.mark.parametrize('damp', [False, True], ids=['stochastic', 'kraus'])
@pytest.mark.parametrize('seed', range(20))
def test_samples_match_jax(seed, damp):
    """Stochastic sites only, then stochastic and Kraus sites (24 of
    them), 64 samples a seed: sample for sample with JAX."""
    cj, ct = _circuits(damp)
    want = jtraj.sample_trajectories(cj, 64, seed=seed)
    got = ttraj.sample_trajectories(ct, 64, seed=seed, device='cpu')
    assert got.shape == want.shape == (64, 2 ** 6)
    assert got.dtype == np.complex64
    assert _rel(want, got).max() <= RMS_TOL


def test_kernel_route_through_apply_bits_plain(monkeypatch):
    """The card's route (one ``apply_bits`` launch a gate and sample, a
    split container a sample) forced on the host, where ``apply_bits``
    runs its plain version: the same samples as the plain route (which
    ``test_samples_match_jax`` holds against JAX), and one ``apply_bits``
    call a gate, sample and Kraus candidate (plus the chosen one)."""
    _, ct = _circuits(True)
    S = 16
    plain = ttraj.sample_trajectories(ct, S, seed=3, device='cpu')
    monkeypatch.setattr(ttraj, '_route', lambda *a: 'bits')
    fk.reset_counts()
    got = ttraj.sample_trajectories(ct, S, seed=3, device='cpu')
    calls = fk.counts()['apply_bits_plain']
    n_kraus = sum(isinstance(g, FunctionalGate) for g in ct)
    assert n_kraus == 24
    assert calls == S * (len(ct) - n_kraus + 3 * n_kraus)
    assert _rel(plain, got).max() <= RMS_TOL


def test_route_takes_the_kernel_on_a_card_from_20_qubits():
    import torch

    cuda = torch.device('cuda')
    c64, c128 = np.dtype('complex64'), np.dtype('complex128')
    assert ttraj._route(cuda, c64, 20) == 'bits'
    assert ttraj._route(cuda, c64, 19) == 'plain'
    assert ttraj._route(cuda, c128, 24) == 'plain'
    assert ttraj._route(torch.device('cpu'), c64, 24) == 'plain'


def _exact_rho(cj, n):
    return np.asarray(jdm.simulate(cj, initial_state='0', **C128)
                      ).reshape(2 ** n, 2 ** n)


def test_batched_trajectories_match_exact_dm():
    """``tests/test_dm_noise.py:214`` on the port: 3000 trajectories of a
    3-qubit depolarized circuit against the exact density matrix."""
    n = 3

    def build(pkg_gate, pkg_circuit, noise):
        c = pkg_circuit([pkg_gate('H', [0]), pkg_gate('CX', [0, 1]),
                         pkg_gate('T', [1]), pkg_gate('CX', [1, 2])])
        return noise.add_depolarizing_noise(c, probs=0.15)
    from hybridq_tpu.gate import Gate as JGate
    noisy_j = build(JGate, JCircuit, jnoise)
    noisy_t = build(Gate, Circuit, tnoise)
    exact = _exact_rho(noisy_j, n)
    rho = ttraj.trajectory_density_matrix(Circuit(list(noisy_t)), 3000,
                                          initial_state='0', seed=11,
                                          device='cpu')
    np.testing.assert_allclose(rho, exact, atol=DM_ATOL)
    np.testing.assert_allclose(
        rho, jtraj.trajectory_density_matrix(JCircuit(list(noisy_j)), 3000,
                                             initial_state='0', seed=11),
        atol=RMS_TOL)


def test_batched_trajectories_general_kraus():
    """``tests/test_dm_noise.py:231`` on the port: amplitude damping
    (Kraus sites) alone at 2000 samples, then mixed with depolarizing
    noise at 3000, against the exact density matrix."""
    from hybridq_tpu.gate import Gate as JGate
    n = 2

    def base(G, C):
        return C([G('H', [0]), G('CX', [0, 1]), G('T', [1])])

    def damped(G, C, noise):
        chans = noise.AmplitudeDampingChannel([0, 1], gamma=0.35, p=1)
        return C(list(base(G, C)) + list(chans) +
                 [G('RY', [0], params=[0.7])])

    def mixed(G, C, noise):
        return C(list(noise.add_depolarizing_noise(base(G, C), probs=0.1)) +
                 list(noise.AmplitudeDampingChannel([0], gamma=0.5, p=0.6)))

    for build, S, seed in ((damped, 2000, 5), (mixed, 3000, 6)):
        cj = build(JGate, JCircuit, jnoise)
        ct = build(Gate, Circuit, tnoise)
        rho = ttraj.trajectory_density_matrix(ct, S, initial_state='0',
                                              seed=seed, device='cpu')
        np.testing.assert_allclose(rho, _exact_rho(cj, n), atol=DM_ATOL)


def test_complex128_against_complex64_and_the_exact_dm():
    """complex128 trajectories: within 1e-5 of the complex64 run sample
    for sample (no branch flips), and their density matrix within 0.05 of
    the exact one."""
    cj, ct = _circuits(True)
    s64 = ttraj.sample_trajectories(ct, 200, seed=1, device='cpu')
    s128 = ttraj.sample_trajectories(ct, 200, seed=1, device='cpu', **C128)
    assert s128.dtype == np.complex128
    assert _rel(s128, s64).max() <= RMS_TOL
    rho = np.einsum('si,sj->ij', s128, s128.conj()) / len(s128)
    np.testing.assert_allclose(rho, _exact_rho(cj, 6), atol=DM_ATOL)


def test_initial_state_tokens_and_refused_gates():
    """A token string per qubit, and arbitrary FunctionalGates refused as
    in JAX."""
    c = Circuit([Gate('CX', [0, 1])])
    out = ttraj.sample_trajectories(c, 2, initial_state='1+',
                                    device='cpu')
    want = np.array([0, 0, 1, 1]) / np.sqrt(2)
    np.testing.assert_allclose(out, [want, want], atol=1e-7)
    bad = Circuit([FunctionalGate(lambda psi, order: (psi, order),
                                  qubits=[0])])
    with pytest.raises(NotImplementedError, match='FunctionalGates'):
        ttraj.sample_trajectories(bad, 2, device='cpu')
