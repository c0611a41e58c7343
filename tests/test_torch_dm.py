"""The port's density-matrix and noise layer against the JAX package's.

Each test of ``tests/test_dm_noise.py`` that needs neither trajectories
(ROADMAP [8]), the tensor-network engine ([10]) nor the reference
checkout runs here on both packages: the same circuit, built twice from
one seed, through JAX's ``dm.simulate`` and the port's with
``device='cpu'``, in complex128 (both sides exact complex128 products:
1e-10 absolute), beside the original's own dense or analytic check.  One
complex64 DM of 7 qubits (14 doubled) runs through the straight engine
against JAX's ``'evolution-indexed'`` (f32: 1e-5 on a unit-trace
vectorized rho).
"""

import numpy as np
import pytest
import torch

import hybridq_tpu as J
import hybridq_tpu_torch as T
from hybridq_tpu import dm as jdm
from hybridq_tpu import noise as jnoise
from hybridq_tpu.circuit import utils as jutils
from hybridq_tpu.extras.random import get_rqc as j_rqc
from hybridq_tpu.noise.channel import utils as jchu
from hybridq_tpu_torch import dm as tdm
from hybridq_tpu_torch import noise as tnoise
from hybridq_tpu_torch.extras.random import get_rqc as t_rqc
from hybridq_tpu_torch.noise.channel import utils as tchu
from hybridq_tpu_torch.simulation import simulate as t_simulate

ATOL = 1e-10
ATOL_F32 = 1e-5
ATOL_ANALYTIC = 1e-4           # test_dm_noise.py's bar
C128 = dict(complex_type='complex128')


def _both(build, seed):
    """``build(pkg, rqc, noise)`` for each package, from one seed."""
    out = []
    for pkg, rqc, noise in ((J, j_rqc, jnoise), (T, t_rqc, tnoise)):
        np.random.seed(seed)
        out.append(build(pkg, rqc, noise))
    return out


def _rho(x, n):
    return np.asarray(x).reshape(2**n, 2**n)


def _dm_both(cj, ct, n, **kw):
    want = _rho(jdm.simulate(cj, **kw), n)
    got = _rho(tdm.simulate(ct, device='cpu', **kw), n)
    np.testing.assert_allclose(got, want, atol=ATOL)
    return got


def test_unitary_dm_evolution_matches_dense(seed):
    n = 3
    cj, ct = _both(lambda pkg, rqc, _: rqc(n, 15, indexes=list(range(n))),
                   seed)
    got = _dm_both(cj, ct, n, initial_state='0', **C128)
    U = jutils.matrix(cj, complex_type='complex128')
    rho0 = np.zeros((2**n, 2**n))
    rho0[0, 0] = 1
    np.testing.assert_allclose(got, U @ rho0 @ U.conj().T,
                               atol=ATOL_ANALYTIC)
    assert tchu.is_dm(got)


def test_kraus_supergate_map():
    out = []
    for pkg, dm in ((J, jdm), (T, tdm)):
        U = pkg.Gate('H').matrix()
        k = dm.KrausSuperGate(gates=(
            (pkg.Gate('MATRIX', qubits=[0], U=U),),
            (pkg.Gate('MATRIX', qubits=[0], U=U),)), s=1)
        out.append(k.map())
    np.testing.assert_allclose(out[1], out[0], atol=ATOL)
    U = T.Gate('H').matrix()
    np.testing.assert_allclose(out[1], np.kron(U, U.conj()), atol=1e-8)


def test_matrix_supergate(seed):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((16, 16)) + 1j * rng.standard_normal((16, 16))
    gj = jdm.MatrixSuperGate(Map=M, l_qubits=[0, 1], r_qubits=[0, 1])
    gt = tdm.MatrixSuperGate(Map=M, l_qubits=[0, 1], r_qubits=[0, 1])
    np.testing.assert_allclose(gt.map(), M)
    assert gt.qubits == gj.qubits == ((0, 1), (0, 1))
    order = ((1, 0), (0, 1))
    np.testing.assert_allclose(gt.map(order=order), gj.map(order=order),
                               atol=ATOL)


def test_depolarizing_channel_analytic(seed):
    """E(rho) = (1-p) rho + p I/d, on both packages."""
    p, n = 0.3, 2
    cj, ct = _both(lambda pkg, rqc, _: rqc(n, 8, indexes=list(range(n))),
                   seed)
    pure = _dm_both(cj, ct, n, initial_state='0', **C128)
    noisy = _dm_both(
        list(cj) + [jnoise.GlobalDepolarizingChannel(list(range(n)), p)],
        list(ct) + [tnoise.GlobalDepolarizingChannel(list(range(n)), p)],
        n, initial_state='0', **C128)
    np.testing.assert_allclose(noisy, (1 - p) * pure + p * np.eye(2**n) /
                               2**n, atol=ATOL_ANALYTIC)


def _channels(noise):
    return [noise.GlobalDepolarizingChannel([0, 1], 0.25),
            noise.GlobalPauliChannel([0], s=[0.7, 0.1, 0.1, 0.1]),
            noise.LocalDephasingChannel([0], p=0.4)[0],
            noise.LocalDepolarizingChannel([0], p=0.2)[0],
            noise.AmplitudeDampingChannel([0], gamma=0.3, p=0.8)[0]]


def test_channels_are_cptp():
    for cj, ct in zip(_channels(jnoise), _channels(tnoise)):
        assert tchu.is_channel(ct, atol=1e-6), ct.name
        np.testing.assert_allclose(ct.map(), cj.map(), atol=ATOL)
        np.testing.assert_allclose(tchu.choi_matrix(ct),
                                   jchu.choi_matrix(cj), atol=ATOL)


def test_amplitude_damping_analytic():
    """Damping on |1><1| decays toward |0><0|."""
    out = []
    for pkg, dm, noise in ((J, jdm, jnoise), (T, tdm, tnoise)):
        (ch,) = noise.AmplitudeDampingChannel([0], gamma=0.4, p=1)
        kw = {'device': 'cpu'} if dm is tdm else {}
        out.append(_rho(dm.simulate([pkg.Gate('X', [0]), ch],
                                    initial_state='0', **C128, **kw), 1))
    np.testing.assert_allclose(out[1], out[0], atol=ATOL)
    np.testing.assert_allclose(out[1], np.diag([0.4, 0.6]),
                               atol=ATOL_ANALYTIC)


def test_trajectory_vs_exact_dm(seed):
    """The port's exact DM of a noisy circuit matches JAX's, and the
    average over stochastic trajectories of the port's pure-state
    ``simulate`` converges to it (the original's rtol of 5e-2)."""
    n = 2
    cj, ct = _both(lambda pkg, _, noise: noise.add_depolarizing_noise(
        pkg.Circuit([pkg.Gate('H', [0]), pkg.Gate('CX', [0, 1])]),
        probs=0.2), seed)
    exact = _dm_both(cj, ct, n, initial_state='0', **C128)
    rng = np.random.default_rng(42)
    samples = []
    for _ in range(800):
        psi = t_simulate(T.Circuit(list(ct)), initial_state='0',
                         allow_sampling=True, device='cpu',
                         sampling_seed=int(rng.integers(2**31)))
        samples.append(np.asarray(psi).ravel())
    np.testing.assert_allclose(tchu.reconstruct_dm(samples), exact,
                               atol=0.05)


def test_dm_initial_state_circuit_and_array(seed):
    n = 2
    cj, ct = _both(lambda pkg, rqc, _: rqc(n, 6, indexes=list(range(n))),
                   seed)
    prep = J.Circuit([J.Gate('H', [0]), J.Gate('CX', [0, 1])])
    psi0 = jutils.matrix(prep, complex_type='complex128') @ np.eye(2**n)[0]
    rho0 = np.outer(psi0, psi0.conj())
    got = _dm_both(cj, ct, n, initial_state=rho0.reshape((2,) * (2 * n)),
                   **C128)
    U = jutils.matrix(cj, complex_type='complex128')
    np.testing.assert_allclose(got, U @ rho0 @ U.conj().T,
                               atol=ATOL_ANALYTIC)
    # a pure state of nl axes (kron-doubled), and a Circuit as rho
    _dm_both(cj, ct, n, initial_state=psi0.reshape((2,) * n), **C128)
    pj, pt = (pkg.Circuit([pkg.Gate('H', [0]), pkg.Gate('CX', [0, 1])])
              for pkg in (J, T))
    want = _rho(jdm.simulate(cj, initial_state=pj, **C128), n)
    got = _rho(tdm.simulate(ct, initial_state=pt, device='cpu', **C128), n)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_ptrace_and_fidelity():
    bell = np.array([1, 0, 0, 1]) / np.sqrt(2)
    for chu in (jchu, tchu):
        np.testing.assert_allclose(chu.ptrace(bell, [0]), np.eye(2) / 2,
                                   atol=1e-8)
        np.testing.assert_allclose(chu.fidelity(bell, bell), 1, atol=1e-8)
        np.testing.assert_allclose(chu.fidelity(bell, np.outer(bell, bell)),
                                   1, atol=1e-8)
        np.testing.assert_allclose(
            chu.fidelity(np.array([1, 0]), np.diag([0.5, 0.5])), 0.5,
            atol=1e-8)


def test_choi_matrix_identity():
    """Choi matrix of the identity channel is the maximally entangled
    projector (unnormalized)."""
    bell = np.array([1, 0, 0, 1.0])
    for noise, chu in ((jnoise, jchu), (tnoise, tchu)):
        ch = noise.MatrixChannel(LMatrices=[np.eye(2)], qubits=[0])
        np.testing.assert_allclose(chu.choi_matrix(ch),
                                   np.outer(bell, bell), atol=1e-8)


def test_supercircuit_all_qubits():
    for pkg, dm in ((J, jdm), (T, tdm)):
        c = dm.Circuit([pkg.Gate('H', [1]),
                        dm.MatrixSuperGate(Map=np.eye(4), l_qubits=[0],
                                           r_qubits=[2])])
        assert c.all_qubits == ([0, 1], [1, 2])


@pytest.mark.parametrize('add', ['add_depolarizing_noise',
                                 'add_dephasing_noise',
                                 'add_amplitude_damping_noise'])
def test_noisy_rqc_matches_jax(add, seed):
    """Each noise injector on a random 3-qubit circuit, exact DM."""
    n = 3
    cj, ct = _both(lambda pkg, rqc, noise: getattr(noise, add)(
        rqc(n, 10, indexes=list(range(n))), 0.05), seed)
    got = _dm_both(cj, ct, n, initial_state='+', **C128)
    np.testing.assert_allclose(np.trace(got), 1, atol=1e-10)


def _noisy_layers(pkg, rqc, noise, n, depth, p=0.01):
    """``get_rqc(n, depth)`` with a ``LocalDepolarizingChannel`` on every
    qubit after each layer of ``n`` gates."""
    c = rqc(n, depth, indexes=list(range(n)))
    out = []
    for i, g in enumerate(c):
        out.append(g)
        if (i + 1) % n == 0:
            out += list(noise.LocalDepolarizingChannel(list(range(n)), p))
    return out


def test_dm_complex64_straight_engine_matches_jax(seed):
    """7 qubits (n = 14 doubled), complex64, through the straight engine
    ('evolution-indexed') on both sides."""
    n = 7
    cj, ct = _both(lambda pkg, rqc, noise: _noisy_layers(pkg, rqc, noise,
                                                         n, 21), seed)
    want = _rho(jdm.simulate(cj, initial_state='0',
                             optimize='evolution-indexed'), n)
    got, info = tdm.simulate(ct, initial_state='0', device='cpu',
                             optimize='evolution-indexed', return_info=True)
    got = _rho(got, n)
    assert info['engine'] == 'indexed' and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, atol=ATOL_F32)
    assert abs(np.trace(got) - 1) < 1e-4
    np.testing.assert_allclose(got, got.conj().T, atol=ATOL_F32)


def test_dm_raises_for_unported_engines(monkeypatch):
    """The engines once named here as not ported now run: Clifford
    (``tests/test_torch_clifford.py`` holds it against JAX) gives
    H^dagger Z H = X, the TN engine H|0><0|H; without a card both default
    engines raise, naming ``device='cpu'``."""
    c = [T.Gate('H', [0])]
    db = tdm.simulate(c, initial_state='Z', optimize='clifford',
                      device='cpu')
    assert set(db) == {'X'} and abs(db['X'] - 1) < 1e-6
    rho = tdm.simulate(c, initial_state='0', final_state='.',
                       optimize='tn', device='cpu', max_time=1)
    np.testing.assert_allclose(np.reshape(rho, (2, 2)),
                               np.full((2, 2), 0.5), atol=1e-6)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdm.simulate(c, initial_state='0')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdm.simulate(c, initial_state='Z', optimize='clifford')
