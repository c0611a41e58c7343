"""Batched noise-trajectory sampling.

The counterpart of ``hybridq_tpu/simulation/trajectories.py``: all
``n_samples`` trajectories of a noisy circuit evolve together, as a batch
on a leading axis.

- **Unitary-mixing channels** (``StochasticGate``): each trajectory's
  option is drawn on the host, and the sample's own matrix is applied.
- **General Kraus channels** (the ``MatrixChannel`` lowering,
  ``_is_device_kraus``): the branch is chosen from the data, by JAX's
  rule: ``p_k = w_k |K_k psi|^2``, a cumulative sum, ``searchsorted``
  (left) of ``u * cum[-1]`` clipped to ``[0, K - 1]``, and the chosen
  ``K psi`` renormalised with its norm floored at ``norm_atol``.  Where
  JAX keeps all ``K`` candidates at once (``vmap``), the port computes
  one candidate at a time and keeps only its norms, then applies each
  sample's chosen ``K`` once more: about twice the batch in memory,
  not ``K`` times, and the same arithmetic for the state kept.

The random numbers are drawn in JAX's order from one
``np.random.default_rng(seed)``: each ``StochasticGate``'s choices in
circuit order, then one uniform a Kraus site and sample, so that the two
packages agree sample for sample with the same ``seed``.

Two routes, chosen as ``simulate`` chooses its engine: on a CUDA device
in complex64 from ``MIN_KERNEL_QUBITS`` qubits, every sample is a split
container (a row of an ``[S, 2^(n+1)]`` f32 tensor) and each gate is one
``fused_kernels.apply_bits`` launch on it; otherwise the batch is a
complex ``(S,) + (2,)*n`` tensor and each site one batched ``matmul``.
Arbitrary ``FunctionalGate``\\ s are refused, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from hybridq_tpu_torch.circuit import Circuit, utils
from hybridq_tpu_torch.gate import FunctionalGate, StochasticGate
from hybridq_tpu_torch.simulation._device import resolve_device

__all__ = ['sample_trajectories', 'trajectory_density_matrix',
           'MIN_KERNEL_QUBITS']

# From this many qubits, complex64 trajectories on a card run on
# apply_bits (the threshold of simulate's engine on the card).
MIN_KERNEL_QUBITS = 20
NORM_ATOL = 1e-6


def _is_device_kraus(g) -> bool:
    """True for channels whose trajectory mode is cumulative-probability
    Kraus projection with a shared L/R set and diagonal s -- the class
    ``MatrixChannel`` lowers to ``_FunctionalChannel``."""
    s = getattr(g, 's', None)
    return (getattr(g, 'LMatrices', None) is not None and s is not None
            and np.ndim(s) == 1)


def _sites(circuit, qubit_index, n_samples, rng, complex_type,
           float_type, device):
    """``[(kind, axes, operands)]`` in circuit order, drawing each
    ``StochasticGate``'s choices from ``rng`` as JAX does: ``('gate',
    axes, U)``, ``('stochastic', axes, (options, choice))`` and
    ``('kraus', axes, (K, w))``, the operands as tensors on ``device``."""
    def dev(a):
        return torch.as_tensor(a, device=device)

    sites = []
    for g in circuit:
        if isinstance(g, FunctionalGate) and not _is_device_kraus(g):
            raise NotImplementedError(
                "arbitrary FunctionalGates are not supported in batched "
                "trajectories; use simulate(allow_sampling=True) per "
                "sample.")
        axes = tuple(qubit_index[q] for q in g.qubits)
        if isinstance(g, FunctionalGate):
            K = np.stack([np.asarray(m, dtype=complex_type)
                          for m in g.LMatrices])
            w = np.real(np.asarray(g.s)).astype(float_type)
            sites.append(('kraus', axes, (dev(K), dev(w))))
        elif isinstance(g, StochasticGate):
            options = [np.ascontiguousarray(
                og.matrix(order=g.qubits).astype(complex_type))
                for og in g.gates]
            if len({m.shape for m in options}) != 1:
                raise NotImplementedError(
                    "Stochastic options must act on the same qubits.")
            choice = rng.choice(len(options), size=n_samples,
                                p=np.real(g.p))
            sites.append(('stochastic', axes,
                          (dev(np.stack(options)), dev(choice))))
        else:
            sites.append(('gate', axes, dev(np.ascontiguousarray(
                g.matrix().astype(complex_type)))))
    return sites


def _choose(n2, w, u):
    """JAX's branch rule on ``n2`` ([S, K] norms^2 of the candidates),
    weights ``w`` [K] and uniforms ``u`` [S]: ``(branch [S], 1 / norm
    [S])``."""
    cum = torch.cumsum(w * n2, dim=1)
    idx = torch.searchsorted(cum, (u * cum[:, -1])[:, None],
                             side='left')[:, 0].clamp_(0, n2.shape[1] - 1)
    chosen = n2.gather(1, idx[:, None])[:, 0]
    return idx, 1.0 / torch.sqrt(torch.clamp(chosen, min=NORM_ATOL**2))


# -- the plain route: a complex (S,) + (2,)*n tensor --------------------

def _apply(psi, M, axes):
    """``M`` ([d, d], or one matrix a sample: [S, d, d]) on axes ``axes``
    (first axis = most significant bit of the gate index) of every sample
    of ``psi`` ([S] + [2]*n); returns a new tensor."""
    k = len(axes)
    dims = [1 + a for a in axes]
    front = list(range(1, k + 1))
    x = psi.movedim(dims, front).reshape(psi.shape[0], 2 ** k, -1)
    return torch.matmul(M, x).reshape(psi.shape).movedim(front, dims)


def _run_plain(sites, psi, uniforms):
    u_i = 0
    for kind, axes, ops in sites:
        if kind == 'gate':
            psi = _apply(psi, ops, axes)
        elif kind == 'stochastic':
            options, choice = ops
            psi = _apply(psi, options[choice], axes)
        else:
            K, w = ops
            sum_dims = tuple(range(1, psi.dim()))
            n2 = torch.stack([torch.sum(c.real * c.real + c.imag * c.imag,
                                        dim=sum_dims)
                              for c in (_apply(psi, Kk, axes) for Kk in K)],
                             dim=1)
            idx, inv = _choose(n2, w, uniforms[:, u_i])
            psi = _apply(psi, K[idx], axes)
            psi = psi * inv.reshape((-1,) + (1,) * (psi.dim() - 1))
            u_i += 1
    return psi


# -- the kernel route: one split container a sample ---------------------

def _run_bits(sites, X, uniforms, n):
    """Every site on every row of ``X`` ([S, 2^(n+1)] f32, one split
    container a sample), one ``apply_bits`` launch a gate and sample."""
    from hybridq_tpu_torch.simulation.fused_kernels import apply_bits

    N = 2 ** n
    S = X.shape[0]
    scratch = None
    u_i = 0
    for kind, axes, ops in sites:
        bits = [n - 1 - a for a in axes]
        if kind == 'gate':
            for s in range(S):
                apply_bits(X[s], ops, bits)
        elif kind == 'stochastic':
            options, choice = ops
            mats = options[choice]
            for s in range(S):
                apply_bits(X[s], mats[s], bits)
        else:
            K, w = ops
            if scratch is None:
                scratch = torch.empty_like(X[0])
            n2 = torch.empty((S, K.shape[0]), dtype=torch.float32,
                             device=X.device)
            for j in range(K.shape[0]):
                for s in range(S):
                    apply_bits(scratch.copy_(X[s]), K[j], bits)
                    re, im = scratch[:N], scratch[N:]
                    n2[s, j] = torch.sum(re * re + im * im)
            idx, inv = _choose(n2, w, uniforms[:, u_i])
            mats = K[idx]
            for s in range(S):
                apply_bits(X[s], mats[s], bits)
                X[s].mul_(inv[s])
            u_i += 1
    return X


def _route(device, complex_type, n) -> str:
    """'bits' (the kernel route) or 'plain'; see the module docstring."""
    if device.type == 'cuda' and complex_type == np.dtype('complex64') \
            and n >= MIN_KERNEL_QUBITS:
        return 'bits'
    return 'plain'


def sample_trajectories(circuit, n_samples: int, initial_state='0',
                        complex_type='complex64', seed=None,
                        device=None) -> np.ndarray:
    """Evolve ``n_samples`` noise trajectories as one batch on ``device``
    (``None`` means ``'cuda'``, which raises without a card; pass
    ``device='cpu'`` for the host).

    Returns the final states as a numpy array of shape
    ``(n_samples, 2**n)``, over the sorted circuit qubits.
    """
    from hybridq_tpu_torch.simulation.prepare import (pack_container,
                                                      prepare_state)

    device = resolve_device(device, 'sample_trajectories()')
    complex_type = np.dtype(complex_type)
    float_type = np.real(np.zeros(1, dtype=complex_type)).dtype
    circuit = utils.flatten(Circuit(circuit))
    qubits = circuit.all_qubits
    n = len(qubits)
    qubit_index = {q: i for i, q in enumerate(qubits)}
    rng = np.random.default_rng(seed)

    sites = _sites(circuit, qubit_index, n_samples, rng, complex_type,
                   float_type, device)
    n_kraus = sum(kind == 'kraus' for kind, _, _ in sites)
    uniforms = torch.as_tensor(
        rng.random((n_samples, max(n_kraus, 1))).astype(float_type),
        device=device)

    psi0 = prepare_state(
        initial_state * n if len(str(initial_state)) == 1
        else initial_state, complex_type=complex_type)
    out = np.empty((n_samples, 2 ** n), dtype=complex_type)
    host = torch.from_numpy(out)          # results land straight in out
    if _route(device, complex_type, n) == 'bits':
        X = pack_container(psi0, device).repeat(n_samples, 1)
        X = _run_bits(sites, X, uniforms, n)
        N = 2 ** n
        for s in range(n_samples):
            host[s].copy_(torch.complex(X[s, :N], X[s, N:]))
    else:
        psi = torch.as_tensor(psi0, device=device).expand(
            (n_samples,) + psi0.shape)
        host.copy_(_run_plain(sites, psi, uniforms).reshape(n_samples, -1))
    return out


def trajectory_density_matrix(circuit, n_samples: int, initial_state='0',
                              complex_type='complex64', seed=None,
                              device=None) -> np.ndarray:
    """Monte-Carlo density matrix: the average of ``|psi_s><psi_s|`` over
    the batched trajectories of ``sample_trajectories``."""
    states = sample_trajectories(circuit, n_samples,
                                 initial_state=initial_state,
                                 complex_type=complex_type, seed=seed,
                                 device=device)
    return np.einsum('si,sj->ij', states, states.conj()) / n_samples
