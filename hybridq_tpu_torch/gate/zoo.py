"""Named-gate zoo: matrices, generators, and flags.

Covers the same named gates and aliases as the reference implementation
(``hybridq/gate/gate.py:127-365``): I, H, X, Y, Z, U3, R_PI_2, ZZ, CZ, CX,
SWAP, ISWAP, CPHASE, FSIM, RX, RY, RZ, SQRT_X, SQRT_Y, P, T, SQRT_SWAP,
SQRT_ISWAP plus aliases (ID, S, Z_1_2, SQRT_Z, CNOT, X_1_2, Y_1_2, FS, ...).

The table is plain data (no metaclass machinery): each entry records the
qubit/param counts, a fixed matrix or a matrix generator, and whether the
gate is Clifford / self-adjoint / a rotation.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

__all__ = ['GateSpec', 'GATES', 'ALIASES', 'resolve_name', 'get_clifford_gates']

_SQRT2 = np.sqrt(2.0)


def _u3(t, p, l):
    t, p, l = float(t), float(p), float(l)
    return np.array(
        [[np.cos(t / 2), -np.exp(1j * l) * np.sin(t / 2)],
         [np.exp(1j * p) * np.sin(t / 2),
          np.exp(1j * (l + p)) * np.cos(t / 2)]])


def _r_pi_2(phi):
    phi = float(phi)
    return np.array([[1, -1j * np.exp(-1j * phi)],
                     [-1j * np.exp(1j * phi), 1]]) / _SQRT2


def _cphase(p):
    return np.diag([1, 1, 1, np.exp(1j * float(p))])


def _fsim(t, p):
    t, p = float(t), float(p)
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0, 0], [0, c, -1j * s, 0], [0, -1j * s, c, 0],
                     [0, 0, 0, np.exp(-1j * p)]])


def _sqrtm2(m):
    """Principal square root of a small matrix (host, exact via scipy)."""
    from scipy.linalg import sqrtm
    return np.asarray(sqrtm(np.asarray(m, dtype=complex)))


_X = np.array([[0, 1], [1, 0]], dtype=complex)
_Y = np.array([[0, -1j], [1j, 0]])
_Z = np.array([[1, 0], [0, -1]], dtype=complex)
_H = np.array([[1, 1], [1, -1]]) / _SQRT2
_ZZ = np.diag([1., -1., -1., 1.]).astype(complex)
_CZ = np.diag([1., 1., 1., -1.]).astype(complex)
_CX = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]],
               dtype=complex)
_SWAP = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                 dtype=complex)
_ISWAP = np.array([[1, 0, 0, 0], [0, 0, 1j, 0], [0, 1j, 0, 0], [0, 0, 0, 1]])


@dataclasses.dataclass(frozen=True)
class GateSpec:
    """Static description of a named gate."""
    name: str
    n_qubits: object  # int or the builtin `any` for variable-size gates
    n_params: int = 0
    matrix: Optional[np.ndarray] = None
    matrix_gen: Optional[Callable] = None
    rmatrix: Optional[np.ndarray] = None  # rotation generator: exp(-i r O / 2)
    clifford: bool = False
    self_adjoint: bool = False
    docstring: str = ''

    @property
    def is_rotation(self) -> bool:
        return self.rmatrix is not None

    def base_matrix(self, params=None) -> np.ndarray:
        """Matrix for the given params (qubit order = declared order)."""
        if self.rmatrix is not None:
            from scipy.linalg import expm
            (r,) = params
            return expm(-0.5j * float(r) * self.rmatrix)
        if self.matrix_gen is not None:
            if params is None:
                raise ValueError(f"'{self.name}' requires params.")
            return np.asarray(self.matrix_gen(*params))
        return np.asarray(self.matrix)


GATES = {
    'I':
        GateSpec('I', any, clifford=True, self_adjoint=True,
                 docstring="Identity operator (n_qubits=any)."),
    'H':
        GateSpec('H', 1, matrix=_H, clifford=True, self_adjoint=True,
                 docstring="Hadamard operator (n_qubits=1)."),
    'X':
        GateSpec('X', 1, matrix=_X, clifford=True, self_adjoint=True,
                 docstring="X Pauli matrix (n_qubits=1)."),
    'Y':
        GateSpec('Y', 1, matrix=_Y, clifford=True, self_adjoint=True,
                 docstring="Y Pauli matrix (n_qubits=1)."),
    'Z':
        GateSpec('Z', 1, matrix=_Z, clifford=True, self_adjoint=True,
                 docstring="Z Pauli matrix (n_qubits=1)."),
    'U3':
        GateSpec('U3', 1, n_params=3, matrix_gen=_u3,
                 docstring="Arbitrary single-qubit unitary "
                           "U3(t, p, l) = e^{i(p+l)/2} RZ(p) RY(t) RZ(l)."),
    'R_PI_2':
        GateSpec('R_PI_2', 1, n_params=1, matrix_gen=_r_pi_2,
                 docstring="Rotation in the X-Y plane: "
                           "R_PI_2(phi) = RZ(phi) RX(pi/2) RZ(-phi)."),
    'ZZ':
        GateSpec('ZZ', 2, matrix=_ZZ, clifford=True, self_adjoint=True,
                 docstring="Z ⊗ Z (n_qubits=2)."),
    'CZ':
        GateSpec('CZ', 2, matrix=_CZ, clifford=True, self_adjoint=True,
                 docstring="Controlled-Z gate (n_qubits=2)."),
    'CX':
        GateSpec('CX', 2, matrix=_CX, clifford=True, self_adjoint=True,
                 docstring="Controlled-X gate (n_qubits=2)."),
    'SWAP':
        GateSpec('SWAP', 2, matrix=_SWAP, clifford=True, self_adjoint=True,
                 docstring="Swap two qubits (n_qubits=2)."),
    'ISWAP':
        GateSpec('ISWAP', 2, matrix=_ISWAP, clifford=True,
                 docstring="Swap with i phase on |01>,|10> (n_qubits=2)."),
    'CPHASE':
        GateSpec('CPHASE', 2, n_params=1, matrix_gen=_cphase,
                 docstring="Phase e^{i phi} on |11> (n_qubits=2)."),
    'FSIM':
        GateSpec('FSIM', 2, n_params=2, matrix_gen=_fsim,
                 docstring="fSim gate (Sycamore native two-qubit gate)."),
    'RX':
        GateSpec('RX', 1, n_params=1, rmatrix=_X,
                 docstring="exp(-i phi X / 2) (n_qubits=1, n_params=1)."),
    'RY':
        GateSpec('RY', 1, n_params=1, rmatrix=_Y,
                 docstring="exp(-i phi Y / 2) (n_qubits=1, n_params=1)."),
    'RZ':
        GateSpec('RZ', 1, n_params=1, rmatrix=_Z,
                 docstring="exp(-i phi Z / 2) (n_qubits=1, n_params=1)."),
    'SQRT_X':
        GateSpec('SQRT_X', 1, matrix=_sqrtm2(_X), clifford=True,
                 docstring="Square root of X gate (n_qubits=1)."),
    'SQRT_Y':
        GateSpec('SQRT_Y', 1, matrix=_sqrtm2(_Y), clifford=True,
                 docstring="Square root of Y gate (n_qubits=1)."),
    'P':
        GateSpec('P', 1, matrix=_sqrtm2(_Z), clifford=True,
                 docstring="Phase gate S = sqrt(Z) (n_qubits=1)."),
    'T':
        GateSpec('T', 1, matrix=np.diag([1., np.exp(0.25j * np.pi)]),
                 docstring="T gate = Z**(1/4) (n_qubits=1)."),
    'SQRT_SWAP':
        GateSpec('SQRT_SWAP', 2, matrix=_sqrtm2(_SWAP),
                 docstring="Square root of SWAP gate (n_qubits=2)."),
    'SQRT_ISWAP':
        GateSpec('SQRT_ISWAP', 2, matrix=_sqrtm2(_ISWAP),
                 docstring="Square root of ISWAP gate (n_qubits=2)."),
}

ALIASES = {
    'ID': 'I',
    'S': 'P',
    'Z_1_2': 'P',
    'SQRT_Z': 'P',
    'CNOT': 'CX',
    'X_1_2': 'SQRT_X',
    'Y_1_2': 'SQRT_Y',
    'FS': 'FSIM',
    'STOC': 'STOCHASTIC',
    'FUN': 'FUNCTIONAL',
    'FN': 'FUNCTIONAL',
    'PROJ': 'PROJECTION',
    'MEAS': 'MEASURE',
}


def resolve_name(name: str) -> str:
    """Resolve a gate name through the alias table (case-insensitive)."""
    name = str(name).upper()
    return ALIASES.get(name, name)


def get_clifford_gates() -> tuple:
    """Names of all Clifford gates in the zoo."""
    return tuple(k for k, v in GATES.items() if v.clifford)
