"""QASM dialect IO.

The same dialect as the reference (``hybridq/extras/io/qasm.py``): standard
QASM-ish ``<name> <qubits...> [params...]`` lines plus ``#@`` extension
comments carrying the qubits map, per-gate power / conj / T / tags, and the
matrix of MATRIX gates.  This is the CLI input format.
"""

from __future__ import annotations

import json
import re
from warnings import warn

import numpy as np

from hybridq_tpu_torch.circuit import Circuit
from hybridq_tpu_torch.gate import Gate

__all__ = ['to_qasm', 'from_qasm']


def _isint(x) -> bool:
    try:
        int(x)
        return True
    except ValueError:
        return False


def to_qasm(circuit: Circuit, qubits_map: dict = None) -> str:
    """Serialize a circuit to the QASM dialect."""
    out = []
    if qubits_map is None:
        qubits_map = {q: x for x, q in enumerate(circuit.all_qubits)}
    inv_map = {x: str(q) for q, x in qubits_map.items()}

    out.append(f'{len(qubits_map)}')
    out.append('#@ qubits = ')
    out.extend('#@ ' + x for x in json.dumps(inv_map, indent=2).split('\n'))

    for gate in circuit:
        if gate.name == 'MATRIX':
            out.append('#@ U = ')
            out.extend('#@ ' + x for x in json.dumps(
                [[str(y) for y in row] for row in gate.Matrix],
                indent=2).split('\n'))
        if gate.provides('tags') and gate.tags:
            out.append('#@ tags = ')
            out.extend('#@ ' + x
                       for x in json.dumps(gate.tags, indent=2).split('\n'))
        if gate.provides('power') and gate.power != 1:
            out.append(f'#@ power = {gate.power}')
        if gate.provides('is_conjugated') and gate.is_conjugated():
            out.append('#@ conj')
        if gate.provides('is_transposed') and gate.is_transposed():
            out.append('#@ T')

        line = gate.name.lower()
        if gate.provides('qubits') and gate.qubits is not None:
            line += ' ' + ' '.join(str(qubits_map[q]) for q in gate.qubits)
        else:
            line += ' .'
        if gate.provides('params') and gate.params is not None:
            line += ' ' + ' '.join(str(p) for p in gate.params)
        out.append(line)
    return '\n'.join(out) + '\n'


def from_qasm(qasm_string: str) -> Circuit:
    """Parse the QASM dialect back into a Circuit."""
    circuit = Circuit()
    extra = None
    power = None
    conj = False
    T = False
    tags = None
    qubits_map = None
    U = None

    for line in (l for l in qasm_string.split('\n')
                 if l and (l[0] != '#' or l[:2] == '#@')):
        if line[:2] == '#@':
            stripped = re.sub(r'\s+', '', line)
            if '#@tags=' in stripped:
                if tags is not None:
                    raise ValueError('Format error.')
                tags = line.split('=', 1)[-1]
                extra = 'tags'
            elif '#@U=' in stripped:
                if U is not None:
                    raise ValueError('Format error.')
                U = line.split('=', 1)[-1]
                extra = 'U'
            elif '#@power=' in stripped:
                if power is not None:
                    raise ValueError('Format error.')
                power = line.split('=', 1)[-1]
                extra = 'power'
            elif '#@conj' in stripped:
                conj = True
            elif '#@T' in stripped and '#@tags' not in stripped:
                T = True
            elif '#@qubits=' in stripped:
                if qubits_map is not None:
                    raise ValueError('Format error.')
                qubits_map = line.split('=', 1)[-1]
                extra = 'qubits'
            elif extra == 'tags':
                tags += line.replace('#@', '')
            elif extra == 'U':
                U += line.replace('#@', '')
            elif extra == 'power':
                power += line.replace('#@', '')
            elif extra == 'qubits':
                qubits_map += line.replace('#@', '')
            else:
                raise ValueError('Format error.')
            continue

        extra = None
        tokens = line.split('#')[0].split()
        if len(tokens) == 1:
            if _isint(tokens[0]):
                # the number-of-qubits header
                continue
            warn(f"Skipping '{' '.join(tokens)}' "
                 "(format is not understood).")
            continue
        if _isint(tokens[0]):
            # a leading layer index
            del tokens[0]

        name = tokens[0]
        if name.upper() == 'MATRIX':
            del tokens[0]
            if not U:
                raise ValueError('Format error.')
            M = np.real_if_close(
                np.array([[complex(y) for y in row]
                          for row in json.loads(U)]))
            gate = Gate('MATRIX', U=M)
            if tokens[0] != '.':
                gate = gate.on([int(x) for x in tokens])
            U = None
        else:
            gate = Gate(name)
            p = 1
            if tokens[p] != '.':
                gate = gate.on(
                    [int(x) for x in tokens[p:p + gate.n_qubits]])
                p += gate.n_qubits
            else:
                p += 1
            if p != len(tokens):
                n_params = getattr(gate, 'n_params', 0) or 0
                if p + n_params != len(tokens):
                    raise ValueError('Format error.')
                gate.set_params([float(x) for x in tokens[p:p + n_params]],
                                inplace=True)

        if tags:
            gate.set_tags(json.loads(tags), inplace=True)
        if power:
            gate.set_power(float(power), inplace=True)
        if conj:
            gate.conj(inplace=True)
        if T:
            gate.T(inplace=True)
        circuit.append(gate)
        tags = power = None
        conj = T = False

    if qubits_map is not None:

        def _maybe_int(x):
            try:
                return int(x)
            except ValueError:
                return x

        qubits_map = {int(k): _maybe_int(v)
                      for k, v in json.loads(qubits_map).items()}
        for i, gate in enumerate(circuit):
            if gate.provides('qubits') and gate.qubits is not None:
                circuit[i] = gate.on([qubits_map[x] for x in gate.qubits])

    return circuit
