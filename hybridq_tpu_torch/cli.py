"""Command-line interface.

The counterpart of ``hybridq_tpu/cli.py``: ``hybridq-tpu-torch`` mirrors
the reference ``bin/hybridq`` (flags, QASM input, pickled output dict)
through the port's ``simulate``; ``hybridq-tpu-torch-dm`` mirrors
``bin/hybridq-dm`` (Pauli-string expansion, JSON output) through the
port's ``clifford.update_pauli_string``.  Both run on the card unless
told ``--device cpu``.  ``python -m hybridq_tpu_torch.cli`` runs
``main``.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time
from warnings import warn

import numpy as np


def _get_state(state: str, n_qubits: int):
    """Expand a state token string; all-'.' means 'not provided'."""
    if state is None:
        return None
    state = str(state)
    if len(state) == 1:
        state *= n_qubits
    if set(state) == {'.'}:
        return None
    return state


def _add_device(p):
    p.add_argument('--device', default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs on the host)")


def _build_parser():
    p = argparse.ArgumentParser(
        prog='hybridq-tpu-torch',
        description='HybridQ-TPU on PyTorch: a hybrid quantum-circuit '
                    'simulator on an NVIDIA GPU.')
    p.add_argument('circuit_filename', nargs='?', default='stdin',
                   help="QASM circuit file (default: stdin)")
    p.add_argument('output_filename', help="output file (pickle)")
    p.add_argument('-p', '--params', default=None,
                   help="JSON file or inline JSON with extra parameters")
    p.add_argument('--initial-state', default='0')
    p.add_argument('--final-state', default='.')
    p.add_argument('--optimize', default='evolution')
    p.add_argument('--backend', default='torch')
    p.add_argument('--parallel', action='store_true')
    p.add_argument('--compress', default='auto')
    p.add_argument('--max-iterations', type=int, default=2)
    p.add_argument('--max-repeats', type=int, default=32)
    p.add_argument('--max-largest-intermediate', type=int, default=2**26)
    p.add_argument('--max-n-slices', type=int, default=None)
    p.add_argument('--tensor-only', action='store_true')
    p.add_argument('--complex-type', default='complex64')
    p.add_argument('--return-info', action='store_true')
    p.add_argument('--use-mpi', action='store_true',
                   help="accepted for compatibility; ignored")
    p.add_argument('--atol', type=float, default=1e-8)
    p.add_argument('--append', action='store_true')
    p.add_argument('--verbose', action='store_true')
    _add_device(p)
    p.add_argument('--version', action='version', version=_version())
    return p


def _version():
    from hybridq_tpu_torch import __version__
    return f'hybridq-tpu-torch {__version__}'


def _merge_params(args) -> dict:
    params = {k: v for k, v in vars(args).items() if v is not None}
    if params.get('params'):
        blob = params.pop('params')
        if os.path.exists(blob):
            with open(blob) as f:
                extra = json.loads(f.read())
        else:
            extra = json.loads(blob)
        params.update({k.replace('-', '_'): v for k, v in extra.items()})
    if params.get('compress') == 'auto':
        params.pop('compress')
    elif 'compress' in params:
        params['compress'] = int(params['compress'])
    return params


def _read_circuit(name):
    from hybridq_tpu_torch.extras.io import qasm

    if name == 'stdin':
        return qasm.from_qasm(sys.stdin.read())
    with open(name) as f:
        return qasm.from_qasm(f.read())


def main(argv=None):
    from hybridq_tpu_torch.simulation import simulate

    args = _build_parser().parse_args(argv)
    params = _merge_params(args)

    out_name = params.pop('output_filename')
    if os.path.exists(out_name) and not params.get('append'):
        warn(f"File '{out_name}' already exists and will be overwritten. "
             "If this is not the intended behavior, use --append instead.")

    circuit = _read_circuit(params.pop('circuit_filename'))
    n_qubits = len(circuit.all_qubits)
    params['initial_state'] = _get_state(params.get('initial_state'),
                                         n_qubits)
    params['final_state'] = _get_state(params.get('final_state'), n_qubits)
    params.pop('append', None)
    # --parallel threads the TN path search (the reference's per-rank
    # optimizer Pool); True = all cores.  Unused by the evolution engines.
    if not params.get('parallel'):
        params.pop('parallel', None)
    params.pop('use_mpi', None)

    verbose = params.get('verbose', False)
    if verbose:
        for k, v in params.items():
            print(f"# {k.replace('_', ' ').title()}: {v}", file=sys.stderr)
        print(f'# Number of qubits: {n_qubits}', file=sys.stderr)

    results = {}
    t0 = time.time()
    results['simulate'] = simulate(circuit, **params)
    results['runtime (s)'] = time.time() - t0

    if verbose:
        if 'evolution' in str(params.get('optimize', 'evolution')):
            psi = results['simulate'][0] if params.get('return_info') else \
                results['simulate']
            psi = np.asarray(psi).ravel()
            for x in range(min(8, len(psi))):
                print(f'{x:03b}...: {psi[x]:+1.5e} '
                      f'(norm^2={abs(psi[x])**2:1.5e})', file=sys.stderr)
        print(f"# Runtime (s): {results['runtime (s)']:1.4f}",
              file=sys.stderr)

    with open(out_name, 'ab' if args.append else 'wb') as f:
        f.write(pickle.dumps(results))


def main_dm(argv=None):
    """Clifford / Pauli-string expansion CLI (reference ``bin/hybridq-dm``).

    Outputs JSON with the expanded Pauli strings and their amplitudes.
    ``--parallel`` runs the numpy backend in one worker process a core;
    otherwise the torch backend runs on ``--device`` (default: the card).
    """
    from hybridq_tpu_torch.simulation import clifford

    p = argparse.ArgumentParser(
        prog='hybridq-tpu-torch-dm',
        description='Pauli-string expansion of a circuit-evolved operator.')
    p.add_argument('circuit_filename', nargs='?', default='stdin')
    p.add_argument('output_filename')
    p.add_argument('--initial-pauli-string', required=True,
                   help="e.g. 'XIZY' over the circuit qubits")
    p.add_argument('--atol', type=float, default=1e-8)
    p.add_argument('--parallel', action='store_true',
                   help="the numpy backend on all cores")
    p.add_argument('--use-mpi', action='store_true')
    p.add_argument('--compress', type=int, default=4)
    p.add_argument('--max-breadth-first-branches', type=int,
                   default=2**20)
    p.add_argument('--return-info', action='store_true')
    p.add_argument('--float-type', default='float32')
    p.add_argument('--verbose', action='store_true')
    _add_device(p)
    p.add_argument('--version', action='version', version=_version())
    args = p.parse_args(argv)

    circuit = _read_circuit(args.circuit_filename)
    pauli = args.initial_pauli_string.upper()
    if set(pauli) - set('IXYZ'):
        raise ValueError("Pauli string may contain only I, X, Y, Z.")
    if len(pauli) != len(circuit.all_qubits):
        raise ValueError("Pauli string length must equal the number of "
                         "qubits.")

    t0 = time.time()
    out = clifford.update_pauli_string(
        circuit, pauli, atol=args.atol, compress=args.compress,
        max_breadth_first_branches=args.max_breadth_first_branches,
        parallel=args.parallel,
        backend='numpy' if args.parallel else 'torch', device=args.device,
        float_type=args.float_type, return_info=args.return_info, verbose=args.verbose)
    dt = time.time() - t0
    if args.return_info:
        strings, info = out
    else:
        strings, info = out, {}

    payload = {
        'pauli_strings': {k: [float(np.real(v)), float(np.imag(v))]
                          for k, v in strings.items()},
        'runtime (s)': dt,
        'info': {k: v for k, v in info.items()
                 if isinstance(v, (int, float, str, bool))},
    }
    with open(args.output_filename, 'w') as f:
        json.dump(payload, f, indent=2)


if __name__ == '__main__':
    main()
