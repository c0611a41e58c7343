"""Circuit transformation toolbox.

Host-side, deterministic circuit rewrites mirroring the reference
``hybridq/circuit/utils.py``:

  * ``compress``      — greedy k-qubit blocking with matrix commutation
                        (reference ``:467-686``); the key pre-pass for the
                        evolution (k=4) and tensor-network (k=2) engines.
  * ``simplify``      — reverse insert-from-left with inverse cancellation
                        (reference ``:825-865``).
  * ``matrix``        — circuit → unitary with recursive compression
                        (reference ``:688-810``).
  * ``pop*``          — lightcone pruning against pinned qubits
                        (reference ``:865-950``).
  * ``moments``, ``remove_swap``, ``expand_iswap``, ``filter``, ``to_nx``.
"""

from __future__ import annotations

import copy

import numpy as np

from hybridq_tpu_torch.circuit.circuit import Circuit
from hybridq_tpu_torch.gate import (BaseGate, Gate, MatrixGate,
                                    PowerMatrixGate, TupleGate)
from hybridq_tpu_torch.utils import sort, argsort

__all__ = [
    'flatten', 'isidentity', 'isclose', 'insert_from_left', 'to_nx',
    'to_matrix_gate', 'compress', 'matrix', 'simplify', 'popright',
    'popleft', 'pop', 'moments', 'remove_swap', 'expand_iswap', 'filter'
]


def flatten(a) -> Circuit:
    """Expand any gate providing ``flatten`` (e.g. TupleGate) in place."""
    return Circuit(
        g for gs in a for g in (gs.flatten() if gs.provides('flatten') else
                                (gs,)))


def matrix(circuit, order=None, complex_type='complex64',
           max_compress: int = 4, verbose: bool = False) -> np.ndarray:
    """Unitary matrix of ``circuit`` in the given qubit order
    (default ``circuit.all_qubits``)."""
    circuit = Circuit(circuit)
    all_qubits = circuit.all_qubits
    if order is not None:
        order = list(order)
        if set(order) ^ set(all_qubits):
            raise ValueError(
                "'order' must be a valid permutation of the circuit qubits.")

    if max_compress > 0:
        blocks = compress(circuit, max_n_qubits=max_compress)
        circuit = Circuit(
            to_matrix_gate(c, complex_type=complex_type, max_compress=0)
            for c in blocks)

    qubits = list(all_qubits)
    n = len(qubits)
    U = np.reshape(np.eye(2**n, dtype=complex_type), (2,) * (2 * n))

    for g in circuit:
        gq = g.qubits
        k = len(gq)
        perm = [qubits.index(q) for q in gq]
        perm += [x for x in range(n) if x not in perm]
        qubits = [qubits[x] for x in perm]
        U = np.transpose(U, perm + list(range(n, 2 * n)))
        U = np.reshape(
            g.matrix().astype(complex_type) @ np.reshape(
                U, (2**k, 2**(2 * n - k))), (2,) * (2 * n))

    U = np.reshape(
        np.transpose(U, argsort(qubits) + list(range(n, 2 * n))),
        (2**n, 2**n))

    if order and order != all_qubits:
        idx = [all_qubits.index(q) for q in order]
        U = np.reshape(
            np.transpose(np.reshape(U, (2,) * (2 * n)),
                         idx + [n + i for i in idx]), (2**n, 2**n))
    return np.ascontiguousarray(U.astype(complex_type))


def to_matrix_gate(circuit, complex_type='complex64', **kwargs) -> MatrixGate:
    """Convert ``circuit`` into a single MatrixGate on its sorted qubits."""
    circuit = Circuit(circuit)
    return Gate('MATRIX',
                qubits=circuit.all_qubits,
                U=matrix(circuit, complex_type=complex_type, **kwargs))


def isidentity(a, atol: float = 1e-8) -> bool:
    """True if the circuit matrix is close to the identity."""
    M = matrix(a, complex_type='complex128')
    return np.allclose(M, np.eye(M.shape[0]), atol=atol)


def isclose(a, b, use_matrix_commutation: bool = True,
            max_n_qubits_matrix: int = 10, atol: float = 1e-8,
            verbose: bool = False) -> bool:
    """True if circuits ``a`` and ``b`` implement the same unitary."""
    s = simplify(Circuit(a) + Circuit(b).inv(),
                 use_matrix_commutation=use_matrix_commutation,
                 max_n_qubits_matrix=max_n_qubits_matrix, atol=atol,
                 verbose=verbose)
    return not s or all(isidentity([g], atol=atol) for g in s)


# Work of the insertion scan (``simplify``, ``pop*``, ``isclose``): gates
# inserted, positions visited, and inverse or commutation tests that
# reached numpy.  Work of ``compress``: its commutation tests that reached
# numpy; and of the engines that launch its blocks: blocks of more than one
# gate launched with the matrix ``compress`` built, or with one they built.
simplify_gates = 0
scanned = 0
matrix_tests = 0
compress_tests = 0
block_matrices_reused = 0
block_matrices_built = 0


def reset_counts():
    global simplify_gates, scanned, matrix_tests, compress_tests
    global block_matrices_reused, block_matrices_built
    simplify_gates = scanned = matrix_tests = compress_tests = 0
    block_matrices_reused = block_matrices_built = 0


def counts() -> dict:
    return {'simplify_gates': simplify_gates, 'scanned': scanned,
            'matrix_tests': matrix_tests, 'compress_tests': compress_tests,
            'block_matrices_reused': block_matrices_reused,
            'block_matrices_built': block_matrices_built}


def _own_matrix(g, cache: dict) -> np.ndarray:
    """``g.matrix()`` in complex128, computed once per ``cache``.  Each
    entry holds its gate, so no id is reused while the cache lives."""
    hit = cache.get(id(g))
    if hit is None:
        hit = cache[id(g)] = (g, np.asarray(g.matrix(), dtype='complex128'))
    return hit[1]


def _widen(M: np.ndarray, qubits: tuple, order: tuple) -> np.ndarray:
    """``M`` on ``qubits``, times the identity on the rest of ``order``,
    with its axes in ``order``."""
    if qubits == order:
        return M
    n, k = len(order), len(qubits)
    # Axes of M ⊗ I: M's outputs, M's inputs, then the identity's.
    T = np.multiply.outer(np.reshape(M, (2,) * (2 * k)),
                          np.reshape(np.eye(2**(n - k)), (2,) * (2 * (n - k))))
    rest = [q for q in order if q not in qubits]
    axis = {q: (i, k + i) for i, q in enumerate(qubits)}
    axis.update({q: (2 * k + i, n + k + i) for i, q in enumerate(rest)})
    perm = [axis[q][0] for q in order] + [axis[q][1] for q in order]
    return np.reshape(np.transpose(T, perm), (2**n, 2**n))


def _commute(A, qa: tuple, B, qb: tuple, atol: float) -> bool:
    """``commutes_with``'s test of the matrix ``A`` on ``qa`` against ``B``
    on ``qb``: ``B·A`` against ``A·B`` on the union of their qubits, in
    that argument order of ``np.allclose``.  The union starts with the
    wider one's qubits, which then needs no widening."""
    wide, narrow = (qb, qa) if len(qb) > len(qa) else (qa, qb)
    order = wide + tuple(q for q in narrow if q not in wide)
    A, B = _widen(A, qa, order), _widen(B, qb, order)
    return np.allclose(B @ A, A @ B, atol=atol)


def _commutes(gate, g, cache: dict, atol: float) -> bool:
    """``gate.commutes_with(g, atol=atol)`` for gates that share a qubit,
    from each gate's matrix taken once per ``cache``."""
    global matrix_tests
    if not (isinstance(g, BaseGate) and g.provides('matrix,qubits')):
        return False
    matrix_tests += 1
    return _commute(_own_matrix(gate, cache), gate.qubits,
                    _own_matrix(g, cache), g.qubits, atol)


def _is_inverse(inv, inv_M, g, cache: dict, atol: float) -> bool:
    """``inv.isclose(g, atol=atol)``, where ``inv_M`` is ``inv.matrix()``."""
    global matrix_tests
    if not (isinstance(g, BaseGate) and g.provides('matrix')):
        return False
    if inv.n_qubits != g.n_qubits or g.qubits is None:
        return False
    if sort(inv.qubits) != sort(g.qubits):
        return False
    M = _own_matrix(g, cache) if g.qubits == inv.qubits else \
        g.matrix(order=inv.qubits)
    matrix_tests += 1
    return np.allclose(inv_M, M, atol=atol)


def insert_from_left(circuit, gate: BaseGate, atol: float = 1e-8, *,
                     use_matrix_commutation: bool = True,
                     max_n_qubits_matrix: int = 10, simplify: bool = True,
                     pop: bool = False, pinned_qubits=None,
                     inplace: bool = False) -> Circuit:
    """Insert ``gate`` scanning from the left, cancelling with an inverse or
    commuting past gates when possible (reference ``:122-208``)."""
    if not inplace:
        circuit = Circuit(g.copy() for g in circuit)
    _insert(circuit, gate, {}, atol=atol,
            use_matrix_commutation=use_matrix_commutation,
            max_n_qubits_matrix=max_n_qubits_matrix, simplify=simplify,
            pop=pop, pinned_qubits=pinned_qubits)
    return circuit


def _insert(circuit, gate, cache: dict, gate_M=None, *, atol,
            use_matrix_commutation, max_n_qubits_matrix, simplify, pop=False,
            pinned_qubits=None):
    """``insert_from_left`` in place, with each matrix taken once per
    ``cache``; ``gate_M``, if given, is ``gate.matrix()`` in complex128.
    Only a ``PowerMatrixGate`` has an inverse and a commutation test."""
    global simplify_gates, scanned
    simplify_gates += 1

    if not gate.provides('qubits') or gate.qubits is None:
        circuit.insert(0, copy.deepcopy(gate))
        return
    qubits = set(gate.qubits)
    if gate_M is not None:
        cache[id(gate)] = (gate, gate_M)
    matrix_gate = isinstance(gate, PowerMatrixGate)

    # The inverse is the same at every position: build it once, and its
    # matrix at the first position it can match.
    inv = inv_M = None
    if simplify and matrix_gate:
        try:
            inv = gate.inv()
        except Exception:
            pass

    at = n_scanned = len(circuit)
    for p, g in enumerate(circuit):
        # A gate on other qubits that is small enough to test commutes and
        # is no inverse partner.
        try:
            gq = g.qubits
            if gq is not None and qubits and qubits.isdisjoint(gq) and \
                    g.n_qubits is not None and \
                    g.n_qubits <= max_n_qubits_matrix:
                continue
        except Exception:
            pass
        # Cancel with an inverse partner, which acts on the same qubits.
        if inv is not None:
            try:
                gq = g.qubits
                if gq is not None and len(gq) == len(qubits) and \
                        qubits.issuperset(gq):
                    if inv_M is None:
                        inv_M = inv.matrix()
                    if _is_inverse(inv, inv_M, g, cache, atol):
                        del circuit[p]
                        at, n_scanned = None, p + 1
                        break
            except Exception:
                pass
        # Commute past, or insert here.
        commute = False
        try:
            if g.n_qubits is not None and \
                    g.n_qubits <= max_n_qubits_matrix and \
                    g.qubits is not None:
                commute = not qubits.intersection(g.qubits)
                if not commute and use_matrix_commutation and matrix_gate:
                    commute = _commutes(gate, g, cache, atol)
        except Exception:
            pass
        if not commute:
            at, n_scanned = p, p + 1
            break
    else:
        # Commutes with everything: append, unless popping outside the
        # lightcone.
        if pop and not qubits.intersection(pinned_qubits or ()):
            at = None
    scanned += n_scanned

    hit = cache.pop(id(gate), None)
    if at is not None:
        new = copy.deepcopy(gate)
        circuit.insert(at, new)
        if hit is not None:
            cache[id(new)] = (new, hit[1])


def compress(circuit, max_n_qubits: int = 2, *, exclude_qubits=None,
             use_matrix_commutation: bool = True,
             max_n_qubits_matrix: int = 10, skip_compression=None,
             skip_commutation=None, atol: float = 1e-8,
             verbose: bool = False) -> list:
    """Greedily merge gates into blocks of at most ``max_n_qubits`` qubits.

    Deterministic; returns a list of ``Circuit`` blocks.  Matches the
    reference algorithm (``hybridq/circuit/utils.py:467-686``): a gate is
    pushed back through existing blocks as long as it commutes with them,
    and merged into the deepest block whose qubit-union stays within the
    limit.
    """
    return _compress(circuit, max_n_qubits, exclude_qubits=exclude_qubits,
                     use_matrix_commutation=use_matrix_commutation,
                     max_n_qubits_matrix=max_n_qubits_matrix,
                     skip_compression=skip_compression,
                     skip_commutation=skip_commutation, atol=atol)[0]


def _compress(circuit, max_n_qubits: int = 2, *, exclude_qubits=None,
              use_matrix_commutation: bool = True,
              max_n_qubits_matrix: int = 10, skip_compression=None,
              skip_commutation=None, atol: float = 1e-8):
    """``compress``'s blocks and, for each, its complex128 matrix: ``(U,
    qubits)`` on the block's sorted qubits, the product of its gates, or
    ``None`` where there is none (matrix commutation off, a gate without a
    matrix, or a block wider than ``max_n_qubits_matrix``).  Each gate's
    matrix is taken once, and the commutation tests and merges work on
    those arrays."""
    global compress_tests
    if max_n_qubits <= 0:
        blocks = [Circuit([g]) for g in circuit]
        return blocks, [None] * len(blocks)

    skip_compression = tuple(skip_compression or ())
    skip_commutation = tuple(skip_commutation or ())
    exclude_qubits = set(exclude_qubits or ())

    def _check_skip(gate, x):
        if isinstance(x, type):
            return isinstance(gate, x)
        if isinstance(x, str):
            return gate.name == x.upper() or gate.provides(x)
        raise ValueError(f"'{x}' not supported.")

    circuit = Circuit(circuit)
    # Each layer: [gates, qubits (None: a gate without qubits), matrix
    # (U, sorted qubits) or None, props]
    layers = []

    for gate in circuit:
        M = None
        props = dict(compress=True, commute=True)
        merge_to = len(layers)

        if not gate.provides('qubits') or gate.qubits is None:
            q = None
            props['compress'] = props['commute'] = False
        else:
            q = set(gate.qubits)
            if use_matrix_commutation and len(q) <= max_n_qubits_matrix:
                try:
                    order = tuple(sort(q))
                    M = (_widen(np.asarray(gate.matrix(), dtype='complex128'),
                                tuple(gate.qubits), order), order)
                except Exception:
                    M = None

            if any(_check_skip(gate, t) for t in skip_compression) or \
                    q & exclude_qubits:
                props['compress'] = False
            if any(_check_skip(gate, t) for t in skip_commutation):
                props['commute'] = False

            for i in reversed(range(len(layers))):
                _, cq, block_M, block_props = layers[i]
                if cq is None:
                    break
                if props['compress'] and block_props['compress']:
                    if len(q | cq) <= max(max_n_qubits, len(cq), len(q)):
                        merge_to = i
                if use_matrix_commutation and props['commute'] and \
                        block_props['commute']:
                    if not q & cq:
                        continue
                    if M is not None and block_M is not None:
                        compress_tests += 1
                        if _commute(*M, *block_M, atol):
                            continue
                break

        if merge_to < len(layers):
            layer = layers[merge_to]
            layer[0].append(gate)
            layer[1] |= q
            block_M = layer[2]
            layer[2] = None
            if use_matrix_commutation and M is not None and \
                    block_M is not None and \
                    len(layer[1]) <= max_n_qubits_matrix:
                # the gate after the block
                order = tuple(sort(layer[1]))
                layer[2] = (_widen(*M, order) @ _widen(*block_M, order),
                            order)
            for k in ('compress', 'commute'):
                layer[3][k] &= props[k]
        else:
            layers.append([[gate], q, M, props])

    return [Circuit(gates) for gates, _, _, _ in layers], \
        [M for _, _, M, _ in layers]


def _block_gate(block, matrix, complex_type):
    """The gate that launches a block of ``_compress``: its one gate, else
    a MatrixGate of ``matrix``, the block's matrix from ``_compress``,
    rounded once to ``complex_type``; where that is ``None``,
    ``to_matrix_gate``'s."""
    global block_matrices_reused, block_matrices_built
    if len(block) == 1:
        return block[0]
    if matrix is None:
        block_matrices_built += 1
        return to_matrix_gate(block, complex_type=complex_type)
    block_matrices_reused += 1
    U, qubits = matrix
    return Gate('MATRIX', qubits=qubits, U=U.astype(complex_type))


def simplify(circuit, atol: float = 1e-8,
             use_matrix_commutation: bool = True,
             max_n_qubits_matrix: int = 10, remove_id_gates: bool = True,
             verbose: bool = False) -> Circuit:
    """Cancel inverse pairs and drop identities (reference ``:825-865``).
    Each gate's matrix is computed at most once."""
    new_circuit = Circuit()
    cache = {}
    for gate in reversed(circuit):
        M = None
        if remove_id_gates:
            if gate.name == 'I':
                continue
            if gate.provides('matrix') and gate.n_qubits is not None and \
                    gate.n_qubits <= max_n_qubits_matrix:
                if isinstance(gate, PowerMatrixGate) and \
                        gate.qubits is not None:
                    M = np.asarray(gate.matrix(), dtype='complex128')
                    if np.allclose(M, np.eye(M.shape[0]), atol=atol):
                        continue
                elif isidentity([gate], atol=atol):
                    continue
        _insert(new_circuit, gate, cache, M, atol=atol,
                use_matrix_commutation=use_matrix_commutation,
                max_n_qubits_matrix=max_n_qubits_matrix, simplify=True)
    return new_circuit


def popright(circuit, pinned_qubits, atol: float = 1e-8,
             use_matrix_commutation: bool = True,
             max_n_qubits_matrix: int = 10, simplify: bool = True,
             verbose: bool = False) -> Circuit:
    """Remove gates outside the lightcone of ``pinned_qubits`` (from the
    right)."""
    new_circuit = Circuit()
    cache = {}
    for gate in reversed(circuit):
        _insert(new_circuit, gate, cache, atol=atol,
                use_matrix_commutation=use_matrix_commutation,
                max_n_qubits_matrix=max_n_qubits_matrix, simplify=simplify,
                pop=True, pinned_qubits=pinned_qubits)
    return new_circuit


def popleft(circuit, pinned_qubits, atol: float = 1e-8,
            use_matrix_commutation: bool = True, simplify: bool = True,
            verbose: bool = False) -> Circuit:
    """Remove gates outside the lightcone of ``pinned_qubits`` (from the
    left)."""
    return Circuit(
        reversed(
            popright(list(reversed(circuit)), pinned_qubits=pinned_qubits,
                     atol=atol,
                     use_matrix_commutation=use_matrix_commutation,
                     simplify=simplify, verbose=verbose)))


def pop(circuit, direction: str, pinned_qubits, atol: float = 1e-8,
        use_matrix_commutation: bool = True, simplify: bool = True,
        verbose: bool = False) -> Circuit:
    """Lightcone pruning in the given direction ('left'|'right'|'both')."""
    kw = dict(pinned_qubits=pinned_qubits, atol=atol,
              use_matrix_commutation=use_matrix_commutation,
              simplify=simplify, verbose=verbose)
    if direction == 'left':
        return popleft(circuit, **kw)
    if direction == 'right':
        return popright(circuit, **kw)
    if direction == 'both':
        return popleft(popright(circuit, **kw), **kw)
    raise ValueError(f"direction='{direction}' not supported.")


def moments(circuit) -> list:
    """Split a circuit into parallel moments (list of TupleGates)."""
    circuit = list(circuit)
    if not circuit:
        return [TupleGate()]

    def _get_qubits(x):
        if isinstance(x, BaseGate):
            return x.qubits if x.n_qubits else tuple()
        if isinstance(x, Circuit):
            return x.all_qubits
        raise ValueError(f"'{x}' is not valid.")

    qubits = sort({q for x in circuit for q in _get_qubits(x)})
    level_map = {q: 0 for q in qubits}
    level = [0] * len(circuit)
    for i, x in enumerate(circuit):
        xq = _get_qubits(x)
        if xq:
            level[i] = max(level_map[q] for q in xq) + 1
            level_map.update({q: level[i] for q in xq})
        else:
            level[i] = max(level) + 1
            level_map = {q: level[i] for q in qubits}
    out = [[] for _ in range(max(level))]
    for i, x in enumerate(circuit):
        out[level[i] - 1].append(x)
    return list(map(TupleGate, out))


def remove_swap(circuit: Circuit):
    """Delete SWAP gates by relabeling qubits instead of applying them.

    Returns ``(new_circuit, qubits_map)`` with ``qubits_map`` mapping
    new_qubit -> old_qubit.  This is the reference's relabel-and-swap trick
    (``hybridq/circuit/utils.py:1012-1055``); in the sharded engine the same
    idea rotates global qubits over ICI.
    """
    circuit = Circuit(circuit)
    qmap = {q: q for q in circuit.all_qubits}
    out = Circuit()
    SWAP = Gate('SWAP').matrix()
    inv = {v: k for k, v in qmap.items()}

    for gate in circuit:
        if gate.n_qubits == 2 and gate.qubits and \
                gate.provides('matrix') and \
                np.allclose(gate.matrix(), SWAP):
            q0, q1 = gate.qubits
            k0, k1 = inv[q0], inv[q1]
            qmap[k0], qmap[k1] = qmap[k1], qmap[k0]
            inv[q0], inv[q1] = k1, k0
        else:
            out.append(gate.on([inv[q] for q in gate.qubits]))
    return out, qmap


def expand_iswap(circuit: Circuit) -> Circuit:
    """Replace each ISWAP with SWAP · CZ · P ⊗ P
    (reference ``:1058-1097``)."""
    ISWAP = Gate('ISWAP').matrix()
    out = Circuit()
    for gate in circuit:
        if gate.n_qubits == 2 and gate.qubits and \
                gate.provides('matrix') and \
                np.allclose(gate.matrix(), ISWAP):
            tags = dict(gate.tags)
            ext = [
                Gate('SWAP', qubits=gate.qubits, tags=tags),
                Gate('CZ', qubits=gate.qubits, tags=tags),
                Gate('P', qubits=[gate.qubits[0]], tags=tags),
                Gate('P', qubits=[gate.qubits[1]], tags=tags),
            ]
            if getattr(gate, 'power', 1) == 1:
                out.extend(ext)
            else:
                out.extend(g**-1 for g in reversed(ext))
        else:
            out.append(gate.copy())
    return out


def filter(circuit, names=any, qubits=any, params=any, n_qubits=any,
           n_params=any, exact_match: bool = False, atol: float = 1e-8,
           **tags):
    """Lazily filter gates by name / qubits / params / tags
    (reference ``:1100-1189``)."""
    it = iter(circuit)
    if names is not any:
        nameset = {str(n).upper() for n in names}
        it = (g for g in it if g.name in nameset)
    if qubits is not any:
        if exact_match:
            qt = tuple(qubits)
            it = (g for g in it if g.provides('qubits') and g.qubits == qt)
        else:
            qs = set(qubits)
            it = (g for g in it if g.provides('qubits') and g.qubits and
                  qs.intersection(g.qubits))
    if params is not any:

        def _isclose(x, y):
            try:
                return np.isclose(float(x), float(y), atol=atol)
            except (TypeError, ValueError):
                return x == y

        it = (g for g in it if g.provides('params') and g.params and all(
            _isclose(x, y) for x, y in zip(g.params, params)))
    if n_qubits is not any:
        it = (g for g in it
              if g.provides('qubits') and g.n_qubits == n_qubits)
    if n_params is not any:
        it = (g for g in it
              if g.provides('params') and len(g.params or ()) == n_params)
    if tags:
        if exact_match:

            def _filter(g):
                return g.provides('tags') and all(
                    k in g.tags and (v is any or g.tags[k] == v)
                    for k, v in tags.items())
        else:

            def _filter(g):
                return g.provides('tags') and any(
                    k in g.tags and (v is any or g.tags[k] == v)
                    for k, v in tags.items())

        it = (g for g in it if _filter(g))
    return it


def to_nx(circuit, add_final_nodes: bool = True, node_tags: dict = None,
          edge_tags: dict = None, return_qubits_map: bool = False,
          leaves_prefix: str = 'q'):
    """Time-directed graph representation of the circuit
    (reference ``:211-324``)."""
    import networkx as nx

    node_tags = node_tags or {}
    edge_tags = edge_tags or {}
    circuit = Circuit(circuit)
    qubits = circuit.all_qubits
    qubits_map = {q: i for i, q in enumerate(qubits)}

    def _is_leaf(node):
        return isinstance(node, str) and node.startswith(leaves_prefix)

    if any(_is_leaf(q) for q in qubits):
        raise ValueError(
            f"No qubits must start with 'leaves_prefix'={leaves_prefix}.")

    graph = nx.DiGraph()
    for q in qubits:
        graph.add_node(f'{leaves_prefix}_{qubits_map[q]}_i', qubits=[q],
                       **node_tags)
    last_leg = {q: f'{leaves_prefix}_{qubits_map[q]}_i' for q in qubits}

    for x, gate in enumerate(circuit):
        graph.add_node(x, circuit=Circuit([gate]), qubits=sort(gate.qubits),
                       **node_tags)
        graph.add_edges_from([(last_leg[q], x) for q in gate.qubits],
                             **edge_tags)
        last_leg.update({q: x for q in gate.qubits})

    if add_final_nodes:
        for q in qubits:
            graph.add_node(f'{leaves_prefix}_{qubits_map[q]}_f', qubits=[q],
                           **node_tags)
        graph.add_edges_from([(x, f'{leaves_prefix}_{qubits_map[q]}_f')
                              for q, x in last_leg.items()], **edge_tags)

    if return_qubits_map:
        return graph, qubits_map
    return graph
