"""The port's host extras against the JAX package's.

``tests/test_extras.py``'s layouts, OTOC workloads, ``MessageGate`` and
the gated ``to_cirq`` run on the port, each beside its JAX twin on the
same inputs: the layouts and layers are equal, the OTOC circuits have
the same gates and the same matrix (1e-10, complex128), and a
``MessageGate`` prints inside the port's ``simulate``.
Then ``tests/test_serialization.py:22-51``'s pickle round trips of gates,
circuits, channels and supergates on the port's classes.
"""

import itertools
import pickle

import numpy as np
import pytest

from hybridq_tpu.architecture import google as jgoogle
from hybridq_tpu.architecture.utils import get_layout_from_drawing as j_lfd
from hybridq_tpu.circuit import utils as jutils
from hybridq_tpu.extras import otoc as jotoc
from hybridq_tpu.gate import Gate as JGate
from hybridq_tpu_torch import architecture
from hybridq_tpu_torch.architecture.google import sycamore
from hybridq_tpu_torch.architecture.ibm import eagle, rochester
from hybridq_tpu_torch.architecture.rigetti import aspen_7, aspen_11
from hybridq_tpu_torch.architecture.utils import get_layout_from_drawing
from hybridq_tpu_torch.circuit import Circuit, utils
from hybridq_tpu_torch.dm.gate import KrausSuperGate, MatrixSuperGate
from hybridq_tpu_torch.extras import MessageGate, io
from hybridq_tpu_torch.extras.otoc import generate_OTOC
from hybridq_tpu_torch.extras.random import get_rqc
from hybridq_tpu_torch.gate import Gate, Measure, Projection
from hybridq_tpu_torch.noise import (AmplitudeDampingChannel,
                                     GlobalDepolarizingChannel)
from hybridq_tpu_torch.simulation import simulate

DRAWING = r"""
      X-X
     /  |
    X   X
    |   |
    X-X-X
    """


def test_layout_parser_reference_example():
    qubits, couplings = get_layout_from_drawing(DRAWING)
    assert qubits == [(0, 0), (0, 1), (1, 0), (1, 2), (2, 0), (2, 1),
                      (2, 2)]
    assert ((0, 0), (0, 1)) in [tuple(c) for c in couplings]
    assert (qubits, couplings) == j_lfd(DRAWING)


def test_device_layouts_match_jax():
    import hybridq_tpu.architecture.ibm as jibm
    import hybridq_tpu.architecture.rigetti as jrig

    sizes = {sycamore: 53, rochester: 53, eagle: 127, aspen_7: 25,
             aspen_11: 40}
    twins = {sycamore: jgoogle.sycamore, rochester: jibm.rochester,
             eagle: jibm.eagle, aspen_7: jrig.aspen_7,
             aspen_11: jrig.aspen_11}
    for mod, n in sizes.items():
        assert len(mod.layout) == n
        qs = set(mod.layout)
        assert all(a in qs and b in qs for a, b in mod.couplings)
        assert mod.layout == twins[mod].layout
        assert mod.couplings == twins[mod].couplings
    assert architecture.get_layout_from_drawing is get_layout_from_drawing


def test_supremacy_layers_partition_and_match_jax():
    layers = sycamore.get_layers()
    abcd = list(itertools.chain(*(layers[k] for k in 'ABCD')))
    assert sorted(abcd) == sorted(sycamore.couplings)
    jlayers = jgoogle.sycamore.get_layers()
    assert layers.keys() == jlayers.keys()
    for k in layers:
        assert layers[k] == jlayers[k], k


def _otoc(pkg_gen, G, layers):
    def ones():
        while True:
            yield G('SQRT_X')

    def twos():
        while True:
            yield G('ISWAP')
    return pkg_gen(layout=layers, depth=3, sequence=['A', 'B', 'C', 'D'],
                   one_qb_gates=ones(), two_qb_gates=twos(),
                   butterfly_op='X', ancilla=(0, 0),
                   targets=[(1, 0), (0, 1)])


def test_generate_otoc_small_matches_jax():
    qpu = [(0, 0), (0, 1), (1, 0), (1, 1)]
    c = _otoc(generate_OTOC, Gate, sycamore.get_layers(qpu))
    cj = _otoc(jotoc.generate_OTOC, JGate,
               jgoogle.sycamore.get_layers(qpu))
    assert len(c) > 0
    assert {'initial', 'first_control', 'butterfly', 'second_control'} <= \
        {g.tags.get('sequence') for g in c}
    assert [(g.name, tuple(g.qubits), g.tags) for g in c] == \
        [(g.name, tuple(g.qubits), g.tags) for g in cj]
    U = utils.matrix(c, complex_type='complex128')
    np.testing.assert_allclose(U @ U.conj().T, np.eye(U.shape[0]),
                               atol=1e-4)
    np.testing.assert_allclose(
        U, jutils.matrix(cj, complex_type='complex128'), atol=1e-10)
    with pytest.raises(ValueError, match='butterfly'):
        _otoc(lambda **kw: generate_OTOC(**{**kw, 'butterfly_op': 'Q'}),
              Gate, sycamore.get_layers(qpu))


def test_message_gate(capsys):
    c = Circuit([Gate('H', [0]), MessageGate('hello-from-sim',
                                             qubits=[0])])
    psi = simulate(c, initial_state='0', device='cpu')
    assert 'hello-from-sim' in capsys.readouterr().err
    np.testing.assert_allclose(np.abs(np.asarray(psi).ravel()),
                               [1 / np.sqrt(2)] * 2, atol=1e-5)
    assert MessageGate('m', qubits=[0]).message == 'm'


def test_to_cirq_gated():
    try:
        import cirq  # noqa: F401
        has_cirq = True
    except ImportError:
        has_cirq = False
    c = Circuit([Gate('H', [0]), Gate('CX', [0, 1])])
    if has_cirq:
        np.testing.assert_allclose(
            io.to_cirq(c).unitary(),
            utils.matrix(c, complex_type='complex128'), atol=1e-6)
    else:
        with pytest.raises(ImportError, match='cirq'):
            io.to_cirq(c)


def test_plot_needs_matplotlib_only_when_called():
    from hybridq_tpu_torch.architecture import plot

    try:
        import matplotlib
    except ImportError:
        with pytest.raises(ImportError, match='matplotlib'):
            plot.plot_qubits(sycamore.layout)
        return
    matplotlib.use('Agg')
    fig = plot.plot_qubits(sycamore.layout, sycamore.couplings,
                           selected_qubits=sycamore.layout[:3])
    assert len(fig.axes) == 1


def test_gate_pickle_roundtrip():
    gates = [
        Gate('H', [0]),
        Gate('RX', ['a'], params=[0.5])**1.5,
        Gate('ISWAP', [(0, 1), 'b']).conj(),
        Gate('MATRIX', qubits=[0, 1],
             U=np.kron(Gate('H').matrix(), Gate('X').matrix())),
        Gate('STOC', gates=[Gate('X', [0]), Gate('Z', [0])],
             p=[0.3, 0.7]),
        Projection('01', qubits=[0, 1]),
        Measure(qubits=[2]),
        MessageGate('m', qubits=[0]),
    ]
    for g in gates:
        g2 = pickle.loads(pickle.dumps(g))
        assert g2.name == g.name
        assert g2.qubits == g.qubits
        if g.provides('matrix'):
            np.testing.assert_allclose(g2.matrix(), g.matrix())


def test_circuit_pickle_roundtrip():
    c = get_rqc(4, 30, use_random_indexes=True)
    c2 = pickle.loads(pickle.dumps(c))
    assert len(c2) == len(c)
    np.testing.assert_allclose(
        utils.matrix(c2, complex_type='complex128'),
        utils.matrix(c, complex_type='complex128'), atol=1e-8)


def test_channel_and_supergate_pickle():
    for obj in [
            GlobalDepolarizingChannel([0, 1], 0.2),
            AmplitudeDampingChannel([0], gamma=0.3)[0],
            MatrixSuperGate(Map=np.eye(4), l_qubits=[0], r_qubits=[1]),
            KrausSuperGate(gates=((Gate('X', [0]),), (Gate('X', [0]),)),
                           s=1),
    ]:
        o2 = pickle.loads(pickle.dumps(obj))
        np.testing.assert_allclose(np.asarray(o2.map()),
                                   np.asarray(obj.map()), atol=1e-10)
