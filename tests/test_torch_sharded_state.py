"""The sharded engine's result left on its shards (``ShardedState``), its
exchange in pieces, its counters and spans, on the CPU against the JAX
package.

``simulate(..., optimize='evolution-sharded', return_numpy_array=False)``
returns the shards and their layout; ``amplitudes`` reads given logical
bitstrings on each shard and must equal the gathered host array bit for
bit and JAX's ``simulate`` on its CPU mesh within complex64 rounding
(1e-5 on unit-norm states, as ``test_torch_sharded.py``).  With the
default ``return_numpy_array=True`` the result is the gathered array, as
before.  The circuits end with gates on qubits 0 and 1, the global ones,
so that the layout is left permuted.
"""

import json

import jax
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import hybridq_tpu as J
import hybridq_tpu_torch as T
from hybridq_tpu.extras.random import get_rqc as j_rqc
from hybridq_tpu.simulation import simulate as j_simulate
from hybridq_tpu_torch.extras.random import get_rqc as t_rqc
from hybridq_tpu_torch.parallel import mesh
from hybridq_tpu_torch.simulation import sharded
from hybridq_tpu_torch.simulation import simulate as t_simulate
from hybridq_tpu_torch.simulation.sharded import ShardedState

ATOL = 1e-5
MODES = ['indexed', 'traced']
KW = dict(initial_state='0', optimize='evolution-sharded', simplify=False,
          remove_id_gates=False)


def _circuits(n, seed):
    """The same circuit in both packages: a random circuit, then gates on
    the global qubits 0 and 1."""
    out = []
    for pkg, rqc in ((J, j_rqc), (T, t_rqc)):
        np.random.seed(seed)
        out.append(rqc(n, 6 * n, indexes=list(range(n))) + pkg.Circuit([
            pkg.Gate('H', qubits=[0]), pkg.Gate('CX', qubits=[1, n - 1]),
            pkg.Gate('H', qubits=[1])]))
    return out


def _index(n, count=512, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, 2 ** n, count), dtype=torch.int64)


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('n_dev', [2, 4])
@pytest.mark.parametrize('n', [10, 12])
def test_amplitudes_match_gather_and_jax(mode, n_dev, n):
    cj, ct = _circuits(n, 100 + n)
    st = t_simulate(ct, devices=['cpu'] * n_dev, sharded_mode=mode, **KW,
                    return_numpy_array=False)
    assert isinstance(st, ShardedState) and len(st.shards) == n_dev
    assert st.perm != list(range(n))
    index = _index(n)
    amps = st.amplitudes(index)
    assert amps.dtype == torch.complex64 and amps.shape == index.shape
    full = st.gather()
    assert full.shape == (2,) * n
    np.testing.assert_array_equal(amps.numpy(),
                                  full.reshape(-1)[index.numpy()])
    want = np.asarray(j_simulate(cj, devices=jax.devices()[:n_dev],
                                 sharded_mode=mode, **KW)).reshape(-1)
    np.testing.assert_allclose(amps.numpy(), want[index.numpy()],
                               atol=ATOL)


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('n_dev', [2, 4])
def test_numpy_result_unchanged(mode, n_dev):
    """The default result is the gathered array: JAX's within rounding,
    and the on-shard result's ``gather`` bit for bit."""
    n = 10
    cj, ct = _circuits(n, 7)
    got = t_simulate(ct, devices=['cpu'] * n_dev, sharded_mode=mode, **KW)
    assert isinstance(got, np.ndarray) and got.dtype == np.complex64
    assert got.shape == (2,) * n
    want = np.asarray(j_simulate(cj, devices=jax.devices()[:n_dev],
                                 sharded_mode=mode, **KW))
    np.testing.assert_allclose(got, want, atol=ATOL)
    st = t_simulate(ct, devices=['cpu'] * n_dev, sharded_mode=mode, **KW,
                    return_numpy_array=False)
    np.testing.assert_array_equal(st.gather(), got)


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('piece', [1, 8, 2 ** 6])
def test_exchange_in_pieces_is_the_whole_exchange(monkeypatch, mode,
                                                  piece):
    """Pieces smaller than the half's runs, and runs shorter than a
    piece (blocks of rows): the state bit for bit as with one piece."""
    n = 10
    _, ct = _circuits(n, 3)
    whole = t_simulate(ct, devices=['cpu'] * 4, sharded_mode=mode, **KW)
    monkeypatch.setattr(mesh, 'PIECE', piece)
    got = t_simulate(ct, devices=['cpu'] * 4, sharded_mode=mode, **KW)
    np.testing.assert_array_equal(got, whole)


@pytest.mark.parametrize('slot', [0, 3, 7])
@pytest.mark.parametrize('piece', [1, 4, 2 ** 5])
def test_pieces_cover_each_half_once(monkeypatch, slot, piece):
    """``Mesh._pieces`` of every slot covers each half's entries once,
    a piece at most ``PIECE`` floats."""
    monkeypatch.setattr(mesh, 'PIECE', piece)
    n_local = 8
    shard = torch.zeros(2 ** (n_local + 1))
    for half in (0, 1):
        view = mesh.Mesh._half(shard, slot, n_local, half)
        for idx in mesh.Mesh._pieces(slot, n_local):
            part = view[idx]
            assert part.numel() <= max(piece, 2 ** (n_local - slot - 1))
            part += 1
    assert bool((shard == 1).all())


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('n_dev', [2, 4])
def test_exchange_spans_match_counter(tmp_path, mode, n_dev):
    """Under a profiler: one ``hq.exchange b= slot= n=`` span an exchange
    that ``counts()`` counts, inside ``hq.simulate`` with the engine's
    other spans; on one device no byte crosses between devices."""
    n = 10
    _, ct = _circuits(n, 11)
    sharded.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t_simulate(ct, devices=['cpu'] * n_dev, sharded_mode=mode, **KW,
                   return_numpy_array=False)
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    names = [e['name'] for e in json.loads(path.read_text())['traceEvents']
             if e.get('ph') == 'X' and e.get('cat') == 'user_annotation'
             and e['name'].startswith('hq.')]
    ex = [m for m in names if m.split()[0] == 'hq.exchange']
    got = sharded.counts()
    assert len(ex) == got['exchange'] > 0 and got['exchange_bytes'] == 0
    g = n_dev.bit_length() - 1
    for m in ex:
        meta = dict(p.split('=') for p in m.split()[1:])
        assert set(meta) == {'b', 'slot', 'n'} and int(meta['n']) == n - g
        assert 0 <= int(meta['b']) < g and 0 <= int(meta['slot']) < n - g
    bases = {m.split()[0] for m in names}
    assert {'hq.simulate', 'hq.compress', 'hq.prepare_state',
            'hq.sharded.schedule', 'hq.sharded.operands',
            'hq.sync'} <= bases
    sharded.reset_counts()
    assert sharded.counts() == {'exchange': 0, 'exchange_bytes': 0}


@pytest.mark.parametrize('state', ['0101010101', '+-01+-01+-', '1' * 10])
@pytest.mark.parametrize('n_dev', [2, 4, 8])
def test_prepared_shards_match_jax(state, n_dev):
    """Each shard's container filled on its own device from amplitudes
    built once, then scaled by its global tokens: JAX's prepared state,
    with no container copied between devices."""
    from hybridq_tpu.simulation.sharded import ShardedEvolver as JSharded
    from hybridq_tpu_torch.simulation.sharded import ShardedEvolver

    n = len(state)
    ev = ShardedEvolver(n, devices=['cpu'] * n_dev)
    jev = JSharded(n_qubits=n, devices=jax.devices()[:n_dev])
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        shards = ev.prepare_state(state)
    # only the row and lane amplitudes are copied, never a container
    container = 2 ** (n - (n_dev.bit_length() - 1) + 1)
    copied = [int(np.prod(shape)) for e in prof.events()
              if e.name in ('aten::to', 'aten::_to_copy', 'aten::copy_',
                            'aten::clone')
              for shape in e.input_shapes[:1]]
    assert copied and max(copied) < container
    assert len({s.data_ptr() for s in shards}) == n_dev
    np.testing.assert_allclose(ev.gather(shards),
                               jev.gather(jev.prepare_state(state)),
                               atol=1e-7)


@pytest.mark.parametrize('mode', MODES)
def test_complex128_amplitudes(mode):
    """complex128 shards give complex128 amplitudes, equal to their
    gather and to the straight complex128 state."""
    n = 10
    _, ct = _circuits(n, 5)
    st = t_simulate(ct, devices=['cpu'] * 4, sharded_mode=mode, **KW,
                    complex_type='complex128', return_numpy_array=False)
    index = _index(n, seed=2)
    amps = st.amplitudes(index)
    assert amps.dtype == torch.complex128
    np.testing.assert_array_equal(amps.numpy(),
                                  st.gather().reshape(-1)[index.numpy()])
    want = np.asarray(t_simulate(ct, device='cpu', simplify=False,
                                 remove_id_gates=False, initial_state='0',
                                 complex_type='complex128')).reshape(-1)
    np.testing.assert_allclose(amps.numpy(), want[index.numpy()],
                               atol=1e-10)
