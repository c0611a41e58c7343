"""The port's process layer (``hybridq_tpu_torch.parallel``) across real
processes, the counterpart of ``tests/test_multiprocess.py``.

Each case spawns worker interpreters that import only the port (none of
``jax`` or ``hybridq_tpu``) and join one gloo group through a
``file://`` store in the test's own directory, with a timeout on the
group and on every join.  Two layouts, as JAX's: 2 processes of 4 CPU
shards, and 8 of 1, where every exchange crosses a process.  Each worker:

 1. runs ``ShardedIndexedEvolver`` (and ``ShardedEvolver``) over the
    global mesh on a 7-qubit RQC, gathers the state and takes the outcome
    probabilities of qubits [0, 3, 5] (1e-5 against JAX's complex128
    evolution in the parent);
 2. contracts its ``parallel.local_slice_range`` share of one sliced TN
    plan that the parent built; the partials must sum to JAX's amplitude
    (1e-5);
 3. runs ``update_pauli_string`` with the group autodetected: the
    merged dict must equal the single-process one on every rank (1e-6).
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import hybridq_tpu as J
import hybridq_tpu_torch as T
from hybridq_tpu.extras.random import get_rqc as j_rqc
from hybridq_tpu.parallel import local_slice_range as j_local_slice_range
from hybridq_tpu.simulation import simulate as j_simulate
from hybridq_tpu.simulation.clifford import \
    update_pauli_string as j_update_pauli_string
from hybridq_tpu_torch.extras.random import get_rqc as t_rqc
from hybridq_tpu_torch.parallel import local_slice_range
from hybridq_tpu_torch.simulation import simulate as t_simulate
from hybridq_tpu_torch.simulation.tn import make_plan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, DEPTH, SEED = 7, 25, 1234
GROUP_TIMEOUT = 60          # seconds: every collective of a worker's group
JOIN_TIMEOUT = 240          # seconds: each worker, start to exit

WORKER = r'''
import pickle, sys
import numpy as np
import torch.distributed as dist
from hybridq_tpu_torch import Circuit, Gate, parallel
from hybridq_tpu_torch.extras.random import get_rqc
from hybridq_tpu_torch.simulation import simulate
from hybridq_tpu_torch.simulation.clifford import update_pauli_string
from hybridq_tpu_torch.simulation.sharded import (ShardedEvolver,
                                                  ShardedIndexedEvolver)

out_path, in_path, n_dev, timeout = sys.argv[1:5]
with open(in_path, 'rb') as f:
    job = pickle.load(f)
parallel.initialize(device='cpu', timeout=float(timeout))
pid = parallel.process_index()
res = {'pid': pid, 'count': parallel.process_count(),
       'distributed': parallel.is_distributed()}

np.random.seed(job['seed'])
n = job['n']
c = get_rqc(n, job['depth'], indexes=list(range(n))) + Circuit(
    Gate('H', [q]) for q in range(n))
for name, cls in (('indexed', ShardedIndexedEvolver),
                  ('traced', ShardedEvolver)):
    ev = cls(n, devices=['cpu'] * int(n_dev))
    psi = ev.prepare_state('0' * n)
    psi = ev.evolve(psi, c, qubits=list(range(n)))
    res[name] = {'state': ev.gather(psi), 'perm': list(ev.perm),
                 'exchanges': ev.exchanges, 'g': ev.g, 'norm': ev.norm(psi)}
    if name == 'indexed':
        psi, probs = ev.probabilities(psi, [0, 3, 5])
        res['probs'] = probs

net, info, plan = job['plan']
start, stop = parallel.local_slice_range(job['n_slices'])
res['slice_range'] = (start, stop)
res['partial'] = complex(np.asarray(simulate(
    net, optimize=(info, plan), device='cpu',
    slice_range=(start, stop))).reshape(-1)[0])

cc, pauli = job['clifford']
res['clifford'] = {b: dict(update_pauli_string(
    cc, pauli, float_type='float64', device='cpu', backend=b))
    for b in ('torch', 'numpy')}
res['imported'] = sorted({m.split('.')[0] for m in sys.modules} &
                         {'jax', 'jaxlib', 'hybridq_tpu'})
with open(out_path, 'wb') as f:
    pickle.dump(res, f)
dist.destroy_process_group()
'''


def _workload(pkg, rqc):
    np.random.seed(SEED)
    return rqc(N, DEPTH, indexes=list(range(N))) + pkg.Circuit(
        pkg.Gate('H', qubits=[q]) for q in range(N))


def _clifford(pkg):
    """Clifford+T ladder and a Pauli operator: ~200 output strings, so
    the frontier split is exercised (``example-multiprocess.py``'s)."""
    c = pkg.Circuit()
    for _ in range(3):
        for q in range(6):
            c.append(pkg.Gate('H', qubits=[q]))
            c.append(pkg.Gate('T', qubits=[q]))
        for q in range(5):
            c.append(pkg.Gate('CX', qubits=[q, q + 1]))
    return c, pkg.Circuit([pkg.Gate('X', qubits=[0]),
                           pkg.Gate('Z', qubits=[3])])


def _spawn(n_proc, n_dev, job, tmp_path):
    in_path = tmp_path / 'job.pkl'
    with open(in_path, 'wb') as f:
        pickle.dump(job, f)
    env = dict(os.environ, PYTHONPATH=ROOT,
               HYBRIDQ_TPU_COORDINATOR=f'file://{tmp_path}/store',
               HYBRIDQ_TPU_NUM_PROCESSES=str(n_proc),
               OMP_NUM_THREADS='1')
    procs, outs = [], []
    for pid in range(n_proc):
        outs.append(tmp_path / f'out{pid}.pkl')
        procs.append(subprocess.Popen(
            [sys.executable, '-c', WORKER, str(outs[-1]), str(in_path),
             str(n_dev), str(GROUP_TIMEOUT)],
            env=dict(env, HYBRIDQ_TPU_PROCESS_ID=str(pid)), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    results = []
    for out in outs:
        with open(out, 'rb') as f:
            results.append(pickle.load(f))
    return results


@pytest.mark.parametrize('n_proc, n_dev', [(2, 4), (8, 1)])
def test_multiprocess_layouts(n_proc, n_dev, tmp_path):
    """2 processes x 4 CPU shards, and 8 x 1, where every exchange and
    every reduction crosses a process boundary."""
    cj = _workload(J, j_rqc)
    psi = np.asarray(j_simulate(cj, initial_state='0',
                                complex_type='complex128'))
    p2 = np.abs(psi) ** 2
    expected_probs = p2.sum(axis=(1, 2, 4, 6)).reshape(-1)
    final = ''.join(str(b) for b in np.unravel_index(np.argmax(p2),
                                                     p2.shape))
    expected_amp = psi[tuple(int(b) for b in final)]

    ct = _workload(T, t_rqc)
    net, opt = t_simulate(ct, initial_state='0', final_state=final,
                          optimize='tn', tensor_only=True, max_time=2,
                          device='cpu')
    info, plan = make_plan(opt, target_size=2 ** 2, time_budget=2)
    n_slices = plan.nslices
    assert n_slices > 1          # empty shares sum to zero, as in JAX
    want_db = dict(j_update_pauli_string(*_clifford(J), use_mpi=False,
                                         float_type='float64'))

    results = _spawn(n_proc, n_dev, {
        'n': N, 'depth': DEPTH, 'seed': SEED, 'plan': (net, info, plan),
        'n_slices': n_slices, 'clifford': _clifford(T)}, tmp_path)

    assert sorted(r['pid'] for r in results) == list(range(n_proc))
    ranges = sorted(r['slice_range'] for r in results)
    assert ranges[0][0] == 0 and ranges[-1][1] == n_slices
    for (a, b), (c, d) in zip(ranges, ranges[1:]):
        assert b == c
    total = sum(r['partial'] for r in results)
    assert abs(total - expected_amp) < 1e-5, (total, expected_amp)
    for r in results:
        assert r['imported'] == [] and r['count'] == n_proc
        assert r['distributed']
        np.testing.assert_allclose(r['probs'], expected_probs, atol=1e-5)
        for mode in ('indexed', 'traced'):
            got = r[mode]
            assert got['g'] == 3 and got['exchanges'] > 0
            assert abs(got['norm'] - 1) < 1e-5
            assert got['perm'] == results[0][mode]['perm']
            np.testing.assert_allclose(got['state'], psi, atol=1e-5)
        for backend, got in r['clifford'].items():
            assert set(got) == set(want_db), (backend, len(got))
            for k, v in want_db.items():
                assert abs(got[k] - v) < 1e-6, (backend, k)


def test_local_slice_range_matches_jax():
    for n_slices in (1, 2, 7, 64, 65):
        for n_procs in (1, 2, 3, 8):
            ranges = [local_slice_range(n_slices, pid=p, n_procs=n_procs)
                      for p in range(n_procs)]
            assert ranges == [j_local_slice_range(n_slices, pid=p,
                                                  n_procs=n_procs)
                              for p in range(n_procs)]
            assert ranges[0][0] == 0 and ranges[-1][1] == n_slices
            sizes = [b - a for a, b in ranges]
            assert max(sizes) - min(sizes) <= 1


def test_single_process_defaults():
    """Without a group, as in JAX: process 0 of 1, not distributed, and
    the whole slice range."""
    from hybridq_tpu_torch import parallel

    assert parallel.process_index() == 0
    assert parallel.process_count() == 1
    assert not parallel.is_distributed()
    assert local_slice_range(10) == (0, 10)
