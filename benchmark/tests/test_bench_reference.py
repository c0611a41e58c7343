"""The plain references against dense numpy products and the program's
gate definitions, and the plan files read by the reference's own
unpickler."""

import os
import pickle

import numpy as np
import pytest
import torch

import _small
from hqbench import circuits
from reference import statevector, tensornet

D12 = os.path.join(_small.HERE, 'data', 'syc53_d12_s0_t26.pkl')


def dense(gates, n):
    psi = np.zeros((2,) * n, complex)
    psi[(0,) * n] = 1
    for name, qs, params in gates:
        k = len(qs)
        u = statevector.gate_matrix(name, params).reshape((2,) * 2 * k)
        psi = np.moveaxis(np.tensordot(u, psi, (list(range(k, 2 * k)),
                                                list(qs))),
                          list(range(k)), list(qs))
    return psi.reshape(-1)


@pytest.mark.parametrize('n,cycles,seed', [(4, 3, 0), (7, 5, 1), (10, 8, 2)])
def test_statevector_matches_dense(n, cycles, seed):
    gates = circuits.rqc(n, cycles, seed)
    want = dense(gates, n)
    got = statevector.evolve(gates, n, 'cpu').numpy()
    assert np.abs(got - want).max() < 1e-6


def test_blocks_of_the_state():
    gates = circuits.rqc(10, 6, 4)
    want = statevector.evolve(gates, 10, 'cpu').numpy()
    chunk = statevector.CHUNK
    try:
        statevector.CHUNK = 2 ** 4
        got = statevector.evolve(gates, 10, 'cpu').numpy()
    finally:
        statevector.CHUNK = chunk
    assert np.abs(got - want).max() < 1e-6


def test_gate_matrices_are_the_programs():
    from hybridq_tpu_torch import Gate

    for name, params in circuits.ONE_QUBIT_GATES + (
            ('FSIM', circuits.FSIM_PARAMS),):
        mine = statevector.gate_matrix(name, params)
        g = Gate(name, params=list(params)) if params else Gate(name)
        assert np.abs(mine - g.matrix()).max() < 1e-12, name
        assert np.allclose(mine @ mine.conj().T, np.eye(len(mine)))


def test_operations_merge_runs_of_one_qubit_gates():
    ops = statevector.operations(circuits.rqc(32, 14, 0), 32)
    assert len(ops) == 14 * 8 + 170
    assert all(len(a) <= statevector.GROUP for _, a in ops)


def test_round_tf32():
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -10, -3.0 - 2 ** -9, 0.0])
    y = statevector.round_tf32(x)
    assert y.tolist() == [1 + 2 ** -10, 1 + 2 ** -10, -3.0 - 2 ** -9, 0.0]
    z = torch.randn(1000, dtype=torch.complex64)
    r = statevector.round_tf32(z)
    assert (torch.abs(r - z) <= torch.abs(z) * 2 ** -11).all()
    assert not torch.equal(r, z)


def test_d12_plan_read_plainly():
    plan = tensornet.load_plan(D12)
    assert plan.nslices == 2 ** 16 and len(plan.sliced) == 16
    assert plan.output == ()
    assert abs(np.log2(tensornet.macs_per_slice(plan)) - 33.63) < 0.01
    legs, _, order = tensornet.node_legs(plan)
    sl = set(plan.sliced)
    widest = max(np.prod([plan.size[i] for i in legs[v] if i not in sl])
                 for v in order)
    assert widest == 2 ** 26


def test_d12_work_is_the_programs_count():
    from hybridq_tpu_torch.convert import load_reference_plan

    _, _, tree, sliced, _ = load_reference_plan(D12)
    plan = tensornet.load_plan(D12)
    assert tensornet.macs_per_slice(plan) == tree.total_flops(sliced)
    legs, _, _ = tensornet.node_legs(plan)
    for v, inds in tree.node_inds.items():
        assert set(legs[v]) == set(inds)


def test_unpickler_refuses_other_classes(tmp_path):
    path = tmp_path / 'x.pkl'
    with open(path, 'wb') as f:
        pickle.dump(os.system, f)
    with pytest.raises(pickle.UnpicklingError):
        tensornet.load_plan(path)


def test_small_plan_against_dense_and_program(tmp_path):
    from hybridq_tpu_torch.convert import load_reference_plan
    from hybridq_tpu_torch.simulation.tn.contract import (ContractionPlan,
                                                          SlicedContractor)

    path = tmp_path / 'plan.pkl'
    nslices = _small.make_plan(path)
    plan = tensornet.load_plan(path)
    vals = tensornet.slice_values(plan, 0, nslices, 'cpu')
    amp = dense(circuits.rqc(16, 8, 5), 16)[0]
    assert abs(vals.sum() - amp) < 1e-6
    net, oo, tree, sliced, _ = load_reference_plan(path)
    sc = SlicedContractor(ContractionPlan(tree, sliced), net.tensors, oo)
    for a, b in ((0, 3), (3, nslices)):
        assert abs(sc.contract_np(slice_range=(a, b)) -
                   vals[a:b].sum()) < 1e-6
    ctl = tensornet.slice_values(plan, 0, nslices, 'cpu', tf32=True)
    scale = np.sqrt(np.sum(np.abs(vals) ** 2))
    assert abs(ctl.sum() - vals.sum()) / scale > 1e-4
