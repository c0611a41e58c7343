"""Small versions of the cells for the host, shared by the tests."""

import os
import pickle
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

from hqbench import circuits, harness  # noqa: E402

SV_CELL = 'sycamore-n32-m14.nosimplify'
TN_CELL = 'sycamore53-m12.slices'


def small_sv(n=10, cycles=8):
    """The nosimplify cell at ``n`` qubits on the host, through the
    straight engine (``'evolution-indexed'``, the card's route of
    ``'evolution'``) and the plain version of its kernel."""
    _, _, config, traffic = harness.load_cell(SV_CELL)
    config = dict(config, n_qubits=n, cycles=cycles)
    traffic = dict(traffic, bitstrings=256, simulate=dict(
        traffic['simulate'], optimize='evolution-indexed'))
    return config, traffic


def make_plan(path, n=16, cycles=8, target=2 ** 7):
    """A sliced plan of a small circuit of the generator, written as the
    program pickles its plans; returns its slice count."""
    from hybridq_tpu_torch.simulation import simulate
    from hybridq_tpu_torch.simulation.tn import make_plan as plan_of
    from hybridq_tpu_torch.simulation.tn.slicer import SliceCost

    from hqbench import system

    net, opt = simulate(system.circuit(circuits.rqc(n, cycles, 5)),
                        initial_state='0' * n, final_state='0' * n,
                        optimize='tn', tensor_only=True, device='cpu',
                        max_time=1)
    _, plan = plan_of(opt, target_size=target, time_budget=1)
    cost = SliceCost(plan.tree, plan.sliced_set)
    with open(path, 'wb') as f:
        pickle.dump((net, list(plan.tree.output), plan.tree,
                     plan.sliced_set, cost), f)
    return plan.nslices


def small_tn(path, per_call=4):
    """The TN cell on a small plan; the check takes every call's sum, as
    one small call's rounding can be too small to tell TF32 apart."""
    _, _, config, traffic = harness.load_cell(TN_CELL)
    config = dict(config, plan=str(path))
    traffic = dict(traffic, slices_per_call=per_call, warm_slices=2,
                   checked_requests=10 ** 6)
    return config, traffic


def run(cell, config, traffic, seed=2 ** 31 + 11, seconds=0.2,
        trace=False):
    return harness.run_cell(cell, seed, seconds, trace, 'cpu',
                            time.perf_counter(), config=config,
                            traffic=traffic)
