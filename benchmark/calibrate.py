"""Readings that the limits of ``correct`` are set from, at a cell's own
size on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3]

For each seed of ``--seeds`` the cell's driver runs as a run of that seed
does (set-up, the warm-up, then requests), up to the first request that
the run's check samples, and prints the check's number for the program.
For each seed of ``--control-seeds`` it does the same with the control in
the program's place: the plain reference with every product's operands
rounded to TF32, the next precision below the configuration's complex64
with TF32 off.  One JSON line a reading; the benchmark's runs never run
this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def control(config):
    """Context in which the reference, in TF32, stands in for the
    program's entry."""
    from unittest import mock

    import numpy as np

    from hqbench import system
    from reference import statevector, tensornet

    if config['driver'] == 'statevector':
        def simulate_circuit(gates, n, options, device):
            return statevector.evolve(gates, n, device, tf32=True)
        return mock.patch.object(system, 'simulate_circuit',
                                 simulate_circuit)
    plan = tensornet.load_plan(os.path.join(ROOT, config['plan']))

    def simulate_slices(net, optimize, start, stop, options, device):
        vals = tensornet.slice_values(plan, start, stop, device, tf32=True)
        return vals.sum(0).astype(np.complex64)
    return mock.patch.object(system, 'simulate_slices', simulate_slices)


def reading(seed, config, traffic, device, warm=True):
    """The check's numbers of one run of ``seed`` cut short after the
    request that the check samples (the control skips the warm-up, which
    only builds and loads the program's kernels)."""
    import importlib

    import numpy as np

    Driver = importlib.import_module(
        f"hqbench.drivers.{config['driver']}").Driver
    driver = Driver(config, traffic, seed, device, ROOT)
    if warm:
        driver.warm()
    rng = np.random.default_rng([int(seed), 3])
    # the check's first draw among one completed request is request 0
    driver.request(0)
    driver.release()
    return {k: v for k, (v, _) in driver.check(rng).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import torch

    from hqbench.harness import load_cell

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA device", file=sys.stderr)
        return 2
    _, _, config, traffic = load_cell(args.workload)
    traffic = dict(traffic, checked_requests=1)
    seeds = [int(s) for s in args.seeds.split(',') if s]
    controls = [int(s) for s in args.control_seeds.split(',') if s]
    for who, group in (('program', seeds), ('control', controls)):
        for seed in group:
            t0 = time.perf_counter()
            if who == 'control':
                with control(config):
                    got = reading(seed, config, traffic, 'cuda', warm=False)
            else:
                got = reading(seed, config, traffic, 'cuda')
            print(json.dumps({'workload': args.workload, 'who': who,
                              'seed': seed, **got,
                              'seconds': time.perf_counter() - t0}),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
