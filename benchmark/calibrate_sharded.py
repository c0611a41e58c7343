"""Readings that the sharded cell's limit of ``correct`` is set from, on
its four cards.

    python3 benchmark/calibrate_sharded.py [--seeds 1,2,...] \\
        [--control-seeds 3,4,...] [--workload sycamore-n34-m14.sharded4]

As ``calibrate.py`` (whose ``reading`` this runs) for the cells of the
``sharded`` driver: for each seed of ``--seeds`` the program's ``amp_gap``
in a run of that seed cut short after the request the check samples; for
each seed of ``--control-seeds`` the same with the control in the
program's place: the four-quarter reference with every product's
operands rounded to TF32, the next precision below the configuration's
complex64 with TF32 off.  One JSON line a reading; the benchmark's runs
never run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Quarters:
    """The control's answer in place of the program's result: the
    reference's quarters in TF32, read as the driver reads a result."""

    def __init__(self, gates, n, devices):
        from reference import sharded as reference

        self.gates, self.n, self.devices = gates, n, devices
        self.shards = [None] * reference.QUARTERS

    def amplitudes(self, index):
        import torch

        from reference import sharded as reference

        return torch.as_tensor(reference.amplitudes(
            self.gates, self.n, index, self.devices, tf32=True))


def control():
    """Context in which the control stands in for the program's entry."""
    from unittest import mock

    import torch

    from hqbench.drivers import sharded as driver

    def run_program(gates, n, options, devices):
        if devices is None:
            devices = [torch.device('cuda', i) for i in range(4)]
        return Quarters(gates, n, devices)
    return mock.patch.object(driver, 'run_program', run_program)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', default='sycamore-n34-m14.sharded4')
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import torch

    from calibrate import reading
    from hqbench.harness import load_cell

    if not torch.cuda.is_available():
        print("calibrate_sharded.py needs CUDA devices", file=sys.stderr)
        return 2
    _, _, config, traffic = load_cell(args.workload)
    traffic = dict(traffic, checked_requests=1)
    for who, group in (('program', args.seeds), ('control',
                                                 args.control_seeds)):
        for seed in (int(s) for s in group.split(',') if s):
            t0 = time.perf_counter()
            if who == 'control':
                with control():
                    got = reading(seed, config, traffic, 'cuda', warm=False)
            else:
                got = reading(seed, config, traffic, 'cuda')
            print(json.dumps({'workload': args.workload, 'who': who,
                              'seed': seed, **got,
                              'seconds': time.perf_counter() - t0}),
                  flush=True)
            for i in range(torch.cuda.device_count()):
                with torch.cuda.device(i):
                    torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
