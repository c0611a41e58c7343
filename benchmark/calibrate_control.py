"""``calibrate.py``'s readings for a cell whose driver carries its own
control (``Driver.control()``; the density-matrix driver), at the cell's
own size on the card.

    python3 benchmark/calibrate_control.py --workload <cell> \\
        --seeds 1,2,... [--control-seeds 1,2,3]

For each seed of ``--seeds`` the cell's driver runs as a run of that seed
does, up to the first request that the run's check samples, and prints
the check's numbers for the program (``calibrate.reading``); for each
seed of ``--control-seeds`` it does the same inside ``Driver.control()``,
the plain reference with every product's operands rounded to TF32 in the
program's place.  One JSON line a reading; the benchmark's runs never run
this.
"""

import argparse
import importlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import torch

    from calibrate import reading
    from hqbench.harness import load_cell

    if not torch.cuda.is_available():
        print("calibrate_control.py needs a CUDA device", file=sys.stderr)
        return 2
    _, _, config, traffic = load_cell(args.workload)
    traffic = dict(traffic, checked_requests=1)
    Driver = importlib.import_module(
        f"hqbench.drivers.{config['driver']}").Driver
    for who, seeds in (('program', args.seeds),
                       ('control', args.control_seeds)):
        for seed in (int(s) for s in seeds.split(',') if s):
            t0 = time.perf_counter()
            if who == 'control':
                with Driver.control():
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
