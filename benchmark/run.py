"""Benchmark of ``hybridq_tpu_torch`` on NVIDIA cards: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``workloads`` in ``BENCHMARK.json``) names a configuration and a
traffic mix.  The run builds its inputs from ``--seed``, warms the cell's
shapes, measures a closed loop of requests for ``--seconds`` (the
end-to-end metrics; with ``--trace 1`` the per-layer metrics of a traced
sub-window instead), checks the answers against the plain reference, and
prints one JSON object as the last line of its output.  It needs as many
cards as the cell asks for and never falls back to the host; a run in
which JAX or the JAX package was loaded prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'hybridq_tpu')


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [HERE, ROOT]
    import torch

    import hybridq_tpu_torch
    from hqbench.harness import load_cell, run_cell

    where = os.path.dirname(os.path.abspath(hybridq_tpu_torch.__file__))
    if where != os.path.join(ROOT, 'hybridq_tpu_torch'):
        print(f"hybridq_tpu_torch came from {where}, not from this "
              "checkout", file=sys.stderr)
        return 2

    _, cell, _, _ = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell['chips']):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), 'cuda', T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"loaded in this process: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    result['checks'] = {k: {'value': v, 'limit': lim}
                        for k, (v, lim) in checks.items()}
    print('request seconds: ' + ' '.join(
        f"{s:.4f}" for s in result.pop('request_seconds')), file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
