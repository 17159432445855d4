"""The benchmark of ``ssrs_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout that holds the program. It sets up the
cell (``BENCHMARK.json``'s workload), runs its jobs back to back for
``--seconds`` (the job in flight at the end is finished and counted),
with ``--trace 1`` profiles one more job, checks the outputs against the
plain reference, and prints one JSON line last: ``correct``, ``attempted``,
``failed``, ``metrics`` (the end-to-end metrics, or with ``--trace 1`` the
per-layer ones), ``device`` and, traced, ``breakdown``; the compared
numbers with their limits last, under ``checks``, and on standard error.
It exits non-zero, with no result, without enough CUDA devices, and when
JAX or the JAX package was loaded."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    t_start = time.perf_counter()
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark import cells, harness, offline
    cell = cells.find_cell(cells.load_spec(ROOT), args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell['chips']):
        print(f'{args.workload} needs {cell["chips"]} CUDA device(s); '
              f'{torch.cuda.device_count()} available', file=sys.stderr)
        return 2
    offline.refuse_http()
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), device='cuda:0',
                              t_start=t_start)
    found = harness.forbidden_modules()
    if found:
        print(f'the run loaded JAX or the JAX package: {found}',
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
            os.path.abspath(__file__)):
        sys.path[0] = ROOT
    else:
        sys.path.insert(0, ROOT)
    sys.exit(main())
