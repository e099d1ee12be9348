"""Run one cell of BENCHMARK.json and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  `--trace 0` prints the cell's end-to-end metrics, `--trace 1` its
per-layer metrics with the device's busy and window seconds and a
breakdown.  Every run checks what its timed path produced against the
plain reference (benchmark/reference/) and prints each compared number
beside its limit.  Without CUDA (or with fewer cards than the cell asks
for) it exits 2 and prints no result.

`--control` runs the correctness check's control (the next precision
down in the program's place) instead of the program; it has to come out
not correct.  `--list` prints the cells with the files the harness
found for them; `--dry-run` runs a cell on the CPU through the same
set-up, window and judgement and prints its checks, never a metric (a
CPU number is no device number): it is for tests at tiny sizes.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--seconds', type=float, default=10.0)
    ap.add_argument('--trace', type=int, default=0, choices=(0, 1))
    ap.add_argument('--bench', type=Path, default=None,
                    help='BENCHMARK.json to read (default: the checkout\'s)')
    ap.add_argument('--list', action='store_true')
    ap.add_argument('--dry-run', action='store_true')
    ap.add_argument('--control', action='store_true',
                    help='run the correctness check\'s control in the '
                    'program\'s place (it has to come out not correct)')
    args = ap.parse_args(argv)
    core.kernel_cache_env()
    if args.list:
        for row in core.list_cells(args.bench):
            print(json.dumps(row))
        return 0
    if not args.workload:
        ap.error('--workload is required')
    try:
        cell = core.Cell(args.workload, args.bench)
        import torch
        if args.dry_run:
            device = torch.device('cpu')
        else:
            core.require_cards(cell.chips)
            device = torch.device('cuda', 0)
            torch.cuda.set_device(device)
    except core.BenchError as e:
        print(f'benchmark: {e}', file=sys.stderr, flush=True)
        return 2
    tmp = core.scratch_dir('bench')
    try:
        result, checks = cell.driver().run(
            cell, args.seed, args.seconds, bool(args.trace), device,
            T_START, tmp, control=args.control)
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    out = {'correct': bool(result['correct']),
           'attempted': int(result['attempted']),
           'failed': int(result['failed'])}
    if args.dry_run:
        out.update({'dry_run': True, 'metrics': {},
                    'metric_names': sorted(result['metrics']),
                    'device': {'platform': 'cpu', 'count': 0}})
    else:
        out['metrics'] = result['metrics']
        out['device'] = core.device_block(cell.chips, result['peak_bytes'])
        if args.trace:
            out['device']['busy_s'] = result['busy_s']
            out['device']['window_s'] = result['traced_window_s']
            if result.get('breakdown'):
                out['breakdown'] = result['breakdown']
        out['card'] = core.card_info()
    out.update({k: v for k, v in result.items()
                if k in ('precision', 'window_s', 'steps', 'launches')})
    out['seed'] = args.seed
    core.emit(out, checks)
    return 0


if __name__ == '__main__':
    sys.exit(main())
