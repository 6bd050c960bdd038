#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from (PERF.md
gives them beside each limit), at the cell's own sizes, in one process:

    python3 benchmark/tools/readings.py --workload crown_eval --seeds 1 2 3 \
        --control_seeds 4 5 6 [--faults half answer] [--fault_seeds 7 8 9] \
        [--out readings.jsonl]

  - the program: the numbers that a run compares (harness/checks.py), on
    the inputs of each seed, through the timed path (sweep_counts);
  - the control: the configuration's reference in fp8 put in the
    program's place, against the f32 reference;
  - faults planted in the program (tools/faults.py): 'half', 'answer'.

It takes the batches a window of one pass over the SNR grid would
run and samples them as a run does. One card; it never runs in the
benchmark's own runs.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.harness import host  # noqa: E402

host.fix_environment()

import torch  # noqa: E402

from benchmark.harness import checks  # noqa: E402
from benchmark.harness.evaluation import EvalCell  # noqa: E402
from benchmark.harness.main import load_cell  # noqa: E402
from benchmark.harness.tracing import Spans  # noqa: E402
from benchmark.reference.common import no_tf32  # noqa: E402
from benchmark.tools.faults import plant  # noqa: E402


def program_counts(cell: EvalCell, units):
    """The program's counts of `units`, through the timed call."""
    out = []
    for u in units:
        be, ke, pe = cell.counts(*cell.draw(u))
        out.append((int(be), int(ke), pe.cpu()))
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='*', default=[])
    p.add_argument('--control_seeds', type=int, nargs='*', default=[])
    p.add_argument('--faults', nargs='*', default=[])
    p.add_argument('--fault_seeds', type=int, nargs='*', default=None,
                   help='the faults\' seeds (default: the control\'s)')
    p.add_argument('--out', default=None)
    args = p.parse_args()
    no_tf32()
    fault_seeds = args.control_seeds if args.fault_seeds is None else args.fault_seeds
    spec = load_cell(args.workload)
    dev = torch.device('cuda', 0)
    host.log(f'device: {torch.cuda.get_device_name(dev)}; {host.nvidia_smi()}')
    out = open(args.out, 'a') if args.out else None

    def emit(kind, seed, numbers, seconds):
        line = {'workload': args.workload, 'kind': kind, 'seed': seed, 'numbers': numbers,
                'seconds': seconds}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + '\n')
            out.flush()

    cell = EvalCell(spec['arch'], spec['traffic'], 0, dev, Spans())
    cell.setup()
    n_units = cell.per_point * len(cell.grid)
    for kind, seeds in (('program', args.seeds), ('control', args.control_seeds),
                        *((f'fault_{f}', fault_seeds) for f in args.faults)):
        for s in seeds:
            t0 = time.perf_counter()
            cell.seed = s
            units = cell._sample(n_units)
            ref = cell.reference_counts(units)
            if kind == 'control':
                prog = cell.reference_counts(units, 'fp8')
            else:
                remove = plant(kind[len('fault_'):] if kind != 'program' else 'none')
                prog = program_counts(cell, units)
                remove()
            emit(kind, s, checks.eval_numbers(prog, ref), time.perf_counter() - t0)
    if out:
        out.close()


if __name__ == '__main__':
    main()
