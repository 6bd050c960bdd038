"""The control at a size a test run holds: the plain reference computed in
fp8 (the precision below the configurations' bf16), put in the program's
place, comes out not correct against each cell's committed limits, on
three seeds. The cells keep their widths and checkpoints and shrink the
batch. (At the cells' own sizes on the card: tools/readings.py; PERF.md
gives those readings.)"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _tiny  # noqa: E402
from benchmark.harness import checks  # noqa: E402
from benchmark.harness.evaluation import EvalCell  # noqa: E402
from benchmark.harness.tracing import Spans  # noqa: E402

CPU = torch.device('cpu')
SEEDS = [3000000041, 3000000042, 3000000043]


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('name, batch', [('crown_eval', 100), ('k1000_eval', 10)])
def test_sweep_control_fails(name, batch, seed):
    c = _tiny.M.load_cell(name)
    c['traffic'].update(batch_size=batch, blocks_per_point=batch)
    cell = EvalCell(c['arch'], c['traffic'], seed, CPU, Spans(), check_batches=1)
    units = cell._sample(len(cell.grid) * cell.per_point)
    numbers = checks.eval_numbers(cell.reference_counts(units, 'fp8'),
                                  cell.reference_counts(units))
    assert not checks.judge(numbers, c['limits'])['correct'], numbers
