"""Each cell's run on the CPU at a small size (the look for a card skipped),
sound and with the timed path broken underneath: a sound run comes out
correct, and each fault the cell can have makes `correct` false against the
committed limits. Each run is one point, all of whose batches are checked."""
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import _tiny  # noqa: E402
from benchmark.tools.faults import plant  # noqa: E402


CELLS = {'none': lambda name, tmp: _tiny.sound_cell(name, tmp),
         'half': lambda name, tmp: _tiny.fault_cell(name, -1.5),
         'answer': lambda name, tmp: _tiny.fault_cell(name, 4.0)}


@pytest.mark.parametrize('name', ['crown_eval', 'k1000_eval'])
@pytest.mark.parametrize('fault', ['none', 'half', 'answer'])
def test_sweep_cell(name, fault, tmp_path):
    c = CELLS[fault](name, tmp_path)
    remove = plant(fault)
    try:
        rc, line = _tiny.run(c, seconds=0.0)
    finally:
        remove()
    assert rc == 0 and line['attempted'] == c['options']['check_batches']
    assert line['correct'] is (fault == 'none'), line['checks']
