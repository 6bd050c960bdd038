"""The deepturbo_eval cell on the CPU: its configuration's FLOP count, its
run at a small size sound and with each fault planted, the fp8 control
against its committed limits, and the readers of the dense stacks' and the
trellis encoder's spans and counters on a synthetic traced slice, with the
cases in which each reads nothing."""
import sys
import types
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _tiny  # noqa: E402
from benchmark.harness import checks  # noqa: E402
from benchmark.harness import yardstick as Y  # noqa: E402
from benchmark.harness.evaluation import EvalCell  # noqa: E402
from benchmark.harness.main import RunView, reader  # noqa: E402
from benchmark.harness.tracing import Spans  # noqa: E402
from benchmark.metrics._dense import dense_stack_work  # noqa: E402
from benchmark.tools.faults import plant  # noqa: E402

program_log = pytest.importorskip('turboae_tpu_torch.utils.logging')
conv1d = pytest.importorskip('turboae_tpu_torch.ops.conv1d')

CELL = 'deepturbo_eval'
H100 = 'NVIDIA H100 80GB HBM3'
MS = 1_000_000
READERS = ('dense_host_ms.eval', 'trellis_host_ms.eval', 'dense_roofline')


def test_flops_and_the_dense_stacks_work():
    arch = _tiny.M.load_cell(CELL)['arch']
    assert arch['reference'] == 'deepturbo'
    assert Y.forward_flops(arch, arch['block_len']) == 1_243_120_000
    flops, nbytes = dense_stack_work(2000, 100, 7, 100, 5, 5)
    assert flops == 2 * 2000 * 100 * 5 * 100 * (7 + 107 + 207 + 307 + 407)
    assert nbytes == (2000 * 100 * 7 + 5 * 100 * 1035 + 2000 * 100 * 100) * 2 + 5 * 100 * 4
    assert 12 * Y.bound_s(flops, nbytes, H100) == pytest.approx(2.511e-3, rel=1e-3)


# --------------------------------------------------------------- the run
CELLS = {'none': lambda tmp: _tiny.sound_cell(CELL, tmp),
         'half': lambda tmp: _tiny.fault_cell(CELL, -1.5),
         'answer': lambda tmp: _tiny.fault_cell(CELL, 4.0)}


@pytest.mark.parametrize('fault', ['none', 'half', 'answer'])
def test_sweep_cell(fault, tmp_path):
    c = CELLS[fault](tmp_path)
    remove = plant(fault)
    try:
        rc, line = _tiny.run(c, seconds=0.0)
    finally:
        remove()
    assert rc == 0 and line['attempted'] == c['options']['check_batches']
    assert line['correct'] is (fault == 'none'), line['checks']


@pytest.mark.parametrize('seed', [3000000041, 3000000042, 3000000043])
def test_sweep_control_fails(seed):
    c = _tiny.M.load_cell(CELL)
    c['traffic'].update(batch_size=20, blocks_per_point=20)
    cell = EvalCell(c['arch'], c['traffic'], seed, torch.device('cpu'), Spans(),
                    check_batches=1)
    units = cell._sample(len(cell.grid) * cell.per_point)
    numbers = checks.eval_numbers(cell.reference_counts(units, 'fp8'),
                                  cell.reference_counts(units))
    assert not checks.judge(numbers, c['limits'])['correct'], numbers


# ----------------------------------------------------------- the readers
def _ms(a, b):
    return int(a * MS), int(b * MS)


# Two batches. (name, start, end, parent index, batch), in opening order.
SPANS = [
    ('sweep', *_ms(0.0, 4.0), -1, 0),          # 0
    ('encode', *_ms(0.1, 0.6), 0, 0),          # 1
    ('trellis', *_ms(0.15, 0.55), 1, 0),       # 2: 0.4 ms
    ('decode', *_ms(0.6, 3.5), 0, 0),          # 3
    ('decode.iter', *_ms(0.7, 3.4), 3, 0),     # 4
    ('dense', *_ms(0.8, 1.8), 4, 0),           # 5: 1.0 ms
    ('dense', *_ms(2.0, 3.2), 4, 0),           # 6: 1.2 ms
    ('sweep', *_ms(5.0, 9.0), -1, 1),          # 7
    ('encode', *_ms(5.1, 5.4), 7, 1),          # 8
    ('trellis', *_ms(5.1, 5.3), 8, 1),         # 9: 0.2 ms
    ('decode', *_ms(5.4, 8.9), 7, 1),          # 10
    ('decode.iter', *_ms(5.5, 8.8), 10, 1),    # 11
    ('dense', *_ms(5.6, 7.0), 11, 1),          # 12: 1.4 ms
]
# a 10 ms slice whose device was busy 6 ms: 3 ms a batch
TRACE = {'window_s': 0.010, 'busy_s': 0.006, 'events': [('k', *_ms(0.5, 3.5)),
                                                        ('k', *_ms(5.5, 8.5))]}


def _view(spans, monkeypatch, name=CELL, trace=TRACE, device=H100):
    monkeypatch.setattr(program_log, 'spans', lambda: list(spans))
    c = _tiny.M.load_cell(name)
    cell = types.SimpleNamespace(arch=c['arch'], traffic=c['traffic'], spans=Spans())
    return RunView(cell, {'rest_units': 1, 'rest_seconds': 1.0}, trace, device, 1)


def test_the_span_readers_on_a_known_trace(monkeypatch):
    v = _view(SPANS, monkeypatch)
    assert reader('dense_host_ms.eval')(v) == pytest.approx((1.0 + 1.2 + 1.4) / 2)
    assert reader('trellis_host_ms.eval')(v) == pytest.approx((0.4 + 0.2) / 2)
    stack = 2 * 2000 * 100 * 5 * 100 * 1035 / 989.4e12          # FLOP-bound
    assert reader('dense_roofline')(v) == pytest.approx(100.0 * 12 * stack / 0.003)


def test_the_roofline_reads_only_deepturbo_on_a_known_card(monkeypatch):
    assert reader('dense_roofline')(_view(SPANS, monkeypatch, name='crown_eval')) is None
    assert reader('dense_roofline')(_view(SPANS, monkeypatch, device='some card')) is None
    assert reader('dense_roofline')(_view(SPANS, monkeypatch,
                                          trace=dict(TRACE, busy_s=0.0))) is None


def _without(spans, names):
    """`spans` less those called one of `names`, each parent index moved to
    the nearest ancestor kept (-1 for none)."""
    keep = [i for i, s in enumerate(spans) if s[0] not in names]
    at = {old: new for new, old in enumerate(keep)}

    def up(p):
        while p >= 0 and p not in at:
            p = spans[p][3]
        return at.get(p, -1)
    return [(*spans[i][:3], up(spans[i][3]), spans[i][4]) for i in keep]


@pytest.mark.parametrize('spans', [[], _without(SPANS, {'sweep'}),
                                   _without(SPANS, {'dense', 'trellis'})],
                         ids=['no spans', 'spans but no sweep', 'the parent\'s spans'])
def test_the_span_readers_return_none_without_their_spans(monkeypatch, spans):
    v = _view(spans, monkeypatch)
    assert reader('dense_host_ms.eval')(v) is None
    assert reader('trellis_host_ms.eval')(v) is None
    if not any(s[0] == 'sweep' for s in spans):
        assert reader('dense_roofline')(v) is None


def test_every_reader_returns_none_without_the_recorder_or_a_trace(monkeypatch):
    v = _view(SPANS, monkeypatch, trace=None)
    for name in READERS:
        assert reader(name)(v) is None, name
    v = _view(SPANS, monkeypatch)
    monkeypatch.delattr(program_log, 'spans')
    for name in READERS:
        assert reader(name)(v) is None, name


def test_copy_mb_reads_the_counters(monkeypatch):
    v = _view(SPANS, monkeypatch)
    f = conv1d.dense_stack_apply
    monkeypatch.setattr(f, 'calls', 24)
    monkeypatch.setattr(f, 'copy_bytes', 24 * 411_200_000)
    assert reader('dense_copy_mb.eval')(v) == pytest.approx(411.2)
    monkeypatch.setattr(f, 'calls', 0)                  # the crown's path
    assert reader('dense_copy_mb.eval')(v) is None
    monkeypatch.delattr(f, 'calls')                     # the parent: no counters
    monkeypatch.delattr(f, 'copy_bytes')
    assert reader('dense_copy_mb.eval')(v) is None
