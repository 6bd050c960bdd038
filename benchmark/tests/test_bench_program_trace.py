"""The readers of the program's own spans (metrics/_program.py) on a
synthetic traced slice: device events summarised by the harness's Slice,
and recorder spans in the form turboae_tpu_torch/utils/logging.py:spans
gives them, both on one clock."""
import sys
import types
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _tiny  # noqa: E402
from benchmark.harness.main import RunView, reader  # noqa: E402
from benchmark.harness.tracing import Slice, Spans  # noqa: E402
from benchmark.metrics import _program  # noqa: E402

program_log = pytest.importorskip('turboae_tpu_torch.utils.logging')

MS = 1_000_000
READERS = ('k2_host_ms.eval', 'host_wait_ms.eval', 'wait_idle_pct.eval',
           'device_ops_per_batch.eval')


class _Ev:
    def __init__(self, name, start, dur, kind='DeviceType.CUDA'):
        self._n, self._s, self._d, self._k = name, start, dur, kind

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._k


def _summary(events):
    """The harness's summary of a 10 ms slice holding `events` (name, start,
    end in ns), the profiler's clock on time.time_ns()'s."""
    sl = Slice(Spans(), None)
    sl.sync_host, sl.t0, sl.t1 = 0, 0, 10 * MS
    sl.timeline = []
    evs = [_Ev('cudaDeviceSynchronize', 0, 5, 'DeviceType.CPU')]
    evs += [_Ev(n, s, e - s) for n, s, e in events]
    sl.prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))
    return sl.summary()


def _ms(a, b):
    return int(a * MS), int(b * MS)


# Two batches. (name, start, end, parent index, batch), in opening order.
SPANS = [
    ('sweep', *_ms(0.0, 4.0), -1, 0),          # 0
    ('encode', *_ms(0.1, 0.5), 0, 0),          # 1
    ('decode', *_ms(0.5, 3.5), 0, 0),          # 2
    ('decode.iter', *_ms(0.6, 3.4), 2, 0),     # 3
    ('k2', *_ms(0.7, 2.0), 3, 0),              # 4: outermost, 1.3 ms
    ('k2.window', *_ms(0.75, 1.95), 4, 0),     # 5
    ('wait', *_ms(0.8, 1.0), 5, 0),            # 6
    ('wait', *_ms(1.0, 1.2), 5, 0),            # 7
    ('k2', *_ms(1.3, 1.9), 5, 0),              # 8: nested, not counted again
    ('k2.pack', *_ms(1.35, 1.6), 8, 0),        # 9
    ('k2.launch', *_ms(1.6, 1.8), 8, 0),       # 10
    ('counts', *_ms(3.6, 3.9), 0, 0),          # 11
    ('sweep', *_ms(5.0, 9.0), -1, 1),          # 12
    ('decode', *_ms(5.1, 8.9), 12, 1),         # 13
    ('k2', *_ms(5.2, 6.2), 13, 1),             # 14: outermost, 1.0 ms
    ('k2.pack', *_ms(5.3, 5.8), 14, 1),        # 15
    ('k2.launch', *_ms(5.8, 6.0), 14, 1),      # 16
]

# Device events; the gaps between them: [0.9, 1.3) ms opens inside a wait,
# [4.2, 4.8) between the batches (the harness), [5.4, 5.7) inside k2.pack.
# The slice's edges, [0, 0.2) and [9.5, 10), lie outside the first and last
# event.
EVENTS = [('k', *_ms(0.2, 0.9)), ('k', *_ms(1.3, 2.5)), ('copy', *_ms(2.5, 4.2)),
          ('k', *_ms(4.8, 5.4)), ('k', *_ms(5.7, 9.5))]


def _view(summary, spans, monkeypatch):
    monkeypatch.setattr(program_log, 'spans', lambda: list(spans))
    c = _tiny.M.load_cell('crown_eval')
    cell = types.SimpleNamespace(arch=c['arch'], traffic=c['traffic'], spans=Spans())
    return RunView(cell, {'rest_units': 1, 'rest_seconds': 1.0}, summary,
                   'NVIDIA H100 80GB HBM3', 1)


def test_the_four_metrics_on_a_known_trace(monkeypatch):
    v = _view(_summary(EVENTS), SPANS, monkeypatch)
    assert reader('k2_host_ms.eval')(v) == pytest.approx((1.3 + 1.0) / 2)
    assert reader('host_wait_ms.eval')(v) == pytest.approx((0.2 + 0.2) / 2)
    assert reader('wait_idle_pct.eval')(v) == pytest.approx(100.0 * 0.4 / 10)
    assert reader('device_ops_per_batch.eval')(v) == pytest.approx(5 / 2)
    # device_idle_pct.eval also holds the slice's edges: 2.0 ms of 10
    assert reader('device_idle_pct.eval')(v) == pytest.approx(20.0)
    assert reader('wait_idle_pct.eval')(v) <= reader('device_idle_pct.eval')(v)


def test_gaps_are_named_by_the_innermost_span_at_their_start(monkeypatch):
    v = _view(_summary(EVENTS), SPANS, monkeypatch)
    assert _program.idle_by_span(v) == {'wait': pytest.approx(0.0004),
                                        'harness': pytest.approx(0.0006),
                                        'k2.pack': pytest.approx(0.0003)}


def test_a_gap_inside_k2_pack_is_no_wait(monkeypatch):
    # the same trace with the wait's gap closed: only k2.pack's gap is left
    # inside a batch, and wait_idle_pct.eval reads 0
    events = [('k', *_ms(0.2, 2.5))] + EVENTS[2:]
    v = _view(_summary(events), SPANS, monkeypatch)
    assert 'wait' not in _program.idle_by_span(v)
    assert _program.idle_by_span(v)['k2.pack'] == pytest.approx(0.0003)
    assert reader('wait_idle_pct.eval')(v) == 0.0
    # and a gap that opens inside k2.launch, k2.pack's sibling, is no wait either
    events = [('k', *_ms(0.2, 1.7)), ('k', *_ms(1.75, 9.5))]
    v = _view(_summary(events), SPANS, monkeypatch)
    assert _program.idle_by_span(v) == {'k2.launch': pytest.approx(0.00005)}
    assert reader('wait_idle_pct.eval')(v) == 0.0


def test_outermost_counts_a_nested_k2_once():
    assert [s[1] for s in _program.outermost(SPANS, 'k2')] == [int(0.7 * MS), int(5.2 * MS)]
    assert len(_program.outermost(SPANS, 'wait')) == 2


@pytest.mark.parametrize('spans', [[], [s for s in SPANS[4:11]]],
                         ids=['no spans', 'spans but no sweep'])
def test_every_reader_returns_none_without_sweep_spans(monkeypatch, spans):
    if spans:   # a k2 tree with no sweep above it: its own root
        spans = [(n, s, e, p - 4 if p >= 4 else -1, 0) for n, s, e, p, _ in spans]
    v = _view(_summary(EVENTS), spans, monkeypatch)
    for name in READERS:
        assert reader(name)(v) is None, name


def test_every_reader_returns_none_without_the_recorder(monkeypatch):
    # the parent of this change: a program whose logging module has no spans()
    v = _view(_summary(EVENTS), SPANS, monkeypatch)
    monkeypatch.delattr(program_log, 'spans')
    for name in READERS:
        assert reader(name)(v) is None, name


def test_every_reader_returns_none_without_a_trace(monkeypatch):
    v = _view(None, SPANS, monkeypatch)
    for name in READERS:
        assert reader(name)(v) is None, name
