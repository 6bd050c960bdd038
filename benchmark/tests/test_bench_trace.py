"""The trace readers on a synthetic trace: the slice's summary (device
union, idle gaps named by host span, clock offset) and the per-layer
metrics that read it."""
import sys
import types
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _tiny  # noqa: E402
from benchmark.harness import yardstick as Y  # noqa: E402
from benchmark.harness.main import RunView, reader  # noqa: E402
from benchmark.harness.tracing import Slice, Spans  # noqa: E402

H100 = 'NVIDIA H100 80GB HBM3'
OFF = 1_000_000  # the profiler's clock ahead of time.time_ns() by 1 ms


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


def _slice(events, timeline):
    sl = Slice(Spans(), None)
    sl.sync_host, sl.t0, sl.t1 = 0, 0, 10_000_000          # a 10 ms window
    sl.timeline = timeline
    evs = [_Ev('cudaDeviceSynchronize', OFF, 5, 'DeviceType.CPU')]
    evs += [_Ev(n, OFF + s, d) for n, s, d in events]
    sl.prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))
    return sl.summary()


KERNELS = [
    ('void (anonymous namespace)::conv_stack_bf16_kernel<104, 5>(...)', 1_000_000, 2_000_000),
    ('void (anonymous namespace)::conv_stack_bf16_kernel<104, 5>(...)', 2_500_000, 2_000_000),
    ('void cudnn::engines_precompiled::nchwToNhwcKernel<...>', 2_000_000, 1_000_000),
    ('ncclDevKernel_AllReduce_Sum_f32_RING_LL(...)', 6_000_000, 1_000_000),
    ('Memcpy DtoH (Device -> Pinned)', 9_500_000, 1_000_000),    # clipped to 0.5 ms
]


def test_summary_union_gaps_and_names():
    s = _slice(KERNELS, [('sweep_counts', 0, 5_000_000), ('read_counts', 5_000_000, 9_000_000)])
    assert s['window_s'] == pytest.approx(0.010)
    # busy: [1, 4.5) + [6, 7) + [9.5, 10) ms
    assert s['busy_s'] == pytest.approx(0.005)
    # idle [0, 1), [4.5, 6), [7, 9.5) ms, each named by the span at its start
    assert s['idle_by_span'] == {'sweep_counts': pytest.approx(0.0025),
                                 'read_counts': pytest.approx(0.0025)}


def _view(name, summary, device=H100):
    c = _tiny.M.load_cell(name)
    cell = types.SimpleNamespace(arch=c['arch'], traffic=c['traffic'], spans=Spans())
    cell.spans.total, cell.spans.count = {'sweep_counts': 0.5}, {'sweep_counts': 100}
    w = {'rest_units': 100, 'rest_seconds': 1.0}
    return RunView(cell, w, summary, device, 1)


def test_metric_readers():
    s = _slice(KERNELS, [])
    v = _view('crown_eval', s)
    assert reader('device_idle_pct.eval')(v) == pytest.approx(50.0)
    assert reader('dispatch_ms.eval')(v) == pytest.approx(5.0)
    flops, nbytes = Y.conv_stack_work(2000, 100, 7, 100, 5, 5)
    k2 = reader('k2_roofline')(v)
    assert k2 == pytest.approx(100.0 * flops / 989.4e12 / 0.002)
    mfu = reader('mfu_pct.eval')(v)
    assert mfu == pytest.approx(100.0 * 100 * 2000 * Y.forward_flops(v.arch, 100) / 989.4e12)


def test_readers_find_nothing_to_read():
    s = _slice([], [])
    v = _view('crown_eval', s, device='a card not in the table')
    assert reader('k2_roofline')(v) is None
    assert reader('mfu_pct.eval')(v) is None
    assert reader('device_idle_pct.eval')(v) == pytest.approx(100.0)
