"""k2_pack_hit_pct.eval on hand-made spans, in the synthetic traced slice of
test_bench_program_trace.py: the share of outermost `k2.pack` spans with no
`k2.pack.weights` child."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchmark.harness.main import reader  # noqa: E402
from test_bench_program_trace import EVENTS, MS, _summary, _view  # noqa: E402

conv_stack = pytest.importorskip('turboae_tpu_torch.kernels.conv_stack')

METRIC = 'k2_pack_hit_pct.eval'


def _batch(n_packs, packed, batch=0, t0=0.0):
    """One `sweep` of n_packs `k2` calls, each a `k2.pack` then `k2.launch`;
    the packs numbered in `packed` hold a `k2.pack.weights` child. Indices
    start at 0: offset them to append."""
    ms = lambda a, b: (int((t0 + a) * MS), int((t0 + b) * MS))  # noqa: E731
    sp = [('sweep', *ms(0.0, 0.1 * n_packs + 0.05), -1, batch)]
    for i in range(n_packs):
        k2 = len(sp)
        a = 0.1 * i
        sp.append(('k2', *ms(a, a + 0.09), 0, batch))
        sp.append(('k2.pack', *ms(a + 0.01, a + 0.05), k2, batch))
        if i in packed:
            sp.append(('k2.pack.weights', *ms(a + 0.02, a + 0.04), k2 + 1, batch))
        sp.append(('k2.launch', *ms(a + 0.05, a + 0.08), k2, batch))
    return sp


def _read(spans, monkeypatch):
    return reader(METRIC)(_view(_summary(EVENTS), spans, monkeypatch))


@pytest.mark.parametrize('packed,want', [({3}, 100.0 * 11 / 12), (set(), 100.0),
                                         (set(range(12)), 0.0)],
                         ids=['one miss', 'all hits', 'all packed'])
def test_the_share_of_packs_that_packed_nothing(monkeypatch, packed, want):
    got = _read(_batch(12, packed), monkeypatch)
    assert got == pytest.approx(want)
    if packed == {3}:
        assert round(got, 2) == 91.67


def test_two_batches_count_every_pack_of_both(monkeypatch):
    # the second batch's spans follow the first's, their parents shifted
    first = _batch(2, {0})
    second = [(n, s, e, p + len(first) if p >= 0 else -1, 1)
              for n, s, e, p, _ in _batch(2, set(), t0=5.0)]
    assert _read(first + second, monkeypatch) == pytest.approx(75.0)


def test_none_without_sweep_spans_or_packs(monkeypatch):
    no_sweep = [(n, s, e, p - 1 if p > 0 else -1, b) for n, s, e, p, b in _batch(2, set())[1:]]
    assert _read(no_sweep, monkeypatch) is None
    assert _read([], monkeypatch) is None
    assert _read(_batch(0, set()), monkeypatch) is None


def test_none_for_a_program_without_the_cache(monkeypatch):
    # the parent of this metric: K2's wrapper has no pack_hits, and every
    # pack packs without a `k2.pack.weights` span
    monkeypatch.delattr(conv_stack.conv_stack_bf16, 'pack_hits')
    assert _read(_batch(12, set()), monkeypatch) is None
