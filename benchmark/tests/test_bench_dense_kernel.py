"""The reader of dense_kernel_pct.eval on the CPU: the share of the dense
stacks that ran as one launch of the program's dense kernel, from the
program's counters, and None where the program has no launch counter (the
parent of the kernel) or made no dense call (the crown's path)."""
import sys
import types
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _tiny  # noqa: E402
from benchmark.harness.main import RunView, reader  # noqa: E402
from benchmark.harness.tracing import Spans  # noqa: E402

conv1d = pytest.importorskip('turboae_tpu_torch.ops.conv1d')
conv_stack = pytest.importorskip('turboae_tpu_torch.kernels.conv_stack')


def _view(name='deepturbo_eval'):
    c = _tiny.M.load_cell(name)
    cell = types.SimpleNamespace(arch=c['arch'], traffic=c['traffic'], spans=Spans())
    return RunView(cell, {'rest_units': 1, 'rest_seconds': 1.0}, None, 'NVIDIA H100 80GB HBM3', 1)


def test_every_dense_call_launched(monkeypatch):
    monkeypatch.setattr(conv1d.dense_stack_apply, 'calls', 24)
    monkeypatch.setattr(conv_stack.dense_stack_bf16, 'launches', 24)
    assert reader('dense_kernel_pct.eval')(_view()) == pytest.approx(100.0)
    monkeypatch.setattr(conv_stack.dense_stack_bf16, 'launches', 6)   # a quarter fused
    assert reader('dense_kernel_pct.eval')(_view()) == pytest.approx(25.0)


def test_none_without_the_launch_counter_or_a_dense_call(monkeypatch):
    monkeypatch.setattr(conv1d.dense_stack_apply, 'calls', 24)
    monkeypatch.delattr(conv_stack.dense_stack_bf16, 'launches')      # no such counter
    assert reader('dense_kernel_pct.eval')(_view()) is None
    monkeypatch.delattr(conv_stack, 'dense_stack_bf16')               # no such kernel
    assert reader('dense_kernel_pct.eval')(_view()) is None


def test_none_on_the_crowns_path(monkeypatch):
    monkeypatch.setattr(conv1d.dense_stack_apply, 'calls', 0)
    monkeypatch.setattr(conv_stack.dense_stack_bf16, 'launches', 0)
    assert reader('dense_kernel_pct.eval')(_view('crown_eval')) is None
