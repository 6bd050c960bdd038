"""The host's spans (utils/logging.py:span) on the evaluation path: off
without a profiler session, the sweep's tree under one, on the clock of
the profiler's events, and written by trace().

The last test needs an NVIDIA GPU (the `gpu` marker): K2's spans under a
CUDA-only profiler, as the benchmark's traced slice runs it. The file
imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_trace.py
"""
import gc
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from turboae_tpu_torch.config import Config
from turboae_tpu_torch.kernels import conv_stack as ks
from turboae_tpu_torch.models.channel_ae import init_ae, make_perms
from turboae_tpu_torch.train.sweep import sweep_counts
from turboae_tpu_torch.utils import logging as tlog

SMALL = dict(block_len=24, enc_num_unit=12, dec_num_unit=12, dec_num_layer=2)


def _batch(cfg, device='cpu', seed=1):
    g = torch.Generator().manual_seed(seed)
    shape = (cfg.batch_size, cfg.block_len)
    bits = (torch.rand((*shape, 1), generator=g) < 0.5).float()
    noise = torch.randn((*shape, 3), generator=g)
    return bits.to(device), noise.to(device)


@pytest.fixture
def small():
    cfg = Config(batch_size=8, dtype='bfloat16', use_fused_conv=True, **SMALL)
    params = init_ae(torch.Generator().manual_seed(0), cfg)
    return cfg, params, make_perms(cfg, 'cpu'), _batch(cfg)


def _children(spans, i):
    return [s for s in spans if s.parent == i]


def test_no_profiler_no_spans(small):
    cfg, params, perms, (bits, noise) = small
    tlog.clear_spans()
    sweep_counts(params, cfg, bits, noise, perms)
    assert tlog.spans() == []


def test_a_sweep_batch_is_one_tree(small):
    cfg, params, perms, (bits, noise) = small
    want = sweep_counts(params, cfg, bits, noise, perms)
    tlog.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        got = sweep_counts(params, cfg, bits, noise, perms)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    sp = tlog.spans()
    (root,) = [i for i, s in enumerate(sp) if s.parent < 0]
    assert sp[root].name == 'sweep'
    assert [s.name for s in _children(sp, root)] == ['encode', 'channel', 'decode', 'counts']
    (dec,) = [i for i, s in enumerate(sp) if s.name == 'decode']
    iters = [i for i, s in enumerate(sp) if s.parent == dec]
    assert [sp[i].name for i in iters] == ['decode.iter'] * 6
    # two stacks an iteration through K2's wrapper (its plain version on the CPU)
    assert [len(_children(sp, i)) for i in iters] == [2] * 6
    assert {s.name for i in iters for s in _children(sp, i)} == {'k2'}
    assert {s.batch for s in sp} == {0}
    for s in sp:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = sp[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    # batch ids count the roots
    with profile(activities=[ProfilerActivity.CPU]):
        sweep_counts(params, cfg, bits, noise, perms)
    assert [s.batch for s in tlog.spans() if s.name == 'sweep'] == [0, 1]


def test_spans_share_the_profilers_clock(small):
    cfg, params, perms, (bits, noise) = small
    tlog.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sweep_counts(params, cfg, bits, noise, perms)
    sp = {s.name: s for s in tlog.spans() if s.name in ('sweep', 'counts')}
    aten = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.name().startswith('aten::')]
    assert aten
    for _, s, e in aten:        # every op was issued inside the sweep
        assert sp['sweep'].start_ns <= s and e <= sp['sweep'].end_ns
    rounds = [(s, e) for n, s, e in aten if n == 'aten::round']
    assert rounds               # the decisions, issued only by error_counts
    for s, e in rounds:
        assert sp['counts'].start_ns <= s and e <= sp['counts'].end_ns


def test_trace_writes_its_spans(small, tmp_path):
    cfg, params, perms, (bits, noise) = small
    with tlog.trace(str(tmp_path)):
        sweep_counts(params, cfg, bits, noise, perms)
    assert (tmp_path / 'trace.json').exists()
    rows = [json.loads(line) for line in (tmp_path / 'spans.jsonl').read_text().splitlines()]
    assert rows == [s._asdict() for s in tlog.spans()]
    assert rows[0]['name'] == 'sweep' and rows[0]['parent'] == -1
    assert sum(r['name'] == 'decode.iter' for r in rows) == 6
    assert set(rows[0]) == {'name', 'start_ns', 'end_ns', 'parent', 'batch'}


def test_clear_spans_refuses_while_a_span_is_open():
    tlog.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with tlog.span('outer'):
            with pytest.raises(RuntimeError):
                tlog.clear_spans()
            with tlog.span('inner'):
                pass
    assert [(s.name, s.parent) for s in tlog.spans()] == [('outer', -1), ('inner', 0)]


def test_recording_leaves_nothing_for_the_collector():
    # a span that left a container behind would set off the garbage
    # collector's passes, which cost the card's host ~1 ms a batch
    passes = []

    def count(phase, info):
        passes.append(phase)
    tlog.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        gc.collect()
        gc.callbacks.append(count)
        try:
            for _ in range(300):
                with tlog.span('sweep'):
                    for _ in range(46):
                        with tlog.span('k2'):
                            pass
        finally:
            gc.callbacks.remove(count)
    assert len(tlog.spans()) == 300 * 47 and passes == []


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('block_len,windows', [(100, 0), (1000, 12)])
def test_k2_spans_on_the_card(cuda_device, block_len, windows):
    """A batch of 2000 at full width under a CUDA-only profiler: 12
    outermost `k2` spans, each with its pack and launch; at L=1000 each
    windows (`k2.window`) around two `wait`s; K2's launches as without a
    profiler, and the same counts."""
    dev = cuda_device
    cfg = Config(batch_size=2000, block_len=block_len, dtype='bfloat16', use_fused_conv=True)
    params = init_ae(torch.Generator().manual_seed(0), cfg, dev)
    perms = make_perms(cfg, dev)
    bits, noise = _batch(cfg, dev)
    sweep_counts(params, cfg, bits, noise, perms)
    torch.cuda.synchronize()
    n0 = ks.conv_stack_bf16.launches
    want = [t.cpu() for t in sweep_counts(params, cfg, bits, noise, perms)]
    n1 = ks.conv_stack_bf16.launches
    tlog.clear_spans()
    with profile(activities=[ProfilerActivity.CUDA]):
        got = [t.cpu() for t in sweep_counts(params, cfg, bits, noise, perms)]
    n2 = ks.conv_stack_bf16.launches
    assert n1 - n0 == n2 - n1 == 12
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    sp = tlog.spans()
    names = [s.name for s in sp]
    outer = [s for s in sp if s.name == 'k2' and sp[s.parent].name == 'decode.iter']
    assert len(outer) == 12 and names.count('sweep') == 1
    assert names.count('k2.pack') == names.count('k2.launch') == 12
    assert names.count('k2.pack.weights') == 0      # packed by the first call
    assert names.count('k2.window') == windows
    assert names.count('k2') == 12 + windows
    assert names.count('wait') == 2 * windows
    for s in sp:
        if s.name == 'wait':
            assert sp[s.parent].name == 'k2.window'
