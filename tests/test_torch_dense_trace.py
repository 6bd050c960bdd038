"""DeepTurbo's spans and counters on the evaluation path, on the CPU: the
dense stacks (ops/conv1d.py:dense_stack_apply, span `dense`, counters
`calls` and `copy_bytes`; through the dense kernel under use_fused_conv in
bf16, span `k3`, no bytes) and the trellis encoder (models/deepturbo.py,
span `trellis`). The crown's path calls neither. The file imports no JAX.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from turboae_tpu_torch.config import Config
from turboae_tpu_torch.models.channel_ae import init_ae, make_perms
from turboae_tpu_torch.ops import conv1d as cv
from turboae_tpu_torch.train.sweep import sweep_counts
from turboae_tpu_torch.utils import logging as tlog

TINY = dict(block_len=20, enc_num_unit=8, dec_num_unit=8, dec_num_layer=3, batch_size=4,
            dtype='bfloat16', use_fused_conv=True)


def _batch(cfg, seed=1):
    g = torch.Generator().manual_seed(seed)
    shape = (cfg.batch_size, cfg.block_len)
    return (torch.rand((*shape, 1), generator=g) < 0.5).float(), torch.randn((*shape, 3),
                                                                             generator=g)


def _traced(encoder, tmp_path, fused=True):
    cfg = Config(encoder=encoder, **dict(TINY, use_fused_conv=fused))
    params = init_ae(torch.Generator().manual_seed(0), cfg)
    with tlog.trace(str(tmp_path)):
        sweep_counts(params, cfg, *_batch(cfg), make_perms(cfg, 'cpu'))
    return tlog.spans()


def _children(sp, i, name=None):
    return [j for j, s in enumerate(sp) if s.parent == i and (name is None or s.name == name)]


@pytest.mark.parametrize('fused', [False, True])
def test_a_deepturbo_batch_is_one_tree(tmp_path, fused):
    """The same tree with use_fused_conv off and on; on, each `dense` span
    holds the dense kernel's wrapper span `k3` (kernels/conv_stack.py)."""
    sp = _traced('Turbo_rate3_757', tmp_path, fused)
    (root,) = [i for i, s in enumerate(sp) if s.parent < 0]
    assert sp[root].name == 'sweep'
    assert [sp[i].name for i in _children(sp, root)] == ['encode', 'channel', 'decode',
                                                         'counts']
    (enc,) = _children(sp, root, 'encode')
    assert [sp[i].name for i in _children(sp, enc)] == ['trellis']
    (dec,) = _children(sp, root, 'decode')
    iters = _children(sp, dec)
    assert [sp[i].name for i in iters] == ['decode.iter'] * 6
    assert [[sp[j].name for j in _children(sp, i)] for i in iters] == [['dense'] * 2] * 6
    assert sum(s.name == 'dense' for s in sp) == 12
    assert sum(s.name == 'trellis' for s in sp) == 1
    assert not any(s.name.startswith('k2') for s in sp)
    dense = [i for i, s in enumerate(sp) if s.name == 'dense']
    assert [[sp[j].name for j in _children(sp, i)] for i in dense] == \
        [['k3'] if fused else []] * 12
    for s in sp:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            assert sp[s.parent].start_ns <= s.start_ns and s.end_ns <= sp[s.parent].end_ns


def test_the_crowns_path_records_no_dense_or_trellis_span(tmp_path):
    names = {s.name for s in _traced('TurboAE_rate3_cnn', tmp_path)}
    assert 'decode.iter' in names and not names & {'dense', 'trellis'}


@pytest.mark.parametrize('dtype,itemsize', [(torch.bfloat16, 2), (torch.float32, 4)])
@pytest.mark.parametrize('num_layer', [1, 2, 5])
def test_copy_bytes_counts_the_running_concat(dtype, itemsize, num_layer):
    B, L, cin, c, k = 3, 11, 7, 6, 5
    layers = cv.dense_stack_init(torch.Generator().manual_seed(2), num_layer, cin, c, k)
    x = torch.randn((B, L, cin), generator=torch.Generator().manual_seed(3))
    calls, copied = cv.dense_stack_apply.calls, cv.dense_stack_apply.copy_bytes
    with profile(activities=[ProfilerActivity.CPU]):    # counted with or without spans
        out = cv.dense_stack_apply(layers, x, compute_dtype=dtype)
    cv.dense_stack_apply(layers, x, compute_dtype=dtype)
    assert out.shape == (B, L, c)
    assert cv.dense_stack_apply.calls - calls == 2
    want = B * L * itemsize * sum(cin + i * c for i in range(1, num_layer))
    assert cv.dense_stack_apply.copy_bytes - copied == 2 * want


@pytest.mark.parametrize('num_layer', [1, 2, 5])
def test_copy_bytes_is_zero_on_the_fused_route(num_layer):
    """A call through the dense kernel's entry writes no concatenation: one
    more call, no more bytes."""
    from turboae_tpu_torch.kernels.conv_stack import fused_dense_stack_apply_bf16
    B, L, cin, c, k = 3, 11, 7, 6, 5
    layers = cv.dense_stack_init(torch.Generator().manual_seed(2), num_layer, cin, c, k)
    x = torch.randn((B, L, cin), generator=torch.Generator().manual_seed(3))
    calls, copied = cv.dense_stack_apply.calls, cv.dense_stack_apply.copy_bytes
    out = cv.dense_stack_apply(layers, x, compute_dtype=torch.bfloat16,
                               fused=fused_dense_stack_apply_bf16)
    assert out.shape == (B, L, c) and out.dtype == torch.bfloat16
    assert cv.dense_stack_apply.calls - calls == 1
    assert cv.dense_stack_apply.copy_bytes == copied


def test_the_crowns_counters_stay_put():
    cfg = Config(encoder='TurboAE_rate3_cnn', **TINY)
    params = init_ae(torch.Generator().manual_seed(0), cfg)
    calls, copied = cv.dense_stack_apply.calls, cv.dense_stack_apply.copy_bytes
    sweep_counts(params, cfg, *_batch(cfg), make_perms(cfg, 'cpu'))
    assert (cv.dense_stack_apply.calls, cv.dense_stack_apply.copy_bytes) == (calls, copied)
