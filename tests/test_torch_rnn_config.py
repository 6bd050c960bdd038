"""TurboAE-RNN as the benchmark's configuration `turboae_rnn_k100` (cell
`rnn_eval`), on the CPU:

  - the benchmark's plain reference (benchmark/reference/turboae_rnn.py)
    against the port's forward_ae on the scan route, on a seeded init
    written with save_checkpoint and read back by the reference's own
    loader: the code after the power constraint and the decoder's outputs,
    equal in f32, within a bf16 tolerance in bf16, the fp8 control beyond it;
  - the committed checkpoint read by both, and their full-width forwards;
  - the reference's written-out GRU against torch.nn.GRU;
  - the `rnn`, `rnn.layer` and `decode.iter` spans of one forward and the
    counters of ops/gru.py:birnn_apply;
  - the cell's manifest entries, its FLOP count and the work of a biGRU
    stack (benchmark/metrics/_rnn.py);
  - the readers of the cell's new metrics, which read nothing in a run of
    another configuration or of a program without the spans and counters.
The file imports no JAX.
"""
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import inputs
from benchmark.harness import main as M
from benchmark.harness import yardstick as Y
from benchmark.harness.main import RunView, reader
from benchmark.harness.tracing import Spans
from benchmark.metrics._rnn import birnn_work
from benchmark.reference import turboae_rnn as ref
from benchmark.reference.common import no_tf32
from turboae_tpu_torch.models.channel_ae import forward_ae, init_ae, make_perms
from turboae_tpu_torch.ops import gru
from turboae_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from turboae_tpu_torch.train.sweep import sweep_counts
from turboae_tpu_torch.utils import logging as tlog

from _torch_parity import ROOT

CELL = 'rnn_eval'
H100 = 'NVIDIA H100 80GB HBM3'
ARCH = json.loads((Path(ROOT) / 'benchmark' / 'configs' / 'turboae_rnn_k100.json').read_text())
TINY = dict(ARCH, block_len=12, enc_num_unit=16, dec_num_unit=16, num_iteration=2)
# The port's bf16 path against the f32 reference, as a largest |difference|:
# of the code (whitened, so of unit spread), and of the decoder's logits
# over their largest |logit|. bf16 keeps 8 significant bits (unit roundoff
# 2^-8) and the port rounds every GRU and head operand to it, the hidden
# state each step included, over two GRU layers, a head and (the decoder)
# 2 iterations of two biGRUs: a few units of 2^-8 add up. On seeds 0-5 the
# code reads 0.0027 to 0.0197 and the logits 0.0028 to 0.0134; 2^-5 leaves
# 1.6 and 2.3 times that. The fp8 control (e4m3, 3 significant bits) reads
# 0.041 to 0.180 and 0.053 to 0.150 on the same seeds.
CODE_TOL = 2.0 ** -5
LOGIT_TOL = 2.0 ** -5


@pytest.fixture(autouse=True)
def _f32_exact():
    no_tf32()


def _logit(p):
    p = p.double()
    return torch.log(p) - torch.log1p(-p)


def _both(seed, dtype, tmp_path):
    """(port, f32 reference, fp8 control), each (code, outputs), on one batch
    of 8 blocks of a seeded init written as a checkpoint."""
    cfg = inputs.program_config(TINY, dtype=dtype, batch_size=8)
    params = init_ae(torch.Generator().manual_seed(seed), cfg)
    path = str(tmp_path / 'tiny.msgpack')
    save_checkpoint(path, params)
    mine = ref.load(path, TINY, 'cpu')
    bits, noise = inputs.draw(torch.Generator(), seed + 11, 0, 8, TINY['block_len'], 0.0,
                              torch.device('cpu'))
    pm = ref.perms(TINY['block_len'], 'cpu')
    out = {}
    with torch.no_grad():
        o, code, _ = forward_ae(params, cfg, bits, noise, make_perms(cfg, 'cpu'),
                                training=False)
        out['port'] = code, o
        for precision in ('f32', 'fp8'):
            c = ref.encode(mine, bits, pm, TINY, precision)
            out[precision] = c, ref.decode(mine, c + noise, pm, TINY, precision)
    return out


def test_the_reference_equals_the_ports_f32(tmp_path):
    got = _both(0, 'float32', tmp_path)
    (code, o), (rcode, ro) = got['port'], got['f32']
    assert code.shape == rcode.shape == (8, TINY['block_len'], 3)
    assert o.shape == ro.shape == (8, TINY['block_len'], 1)
    # the same products in the same order: 1e-5 is f32 rounding's room
    np.testing.assert_allclose(rcode.numpy(), code.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ro.numpy(), o.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_bf16_within_its_tolerance_and_the_fp8_control_beyond_it(seed, tmp_path):
    got = _both(seed, 'bfloat16', tmp_path)
    rcode, ro = got['f32']
    scale = float(_logit(ro).abs().max())

    def gaps(which):
        code, o = got[which]
        return (float((code - rcode).abs().max()),
                float((_logit(o) - _logit(ro)).abs().max()) / scale)
    (code_gap, logit_gap), (code_fp8, logit_fp8) = gaps('port'), gaps('fp8')
    assert code_gap < CODE_TOL < code_fp8
    assert logit_gap < LOGIT_TOL < logit_fp8


def test_load_gives_the_ports_full_width_forward():
    """The committed checkpoint, read by the reference's own loader and by
    the port's: the same weights, and the two f32 forwards at full width
    agree."""
    path = str(Path(ROOT) / ARCH['checkpoint'])
    cfg = inputs.program_config(ARCH, dtype='float32', batch_size=4)
    port = load_checkpoint(path, init_ae(torch.Generator().manual_seed(0), cfg))
    mine = ref.load(path, ARCH, 'cpu')
    for b in ('b1', 'b2', 'b3'):
        assert _same(mine['enc'][b], port['enc'][b])
    assert len(mine['dec']['iters']) == len(port['dec']['iters']) == 6
    for a, b in zip(mine['dec']['iters'], port['dec']['iters']):
        assert _same(a, b)
    assert tuple(mine['dec']['iters'][0]['dec1_rnn'][1]['bwd']['w_ih'].shape) == (300, 200)
    bits, noise = inputs.draw(torch.Generator(), 11, 0, 4, 100, 2.0, torch.device('cpu'))
    with torch.no_grad():
        want, _, _ = forward_ae(port, cfg, bits, noise, make_perms(cfg, 'cpu'),
                                training=False)
        got = ref.forward(mine, bits, noise, ref.perms(100, 'cpu'), ARCH)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    assert float((torch.round(got) != bits).float().mean()) < 0.1   # it decodes


def _same(a, b):
    """Two trees of the same keys and equal tensors."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)


def _to_reference(module: torch.nn.GRU):
    """torch.nn.GRU's weights as the reference's layers."""
    out = []
    for i in range(module.num_layers):
        layer = {}
        for d, suffix in (('fwd', ''), ('bwd', '_reverse')):
            layer[d] = {k: getattr(module, f'{name}_l{i}{suffix}').detach()
                        for k, name in (('w_ih', 'weight_ih'), ('w_hh', 'weight_hh'),
                                        ('b_ih', 'bias_ih'), ('b_hh', 'bias_hh'))}
        out.append(layer)
    return out


@pytest.mark.parametrize('n_in,H,L', [(7, 16, 12), (1, 10, 9)])
def test_the_written_out_gru_is_torchs(n_in, H, L):
    torch.manual_seed(5)
    module = torch.nn.GRU(n_in, H, num_layers=2, bidirectional=True, batch_first=True)
    x = torch.randn((6, L, n_in), generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        want = module(x)[0]
        got = ref.bigru(_to_reference(module), x)
    assert got.shape == want.shape == (6, L, 2 * H)
    # the same equations, the products summed in another order: f32 rounding
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


# -------------------------------------------------------------- spans
def _children(sp, i, name=None):
    return [j for j, s in enumerate(sp) if s.parent == i and (name is None or s.name == name)]


def test_a_batch_opens_its_rnn_spans_and_counts(tmp_path):
    cfg = inputs.program_config(dict(ARCH, block_len=10, enc_num_unit=6, dec_num_unit=6),
                                batch_size=4)
    assert cfg.num_iteration == 6 and cfg.enc_num_layer == 2
    params = init_ae(torch.Generator().manual_seed(0), cfg)
    bits, noise = inputs.draw(torch.Generator(), 1, 0, 4, 10, 0.0, torch.device('cpu'))
    f = gru.birnn_apply
    before = (f.calls, f.layers, f.pack_bytes, gru.ROUTE_CALLS['scan'])
    with tlog.trace(str(tmp_path)):
        sweep_counts(params, cfg, bits, noise, make_perms(cfg, 'cpu'))
    sp = tlog.spans()
    assert (f.calls - before[0], f.layers - before[1], f.pack_bytes - before[2],
            gru.ROUTE_CALLS['scan'] - before[3]) == (15, 30, 0, 30)
    rnn = [i for i, s in enumerate(sp) if s.name == 'rnn']
    assert len(rnn) == 15 and all(sp[sp[i].parent].name != 'rnn' for i in rnn)
    assert [[sp[j].name for j in _children(sp, i)] for i in rnn] == [['rnn.layer'] * 2] * 15
    assert sum(s.name == 'rnn.layer' for s in sp) == 30
    assert not any(s.name == 'rnn.pack' for s in sp)        # the scan packs nothing
    (root,) = [i for i, s in enumerate(sp) if s.parent < 0]
    (enc,) = _children(sp, root, 'encode')
    assert [sp[i].name for i in _children(sp, enc)] == ['rnn'] * 3
    (dec,) = _children(sp, root, 'decode')
    iters = _children(sp, dec)
    assert [sp[i].name for i in iters] == ['decode.iter'] * 6
    assert [[sp[j].name for j in _children(sp, i)] for i in iters] == [['rnn'] * 2] * 6
    for s in sp:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            assert sp[s.parent].start_ns <= s.start_ns and s.end_ns <= sp[s.parent].end_ns


def test_the_counters_count_without_a_profiler():
    layers = gru.bigru_init(torch.Generator().manual_seed(1), 3, 5, 3)
    x = torch.randn((2, 7, 3), generator=torch.Generator().manual_seed(2))
    f = gru.birnn_apply
    before = (f.calls, f.layers, f.pack_bytes)
    recorded = len(tlog.spans())
    out = gru.bigru_apply(layers, x)
    assert out.shape == (2, 7, 10) and len(tlog.spans()) == recorded
    assert (f.calls - before[0], f.layers - before[1], f.pack_bytes - before[2]) == (1, 3, 0)


# ------------------------------------------------- manifest and FLOPs
def test_the_cell_resolves():
    c = M.load_cell(CELL)
    assert c['chips'] == 1 and c['arch'] == ARCH
    assert c['arch']['reference'] == 'turboae_rnn'
    assert (Path(ROOT) / c['arch']['checkpoint']).is_file()
    assert c['traffic'] == json.loads(
        (Path(ROOT) / 'benchmark' / 'traffic' / 'sweep_awgn_b2000.json').read_text())
    assert set(c['limits']) == {'bit_l1', 'blk_l1', 'pos_l1'}
    per_layer = {m['name'] for m in c['per_layer']}
    assert {'rnn_host_ms.eval', 'rnn_pack_mb.eval', 'rnn_roofline', 'mfu_pct.eval',
            'device_idle_pct.eval', 'device_ops_per_batch.eval', 'dispatch_ms.eval'} \
        <= per_layer
    assert not per_layer & {'k2_roofline', 'dense_roofline', 'k2_host_ms.eval'}
    assert [m['name'] for m in c['end_to_end']] == ['eval_blocks_per_s', 'setup_s']
    bench = json.loads((Path(ROOT) / 'BENCHMARK.json').read_text())
    (conf,) = [x for x in bench['configs'] if x['name'] == 'turboae_rnn_k100']
    assert conf['reduced'] == []


def test_forward_flops():
    # a biGRU of 2 layers over 100 positions, 100 units: 2 directions x 100
    # x 2 (In 300 + 100 300), In = 7 then 200 (decoder) or 1 then 200
    dec = 2 * 100 * 2 * (7 * 300 + 100 * 300) + 2 * 100 * 2 * (200 * 300 + 100 * 300)
    enc = 2 * 100 * 2 * (1 * 300 + 100 * 300) + 2 * 100 * 2 * (200 * 300 + 100 * 300)
    heads = 2 * 100 * 200 * (3 * 1 + 11 * 5 + 1)
    assert (dec, enc) == (48_840_000, 48_120_000)
    assert ref.forward_flops(ARCH, 100) == 12 * dec + 3 * enc + heads == 732_800_000
    assert Y.forward_flops(ARCH, 100) == 732_800_000
    cfg = inputs.program_config(TINY, dtype='float32', batch_size=3)
    params = init_ae(torch.Generator().manual_seed(1), cfg)
    bits, noise = inputs.draw(torch.Generator(), 1, 0, 3, TINY['block_len'], 0.0,
                              torch.device('cpu'))
    with torch.no_grad(), FlopCounterMode(display=False) as mode:
        forward_ae(params, cfg, bits, noise, make_perms(cfg, 'cpu'), training=False)
    assert mode.get_total_flops() == 3 * ref.forward_flops(TINY, TINY['block_len'])


def test_the_work_of_a_bigru_stack():
    flops, nbytes = birnn_work(2000, 100, 7, 100, 2)
    assert flops == 2000 * 48_840_000
    w0, w1 = 2 * (300 * 7 + 300 * 100 + 600), 2 * (300 * 200 + 300 * 100 + 600)
    assert nbytes == 2 * (2000 * 100 * (7 + 200) + w0 + 2000 * 100 * (200 + 200) + w1)
    enc = birnn_work(2000, 100, 1, 100, 2)
    bound = 3 * Y.bound_s(*enc, H100) + 12 * Y.bound_s(flops, nbytes, H100)
    assert bound == pytest.approx(1.4765e-3, rel=1e-3)          # FLOP-bound


# ------------------------------------------------------------ readers
MS = 1_000_000


def _ms(a, b):
    return int(a * MS), int(b * MS)


# Two batches: (name, start, end, parent index, batch), in opening order.
SPANS = [
    ('sweep', *_ms(0.0, 10.0), -1, 0),        # 0
    ('encode', *_ms(0.1, 3.0), 0, 0),         # 1
    ('rnn', *_ms(0.2, 2.0), 1, 0),            # 2: 1.8 ms
    ('rnn.layer', *_ms(0.3, 1.0), 2, 0),      # 3
    ('rnn.pack', *_ms(0.3, 0.5), 3, 0),       # 4
    ('decode', *_ms(3.0, 9.0), 0, 0),         # 5
    ('decode.iter', *_ms(3.1, 8.9), 5, 0),    # 6
    ('rnn', *_ms(3.2, 5.2), 6, 0),            # 7: 2.0 ms
    ('sweep', *_ms(11.0, 20.0), -1, 1),       # 8
    ('decode', *_ms(11.5, 19.0), 8, 1),       # 9
    ('rnn', *_ms(12.0, 14.2), 9, 1),          # 10: 2.2 ms
]
# a 30 ms slice whose device was busy 16 ms: 8 ms a batch
TRACE = {'window_s': 0.030, 'busy_s': 0.016, 'events': [('k', *_ms(0.5, 8.5)),
                                                        ('k', *_ms(11.5, 19.5))]}
READERS = ('rnn_host_ms.eval', 'rnn_pack_mb.eval', 'rnn_roofline')


def _without_rnn(spans):
    """`spans` less the `rnn*` ones, each parent index moved to the nearest
    ancestor kept: a batch of the CNN cells' path, or of the parent."""
    keep = [i for i, s in enumerate(spans) if not s[0].startswith('rnn')]
    at = {old: new for new, old in enumerate(keep)}

    def up(p):
        while p >= 0 and p not in at:
            p = spans[p][3]
        return at.get(p, -1)
    return [(*spans[i][:3], up(spans[i][3]), spans[i][4]) for i in keep]


def _view(monkeypatch, spans=SPANS, name=CELL, trace=TRACE):
    monkeypatch.setattr(tlog, 'spans', lambda: list(spans))
    c = M.load_cell(name)
    cell = types.SimpleNamespace(arch=c['arch'], traffic=c['traffic'], spans=Spans())
    return RunView(cell, {'rest_units': 1, 'rest_seconds': 1.0}, trace, H100, 1)


def test_the_readers_on_a_known_trace(monkeypatch):
    v = _view(monkeypatch)
    assert reader('rnn_host_ms.eval')(v) == pytest.approx((1.8 + 2.0 + 2.2) / 2)
    assert reader('rnn_roofline')(v) == pytest.approx(100.0 * 1.4765e-3 / 0.008, rel=1e-3)
    monkeypatch.setattr(gru.birnn_apply, 'calls', 30)
    monkeypatch.setattr(gru.birnn_apply, 'pack_bytes', 30 * 493_200)
    assert reader('rnn_pack_mb.eval')(v) == pytest.approx(0.4932)


@pytest.mark.parametrize('name', ['crown_eval', 'k1000_eval', 'deepturbo_eval'])
def test_the_readers_read_nothing_in_another_configuration(monkeypatch, name):
    """Their spans and counters stay empty on the CNN cells' path, and the
    roofline reads only for the configuration of reference `turboae_rnn`."""
    v = _view(monkeypatch, _without_rnn(SPANS), name)
    monkeypatch.setattr(gru.birnn_apply, 'calls', 0)
    for r in READERS:
        assert reader(r)(v) is None, r
    assert reader('rnn_roofline')(_view(monkeypatch, SPANS, name)) is None


def test_the_readers_read_nothing_of_the_parent(monkeypatch):
    """A program without the spans (the parent's) or the counters, and a run
    without a trace."""
    v = _view(monkeypatch, _without_rnn(SPANS))
    assert reader('rnn_host_ms.eval')(v) is None
    monkeypatch.delattr(gru.birnn_apply, 'calls')
    monkeypatch.delattr(gru.birnn_apply, 'pack_bytes')
    assert reader('rnn_pack_mb.eval')(v) is None
    v = _view(monkeypatch, trace=None)
    assert reader('rnn_host_ms.eval')(v) is None and reader('rnn_roofline')(v) is None
