"""The benchmark's plain DeepTurbo reference (benchmark/reference/deepturbo.py)
against the port, on the CPU:

  - its RSC-757 turbo encoder equals the port's trellis encoder
    (models/deepturbo.py:turbo_enc_apply) bit for bit, the dropped tail
    included;
  - its dense decoder equals the port's DEC_LargeCNN (largecnn_apply) on a
    seeded init at a tiny width in f32; the port's bf16 path stays within a
    bf16 tolerance of it, and the fp8 control does not;
  - its loader reads artifacts/deepturbo.msgpack into the port's weights,
    and the two full-width forwards agree;
  - its FLOP count, 1,243,120,000 a block at the configuration's widths, is
    what torch's FlopCounterMode counts over the port's forward.
"""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import inputs
from benchmark.reference import deepturbo as ref
from benchmark.reference.common import no_tf32
from turboae_tpu_torch.models import decoders
from turboae_tpu_torch.models.channel_ae import forward_ae, init_ae, make_perms
from turboae_tpu_torch.models.deepturbo import turbo_enc_apply
from turboae_tpu_torch.train.checkpoint import load_checkpoint

from _torch_parity import ROOT

DEEPTURBO = os.path.join(ROOT, 'artifacts', 'deepturbo.msgpack')
ARCH = json.loads((Path(ROOT) / 'benchmark' / 'configs' / 'deepturbo_757_k100.json').read_text())
TINY = dict(ARCH, block_len=20, dec_num_unit=16, num_iteration=2)
# The port's bf16 decoder against the f32 reference: max |logit difference|
# over max |logit|. bf16 keeps 8 significant bits (unit roundoff 2^-8), and
# the port rounds every conv and head operand to it, over 2 iterations of 5
# layers and a head, so the errors add up to a few units of 2^-8 (0.002 to
# 0.008 on seeds 0-5). 2^-6 leaves twice that; fp8 e4m3 (3 significant
# bits) reads 0.028 to 0.089 on the same seeds.
BF16_TOL = 2.0 ** -6


@pytest.fixture(autouse=True)
def _f32_exact():
    no_tf32()


def _logit(p):
    p = p.double()
    return torch.log(p) - torch.log1p(-p)


@pytest.mark.parametrize('L', [100, 23])
def test_encode_equals_the_ports_trellis(L):
    cfg = inputs.program_config(ARCH, block_len=L)
    bits = (torch.rand((32, L, 1), generator=torch.Generator().manual_seed(L)) < 0.5).float()
    port, _ = turbo_enc_apply({}, cfg, bits, make_perms(cfg, 'cpu'))
    mine = ref.encode({}, bits, ref.perms(L, 'cpu'), ARCH)
    assert mine.dtype == torch.float32 and mine.shape == (32, L, 3)
    assert torch.equal(mine, port)


def test_parity_is_the_rsc_757_recursion():
    # a single 1: the feedback register a runs 1 1 0 1 1 0 ..., the parity
    # a_t xor a_{t-2} 1 1 1 0 1 1 0 1 1 (the impulse response of 5/7 never
    # dies out: the code is recursive)
    u = torch.tensor([[1, 0, 0, 0, 0, 0, 0, 0, 0]])
    assert ref._rsc_parity(u).tolist() == [[1, 1, 1, 0, 1, 1, 0, 1, 1]]


def _decode_both(seed, dtype):
    cfg = inputs.program_config(TINY, dtype=dtype, batch_size=8)
    params = decoders.largecnn_init(torch.Generator().manual_seed(seed), cfg)
    received = torch.randn((8, TINY['block_len'], 3), generator=torch.Generator().manual_seed(
        seed + 10))
    pm = ref.perms(TINY['block_len'], 'cpu')
    with torch.no_grad():
        port = decoders.largecnn_apply(params, cfg, received, make_perms(cfg, 'cpu'))
        f32 = ref.decode({'dec': params}, received, pm, TINY)
        fp8 = ref.decode({'dec': params}, received, pm, TINY, 'fp8')
    return port, f32, fp8


def test_decode_equals_the_ports_f32():
    port, f32, _ = _decode_both(0, 'float32')
    assert port.dtype == torch.float32
    np.testing.assert_allclose(f32.numpy(), port.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_bf16_within_its_tolerance_and_the_fp8_control_beyond_it(seed):
    port, f32, fp8 = _decode_both(seed, 'bfloat16')
    scale = float(_logit(f32).abs().max())

    def gap(x):
        return float((_logit(x) - _logit(f32)).abs().max()) / scale
    assert gap(port) < BF16_TOL < gap(fp8)


def test_load_gives_the_ports_full_width_forward():
    cfg = inputs.program_config(ARCH, dtype='float32', batch_size=4)
    port = load_checkpoint(DEEPTURBO, init_ae(torch.Generator().manual_seed(0), cfg))
    mine = ref.load(DEEPTURBO, ARCH, 'cpu')
    assert mine['enc'] == port['enc'] == {}
    for a, b in zip(mine['dec']['iters'], port['dec']['iters']):
        assert a.keys() == b.keys()
        for k in ('dec1_cnn', 'dec2_cnn'):
            assert [tuple(p['w'].shape) for p in a[k]] == [(100, 7 + 100 * i, 5)
                                                           for i in range(5)]
            assert all(torch.equal(p['w'], q['w']) and torch.equal(p['b'], q['b'])
                       for p, q in zip(a[k], b[k]))
        for k in ('dec1_lin', 'dec2_lin'):
            assert torch.equal(a[k]['w'], b[k]['w']) and torch.equal(a[k]['b'], b[k]['b'])
    bits, noise = inputs.draw(torch.Generator(), 11, 0, 4, 100, 0.0, torch.device('cpu'))
    with torch.no_grad():
        want, _, _ = forward_ae(port, cfg, bits, noise, make_perms(cfg, 'cpu'),
                                training=False)
        got = ref.forward(mine, bits, noise, ref.perms(100, 'cpu'), ARCH)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    assert float((torch.round(got) != bits).float().mean()) < 0.05   # it decodes


def test_forward_flops():
    assert ref.forward_flops(ARCH, 100) == 1_243_120_000
    cfg = inputs.program_config(TINY, dtype='float32', batch_size=3)
    params = init_ae(torch.Generator().manual_seed(1), cfg)
    bits, noise = inputs.draw(torch.Generator(), 1, 0, 3, TINY['block_len'], 0.0,
                              torch.device('cpu'))
    with torch.no_grad(), FlopCounterMode(display=False) as mode:
        forward_ae(params, cfg, bits, noise, make_perms(cfg, 'cpu'), training=False)
    assert mode.get_total_flops() == 3 * ref.forward_flops(TINY, TINY['block_len'])
