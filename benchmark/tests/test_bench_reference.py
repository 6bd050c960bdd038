"""The plain reference against the port's CPU path at tiny sizes: the same
checkpoint read by both, the same forward."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _tiny  # noqa: E402
from benchmark.harness import inputs  # noqa: E402
from benchmark.reference import turboae_cnn as ref  # noqa: E402
from turboae_tpu_torch.cli.eval_flagship import load_flagship  # noqa: E402
from turboae_tpu_torch.config import Config  # noqa: E402
from turboae_tpu_torch.models.channel_ae import forward_ae, make_perms  # noqa: E402

CPU = torch.device('cpu')


def _arch(**over):
    return {**_tiny.M.load_cell('crown_eval')['arch'], **_tiny.NARROW, **over}


def _cfg(a, **over):
    kw = {k: v for k, v in a.items() if k in Config.__dataclass_fields__}
    kw.update(dtype='float32', **over)
    return Config(**kw)


@pytest.mark.parametrize('ckpt', ['artifacts/flagship.msgpack', 'tiny'])
def test_checkpoint_read_alike(ckpt, tmp_path):
    a = _arch(block_len=100, enc_num_unit=100, dec_num_unit=100, dec_num_layer=5,
              num_iteration=6) if ckpt != 'tiny' else _arch()
    path = _tiny.ROOT / ckpt if ckpt != 'tiny' else tmp_path / 't.msgpack'
    if ckpt == 'tiny':
        _tiny.write_checkpoint(path, a)
    mine = ref.leaves_of(ref.load(str(path), a, CPU), a)
    port = ref.leaves_of(load_flagship(str(path), CPU), a)
    assert len(mine) == len(port) == len(ref.param_specs(a))
    for x, y in zip(mine, port):
        assert torch.equal(x, y)


def test_perms_equal_the_ports():
    a = _arch(block_len=100)
    mine = ref.perms(100, CPU)
    port = make_perms(_cfg(a), CPU)
    assert torch.equal(mine['p1'], port['p1']) and torch.equal(mine['p1_inv'], port['p1_inv'])


def test_forward_equals_the_ports_f32(tmp_path):
    a = _arch()
    params = _tiny.write_checkpoint(tmp_path / 't.msgpack', a)
    gen = torch.Generator()
    bits, noise = inputs.draw(gen, 5, 0, 32, a['block_len'], -1.0, CPU)
    with torch.no_grad():
        port, _, _ = forward_ae(params, _cfg(a), bits, noise, make_perms(_cfg(a), CPU),
                                training=False)
        mine = ref.forward(params, bits, noise, ref.perms(a['block_len'], CPU), a)
    np.testing.assert_allclose(mine.numpy(), port.numpy(), rtol=0, atol=2e-6)


def test_fp8_control_departs(tmp_path):
    a = _arch()
    params = _tiny.write_checkpoint(tmp_path / 't.msgpack', a, seed=1)
    bits, noise = inputs.draw(torch.Generator(), 5, 0, 32, a['block_len'], -1.0, CPU)
    pm = ref.perms(a['block_len'], CPU)
    with torch.no_grad():
        f32 = ref.forward(params, bits, noise, pm, a)
        fp8 = ref.forward(params, bits, noise, pm, a, 'fp8')
    assert 1e-4 < float((f32 - fp8).abs().max()) < 0.5
