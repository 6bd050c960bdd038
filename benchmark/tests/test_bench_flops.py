"""The frozen closed-form FLOPs against torch's FlopCounterMode over the
port's unfused forward at a tiny size, and K2's per-launch work."""
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _tiny  # noqa: E402
from benchmark.harness import inputs  # noqa: E402
from benchmark.harness import yardstick as Y  # noqa: E402
from turboae_tpu_torch.config import Config  # noqa: E402
from turboae_tpu_torch.models.channel_ae import forward_ae, init_ae, make_perms  # noqa: E402

CPU = torch.device('cpu')
B = 4


def _setup(**over):
    a = {**_tiny.M.load_cell('crown_eval')['arch'], **_tiny.NARROW, **over}
    kw = {k: v for k, v in a.items() if k in Config.__dataclass_fields__}
    cfg = Config(**dict(kw, dtype='float32', use_fused_conv=False, batch_size=B))
    return a, cfg


def _count(fn):
    with FlopCounterMode(display=False) as mode:
        fn()
    return mode.get_total_flops()


@pytest.mark.parametrize('over', [{}, {'num_iteration': 3, 'enc_num_layer': 3}])
def test_forward(over):
    a, cfg = _setup(**over)
    params = init_ae(torch.Generator().manual_seed(1), cfg)
    bits, noise = inputs.draw(torch.Generator(), 1, 0, B, a['block_len'], 0.0, CPU)
    with torch.no_grad():
        n = _count(lambda: forward_ae(params, cfg, bits, noise, make_perms(cfg, CPU),
                                      training=False))
    assert n == B * Y.forward_flops(a, a['block_len'])


def test_k2_bound_at_the_crowns_shape():
    flops, nbytes = Y.conv_stack_work(2000, 100, 7, 100, 5, 5)
    assert flops == 2 * 2000 * 100 * (5 * 7 * 100 + 4 * 5 * 100 * 100)
    bound = Y.bound_s(flops, nbytes, 'NVIDIA H100 80GB HBM3')
    assert abs(bound - flops / 989.4e12) < 1e-12           # compute-bound
    assert Y.bound_s(flops, nbytes, 'some other card') is None
