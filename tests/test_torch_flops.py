"""The port's FLOP and param counts (utils/flops.py, cli/compute_flop.py)
against the JAX package's utils/flops.py on the CPU.

  - the closed form is integer arithmetic on the config: equal;
  - param counts of the same config: equal;
  - FlopCounterMode counts the matmuls and convolutions of a forward, which
    the closed form approximates (it leaves out nothing but elementwise
    work): within 5 %.
"""
import jax
import numpy as np
import pytest
import torch

from turboae_tpu.models.channel_ae import init_ae as j_init_ae
from turboae_tpu.utils.flops import analytic_flops as j_analytic_flops
from turboae_tpu.utils.flops import count_params as j_count_params
from turboae_tpu_torch.cli import compute_flop
from turboae_tpu_torch.models.channel_ae import forward_ae, init_ae, make_perms
from turboae_tpu_torch.utils import flops

from _torch_parity import SMALL, configs

NARROW = dict(enc_num_unit=12, dec_num_unit=16, num_iteration=2, dec_num_layer=3)


@pytest.mark.parametrize('kw', [{}, NARROW, dict(block_len=1000), dict(num_iter_ft=3)],
                         ids=['flagship', 'narrow', 'k1000', 'iter_ft3'])
@pytest.mark.parametrize('batch', [1, 500])
def test_analytic_flops_equal_jax(kw, batch):
    jcfg, tcfg = configs(**kw)
    assert flops.analytic_flops(tcfg, batch) == j_analytic_flops(jcfg, batch)


@pytest.mark.parametrize('kw', [{}, SMALL], ids=['flagship', 'small'])
def test_count_params_equals_jax(kw):
    jcfg, tcfg = configs(**kw)
    ref = j_count_params(j_init_ae(jax.random.PRNGKey(0), jcfg))
    got = flops.count_params(init_ae(torch.Generator().manual_seed(0), tcfg))
    assert got == ref and got > 0


@pytest.mark.parametrize('batch', [1, 4])
def test_counted_forward_flops_within_5_percent_of_the_closed_form(batch):
    _, tcfg = configs(**NARROW, block_len=40)
    params = init_ae(torch.Generator().manual_seed(0), tcfg)
    rng = np.random.RandomState(0)
    bits = torch.from_numpy((rng.random_sample((batch, 40, 1)) < 0.5).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((batch, 40, 3)).astype(np.float32))
    counted = flops.counted_flops(forward_ae, params, tcfg, bits, noise, make_perms(tcfg, 'cpu'),
                                  training=False)
    ref = flops.analytic_flops(tcfg, batch)['total_flops']
    assert abs(counted - ref) <= 0.05 * ref


def test_counted_flops_see_the_backward():
    """A step's count holds the backward's products too: more than twice
    the forward's."""
    w = torch.randn(8, 8, requires_grad=True)
    x = torch.randn(4, 8)
    fwd = flops.counted_flops(lambda: x @ w)
    both = flops.counted_flops(lambda: (x @ w).sum().backward())
    assert fwd == 2 * 4 * 8 * 8 and both == 2 * fwd


def test_peaks_know_the_h100_and_nothing_else():
    assert flops.peak('NVIDIA H100 80GB HBM3', 'bfloat16') == 989.4e12
    assert flops.peak('NVIDIA H100 80GB HBM3', 'float32') == 66.9e12
    assert flops.peak('Some Other GPU', 'bfloat16') is None
    assert flops.peak('NVIDIA H100 80GB HBM3', 'int4') is None


def test_compute_flop_cli_on_cpu(capsys):
    out = compute_flop.main(['--device', 'cpu', '-enc_num_unit', '12', '-dec_num_unit', '12',
                             '-num_iteration', '2', '-block_len', '20'])
    printed = capsys.readouterr().out
    assert 'counted fwd FLOPs/block' in printed and 'encoder params' in printed
    assert abs(out['counted'] - out['total_flops']) <= 0.05 * out['total_flops']
    jcfg, _ = configs(enc_num_unit=12, dec_num_unit=12, num_iteration=2, block_len=20)
    assert out['enc_params'] == j_count_params(j_init_ae(jax.random.PRNGKey(0), jcfg)['enc'])
