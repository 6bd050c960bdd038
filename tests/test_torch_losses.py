"""The port's loss menu (train/losses.py) against the JAX package's
customized_loss, on the CPU: each loss and its gradients with respect to
the decoder's output and the code, on the same numpy-drawn (output, bits,
code), saturated outputs included.

Tolerance: f32, 1e-6 relative on the loss and 1e-6 of the largest |gradient|
on the gradients (the reductions sum in another order). soft_ber does not
clip to [eps, 1 - eps]; its gradients are compared where the output lies
inside (0, 1). At an output the clip to [0, 1] holds at a bound, JAX's clip
splits the gradient in half between its branches and torch.clamp passes it
whole (both valid subgradients at a point of measure zero,
tests/test_torch_train.py, BCE), and beyond a bound JAX's gradient is NaN:
0 ** 0's derivative, where torch's pow gives 0. The port's is finite there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turboae_tpu.train.losses import customized_loss as j_loss
from turboae_tpu_torch.train.losses import customized_loss

from _torch_parity import configs

LOSSES = ['bce', 'soft_ber', 'bce_rl', 'enc_rl', 'bce_block', 'focal', 'mse', 'maxBCE',
          'sortBCE']
# lambdas and focal parameters away from their defaults, so each term counts
KNOBS = dict(ber_lambda=0.7, bce_lambda=1.3, focal_alpha=0.8, focal_gamma=2.0,
             lambda_maxBCE=0.05)


def _inputs(seed=0, B=6, L=24):
    rng = np.random.RandomState(seed)
    out = rng.uniform(0.0, 1.0, (B, L, 1)).astype(np.float32)
    # saturated outputs: beyond and just inside both eps clips, at and beyond
    # both bounds of [0, 1] (at an eps bound JAX splits the gradient too)
    sat = np.array([0.0, 1e-12, 5e-8, 2e-7, 1 - 3e-7, 1 - 6e-8, 1.0, 1.2, -0.1], np.float32)
    out[0, :sat.size, 0] = sat
    out[1, -sat.size:, 0] = sat[::-1]
    bits = (rng.random_sample((B, L, 1)) < 0.5).astype(np.float32)
    code = rng.standard_normal((B, L, 3)).astype(np.float32)
    return out, bits, code


def _both(name, out, bits, code, **kw):
    jcfg, tcfg = configs(loss=name, **kw)
    ref, (rg_o, rg_c) = jax.value_and_grad(
        lambda o, c: j_loss(o, jnp.asarray(bits), jcfg, code=c), argnums=(0, 1))(
            jnp.asarray(out), jnp.asarray(code))
    ot = torch.from_numpy(out).requires_grad_(True)
    ct = torch.from_numpy(code).requires_grad_(True)
    got = customized_loss(ot, torch.from_numpy(bits), tcfg, code=ct)
    g_o, g_c = torch.autograd.grad(got, (ot, ct), allow_unused=True, materialize_grads=True)
    return (got.item(), g_o.numpy(), g_c.numpy()), (float(ref), np.asarray(rg_o),
                                                    np.asarray(rg_c))


def _close(got, ref, rtol=1e-6):
    assert np.all(np.isfinite(got))
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= rtol * scale, (np.abs(got - ref).max(), scale)


@pytest.mark.parametrize('knobs', [{}, KNOBS], ids=['defaults', 'knobs'])
@pytest.mark.parametrize('name', LOSSES)
def test_loss_and_gradients_match_jax(name, knobs):
    out, bits, code = _inputs()
    (lt, gt_o, gt_c), (lj, gj_o, gj_c) = _both(name, out, bits, code, **knobs)
    assert np.isfinite(lt)
    np.testing.assert_allclose(lt, lj, rtol=1e-6)
    assert np.all(np.isfinite(gt_o))
    keep = (out > 0.0) & (out < 1.0) if name == 'soft_ber' else np.ones(out.shape, bool)
    _close(gt_o[keep], gj_o[keep])
    _close(gt_c, gj_c)
    if name == 'enc_rl':
        # the errors are detached: no gradient reaches the output, all of it the code
        assert not gt_o.any() and not gj_o.any() and np.abs(gt_c).max() > 0
    else:
        assert not gt_c.any() and not gj_c.any()


def test_sort_bce_takes_the_five_worst_positions():
    """sortBCE adds lambda times the sum of the 5 largest positional mean
    BCEs; with the positions' losses known, that sum is exact."""
    out, bits, code = _inputs(seed=1, B=4, L=16)
    _, tcfg = configs(loss='sortBCE', lambda_maxBCE=1.0)
    o, b = torch.from_numpy(out), torch.from_numpy(bits)
    bce = customized_loss(o, b, tcfg.replace(loss='bce'))
    from turboae_tpu_torch.train.losses import bce_elementwise
    pos = bce_elementwise(o.clamp(0, 1), b).mean(0).reshape(-1)
    want = bce + pos.sort(descending=True).values[:5].sum()
    assert torch.allclose(customized_loss(o, b, tcfg), want, rtol=1e-6)


def test_enc_rl_needs_the_code():
    _, tcfg = configs(loss='enc_rl')
    with pytest.raises(ValueError, match='code'):
        customized_loss(torch.full((1, 4, 1), 0.5), torch.ones((1, 4, 1)), tcfg)


def test_unknown_loss_raises_as_in_jax():
    jcfg, tcfg = configs(loss='hinge')
    o, b = np.full((1, 4, 1), 0.5, np.float32), np.ones((1, 4, 1), np.float32)
    with pytest.raises(ValueError, match='unknown loss'):
        j_loss(jnp.asarray(o), jnp.asarray(b), jcfg)
    with pytest.raises(ValueError, match='unknown loss'):
        customized_loss(torch.from_numpy(o), torch.from_numpy(b), tcfg)
