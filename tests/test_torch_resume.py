"""A resume of a committed run: one f32 decoder step from
artifacts/flagship_fading.msgpack's params and optax Adam state, at full
width, on the port against a JAX Trainer restored from the same file (CPU).

Both sides see the same bits, noise and fading gain: JAX's step draws them
from its key, and the test recomputes them from that key for the port
(JAX trainer.py:135-137, 109-126; channel_ae.py:64; apply.py:28-31).
Tolerances: the loss to 1e-4 relative (f32, summation order); the updated
params to 1e-5 of each leaf's largest. A resumed Adam update is
lr * mu_hat / (sqrt(nu_hat) + eps) with moments built over 37,500 steps, so
a gradient difference of 1e-4 relative moves it by far less than that.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from turboae_tpu.train.checkpoint import load_checkpoint
from turboae_tpu.train.trainer import Trainer as JaxTrainer
from turboae_tpu_torch.channels import apply as tapply
from turboae_tpu_torch.train.checkpoint import load_checkpoint as port_load
from turboae_tpu_torch.train.convert import to_jax
from turboae_tpu_torch.train.msgpack_io import load_msgpack
from turboae_tpu_torch.train.trainer import Trainer

from _torch_parity import ROOT, configs

FADING = os.path.join(ROOT, 'artifacts', 'flagship_fading.msgpack')


def test_adam_resume_step_matches_jax(monkeypatch):
    jcfg, tcfg = configs(batch_size=8, channel='fading')
    jt = JaxTrainer(jcfg)
    params, opt, step = load_checkpoint(FADING, jt.params, jt.opt_state)
    key = jax.random.PRNGKey(5)
    with jax.default_matmul_precision('highest'):
        new_params, new_opt, ref_loss = jt._train_step(params, opt, key, mode='decoder')
        # the step's own draws: bits and noise from k_data, the gain from k_chan
        k_data, k_fwd = jax.random.split(key)
        bits, noise = jt._sample_batch(k_data, 'decoder')
    k1, k2 = jax.random.split(jax.random.split(k_fwd)[0])
    shape = noise.shape
    gain = np.asarray(jnp.sqrt(jax.random.normal(k1, shape) ** 2 + jax.random.normal(k2, shape) ** 2)
                      / jnp.sqrt(3.14 / 2.0))
    monkeypatch.setattr(tapply, 'fading_gain', lambda shp, g, dev: torch.tensor(gain, device=dev))

    tr = Trainer(tcfg, 'cpu')
    tr.params, tr.opt_state, t_step = port_load(FADING, tr.params, tr.opt_state)
    file_counts = {h: int(load_msgpack(FADING)['opt_state'][h]['0']['count']) for h in ('enc', 'dec')}
    assert t_step == step == 150 and tr.opt['dec'].count == file_counts['dec']
    loss = tr._train_step('decoder', torch.tensor(np.asarray(bits)), torch.tensor(np.asarray(noise)))

    assert abs(loss.item() - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))
    assert tr.opt['dec'].count == file_counts['dec'] + 1 == int(new_opt['dec'][0].count)
    assert tr.opt['enc'].count == file_counts['enc']
    got = jax.tree.leaves(to_jax(tr.params)['dec'])
    ref = [np.asarray(t) for t in jax.tree.leaves(new_params['dec'])]
    before = [np.asarray(t) for t in jax.tree.leaves(params['dec'])]
    assert len(got) == len(ref) == 48
    moved = 0
    for g, r, b in zip(got, ref, before):
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max()
        moved += int(np.abs(r - b).max() > 0)
    assert moved == len(ref)                       # the step moved every leaf
