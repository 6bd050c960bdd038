"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: configs built from one set of fields on both sides, and params made
once by the JAX package's init and converted for the port."""
import os

import jax
import numpy as np
import torch

from turboae_tpu.config import Config as JaxConfig
from turboae_tpu.models.channel_ae import init_ae
from turboae_tpu_torch.config import Config as PortConfig
from turboae_tpu_torch.train.convert import from_jax

# The suite runs in several pytest-xdist workers on a few cores. PyTorch's
# default of one intra-op thread per core in each worker oversubscribes the
# CPU, and the spinning threads slow every worker several-fold; the tests'
# shapes are small, so one thread per worker is enough.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROWN = os.path.join(ROOT, 'artifacts', 'flagship.msgpack')
CROWN_EVAL = os.path.join(ROOT, 'artifacts', 'eval_crown_r4.json')

# a small flagship config for the parity tests
SMALL = dict(enc_num_unit=12, dec_num_unit=12, enc_num_layer=2, dec_num_layer=3,
             num_iteration=2, block_len=24)


def configs(**kw):
    return JaxConfig(**kw), PortConfig(**kw)


def small_params(jcfg, seed=0):
    """(jax params as numpy, port params on the CPU) from one JAX init."""
    jp = jax.tree.map(np.asarray, init_ae(jax.random.PRNGKey(seed), jcfg))
    return jp, from_jax(jp, 'cpu')


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def rel_err(got, ref):
    """max |got - ref| / max |ref|, the Pallas kernel tests' bf16 measure."""
    got, ref = to_np(got), to_np(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def bits_noise(rng, B, L, sigma=1.0):
    bits = (rng.random_sample((B, L, 1)) < 0.5).astype(np.float32)
    noise = (sigma * rng.standard_normal((B, L, 3))).astype(np.float32)
    return bits, noise


def eval_point(ckpt, ref, snr, num_block, *flags):
    """One SNR point of a committed checkpoint through the port's eval CLI on
    the CPU (bf16, the fused decoder's plain version), with the BLER z
    statistic against the committed curve `ref` (artifacts/<ref>.json)."""
    from turboae_tpu_torch.cli import eval_flagship
    args = eval_flagship.parse([
        '--ckpt', os.path.join(ROOT, 'artifacts', ckpt), '--device', 'cpu',
        '--num_block', str(num_block), '--batch_size', str(min(num_block, 500)),
        '--snr_points', '1', '--snr_test_start', str(snr), '--snr_test_end', str(snr),
        '--ref', os.path.join(ROOT, 'artifacts', ref), *flags])
    return eval_flagship.evaluate(args)
