"""Channel noise (JAX: channels/noise.py:24-157): every channel of the
reference (channels.py:7-115).

Noise is drawn on the device from an explicit torch.Generator. The JAX
package draws from jax.random, so the two agree in distribution, not in value;
tests hand both sides the same draws instead.

`sample_noise` gives the forward-noise tensor of one channel at one sigma: the
noise sigma of the additive channels, or the erasure/flip/keep probability of
bec, bsc and ge. Channel *application* lives in channels/apply.py.

Training noise (`generate_noise` without `test_sigma`) has a per-element
sigma drawn uniformly in [sigma(snr_high), sigma(snr_low)]; the trainer
passes the encoder phase's or the decoder phase's SNR range. bec, bsc and ge
train at the static probabilities of the phase instead.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.metrics import snr_db2sigma

# the Gilbert-Elliott transition probabilities the reference always uses
# (channels.py:62-63, JAX noise.py:111,121)
GE_P_GG = 0.8
GE_P_BB = 0.8


class NoiseSpec(NamedTuple):
    """Static channel parameters."""
    channel: str = 'awgn'
    vv: float = 5.0
    radar_prob: float = 0.05
    radar_power: float = 5.0


def spec_from_cfg(cfg) -> NoiseSpec:
    return NoiseSpec(cfg.channel, cfg.vv, cfg.radar_prob, cfg.radar_power)


def train_sigma(shape, snr_low: float, snr_high: float, generator: torch.Generator,
                device) -> torch.Tensor:
    """Per-element uniform sigma in [sigma(snr_high), sigma(snr_low)]."""
    s_low = snr_db2sigma(snr_low)      # the larger sigma (lower SNR)
    s_high = snr_db2sigma(snr_high)
    u = torch.rand(shape, generator=generator, device=device)
    return (s_low - s_high) * u + s_high


def student_t(shape, df: float, generator: torch.Generator, device) -> torch.Tensor:
    """Variance-normalized Student-t, sqrt((v-2)/v) * t_v (JAX noise.py:44-47).

    t_v = z / sqrt(chi2_v / v) with chi2_v = 2 Gamma(v/2, 1); both draws take
    the generator (torch.distributions.StudentT.sample takes none)."""
    z = torch.randn(shape, generator=generator, device=device)
    alpha = torch.full(shape, df / 2.0, device=device)
    chi2 = 2.0 * torch._standard_gamma(alpha, generator=generator)
    return ((df - 2.0) / df) ** 0.5 * (z / torch.sqrt(chi2 / df))


def ge_states(stay: torch.Tensor, p_gg: float = GE_P_GG, p_bb: float = GE_P_BB) -> torch.Tensor:
    """The Gilbert-Elliott chain's good-state mask (B, L, C) from its
    transition uniforms `stay` (B, L, C) (JAX noise.py:50-76).

    The chain starts good and moves after each step: from good it stays good
    when stay < p_gg; from bad it RETURNS to good when stay < p_bb (the
    reference's executable semantics, channels.py:73,79). stay[:, -1] is
    never used. When p_gg == p_bb the next state does not depend on the
    current one, so good[t] = stay[t-1] < p for t > 0 with no loop over time."""
    good0 = torch.ones_like(stay[:, :1], dtype=torch.bool)
    if p_gg == p_bb:
        return torch.cat([good0, stay[:, :-1] < p_gg], dim=1)
    states = [good0[:, 0]]
    for t in range(stay.shape[1] - 1):
        states.append(stay[:, t] < torch.where(states[-1], p_gg, p_bb))
    return torch.stack(states, dim=1)


def _ge_chain(shape, emit_good, emit_bad, generator, device):
    """Emit emit_good in the good state and emit_bad in the bad one."""
    stay = torch.rand(shape, generator=generator, device=device)
    return torch.where(ge_states(stay), emit_good, emit_bad)


def sample_noise(shape, spec: NoiseSpec, sigma, generator: torch.Generator,
                 device) -> torch.Tensor:
    """The forward-noise tensor of spec.channel (JAX noise.py:79-128).

    sigma: a float or a tensor broadcast to `shape`."""
    ch = spec.channel

    def normal():
        return torch.randn(shape, generator=generator, device=device)

    def uniform():
        return torch.rand(shape, generator=generator, device=device)

    if ch == 't-dist':
        return sigma * student_t(shape, spec.vv, generator, device)
    if ch == 'radar':
        add_pos = (uniform() < spec.radar_prob).float()
        burst = spec.radar_power * normal() * add_pos
        return sigma * normal() + burst
    if ch in ('bec', 'bsc'):
        # keep mask: 1 with probability 1 - sigma (channels.py:48-54)
        return (uniform() >= sigma).float()
    if ch == 'ge_awgn':
        # good state sigma(SNR + 1 dB), bad state sigma(SNR - 1 dB) (channels.py:55-83)
        snr = -20.0 * torch.log10(torch.as_tensor(sigma, dtype=torch.float32, device=device))
        sig_good = torch.broadcast_to(10.0 ** (-(snr + 1.0) / 20.0), shape)
        sig_bad = torch.broadcast_to(10.0 ** (-(snr - 1.0) / 20.0), shape)
        return _ge_chain(shape, sig_good, sig_bad, generator, device) * normal()
    if ch == 'ge':
        # discrete GE: good keeps always, bad keeps with probability sigma
        # (channels.py:85-109)
        keep_bad = (uniform() < sigma).float()
        return _ge_chain(shape, torch.ones(shape, device=device), keep_bad, generator, device)
    # awgn; fading, whose noise is AWGN (its gain is drawn in apply.py); and,
    # as in the reference (channels.py:111-113), any unknown channel
    return sigma * normal()


def check_legacy_noise_channel(channel: str) -> None:
    """legacy_noise scales ONE unit realization by each point's sigma, which
    reproduces fresh-noise statistics only where the noise is purely
    multiplicative in sigma, awgn and t-dist (JAX train/trainer.py:41-51):
    mask channels would get fractional masks, and radar's bursts and
    ge_awgn's states would be scaled with sigma."""
    if channel not in ('awgn', 't-dist'):
        raise ValueError(
            f'legacy_noise is only defined for awgn/t-dist channels '
            f'(noise purely multiplicative in sigma), got {channel!r}')


def point_sigma(cfg, snr: float) -> float:
    """A test point's sigma: the raw probability for bec/bsc/ge, else
    sigma(snr dB) (JAX train/trainer.py:453-455, 571-574)."""
    return snr if cfg.channel in ('bec', 'bsc', 'ge') else snr_db2sigma(snr)


def generate_noise(shape, cfg, generator: torch.Generator, device,
                   test_sigma: Optional[float] = None, snr_low: float = 0.0,
                   snr_high: float = 0.0, mode: str = 'encoder') -> torch.Tensor:
    """Training noise (test_sigma None) or test noise (JAX noise.py:131-157).

    Training: a uniform sigma mixture over [snr_low, snr_high] dB, or for
    bec/bsc/ge the static probability of the phase (bec_p/bsc_p for the
    encoder, bec_p_dec/bsc_p_dec otherwise). Test: sigma(test_sigma dB), or
    for bec/bsc/ge test_sigma itself as the probability."""
    if test_sigma is None:
        if cfg.channel == 'bec':
            sigma = cfg.bec_p if mode == 'encoder' else cfg.bec_p_dec
        elif cfg.channel in ('bsc', 'ge'):
            sigma = cfg.bsc_p if mode == 'encoder' else cfg.bsc_p_dec
        else:
            sigma = train_sigma(shape, snr_low, snr_high, generator, device)
    else:
        sigma = point_sigma(cfg, test_sigma)
    return sample_noise(shape, spec_from_cfg(cfg), sigma, generator, device)
