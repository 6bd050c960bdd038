"""FTAE, the feedback-channel turbo autoencoder (JAX: models/ftae.py).

Three forward phases with two feedback encoders (reference ftae_ae.py):
  phase 1: x1 = enc1(bits);            y1 = x1 + z1;  r1 = fb1(y1) + zf1
  phase 2: x2 = enc2([bits, r1, x1]);  y2 = x2 + z2;  r2 = fb2([y1, y2]) + zf2
  phase 3: x3 = enc3([bits, r1, x1, r2, x2]), its input interleaved when
           cfg.is_interleave;          y3 = x3 + z3
  decode([y1, y2, y3])
Noise tensors are (B, L, 3), one channel per phase, both ways.

Params {'fwd_enc1' | 'fwd_enc2' | 'fwd_enc3' | 'fb_enc1' | 'fb_enc2':
{'cnn': [conv layers], 'lin': head to 1[, 'pw': (L, 1), 'ps': ()]}, 'dec'},
PyTorch's layout (ops/conv1d.py). The forward encoders carry 'pw' under
cfg.ftae_power_alloc 'pos' and 'pos_phase', 'ps' under 'pos_phase'; both
start at ones. 'dec' by cfg.dec_type:
  - 'cnn': {'cnn', 'lin'}, one plain stack over the three received streams;
  - 'turboae_cnn' / 'turboae_rnn': {'iters': [{'dec1', 'dec2': core,
    'lin1', 'lin2': heads}]}, per-iteration weights, the core a conv stack
    (dense under cfg.cnn_type 'dense') or a biGRU of dec_num_layer layers
    (ops/gru.py, no dropout); the last iteration's lin2 emits code_rate_k;
  - 'turboae_sharedcnn': {'dec1', 'dec2': stacks, 'lin1', 'lin2', 'final'},
    one weight set run num_iteration times.

Kept from the JAX package as they are, since they set its numbers:
  - the interleaved phase-3 branch permutes the RAW inputs and drops the
    BPSK map (ftae_ae.py:74);
  - the per-iteration decoder subtracts its prior whatever cfg.extrinsic;
  - `_alloc` renormalizes with no epsilon, and 'pw'/'ps' scale codes that
    block_norm_ste has already quantized, with no guard (ADVICE.md 6-7).
The encoder stacks run unfused, as in JAX: no FTAE stack reaches K2.
Under a mesh (dist/mesh.py) the feedback whitening's mean and std and the
power allocation's per-position power are those of the global batch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist import mesh as dm
from ..ops import conv1d as cv
from ..ops import gru as rnn
from ..ops.interleave import deinterleave, interleave
from ..ops.power import mean_std
from ..ops.ste import rx_quantize
from ..utils.device import torch_dtype


def _fb_power_constraint(cfg, x):
    """Whitening by the mean and the Bessel-corrected std, then the rx
    quantizer unless cfg.channel_mode is 'block_norm' (JAX :40-52); f32 out.

    Taken in f64, from the head's ELU on (see _phase_enc_apply): a trained
    feedback encoder can saturate its ELU, and then its outputs lie within
    ~3e-5 of -1, where f32 holds ~500 values per std and one ulp of the
    conv's summation order, or the rounding of an f32 mean, moves a whitened
    value by ~2e-3 (both committed FTAE checkpoints' fb_enc2; PERF.md §6).
    In f64 the whitened values no longer depend on the device."""
    xd = x.double()
    m, s = mean_std(xd)
    xn = ((xd - m) / s).float()
    if cfg.channel_mode != 'block_norm':
        xn = rx_quantize(xn, 1.0, 2)
    return xn


def _phase_enc_init(gen, cfg, input_size: int, device, with_pw=False, with_ps=False):
    """CNN_encoder (JAX :55-71): a conv stack and a head to 1."""
    p = {'cnn': cv.stack_init(gen, cfg.enc_num_layer, input_size, cfg.enc_num_unit,
                              cfg.enc_kernel_size, device),
         'lin': cv.linear_init(gen, cfg.enc_num_unit, 1, device)}
    if with_pw:
        p['pw'] = torch.ones((cfg.block_len, 1), device=device)
    if with_ps:
        p['ps'] = torch.ones((), device=device)
    return p


def _power_alloc_scales(params, cfg):
    """((w1, w2, w3), (s1, s2, s3)) of the forward phases (JAX :74-92); 'ps'
    normalized to unit mean square across the three."""
    if cfg.ftae_power_alloc == 'none':
        return (None,) * 3, (None,) * 3
    ws = tuple(params[f'fwd_enc{i}']['pw'] for i in (1, 2, 3))
    if cfg.ftae_power_alloc == 'pos_phase':
        s = torch.stack([params[f'fwd_enc{i}']['ps'] for i in (1, 2, 3)])
        s = s * torch.rsqrt(torch.mean(s * s))
        return ws, (s[0], s[1], s[2])
    return ws, (None,) * 3


def _phase_enc_apply(p, cfg, inputs, interleave_perm=None):
    dt = torch_dtype(cfg.dtype)
    x = 2.0 * inputs - 1.0
    if interleave_perm is not None:
        x = interleave(inputs, interleave_perm)       # raw inputs (ftae_ae.py:74)
    h = cv.stack_apply(p['cnn'], x, compute_dtype=dt)
    return _fb_power_constraint(cfg, F.elu(cv.linear_apply(p['lin'], h,
                                                           compute_dtype=dt).double()))


def _alloc(x, w, s):
    """The learned per-position weights renormalized against the batch's
    measured per-position power, so the phase's power stays that of uniform
    whitening; then the phase scalar (JAX :283-301)."""
    if w is None:
        return x
    xf = x.float()
    pbar = dm.mean(xf * xf, dim=0)                            # (L, 1)
    factor = torch.rsqrt(torch.mean(w * w * pbar) / torch.mean(pbar))
    out = x * (w * factor).to(x.dtype)
    if s is not None:
        out = out * s.to(x.dtype)
    return out


# ---------------------------------------------------------------- decoders

def _core_init(gen, cfg, n_in, device):
    if cfg.dec_type == 'turboae_rnn':
        return rnn.bigru_init(gen, n_in, cfg.dec_num_unit, cfg.dec_num_layer, device)
    init = cv.dense_stack_init if cfg.cnn_type == 'dense' else cv.stack_init
    return init(gen, cfg.dec_num_layer, n_in, cfg.dec_num_unit, cfg.dec_kernel_size, device)


def _core_apply(cfg, w, x):
    dt = torch_dtype(cfg.dtype)
    if cfg.dec_type == 'turboae_rnn':
        return rnn.bigru_apply(w, x, compute_dtype=dt)
    if cfg.cnn_type == 'dense':
        return cv.dense_stack_apply(w, x, compute_dtype=dt)
    return cv.stack_apply(w, x, compute_dtype=dt)


def _ftae_dec_init(gen, cfg, device):
    """FTAE_decoder (JAX :111-142)."""
    n_in = 2 + cfg.num_iter_ft
    lin_in = 2 * cfg.dec_num_unit if cfg.dec_type == 'turboae_rnn' else cfg.dec_num_unit
    iters = []
    for i in range(cfg.num_iteration):
        last = i == cfg.num_iteration - 1
        iters.append({'dec1': _core_init(gen, cfg, n_in, device),
                      'dec2': _core_init(gen, cfg, n_in, device),
                      'lin1': cv.linear_init(gen, lin_in, cfg.num_iter_ft, device),
                      'lin2': cv.linear_init(gen, lin_in,
                                             cfg.code_rate_k if last else cfg.num_iter_ft,
                                             device)})
    return {'iters': iters}


def _ftae_dec_apply(params, cfg, received, perms):
    dt = torch_dtype(cfg.dtype)
    p, inv = perms['p1'], perms['p1_inv']
    r_sys, r_par1, r_par2 = received[:, :, 0:1], received[:, :, 1:2], received[:, :, 2:3]
    r_sys_int = interleave(r_sys, p)
    b, l, _ = received.shape
    prior = torch.zeros((b, l, cfg.num_iter_ft), dtype=torch.float32, device=received.device)

    def half(w_core, w_lin, inputs):
        return cv.linear_apply(w_lin, _core_apply(cfg, w_core, inputs), compute_dtype=dt)

    *iters, final = params['iters']
    for w in iters:
        x = half(w['dec1'], w['lin1'], torch.cat([r_sys, r_par1, prior], dim=2)) - prior
        x_int = interleave(x, p)
        x2 = half(w['dec2'], w['lin2'], torch.cat([r_sys_int, r_par2, x_int], dim=2)) - x_int
        prior = deinterleave(x2, inv)
    x = half(final['dec1'], final['lin1'], torch.cat([r_sys, r_par1, prior], dim=2)) - prior
    x_int = interleave(x, p)
    logit = half(final['dec2'], final['lin2'], torch.cat([r_sys_int, r_par2, x_int], dim=2))
    return torch.sigmoid(deinterleave(logit, inv))


def _shared_dec_init(gen, cfg, device):
    """FTAE_Shareddecoder (JAX :189-201)."""
    n_in = 2 + cfg.num_iter_ft
    init = cv.dense_stack_init if cfg.cnn_type == 'dense' else cv.stack_init
    U, nl, K = cfg.dec_num_unit, cfg.dec_num_layer, cfg.dec_kernel_size
    return {'dec1': init(gen, nl, n_in, U, K, device),
            'dec2': init(gen, nl, n_in, U, K, device),
            'lin1': cv.linear_init(gen, U, cfg.num_iter_ft, device),
            'lin2': cv.linear_init(gen, U, cfg.num_iter_ft, device),
            'final': cv.linear_init(gen, cfg.num_iter_ft, 1, device)}


def _shared_dec_apply(params, cfg, received, perms):
    """num_iteration rounds of one weight set; the last round's dec2 output,
    de-interleaved, through the final linear (JAX :204-239)."""
    dt = torch_dtype(cfg.dtype)
    stackf = cv.dense_stack_apply if cfg.cnn_type == 'dense' else cv.stack_apply
    p, inv = perms['p1'], perms['p1_inv']
    r_sys, r_par1, r_par2 = received[:, :, 0:1], received[:, :, 1:2], received[:, :, 2:3]
    r_sys_int = interleave(r_sys, p)
    b, l, _ = received.shape
    prior = torch.zeros((b, l, cfg.num_iter_ft), dtype=torch.float32, device=received.device)
    x_plr = prior
    for _ in range(cfg.num_iteration):
        x = cv.linear_apply(params['lin1'], stackf(params['dec1'],
                            torch.cat([r_sys, r_par1, prior], dim=2), compute_dtype=dt),
                            compute_dtype=dt) - prior
        x_int = interleave(x, p)
        x_plr = cv.linear_apply(params['lin2'], stackf(params['dec2'],
                                torch.cat([r_sys_int, r_par2, x_int], dim=2), compute_dtype=dt),
                                compute_dtype=dt) - x_int
        prior = deinterleave(x_plr, inv)
    return torch.sigmoid(cv.linear_apply(params['final'], deinterleave(x_plr, inv),
                                         compute_dtype=dt))


def _cnn_dec_init(gen, cfg, device):
    """The plain CNN decoder (JAX :242-246)."""
    return {'cnn': cv.stack_init(gen, cfg.dec_num_layer, cfg.code_rate_n, cfg.dec_num_unit,
                                 cfg.dec_kernel_size, device),
            'lin': cv.linear_init(gen, cfg.dec_num_unit, cfg.code_rate_k, device)}


def _cnn_dec_apply(params, cfg, received, perms):
    dt = torch_dtype(cfg.dtype)
    h = cv.stack_apply(params['cnn'], received, compute_dtype=dt)
    return torch.sigmoid(cv.linear_apply(params['lin'], h, compute_dtype=dt))


_DECODERS = {'cnn': (_cnn_dec_init, _cnn_dec_apply),
             'turboae_sharedcnn': (_shared_dec_init, _shared_dec_apply)}


def _decoder(cfg):
    return _DECODERS.get(cfg.dec_type, (_ftae_dec_init, _ftae_dec_apply))


# ---------------------------------------------------------------- the AE

def init_ftae(gen: torch.Generator, cfg, device='cpu'):
    """PyTorch's default init drawn from `gen` (a CPU generator): the forward
    encoders, the feedback encoders, then the decoder (JAX :259-275)."""
    pw = cfg.ftae_power_alloc != 'none'
    ps = cfg.ftae_power_alloc == 'pos_phase'
    params = {f'fwd_enc{i}': _phase_enc_init(gen, cfg, n, device, pw, ps)
              for i, n in ((1, 1), (2, 3), (3, 5))}
    params['fb_enc1'] = _phase_enc_init(gen, cfg, 1, device)
    params['fb_enc2'] = _phase_enc_init(gen, cfg, 2, device)
    params['dec'] = _decoder(cfg)[0](gen, cfg, device)
    return params


def forward_ftae(params, cfg, bits, fwd_noise, fb_noise, perms):
    """(bit estimates (B, L, k), codes (B, L, 3)); noises (B, L, 3); perms
    as models/channel_ae.make_perms gives them (JAX :278-336)."""
    z1, z2, z3 = (fwd_noise[:, :, i:i + 1] for i in range(3))
    zf1, zf2 = (fb_noise[:, :, i:i + 1] for i in range(2))
    (w1, w2, w3), (s1, s2, s3) = _power_alloc_scales(params, cfg)

    x1 = _alloc(_phase_enc_apply(params['fwd_enc1'], cfg, bits), w1, s1)
    y1 = x1 + z1
    r1 = _phase_enc_apply(params['fb_enc1'], cfg, y1) + zf1
    if cfg.ignore_feedback:
        r1 = r1 * 0.0
    x1_in = x1 * 0.0 if cfg.ignore_prev_code else x1
    x2 = _alloc(_phase_enc_apply(params['fwd_enc2'], cfg, torch.cat([bits, r1, x1_in], dim=2)),
                w2, s2)
    y2 = x2 + z2
    r2 = _phase_enc_apply(params['fb_enc2'], cfg, torch.cat([y1, y2], dim=2)) + zf2
    if cfg.ignore_feedback:
        r2 = r2 * 0.0
    x2_in = x2 * 0.0 if cfg.ignore_prev_code else x2
    perm = perms['p1'] if cfg.is_interleave else None
    x3 = _alloc(_phase_enc_apply(params['fwd_enc3'], cfg,
                                 torch.cat([bits, r1, x1_in, r2, x2_in], dim=2), perm), w3, s3)
    y3 = x3 + z3

    # the reference zeroes x1 and x2 themselves under ignore_prev_code
    # (ftae_ae.py:355,367): the returned codes carry the zeros
    codes = torch.cat([x1_in, x2_in, x3], dim=2)
    received = torch.cat([y1, y2, y3], dim=2)
    return _decoder(cfg)[1](params['dec'], cfg, received, perms), codes
