"""Encoders and their registry (JAX: models/encoders.py).

ENC_interCNN, the flagship's, in both conv flavours: 'TurboAE_rate3_cnn'
with plain stacks and 'TurboAE_rate3_cnn_dense' with dense ones. Params:
{'b1' | 'b2' | 'b3': {'cnn': [conv layers], 'lin': linear head}} in
PyTorch's layout (see ops/conv1d.py). Bits x are (B, L, k) in {0, 1}; codes
are (B, L, n). The encoder's conv stacks run unfused, as in the JAX package.

The rest of the 1D CNN zoo has the same branches over plain stacks, built
with cfg.dec_kernel_size, a quirk of the reference kept by JAX (encoders.py:
88-92): 'turboae_2int' (b2 reads the bits interleaved by p1, b3 by p2),
'TurboAE_rate2_cnn' (b2 by p1), 'rate3_cnn' and 'rate2_cnn' (no
interleaver).

The 2D codes view the block as a (cfg.img_size, cfg.img_size) image, each
branch {'cnn': [Conv2d layers], 'lin': a 1x1 Conv2d to 1}:
'TurboAE_rate3_cnn2d' (plain stacks), 'TurboAE_rate3_cnn2d_dense' (dense),
whose b3 reads the pixel-interleaved image and whose heads have no
activation, and 'rate3_cnn2d' (no interleaver, enc_act on the heads).

The RNN encoders (ops/gru.py) have branches {'rnn': [biRNN layers],
'lin': head from 2 * enc_num_unit}: 'Turboae_rate3_rnn' (three branches,
cfg.enc_rnn), 'TurboAE_rate3_rnn_sys' (a hard systematic bit and two
parity branches) and 'TurboAE_rate2_rnn' (two branches, always GRU). They
read the raw bits, with no BPSK map, as the reference does.

Under a mesh that shards time (dist/mesh.py) a CNN branch's stack runs over
this rank's halo window (`halo_apply`); the 2D codes and the biRNNs have no
local form over time and run on the whole block (`whole_time`).

`make_encoder(cfg)` gives (init, apply) for cfg.encoder; DeepTurbo's fixed
classical encoders come from models/deepturbo.py. An unknown key raises
ValueError, as in JAX.
"""
from __future__ import annotations

import torch

from ..dist import mesh as dm
from ..ops import conv1d as cv
from ..ops import gru as rnn
from ..ops.activations import activation
from ..ops.interleave import interleave, interleave_2d
from ..ops.power import power_constraint
from ..utils.device import torch_dtype


def dense(cfg) -> bool:
    """Whether cfg's CNN stacks are dense: the reference keys the flavour of
    both the encoder's and DEC_LargeCNN's stacks off the ENCODER's name
    (decoders.py:172-176); plain only for the flagship's."""
    return cfg.encoder != 'TurboAE_rate3_cnn'


def _branch_init(gen, cfg, device, is_dense: bool):
    """One branch: a conv stack code_rate_k -> enc_num_unit and a head to 1."""
    init = cv.dense_stack_init if is_dense else cv.stack_init
    return {'cnn': init(gen, cfg.enc_num_layer, cfg.code_rate_k, cfg.enc_num_unit,
                        cfg.enc_kernel_size, device),
            'lin': cv.linear_init(gen, cfg.enc_num_unit, 1, device)}


def intercnn_init(gen: torch.Generator, cfg, device='cpu'):
    """Params of the three branches b1, b2, b3 (JAX encoders.py:62-67)."""
    return {name: _branch_init(gen, cfg, device, dense(cfg)) for name in ('b1', 'b2', 'b3')}


def _branch_apply(p, cfg, x, is_dense: bool):
    dt = torch_dtype(cfg.dtype)
    stack = cv.dense_stack_apply if is_dense else cv.stack_apply
    # under a time-sharded mesh, over this rank's halo window
    h = dm.halo_apply(lambda t: stack(p['cnn'], t, compute_dtype=dt), x, cv.halo(p['cnn']))
    return activation(cfg.enc_act)(cv.linear_apply(p['lin'], h, compute_dtype=dt))


def intercnn_apply(params, cfg, x, perms, training=True, stats=None):
    """Returns (codes, stats). perms['p1'] is the forward interleaver."""
    is_dense = dense(cfg)
    x = 2.0 * x - 1.0                       # BPSK map (JAX encoders.py:71)
    x_sys = _branch_apply(params['b1'], cfg, x, is_dense)
    x_p1 = _branch_apply(params['b2'], cfg, x, is_dense)
    x_p2 = _branch_apply(params['b3'], cfg, interleave(x, perms['p1']), is_dense)
    x_tx = torch.cat([x_sys, x_p1, x_p2], dim=2)
    return power_constraint(x_tx, cfg, training, stats)


def _rnn_branch_init(gen, cfg, device, kind):
    return {'rnn': rnn.birnn_init(gen, cfg.code_rate_k, cfg.enc_num_unit, cfg.enc_num_layer,
                                  kind, device),
            'lin': cv.linear_init(gen, 2 * cfg.enc_num_unit, 1, device)}


def _rnn_branch_apply(p, cfg, x, kind):
    dt = torch_dtype(cfg.dtype)
    h = rnn.birnn_apply(p['rnn'], x, kind, compute_dtype=dt)
    return activation(cfg.enc_act)(cv.linear_apply(p['lin'], h, compute_dtype=dt))


def interrnn_init(gen: torch.Generator, cfg, device='cpu'):
    """ENC_interRNN: three branches b1, b2, b3 (JAX encoders.py:204-208)."""
    return {b: _rnn_branch_init(gen, cfg, device, cfg.enc_rnn) for b in ('b1', 'b2', 'b3')}


def interrnn_apply(params, cfg, x, perms, training=True, stats=None):
    """Raw bits into every branch, b3's interleaved (JAX :211-218)."""
    x_sys = _rnn_branch_apply(params['b1'], cfg, x, cfg.enc_rnn)
    x_p1 = _rnn_branch_apply(params['b2'], cfg, x, cfg.enc_rnn)
    x_p2 = _rnn_branch_apply(params['b3'], cfg, interleave(x, perms['p1']), cfg.enc_rnn)
    return power_constraint(torch.cat([x_sys, x_p1, x_p2], dim=2), cfg, training, stats)


def interrnn_sys_init(gen: torch.Generator, cfg, device='cpu'):
    """ENC_interRNN_sys: two parity branches b1, b2 (JAX :221-225)."""
    return {b: _rnn_branch_init(gen, cfg, device, cfg.enc_rnn) for b in ('b1', 'b2')}


def interrnn_sys_apply(params, cfg, x, perms, training=True, stats=None):
    """[2x - 1, power_constraint(parity)] (JAX :228-236)."""
    x_p1 = _rnn_branch_apply(params['b1'], cfg, x, cfg.enc_rnn)
    x_p2 = _rnn_branch_apply(params['b2'], cfg, interleave(x, perms['p1']), cfg.enc_rnn)
    x_tx, stats = power_constraint(torch.cat([x_p1, x_p2], dim=2), cfg, training, stats)
    return torch.cat([2.0 * x - 1.0, x_tx], dim=2), stats


def rate2rnn_init(gen: torch.Generator, cfg, device='cpu'):
    """ENC_turbofy_rate2: two GRU branches b1, b2 (JAX :239-247)."""
    return {b: _rnn_branch_init(gen, cfg, device, 'gru') for b in ('b1', 'b2')}


def rate2rnn_apply(params, cfg, x, perms, training=True, stats=None):
    """[b1(x), b2(interleave(x))] (JAX :250-257)."""
    x_sys = _rnn_branch_apply(params['b1'], cfg, x, 'gru')
    x_p2 = _rnn_branch_apply(params['b2'], cfg, interleave(x, perms['p1']), 'gru')
    return power_constraint(torch.cat([x_sys, x_p2], dim=2), cfg, training, stats)


def _zoo_init(names):
    """Branches `names`, each a plain stack code_rate_k -> enc_num_unit of
    kernel dec_kernel_size (JAX encoders.py:86-94, 115-122, 142-172) and a
    head to 1."""
    def init(gen: torch.Generator, cfg, device='cpu'):
        return {b: {'cnn': cv.stack_init(gen, cfg.enc_num_layer, cfg.code_rate_k,
                                         cfg.enc_num_unit, cfg.dec_kernel_size, device),
                    'lin': cv.linear_init(gen, cfg.enc_num_unit, 1, device)} for b in names}
    return init


def _zoo_apply(reads):
    """Branch b<i+1> reads the BPSK bits interleaved by perms[reads[i]], or
    as they are where reads[i] is None (JAX encoders.py:97-108, 125-135,
    152-185)."""
    def apply(params, cfg, x, perms, training=True, stats=None):
        x = 2.0 * x - 1.0
        outs = [_branch_apply(params[f'b{i + 1}'], cfg, x if p is None else interleave(x, perms[p]),
                              False) for i, p in enumerate(reads)]
        return power_constraint(torch.cat(outs, dim=2), cfg, training, stats)
    return apply


def dense2d(cfg) -> bool:
    """Whether the 2D codes' stacks are dense: keyed off the ENCODER's name
    for the encoder and the decoder alike (JAX decoders.py:489)."""
    return cfg.encoder == 'TurboAE_rate3_cnn2d_dense'


def cnn2d_init(gen: torch.Generator, cfg, device='cpu'):
    """Three branches of a 2D stack code_rate_k -> enc_num_unit and a 1x1
    Conv2d head to 1 (JAX encoders.py:273-284)."""
    init = cv.dense_stack2d_init if dense2d(cfg) else cv.stack2d_init
    return {b: {'cnn': init(gen, cfg.enc_num_layer, cfg.code_rate_k, cfg.enc_num_unit,
                            cfg.enc_kernel_size, device),
                'lin': cv.conv2d_init(gen, cfg.enc_num_unit, 1, 1, device)}
            for b in ('b1', 'b2', 'b3')}


def _cnn2d_apply(interleaved: bool):
    """ENC_interCNN2D (interleaved: b3 reads the pixel-interleaved image,
    raw heads; JAX encoders.py:299-321) or ENC_CNN2D (enc_act on the heads;
    :329-342). The image is the block reshaped row-major to (B, img_size,
    img_size, k); the codes are reshaped back to (B, block_len, 3). Under a
    time-sharded mesh it runs on the whole block (dist/mesh.py:whole_time)."""
    def apply(params, cfg, x, perms, training=True, stats=None):
        return dm.whole_time(lambda full: _apply(params, cfg, full, perms, training, stats), x)

    def _apply(params, cfg, x, perms, training, stats):
        dt = torch_dtype(cfg.dtype)
        stack = cv.dense_stack2d_apply if dense2d(cfg) else cv.stack2d_apply
        head_act = (lambda h: h) if interleaved else activation(cfg.enc_act)
        s, b = cfg.img_size, x.shape[0]
        img = (2.0 * x - 1.0).reshape(b, s, s, x.shape[2])
        inputs = [img, img, img]
        if interleaved:
            inputs[2] = interleave_2d(img.permute(0, 3, 1, 2), perms['p1']).permute(0, 2, 3, 1)
        outs = [head_act(cv.conv2d_apply(params[f'b{i + 1}']['lin'],
                                         stack(params[f'b{i + 1}']['cnn'], inp, compute_dtype=dt),
                                         compute_dtype=dt))
                for i, inp in enumerate(inputs)]
        x_tx = torch.cat(outs, dim=3).reshape(b, cfg.block_len, 3)
        return power_constraint(x_tx, cfg, training, stats)
    return apply


ENC_REGISTRY = {
    'TurboAE_rate3_cnn': (intercnn_init, intercnn_apply),
    'TurboAE_rate3_cnn_dense': (intercnn_init, intercnn_apply),
    'Turboae_rate3_rnn': (interrnn_init, interrnn_apply),
    'TurboAE_rate3_rnn_sys': (interrnn_sys_init, interrnn_sys_apply),
    'TurboAE_rate2_rnn': (rate2rnn_init, rate2rnn_apply),
    'TurboAE_rate2_cnn': (_zoo_init(('b1', 'b2')), _zoo_apply((None, 'p1'))),
    'rate3_cnn': (_zoo_init(('b1', 'b2', 'b3')), _zoo_apply((None, None, None))),
    'rate2_cnn': (_zoo_init(('b1', 'b2')), _zoo_apply((None, None))),
    'turboae_2int': (_zoo_init(('b1', 'b2', 'b3')), _zoo_apply((None, 'p1', 'p2'))),
    'TurboAE_rate3_cnn2d': (cnn2d_init, _cnn2d_apply(interleaved=True)),
    'TurboAE_rate3_cnn2d_dense': (cnn2d_init, _cnn2d_apply(interleaved=True)),
    'rate3_cnn2d': (cnn2d_init, _cnn2d_apply(interleaved=False)),
}


def make_encoder(cfg):
    """(init, apply) of cfg.encoder (JAX encoders.py:364-376)."""
    if cfg.encoder in ('Turbo_rate3_757', 'Turbo_rate3_lte'):
        from .deepturbo import turbo_enc_apply, turbo_enc_init
        return turbo_enc_init, turbo_enc_apply
    if cfg.encoder not in ENC_REGISTRY:
        raise ValueError(f'unknown encoder {cfg.encoder}')
    return ENC_REGISTRY[cfg.encoder]
