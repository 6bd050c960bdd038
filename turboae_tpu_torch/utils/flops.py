"""Param and FLOP counts, and the card's peak rates (JAX: utils/flops.py).

  - `count_params` sums the elements of a param tree;
  - `analytic_flops` is JAX's closed form of the CNN flagship's forward:
    2 B L K Cin Cout a conv layer, plus the linear heads (JAX :21-39);
  - `counted_flops` runs a function under torch.utils.flop_counter's
    FlopCounterMode, the port's counterpart of XLA's cost_analysis (JAX
    :42-49). It counts the matmuls and convolutions that PyTorch dispatches
    (forward and backward), not elementwise work. It cannot see inside a
    kernel called through ctypes, so a fused decoder stack counts nothing:
    count the unfused path of the same function (the fused stack does the
    same products);
  - `PEAKS` holds the dense peak rates of each card the port knows, keyed
    by `torch.cuda.get_device_name`; it is the one place where a peak is
    written down. A card that is not in it has no MFU.
"""
from __future__ import annotations

from typing import Optional

import torch

from .tree import tree_leaves

# NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense (no
# sparsity): bf16 and TF32 on the tensor cores, f32 FFMA outside them, HBM3
H100_SXM = {'bfloat16': 989.4e12, 'tf32': 494.7e12, 'float32': 66.9e12,
            'bytes_per_s': 3.35e12}
PEAKS = {'NVIDIA H100 80GB HBM3': H100_SXM}


def peak(device_name: str, key: str) -> Optional[float]:
    """The card's peak for `key` ('bfloat16', 'tf32', 'float32' FLOP/s or
    'bytes_per_s'), or None for a card not in PEAKS."""
    return PEAKS.get(device_name, {}).get(key)


def count_params(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def analytic_flops(cfg, batch_size: int = 1) -> dict:
    """MAC-based forward FLOPs of the CNN flagship family (JAX :21-39)."""
    B, L = batch_size, cfg.block_len
    k = cfg.enc_kernel_size

    def conv_stack(n_layers, cin, cout, ksize):
        f = 2 * B * L * ksize * cin * cout          # first layer
        f += (n_layers - 1) * 2 * B * L * ksize * cout * cout
        return f

    enc = 3 * (conv_stack(cfg.enc_num_layer, cfg.code_rate_k, cfg.enc_num_unit, k)
               + 2 * B * L * cfg.enc_num_unit * 1)
    n_in = 2 + cfg.num_iter_ft
    dec_half = conv_stack(cfg.dec_num_layer, n_in, cfg.dec_num_unit, cfg.dec_kernel_size) \
        + 2 * B * L * cfg.dec_num_unit * cfg.num_iter_ft
    dec = 2 * cfg.num_iteration * dec_half
    return {'encoder_flops': enc, 'decoder_flops': dec, 'total_flops': enc + dec}


def counted_flops(fn, *args, **kwargs) -> int:
    """The FLOPs of the matmuls and convolutions fn(*args, **kwargs)
    dispatches, forward and backward (a ctypes kernel counts nothing)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as mode:
        fn(*args, **kwargs)
    return int(mode.get_total_flops())


def report(cfg, device='cpu') -> dict:
    """Params and FLOPs of the configured model, one block (JAX :52-76):
    the closed form beside the counted forward."""
    from ..models.channel_ae import forward_ae, init_ae, make_perms
    params = init_ae(torch.Generator().manual_seed(0), cfg, device)
    perms = make_perms(cfg, device)
    bits = torch.zeros((1, cfg.block_len, cfg.code_rate_k), device=device)
    noise = torch.zeros((1, cfg.block_len, cfg.code_rate_n), device=device)

    def fwd():
        with torch.no_grad():
            forward_ae(params, cfg.replace(use_fused_conv=False), bits, noise, perms,
                       training=False, generator=torch.Generator(device=device))

    enc_params = count_params(params['enc'])
    dec_params = count_params(params['dec'])
    ana = analytic_flops(cfg)
    counted = counted_flops(fwd)
    print(f'encoder params: {enc_params:,}')
    print(f'decoder params: {dec_params:,}')
    print(f'analytic fwd FLOPs/block: enc {ana["encoder_flops"]:,} '
          f'dec {ana["decoder_flops"]:,}')
    print(f'counted fwd FLOPs/block: {counted:,}')
    return {'enc_params': enc_params, 'dec_params': dec_params, **ana, 'counted': counted}
