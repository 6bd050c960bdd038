"""Params and FLOPs of a configured model (JAX: cli/compute_flop.py;
reference compute_flop.py): the closed form of utils/flops.py beside the
FLOPs FlopCounterMode counts in one block's forward.

    python -m turboae_tpu_torch.cli.compute_flop -block_len 100 --device cpu

The count runs the unfused forward on `--device` (default cuda).
"""
from __future__ import annotations


def main(argv=None):
    from ..utils.device import resolve_device
    from ..utils.flops import report
    from .main import parse
    cfg, device = parse(argv)
    return report(cfg, resolve_device(device))


if __name__ == '__main__':
    main()
