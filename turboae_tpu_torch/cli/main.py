"""CLI entry point: the reference-compatible experiment on the GPU
(JAX: cli/main.py:16-95; reference main.py:98-260).

Parses the reference's flags (config.py:get_args), tees stdout to
./logs/<id>_log.txt, runs the alternating encoder/decoder epochs with a
validation after each, saves ./tmp/model_<id>.msgpack (params and optimizer
state, the JAX package's format) and ends with Trainer.test's SNR sweep.
`-init_nw_weight <file>` starts from a checkpoint's params. With
`--is_variable_block_len` the steps draw their lengths from
[block_len_low, block_len_high) and the run ends with two more tests, at
block_len_low and block_len_high (JAX cli/main.py:86-94). TF32 is off.

    python -m turboae_tpu_torch.cli.main -num_epoch 10 -num_block 10000

`--device cpu` runs on the CPU; without it the CLI needs a GPU. Not ported
yet: `-mesh_shape` (ROADMAP M16) raises.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from ..config import _add_args, config_from_args


def parse(argv=None):
    """(Config, device) of the command line."""
    parser = argparse.ArgumentParser('turboae-tpu-torch')
    _add_args(parser)
    parser.add_argument('--device', default='cuda',
                        help='cuda (default) or cpu; not a Config field')
    ns = parser.parse_args(argv)
    return config_from_args(ns), ns.device


def main(argv=None):
    cfg, device = parse(argv)
    from ..utils.device import no_tf32, resolve_device
    no_tf32()
    if cfg.mesh_shape:
        raise NotImplementedError('-mesh_shape is not ported yet (ROADMAP M16)')
    device = resolve_device(device)

    # stdout tee to ./logs/<id>_log.txt (reference main.py:17-27,102-107)
    ident = str(int(time.time() % 1_000_000))
    os.makedirs('./logs', exist_ok=True)
    from ..utils.logging import Tee
    tee = Tee(f'./logs/{ident}_log.txt')
    prev_stdout, sys.stdout = sys.stdout, tee
    try:
        return _run(cfg, ident, device)
    finally:
        sys.stdout = prev_stdout
        tee.log.close()


def _run(cfg, ident, device):
    print('[ID]', ident)
    print(cfg)

    from ..train.checkpoint import load_checkpoint, save_checkpoint
    from ..train.trainer import Trainer
    from ..utils.logging import MetricsLogger
    metrics = MetricsLogger(cfg.log_jsonl or None)
    trainer = Trainer(cfg, device)

    if cfg.init_nw_weight != 'default':
        trainer.params = load_checkpoint(cfg.init_nw_weight, trainer.params)
        print('loaded weights from', cfg.init_nw_weight)

    # alternating training schedule (reference main.py:220-237)
    report_loss, report_ber = [], []
    for epoch in range(1, cfg.num_epoch + 1):
        loss = float('nan')  # stays nan if both phase counts are 0
        if cfg.joint_train:
            loss = trainer.train_epoch(epoch, 'joint')
        else:
            for _ in range(cfg.num_train_enc):
                loss = trainer.train_epoch(epoch, 'encoder')
            for _ in range(cfg.num_train_dec):
                loss = trainer.train_epoch(epoch, 'decoder')
        bce, ber = trainer.validate()
        report_loss.append(bce)
        report_ber.append(ber)
        metrics.log('epoch', epoch=epoch, loss=loss, val_bce=bce, val_ber=ber)

    if cfg.print_test_traj:
        # per-epoch validation trajectory (reference main.py:239-242)
        print('test loss trajectory', report_loss)
        print('test ber trajectory', report_ber)
        print('total epoch', cfg.num_epoch)

    if cfg.num_epoch > 0:
        os.makedirs('./tmp', exist_ok=True)
        ckpt = f'./tmp/model_{ident}.msgpack'
        save_checkpoint(ckpt, trainer.params, trainer.opt_state)
        print('saved model', ckpt)

    snrs, ber, bler = trainer.test()
    metrics.log('test', snrs=snrs, ber=ber, bler=bler)
    metrics.close()

    # variable block lengths: also test at the low and high lengths
    # (reference main.py:251-257)
    if cfg.is_variable_block_len:
        for L in (cfg.block_len_low, cfg.block_len_high):
            print(f'====> test at block_len {L}')
            Trainer(cfg.replace(block_len=L, is_variable_block_len=False), device,
                    params=trainer.params).test()
    return trainer


if __name__ == '__main__':
    main()
