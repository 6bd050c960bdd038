"""Long-run training of the secondary model families on the GPU (the port
of scripts/train_family.py): FTAE (--family ftae, train/ftae_trainer.py)
and the joint coding+modulation AE (--family mod, train/mod_trainer.py),
with train_flagship.py's checkpoints, JSONL metrics, divergence guard and
time budget. TF32 is off.

    python -m turboae_tpu_torch.cli.train_family --family ftae --epochs 120 \\
        --block_len 50 --ckpt tmp/ftae.msgpack --metrics logs/ftae.jsonl

  - an epoch runs num_train_enc encoder and num_train_dec decoder epochs
    (and, for mod, num_train_mod and num_train_demod epochs of those phases);
  - --resume <file> loads params, every phase optimizer's state and the
    epoch counter; --init_from <file> warm-starts the params only, merging
    the leaves whose paths and shapes match (a flagship checkpoint seeds the
    mod family's enc and dec) and refusing a file of which none match;
  - an epoch whose loss is NaN or explodes (train/guard.py) reloads the last
    good checkpoint into a fresh trainer with every lr halved, up to
    --max_backoffs times;
  - every --val_every epochs a test at --val_num_block blocks keeps the best
    mid-SNR BER epoch as <ckpt>.best; the run ends with the family's test at
    --test_num_block blocks.

`--device cpu` runs on the CPU; without it the CLI needs a GPU.
"""
from __future__ import annotations

import argparse
import os
import time


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--family', choices=['ftae', 'mod'], required=True)
    p.add_argument('--epochs', type=int, default=100)
    p.add_argument('--num_block', type=int, default=10000)
    p.add_argument('--batch_size', type=int, default=500)
    p.add_argument('--block_len', type=int, default=50)
    p.add_argument('--ckpt', default='')
    p.add_argument('--metrics', default='')
    p.add_argument('--resume', default='')
    p.add_argument('--init_from', default='',
                   help='warm-start params from another checkpoint, merging only matching '
                        'leaves; resets the epoch counter and optimizer state')
    p.add_argument('--loss', default='bce')
    p.add_argument('--enc_lr', type=float, default=0.001)
    p.add_argument('--dec_lr', type=float, default=0.001)
    p.add_argument('--num_train_enc', type=int, default=1)
    p.add_argument('--num_train_dec', type=int, default=5)
    p.add_argument('--ckpt_every', type=int, default=10)
    p.add_argument('--time_budget_s', type=float, default=0)
    p.add_argument('--test_num_block', type=int, default=10000)
    # ftae
    p.add_argument('--fb_channel_low', type=float, default=10.0)
    p.add_argument('--fb_channel_high', type=float, default=10.0)
    p.add_argument('--dec_type', default='turboae_cnn')
    p.add_argument('--cnn_type', default='normal')
    p.add_argument('--ftae_power_alloc', default='none', choices=['none', 'pos', 'pos_phase'])
    # mod
    p.add_argument('--mod_rate', type=int, default=2)
    p.add_argument('--mod_pc', default='block_power')
    p.add_argument('--mod_lr', type=float, default=0.005)
    p.add_argument('--demod_lr', type=float, default=0.005)
    p.add_argument('--num_train_mod', type=int, default=1)
    p.add_argument('--num_train_demod', type=int, default=5)
    p.add_argument('--train_enc_channel_low', type=float, default=1.0)
    p.add_argument('--train_enc_channel_high', type=float, default=1.0)
    p.add_argument('--train_dec_channel_low', type=float, default=-1.5)
    p.add_argument('--train_dec_channel_high', type=float, default=2.0)
    p.add_argument('--snr_test_start', type=float, default=-2.0)
    p.add_argument('--snr_test_end', type=float, default=2.0)
    p.add_argument('--snr_points', type=int, default=5)
    p.add_argument('--max_backoffs', type=int, default=4)
    p.add_argument('--val_every', type=int, default=10)
    p.add_argument('--val_num_block', type=int, default=2000)
    # narrow models for a quick run (the Config's widths by default)
    p.add_argument('--enc_num_unit', type=int, default=100)
    p.add_argument('--dec_num_unit', type=int, default=100)
    p.add_argument('--dec_num_layer', type=int, default=5)
    p.add_argument('--num_iteration', type=int, default=6)
    p.add_argument('--device', default='cuda')
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    from ..utils.device import no_tf32, resolve_device
    no_tf32()
    device = resolve_device(args.device)

    from ..config import Config
    from ..train.checkpoint import load_checkpoint, save_checkpoint
    from ..train.guard import BestTracker, DivergenceGuard, backoff_lrs
    from ..utils.logging import MetricsLogger

    ckpt = args.ckpt or f'tmp/{args.family}.msgpack'
    metrics_path = args.metrics or f'logs/{args.family}.jsonl'
    os.makedirs(os.path.dirname(ckpt) or '.', exist_ok=True)
    os.makedirs(os.path.dirname(metrics_path) or '.', exist_ok=True)

    def build_cfg(lrs):
        return Config(batch_size=args.batch_size, block_len=args.block_len,
                      num_block=args.num_block, loss=args.loss,
                      enc_lr=lrs['enc'], dec_lr=lrs['dec'],
                      num_train_enc=args.num_train_enc, num_train_dec=args.num_train_dec,
                      train_enc_channel_low=args.train_enc_channel_low,
                      train_enc_channel_high=args.train_enc_channel_high,
                      train_dec_channel_low=args.train_dec_channel_low,
                      train_dec_channel_high=args.train_dec_channel_high,
                      fb_channel_low=args.fb_channel_low, fb_channel_high=args.fb_channel_high,
                      dec_type=args.dec_type, cnn_type=args.cnn_type,
                      ftae_power_alloc=args.ftae_power_alloc,
                      mod_rate=args.mod_rate, mod_pc=args.mod_pc,
                      mod_lr=lrs['mod'], demod_lr=lrs['demod'],
                      num_train_mod=args.num_train_mod, num_train_demod=args.num_train_demod,
                      snr_test_start=args.snr_test_start, snr_test_end=args.snr_test_end,
                      snr_points=args.snr_points, enc_num_unit=args.enc_num_unit,
                      dec_num_unit=args.dec_num_unit, dec_num_layer=args.dec_num_layer,
                      num_iteration=args.num_iteration)

    def build_trainer(cfg):
        phases = ['encoder'] * cfg.num_train_enc + ['decoder'] * cfg.num_train_dec
        if args.family == 'ftae':
            from ..train.ftae_trainer import FTAETrainer
            return FTAETrainer(cfg, device), phases
        from ..train.mod_trainer import ModTrainer
        return ModTrainer(cfg, device), (phases + ['mod'] * cfg.num_train_mod
                                         + ['demod'] * cfg.num_train_demod)

    lrs = {'enc': args.enc_lr, 'dec': args.dec_lr, 'mod': args.mod_lr, 'demod': args.demod_lr}
    cfg = build_cfg(lrs)
    trainer, phases = build_trainer(cfg)
    metrics = MetricsLogger(metrics_path)
    start_epoch = 0
    if args.init_from:
        stats = {}
        trainer.params = load_checkpoint(args.init_from, trainer.params, stats=stats)
        print(f"warm-started {stats['merged']}/{stats['merged'] + stats['kept']} param "
              f'leaves from {args.init_from}', flush=True)
        if stats['merged'] == 0:
            raise SystemExit(f'--init_from {args.init_from}: ZERO leaves matched the target '
                             'architecture: wrong path or incompatible family')
    if args.resume and os.path.exists(args.resume):
        loaded = load_checkpoint(args.resume, trainer.params, trainer.opt_state)
        if isinstance(loaded, tuple):
            trainer.params, trainer.opt_state, start_epoch = loaded
        else:
            trainer.params = loaded
        print(f'resumed from {args.resume} at epoch {start_epoch}', flush=True)

    guard = DivergenceGuard()
    best = BestTracker()
    backoffs = 0
    last_good_epoch = start_epoch
    t_start = time.time()
    epoch = start_epoch
    while epoch < args.epochs:
        epoch += 1
        t0 = time.time()
        losses = {}
        for phase in phases:
            losses[phase] = trainer.train_epoch(epoch, phase, verbose=False)
        dt = time.time() - t0
        blocks = cfg.num_block * len(phases)
        msg = ' '.join(f'{k}_loss {v:.6f}' for k, v in losses.items())
        print(f'epoch {epoch}: {msg} {dt:.1f}s ({blocks / dt:.0f} blk/s)', flush=True)
        metrics.log('epoch', epoch=epoch, seconds=dt, **{f'{k}_loss': v for k, v in losses.items()})

        if guard.check(losses):
            backoffs += 1
            if backoffs > args.max_backoffs:
                print(f'DIVERGED at epoch {epoch}: {msg}; backoff limit '
                      f'({args.max_backoffs}) exhausted, stopping', flush=True)
                metrics.log('diverged', epoch=epoch, action='abort', **losses)
                break
            lrs = backoff_lrs(lrs)
            print(f'DIVERGED at epoch {epoch}: {msg}; reloading epoch-{last_good_epoch} '
                  f'checkpoint with lrs {lrs}', flush=True)
            metrics.log('diverged', epoch=epoch, action='backoff', lrs=lrs,
                        reload_epoch=last_good_epoch, **losses)
            cfg = build_cfg(lrs)
            trainer, phases = build_trainer(cfg)
            if os.path.exists(ckpt) and last_good_epoch > start_epoch:
                trainer.params = load_checkpoint(ckpt, trainer.params)
            elif args.resume and os.path.exists(args.resume):
                trainer.params = load_checkpoint(args.resume, trainer.params)
            guard.reset()
            epoch = last_good_epoch
            continue

        if args.val_every and epoch % args.val_every == 0:
            trainer.cfg = cfg.replace(num_block=args.val_num_block)
            vsnrs, vber, vbler = trainer.test(verbose=False)
            trainer.cfg = cfg
            mid = vber[len(vber) // 2]
            print(f'  val@{epoch}: mid-SNR ber {mid:.3g} (ber {["%.3g" % b for b in vber]})',
                  flush=True)
            metrics.log('val', epoch=epoch, snrs=vsnrs, ber=vber, bler=vbler)
            if best.update(mid, epoch):
                save_checkpoint(ckpt + '.best', trainer.params, trainer.opt_state, step=epoch)
                metrics.log('best', epoch=epoch, ber=mid, path=ckpt + '.best')

        if epoch % args.ckpt_every == 0 or epoch == args.epochs:
            save_checkpoint(ckpt, trainer.params, trainer.opt_state, step=epoch)
            metrics.log('checkpoint', epoch=epoch, path=ckpt)
            last_good_epoch = epoch

        if args.time_budget_s and time.time() - t_start > args.time_budget_s:
            print(f'time budget reached at epoch {epoch}; checkpointing and stopping',
                  flush=True)
            save_checkpoint(ckpt, trainer.params, trainer.opt_state, step=epoch)
            break

    trainer.cfg = cfg.replace(num_block=args.test_num_block)
    snrs, ber, bler = trainer.test(verbose=True)
    metrics.log('test', snrs=snrs, ber=ber, bler=bler)
    metrics.close()
    return trainer


if __name__ == '__main__':
    main()
