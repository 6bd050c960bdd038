"""TurboAE and DeepTurbo training on the GPU (the port of
scripts/train_flagship.py, with its flags).

Runs the reference's alternating 1-enc/5-dec schedule (main.py:220-233) with
periodic checkpoints and JSONL metrics, resumable with --resume. TF32 is off.

    python -m turboae_tpu_torch.cli.train_flagship --epochs 200 \
        --num_block 25000 --ckpt tmp/flagship.msgpack --metrics logs/flagship.jsonl

  - --resume <file> loads params and, unless --fresh_opt, the optimizer state
    and the epoch counter (the checkpoint's 'step'); --start_epoch overrides
    the counter. The committed JAX checkpoints resume as they are.
  - An epoch whose loss is NaN or explodes (train/guard.py) reloads the last
    good checkpoint into a fresh trainer with both lrs halved, up to
    --max_backoffs times.
  - <ckpt>.best keeps the best validation BER; --test_every N sweeps the SNR
    points and snapshots <ckpt>.e<epoch>; --time_budget_s stops cleanly; the
    run ends with Trainer.test.
  - --trace_dir writes a torch.profiler Chrome trace of the second epoch run
    (trace.json) and the host spans it recorded (spans.jsonl).
  - --scan_unroll is accepted so the committed recipes' command lines run
    unchanged; the port's decoder loop has no scan, so it changes neither
    numerics nor launches.

  - --loss takes the whole menu of train/losses.py; --encoder
    Turbo_rate3_757 | Turbo_rate3_lte trains DeepTurbo's decoder (with
    --num_train_enc 0: the encoder has no params), TurboAE_rate3_cnn_dense
    the dense CNN code.

    python -m turboae_tpu_torch.cli.train_flagship --resume artifacts/deepturbo.msgpack \
        --encoder Turbo_rate3_757 --num_train_enc 0 --num_train_dec 6 --dec_lr 2e-5 \
        --train_dec_channel_low -2.5 --dtype bfloat16 --epochs 530

`--device cpu` runs on the CPU; without it the CLI needs a GPU. Every key
of the registries builds: the RNN zoo's at the Config's RNN settings
(-enc_rnn, -dec_rnn and -dropout are cli/main.py's flags), the 2D codes at
the Config's img_size 10 (so block_len 100); the rate-2 codes need
-code_rate_n 2, a flag of cli/main.py only, as in JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--epochs', type=int, default=100)
    p.add_argument('--num_block', type=int, default=25000)
    p.add_argument('--batch_size', type=int, default=500)
    p.add_argument('--block_len', type=int, default=100)
    p.add_argument('--ckpt', default='tmp/flagship.msgpack')
    p.add_argument('--metrics', default='logs/flagship.jsonl')
    p.add_argument('--resume', default='')
    p.add_argument('--train_channel_mode', default='block_norm')
    p.add_argument('--loss', default='bce',
                   help='bce | soft_ber | bce_rl | enc_rl | bce_block | focal | mse | '
                        'maxBCE | sortBCE')
    p.add_argument('--enc_lr', type=float, default=0.001)
    p.add_argument('--dec_lr', type=float, default=0.001)
    p.add_argument('--dtype', default='float32')
    p.add_argument('--use_fused_conv', action='store_true',
                   help='decoder conv stacks through the CUDA bf16 kernel')
    p.add_argument('--num_train_enc', type=int, default=1)
    p.add_argument('--num_train_dec', type=int, default=5)
    p.add_argument('--ckpt_every', type=int, default=10)
    p.add_argument('--val_every', type=int, default=5)
    p.add_argument('--time_budget_s', type=float, default=0,
                   help='stop cleanly after this many seconds (0 = no limit)')
    p.add_argument('--encoder', default='TurboAE_rate3_cnn',
                   help='e.g. Turbo_rate3_757 for DeepTurbo')
    p.add_argument('--decoder', default='TurboAE_rate3_cnn')
    p.add_argument('--dec_num_layer', type=int, default=5)
    p.add_argument('--enc_num_unit', type=int, default=100)
    p.add_argument('--dec_num_unit', type=int, default=100)
    p.add_argument('--num_iteration', type=int, default=6)
    p.add_argument('--snr_points', type=int, default=12)
    p.add_argument('--channel', default='awgn',
                   help='awgn | t-dist | radar | ge_awgn | bec | bsc | ge | fading')
    p.add_argument('--vv', type=float, default=5.0, help='t-dist dof')
    p.add_argument('--radar_power', type=float, default=5.0)
    p.add_argument('--radar_prob', type=float, default=0.05)
    p.add_argument('--train_enc_channel_low', type=float, default=1.0)
    p.add_argument('--train_enc_channel_high', type=float, default=1.0)
    p.add_argument('--train_dec_channel_low', type=float, default=-1.5)
    p.add_argument('--train_dec_channel_high', type=float, default=2.0)
    p.add_argument('--fresh_opt', action='store_true',
                   help='on resume, load params only and start a new optimizer state')
    p.add_argument('--start_epoch', type=int, default=-1,
                   help='override the resumed epoch counter (new phases restart at 0)')
    p.add_argument('--trace_dir', default='',
                   help='torch.profiler Chrome trace of the second epoch run')
    p.add_argument('--test_every', type=int, default=0,
                   help='every N epochs sweep the SNR points (test_num_block '
                        'blocks each), log it and snapshot <ckpt>.e<epoch>')
    p.add_argument('--test_num_block', type=int, default=10000)
    p.add_argument('--scan_unroll', type=int, default=1,
                   help='accepted for the JAX command lines; no effect here')
    p.add_argument('--max_backoffs', type=int, default=4,
                   help='on loss divergence reload the last checkpoint and '
                        'halve both lrs, up to this many times')
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
    from ..train.sweep import sweep
    from ..train.trainer import Trainer
    from ..utils.logging import MetricsLogger, trace

    os.makedirs(os.path.dirname(args.ckpt) or '.', exist_ok=True)
    os.makedirs(os.path.dirname(args.metrics) or '.', exist_ok=True)

    def build_cfg(enc_lr, dec_lr):
        return Config(batch_size=args.batch_size, block_len=args.block_len,
                      num_block=args.num_block, channel=args.channel, vv=args.vv,
                      radar_power=args.radar_power, radar_prob=args.radar_prob,
                      encoder=args.encoder, decoder=args.decoder,
                      dec_num_layer=args.dec_num_layer, enc_num_unit=args.enc_num_unit,
                      dec_num_unit=args.dec_num_unit, num_iteration=args.num_iteration,
                      snr_points=args.snr_points,
                      train_enc_channel_low=args.train_enc_channel_low,
                      train_enc_channel_high=args.train_enc_channel_high,
                      train_dec_channel_low=args.train_dec_channel_low,
                      train_dec_channel_high=args.train_dec_channel_high,
                      train_channel_mode=args.train_channel_mode,
                      test_channel_mode=args.train_channel_mode,
                      num_train_enc=args.num_train_enc, num_train_dec=args.num_train_dec,
                      loss=args.loss, enc_lr=enc_lr, dec_lr=dec_lr, dtype=args.dtype,
                      use_fused_conv=args.use_fused_conv, scan_unroll=args.scan_unroll)

    lrs = {'enc': args.enc_lr, 'dec': args.dec_lr}
    cfg = build_cfg(lrs['enc'], lrs['dec'])
    trainer = Trainer(cfg, device)
    metrics = MetricsLogger(args.metrics)

    start_epoch = 0
    if args.resume and os.path.exists(args.resume):
        loaded = load_checkpoint(args.resume, trainer.params, trainer.opt_state)
        if isinstance(loaded, tuple):
            if args.fresh_opt:
                trainer.params = loaded[0]
            else:
                trainer.params, trainer.opt_state, start_epoch = loaded
        else:
            trainer.params = loaded
        print(f'resumed from {args.resume} at epoch {start_epoch}', flush=True)
    if args.start_epoch >= 0:
        start_epoch = args.start_epoch

    # trace the second epoch run, past the first one's warm-up; with one
    # epoch to run, trace that one
    trace_iter = 1 if args.epochs - start_epoch >= 2 else 0
    guard = DivergenceGuard()
    best = BestTracker()
    backoffs = 0
    last_good_epoch = start_epoch

    t_start = time.time()
    epoch = start_epoch
    i = -1
    while epoch < args.epochs:
        epoch += 1
        i += 1
        t0 = time.time()
        tracing = trace(args.trace_dir) if (args.trace_dir and i == trace_iter) \
            else contextlib.nullcontext()
        enc_loss = dec_loss = 0.0
        with tracing:
            for _ in range(cfg.num_train_enc):
                enc_loss = trainer.train_epoch(epoch, 'encoder', verbose=False)
            for _ in range(cfg.num_train_dec):
                dec_loss = trainer.train_epoch(epoch, 'decoder', verbose=False)
        dt = time.time() - t0
        blocks = cfg.num_block * (cfg.num_train_enc + cfg.num_train_dec)
        print(f'epoch {epoch}: enc_loss {enc_loss:.6f} dec_loss {dec_loss:.6f} '
              f'{dt:.1f}s ({blocks / dt:.0f} blk/s)', flush=True)
        metrics.log('epoch', epoch=epoch, enc_loss=enc_loss, dec_loss=dec_loss, seconds=dt)

        losses = {'enc': enc_loss, 'dec': dec_loss}
        if cfg.num_train_enc == 0:
            losses.pop('enc')
        if guard.check(losses):
            backoffs += 1
            if backoffs > args.max_backoffs:
                print(f'DIVERGED at epoch {epoch}: losses {losses}; backoff '
                      f'limit ({args.max_backoffs}) exhausted, stopping', flush=True)
                metrics.log('diverged', epoch=epoch, action='abort', **losses)
                break
            lrs = backoff_lrs(lrs)
            print(f'DIVERGED at epoch {epoch}: losses {losses}; reloading '
                  f'epoch-{last_good_epoch} checkpoint with lrs {lrs}', flush=True)
            metrics.log('diverged', epoch=epoch, action='backoff', lrs=lrs,
                        reload_epoch=last_good_epoch, **losses)
            cfg = build_cfg(lrs['enc'], lrs['dec'])
            trainer = Trainer(cfg, device)
            if os.path.exists(args.ckpt) and last_good_epoch > start_epoch:
                trainer.params = load_checkpoint(args.ckpt, trainer.params)
            elif args.resume and os.path.exists(args.resume):
                trainer.params = load_checkpoint(args.resume, trainer.params)
            guard.reset()
            epoch = last_good_epoch
            continue

        if epoch % args.val_every == 0:
            bce, ber = trainer.validate(verbose=False)
            print(f'  validate: bce {bce:.6f} ber {ber:.6f}', flush=True)
            metrics.log('validate', epoch=epoch, bce=bce, ber=ber)
            if best.update(ber, epoch):
                save_checkpoint(args.ckpt + '.best', trainer.params, trainer.opt_state,
                                step=epoch)
                metrics.log('best', epoch=epoch, ber=ber, path=args.ckpt + '.best')

        if args.test_every and epoch % args.test_every == 0:
            # the count-based sweep (no punctured pass)
            interval = (cfg.snr_test_end - cfg.snr_test_start) / max(1, cfg.snr_points - 1)
            snrs = [cfg.snr_test_start + interval * j for j in range(cfg.snr_points)]
            r = sweep(trainer.params, cfg, snrs, num_block=args.test_num_block,
                      device=device, generator=trainer.generator)
            print(f'  test@{epoch}: ber {["%.3g" % b for b in r["ber"]]}', flush=True)
            metrics.log('test', epoch=epoch, snrs=snrs, ber=r['ber'], bler=r['bler'],
                        bit_errors=r['bit_errors'], blk_errors=r['blk_errors'])
            save_checkpoint(f'{args.ckpt}.e{epoch}', trainer.params, trainer.opt_state,
                            step=epoch)

        if epoch % args.ckpt_every == 0 or epoch == args.epochs:
            save_checkpoint(args.ckpt, trainer.params, trainer.opt_state, step=epoch)
            metrics.log('checkpoint', epoch=epoch, path=args.ckpt)
            last_good_epoch = epoch

        if args.time_budget_s and time.time() - t_start > args.time_budget_s:
            print(f'time budget reached at epoch {epoch}; checkpointing and stopping',
                  flush=True)
            save_checkpoint(args.ckpt, trainer.params, trainer.opt_state, step=epoch)
            break

    # final quick test sweep at a reduced num_block for a progress snapshot
    trainer.cfg = cfg.replace(num_block=min(10000, args.num_block))
    snrs, ber, bler = trainer.test(verbose=True)
    metrics.log('test', snrs=snrs, ber=ber, bler=bler)
    metrics.close()
    return trainer


if __name__ == '__main__':
    main()
