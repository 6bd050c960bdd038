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

`--device cpu` runs on the CPU; without it the CLI needs a GPU.

`-mesh_shape N` trains over N ranks, one process a rank, launched by
torchrun, which sets RANK, WORLD_SIZE and LOCAL_RANK:

    python -m torch.distributed.run --nproc_per_node N -m turboae_tpu_torch.cli.main \
        -mesh_shape N [-shard_axis time] [--device cpu] ...

NCCL with one card a rank (cuda:LOCAL_RANK), or gloo on the CPU under
`--device cpu`. `-shard_axis batch` (the default) splits the global batch
`-batch_size` over the N ranks; `-shard_axis time` splits every block's
`-block_len` positions (dist/mesh.py). N must divide the sharded length; the
run equals the 1-rank run with the same seed. `-mesh_shape N M` takes N * M
ranks: the data axis of N, and M replicas of each share (JAX's ('data',
'model') mesh, whose model axis shards nothing). Rank 0 alone writes the log
and the checkpoint, the file a 1-rank run writes.
"""
from __future__ import annotations

import argparse
import contextlib
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


def launch(cfg, device):
    """(device, mesh) of a run: (the device, None) without -mesh_shape;
    with it, this rank's device and the mesh over the torchrun job, sharding
    cfg.shard_axis, whose process group is joined here (NCCL, or gloo under
    --device cpu)."""
    import math

    from ..dist import mesh as dm
    from ..utils.device import resolve_device
    if cfg.shard_axis not in dm.AXES:
        raise ValueError(f'-shard_axis must be one of {dm.AXES}, got {cfg.shard_axis!r}')
    if not cfg.mesh_shape:
        return resolve_device(device), None
    if len(cfg.mesh_shape) > 2:
        raise ValueError(f'-mesh_shape {list(cfg.mesh_shape)}: at most two axes, '
                         '(data, model)')
    env = dm.launch_env()
    if env is None:
        raise RuntimeError('-mesh_shape needs one process a rank: launch with torchrun, '
                           'python -m torch.distributed.run --nproc_per_node N -m '
                           'turboae_tpu_torch.cli.main -mesh_shape N ...')
    rank, world, local = env
    need = math.prod(cfg.mesh_shape)
    if need != world:
        raise ValueError(f'-mesh_shape {" ".join(map(str, cfg.mesh_shape))} needs {need} ranks '
                         f'but torchrun started {world} ranks')
    cpu = str(device) == 'cpu'
    dm.initialize_distributed('env://', world, rank, 'gloo' if cpu else 'nccl')
    dev = resolve_device('cpu' if cpu else f'cuda:{local}')
    if not cpu:
        import torch
        torch.cuda.set_device(dev)
    return dev, dm.make_mesh(cfg.mesh_shape, dev, cfg.shard_axis)


@contextlib.contextmanager
def rank_zero_output(mesh, log_path=None):
    """Rank 0's stdout, teed to log_path when given; the other ranks print
    nothing. Leaves the process group when the block ends."""
    from ..utils.logging import Tee
    prev = sys.stdout
    if mesh is not None and mesh.rank != 0:
        sys.stdout = open(os.devnull, 'w')
    elif log_path:
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        sys.stdout = Tee(log_path)
    try:
        yield
    finally:
        out, sys.stdout = sys.stdout, prev
        if out is not prev:
            (out.log if hasattr(out, 'log') else out).close()
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def main(argv=None):
    cfg, device = parse(argv)
    from ..utils.device import no_tf32
    no_tf32()
    device, mesh = launch(cfg, device)

    # stdout tee to ./logs/<id>_log.txt (reference main.py:17-27,102-107)
    ident = str(int(time.time() % 1_000_000))
    with rank_zero_output(mesh, f'./logs/{ident}_log.txt'):
        return _run(cfg, ident, device, mesh)


def _run(cfg, ident, device, mesh=None):
    writer = mesh is None or mesh.rank == 0
    print('[ID]', ident)
    print(cfg)

    from ..train.checkpoint import load_checkpoint, save_checkpoint
    from ..train.trainer import Trainer
    from ..utils.logging import MetricsLogger
    metrics = MetricsLogger((cfg.log_jsonl or None) if writer else None)
    trainer = Trainer(cfg, device, mesh=mesh)

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

    if cfg.num_epoch > 0 and writer:
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
                    params=trainer.params, mesh=mesh).test()
    return trainer


if __name__ == '__main__':
    main()
