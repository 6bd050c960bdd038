"""The joint coding+modulation experiment on the GPU (JAX:
cli/main_modulation.py; reference main_modulation.py:98-279).

Parses the reference's flags (config.py:get_args), starts from
`-init_nw_weight <file>` when given (params only, the tolerant load, as in
JAX), runs num_epoch epochs of num_train_enc encoder, num_train_dec
decoder, num_train_mod modulator and num_train_demod demodulator epochs,
saves ./tmp/mod_model_<id>.msgpack (params and the four optimizers' state,
the JAX package's layout) and ends with ModTrainer.test. TF32 is off.

    python -m turboae_tpu_torch.cli.main_modulation -mod_rate 2 -mod_pc block_power

`--device cpu` runs on the CPU; without it the CLI needs a GPU.
`-mesh_shape N` (or `N M`) under torchrun trains over N (N * M) ranks, rank 0
writing the checkpoint, as cli/main.py says. The batch is sharded whatever
`-shard_axis` says, as in JAX.
"""
from __future__ import annotations

import os
import time

from .main import launch, parse, rank_zero_output


def main(argv=None):
    cfg, device = parse(argv)
    from ..utils.device import no_tf32
    no_tf32()
    device, mesh = launch(cfg, device)
    with rank_zero_output(mesh):
        return _run(cfg, device, mesh)


def _run(cfg, device, mesh):

    from ..train.checkpoint import load_checkpoint, save_checkpoint
    from ..train.mod_trainer import ModTrainer
    trainer = ModTrainer(cfg, device, mesh=mesh)
    print(cfg)
    if cfg.init_nw_weight != 'default':
        trainer.params = load_checkpoint(cfg.init_nw_weight, trainer.params)
        print('loaded weights from', cfg.init_nw_weight)

    for epoch in range(1, cfg.num_epoch + 1):
        for phase, count in (('encoder', cfg.num_train_enc), ('decoder', cfg.num_train_dec),
                             ('mod', cfg.num_train_mod), ('demod', cfg.num_train_demod)):
            for _ in range(count):
                trainer.train_epoch(epoch, phase)

    if cfg.num_epoch > 0 and (mesh is None or mesh.rank == 0):
        os.makedirs('./tmp', exist_ok=True)
        ckpt = f'./tmp/mod_model_{int(time.time()) % 1_000_000}.msgpack'
        save_checkpoint(ckpt, trainer.params, trainer.opt_state)
        print('saved model', ckpt)

    trainer.test()
    return trainer


if __name__ == '__main__':
    main()
