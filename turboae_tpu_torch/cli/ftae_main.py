"""The FTAE experiment on the GPU (JAX: cli/ftae_main.py; reference
ftae_main.py:28-125).

Parses the reference's flags (config.py:get_args), starts from
`-init_nw_weight <file>` when given (the tolerant load), runs num_epoch
epochs of num_train_enc encoder and num_train_dec decoder epochs, saves
./tmp/ftae_model_<id>.msgpack (params and both optimizers' state, the JAX
package's layout) and ends with FTAETrainer.test. TF32 is off.

    python -m turboae_tpu_torch.cli.ftae_main -dec_type turboae_rnn -block_len 50

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
    from ..train.ftae_trainer import FTAETrainer
    trainer = FTAETrainer(cfg, device, mesh=mesh)
    print(cfg)
    if cfg.init_nw_weight != 'default':
        trainer.params = load_checkpoint(cfg.init_nw_weight, trainer.params)
        print('loaded weights from', cfg.init_nw_weight)

    for epoch in range(1, cfg.num_epoch + 1):
        for _ in range(cfg.num_train_enc):
            trainer.train_epoch(epoch, 'encoder')
        for _ in range(cfg.num_train_dec):
            trainer.train_epoch(epoch, 'decoder')

    if cfg.num_epoch > 0 and (mesh is None or mesh.rank == 0):
        os.makedirs('./tmp', exist_ok=True)
        ckpt = f'./tmp/ftae_model_{int(time.time()) % 1_000_000}.msgpack'
        save_checkpoint(ckpt, trainer.params, trainer.opt_state)
        print('saved model', ckpt)

    trainer.test()
    return trainer


if __name__ == '__main__':
    main()
