"""One gloo rank of a time-sharded or 2-D mesh run of the PyTorch port, for
tests/test_torch_dist_time.py; it imports no JAX.

    python tests/_torch_dist_time_worker.py <inputs.pt> <out_prefix> N [M]

with MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE in the environment. A 1-D
mesh (N,) runs `run_time` with shard_axis 'time'; a 2-D mesh (N, M) runs
`run_2d`, which shards the batch over the data axis. The results go to
<out_prefix><rank>.pt. The test runs the same functions with mesh None in
its own process: the single-process run that the ranks must equal."""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import _torch_dist_worker as W  # noqa: E402
from turboae_tpu_torch.config import Config  # noqa: E402
from turboae_tpu_torch.dist import mesh as dm  # noqa: E402
from turboae_tpu_torch.models.channel_ae import forward_ae, make_perms  # noqa: E402
from turboae_tpu_torch.train.trainer import Trainer  # noqa: E402
from turboae_tpu_torch.utils.device import no_tf32  # noqa: E402

torch.set_num_threads(1)

TIME = {'shard_axis': 'time'}
# every key of the JAX package's encoder and decoder registries (and
# DeepTurbo's two turbo encoders), each in one pair: (encoder, decoder, extra)
PAIRS = {
    'cnn': ('TurboAE_rate3_cnn', 'TurboAE_rate3_cnn', {}),
    'cnn_dense': ('TurboAE_rate3_cnn_dense', 'TurboAE_rate3_cnn_dense', {}),
    'rnn': ('Turboae_rate3_rnn', 'TurboAE_rate3_rnn', {'dropout': 0.3}),
    'rnn_sys': ('TurboAE_rate3_rnn_sys', 'TurboAE_rate3_rnn', {'enc_rnn': 'lstm'}),
    'rate2_rnn': ('TurboAE_rate2_rnn', 'TurboAE_rate2_rnn', {'code_rate_n': 2}),
    'rate2_cnn': ('TurboAE_rate2_cnn', 'TurboAE_rate2_cnn', {'code_rate_n': 2}),
    'rate3_cnn': ('rate3_cnn', 'rate3_cnn', {}),
    'rate2_cnn_noint': ('rate2_cnn', 'rate3_cnn', {'code_rate_n': 2}),
    '2int': ('turboae_2int', 'turboae_2int', {}),
    'cnn_2inter': ('turboae_2int', 'TurboAE_rate3_cnn_2inter', {}),
    'nbcjr': ('Turboae_rate3_rnn', 'nbcjr_rate3', {}),
    'cnn2d': ('TurboAE_rate3_cnn2d', 'TurboAE_rate3_cnn2d', {'img_size': 4}),
    'cnn2d_dense': ('TurboAE_rate3_cnn2d_dense', 'TurboAE_rate3_cnn2d_dense', {'img_size': 4}),
    'rate3_cnn2d': ('rate3_cnn2d', 'rate3_cnn2d', {'img_size': 4}),
    'turbo757': ('Turbo_rate3_757', 'TurboAE_rate3_cnn', {}),
    'turbo_lte': ('Turbo_rate3_lte', 'TurboAE_rate3_cnn', {}),
}
# a long block whose halo windows are cut at the ranks' edges: L = 1000
LONG = dict(W.SMALL, batch_size=4, block_len=1000, num_block=4)


def pair_cfg(key, **common):
    enc, dec, extra = PAIRS[key]
    return Config(**W.SMALL, encoder=enc, decoder=dec, **extra, **common)


def _grads(grads):
    return {h: [g.cpu() for g in gs] for h, gs in grads.items()}


def registry(inputs, mesh, device, **common):
    """A joint loss_and_grads of every pair from its seeded init on the
    host-drawn batch inputs['zoo'][key], in training (dropout drawn)."""
    out = {}
    for key in PAIRS:
        tr = Trainer(pair_cfg(key, **common), device, mesh=mesh)
        bits, noise = inputs['zoo'][key]
        loss, grads = tr.loss_and_grads('joint', bits.to(device), noise.to(device))
        out[key] = {'loss': float(loss), 'grads': _grads(grads)}
    return out


def long_block(inputs, mesh, device, **common):
    """At L = 1000: the f32 joint loss_and_grads on a host-drawn batch, and
    the bf16 forward through the fused decoder stacks (this rank's positions
    of its output)."""
    bits, noise = (t.to(device) for t in inputs['long'])
    tr = Trainer(Config(**LONG, **common), device, mesh=mesh)
    loss, grads = tr.loss_and_grads('joint', bits, noise)
    fused = Config(**LONG, dtype='bfloat16', use_fused_conv=True, **common)
    with dm.active(tr.mesh), torch.inference_mode():
        out = forward_ae(tr.params, fused, *tr._rows(bits, noise), make_perms(fused, device),
                         training=False)[0]
    return {'loss': float(loss), 'grads': _grads(grads), 'fused_out': out.float().cpu()}


def run_time(inputs, mesh, device='cpu'):
    """Every part under shard_axis 'time' (FTAE and the mod AE shard the
    batch whatever it says)."""
    return {'epochs': W.epochs(mesh, device, **TIME),
            'losses': W.losses(inputs, mesh, device, **TIME),
            'jax': W.jax_inputs(inputs, mesh, device, **TIME),
            'sweep': W.sweeps(inputs, mesh, device, **TIME),
            'registry': registry(inputs, mesh, device, **TIME),
            'long': long_block(inputs, mesh, device, **TIME),
            'ftae': W.ftae(mesh, device, **TIME),
            'mod': W.mod(mesh, device, pcs=('symbol_power',), **TIME)}


def run_2d(inputs, mesh, device='cpu'):
    """The batch sharded over the data axis of a 2-D mesh."""
    return {'epochs': W.epochs(mesh, device, names=('awgn', 'rnn_dropout')),
            'losses': W.losses(inputs, mesh, device),
            'jax': W.jax_inputs(inputs, mesh, device),
            'sweep': W.sweeps(inputs, mesh, device, channels=('awgn',))}


def main():
    inputs_path, prefix, *shape = sys.argv[1:]
    shape = tuple(int(s) for s in shape)
    rank, world = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
    no_tf32()
    dm.initialize_distributed('env://', world, rank, 'gloo')
    mesh = dm.make_mesh(shape, torch.device('cpu'))
    inputs = torch.load(inputs_path)
    out = run_time(inputs, mesh) if len(shape) == 1 else run_2d(inputs, mesh)
    out['mesh'] = {'size': mesh.size, 'rank': mesh.rank, 'data': mesh.data,
                   'model': mesh.model, 'shape': list(mesh.shape)}
    torch.save(out, f'{prefix}{rank}.pt')
    torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main()
