"""One gloo rank of a data-parallel run of the PyTorch port, for
tests/test_torch_dist.py (on the CPU) and tests/test_torch_gpu.py (two ranks
on one card); it imports no JAX.

    python tests/_torch_dist_worker.py <inputs.pt> <out_prefix>

with MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE in the environment, and
DIST_DEVICE (default cpu; cuda puts every rank on cuda:0). It runs
`run_all(inputs, mesh, device)` and saves the results to <out_prefix><rank>.pt.
The test runs the same function with mesh None in its own process: the
single-process run that the ranks must equal."""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from turboae_tpu_torch.config import Config  # noqa: E402
from turboae_tpu_torch.dist import mesh as dm  # noqa: E402
from turboae_tpu_torch.train import sweep as sweep_mod  # noqa: E402
from turboae_tpu_torch.train.ftae_trainer import FTAETrainer  # noqa: E402
from turboae_tpu_torch.train.mod_trainer import ModTrainer  # noqa: E402
from turboae_tpu_torch.train.trainer import Trainer  # noqa: E402
from turboae_tpu_torch.utils.device import no_tf32  # noqa: E402
from turboae_tpu_torch.utils.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

# JAX's tests/test_dist.py SMALL, two steps an epoch
SMALL = dict(batch_size=16, block_len=16, enc_num_unit=8, dec_num_unit=8, enc_num_layer=2,
             dec_num_layer=2, num_iteration=2, num_iter_ft=3, num_block=32)
LOSSES = ('bce', 'soft_ber', 'bce_rl', 'enc_rl', 'bce_block', 'focal', 'mse', 'maxBCE',
          'sortBCE')
# the epochs: the flagship on AWGN, the fading channel (its gain drawn in the
# forward) and the RNN pair with dropout (its masks drawn in the forward)
EPOCHS = {'awgn': {},
          'fading': dict(channel='fading'),
          'rnn_dropout': dict(encoder='Turboae_rate3_rnn', decoder='TurboAE_rate3_rnn',
                              dropout=0.3),
          'norm_stats': dict(precompute_norm_stats=True)}
NEAR = 1e-5     # a decision this close to 0.5 may flip with the order of an f32 sum


def _flat(params):
    return [t.detach().cpu() for t in tree_leaves(params)]


def epochs(mesh, device, names=tuple(EPOCHS), **common):
    """The epochs `names` (EPOCHS), each config with the `common` fields."""
    out = {}
    for name in names:
        cfg = Config(**SMALL, snr_points=2, **EPOCHS[name], **common)
        tr = Trainer(cfg, device, mesh=mesh)
        losses = [tr.train_epoch(0, 'decoder', verbose=False),
                  tr.train_epoch(0, 'encoder', verbose=False)]
        bce, ber = tr.validate(verbose=False)
        _, test_ber, test_bler = tr.test(verbose=False)
        out[name] = {'losses': losses, 'params': _flat(tr.params), 'val': [bce, ber],
                     'test': [test_ber, test_bler], 'enc_power': tr.encoder_power(2)}
    return out


def losses(inputs, mesh, device, **common):
    """Each loss's joint loss_and_grads on the host-drawn batch."""
    out = {}
    for name in LOSSES:
        tr = Trainer(Config(**SMALL, loss=name, **common), device, params=inputs['params'],
                     mesh=mesh)
        loss, grads = tr.loss_and_grads('joint', inputs['bits'].to(device),
                                        inputs['noise'].to(device))
        out[name] = {'loss': float(loss), 'grads': {h: [g.cpu() for g in gs]
                                                    for h, gs in grads.items()}}
    return out


def jax_inputs(inputs, mesh, device, **common):
    """loss_and_grads of each mode on the batch and params the test made with
    the JAX package (converted), to be held against JAX's 8-device mesh."""
    j = inputs['jax']
    tr = Trainer(Config(**j['cfg'], **common), device, params=j['params'], mesh=mesh)
    out = {}
    for mode in ('encoder', 'decoder', 'joint'):
        loss, grads = tr.loss_and_grads(mode, j['bits'].to(device), j['noise'].to(device))
        out[mode] = {'loss': float(loss), 'grads': {h: [g.cpu() for g in gs]
                                                    for h, gs in grads.items()}}
    return out


def sweeps(inputs, mesh, device, channels=('awgn', 'fading'), **common):
    """sweep's exact counts, the crown-like params given, AWGN and fading;
    beside them the blocks of each run with an output within NEAR of 0.5."""
    near = []
    real = sweep_mod.error_counts

    def recording(bits, out):
        close = ((out.float() - 0.5).abs() < NEAR).reshape(out.shape[0], -1).any(dim=1)
        near.append(int(dm.all_reduce(close.sum())))
        return real(bits, out)
    sweep_mod.error_counts = recording
    try:
        out = {}
        for channel in channels:
            cfg = Config(**SMALL, channel=channel, **common)
            del near[:]
            res = sweep_mod.sweep(inputs['params'], cfg, [-1.0, 1.0], num_block=64,
                                  device=device, mesh=mesh)
            out[channel] = {k: res[k] for k in ('bit_errors', 'blk_errors', 'pos_errors',
                                                'n_bits', 'n_blocks')}
            out[channel]['near'] = sum(near)
    finally:
        sweep_mod.error_counts = real
    return out


def ftae(mesh, device, **common):
    cfg = Config(**SMALL, ftae_power_alloc='pos_phase', dec_type='turboae_cnn', **common)
    tr = FTAETrainer(cfg, device, mesh=mesh)
    losses = [float(tr._train_step('encoder')), float(tr._train_step('decoder'))]
    res = tr.sweep([0.0], num_block=32, verbose=False)
    return {'losses': losses, 'params': _flat(tr.params),
            'counts': [res['bit_errors'], res['blk_errors']]}


def mod(mesh, device, pcs=('symbol_power', 'qpsk'), **common):
    out = {}
    for pc in pcs:
        cfg = Config(**SMALL, mod_rate=2, mod_pc=pc, snr_points=1, **common)
        tr = ModTrainer(cfg, device, mesh=mesh)
        losses = [float(tr._train_step(ph)) for ph in ('encoder', 'decoder', 'mod', 'demod')]
        _, ber, bler = tr.test(verbose=False)
        out[pc] = {'losses': losses, 'params': _flat(tr.params), 'test': [ber, bler]}
    return out


def graph_under_gloo(mesh, device):
    """steps_per_call > 1 under a gloo mesh raises, before any step."""
    tr = Trainer(Config(**SMALL, steps_per_call=2), device, mesh=mesh)
    try:
        tr.train_epoch(0, 'decoder', verbose=False)
    except RuntimeError as e:
        return str(e)
    return None


def run_all(inputs, mesh, device='cpu'):
    out = {'epochs': epochs(mesh, device), 'losses': losses(inputs, mesh, device),
           'jax': jax_inputs(inputs, mesh, device), 'sweep': sweeps(inputs, mesh, device),
           'ftae': ftae(mesh, device), 'mod': mod(mesh, device)}
    if mesh is not None:
        out['graph_under_gloo'] = graph_under_gloo(mesh, device)
    return out


def main():
    inputs_path, prefix = sys.argv[1:3]
    rank, world = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
    device = torch.device(os.environ.get('DIST_DEVICE', 'cpu'))
    no_tf32()                       # f32 means f32 on the card, as in the CLIs
    dm.initialize_distributed('env://', world, rank, 'gloo')
    mesh = dm.make_mesh((world,), device)
    out = run_all(torch.load(inputs_path), mesh, device)
    out['mesh'] = {'size': mesh.size, 'rank': mesh.rank, 'backend': mesh.backend,
                   'device': str(mesh.device)}
    torch.save(out, f'{prefix}{rank}.pt')
    torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main()
