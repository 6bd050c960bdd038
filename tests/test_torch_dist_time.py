"""Time-axis (sequence-parallel) sharding and 2-D meshes of the PyTorch port
(dist/mesh.py) on the CPU, beside tests/test_torch_dist.py and with its
tolerances: two gloo ranks under shard_axis 'time', and a (2, 2) mesh over
four gloo ranks, each rank its own process (tests/_torch_dist_time_worker.py,
no JAX in it), spawned once a world, against the single process with the
same seed and against JAX's time-sharded 8-device and (4, 2) meshes on the
same inputs.

Tolerances (tests/test_torch_dist.py): losses to 1e-5 relative; params after
the epochs to rtol 1e-4 / atol 1e-5; gradients per leaf to 1e-5 of the
leaf's largest, or to twice the single process's own reordering noise (the
same loss on the batch's rows reordered three ways, and summed from the two
halves of the positions as two time-sharded ranks sum it, the largest) where
that is larger; counts equal but
for outputs within 1e-5 of 0.5. The fused bf16 forward at L = 1000 (the
plain K2 version on the CPU) to KERNEL_REL_TOL of its largest output: the
power constraint's global sums, reordered, can move a code across a bf16
rounding."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_dist_time_worker as T
import _torch_dist_worker as W
from test_torch_dist import (GRAD_RTOL, LOSS_RTOL, assert_params_close, jax_case, leaf_rel,
                             spawn_ranks)
from turboae_tpu.config import Config as JaxConfig
from turboae_tpu.dist.mesh import data_sharding
from turboae_tpu.dist.mesh import make_mesh as jax_make_mesh
from turboae_tpu.models.decoders import DEC_REGISTRY as JAX_DEC
from turboae_tpu.models.encoders import ENC_REGISTRY as JAX_ENC
from turboae_tpu.train.trainer import Trainer as JaxTrainer
from turboae_tpu_torch.config import Config
from turboae_tpu_torch.dist import mesh as dm
from turboae_tpu_torch.models.channel_ae import forward_ae
from turboae_tpu_torch.train.convert import from_jax, to_jax
from turboae_tpu_torch.train.losses import customized_loss
from turboae_tpu_torch.train.trainer import Trainer
from turboae_tpu_torch.utils.tree import tree_unflatten

from _torch_parity import ROOT

WORKER = f'{ROOT}/tests/_torch_dist_time_worker.py'
KERNEL_REL_TOL = 1e-2       # bf16 (tests/test_kernels.py:33-41)


def _batch(rng, b, length, n):
    return (torch.from_numpy((rng.random_sample((b, length, 1)) < 0.5).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((b, length, n)).astype(np.float32)))


@pytest.fixture(scope='module')
def inputs():
    """Host-drawn batches and JAX-made params, shared by both worlds."""
    from turboae_tpu.models.channel_ae import init_ae as jax_init_ae
    rng = np.random.RandomState(0)
    bits, noise = _batch(rng, 16, 16, 3)
    _, jp, jbits, jnoise = jax_case()
    return {'bits': bits, 'noise': noise,
            'params': from_jax(jax.tree.map(np.asarray, jax_init_ae(jax.random.PRNGKey(1),
                                                                    JaxConfig(**W.SMALL)))),
            'jax': {'cfg': W.SMALL, 'params': from_jax(jp), 'bits': torch.from_numpy(jbits),
                    'noise': torch.from_numpy(jnoise)},
            'zoo': {k: _batch(rng, 16, 16, T.pair_cfg(k).code_rate_n) for k in T.PAIRS},
            'long': _batch(rng, 4, 1000, 3)}


def _spawn(inputs, tmp_path_factory, shape):
    d = tmp_path_factory.mktemp('dist_' + '_'.join(map(str, shape)))
    torch.save(inputs, d / 'inputs.pt')
    world = int(np.prod(shape))
    spawn_ranks([WORKER, str(d / 'inputs.pt'), str(d / 'out'), *map(str, shape)], world, str(d))
    return [torch.load(d / f'out{r}.pt') for r in range(world)]


@pytest.fixture(scope='module')
def time_runs(inputs, tmp_path_factory):
    """(the single process's results, [rank 0's, rank 1's]) under 'time'."""
    return T.run_time(inputs, None), _spawn(inputs, tmp_path_factory, (2,))


@pytest.fixture(scope='module')
def mesh2d_runs(inputs, tmp_path_factory):
    """(the single process's results, the four ranks') on a (2, 2) mesh."""
    return T.run_2d(inputs, None), _spawn(inputs, tmp_path_factory, (2, 2))


def _split_grads(cfg, params, bits, noise):
    """The joint BCE gradients of one process summed from the two halves of
    the block's positions, each half's share of the loss differentiated on
    its own: the split of the sums over positions that two time-sharded
    ranks make."""
    tr = Trainer(cfg, 'cpu', params=params)
    leaves = tr._leaves['enc'] + tr._leaves['dec']
    for p in leaves:
        p.requires_grad_(True)
    out, code, _ = forward_ae(tr.params, cfg, bits, noise, tr.perms, training=True,
                              generator=tr.generator)
    out = torch.clamp(out, 0.0, 1.0)
    n = bits.shape[1]
    parts = [customized_loss(out[:, a:e], bits[:, a:e], cfg) * ((e - a) / n)
             for a, e in ((0, n // 2), (n // 2, n))]
    grads = [sum(gs) for gs in zip(*(torch.autograd.grad(p, leaves, retain_graph=True,
                                                         materialize_grads=True)
                                     for p in parts))]
    k = len(tr._leaves['enc'])
    return {'enc': grads[:k], 'dec': grads[k:]}


def _noise_floor(cfg, params, bits, noise):
    """The single process's own f32 noise: its joint gradients on the
    row-reversed, the half-rotated and a seeded row-permuted batch (the same
    loss; without dropout, whose masks would not follow the rows) and, for
    BCE, summed from the two halves of the positions (_split_grads), each
    against the batch as it is, the largest per half: each reordering is one
    sample of that noise."""
    b = bits.shape[0]
    cfg = cfg.replace(dropout=0.0)
    orders = (torch.arange(b), torch.arange(b - 1, -1, -1), torch.arange(b).roll(b // 2),
              torch.randperm(b, generator=torch.Generator().manual_seed(3)))
    runs = [Trainer(cfg, 'cpu', params=params).loss_and_grads('joint', bits[o], noise[o])[1]
            for o in orders]
    if cfg.loss == 'bce':
        runs.append(_split_grads(cfg, params, bits, noise))
    return {h: max(leaf_rel(r[h], runs[0][h]) for r in runs[1:]) if runs[0][h] else 0.0
            for h in runs[0]}


def _assert_counts_close(g, r):
    """Sweep counts equal, but for blocks with an output within NEAR of 0.5."""
    assert (g['n_bits'], g['n_blocks']) == (r['n_bits'], r['n_blocks']) == (2 * 32 * 16, 2 * 32)
    if (g['bit_errors'], g['blk_errors'], g['pos_errors']) != \
            (r['bit_errors'], r['blk_errors'], r['pos_errors']):
        near = g['near'] + r['near']
        assert all(abs(a - b) <= near for a, b in zip(g['blk_errors'], r['blk_errors']))
        assert all(abs(a - b) <= 16 * near for a, b in zip(g['bit_errors'], r['bit_errors']))


def _assert_loss_grads_close(got, ref, floor):
    assert abs(got['loss'] - ref['loss']) <= LOSS_RTOL * abs(ref['loss'])
    for h, grads in ref['grads'].items():
        assert all(bool(torch.isfinite(g).all()) for g in got['grads'][h])
        if not grads:
            continue
        bound = max(GRAD_RTOL, 2 * floor[h])
        assert leaf_rel(got['grads'][h], grads) <= bound, (h, bound)


# ---------------------------------------------------------------- the mesh, in one process
def test_time_share_and_halo_semantics():
    """The share of a rank along time, and its halo window's bounds."""
    mesh = dm.Mesh(size=2, rank=1, device=torch.device('cpu'), backend='gloo', group=None,
                   shape=(2,), shard_axis='time')
    x = torch.arange(2 * 6 * 3).reshape(2, 6, 3)
    assert torch.equal(dm.shard_rows(x, mesh), x[:, 3:])
    with pytest.raises(ValueError, match='7 positions do not split over 2 ranks'):
        dm.shard_rows(torch.zeros(2, 7, 1), mesh)
    with dm.active(mesh):
        assert dm.time_sharded() and dm.time_slice(3) == (3, 6) and dm.world() == 2
        drawn = dm.rows(lambda s: torch.arange(s[0] * s[1]).reshape(s), (2, 3))
    assert torch.equal(drawn, torch.arange(12).reshape(2, 6)[:, 3:])
    assert dm.time_slice(3) == (0, 3) and not dm.time_sharded()
    assert dm.halo_apply(lambda t: t * 2, x, 4).equal(x * 2)        # no mesh: fn itself
    assert dm.gather_time(x) is x
    assert dm.along(mesh, 'batch').axis == 0 and dm.along(None, 'time') is None
    with pytest.raises(ValueError, match='shard_axis'):
        dm.along(mesh, 'model')


def test_block_len_that_n_does_not_divide_raises():
    mesh = dm.Mesh(size=2, rank=0, device=torch.device('cpu'), backend='gloo', group=None)
    with pytest.raises(ValueError, match='block_len 15 does not split over 2 ranks'):
        Trainer(Config(**{**W.SMALL, 'block_len': 15}, shard_axis='time'), 'cpu', mesh=mesh)
    # the batch axis is not checked under 'time', nor time under 'batch'
    Trainer(Config(**{**W.SMALL, 'batch_size': 15}, shard_axis='time'), 'cpu', mesh=mesh)
    Trainer(Config(**{**W.SMALL, 'block_len': 15}), 'cpu', mesh=mesh)


def test_the_pairs_cover_every_jax_registry_key():
    encs = {e for e, _, _ in T.PAIRS.values()}
    decs = {d for _, d, _ in T.PAIRS.values()}
    assert set(JAX_ENC) | {'Turbo_rate3_757', 'Turbo_rate3_lte'} <= encs
    assert set(JAX_DEC) <= decs


# ---------------------------------------------------------------- two ranks under 'time'
def test_time_both_ranks_hold_the_same_results(time_runs):
    _, (r0, r1) = time_runs
    assert r0['mesh'] == {'size': 2, 'rank': 0, 'data': 0, 'model': 0, 'shape': [2]}
    assert r1['mesh']['data'] == 1
    for name in W.EPOCHS:
        assert r0['epochs'][name]['losses'] == r1['epochs'][name]['losses']
        assert all(torch.equal(a, b) for a, b in zip(r0['epochs'][name]['params'],
                                                      r1['epochs'][name]['params']))
    assert r0['sweep'] == r1['sweep']


@pytest.mark.parametrize('name', list(W.EPOCHS))
def test_time_epoch_two_ranks_equal_one(time_runs, name):
    """A decoder and an encoder epoch, validate, test (its punctured pass
    reads the positional BER gathered along time) and the encoder power,
    under 'time': fading's gain and the dropout masks drawn at the global
    shape, each rank keeping its positions."""
    ref, (got, _) = time_runs
    g, r = got['epochs'][name], ref['epochs'][name]
    for a, b in zip(g['losses'], r['losses']):
        assert abs(a - b) <= LOSS_RTOL * abs(b)
    assert_params_close(g['params'], r['params'])
    np.testing.assert_allclose(g['val'], r['val'], rtol=LOSS_RTOL)
    assert g['test'] == r['test']
    assert abs(g['enc_power'] - r['enc_power']) < 1e-6


@pytest.mark.parametrize('name', W.LOSSES)
def test_time_each_loss_two_ranks_equal_one(time_runs, inputs, name):
    """The positional means are local under 'time'; maxBCE's max, sortBCE's
    top 5 and bce_block's max over a block span the ranks."""
    ref, (got, _) = time_runs
    floor = _noise_floor(Config(**W.SMALL, loss=name), inputs['params'], inputs['bits'],
                         inputs['noise'])
    _assert_loss_grads_close(got['losses'][name], ref['losses'][name], floor)


@pytest.mark.parametrize('channel', ['awgn', 'fading'])
def test_time_sweep_counts_two_ranks_equal_one(time_runs, channel):
    """Positional counts gathered along time; a block's error an OR over
    the ranks."""
    ref, (got, _) = time_runs
    _assert_counts_close(got['sweep'][channel], ref['sweep'][channel])


@pytest.mark.parametrize('key', list(T.PAIRS))
def test_time_registry_key_steps(time_runs, inputs, key):
    """Every registry key's joint step under 'time' equals 1 rank: the CNN
    stacks over halo windows, the biRNNs, the 2D codes and the turbo
    encoder on the whole block (dist/mesh.py:whole_time)."""
    ref, (got, _) = time_runs
    cfg = T.pair_cfg(key)
    floor = _noise_floor(cfg, Trainer(cfg, 'cpu').params, *inputs['zoo'][key])
    _assert_loss_grads_close(got['registry'][key], ref['registry'][key], floor)


def test_time_long_block_windows_cut_at_rank_edges(time_runs, inputs):
    """L = 1000 on two ranks: each rank's stacks run on [0, 504) and
    [496, 1000), whose cut edges fall inside the other rank's positions; the
    f32 step equals 1 rank, and the fused bf16 forward (K2's plain version
    here) equals it to bf16's tolerance."""
    ref, ranks = time_runs
    cfg = Config(**T.LONG)
    floor = _noise_floor(cfg, Trainer(cfg, 'cpu').params, *inputs['long'])
    _assert_loss_grads_close(ranks[0]['long'], ref['long'], floor)
    out = torch.cat([r['long']['fused_out'] for r in ranks], dim=1)
    want = ref['long']['fused_out']
    assert out.shape == want.shape == (4, 1000, 1)
    assert (out - want).abs().max() <= KERNEL_REL_TOL * want.abs().max()


def test_time_ftae_and_mod_shard_the_batch(time_runs):
    """FTAETrainer and ModTrainer shard the batch whatever shard_axis says,
    as JAX's trainers constrain P('data') there."""
    ref, (got, _) = time_runs
    for a, b in zip(got['ftae']['losses'], ref['ftae']['losses']):
        assert abs(a - b) <= LOSS_RTOL * abs(b)
    assert_params_close(got['ftae']['params'], ref['ftae']['params'])
    assert got['ftae']['counts'] == ref['ftae']['counts']
    g, r = got['mod']['symbol_power'], ref['mod']['symbol_power']
    for a, b in zip(g['losses'], r['losses']):
        assert abs(a - b) <= LOSS_RTOL * abs(b)
    assert_params_close(g['params'], r['params'])
    assert g['test'] == r['test']


def _jax_loss_and_grads(jcfg, mesh, spec, mode):
    """JAX's Trainer on `mesh`, bits and noise under NamedSharding(mesh,
    spec): the loss and the gradients of `mode`'s halves."""
    _, jp, bits, noise = jax_case()
    jt = JaxTrainer(jcfg, mesh=mesh)
    par = jax.tree.map(jnp.asarray, jp)
    b, n = (jax.device_put(x, NamedSharding(mesh, spec)) for x in (bits, noise))
    key = jax.random.PRNGKey(0)
    with jax.default_matmul_precision('highest'):
        if mode == 'joint':
            return jax.value_and_grad(jt._loss)(par, None, lambda d, f: d, key, b, n)
        h, o = ('enc', 'dec') if mode == 'encoder' else ('dec', 'enc')
        loss, g = jax.value_and_grad(jt._loss)(par[h], par[o], lambda d, f: {h: d, o: f},
                                               key, b, n)
        return loss, {h: g}


def _assert_equals_jax(res, port, loss, g):
    assert abs(res['loss'] - float(loss)) <= LOSS_RTOL * abs(float(loss))
    for h, grads in res['grads'].items():
        tree = {k: port[k] for k in ('enc', 'dec')}
        tree[h] = tree_unflatten(port[h], grads)
        for a, r in zip(jax.tree.leaves(to_jax(tree)[h]), jax.tree.leaves(g[h]), strict=True):
            r = np.asarray(r)
            assert np.abs(a - r).max() <= GRAD_RTOL * np.abs(r).max(), h


@pytest.mark.parametrize('mode', ['encoder', 'decoder', 'joint'])
def test_port_time_two_ranks_equal_jax_eight_devices(time_runs, inputs, mode):
    """JAX's Trainer(Config(shard_axis='time'), mesh=make_mesh((8,))), bits
    and noise under P(None, 'data'), against the port's two time-sharded
    ranks on the same batch and params."""
    _, (got, _) = time_runs
    mesh = jax_make_mesh((8,))
    loss, g = _jax_loss_and_grads(JaxConfig(**W.SMALL, shard_axis='time'), mesh,
                                  P(None, 'data'), mode)
    _assert_equals_jax(got['jax'][mode], inputs['jax']['params'], loss, g)


# ---------------------------------------------------------------- a (2, 2) mesh
def test_2d_replicas_are_bit_equal(mesh2d_runs):
    """The two ranks of each data index hold the same results bit for bit,
    and every rank reports the global batch's."""
    _, ranks = mesh2d_runs
    assert [(r['mesh']['data'], r['mesh']['model']) for r in ranks] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r['mesh']['size'] == 2 and r['mesh']['shape'] == [2, 2] for r in ranks)

    def equal(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
        return a == b
    strip = [{k: v for k, v in r.items() if k != 'mesh'} for r in ranks]
    assert equal(strip[0], strip[1]) and equal(strip[2], strip[3])
    assert strip[0]['epochs']['awgn']['losses'] == strip[2]['epochs']['awgn']['losses']


@pytest.mark.parametrize('name', ['awgn', 'rnn_dropout'])
def test_2d_epoch_equals_one(mesh2d_runs, name):
    ref, (got, *_) = mesh2d_runs
    g, r = got['epochs'][name], ref['epochs'][name]
    for a, b in zip(g['losses'], r['losses']):
        assert abs(a - b) <= LOSS_RTOL * abs(b)
    assert_params_close(g['params'], r['params'])
    assert g['test'] == r['test']
    _assert_counts_close(got['sweep']['awgn'], ref['sweep']['awgn'])


@pytest.mark.parametrize('name', W.LOSSES)
def test_2d_each_loss_equals_one(mesh2d_runs, inputs, name):
    ref, (got, *_) = mesh2d_runs
    floor = _noise_floor(Config(**W.SMALL, loss=name), inputs['params'], inputs['bits'],
                         inputs['noise'])
    _assert_loss_grads_close(got['losses'][name], ref['losses'][name], floor)


@pytest.mark.parametrize('mode', ['encoder', 'decoder', 'joint'])
def test_port_2x2_equals_jax_4x2(mesh2d_runs, inputs, mode):
    """JAX's make_mesh((4, 2)) ('data', 'model'), the batch under P('data'),
    against the port's (2, 2) mesh on the same batch and params."""
    _, (got, *_) = mesh2d_runs
    mesh = jax_make_mesh((4, 2), ('data', 'model'))
    assert data_sharding(mesh).spec == P('data')
    loss, g = _jax_loss_and_grads(JaxConfig(**W.SMALL), mesh, P('data'), mode)
    _assert_equals_jax(got['jax'][mode], inputs['jax']['params'], loss, g)


# ---------------------------------------------------------------- the CLIs under torchrun
CLI_CASES = {'main_time': ('main', ['-mesh_shape', '2', '-shard_axis', 'time'], 2),
             'main_2x2': ('main', ['-mesh_shape', '2', '2'], 4),
             'ftae_main_time': ('ftae_main', ['-mesh_shape', '2', '-shard_axis', 'time'], 2),
             'main_modulation_time': ('main_modulation',
                                      ['-mesh_shape', '2', '-shard_axis', 'time'], 2)}


@pytest.mark.parametrize('case', list(CLI_CASES))
def test_cli_under_torchrun_equals_one_rank(tmp_path, monkeypatch, case):
    """torchrun with -shard_axis time or a 2-D -mesh_shape, --device cpu:
    rank 0 alone writes the checkpoint, the file of the 1-rank run with the
    same seed (keys equal, values to the sharded tolerance). FTAE and the mod
    AE shard the batch whatever -shard_axis says."""
    import importlib
    import os
    import subprocess
    import sys

    from test_torch_dist import TINY, _flat, free_port, run_procs
    from turboae_tpu_torch.train.msgpack_io import load_msgpack
    cli, mesh_args, nproc = CLI_CASES[case]
    many, one = tmp_path / 'many', tmp_path / 'one'
    many.mkdir()
    one.mkdir()
    proc = subprocess.Popen([sys.executable, '-m', 'torch.distributed.run', '--nproc_per_node',
                             str(nproc), '--master_port', str(free_port()), '-m',
                             f'turboae_tpu_torch.cli.{cli}', *mesh_args, *TINY],
                            cwd=many, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT,
                            env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1'))
    run_procs([proc])
    monkeypatch.chdir(one)
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    importlib.import_module(f'turboae_tpu_torch.cli.{cli}').main(TINY)
    (got,), (ref,) = ([load_msgpack(str(p)) for p in (d / 'tmp').iterdir()] for d in (many, one))
    flat_got, flat_ref = _flat(got), _flat(ref)
    assert flat_got.keys() == flat_ref.keys()
    for k, v in flat_ref.items():
        np.testing.assert_allclose(flat_got[k], v, rtol=1e-4, atol=1e-5, err_msg=k)


def test_bench_train_under_torchrun_takes_time_and_2d(tmp_path):
    """cli/bench_train.py's --mesh_shape takes one or two ints and
    --shard_axis time; rank 0 prints one JSON line naming them."""
    import json
    import os
    import subprocess
    import sys

    from test_torch_dist import free_port, run_procs
    procs = [subprocess.Popen([sys.executable, '-m', 'torch.distributed.run', '--nproc_per_node',
                               str(n), '--master_port', str(free_port()), '-m',
                               'turboae_tpu_torch.cli.bench_train', '--device', 'cpu',
                               '--mesh_shape', *shape, '--shard_axis', axis, '--steps', '2',
                               '--batch_size', '4'],
                              cwd=tmp_path, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL,
                              env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1'))
             for n, shape, axis in ((2, ['2'], 'time'), (4, ['2', '2'], 'batch'))]
    for out, (ranks, axis) in zip(run_procs(procs), ((2, 'time'), (4, 'batch'))):
        lines = [json.loads(x) for x in out.splitlines() if x.startswith('{')]
        assert len(lines) == 1
        assert (lines[0]['ranks'], lines[0]['shard_axis']) == (ranks, axis)
        assert np.isfinite(lines[0]['last_loss']) and lines[0]['mfu'] is None
