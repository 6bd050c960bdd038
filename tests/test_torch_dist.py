"""Data parallelism of the PyTorch port (dist/mesh.py) on the CPU: two gloo
ranks, each its own process (tests/_torch_dist_worker.py, no JAX in it),
against the single process with the same seed, at JAX's SMALL config
(tests/test_dist.py:13-15); and the port's two ranks against JAX's 8-device
mesh on the same inputs.

Tolerances. Epoch losses to 1e-5 relative; params after the epochs to JAX's
sharded tolerance, rtol 1e-4 / atol 1e-5 (tests/test_dist.py:37-39); sweep
and test counts equal, except for blocks with an output within 1e-5 of 0.5
(a reordered f32 sum may flip those). Gradients per leaf to 1e-5 of the
leaf's largest, or, where that is below what f32 can hold, to twice the
single process's own reordering noise: the encoder's leaves reach the loss
through the power constraint's whitening, whose gradient is a difference of
large sums, and the 1-rank run on the row-reversed batch (the same loss)
moves them by up to ~1e-5 of their largest itself. A gradient scaled by the
world size is off by 100 %."""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from turboae_tpu.config import Config as JaxConfig
from turboae_tpu.dist.mesh import data_sharding
from turboae_tpu.dist.mesh import make_mesh as jax_make_mesh
from turboae_tpu.models.channel_ae import init_ae as jax_init_ae
from turboae_tpu.train.trainer import Trainer as JaxTrainer
from turboae_tpu_torch.cli import ftae_main
from turboae_tpu_torch.cli import main as cli_main
from turboae_tpu_torch.config import Config
from turboae_tpu_torch.dist import mesh as dm
from turboae_tpu_torch.train.convert import from_jax, to_jax
from turboae_tpu_torch.train.msgpack_io import load_msgpack
from turboae_tpu_torch.train.trainer import Trainer
from turboae_tpu_torch.utils.tree import tree_unflatten

from _torch_parity import ROOT

WORKER = os.path.join(ROOT, 'tests', '_torch_dist_worker.py')
TIMEOUT = 300           # seconds a spawned run may take; ~10 s here
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
TINY = ['-num_epoch', '1', '-num_block', '32', '-batch_size', '16', '-block_len', '16',
        '-enc_num_unit', '8', '-dec_num_unit', '8', '-enc_num_layer', '2', '-dec_num_layer', '2',
        '-num_iteration', '2', '-snr_points', '2', '--device', 'cpu']


def free_port() -> int:
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_procs(procs):
    """Each process's output; kills all and fails when one runs past TIMEOUT
    or exits non-zero."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail('a rank timed out')
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def spawn_ranks(args, world, cwd):
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR='localhost', MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen([sys.executable, *args], cwd=cwd, env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return run_procs(procs)


def jax_case():
    """A batch drawn on the host and params from JAX's init, for both sides."""
    jcfg = JaxConfig(**W.SMALL)
    jp = jax.tree.map(np.asarray, jax_init_ae(jax.random.PRNGKey(2), jcfg))
    rng = np.random.RandomState(5)
    bits = (rng.random_sample((16, 16, 1)) < 0.5).astype(np.float32)
    noise = rng.standard_normal((16, 16, 3)).astype(np.float32)
    return jcfg, jp, bits, noise


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """(the single process's results, [rank 0's, rank 1's])."""
    d = tmp_path_factory.mktemp('dist')
    cfg = Config(**W.SMALL)
    rng = np.random.RandomState(0)
    _, jp, jbits, jnoise = jax_case()
    inputs = {'bits': torch.from_numpy((rng.random_sample((16, 16, 1)) < 0.5).astype(np.float32)),
              'noise': torch.from_numpy(rng.standard_normal((16, 16, 3)).astype(np.float32)),
              'params': from_jax(jax.tree.map(np.asarray, jax_init_ae(jax.random.PRNGKey(1),
                                                                      JaxConfig(**W.SMALL)))),
              'jax': {'cfg': W.SMALL, 'params': from_jax(jp), 'bits': torch.from_numpy(jbits),
                      'noise': torch.from_numpy(jnoise)}}
    assert Trainer(cfg, 'cpu', params=inputs['params']).params.keys() == {'enc', 'dec'}
    torch.save(inputs, d / 'inputs.pt')
    spawn_ranks([WORKER, str(d / 'inputs.pt'), str(d / 'out')], 2, str(d))
    ranks = [torch.load(d / f'out{r}.pt') for r in range(2)]
    return W.run_all(inputs, None), ranks, inputs


def leaf_rel(got, ref):
    return max(((g - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
               for g, r in zip(got, ref))


def assert_params_close(got, ref):
    for g, r in zip(got, ref, strict=True):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- the mesh
def test_make_mesh_semantics(tmp_path, monkeypatch):
    assert dm.make_mesh(()) is None
    with pytest.raises(ValueError, match='at most two'):
        dm.make_mesh((2, 2, 1))                             # JAX names two axes
    with pytest.raises(RuntimeError, match='torchrun'):
        dm.make_mesh((2,))                                  # no process group
    with pytest.raises(RuntimeError, match='torchrun'):
        dm.make_mesh((2, 2))
    assert dm.initialize_distributed() is False             # one process: a no-op
    assert dm.initialize_distributed(None, 1, 0, 'gloo') is False
    with pytest.raises(ValueError, match='backend'):
        dm.initialize_distributed('env://', 2, 0, 'mpi')
    monkeypatch.delenv('LOCAL_WORLD_SIZE', raising=False)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(RuntimeError, match='NCCL needs one card a rank: 2 ranks'):
        dm.initialize_distributed('tcp://localhost:1', 2, 0, 'nccl')
    assert dm.initialize_distributed(f'file://{tmp_path}/store', 1, 0, 'gloo') is True
    try:
        mesh = dm.make_mesh([1])
        assert (mesh.size, mesh.rank, mesh.backend, mesh.device) == (1, 0, 'gloo',
                                                                    torch.device('cpu'))
        with pytest.raises(ValueError, match='needs 2 ranks'):
            dm.make_mesh((2,))
        with pytest.raises(ValueError, match=r'mesh \(1, 2\) needs 2 ranks'):
            dm.make_mesh((1, 2))
        flat = dm.make_mesh((1, 1), shard_axis='time')     # a 2-D mesh of one rank
        assert (flat.shape, flat.size, flat.replicas, flat.data, flat.model,
                flat.shard_axis, flat.axis) == ((1, 1), 1, 1, 0, 0, 'time', 1)
        assert flat.data_group is torch.distributed.group.WORLD
        x = torch.arange(6.0)
        assert torch.equal(dm.shard_rows(x, mesh), x)
        with dm.active(mesh):                       # a 1-rank mesh sums over itself
            assert dm.current() is mesh and dm.world() == 1
            assert float(dm.batch_sum(x)) == 15.0 and float(dm.batch_mean(x)) == 2.5
        assert dm.current() is None
    finally:
        torch.distributed.destroy_process_group()


def test_rows_split_the_global_batch():
    mesh = dm.Mesh(size=2, rank=1, device=torch.device('cpu'), backend='gloo', group=None)
    x = torch.arange(8).reshape(4, 2)
    assert torch.equal(dm.shard_rows(x, mesh), x[2:])
    with pytest.raises(ValueError, match='5 rows do not split over 2 ranks'):
        dm.shard_rows(torch.zeros(5), mesh)
    with dm.active(mesh):
        drawn = dm.rows(lambda s: torch.arange(s[0] * s[1]).reshape(s), (2, 3))
    assert torch.equal(drawn, torch.arange(12).reshape(4, 3)[2:])
    with pytest.raises(ValueError, match='does not split over 2 ranks'):
        Trainer(Config(**{**W.SMALL, 'batch_size': 15}), 'cpu', mesh=mesh)


# ---------------------------------------------------------------- two ranks against one
def test_both_ranks_hold_the_same_results(runs):
    _, (r0, r1), _ = runs
    assert r0['mesh'] == {'size': 2, 'rank': 0, 'backend': 'gloo', 'device': 'cpu'}
    assert r1['mesh']['rank'] == 1
    for name in W.EPOCHS:
        assert r0['epochs'][name]['losses'] == r1['epochs'][name]['losses']
        assert all(torch.equal(a, b) for a, b in zip(r0['epochs'][name]['params'],
                                                      r1['epochs'][name]['params']))
    assert r0['sweep'] == r1['sweep']


@pytest.mark.parametrize('name', list(W.EPOCHS))
def test_epoch_two_ranks_equal_one(runs, name):
    """A decoder and an encoder epoch of 2 steps, then validate, test (with
    its punctured pass; under norm_stats with the precomputed statistics) and
    the encoder power. fading draws its gain in the forward, rnn_dropout its
    masks: both at the global batch."""
    ref, (got, _), _ = runs
    g, r = got['epochs'][name], ref['epochs'][name]
    for a, b in zip(g['losses'], r['losses']):
        assert abs(a - b) <= LOSS_RTOL * abs(b)
    assert_params_close(g['params'], r['params'])
    np.testing.assert_allclose(g['val'], r['val'], rtol=LOSS_RTOL)
    assert g['test'] == r['test']
    assert abs(g['enc_power'] - r['enc_power']) < 1e-6


@pytest.mark.parametrize('name', W.LOSSES)
def test_each_loss_two_ranks_equal_one(runs, name):
    ref, (got, _), inputs = runs
    g, r = got['losses'][name], ref['losses'][name]
    assert abs(g['loss'] - r['loss']) <= LOSS_RTOL * abs(r['loss'])
    # the single process's own f32 noise: the same loss on the row-reversed batch
    rev = torch.arange(15, -1, -1)
    tr = Trainer(Config(**W.SMALL, loss=name), 'cpu', params=inputs['params'])
    _, noise = tr.loss_and_grads('joint', inputs['bits'][rev], inputs['noise'][rev])
    for h in r['grads']:
        floor = leaf_rel(noise[h], r['grads'][h])
        assert leaf_rel(g['grads'][h], r['grads'][h]) <= max(GRAD_RTOL, 2 * floor), (h, floor)


def test_gradients_are_not_scaled_by_the_world_size(runs):
    """The rule of dist/mesh.py: each rank differentiates its share. Were the
    replicated loss all-reduced instead, every gradient would come out x2."""
    ref, (got, _), _ = runs
    for name in W.LOSSES:
        for h, grads in ref['losses'][name]['grads'].items():
            num = sum(float(g.abs().sum()) for g in got['losses'][name]['grads'][h])
            den = sum(float(g.abs().sum()) for g in grads)
            if den == 0.0:                          # enc_rl's decoder: no gradient
                assert num == 0.0, name
                continue
            assert abs(num / den - 1.0) < 1e-3, (name, h, num / den)


@pytest.mark.parametrize('channel', ['awgn', 'fading'])
def test_sweep_counts_two_ranks_equal_one(runs, channel):
    ref, (got, _), _ = runs
    g, r = got['sweep'][channel], ref['sweep'][channel]
    assert (g['n_bits'], g['n_blocks']) == (r['n_bits'], r['n_blocks']) == (2 * 32 * 16, 2 * 32)
    if (g['bit_errors'], g['blk_errors'], g['pos_errors']) != \
            (r['bit_errors'], r['blk_errors'], r['pos_errors']):
        near = g['near'] + r['near']
        assert all(abs(a - b) <= near for a, b in zip(g['blk_errors'], r['blk_errors']))
        assert all(abs(a - b) <= 16 * near for a, b in zip(g['bit_errors'], r['bit_errors']))


def test_ftae_step_two_ranks_equal_one(runs):
    """pos_phase: the feedback whitening (f64) and the power allocation's
    per-position power over the global batch; then its sweep's counts."""
    ref, (got, _), _ = runs
    g, r = got['ftae'], ref['ftae']
    for a, b in zip(g['losses'], r['losses']):
        assert abs(a - b) <= LOSS_RTOL * abs(b)
    assert_params_close(g['params'], r['params'])
    assert g['counts'] == r['counts']


@pytest.mark.parametrize('pc', ['symbol_power', 'qpsk'])
def test_mod_step_two_ranks_equal_one(runs, pc):
    """One step of each of the four phases (the symbol normalization over axes
    (0, 2), or over everything before the STE), then its test."""
    ref, (got, _), _ = runs
    g, r = got['mod'][pc], ref['mod'][pc]
    for a, b in zip(g['losses'], r['losses']):
        assert abs(a - b) <= LOSS_RTOL * abs(b)
    assert_params_close(g['params'], r['params'])
    assert g['test'] == r['test']


def test_steps_per_call_under_gloo_raises(runs):
    _, (got, _), _ = runs
    assert 'cannot be captured' in got['graph_under_gloo']


# ---------------------------------------------------------------- against JAX's mesh
@pytest.mark.parametrize('mode', ['encoder', 'decoder', 'joint'])
def test_port_two_ranks_equal_jax_eight_devices(runs, mode):
    """JAX's Trainer on an 8-device mesh (its loss of the batch sharded on
    the data axis) against the port's two ranks on the same batch and
    params: the loss to 1e-5 relative, the gradients to 1e-5 of each leaf's
    largest."""
    _, (got, _), inputs = runs
    jcfg, jp, bits, noise = jax_case()
    mesh = jax_make_mesh((8,))
    jt = JaxTrainer(jcfg, mesh=mesh)
    par = jax.tree.map(jnp.asarray, jp)
    b, n = (jax.device_put(x, data_sharding(mesh)) for x in (bits, noise))
    key = jax.random.PRNGKey(0)
    with jax.default_matmul_precision('highest'):
        if mode == 'joint':
            loss, g = jax.value_and_grad(jt._loss)(par, None, lambda d, f: d, key, b, n)
        else:
            h, o = ('enc', 'dec') if mode == 'encoder' else ('dec', 'enc')
            merge = (lambda d, f: {h: d, o: f})
            loss, g = jax.value_and_grad(jt._loss)(par[h], par[o], merge, key, b, n)
            g = {h: g}
    res = got['jax'][mode]
    assert abs(res['loss'] - float(loss)) <= LOSS_RTOL * abs(float(loss))
    port = inputs['jax']['params']
    for h, grads in res['grads'].items():
        tree = {k: port[k] for k in ('enc', 'dec')}
        tree[h] = tree_unflatten(port[h], grads)
        for a, r in zip(jax.tree.leaves(to_jax(tree)[h]), jax.tree.leaves(g[h]), strict=True):
            r = np.asarray(r)
            assert np.abs(a - r).max() <= GRAD_RTOL * np.abs(r).max(), h


# ---------------------------------------------------------------- the CLIs
def test_cli_under_torchrun_writes_the_one_rank_checkpoint(tmp_path, monkeypatch):
    """torchrun --nproc_per_node 2 cli/main.py -mesh_shape 2 --device cpu:
    rank 0 alone writes the log and the checkpoint, the file of the 1-rank
    run with the same seed (keys equal, values to the sharded tolerance)."""
    two, one = tmp_path / 'two', tmp_path / 'one'
    two.mkdir()
    one.mkdir()
    proc = subprocess.Popen([sys.executable, '-m', 'torch.distributed.run', '--nproc_per_node',
                             '2', '--master_port', str(free_port()), '-m',
                             'turboae_tpu_torch.cli.main', '-mesh_shape', '2', *TINY],
                            cwd=two, text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1'))
    out = run_procs([proc])[0]
    assert out.count('final results on SNRs') == 1            # rank 0 prints, rank 1 does not
    assert len(list((two / 'logs').iterdir())) == 1
    ckpts = list((two / 'tmp').iterdir())
    assert len(ckpts) == 1
    monkeypatch.chdir(one)
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    cli_main.main(TINY)
    ref = load_msgpack(str(next((one / 'tmp').iterdir())))
    got = load_msgpack(str(ckpts[0]))
    flat_got, flat_ref = _flat(got), _flat(ref)
    assert flat_got.keys() == flat_ref.keys()
    for k, v in flat_ref.items():
        np.testing.assert_allclose(flat_got[k], v, rtol=1e-4, atol=1e-5, err_msg=k)


def _flat(tree, prefix=''):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f'{prefix}/{k}').items()}
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize('cli', [cli_main, ftae_main], ids=['main', 'ftae_main'])
def test_cli_nccl_with_too_few_cards_raises(cli, tmp_path, monkeypatch):
    """Two NCCL ranks on a node without two cards raise before joining a
    group; nothing is written."""
    monkeypatch.chdir(tmp_path)
    for k, v in (('RANK', '0'), ('WORLD_SIZE', '2'), ('LOCAL_RANK', '0')):
        monkeypatch.setenv(k, v)
    monkeypatch.delenv('LOCAL_WORLD_SIZE', raising=False)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    argv = [a for a in TINY if a not in ('--device', 'cpu')]
    with pytest.raises(RuntimeError, match='NCCL needs one card a rank'):
        cli.main(['-mesh_shape', '2', *argv])
    with pytest.raises(ValueError, match='torchrun started 2 ranks'):
        cli.main(['-mesh_shape', '3', *argv])
    with pytest.raises(ValueError, match='needs 4 ranks but torchrun started 2 ranks'):
        cli.main(['-mesh_shape', '2', '2', *argv])
    with pytest.raises(RuntimeError, match='NCCL needs one card a rank'):  # time: no M16b raise
        cli.main(['-mesh_shape', '2', '-shard_axis', 'time', *argv])
    with pytest.raises(ValueError, match='shard_axis'):
        cli.main(['-mesh_shape', '2', '-shard_axis', 'model', *argv])
    assert not list(tmp_path.iterdir())
