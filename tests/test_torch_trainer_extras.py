"""The trainer's extras against the JAX package on the CPU: variable block
lengths, k-same-code batches, precomputed norm stats, several steps per call
and the optimizers' staged count-dependent values.

Inputs are drawn with numpy from a seed, or made by the JAX package's init,
and handed to both sides; JAX runs at 'highest' matmul precision.
Tolerances, each with its reason:
  - interleavers, bucket lengths and the (length, seed) draws are integers
    from the same MT19937 streams: equal;
  - a variable-block-length step in f32: the loss to 1e-5 relative, the
    gradients to 1e-4 of each leaf's largest (summation order only, as
    tests/test_torch_train.py holds the fixed-length step);
  - norm stats and a forward threaded through them: 1e-6 relative (means
    and standard deviations of the same codes);
  - steps_per_call on the CPU runs the same eager steps: equal;
  - staged bias corrections: tests/test_torch_lookahead.py's 1e-6 relative
    (a staged step multiplies by the f32 reciprocal of each correction, as
    the card's torch._foreach_div by a host number does; optax divides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from turboae_tpu.models.channel_ae import forward_ae as j_forward_ae
from turboae_tpu.models.channel_ae import make_perms as j_make_perms
from turboae_tpu.models.encoders import make_encoder as j_make_encoder
from turboae_tpu.ops.power import init_norm_stats as j_init_norm_stats
from turboae_tpu.train.optimizers import lookahead
from turboae_tpu.train.trainer import Trainer as JaxTrainer
from turboae_tpu_torch.models.channel_ae import forward_ae, make_perms
from turboae_tpu_torch.train import optimizers as topt
from turboae_tpu_torch.train.convert import to_jax
from turboae_tpu_torch.train.trainer import Trainer, vbl_buckets
from turboae_tpu_torch.utils.tree import tree_leaves, tree_unflatten

from _torch_parity import SMALL, bits_noise, configs, small_params

VBL = dict(SMALL, batch_size=8, num_block=48, is_variable_block_len=True, block_len_low=10,
           block_len_high=30, is_interleave=1000)


# ---------------------------------------------------------------- perms
@pytest.mark.parametrize('L,seed,inter', [(24, None, 1), (37, 5, 1), (10, 812, 1000),
                                          (16, 3, 0)])
def test_make_perms_with_length_and_seed_match_jax(L, seed, inter):
    jcfg, tcfg = configs(**SMALL, is_interleave=inter)
    ref = j_make_perms(jcfg, block_len=L, seed=seed)
    got = make_perms(tcfg, 'cpu', block_len=L, seed=seed)
    for k in ('p1', 'p2'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
        np.testing.assert_array_equal(got[k][got[k + '_inv']].numpy(), np.arange(L))
    assert len(got['p1']) == L


def test_make_perms_keeps_its_two_argument_call():
    jcfg, tcfg = configs(**SMALL)
    ref = j_make_perms(jcfg)
    got = make_perms(tcfg, 'cpu')
    np.testing.assert_array_equal(got['p2'].numpy(), np.asarray(ref['p2']))


# ---------------------------------------------------------------- variable block lengths
@pytest.mark.parametrize('lo,hi', [(10, 200), (10, 30), (5, 9), (100, 101)])
def test_vbl_buckets_match_jax(lo, hi):
    jcfg, tcfg = configs(block_len_low=lo, block_len_high=hi)
    assert vbl_buckets(tcfg) == JaxTrainer._vbl_buckets(type('T', (), {'cfg': jcfg})())


def _jax_draws(jcfg, modes):
    """The (mode, length) of each step of JAX's epochs, and the perms of each
    (mode, length), with no step compiled: the jitted step is replaced after
    JAX's own _vbl_step has drawn the pair's seed and perms."""
    jt = JaxTrainer(jcfg)
    steps, perms = [], {}
    inner = jt._vbl_step

    def record(mode, L):
        inner(mode, L)
        steps.append((mode, L))
        perms.setdefault((mode, L), jt._vbl_perms[L])
        return lambda p, o, k: (p, o, jnp.float32(0.0))
    jt._vbl_step = record
    for i, mode in enumerate(modes):
        jt.train_epoch(i, mode, verbose=False)
    return steps, perms


def test_vbl_lengths_and_seeds_match_jax():
    """Two epochs (encoder, decoder) from one cfg.seed: the same length at
    every step, and the same interleaver for every (phase, length); the
    decoder phase draws its own seeds for the lengths the encoder used."""
    jcfg, tcfg = configs(**VBL)
    ref_steps, ref_perms = _jax_draws(jcfg, ['encoder', 'decoder'])
    tr = Trainer(tcfg, 'cpu', params=small_params(jcfg)[1])
    steps = []
    inner = tr._train_step

    def record(mode, bits=None, noise=None, block_len=None):
        steps.append((mode, block_len))
        return inner(mode, bits, noise, block_len)
    tr._train_step = record
    for i, mode in enumerate(['encoder', 'decoder']):
        assert np.isfinite(tr.train_epoch(i, mode, verbose=False))
    assert steps == ref_steps and len(steps) == 12
    assert set(tr._vbl) == set(ref_perms)
    for key, (cfg_l, perms) in tr._vbl.items():
        assert cfg_l.block_len == key[1] == len(perms['p1'])
        for k in ('p1', 'p2'):
            np.testing.assert_array_equal(perms[k].numpy(), np.asarray(ref_perms[key][k]))
    assert len(set(tr.vbl_seeds.values())) > 1


def test_vbl_step_matches_jax():
    """One f32 step of each phase at a bucket length, on the same params,
    bits and noise and the interleaver each side drew for it."""
    jcfg, tcfg = configs(**VBL)
    jp, tp = small_params(jcfg, seed=2)
    L = vbl_buckets(tcfg)[1]
    jt = JaxTrainer(jcfg)
    tr = Trainer(tcfg, 'cpu', params=tp)
    for mode in ('encoder', 'decoder'):
        jt._vbl_step(mode, L)
        sub = JaxTrainer(jcfg.replace(block_len=L, is_variable_block_len=False))
        sub.perms = jt._vbl_perms[L]
        cfg_l, perms = tr._vbl_step_cfg(mode, L)
        bits, noise = bits_noise(np.random.RandomState(4), 8, L)
        h, o = ('enc', 'dec') if mode == 'encoder' else ('dec', 'enc')
        merge = (lambda d, f: {'enc': d, 'dec': f}) if h == 'enc' else \
            (lambda d, f: {'enc': f, 'dec': d})
        par = jax.tree.map(jnp.asarray, jp)
        with jax.default_matmul_precision('highest'):
            ref_loss, ref_g = jax.value_and_grad(sub._loss)(par[h], par[o], merge,
                                                            jax.random.PRNGKey(0), bits, noise)
        loss, grads = tr.loss_and_grads(mode, torch.from_numpy(bits), torch.from_numpy(noise),
                                        cfg_l, perms)
        assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
        got = to_jax({**tr.params, h: tree_unflatten(tr.params[h], grads[h])})[h]
        for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref_g)):
            r = np.asarray(r)
            assert np.abs(np.asarray(g) - r).max() <= 1e-4 * np.abs(r).max() + 1e-12


# ---------------------------------------------------------------- k-same-code
def _recorded(tr):
    seen = []
    inner = tr.loss_and_grads

    def record(mode, bits, noise, *a):
        seen.append((bits.clone(), noise.clone()))
        return inner(mode, bits, noise, *a)
    tr.loss_and_grads = record
    return seen


def test_k_same_code_reuses_bits_in_the_encoder_phase_only():
    """k = 2 over 5 encoder steps: bits shared by steps (0, 1) and (2, 3), new
    at each group's first step; noise fresh at every step. The decoder phase
    draws new bits every step."""
    jcfg, tcfg = configs(**SMALL, batch_size=8, num_block=40, is_k_same_code=True,
                         k_same_code=2)
    tr = Trainer(tcfg, 'cpu', params=small_params(jcfg)[1])
    seen = _recorded(tr)
    tr.train_epoch(0, 'encoder', verbose=False)
    bits = [b for b, _ in seen]
    noise = [n for _, n in seen]
    assert len(seen) == 5
    assert torch.equal(bits[0], bits[1]) and torch.equal(bits[2], bits[3])
    assert not torch.equal(bits[1], bits[2]) and not torch.equal(bits[3], bits[4])
    assert all(not torch.equal(a, b) for i, a in enumerate(noise) for b in noise[i + 1:])
    seen.clear()
    tr.train_epoch(0, 'decoder', verbose=False)
    assert all(not torch.equal(a[0], b[0]) for a, b in zip(seen, seen[1:]))


# ---------------------------------------------------------------- norm stats
def test_precomputed_norm_stats_match_jax():
    """The encoder's running mean and std over the precompute's batches, then
    a test forward threaded through them, on the same bits and noise."""
    jcfg, tcfg = configs(**SMALL, batch_size=8, num_block=80, test_ratio=0.5,
                         precompute_norm_stats=True)
    jp, tp = small_params(jcfg, seed=1)
    n = max(1, int(tcfg.num_block / tcfg.batch_size * tcfg.test_ratio))
    rng = np.random.RandomState(5)
    batches = [bits_noise(rng, 8, SMALL['block_len'])[0] for _ in range(n)]
    _, enc_apply = j_make_encoder(jcfg)
    jperms = j_make_perms(jcfg)
    par = jax.tree.map(jnp.asarray, jp)
    ref = j_init_norm_stats()
    with jax.default_matmul_precision('highest'):
        for b in batches:
            _, ref = enc_apply(par['enc'], jcfg, jnp.asarray(b), jperms, training=False,
                               stats=ref)
    tr = Trainer(tcfg, 'cpu', params=tp)
    it = iter(batches)
    tr._bits = lambda cfg=None: torch.from_numpy(next(it))
    stats = tr.precompute_norm_stats()
    assert next(it, None) is None and float(stats.count) == n == float(ref.count)
    for a, b in zip(stats, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)

    bits, noise = bits_noise(rng, 8, SMALL['block_len'], sigma=0.8)
    with jax.default_matmul_precision('highest'):
        jout, _, jst = j_forward_ae(par, jcfg, jax.random.PRNGKey(0), bits, noise, jperms,
                                    training=False, stats=ref)
    out, _, st = forward_ae(tr.params, tcfg, torch.from_numpy(bits), torch.from_numpy(noise),
                            tr.perms, training=False, stats=stats)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6, atol=1e-6)
    for a, b in zip(st, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    # _eval_batch takes the stats and hands them back, one batch further on
    (ber, *_), st2 = tr._eval_batch(torch.from_numpy(bits), torch.from_numpy(noise),
                                    stats=stats)
    assert float(st2.count) == n + 1 and 0 <= float(ber) <= 1


def test_test_threads_the_stats_through_both_passes():
    _, tcfg = configs(**SMALL, batch_size=8, num_block=16, snr_points=2,
                      precompute_norm_stats=True)
    tr = Trainer(tcfg, 'cpu', params=small_params(configs(**SMALL)[0])[1])
    counts = []
    inner = tr._eval_batch

    def record(bits, noise, punc_mask=None, stats=None):
        counts.append(float(stats.count))
        return inner(bits, noise, punc_mask, stats)
    tr._eval_batch = record
    tr.test(verbose=False)
    n = max(1, int(16 / 8 * tcfg.test_ratio))
    assert counts == [float(n + i) for i in range(2 * 2 * 2)]
    assert float(tr.norm_stats.count) == n


# ---------------------------------------------------------------- steps per call
@pytest.mark.parametrize('n,num_block', [(3, 56), (2, 16), (4, 24)])
def test_steps_per_call_groups_and_losses_on_cpu(n, num_block):
    """divmod(num_batches, n) groups of n steps, then the rest one at a time;
    on the CPU the same eager steps as steps_per_call 1: equal losses and
    params."""
    kw = dict(SMALL, batch_size=8, num_block=num_block, optimizer='lookahead')
    jcfg, tcfg = configs(**kw)
    tp = small_params(jcfg)[1]
    a = Trainer(tcfg.replace(steps_per_call=n), 'cpu', params=tp)
    b = Trainer(tcfg, 'cpu', params=tp)
    groups, singles = [], []
    inner_many, inner_one = a._train_steps, a._train_step
    a._train_steps = lambda mode, k, g: groups.append((k, g)) or inner_many(mode, k, g)
    losses_a, losses_b = [], []
    a._train_step = lambda mode, *x, **kw: singles.append(1) or losses_a.append(
        inner_one(mode, *x, **kw)) or losses_a[-1]
    inner_b = b._train_step
    b._train_step = lambda mode, *x, **kw: losses_b.append(inner_b(mode, *x, **kw)) or losses_b[-1]
    steps = num_block // 8
    g, rem = divmod(steps, n)
    assert a.train_epoch(0, 'joint', verbose=False) == b.train_epoch(0, 'joint', verbose=False)
    assert groups == ([(n, g)] if g else []) and len(singles) == steps == len(losses_b)
    assert torch.equal(torch.stack(losses_a), torch.stack(losses_b))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)))
    assert a.opt['enc'].count == b.opt['enc'].count == steps


def test_vbl_and_k_same_code_take_precedence_over_steps_per_call():
    _, tcfg = configs(**VBL, steps_per_call=2)
    tr = Trainer(tcfg, 'cpu')
    tr._train_steps = lambda *a: pytest.fail('steps_per_call ran under VBL')
    tr.train_epoch(0, 'encoder', verbose=False)
    _, tcfg = configs(**SMALL, batch_size=8, num_block=32, steps_per_call=2,
                      is_k_same_code=True)
    tr = Trainer(tcfg, 'cpu')
    called = []
    inner = tr._train_steps
    tr._train_steps = lambda *a: called.append(a[0]) or inner(*a)
    tr.train_epoch(0, 'encoder', verbose=False)
    tr.train_epoch(0, 'decoder', verbose=False)
    assert called == ['decoder']


# ---------------------------------------------------------------- staged optimizer values
def _tree(rng):
    return {'a': rng.standard_normal((5, 3)).astype(np.float32),
            'b': [rng.standard_normal(7).astype(np.float32)]}


@pytest.mark.parametrize('name', ['adam', 'lookahead'])
def test_staged_steps_match_optax_over_12_steps(name):
    """12 steps that read their bias corrections (and Lookahead's sync) from
    staged rows, as the captured graph does, in two groups of 6, against
    optax: params (and slow weights) to 1e-6 relative at every step; the
    host counts end where optax's do."""
    rng = np.random.RandomState(11)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(12)]
    tx = optax.adam(1e-2) if name == 'adam' else lookahead(optax.adam(1e-2), k=5, alpha=0.5)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    leaves = [torch.from_numpy(t.copy()) for t in tree_leaves(params)]
    opt = topt.Adam(leaves, 1e-2) if name == 'adam' else topt.Lookahead(leaves, 1e-2)
    for group in range(2):
        rows = torch.from_numpy(opt.staged(6))
        for i in range(6):
            g = grads[6 * group + i]
            upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
            jp = optax.apply_updates(jp, upd)
            opt.slot = rows[i]
            opt.step([torch.from_numpy(t) for t in tree_leaves(g)])
            for got, ref in zip(leaves, jax.tree.leaves(jp)):
                np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
            if name == 'lookahead':
                for got, ref in zip(opt.slow, jax.tree.leaves(state['slow'])):
                    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                               atol=1e-7)
    assert opt.count == 12


def test_staged_rows_are_the_host_values():
    leaves = [torch.zeros(3)]
    adam = topt.Adam(leaves, 1e-3)
    adam.count = 7
    rows = adam.staged(3)
    assert rows.dtype == np.float32 and rows.shape == (3, 2)
    want = np.float32([topt._bias_correction(0.9, 8), topt._bias_correction(0.999, 8)])
    assert rows[0].tolist() == (np.float32(1.0) / want).tolist()
    la = topt.Lookahead(leaves, 1e-3)
    la.count = la.inner.count = 3
    assert la.staged(7)[:, 2].tolist() == [0, 0, 0.5, 0, 0, 0, 0]
    la.advance(4)
    assert la.count == la.inner.count == 7
    assert topt.SGD(leaves, 1e-3).staged(4).shape == (4, 0)
