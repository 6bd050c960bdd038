"""The port's training slice against the JAX package's, on the CPU.

Inputs (params, bits, noise, gradients) are made once with numpy or with
the JAX package's init and handed to both sides; the JAX side runs at
'highest' matmul precision. Tolerances, each with its reason:
  - f32 losses agree to 1e-5 relative: same arithmetic, summation order only;
  - gradients, per leaf, to 1e-4 of the leaf's largest |gradient|: the
    backward sums over batch and time in another order;
  - Adam's first step is close to lr * sign(g), so where |g| is near eps a
    tiny gradient difference moves the update a lot: updated params are
    compared with an atol of 1e-3 * lr, after the elements whose |g| lies
    below 1e-4 of the leaf's largest are set aside (there the sign itself is
    within the gradient tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from turboae_tpu.channels.noise import train_sigma as j_train_sigma
from turboae_tpu.ops.ste import mod_quantize as j_mod, rx_quantize as j_rx, ste_quantize as j_ste
from turboae_tpu.train.losses import customized_loss as j_loss
from turboae_tpu.train.trainer import Trainer as JaxTrainer
from turboae_tpu.utils.metrics import snr_db2sigma
from turboae_tpu_torch.channels.noise import generate_noise, train_sigma
from turboae_tpu_torch.models.channel_ae import init_ae
from turboae_tpu_torch.ops.ste import mod_quantize, rx_quantize, ste_quantize
from turboae_tpu_torch.train import optimizers as topt
from turboae_tpu_torch.train.convert import from_jax, to_jax
from turboae_tpu_torch.train.losses import customized_loss
from turboae_tpu_torch.train.trainer import Trainer
from turboae_tpu_torch.utils.tree import tree_leaves, tree_unflatten

from _torch_parity import SMALL, bits_noise, configs, small_params

GRAD_RTOL = 1e-4


# ---------------------------------------------------------------- STE
@pytest.mark.parametrize('clipping', ['inputs', 'gradient', 'both', 'none'])
@pytest.mark.parametrize('level', [2, 4])
def test_ste_backward_matches_jax(clipping, level):
    rng = np.random.RandomState(0)
    x = rng.uniform(-2.0, 2.0, (6, 40)).astype(np.float32)
    g = rng.standard_normal((6, 40)).astype(np.float32) * 0.05
    fwd, vjp = jax.vjp(lambda v: j_ste(v, 1.2, level, 0.02, clipping), jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ste_quantize(xt, 1.2, level, 0.02, clipping)
    (got,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(fwd))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize('which', ['rx', 'mod'])
def test_rx_and_mod_quantize_backward_match_jax(which):
    rng = np.random.RandomState(1)
    x = rng.uniform(-2.0, 2.0, (200,)).astype(np.float32)
    g = rng.standard_normal(200).astype(np.float32)
    jf, tf = (j_rx, rx_quantize) if which == 'rx' else (j_mod, mod_quantize)
    _, vjp = jax.vjp(jf, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(tf(xt), xt, torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


def test_ste_refuses_unknown_clipping():
    with pytest.raises(ValueError):
        ste_quantize(torch.zeros(3), clipping='sometimes')


# ---------------------------------------------------------------- loss
def test_bce_and_its_gradient_at_saturated_outputs():
    """Outputs at, beyond and just inside the clips. An output exactly at a
    clip bound is left out: there JAX's clip splits the gradient in half
    between its two branches and torch.clamp passes it whole, both valid
    subgradients at a point of measure zero."""
    out = np.array([0.0, 1e-12, 2e-7, 0.3, 0.5, 1 - 1e-8, 1.0, 1.0, 0.0, 1.2, -0.1],
                   np.float32).reshape(1, -1, 1)
    tgt = np.array([1, 1, 0, 1, 0, 0, 1, 0, 0, 1, 0], np.float32).reshape(1, -1, 1)
    jcfg, tcfg = configs()
    ref, ref_g = jax.value_and_grad(lambda o: j_loss(o, jnp.asarray(tgt), jcfg))(jnp.asarray(out))
    ot = torch.from_numpy(out).requires_grad_(True)
    got = customized_loss(ot, torch.from_numpy(tgt), tcfg)
    (got_g,) = torch.autograd.grad(got, ot)
    assert np.isfinite(got.item()) and np.isfinite(got_g.numpy()).all()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(ref_g), rtol=1e-5, atol=1e-6)


def test_other_losses_are_not_ported():
    """The whole JAX menu is ported (tests/test_torch_losses.py); a name
    outside it raises ValueError, as in JAX."""
    _, tcfg = configs(loss='maxBCE')
    assert torch.isfinite(customized_loss(torch.full((1, 4, 1), 0.5), torch.ones((1, 4, 1)),
                                          tcfg))
    with pytest.raises(ValueError, match='unknown loss'):
        customized_loss(torch.full((1, 4, 1), 0.5), torch.ones((1, 4, 1)),
                        tcfg.replace(loss='hinge'))


# ---------------------------------------------------------------- optimizers
def _tree(rng):
    return {'a': rng.standard_normal((5, 3)).astype(np.float32),
            'b': [rng.standard_normal(7).astype(np.float32)]}


@pytest.mark.parametrize('name', ['adam', 'sgd'])
def test_three_optimizer_steps_match_optax(name):
    rng = np.random.RandomState(2)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    grads[1]['a'][0, 0] = 1e-9          # near eps: the update is no longer ~lr*sign
    tx = optax.adam(1e-2) if name == 'adam' else optax.sgd(1e-2, momentum=0.9)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
    _, tcfg = configs(optimizer=name)
    leaves = [torch.from_numpy(t.copy()) for t in tree_leaves(params)]
    opt = topt.make_optimizer(tcfg, 1e-2, leaves)
    for g in grads:
        opt.step([torch.from_numpy(t) for t in tree_leaves(g)])
    for got, ref in zip(leaves, jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


def test_lookahead_is_not_ported():
    """Lookahead is ported (tests/test_torch_lookahead.py): the name builds
    Lookahead over Adam with JAX's k 5 and alpha 0.5."""
    _, tcfg = configs(optimizer='lookahead')
    opt = topt.make_optimizer(tcfg, 1e-3, [torch.zeros(2)])
    assert isinstance(opt, topt.Lookahead) and isinstance(opt.inner, topt.Adam)
    assert (opt.k, opt.alpha) == (5, 0.5)


# ---------------------------------------------------------------- noise
def test_train_sigma_statistics():
    """A uniform mixture over [sigma(2 dB), sigma(-1.5 dB)]: its bounds, mean
    and variance against the JAX sampler's, 2e5 draws each (the standard
    error of the mean is ~6e-4, of the variance ~1e-4)."""
    lo, hi = snr_db2sigma(2.0), snr_db2sigma(-1.5)
    g = torch.Generator().manual_seed(0)
    got = train_sigma((200, 1000), -1.5, 2.0, g, 'cpu').numpy()
    ref = np.asarray(j_train_sigma(jax.random.PRNGKey(0), (200, 1000), -1.5, 2.0))
    for s in (got, ref):
        assert s.min() >= lo - 1e-6 and s.max() <= hi + 1e-6
        assert abs(s.mean() - (lo + hi) / 2) < 4e-3
        assert abs(s.var() - (hi - lo) ** 2 / 12) < 1e-3
    assert abs(got.mean() - ref.mean()) < 4e-3
    # per element: neighbouring elements draw different sigmas
    assert np.unique(got[0]).size > 990


def test_generate_noise_scales_with_the_snr_range():
    _, tcfg = configs()
    g = torch.Generator().manual_seed(1)
    n = generate_noise((400, 100, 3), tcfg, g, 'cpu', snr_low=1.0, snr_high=1.0).numpy()
    assert abs(n.std() - snr_db2sigma(1.0)) < 5e-3
    n = generate_noise((400, 100, 3), tcfg, g, 'cpu', test_sigma=0.0).numpy()
    assert abs(n.std() - 1.0) < 5e-3


# ---------------------------------------------------------------- init
def test_init_bounds_per_leaf_match_jax():
    """Every leaf of the port's init has the JAX init's shape (after
    conversion) and lies in the same U(+-1/sqrt(fan_in)) bound, which both
    nearly reach."""
    jcfg, tcfg = configs(**SMALL)
    jp, jt = small_params(jcfg)
    tp = init_ae(torch.Generator().manual_seed(0), tcfg)
    ref_leaves = tree_leaves(jt)
    got_leaves = tree_leaves(tp)
    assert [t.shape for t in got_leaves] == [t.shape for t in ref_leaves]
    conv_fan = {}
    for path_leaves, fan in _fans(tp):
        for t in path_leaves:
            conv_fan[id(t)] = fan
    for got, ref in zip(got_leaves, ref_leaves):
        bound = conv_fan[id(got)] ** -0.5
        assert got.abs().max() <= bound and ref.abs().max() <= bound
        if got.numel() >= 50:
            assert got.abs().max() > 0.8 * bound and ref.abs().max() > 0.8 * bound


def _fans(tp):
    """([w, b], fan_in) of every conv layer and head of a port param tree."""
    for br in tp['enc'].values():
        for l in br['cnn']:
            yield [l['w'], l['b']], l['w'].shape[1] * l['w'].shape[2]
        yield [br['lin']['w'], br['lin']['b']], br['lin']['w'].shape[1]
    for it in tp['dec']['iters']:
        for key in ('dec1_cnn', 'dec2_cnn'):
            for l in it[key]:
                yield [l['w'], l['b']], l['w'].shape[1] * l['w'].shape[2]
        for key in ('dec1_lin', 'dec2_lin'):
            yield [it[key]['w'], it[key]['b']], it[key]['w'].shape[1]


def test_init_is_seeded():
    _, tcfg = configs(**SMALL)
    a = tree_leaves(init_ae(torch.Generator().manual_seed(3), tcfg))
    b = tree_leaves(init_ae(torch.Generator().manual_seed(3), tcfg))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------- one step
def _jax_step(jcfg, jp, mode, bits, noise):
    """JAX's value_and_grad(Trainer._loss) and its optimizers' update."""
    jt = JaxTrainer(jcfg)
    par = jax.tree.map(jnp.asarray, jp)
    key = jax.random.PRNGKey(0)
    with jax.default_matmul_precision('highest'):
        if mode == 'joint':
            loss, g = jax.value_and_grad(jt._loss)(par, None, lambda d, f: d, key, bits, noise)
        else:
            h, o = ('enc', 'dec') if mode == 'encoder' else ('dec', 'enc')
            merge = (lambda d, f: {'enc': d, 'dec': f}) if h == 'enc' else \
                (lambda d, f: {'enc': f, 'dec': d})
            loss, g = jax.value_and_grad(jt._loss)(par[h], par[o], merge, key, bits, noise)
            g = {h: g}
    new = dict(par)
    for h, gh in g.items():
        tx = jt.opt_enc if h == 'enc' else jt.opt_dec
        upd, _ = tx.update(gh, tx.init(par[h]), par[h])
        new[h] = optax.apply_updates(par[h], upd)
    return float(loss), g, new


def _as_jax_half(trainer, half, leaves):
    """A half's leaves (port layout, tree_leaves order) in the JAX layout."""
    tree = {h: trainer.params[h] for h in ('enc', 'dec')}
    tree[half] = tree_unflatten(trainer.params[half], leaves)
    return to_jax(tree)[half]


@pytest.mark.parametrize('ste', [False, True], ids=['block_norm', 'block_norm_ste'])
@pytest.mark.parametrize('mode', ['encoder', 'decoder', 'joint'])
def test_train_step_matches_jax(mode, ste):
    kw = dict(SMALL, batch_size=16)
    if ste:
        kw['train_channel_mode'] = 'block_norm_ste'
    jcfg, tcfg = configs(**kw)
    jp, tp = small_params(jcfg)
    bits, noise = bits_noise(np.random.RandomState(3), 16, SMALL['block_len'])
    ref_loss, ref_g, ref_new = _jax_step(jcfg, jp, mode, bits, noise)

    tr = Trainer(tcfg, 'cpu', params=tp)
    loss, grads = tr.loss_and_grads(mode, torch.from_numpy(bits), torch.from_numpy(noise))
    assert abs(loss.item() - ref_loss) <= 1e-5 * abs(ref_loss)
    frozen = {h: [t.clone() for t in tr._leaves[h]] for h in ('enc', 'dec')}
    tr2 = Trainer(tcfg, 'cpu', params=tp)
    step_loss = tr2._train_step(mode, torch.from_numpy(bits), torch.from_numpy(noise))
    assert step_loss.item() == loss.item()

    for h in ('enc', 'dec'):
        if h not in grads:      # the frozen half and its optimizer did not move
            assert all(torch.equal(a, b) for a, b in zip(tr2._leaves[h], frozen[h]))
            assert tr2.opt[h].count == 0
            continue
        g_got = jax.tree.leaves(_as_jax_half(tr, h, grads[h]))
        g_ref = [np.asarray(t) for t in jax.tree.leaves(ref_g[h])]
        p_got = jax.tree.leaves(_as_jax_half(tr2, h, tr2._leaves[h]))
        p_ref = [np.asarray(t) for t in jax.tree.leaves(ref_new[h])]
        assert len(g_got) == len(g_ref) == len(p_got) == len(p_ref)
        lr = tcfg.enc_lr if h == 'enc' else tcfg.dec_lr
        for gg, gr, pg, pr in zip(g_got, g_ref, p_got, p_ref):
            scale = np.abs(gr).max()
            assert np.abs(gg - gr).max() <= GRAD_RTOL * scale
            firm = np.abs(gr) > GRAD_RTOL * scale
            np.testing.assert_allclose(pg[firm], pr[firm], rtol=0, atol=1e-3 * lr)
            assert np.abs(pg - pr).max() <= 2 * lr * (1 + 1e-3)


@pytest.mark.parametrize('dtype,mode', [('float32', 'encoder'), ('float32', 'decoder'),
                                        ('float32', 'joint'), ('bfloat16', 'decoder')])
def test_fused_train_step_matches_jax(dtype, mode):
    """use_fused_conv: the decoder's stacks go through K2 (its plain version
    here, the Pallas kernel in interpret mode on the JAX side) and gradients
    through their f32 recompute, to both halves. bf16 tolerances of the
    Pallas tests: the loss to 1e-2 relative, gradients per leaf to 5e-2 of
    the leaf's largest (tests/test_kernels.py:53-71). With dtype bfloat16 the
    encoder's own convolutions also run in bf16, forward and backward, and
    the two frameworks round their bf16 gradients at other places: at this
    config the port's encoder gradients lie within 2.3 % of the f32 ones and
    JAX's within 9.5 % (of each leaf's largest), 11 % apart, so that case
    checks the decoder's."""
    jcfg, tcfg = configs(**SMALL, batch_size=16, dtype=dtype, use_fused_conv=True)
    jp, tp = small_params(jcfg)
    bits, noise = bits_noise(np.random.RandomState(4), 16, SMALL['block_len'])
    with pltpu.force_tpu_interpret_mode():
        ref_loss, ref_g, _ = _jax_step(jcfg, jp, mode, bits, noise)
    tr = Trainer(tcfg, 'cpu', params=tp)
    loss, grads = tr.loss_and_grads(mode, torch.from_numpy(bits), torch.from_numpy(noise))
    assert abs(loss.item() - ref_loss) <= 1e-2 * abs(ref_loss)
    assert set(grads) == set(ref_g)
    for h in grads:
        for gg, gr in zip(jax.tree.leaves(_as_jax_half(tr, h, grads[h])),
                          jax.tree.leaves(ref_g[h])):
            gr = np.asarray(gr)
            assert np.abs(gg - gr).max() <= 5e-2 * np.abs(gr).max()


def test_grads_do_not_accumulate_between_phases():
    jcfg, tcfg = configs(**SMALL, batch_size=8)
    _, tp = small_params(jcfg)
    tr = Trainer(tcfg, 'cpu', params=tp)
    tr._train_step('encoder')
    tr._train_step('decoder')
    assert all(p.grad is None and not p.requires_grad for p in tree_leaves(tr.params))
    assert tr.opt['enc'].count == 1 and tr.opt['dec'].count == 1


def test_params_given_are_copied():
    jcfg, tcfg = configs(**SMALL, batch_size=8)
    _, tp = small_params(jcfg)
    before = [t.clone() for t in tree_leaves(tp)]
    Trainer(tcfg, 'cpu', params=tp)._train_step('joint')
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp), before))


# ---------------------------------------------------------------- a short run
def test_short_run_tracks_the_jax_trainer():
    """Four epochs of 10 encoder and 10 decoder steps from each side's own
    seeded init and RNG: every epoch's mean loss within 0.1 of the JAX
    trainer's (the spread between seeds of either trainer is ~0.07 by the
    last epoch), and both fall below 0.45 from ~0.69."""
    jcfg, tcfg = configs(**SMALL, batch_size=32, num_block=320, seed=0)
    jt, tt = JaxTrainer(jcfg), Trainer(tcfg, 'cpu')
    got, ref = [], []
    for e in range(4):
        for mode in ('encoder', 'decoder'):
            ref.append(jt.train_epoch(e, mode, verbose=False))
            got.append(tt.train_epoch(e, mode, verbose=False))
    assert np.all(np.abs(np.array(got) - np.array(ref)) < 0.1), (got, ref)
    assert got[0] > 0.6 and got[-1] < 0.45 and ref[-1] < 0.45
    bce, ber = tt.validate(verbose=False)
    assert np.isfinite(bce) and 0.0 <= ber < 0.5


def test_from_jax_params_round_trip_through_trainer():
    jcfg, tcfg = configs(**SMALL)
    jp, tp = small_params(jcfg)
    tr = Trainer(tcfg, 'cpu', params=tp)
    back = to_jax(tr.params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(to_jax(from_jax(jp)))):
        np.testing.assert_array_equal(a, b)
