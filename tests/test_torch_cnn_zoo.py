"""The rest of the CNN zoo: the two-interleaver, rate-2, no-interleaver and
2D encoders and decoders, and the 2D ops, against the JAX package on
identical converted params, bits and received values (CPU).

f32 agrees to 1e-5 (JAX at 'highest' matmul precision; summation order
only). bf16 agrees to 1e-2 relative, the repo's bf16 measure: both sides
round at the same places but may sum in another order. Small configs: 2
iterations, 2 layers, 10 units, img_size 4 with block_len 16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turboae_tpu.models import channel_ae as jae
from turboae_tpu.models.decoders import DEC_REGISTRY as J_DEC
from turboae_tpu.models.encoders import ENC_REGISTRY as J_ENC
from turboae_tpu.ops import conv1d as jcv
from turboae_tpu.ops import interleave as jil
from turboae_tpu_torch.models import channel_ae as tae
from turboae_tpu_torch.models import decoders as tdec
from turboae_tpu_torch.models import encoders as tenc
from turboae_tpu_torch.ops import conv1d as tcv
from turboae_tpu_torch.ops import interleave as til
from turboae_tpu_torch.train.convert import _layer_from, from_jax, to_jax
from turboae_tpu_torch.utils.tree import tree_leaves, tree_unflatten

from _torch_parity import configs, rel_err, small_params

ZOO_SMALL = dict(enc_num_unit=10, dec_num_unit=10, enc_num_layer=2, dec_num_layer=2,
                 num_iteration=2, block_len=16, img_size=4)
B = 6
# (encoder, decoder, code_rate_n): the pairs of the zoo; together they hold
# every key the port gained, the last one the dense flavour of DEC_CNN2D
# (keyed off the encoder's name)
PAIRS = [('turboae_2int', 'turboae_2int', 3),
         ('TurboAE_rate3_cnn', 'TurboAE_rate3_cnn_2inter', 3),
         ('TurboAE_rate2_cnn', 'TurboAE_rate2_cnn', 2),
         ('rate2_cnn', 'TurboAE_rate2_cnn', 2),
         ('rate3_cnn', 'rate3_cnn', 3),
         ('TurboAE_rate3_cnn2d', 'TurboAE_rate3_cnn2d', 3),
         ('TurboAE_rate3_cnn2d_dense', 'TurboAE_rate3_cnn2d_dense', 3),
         ('rate3_cnn2d', 'rate3_cnn2d', 3),
         ('TurboAE_rate3_cnn2d_dense', 'rate3_cnn2d', 3)]
ZOO_ENC = ['turboae_2int', 'TurboAE_rate2_cnn', 'rate2_cnn', 'rate3_cnn', 'TurboAE_rate3_cnn2d',
           'TurboAE_rate3_cnn2d_dense', 'rate3_cnn2d']
ZOO_DEC = ['turboae_2int', 'TurboAE_rate3_cnn_2inter', 'TurboAE_rate2_cnn', 'rate3_cnn',
           'TurboAE_rate3_cnn2d', 'TurboAE_rate3_cnn2d_dense', 'rate3_cnn2d']


def _pair_cfgs(encoder, decoder, n, **kw):
    return configs(encoder=encoder, decoder=decoder, code_rate_n=n, **{**ZOO_SMALL, **kw})


def _pair_of(key, field):
    return next(p for p in PAIRS if p[0 if field == 'encoder' else 1] == key)


def _check(got, ref, dtype):
    got = got.detach().float().numpy()
    if dtype == 'float32':
        np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=1e-5, rtol=1e-5)
    else:
        assert rel_err(got, ref) < 1e-2


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('key', ZOO_ENC)
def test_encoder_matches_jax(key, dtype):
    enc, dec, n = _pair_of(key, 'encoder')
    jcfg, tcfg = _pair_cfgs(enc, dec, n, dtype=dtype)
    jp, tp = small_params(jcfg, seed=7)
    bits = (np.random.RandomState(7).random_sample((B, 16, 1)) < 0.5).astype(np.float32)
    _, j_apply = J_ENC[key]
    with jax.default_matmul_precision('highest'):
        ref, _ = j_apply(jp['enc'], jcfg, jnp.asarray(bits), jae.make_perms(jcfg), training=False)
    _, t_apply = tenc.make_encoder(tcfg)
    got, _ = t_apply(tp['enc'], tcfg, torch.from_numpy(bits), tae.make_perms(tcfg, 'cpu'),
                     training=False)
    assert got.shape == (B, 16, n)
    _check(got, ref, dtype)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('key', ZOO_DEC)
def test_decoder_matches_jax(key, dtype):
    enc, dec, n = _pair_of(key, 'decoder')
    jcfg, tcfg = _pair_cfgs(enc, dec, n, dtype=dtype)
    jp, tp = small_params(jcfg, seed=8)
    received = np.random.RandomState(8).standard_normal((B, 16, n)).astype(np.float32)
    _, j_apply = J_DEC[key]
    with jax.default_matmul_precision('highest'):
        ref = j_apply(jp['dec'], jcfg, jnp.asarray(received), jae.make_perms(jcfg))
    _, t_apply = tdec.make_decoder(tcfg)
    got = t_apply(tp['dec'], tcfg, torch.from_numpy(received), tae.make_perms(tcfg, 'cpu'))
    assert got.shape == (B, 16, 1)
    _check(got, ref, dtype)


@pytest.mark.parametrize('encoder,decoder,n', PAIRS)
def test_forward_ae_matches_jax(encoder, decoder, n):
    """The whole pair through forward_ae in f32; bf16 decisions agree."""
    for dtype in ('float32', 'bfloat16'):
        jcfg, tcfg = _pair_cfgs(encoder, decoder, n, dtype=dtype)
        jp, tp = small_params(jcfg, seed=9)
        rng = np.random.RandomState(9)
        bits = (rng.random_sample((B, 16, 1)) < 0.5).astype(np.float32)
        noise = (0.5 * rng.standard_normal((B, 16, n))).astype(np.float32)
        with jax.default_matmul_precision('highest'):
            ref, ref_codes, _ = jae.forward_ae(jp, jcfg, jax.random.PRNGKey(0), jnp.asarray(bits),
                                               jnp.asarray(noise), jae.make_perms(jcfg),
                                               training=False)
        got, codes, _ = tae.forward_ae(tp, tcfg, torch.from_numpy(bits), torch.from_numpy(noise),
                                       tae.make_perms(tcfg, 'cpu'), training=False)
        _check(codes, ref_codes, dtype)
        _check(got, ref, dtype)
        if dtype == 'bfloat16':
            agree = (got.float().round().numpy() == np.round(np.asarray(ref, np.float32))).mean()
            assert agree > 0.99


@pytest.mark.parametrize('key', ['turboae_2int', 'TurboAE_rate2_cnn', 'rate2_cnn', 'rate3_cnn'])
def test_1d_zoo_encoders_build_with_dec_kernel_size(key):
    """The reference's quirk, kept by JAX (encoders.py:88-92): the 1D zoo
    encoders' stacks take dec_kernel_size, not enc_kernel_size."""
    enc, dec, n = _pair_of(key, 'encoder')
    jcfg, tcfg = _pair_cfgs(enc, dec, n, enc_kernel_size=3, dec_kernel_size=5)
    init, _ = tenc.make_encoder(tcfg)
    got = init(torch.Generator().manual_seed(0), tcfg)
    assert {tuple(l['w'].shape)[2] for b in got.values() for l in b['cnn']} == {5}
    jp, tp = small_params(jcfg, seed=10)
    bits = (np.random.RandomState(10).random_sample((B, 16, 1)) < 0.5).astype(np.float32)
    with jax.default_matmul_precision('highest'):
        ref, _ = J_ENC[key][1](jp['enc'], jcfg, jnp.asarray(bits), jae.make_perms(jcfg),
                               training=False)
    out, _ = tenc.make_encoder(tcfg)[1](tp['enc'], tcfg, torch.from_numpy(bits),
                                        tae.make_perms(tcfg, 'cpu'), training=False)
    _check(out, ref, 'float32')


def test_2d_decoder_heads_keep_elu_and_interleave_like_the_encoder():
    """DEC_LargeCNN2D's per-iteration heads keep their ELU (JAX
    decoders.py:532-534): a head whose bias is pushed to -1e4 gives ELU's
    floor -1, not -1e4. interleave_2d permutes the row-major pixels."""
    _, tcfg = _pair_cfgs('TurboAE_rate3_cnn2d', 'TurboAE_rate3_cnn2d', 3)
    x = torch.arange(2 * 3 * 16, dtype=torch.float32).reshape(2, 3, 4, 4)
    perms = tae.make_perms(tcfg, 'cpu')
    img = til.interleave_2d(x, perms['p1'])
    flat = x.reshape(2, 3, 16)[:, :, perms['p1']]
    torch.testing.assert_close(img.reshape(2, 3, 16), flat, rtol=0, atol=0)
    torch.testing.assert_close(til.deinterleave_2d(img, perms['p1_inv']), x, rtol=0, atol=0)
    params = tdec.largecnn2d_init(torch.Generator().manual_seed(0), tcfg)
    head = params['iters'][0]['dec1_out'][0]
    head['b'].fill_(-1e4)
    seen = []
    inner = tcv.stack2d_apply

    def record(layers, x, no_act=False, compute_dtype=torch.float32):
        y = inner(layers, x, no_act=no_act, compute_dtype=compute_dtype)
        if layers is params['iters'][0]['dec1_out']:
            seen.append((y, no_act))
        return y
    tcv.stack2d_apply = record
    try:
        tdec.largecnn2d_apply(params, tcfg, torch.randn(2, 16, 3), perms)
    finally:
        tcv.stack2d_apply = inner
    (y, no_act), = seen
    assert not no_act and torch.all(y == -1.0)


def _conv2d_layers(rng, num_layer, cin, c, k, dense):
    out = []
    for i in range(num_layer):
        n_in = cin + i * c if dense else (cin if i == 0 else c)
        out.append({'w': rng.uniform(-1, 1, (k, k, n_in, c)).astype(np.float32) / np.sqrt(n_in * k * k),
                    'b': rng.uniform(-0.3, 0.3, c).astype(np.float32)})
    return out


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('op', ['conv2d', 'stack2d', 'stack2d_no_act', 'dense_stack2d',
                                'dense_stack2d_no_act'])
def test_2d_ops_match_jax(op, dtype):
    rng = np.random.RandomState(len(op))
    dense = op.startswith('dense')
    layers = _conv2d_layers(rng, 1 if op == 'conv2d' else 3, 5, 8, 3, dense)
    x = rng.standard_normal((3, 4, 4, 5)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == 'float32' else (jnp.bfloat16,
                                                                          torch.bfloat16)
    jl, tl = jax.tree.map(jnp.asarray, layers), [_layer_from(l, 'cpu') for l in layers]
    assert tuple(tl[0]['w'].shape) == (8, 5, 3, 3)
    no_act = op.endswith('no_act')
    with jax.default_matmul_precision('highest'):
        if op == 'conv2d':
            ref = jcv.conv2d_apply(jl[0], jnp.asarray(x), compute_dtype=jdt)
        else:
            fn = jcv.dense_stack2d_apply if dense else jcv.stack2d_apply
            ref = fn(jl, jnp.asarray(x), no_act=no_act, compute_dtype=jdt)
    if op == 'conv2d':
        got = tcv.conv2d_apply(tl[0], torch.from_numpy(x), compute_dtype=tdt)
    else:
        fn = tcv.dense_stack2d_apply if dense else tcv.stack2d_apply
        got = fn(tl, torch.from_numpy(x), no_act=no_act, compute_dtype=tdt)
    assert got.dtype == tdt and got.shape == (3, 4, 4, 8)
    _check(got, ref, dtype)


def test_2d_inits_match_jax_shapes_and_bounds():
    gen = torch.Generator().manual_seed(0)
    for init, j_init, dense in ((tcv.stack2d_init, jcv.stack2d_init, False),
                                (tcv.dense_stack2d_init, jcv.dense_stack2d_init, True)):
        got = init(gen, 3, 5, 8, 3)
        ref = j_init(jax.random.PRNGKey(0), 3, 5, 8, 3)
        assert [t.shape for t in jax.tree.leaves(to_jax(got))] == \
            [t.shape for t in jax.tree.leaves(ref)]
        for i, layer in enumerate(got):
            fan_in = (5 + 8 * i if dense else (5 if i == 0 else 8)) * 9
            assert float(layer['w'].abs().max()) <= 1 / np.sqrt(fan_in)


def test_interleave_2d_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
    p = jil.rand_perm(16, 5)
    got = til.interleave_2d(torch.from_numpy(x), torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jil.interleave_2d(jnp.asarray(x), p)))
    back = til.deinterleave_2d(got, torch.from_numpy(til.invert_perm(p)))
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jil.deinterleave_2d(jnp.asarray(got.numpy()), p)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize('encoder,decoder,n', PAIRS)
def test_zoo_params_round_trip_and_match_the_port_init(encoder, decoder, n):
    """to_jax(from_jax(.)) is bit-identical on JAX's init (the 2D decoders'
    stacked scan included), and the converted tree has the port init's
    keys in the port init's leaf order and shapes."""
    jcfg, tcfg = _pair_cfgs(encoder, decoder, n)
    jp, tp = small_params(jcfg, seed=11)
    back = to_jax(from_jax(to_jax(tp)))
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    mine = tae.init_ae(torch.Generator().manual_seed(0), tcfg)
    assert [tuple(t.shape) for t in tree_leaves(mine)] == [tuple(t.shape) for t in tree_leaves(tp)]


@pytest.mark.parametrize('encoder,decoder,n', PAIRS)
def test_joint_step_gradients_match_jax(encoder, decoder, n):
    """The joint f32 loss and its gradients through Trainer, against
    value_and_grad of JAX's Trainer._loss on the same params and batch:
    loss to 1e-5 relative, each leaf's gradient to 1e-4 of its largest."""
    from turboae_tpu.train.trainer import Trainer as JaxTrainer
    from turboae_tpu_torch.train.trainer import Trainer
    jcfg, tcfg = _pair_cfgs(encoder, decoder, n, batch_size=B)
    jp, tp = small_params(jcfg, seed=12)
    rng = np.random.RandomState(12)
    bits = (rng.random_sample((B, 16, 1)) < 0.5).astype(np.float32)
    noise = rng.standard_normal((B, 16, n)).astype(np.float32)
    with jax.default_matmul_precision('highest'):
        ref_loss, ref_g = jax.value_and_grad(JaxTrainer(jcfg)._loss)(
            jax.tree.map(jnp.asarray, jp), None, lambda d, f: d, jax.random.PRNGKey(0),
            jnp.asarray(bits), jnp.asarray(noise))
    tr = Trainer(tcfg, 'cpu', params=tp)
    loss, grads = tr.loss_and_grads('joint', torch.from_numpy(bits), torch.from_numpy(noise))
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    got = from_jax(to_jax({h: tree_unflatten(tr.params[h], grads[h]) for h in ('enc', 'dec')}))
    ref = from_jax(jax.tree.map(np.asarray, ref_g))
    for g, r in zip(tree_leaves(got), tree_leaves(ref)):
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max()) + 1e-12

