"""The port's biGRU/biLSTM (turboae_tpu_torch/ops/gru.py, its plain scan)
against the JAX package's lax.scan version (turboae_tpu/ops/gru.py) on the
CPU: params made by the JAX init and converted, inputs from numpy at a fixed
seed, the JAX side at 'highest' matmul precision. f32 within 1e-5, bf16
operands within 1e-2 relative (the repo's bf16 tolerance); gradients of a
scalar loss within 1e-5; the inter-layer dropout's mask by statistics."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turboae_tpu.ops import gru as jgru
from turboae_tpu_torch.ops import gru as tgru
from turboae_tpu_torch.train.convert import from_jax

from _torch_parity import rel_err, to_np

B, L, IN, H = 5, 9, 3, 6


def _jax_stack(kind, n_layers, in_size=IN, seed=0):
    layers = jgru.birnn_init(jax.random.PRNGKey(seed), in_size, H, n_layers, kind)
    return layers, from_jax(jax.tree.map(np.asarray, layers))


def _x(seed=1, shape=(B, L, IN)):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('n_layers', [1, 2])
@pytest.mark.parametrize('kind', ['gru', 'lstm'])
def test_birnn_matches_jax(kind, n_layers, dtype):
    jl, tl = _jax_stack(kind, n_layers)
    x = _x()
    jdt = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    with jax.default_matmul_precision('highest'):
        ref = jgru.birnn_apply(jl, jnp.asarray(x), kind, compute_dtype=jdt)
    got = tgru.birnn_apply(tl, torch.from_numpy(x), kind,
                           compute_dtype=getattr(torch, dtype))
    assert got.shape == (B, L, 2 * H) and got.dtype == torch.float32
    if dtype == 'float32':
        np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=1e-5, atol=1e-5)
    else:
        assert rel_err(got, ref) < 1e-2


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('kind', ['gru', 'lstm'])
def test_each_direction_matches_jax(kind, reverse):
    """One direction alone: the reverse scan's outputs in input order."""
    jl, tl = _jax_stack(kind, 1)
    x = _x(2)
    jscan = jgru._lstm_scan if kind == 'lstm' else jgru._gru_scan
    with jax.default_matmul_precision('highest'):
        ref = jscan(jl[0]['fwd'], jnp.asarray(x), reverse, jnp.float32)
    got = tgru._scan(tl[0]['fwd'], torch.from_numpy(x), reverse, kind, torch.float32)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # the last step processed holds the whole sequence: the first position
    # of the reverse direction, the last of the forward one
    assert not np.allclose(to_np(got)[:, 0], to_np(got)[:, -1])


@pytest.mark.parametrize('kind', ['gru', 'lstm'])
def test_gradients_match_jax(kind):
    jl, tl = _jax_stack(kind, 2)
    x = _x(3)
    wout = np.random.RandomState(4).standard_normal((B, L, 2 * H)).astype(np.float32)

    def jloss(layers, xx):
        return jnp.sum(jgru.birnn_apply(layers, xx, kind) * wout)
    with jax.default_matmul_precision('highest'):
        jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jl, jnp.asarray(x))
    leaves = [t for layer in tl for d in ('fwd', 'bwd') for t in layer[d].values()]
    for t in leaves:
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = (tgru.birnn_apply(tl, xt, kind) * torch.from_numpy(wout)).sum()
    grads = torch.autograd.grad(loss, leaves + [xt])
    ref = [t for layer in from_jax(jax.tree.map(np.asarray, jg_p))
           for d in ('fwd', 'bwd') for t in layer[d].values()] + [torch.from_numpy(np.array(jg_x))]
    for g, r in zip(grads, ref):
        scale = float(r.abs().max())
        assert float((g - r).abs().max()) <= 1e-5 * max(1.0, scale)


def test_init_is_torch_default_and_matches_jax_shapes():
    gen = torch.Generator().manual_seed(0)
    for kind, gates in (('gru', 3), ('lstm', 4)):
        tl = tgru.birnn_init(gen, IN, H, 2, kind)
        _, jl = _jax_stack(kind, 2)
        assert [tuple(t.shape) for layer in tl for d in layer.values() for t in d.values()] == \
            [tuple(t.shape) for layer in jl for d in layer.values() for t in d.values()]
        assert tl[0]['fwd']['w_ih'].shape == (gates * H, IN)
        assert tl[1]['bwd']['w_ih'].shape == (gates * H, 2 * H)
        for layer in tl:
            for d in layer.values():
                for t in d.values():
                    assert float(t.abs().max()) <= 1.0 / np.sqrt(H)


def test_dropout_share_and_placement():
    """The keep mask drops about `rate` of the first layer's outputs, scales
    the rest by 1/keep, comes from the caller's generator only, and the last
    layer's outputs are never dropped."""
    rate = 0.3
    x = torch.from_numpy(_x(5, (64, 50, 2 * H)))
    g = torch.Generator().manual_seed(3)
    state = torch.random.get_rng_state()
    y = tgru._interlayer_dropout(x, rate, g, 0, 2)
    assert torch.equal(torch.random.get_rng_state(), state)
    dropped = float((y == 0).float().mean())
    n = x.numel()
    assert abs(dropped - rate) < 4 * np.sqrt(rate * (1 - rate) / n)
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / (1 - rate))
    assert torch.equal(tgru._interlayer_dropout(x, rate, g, 1, 2), x)     # the last layer
    assert torch.equal(tgru._interlayer_dropout(x, rate, None, 0, 2), x)  # no generator
    # through a stack: one layer gets no dropout at all; two layers draw
    # from the generator and differ from the undropped output
    _, tl1 = _jax_stack('gru', 1, 2 * H)
    assert torch.equal(tgru.bigru_apply(tl1, x[:4], dropout=rate, generator=g),
                       tgru.bigru_apply(tl1, x[:4]))
    _, tl2 = _jax_stack('gru', 2, 2 * H)
    a = tgru.bigru_apply(tl2, x[:4], dropout=rate, generator=torch.Generator().manual_seed(9))
    b = tgru.bigru_apply(tl2, x[:4], dropout=rate, generator=torch.Generator().manual_seed(9))
    assert torch.equal(a, b) and not torch.equal(a, tgru.bigru_apply(tl2, x[:4]))


def test_cpu_takes_the_scan_and_refuses_cudnn():
    _, tl = _jax_stack('gru', 1)
    x = torch.from_numpy(_x())
    before = dict(tgru.ROUTE_CALLS)
    tgru.bigru_apply(tl, x)
    assert tgru.ROUTE_CALLS['scan'] == before['scan'] + 1
    assert tgru.ROUTE_CALLS['cudnn'] == before['cudnn']
    with pytest.raises(ValueError, match='CUDA'):
        tgru.bigru_apply(tl, x, route='cudnn')
