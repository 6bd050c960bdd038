"""The port's conv-stack kernels K1 and K2 (kernels/conv_stack.py).

On the CPU a wrapper runs its kernel's plain version, which is held here
against the Pallas kernel run in interpret mode, at the Pallas tests'
tolerances: K1 (`_fused_forward`) to atol/rtol 2e-5 (tests/test_kernels.py:
25-30), K2 (`_fused_forward_im2col`) to a max relative error of 1e-2
(:33-41). The CUDA kernels themselves run only on the card: their tests are
in tests/test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from turboae_tpu.kernels.conv_stack import (_fused_forward, _fused_forward_im2col,
                                           fused_stack_apply as j_fused_stack_apply)
from turboae_tpu.ops.conv1d import stack_init
from turboae_tpu_torch.kernels import conv_stack as ks
from turboae_tpu_torch.ops.conv1d import stack_apply
from turboae_tpu_torch.train.convert import _conv_from

from _torch_parity import rel_err


def _mk(num_layer, k, cin=7, c=100, B=8, L=20, seed=0):
    jl = jax.tree.map(np.asarray, stack_init(jax.random.PRNGKey(seed), num_layer, cin, c, k))
    x = np.random.RandomState(seed).standard_normal((B, L, cin)).astype(np.float32)
    return jl, [_conv_from(l, 'cpu') for l in jl], x


@pytest.mark.parametrize('k', [1, 5])
@pytest.mark.parametrize('num_layer', [1, 2, 3])
def test_plain_matches_pallas_im2col(num_layer, k):
    jl, tl, x = _mk(num_layer, k)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_fused_forward_im2col(jax.tree.map(jnp.asarray, jl),
                                               jnp.asarray(x), tile_b=4), np.float32)
    got = ks.conv_stack_bf16_plain(tl, torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == (8, 20, 100)
    assert rel_err(got, ref) < 1e-2


def test_wrapper_on_cpu_is_the_plain_version():
    _, tl, x = _mk(2, 5)
    before = ks.conv_stack_bf16.launches
    got = ks.conv_stack_bf16(tl, torch.from_numpy(x))
    assert torch.equal(got, ks.conv_stack_bf16_plain(tl, torch.from_numpy(x)))
    assert ks.conv_stack_bf16.launches == before     # no kernel was launched


def test_wrapper_refuses_other_devices():
    _, tl, x = _mk(1, 5)
    with pytest.raises(ValueError):
        ks.conv_stack_bf16(tl, torch.from_numpy(x).to('meta'))


def test_pack_weights_layout():
    """The kernel reads w0[k*Cin + ci, c] == W[c, ci, k], zero beyond C."""
    _, tl, _ = _mk(3, 5, c=10)
    w0, b0, wr, br, cp = ks.pack_weights(tl)
    assert cp == 12 and w0.shape == (35, 12) and wr.shape == (2, 50, 12)
    assert w0.dtype == wr.dtype == torch.bfloat16 and b0.dtype == br.dtype == torch.float32
    w = tl[0]['w'].to(torch.bfloat16)
    for k in range(5):
        for ci in range(7):
            assert torch.equal(w0[k * 7 + ci, :10], w[:, ci, k])
    assert torch.equal(wr[1, 3 * 10 + 4, :10], tl[2]['w'].to(torch.bfloat16)[:, 4, 3])
    assert not w0[:, 10:].any() and not b0[10:].any() and not br[:, 10:].any()
    assert ks.pack_weights(tl[:1])[2] is None


def test_smem_bytes_and_limit():
    assert ks.smem_bytes(100, 100, 5, 5) == 2 * 104 * 100 * 2
    assert ks.smem_bytes(100, 100, 5, 1) == 0
    assert ks.smem_bytes(100, 100, 5, 5) < ks.SMEM_LIMIT < ks.smem_bytes(1100, 100, 5, 2)


def test_backward_recomputes_unfused_f32():
    """Gradients are those of the unfused f32 stack for the kernel's cotangent."""
    _, tl, x = _mk(2, 5, c=16, B=3, L=12)
    leaves = [t.clone().requires_grad_(True) for p in tl for t in (p['w'], p['b'])]
    layers = [{'w': leaves[2 * i], 'b': leaves[2 * i + 1]} for i in range(2)]
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ks.fused_stack_apply_bf16(layers, xt)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0)).to(out.dtype)
    got = torch.autograd.grad(out, [xt, *leaves], g)

    x2 = torch.from_numpy(x).requires_grad_(True)
    leaves2 = [t.detach().clone().requires_grad_(True) for t in leaves]
    ref_out = stack_apply([{'w': leaves2[2 * i], 'b': leaves2[2 * i + 1]} for i in range(2)], x2)
    ref = torch.autograd.grad(ref_out, [x2, *leaves2], g.float())
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# ---------------------------------------------------------------- K1
@pytest.mark.parametrize('B', [8, 5])
@pytest.mark.parametrize('k', [1, 5])
@pytest.mark.parametrize('num_layer', [1, 2, 3])
def test_f32_plain_matches_pallas(num_layer, k, B):
    jl, tl, x = _mk(num_layer, k, B=B)
    with pltpu.force_tpu_interpret_mode(), jax.default_matmul_precision('highest'):
        ref = np.asarray(_fused_forward(jax.tree.map(jnp.asarray, jl), jnp.asarray(x),
                                        tile_b=1 if B % 4 else 4))
    got = ks.conv_stack_f32_plain(tl, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (B, 20, 100)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_f32_wrapper_on_cpu_is_the_plain_version():
    _, tl, x = _mk(3, 5)
    before = ks.conv_stack_f32.launches
    got = ks.conv_stack_f32(tl, torch.from_numpy(x))
    assert torch.equal(got, ks.conv_stack_f32_plain(tl, torch.from_numpy(x)))
    assert ks.conv_stack_f32.launches == before
    with pytest.raises(ValueError):
        ks.conv_stack_f32(tl, torch.from_numpy(x).to('meta'))


def test_f32_pack_weights_layout():
    _, tl, _ = _mk(2, 3, c=10)
    w0, b0, wr, br, cp = ks.pack_weights(tl, torch.float32)
    assert cp == 12 and w0.shape == (21, 12) and wr.shape == (1, 30, 12)
    assert w0.dtype == wr.dtype == torch.float32
    assert torch.equal(w0[2 * 7 + 4, :10], tl[0]['w'][:, 4, 2])
    assert torch.equal(wr[0, 1 * 10 + 9, :10], tl[1]['w'][:, 9, 1])


def test_fused_f32_grads_match_jax():
    """K1's backward recomputes the unfused f32 stack, as JAX's `_bwd`."""
    jl, tl, x = _mk(3, 5, c=16, B=3, L=12)
    g = np.random.RandomState(5).standard_normal((3, 12, 16)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode(), jax.default_matmul_precision('highest'):
        _, vjp = jax.vjp(j_fused_stack_apply, jax.tree.map(jnp.asarray, jl), jnp.asarray(x))
        ref_l, ref_x = vjp(jnp.asarray(g))
    leaves = [t.clone().requires_grad_(True) for p in tl for t in (p['w'], p['b'])]
    layers = [{'w': leaves[2 * i], 'b': leaves[2 * i + 1]} for i in range(3)]
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ks.fused_stack_apply(layers, xt)
    assert out.dtype == torch.float32
    got = torch.autograd.grad(out, [xt, *leaves], torch.from_numpy(g))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref_x), atol=2e-5, rtol=2e-5)
    for i, lr in enumerate(ref_l):
        np.testing.assert_allclose(got[1 + 2 * i].permute(2, 1, 0).numpy(), np.asarray(lr['w']),
                                   atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(got[2 + 2 * i].numpy(), np.asarray(lr['b']),
                                   atol=2e-5, rtol=2e-5)


def test_fused_backward_computes_only_what_is_asked():
    _, tl, x = _mk(2, 5, c=16, B=2, L=10)
    w = tl[0]['w'].clone().requires_grad_(True)
    layers = [{'w': w, 'b': tl[0]['b']}, tl[1]]
    out = ks.fused_stack_apply(layers, torch.from_numpy(x))
    (gw,) = torch.autograd.grad(out.sum(), [w])
    assert gw.shape == w.shape


# ---------------------------------------------------------------- long blocks
@pytest.mark.parametrize('L,rows,num_layer,k', [(50, 20, 3, 5), (97, 30, 2, 3),
                                                (64, 64, 2, 5), (41, 13, 1, 5),
                                                (40, 11, 4, 1)])
def test_window_plan_covers_each_row_once_with_its_halo(L, rows, num_layer, k):
    halo = num_layer * (k // 2)
    idx_in, idx_out, r = ks.window_plan(L, rows, halo)
    assert r <= rows and idx_in.numel() % r == 0 and idx_out.shape == (L,)
    win = idx_in.reshape(-1, r)
    assert int(win.min()) >= 0 and int(win.max()) < L
    for t in range(L):                         # row t is kept from window w
        w, local = divmod(int(idx_out[t]), r)
        assert int(win[w, local]) == t
        lo, hi = int(win[w, 0]), int(win[w, -1])
        assert (lo == 0 or t - lo >= halo) and (hi == L - 1 or hi - t >= halo)


def test_window_plan_refuses_a_window_that_is_all_halo():
    with pytest.raises(ValueError, match='shared memory'):
        ks.window_plan(100, 20, 10)


@pytest.mark.parametrize('num_layer,k', [(3, 5), (2, 3), (1, 5), (5, 5)])
def test_windowed_stack_equals_the_whole_stack(num_layer, k):
    """The windowing of long blocks, run on the plain versions at a window
    shorter than L: f32 to 1e-6 (the matmuls see other row counts, so their
    blocking and summation order may change), bf16 to 1e-2 relative."""
    _, tl, x = _mk(num_layer, k, c=24, B=3, L=90)
    xt = torch.from_numpy(x)
    got = ks.run_windowed(ks.conv_stack_f32_plain, tl, xt, rows=37)
    np.testing.assert_allclose(got.numpy(), ks.conv_stack_f32_plain(tl, xt).numpy(),
                               atol=1e-6, rtol=1e-6)
    got = ks.run_windowed(ks.conv_stack_bf16_plain, tl, xt, rows=37)
    assert got.dtype == torch.bfloat16
    assert rel_err(got, ks.conv_stack_bf16_plain(tl, xt)) < 1e-2


def test_long_block_window_at_the_k1000_shape():
    """At L=1000, C=100, K=5 and 5 layers neither kernel's buffers fit in
    shared memory, so the wrappers window: K1 into 4 windows of 270 rows, K2
    into 2 windows of 520; the main path's L=100 fits in one."""
    assert ks.smem_bytes(100, 100, 5, 5, 4) <= ks.SMEM_LIMIT
    for itemsize, n_win, rows in ((4, 4, 270), (2, 2, 520)):
        assert ks.smem_bytes(1000, 100, 5, 5, itemsize) > ks.SMEM_LIMIT
        idx_in, _, r = ks.window_plan(1000, ks.max_rows(100, 5, itemsize), 10)
        assert (idx_in.numel() // r, r) == (n_win, rows)
        assert ks.smem_bytes(r, 100, 5, 5, itemsize) <= ks.SMEM_LIMIT
    _, tl, x = _mk(5, 5, c=100, B=2, L=1000)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(
        ks.run_windowed(ks.conv_stack_f32_plain, tl, xt, ks.max_rows(100, 5, 4)).numpy(),
        ks.conv_stack_f32_plain(tl, xt).numpy(), atol=1e-6, rtol=1e-6)


def test_conv_stack_work_counts():
    flops, nbytes = ks.conv_stack_work(500, 100, 7, 100, 5, 5, 4)
    assert flops == 2 * 500 * 100 * 5 * 100 * (7 + 4 * 100) == 20350000000
    assert nbytes == (500 * 100 * 7 + 5 * 7 * 100 + 4 * 5 * 100 * 100 + 500 * 100 * 100) * 4 \
        + 5 * 100 * 4
