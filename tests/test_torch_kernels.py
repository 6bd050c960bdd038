"""The port's conv-stack kernel K2 (kernels/conv_stack.py).

On the CPU the wrapper runs the kernel's plain version, which is held here
against the Pallas kernel `_fused_forward_im2col` run in interpret mode, at
the Pallas tests' bf16 tolerance (max relative error < 1e-2, as
tests/test_kernels.py:33-41). The CUDA kernel itself runs only on the card:
its tests are in tests/test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from turboae_tpu.kernels.conv_stack import _fused_forward_im2col
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
