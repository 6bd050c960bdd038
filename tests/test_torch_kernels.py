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
from turboae_tpu_torch.train.convert import _layer_from

from _torch_parity import rel_err


def _mk(num_layer, k, cin=7, c=100, B=8, L=20, seed=0):
    jl = jax.tree.map(np.asarray, stack_init(jax.random.PRNGKey(seed), num_layer, cin, c, k))
    x = np.random.RandomState(seed).standard_normal((B, L, cin)).astype(np.float32)
    return jl, [_layer_from(l, 'cpu') for l in jl], x


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


def _k2_unpack(chunks, plan):
    """K2's packed weight chunks (..., ngroups, nch, N*64) read back as the
    kernel's wgmma reads them: for k16 step ks of chunk (g, c) the
    descriptor starts 32*ks bytes into the chunk, with 1024 bytes between
    8-row groups of N and 128 between the rows of a group; value (k, n) of
    the step lies at that address plus 2*k, with the 128-byte swizzle applied
    (address bits 4-6 ^= bits 7-9). Returns the dense (..., nch*64,
    ngroups*N) W'."""
    N, ng = plan.N, plan.ngroups
    nch = chunks.shape[-2]
    ks, k, n = torch.arange(4).view(4, 1, 1), torch.arange(16).view(1, 16, 1), torch.arange(N)
    addr = 32 * ks + n // 8 * 1024 + n % 8 * 128 + 2 * k           # (4, 16, N) bytes
    addr = addr ^ ((addr >> 7) & 7) << 4
    steps = chunks[..., addr // 2]                                  # (..., ng, nch, 4, 16, N)
    lead = chunks.shape[:-3]
    d = len(lead)              # to (..., nch, 4, 16, ng, N): row c*64 + 16*ks + k, column g*N + n
    return steps.permute(*range(d), d + 1, d + 2, d + 3, d, d + 4).reshape(*lead, nch * 64, ng * N)


def test_pack_weights_layout():
    """K2 reads W'[k*S + ci, c] == W[c, ci, k] (S0 for layer 0) through
    wgmma's descriptor over 128-byte-swizzled, K-major chunks of 64 rows and
    N = 32 columns (C = 10): zero where ci or c >= C and in the rows from
    K*S up to the chunks' end; value (k, n) of a chunk at (n//8)*512 +
    (n%8)*64 + ((k//8) ^ (n%8))*8 + k%8; biases f32, zero beyond C. K1's
    packer, like K2's, gives no hidden-layer weights for one layer."""
    _, tl, _ = _mk(3, 5, c=10)
    plan = ks.k2_layout(20, 7, 10, 5, 3, R=2)
    assert (plan.S, plan.S0, plan.N, plan.ngroups, plan.Kc, plan.Kc0) == (24, 8, 32, 1, 128, 48)
    w0, b0, wr, br = ks.pack_weights_bf16(tl, plan)
    assert w0.shape == (1, 1, 32 * 64) and b0.shape == (32,)
    assert wr.shape == (2, 1, 2, 32 * 64) and br.shape == (2, 32)
    assert w0.dtype == wr.dtype == torch.bfloat16 and b0.dtype == br.dtype == torch.float32
    w = tl[2]['w'].to(torch.bfloat16)
    row = 3 * 24 + 4                         # tap 3, channel 4: chunk 1, row 12
    for c in range(10):
        at = c // 8 * 512 + c % 8 * 64 + ((12 // 8) ^ (c % 8)) * 8 + 12 % 8
        assert wr[1, 0, row // 64, at] == w[c, 4, 3]
    d0, dr = _k2_unpack(w0, plan), _k2_unpack(wr, plan)
    assert d0.shape == (64, 32) and dr.shape == (2, 128, 32)
    w = tl[0]['w'].to(torch.bfloat16)
    for k in range(5):
        for ci in range(7):
            assert torch.equal(d0[k * 8 + ci, :10], w[:, ci, k])
        assert not d0[k * 8 + 7].any()
    assert torch.equal(dr[1, 3 * 24 + 4, :10], tl[2]['w'].to(torch.bfloat16)[:, 4, 3])
    assert torch.equal(br[0, :10], tl[1]['b'].float())
    pad_rows = torch.tensor([k * 24 + ci for k in range(5) for ci in range(10, 24)]
                            + list(range(120, 128)))
    assert not dr[:, pad_rows].any() and not d0[40:].any()
    assert not d0[:, 10:].any() and not dr[:, :, 10:].any()
    assert not b0[10:].any() and not br[:, 10:].any()
    assert ks.pack_weights_bf16(tl[:1], plan)[2] is None
    assert ks.pack_weights(tl[:1], ks.k1_layout(20, 7, 10, 5, 1, R=2))[2] is None


def test_k2_wide_weights_take_column_groups():
    """Above 256 channels K2's weights split into column groups (C = 300:
    two of N = 256, here at a short L that fits), each group's chunks
    following the last's; the descriptor's reading gives W' back."""
    _, tl, _ = _mk(2, 3, c=300)
    plan = ks.k2_layout(12, 7, 300, 3, 2, R=1)
    assert (plan.N, plan.ngroups, plan.S, plan.Kc) == (256, 2, 312, 944)
    w0, b0, wr, br = ks.pack_weights_bf16(tl, plan)
    assert wr.shape == (1, 2, 15, 256 * 64) and br.shape == (1, 512)
    d = _k2_unpack(wr, plan)[0]
    w = tl[1]['w'].to(torch.bfloat16)
    assert torch.equal(d[2 * 312 + 299, :300], w[:, 299, 2])
    assert torch.equal(d[1 * 312 + 7, 256:300], w[256:, 7, 1])
    assert not d[:, 300:].any() and not br[0, 300:].any()


def test_smem_bytes_and_limit():
    """K1 at the bench's shape: two batch rows a block in two consumer
    warpgroups of two m64 x n104 tiles each, one f32 buffer of 261 rows of
    stride 100, x's buffer of 261 rows of stride 12, a ring of four
    26,624-byte chunks (a big and a small plane of 32 rows of 104 columns),
    five f32 biases and eight mbarriers, after up to 1024 bytes that align
    the ring; three rows (five tiles) take three warpgroups, one more than
    one SM's registers hold at n104 with two tiles each and the partial
    set. K2 at the
    decoder's shape: three batch rows a block in five warpgroups of one m64
    x n104 tile (308 rows of the fold), two bf16 buffers of 325 rows of
    stride 104, x's buffer of 325 rows of stride 8, a ring of four 13,312-byte
    chunks (64 rows of 104 columns), five f32 biases and eight mbarriers,
    after up to 1024 bytes that align the ring; four rows need seven
    warpgroups, two more than one SM's registers hold at n104."""
    k1 = ks.k1_plan(500, 100, 7, 100, 5, 5, n_sm=132)
    assert (k1.R, k1.nc, k1.tpw, k1.N, k1.ngroups, k1.stages) == (2, 2, 2, 104, 1, 4)
    assert (k1.rows_alloc, k1.rows_alloc0) == (261, 261)
    assert k1.smem == (1024 + 4 * 104 * 256 + 4 * (261 * 100 + 261 * 12) + 4 * 5 * 104
                       + 16 * 4) == 226592
    assert k1.smem <= ks.SMEM_LIMIT
    assert ks.k1_plan(2000, 100, 7, 100, 5, 5, n_sm=132) == k1
    three = ks.k1_layout(100, 7, 100, 5, 5, R=3)
    assert (three.nc, three.tpw) == (3, 2) and not three.fits()
    plan = ks.k2_plan(2000, 100, 7, 100, 5, 5, n_sm=132)
    assert (plan.R, plan.G, plan.nc, plan.N, plan.ngroups, plan.stages) == (3, 792, 5, 104, 1, 4)
    assert (plan.Kc, plan.Kc0, plan.rows_alloc, plan.rows_alloc0) == (528, 48, 325, 325)
    assert plan.smem == (1024 + 4 * 104 * 128 + 2 * (2 * 325 * 104 + 325 * 8)
                         + 4 * 5 * 104 + 16 * 4) == 196816
    assert plan.smem <= ks.SMEM_LIMIT
    assert len(plan.as_ints()) == 18
    four = ks.k2_layout(100, 7, 100, 5, 5, R=4)
    assert four.nc == 7 and not four.fits()
    # the wgmma width and column groups of each channel count
    assert [ks.k2_width(c) for c in (7, 25, 30, 64, 100, 104, 128, 200, 256, 300, 1000)] == [
        (32, 1), (32, 1), (32, 1), (104, 1), (104, 1), (104, 1), (128, 1), (256, 1), (256, 1),
        (256, 2), (256, 4)]
    wide = [ks.k2_plan(500, 100, 7, c, 5, 5, n_sm=132) for c in (25, 128, 256)]
    assert [(p.N, p.nc, p.R, p.stages) for p in wide] == [(32, 7, 4, 4), (128, 4, 2, 4),
                                                         (256, 2, 1, 2)]
    assert ks.k2_plan(2, 100, 7, 100, 5, 5, n_sm=1).R == 2       # never more rows than B
    assert ks.k2_plan(1, 400, 7, 100, 5, 5, n_sm=132) is None    # windowed
    assert [ks.k2_stride(c) for c in (7, 25, 30, 100, 128, 256)] == [8, 40, 40, 104, 136, 264]


@pytest.mark.parametrize('B', [2000, 1001, 500, 334, 333, 64, 7, 1])
@pytest.mark.parametrize('L,c', [(100, 100), (100, 25), (100, 128), (100, 256), (37, 100),
                                 (270, 100), (23, 30)])
def test_k2_plan_fills_whole_rounds(B, L, c):
    """K2's rounds rule: with Rmax the most rows a block of the layout holds,
    ceil(B / (n_sm * Rmax)) rounds of blocks over 132 SMs, in G blocks that
    fill every round (or one block a row), the rows shared out evenly (each
    block ceil(B/G) or one fewer, never more than R, R never above Rmax);
    every plan fits a block's 227 KB and its registers."""
    plan = ks.k2_plan(B, L, 7, c, 5, 5, n_sm=132)
    r_max = 1
    while ks.k2_layout(L, 7, c, 5, 5, r_max + 1).fits() and r_max < B:
        r_max += 1
    rounds = -(-B // (132 * r_max))
    assert plan.G == min(B, 132 * rounds) and plan.R <= r_max
    sizes = [(i + 1) * B // plan.G - i * B // plan.G for i in range(plan.G)]
    assert sum(sizes) == B and max(sizes) == plan.R and min(sizes) >= plan.R - 1
    assert plan.fits() and plan.smem <= ks.SMEM_LIMIT == 232448
    assert plan.nc * 64 >= plan.R * plan.P - 4 and plan.nc <= ks.K2_WIDTHS[plan.N]
    # at the decoder's shape: whole rounds where the one-block-a-row rule
    # left a sixth round of 7 blocks at B=2000
    if (L, c) == (100, 100):
        assert (plan.R, plan.G) == {2000: (3, 792), 1001: (3, 396), 500: (2, 264),
                                    334: (3, 132), 333: (3, 132), 64: (1, 64), 7: (1, 7),
                                    1: (1, 1)}[B]


def _k2_model(layers, x, plan):
    """K2's arithmetic in K2's own layout, on the CPU: block i takes batch
    rows [i*B//G, (i+1)*B//G) into one flat, zeroed, halo-padded buffer of
    stride S0 (then S); each layer the product of the strided A view (row m
    = [m*S, m*S + Kc)) over the m64 tiles that hold a row of the block with
    W' as wgmma reads it from the swizzled chunks (`_k2_unpack`), in f32;
    bias, ELU and bf16 over the N-wide column groups, written to the rows
    and columns the kernel's epilogue writes (valid rows, shifted by K//2;
    columns below S); the output read back from them. The contraction is
    cut at the taps (and at K*S, before the tail rows), which sums in the
    plain version's order."""
    w0, b0, wr, br = ks.pack_weights_bf16(layers, plan)
    dense0 = _k2_unpack(w0, plan)
    dense = _k2_unpack(wr, plan) if wr is not None else None
    B, L, Cin = x.shape
    P, pad, S, GN = plan.P, plan.K // 2, plan.S, plan.ngroups * plan.N
    outs = []
    for i in range(plan.G):
        r0, r1 = i * B // plan.G, (i + 1) * B // plan.G
        Rv = r1 - r0
        assert 1 <= Rv <= plan.R
        tiles = -(-(Rv * P - (plan.K - 1)) // 64)
        assert tiles <= plan.nc
        m = torch.arange(64 * tiles)
        valid = (m // P < Rv) & (m % P < L)
        src = torch.zeros(plan.rows_alloc0 * plan.S0, dtype=torch.bfloat16)
        for r in range(Rv):
            src.view(-1, plan.S0)[r * P + pad:r * P + pad + L, :Cin] = x[r0 + r].to(torch.bfloat16)
        for j in range(plan.num_layer):
            Ss, Kc = (plan.S0, plan.Kc0) if j == 0 else (S, plan.Kc)
            W, b = (dense0, b0) if j == 0 else (dense[j - 1], br[j - 1])
            A = torch.as_strided(src, (64 * tiles, Kc), (Ss, 1))
            cuts = [k * Ss for k in range(plan.K + 1)] + [Kc]
            v = sum(A[:, a:e].float() @ W[a:e].float() for a, e in zip(cuts, cuts[1:]) if e > a)
            y = torch.nn.functional.elu(v + b).to(torch.bfloat16)[:, :min(S, GN)]
            src = torch.zeros(plan.rows_alloc * S, dtype=torch.bfloat16)
            src.view(-1, S)[m[valid] + pad, :y.shape[1]] = y[valid]
        res = src.view(-1, S)
        outs += [res[r * P + pad:r * P + pad + L, :plan.C] for r in range(Rv)]
    return torch.stack(outs)


@pytest.mark.parametrize('num_layer', [1, 2, 5])
@pytest.mark.parametrize('k', [1, 3, 5])
@pytest.mark.parametrize('c', [30, 25, 100, 128, 256])
def test_k2_layout_model_equals_plain(c, k, num_layer):
    """The kernel's layout, swizzled packer, descriptor reads and row mask,
    run on the CPU, give the plain version's output (1e-5 relative): B =
    2 Rmax + 1 rows over two SMs leaves blocks of fewer rows than the plan
    holds, and m64 tiles the rows fill in part, wherever a block holds more
    than one row."""
    _, tl, _ = _mk(num_layer, k, c=c)
    r_max = 1
    while ks.k2_layout(100, 7, c, k, num_layer, r_max + 1).fits():
        r_max += 1
    B = 2 * r_max + 1
    plan = ks.k2_plan(B, 100, 7, c, k, num_layer, n_sm=2)
    x = torch.from_numpy(np.random.RandomState(3).standard_normal((B, 100, 7)).astype(np.float32))
    got = _k2_model(tl, x, plan)
    ref = ks.conv_stack_bf16_plain(tl, x)
    assert got.shape == ref.shape == (B, 100, c) and got.dtype == torch.bfloat16
    assert rel_err(got, ref.float().numpy()) < 1e-5


@pytest.mark.parametrize('k', [3, 5])
def test_k2_layout_model_two_column_groups(k):
    """Above 256 channels (C = 300, two groups of n256) a layer runs its
    column groups one after another, each from its own chunks and into its
    own columns of the next buffer; at L = 40, where such a block fits, the
    model equals the plain version (1e-5 relative)."""
    _, tl, _ = _mk(2, k, c=300)
    plan = ks.k2_plan(3, 40, 7, 300, k, 2, n_sm=2)
    assert (plan.N, plan.ngroups, plan.stages) == (256, 2, 4)
    x = torch.from_numpy(np.random.RandomState(4).standard_normal((3, 40, 7)).astype(np.float32))
    got = _k2_model(tl, x, plan)
    assert rel_err(got, ks.conv_stack_bf16_plain(tl, x).float().numpy()) < 1e-5


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


def _k1_unpack(chunks, plan):
    """K1's packed weight chunks (..., nch, ngroups, 2, N*32) read back as
    the kernel's wgmma reads them: for k8 step ks of plane (big, small) of
    chunk (c, g) the descriptor starts 32*ks bytes into the plane, with 1024
    bytes between 8-row groups of N and 128 between the rows of a group;
    value (k, n) of the step lies at that address plus 4*k, with the
    128-byte swizzle applied (address bits 4-6 ^= bits 7-9). Returns the
    dense (big, small) W' planes, (..., nch*32, ngroups*N) each."""
    N, ng = plan.N, plan.ngroups
    nch = chunks.shape[-4]
    ks_, k, n = torch.arange(4).view(4, 1, 1), torch.arange(8).view(1, 8, 1), torch.arange(N)
    addr = 32 * ks_ + n // 8 * 1024 + n % 8 * 128 + 4 * k          # (4, 8, N) bytes
    addr = addr ^ ((addr >> 7) & 7) << 4
    steps = chunks[..., addr // 4]                # (..., nch, ng, 2, 4, 8, N)
    lead = chunks.shape[:-4]
    d = len(lead)         # to (..., 2, nch, 4, 8, ng, N): row c*32 + 8*ks + k, column g*N + n
    dense = steps.permute(*range(d), d + 2, d, d + 3, d + 4, d + 1, d + 5)
    dense = dense.reshape(*lead, 2, nch * 32, ng * N)
    return dense[..., 0, :, :], dense[..., 1, :, :]


def test_f32_pack_weights_layout():
    """K1 reads W'[k*S + ci, c] == W[c, ci, k] (S0 for layer 0) through
    wgmma's descriptor over 128-byte-swizzled, K-major chunks of 32 rows and
    N = 32 columns (C = 10), each a TF32 big plane then a small one: zero
    where ci or c >= C and in the rows from K*S up to the chunks' end; value
    (k, n) of a plane at (n//8)*256 + (n%8)*32 + ((k//4) ^ (n%8))*4 + k%4;
    biases f32, zero beyond C."""
    _, tl, _ = _mk(2, 3, c=10)
    plan = ks.k1_layout(20, 7, 10, 3, 2, R=2)
    assert (plan.S, plan.S0, plan.N, plan.ngroups, plan.Kc, plan.Kc0) == (12, 12, 32, 1, 40, 40)
    w0, b0, wr, br = ks.pack_weights(tl, plan)
    assert w0.shape == (2, 1, 2, 32 * 32) and b0.shape == (32,)
    assert wr.shape == (1, 2, 1, 2, 32 * 32) and br.shape == (1, 32)
    assert w0.dtype == wr.dtype == b0.dtype == br.dtype == torch.float32
    big, small = ks.tf32_split(tl[1]['w'])
    row = 1 * 12 + 9                         # tap 1, channel 9: chunk 0, row 21
    for c in range(10):
        at = c // 8 * 256 + c % 8 * 32 + ((row // 4) ^ (c % 8)) * 4 + row % 4
        assert wr[0, 0, 0, 0, at] == big[c, 9, 1] and wr[0, 0, 0, 1, at] == small[c, 9, 1]
    (d0, s0), (dr, sr) = _k1_unpack(w0, plan), _k1_unpack(wr, plan)
    assert d0.shape == (64, 32) and dr.shape == (1, 64, 32)
    for k in range(3):
        for ci in range(7):
            assert torch.equal((d0 + s0)[k * 12 + ci, :10],
                               sum(ks.tf32_split(tl[0]['w'][:, ci, k])))
    assert torch.equal(b0[:10], tl[0]['b']) and torch.equal(br[0, :10], tl[1]['b'])
    pad0 = torch.tensor([k * 12 + ci for k in range(3) for ci in range(7, 12)]
                        + list(range(36, 64)))
    padr = torch.tensor([k * 12 + ci for k in range(3) for ci in range(10, 12)]
                        + list(range(36, 64)))
    for plane in (d0, s0):
        assert not plane[pad0].any() and not plane[:, 10:].any()
    for plane in (dr, sr):
        assert not plane[:, padr].any() and not plane[:, :, 10:].any()
    assert not b0[10:].any() and not br[:, 10:].any()


@pytest.mark.parametrize('c,k,num_layer', [(10, 3, 2), (100, 5, 5), (256, 5, 2), (25, 1, 3)])
def test_k1_planes_rebuild_the_weights(c, k, num_layer):
    """K1's two packed planes, read back by the descriptor's arithmetic:
    big + small gives every weight of W' to 2^-22 relative, both planes are
    TF32 (low 13 bits zero), and every padded position (ci >= C, c >= C,
    rows from K*S to the chunks' end) is exactly 0 in both; over two column
    groups at C = 256."""
    _, tl, _ = _mk(num_layer, k, c=c)
    plan = ks.k1_layout(20, 7, c, k, num_layer, R=1)
    w0, _, wr, _ = ks.pack_weights(tl, plan)
    for packed, layers, cin, S in ((w0, tl[:1], 7, plan.S0), (wr, tl[1:], c, plan.S)):
        assert not (packed.view(torch.int32) & 0x1FFF).any()
        big, small = _k1_unpack(packed.reshape(-1, *packed.shape[-4:]), plan)
        dense = torch.zeros(big.shape)
        for i, layer in enumerate(layers):
            taps = dense[i, :k * S].view(k, S, -1)
            taps[:, :cin, :c] = layer['w'].permute(2, 1, 0)
        assert ((big + small - dense).abs() <= 2.0 ** -22 * dense.abs()).all()
        pad = dense == 0
        pad[:, :k * S].view(len(layers), k, S, -1)[:, :, :cin, :c] = False
        assert pad.sum() > 0 and not big[pad].any() and not small[pad].any()


def test_k1_plan_at_the_bench_shape():
    """K1 at the conv-stack bench's shape (B=500, L=100, Cin=7, C=100, K=5,
    5 layers) on 132 SMs: strides 100 and 12 (odd multiples of 4), Kc 504
    and 64 (multiples of 8: the last 32-row chunk of a hidden layer holds
    three k8 steps), wgmma n104 in one column group, two rows a block (four
    m64 tiles, two on each of two consumer warpgroups; 250 blocks, 2
    rounds), a ring of four stages, within the shared memory of a block."""
    plan = ks.k1_plan(500, 100, 7, 100, 5, 5, n_sm=132)
    assert (plan.S, plan.S0, plan.Kc, plan.Kc0) == (100, 12, 504, 64)
    assert (plan.N, plan.ngroups, plan.R, plan.P, plan.nc, plan.tpw) == (104, 1, 2, 104, 2, 2)
    assert plan.Kc % ks.K1_CHUNK == 24 and plan.stages == 4
    assert plan.fits() and plan.smem <= 232448 == ks.SMEM_LIMIT
    assert len(plan.as_ints()) == 18
    # on 132 SMs: the fewest rows that keep the fewest rounds of blocks;
    # at C=100 two rows a block (one where that keeps one round), one tile a
    # warpgroup where the warpgroups suffice; at C=25 (n32) four warpgroups of
    # one tile each
    assert [(p.R, p.nc, p.tpw) for p in (ks.k1_plan(B, 100, 7, 100, 5, 5, n_sm=132)
                                         for B in (2000, 500, 334, 64))] == \
        [(2, 2, 2), (2, 2, 2), (2, 2, 2), (1, 2, 1)]
    assert [(p.R, p.N, p.nc, p.tpw) for p in (ks.k1_plan(B, 100, 7, 25, 5, 5, n_sm=132)
                                               for B in (500, 64))] == [(2, 32, 4, 1),
                                                                        (1, 32, 2, 1)]
    assert [ks.k1_stride(c) for c in (3, 7, 25, 30, 100, 128, 256)] == [4, 12, 28, 36, 100, 132, 260]
    assert [ks.k1_width(c) for c in (7, 25, 30, 64, 100, 104, 128, 200, 256)] == [
        (32, 1), (32, 1), (32, 1), (104, 1), (104, 1), (104, 1), (128, 1), (104, 2), (128, 2)]
    # C=128: n128, one tile a warpgroup, one row a block; C=256: two column
    # groups of n128 take both warpgroups, so one m64 tile a block and L=100
    # is windowed (rows of 64); the ring's stages stay a multiple of the groups
    wide = ks.k1_plan(250, 100, 7, 128, 5, 5, n_sm=132)
    assert (wide.N, wide.ngroups, wide.R, wide.nc, wide.tpw, wide.stages) == (128, 1, 1, 2, 1, 4)
    assert ks.k1_plan(100, 100, 7, 256, 5, 5, n_sm=132) is None
    assert ks.k1_max_rows(7, 256, 5, 5) == 64
    two = ks.k1_plan(100, 64, 7, 256, 5, 5, n_sm=132)
    assert (two.N, two.ngroups, two.nc, two.stages) == (128, 2, 2, 4) and two.fits()
    assert ks.k1_layout(100, 7, 200, 5, 5, 1).stages % 2 == 0
    assert ks.k1_max_rows(7, 300, 5, 5) == 0      # three groups: refused (see window_plan)


def _k1_model(layers, x, plan):
    """K1's arithmetic in K1's own layout, on the CPU: per block, the R batch
    rows in one flat, zeroed, halo-padded buffer of stride S0 (then S); each
    layer the strided A view (row m = [m*S, m*S + Kc)) over the m64 tiles
    that hold a row of the block, split into TF32 big and small parts
    (`ks.tf32_split`), times the packed big and small planes as wgmma reads
    them (`_k1_unpack`), summed in f32 as small*big + big*small + big*big;
    bias and ELU; then the valid rows' C channels written back in place,
    shifted by K//2; the output read back from the buffer's valid rows."""
    w0, b0, wr, br = ks.pack_weights(layers, plan)
    planes = [_k1_unpack(w0, plan)]
    if wr is not None:
        big, small = _k1_unpack(wr, plan)
        planes += list(zip(big, small))
    B, L, Cin = x.shape
    R, P, pad, S, C = plan.R, plan.P, plan.K // 2, plan.S, plan.C
    outs = []
    for r0 in range(0, B, R):
        Rv = min(R, B - r0)
        tiles = -(-(Rv * P - (plan.K - 1)) // 64)
        assert tiles <= plan.nc // plan.ngroups * plan.tpw
        m = torch.arange(64 * tiles)
        valid = (m // P < Rv) & (m % P < L)
        src = torch.zeros(plan.rows_alloc0 * plan.S0)
        for r in range(Rv):
            src.view(-1, plan.S0)[r * P + pad:r * P + pad + L, :Cin] = x[r0 + r]
        buf = torch.zeros(plan.rows_alloc * S)
        for i in range(plan.num_layer):
            Ss, Kc = (plan.S0, plan.Kc0) if i == 0 else (S, plan.Kc)
            (w_big, w_small), b = planes[i], (b0 if i == 0 else br[i - 1])
            A = torch.as_strided(src, (64 * tiles, Kc), (Ss, 1))
            a_big, a_small = ks.tf32_split(A)
            v = a_small @ w_big[:Kc] + a_big @ w_small[:Kc] + a_big @ w_big[:Kc]
            y = ks._elu_exp(v + b)[:, :C]
            buf.view(-1, S)[m[valid] + pad, :C] = y[valid]
            src = buf
        outs += [buf.view(-1, S)[r * P + pad:r * P + pad + L, :C] for r in range(Rv)]
    return torch.stack(outs)


@pytest.mark.parametrize('num_layer', [1, 2, 5])
@pytest.mark.parametrize('k', [1, 3, 5])
@pytest.mark.parametrize('c', [30, 100, 128])
def test_k1_layout_model_equals_plain(c, k, num_layer):
    """K1's layout, packer, row mask and 3xTF32 split, run on the CPU, give
    the exact f32 plain version's output within 2e-5 relative, the Pallas
    f32 tolerance (tests/test_kernels.py:25-30); B = 2R + 1 leaves the last
    block partly filled wherever the plan holds more than one row."""
    _, tl, _ = _mk(num_layer, k, c=c)
    plan = ks.k1_plan(1000, 100, 7, c, k, num_layer, n_sm=132)
    B = 2 * plan.R + 1
    x = torch.from_numpy(np.random.RandomState(3).standard_normal((B, 100, 7)).astype(np.float32))
    got = _k1_model(tl, x, plan)
    ref = ks.conv_stack_f32_plain(tl, x)
    assert got.shape == ref.shape == (B, 100, c) and got.dtype == torch.float32
    assert rel_err(got, ref.numpy()) < 2e-5


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
    """At L=1000, C=100, K=5 and 5 layers no block holds a whole row, so the
    wrappers window: K1 (the rows four m64 tiles cover) into 5 windows of
    220, K2 (the rows five m64 tiles cover) into 4 windows of 270, one row
    a block; the time-sharded halo windows of up to 510 positions into 2 of
    275; the main path's L=100 fits in one."""
    assert ks.k1_plan(16, 100, 7, 100, 5, 5, n_sm=132) is not None
    assert ks.k1_plan(16, 1000, 7, 100, 5, 5, n_sm=132) is None
    assert ks.k1_max_rows(7, 100, 5, 5) == 256
    idx_in, _, r = ks.window_plan(1000, ks.k1_max_rows(7, 100, 5, 5), 10)
    assert (idx_in.numel() // r, r) == (5, 220)
    plan = ks.k1_plan(16 * 5, r, 7, 100, 5, 5, n_sm=132)
    assert (plan.R, plan.nc, plan.tpw) == (1, 2, 2) and plan.fits()
    assert ks.k2_plan(16, 100, 7, 100, 5, 5, n_sm=132) is not None
    assert ks.k2_plan(16, 1000, 7, 100, 5, 5, n_sm=132) is None
    assert ks.k2_max_rows(7, 100, 5, 5) == 320
    idx_in, _, r = ks.window_plan(1000, ks.k2_max_rows(7, 100, 5, 5), 10)
    assert (idx_in.numel() // r, r) == (4, 270)
    plan = ks.k2_plan(2000 * 4, r, 7, 100, 5, 5, n_sm=132)
    assert (plan.R, plan.G, plan.nc) == (1, 8000, 5) and plan.fits()
    idx_in, _, r = ks.window_plan(510, ks.k2_max_rows(7, 100, 5, 5), 10)
    assert (idx_in.numel() // r, r) == (2, 275)
    assert ks.k2_plan(16 * 2, r, 7, 100, 5, 5, n_sm=132).R == 1
    assert ks.k2_max_rows(7, 1000, 51, 2) == 0            # refused: see window_plan
    _, tl, x = _mk(5, 5, c=100, B=2, L=1000)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(
        ks.run_windowed(ks.conv_stack_f32_plain, tl, xt, ks.k1_max_rows(7, 100, 5, 5)).numpy(),
        ks.conv_stack_f32_plain(tl, xt).numpy(), atol=1e-6, rtol=1e-6)


def test_conv_stack_work_counts():
    flops, nbytes = ks.conv_stack_work(500, 100, 7, 100, 5, 5, 4)
    assert flops == 2 * 500 * 100 * 5 * 100 * (7 + 4 * 100) == 20350000000
    assert nbytes == (500 * 100 * 7 + 5 * 7 * 100 + 4 * 5 * 100 * 100 + 500 * 100 * 100) * 4 \
        + 5 * 100 * 4


def test_build_reports_parse_ptxas_and_sass():
    """What chip_smoke.py's build phase reads: ptxas's per-kernel registers,
    shared memory and spills, and the HMMA (mma.sync) and HGMMA (wgmma)
    counts per kernel of SASS, apart."""
    from turboae_tpu_torch.kernels import build
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 16 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'
ptxas info    : Function properties for _Z3barv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers, 360 bytes cmem[0]
"""
    assert build.ptxas_report(log) == {
        '_Z3fooPf': {'spill_stores': 8, 'spill_loads': 12, 'registers': 168, 'smem': 16},
        '_Z3barv': {'spill_stores': 0, 'spill_loads': 0, 'registers': 32, 'smem': 0}}
    sass = """\tcode for sm_90a
\t\tFunction : _Z3fooPf
        /*0a50*/                   HMMA.16816.F32.BF16 R24, R12, R20, R24 ;
        /*0a60*/                   LDSM.16.MT88.4 R8, [R2] ;
        /*0a70*/               @P0 HMMA.16816.F32.BF16 R28, R12, R22, R28 ;
\t\tFunction : _Z3barv
        /*0010*/                   FFMA R1, R2, R3, R1 ;
        /*0020*/                   HGMMA.64x104x16.F32.BF16 R24, R152, gdesc[UR4], R24 ;
\t\tFunction : _Z3bazv
        /*0010*/                   HGMMA.64x256x16.F32.BF16 R24, R200, gdesc[UR8], RZ, !UPT ;
        /*0020*/                   WARPGROUP.ARRIVE ;
        /*0030*/                   HGMMA.64x256x16.F32.BF16 R24, R204, gdesc[UR8], R24, gsb0 ;
        /*0040*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
"""
    assert build.tensor_core_counts(sass) == {'_Z3fooPf': {'hmma': 2, 'hgmma': 0},
                                              '_Z3barv': {'hmma': 0, 'hgmma': 1},
                                              '_Z3bazv': {'hmma': 1, 'hgmma': 2}}
