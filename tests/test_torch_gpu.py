"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU: it carries the `gpu` marker and skips
without one. The file imports no JAX, so it runs on a machine that has only
PyTorch (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from turboae_tpu_torch.kernels import conv_stack as ks

# bf16 tolerance of the Pallas kernel tests (tests/test_kernels.py:33-41)
REL_TOL = 1e-2
# K1 is f32 by 3xTF32, ~1e-6 from its exact f32 plain version (the dropped
# small*small products, the tensor cores' rounding and the summation order);
# tests/test_kernels.py:25-30 hold the Pallas f32 kernel to 2e-5
F32_REL_TOL = 2e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _stack(nl, cin, c, k, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    layers = []
    for i in range(nl):
        bound = ((cin if i == 0 else c) * k) ** -0.5
        w = (torch.rand((c, cin if i == 0 else c, k), generator=g) * 2 - 1) * bound
        b = (torch.rand((c,), generator=g) * 2 - 1) * bound
        layers.append({'w': w.to(device), 'b': b.to(device)})
    return layers


@pytest.mark.gpu
@pytest.mark.parametrize('B,L,cin,c,k,nl', [
    (2000, 100, 7, 100, 5, 5), (37, 100, 7, 100, 5, 1), (64, 100, 7, 100, 1, 3),
    (333, 100, 7, 100, 5, 5), (5, 23, 3, 30, 3, 2), (4, 500, 7, 100, 5, 2),
    (500, 100, 7, 25, 5, 5), (250, 100, 7, 128, 5, 5), (100, 100, 7, 256, 5, 5),
    (334, 100, 7, 100, 5, 5), (1001, 100, 7, 100, 5, 5), (64, 40, 7, 300, 5, 2)])
def test_kernel_matches_plain(cuda_device, B, L, cin, c, k, nl):
    """K2 against its plain version; the last six cases: odd C (wgmma n32),
    n128 and n256 (C=128, 256), B=334 and 1001, whose rows the plan spreads
    over whole rounds of blocks of 2 or 3 rows, so blocks of 2 leave their
    fourth m64 tile partly filled and their fifth warpgroup idle, and C=300
    in two column groups of n256."""
    layers = _stack(nl, cin, c, k, cuda_device)
    x = torch.randn((B, L, cin), generator=torch.Generator().manual_seed(1)).to(cuda_device)
    before = ks.conv_stack_bf16.launches
    got = ks.conv_stack_bf16(layers, x)
    torch.cuda.synchronize()
    assert ks.conv_stack_bf16.launches == before + 1
    ref = ks.conv_stack_bf16_plain(layers, x).float()
    assert got.dtype == torch.bfloat16 and got.shape == (B, L, c)
    assert ((got.float() - ref).abs().max() / ref.abs().max()).item() < REL_TOL


@pytest.mark.gpu
def test_kernel_refuses_too_much_shared_memory(cuda_device):
    """Long blocks are windowed (below); a stack whose halo alone fills the
    shared memory a window may use is refused: K=51 at C=1000 holds 66 rows
    of bf16, and two layers need 50 on each side."""
    c, k = 1000, 51
    layers = [{'w': torch.zeros((c, cin, k), device=cuda_device),
               'b': torch.zeros((c,), device=cuda_device)} for cin in (7, c)]
    x = torch.zeros((1, 1200, 7), device=cuda_device)
    with pytest.raises(ValueError, match='shared'):
        ks.conv_stack_bf16(layers, x)


@pytest.mark.gpu
@pytest.mark.parametrize('f32', [False, True], ids=['K2', 'K1'])
def test_long_block_is_windowed_in_one_launch(cuda_device, f32):
    """L=1000, C=100, K=5, 5 layers: a whole row does not fit in one block
    (K2: the rows five m64 tiles cover; K1: those 12 warps cover); the
    wrapper windows the time axis and launches once."""
    layers = _stack(5, 7, 100, 5, cuda_device)
    x = torch.randn((6, 1000, 7), generator=torch.Generator().manual_seed(2)).to(cuda_device)
    kernel = ks.conv_stack_f32 if f32 else ks.conv_stack_bf16
    plain = ks.conv_stack_f32_plain if f32 else ks.conv_stack_bf16_plain
    before = kernel.launches
    got = kernel(layers, x)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and got.shape == (6, 1000, 100)
    ref = plain(layers, x).float()
    tol = F32_REL_TOL if f32 else REL_TOL
    assert ((got.float() - ref).abs().max() / ref.abs().max()).item() < tol


@pytest.mark.gpu
@pytest.mark.parametrize('ranks', [2, 4])
def test_k2_on_halo_windows_equals_the_whole_block(cuda_device, ranks):
    """K2 on each time-sharded rank's halo window (dist/mesh.py:halo_apply:
    positions [s - 10, e + 10) of L=1000, cut to the block) equals K2 on the
    whole block in the rows the rank keeps, as the flagship's decoder runs
    it under shard_axis 'time' (halo num_layer * (K // 2) = 10)."""
    from turboae_tpu_torch.ops.conv1d import halo
    layers = _stack(5, 7, 100, 5, cuda_device)
    x = torch.randn((16, 1000, 7), generator=torch.Generator().manual_seed(3)).to(cuda_device)
    whole = ks.conv_stack_bf16(layers, x).float()
    h, n = halo(layers), 1000 // ranks
    assert h == 10
    for d in range(ranks):
        s, e = d * n, (d + 1) * n
        lo, hi = max(s - h, 0), min(e + h, 1000)
        before = ks.conv_stack_bf16.launches
        got = ks.conv_stack_bf16(layers, x[:, lo:hi])[:, s - lo:e - lo].float()
        torch.cuda.synchronize()
        assert ks.conv_stack_bf16.launches == before + 1
        ref = whole[:, s:e]
        assert ((got - ref).abs().max() / ref.abs().max()).item() < REL_TOL, d
        assert ((got - ks.conv_stack_bf16_plain(layers, x)[:, s:e].float()).abs().max()
                / ref.abs().max()).item() < REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize('B,L,cin,c,k,nl', [
    (500, 100, 7, 100, 5, 5), (37, 100, 7, 100, 5, 1), (64, 100, 7, 100, 1, 3),
    (333, 100, 7, 100, 5, 5), (5, 23, 3, 30, 3, 2), (4, 500, 7, 100, 5, 2),
    (500, 100, 7, 25, 5, 5), (250, 100, 7, 128, 5, 5), (100, 100, 7, 256, 5, 5),
    (334, 100, 7, 100, 5, 5), (64, 100, 7, 12, 3, 3)])
def test_f32_kernel_matches_plain(cuda_device, B, L, cin, c, k, nl):
    """K1 against its plain version; then as K2's: odd C (n32, two rows a
    block on four warpgroups), n128 (C=128), two column groups of n128 (C=256, windowed to one
    m64 tile a block), B=334 with two rows a block, which leaves the last
    block holding one (two of its four tiles idle); and Kc = 40 at C=12,
    K=3, whose last 32-row ring chunk holds one k8 step."""
    layers = _stack(nl, cin, c, k, cuda_device)
    x = torch.randn((B, L, cin), generator=torch.Generator().manual_seed(1)).to(cuda_device)
    before = ks.conv_stack_f32.launches
    got = ks.conv_stack_f32(layers, x)
    torch.cuda.synchronize()
    assert ks.conv_stack_f32.launches == before + 1
    ref = ks.conv_stack_f32_plain(layers, x)
    assert got.dtype == torch.float32 and got.shape == (B, L, c)
    assert ((got - ref).abs().max() / ref.abs().max()).item() < F32_REL_TOL


@pytest.mark.gpu
def test_fused_f32_backward_on_gpu(cuda_device):
    layers = _stack(2, 7, 16, 5, cuda_device)
    leaves = [t.requires_grad_(True) for p in layers for t in (p['w'], p['b'])]
    x = torch.randn((3, 12, 7), device=cuda_device, requires_grad=True)
    ks.fused_stack_apply(layers, x).sum().backward()
    assert x.grad is not None and all(t.grad is not None for t in leaves)


@pytest.mark.gpu
def test_fused_backward_on_gpu(cuda_device):
    layers = _stack(2, 7, 16, 5, cuda_device)
    leaves = [t.requires_grad_(True) for p in layers for t in (p['w'], p['b'])]
    x = torch.randn((3, 12, 7), device=cuda_device, requires_grad=True)
    out = ks.fused_stack_apply_bf16(layers, x)
    out.float().sum().backward()
    assert x.grad is not None and all(t.grad is not None for t in leaves)


def _dense_stack(nl, cin, c, k, device, seed=0):
    from turboae_tpu_torch.ops.conv1d import dense_stack_init
    layers = dense_stack_init(torch.Generator().manual_seed(seed), nl, cin, c, k)
    return [{'w': p['w'].to(device), 'b': p['b'].to(device)} for p in layers]


@pytest.mark.gpu
@pytest.mark.parametrize('B,L,cin,c,k,nl', [
    (2000, 100, 7, 100, 5, 5), (1, 23, 7, 100, 5, 5), (3, 23, 7, 100, 5, 5),
    (7, 23, 7, 100, 5, 5), (1, 1000, 7, 100, 5, 5), (3, 1000, 7, 100, 5, 5),
    (7, 1000, 7, 100, 5, 5), (1001, 100, 7, 100, 5, 5), (37, 100, 7, 100, 5, 1),
    (64, 100, 7, 100, 1, 3), (500, 100, 7, 13, 3, 3), (250, 100, 8, 104, 5, 2),
    (100, 40, 7, 104, 3, 2)])
def test_dense_kernel_matches_plain(cuda_device, B, L, cin, c, k, nl):
    """K3 against its plain version in one launch: DeepTurbo's shape; B of
    1, 3 and 7 rows at L = 23 and at L = 1000 (windowed: five windows of 220
    rows); B = 1001 (blocks of 1 and 2 rows); one layer; K = 1; odd C (an
    odd Cs padded to even); C = 104, every column of its one width (n104),
    on one row and on two rows of 40."""
    layers = _dense_stack(nl, cin, c, k, cuda_device)
    x = torch.randn((B, L, cin), generator=torch.Generator().manual_seed(1)).to(cuda_device)
    before = ks.dense_stack_bf16.launches
    got = ks.dense_stack_bf16(layers, x)
    torch.cuda.synchronize()
    assert ks.dense_stack_bf16.launches == before + 1
    ref = ks.dense_stack_bf16_plain(layers, x).float()
    assert got.dtype == torch.bfloat16 and got.shape == (B, L, c)
    assert ((got.float() - ref).abs().max() / ref.abs().max()).item() < REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize('c,L,nl,match', [(112, 100, 2, 'at most 104'),
                                          (100, 1000, 40, 'keeps no row')])
def test_dense_kernel_refuses_what_it_cannot_hold(cuda_device, c, L, nl, match):
    """On the card K3's wrapper raises on a stack it cannot hold (more
    output channels than its one width; a halo of 80 rows that fills every
    window), as K2's does, and launches nothing."""
    layers = _dense_stack(nl, 7, c, 5, cuda_device)
    before = ks.dense_stack_bf16.launches
    with pytest.raises(ValueError, match=match):
        ks.dense_stack_bf16(layers, torch.zeros((2, L, 7), device=cuda_device))
    assert ks.dense_stack_bf16.launches == before


@pytest.mark.gpu
def test_dense_fused_backward_on_gpu(cuda_device):
    """The differentiable entry: K3 forward, the f32 dense stack's gradients."""
    from turboae_tpu_torch.ops.conv1d import dense_stack_apply
    layers = _dense_stack(3, 7, 16, 5, cuda_device)
    leaves = [t.requires_grad_(True) for p in layers for t in (p['w'], p['b'])]
    x = torch.randn((3, 12, 7), device=cuda_device, requires_grad=True)
    before = ks.dense_stack_bf16.launches
    out = ks.fused_dense_stack_apply_bf16(layers, x)
    g = torch.randn(out.shape, device=cuda_device)
    got = torch.autograd.grad(out, [x, *leaves], g.to(out.dtype))
    assert ks.dense_stack_bf16.launches == before + 1
    ref = torch.autograd.grad(dense_stack_apply(layers, x), [x, *leaves],
                              g.to(out.dtype).float())
    for a, b in zip(got, ref):      # cuDNN may pick another algorithm each call
        torch.testing.assert_close(a, b)


@pytest.mark.gpu
def test_deepturbo_batch_launches_k3_twelve_times(cuda_device):
    """A bf16 sweep batch of DeepTurbo with use_fused_conv: each of the 12
    dense stacks one K3 launch and no K2 launch, no concatenation; its
    decisions agree with the CPU's plain version of the same path."""
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.models.channel_ae import forward_ae, init_ae, make_perms
    from turboae_tpu_torch.ops import conv1d as cv
    from turboae_tpu_torch.train.sweep import params_to
    cfg = Config(encoder='Turbo_rate3_757', dtype='bfloat16', use_fused_conv=True)
    params = init_ae(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(2)
    bits = (torch.rand((64, 100, 1), generator=g) < 0.5).float()
    noise = torch.randn((64, 100, 3), generator=g)
    k2, k3 = ks.conv_stack_bf16.launches, ks.dense_stack_bf16.launches
    copied = cv.dense_stack_apply.copy_bytes
    with torch.inference_mode():
        got = forward_ae(params_to(params, cuda_device), cfg, bits.to(cuda_device),
                         noise.to(cuda_device), make_perms(cfg, cuda_device), training=False)[0]
        ref = forward_ae(params, cfg, bits, noise, make_perms(cfg, 'cpu'), training=False)[0]
    torch.cuda.synchronize()
    assert ks.dense_stack_bf16.launches - k3 == 12 and ks.conv_stack_bf16.launches == k2
    assert cv.dense_stack_apply.copy_bytes == copied
    assert (got.cpu().round() == ref.round()).float().mean().item() > 0.99


@pytest.mark.gpu
def test_trainer_marks_bracket_each_phase(cuda_device):
    """The CUDA events a step records when `Trainer.marks` is a list, read by
    cli/profile_train.py: one per phase, in order, with positive times."""
    from turboae_tpu_torch.cli.profile_train import PHASES, phase_ms
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.train.trainer import Trainer
    cfg = Config(batch_size=16, enc_num_unit=12, dec_num_unit=12, num_iteration=2,
                 dtype='bfloat16', use_fused_conv=True)
    tr = Trainer(cfg, cuda_device)
    out = phase_ms(tr, 6)
    assert out['encoder']['steps'] == 1 and out['decoder']['steps'] == 5
    assert all(out[m][p] > 0 for m in out for p in PHASES)
    assert tr.marks is None


@pytest.mark.gpu
@pytest.mark.parametrize('encoder', ['Turbo_rate3_757', 'Turbo_rate3_lte'])
@pytest.mark.parametrize('L', [100, 1000])
def test_turbo_encoder_on_the_card_equals_the_cpu(cuda_device, encoder, L):
    """DeepTurbo's classical encoder (a loop of table gathers) on the card,
    bit for bit against the same function on the CPU."""
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.models.channel_ae import make_perms
    from turboae_tpu_torch.models.deepturbo import turbo_enc_apply
    cfg = Config(encoder=encoder, block_len=L)
    bits = (torch.rand((257, L, 1), generator=torch.Generator().manual_seed(L)) < 0.5).float()
    ref, _ = turbo_enc_apply({}, cfg, bits, make_perms(cfg, 'cpu'))
    got, _ = turbo_enc_apply({}, cfg, bits.to(cuda_device), make_perms(cfg, cuda_device))
    assert got.device.type == 'cuda' and torch.equal(got.cpu(), ref)


@pytest.mark.gpu
@pytest.mark.parametrize('kind,tol', [('gru', 1e-5), ('lstm', F32_REL_TOL)])
def test_gru_cudnn_route_matches_the_scan(cuda_device, kind, tol):
    """ops/gru.py's card route (cuDNN, one call a layer, weights in one
    buffer) against its plain scan on the card, f32, TF32 off; its
    gradients too, and no cuDNN weight-copy warning."""
    import warnings
    from turboae_tpu_torch.ops import gru
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    layers = gru.birnn_init(g, 7, 32, 2, kind, cuda_device)
    x = torch.randn((16, 40, 7), generator=g).to(cuda_device)
    leaves = [t.requires_grad_(True) for layer in layers for d in layer.values()
              for t in d.values()]
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        out = {r: gru.birnn_apply(layers, x, kind, route=r) for r in ('cudnn', 'scan')}
        grads = {r: torch.autograd.grad(out[r].sum(), leaves) for r in out}
    ref = out['scan']
    assert float((out['cudnn'] - ref).abs().max() / ref.abs().max()) < tol
    for a, b in zip(grads['cudnn'], grads['scan']):
        assert float((a - b).abs().max() / b.abs().max()) < 1e-4


@pytest.mark.gpu
def test_gru_cudnn_bf16_at_the_rnn_cells_shape(cuda_device):
    """The rnn_eval cell's decoder biGRU (B=2000, L=100, In=7, H=100, 2
    layers): ops/gru.py's cuDNN route in bf16 against the bf16 scan and the
    exact function (the f64 scan), within REL_TOL, the repo's bf16
    tolerance: both routes round every operand to bf16 (unit roundoff
    2^-8), and cuDNN also keeps its hidden state in bf16 between steps where
    the scan keeps f32, so their gap is a few roundings of 2^-8 relative
    (chip_smoke's gru_forward holds it to the same tolerance at B=500).
    One call counts one stack, two layers, and in `pack_bytes` the bytes of
    the two layers' flat weight buffers; the scan packs nothing."""
    from turboae_tpu_torch.ops import gru
    B, L, IN, H, NL = 2000, 100, 7, 100, 2
    g = torch.Generator().manual_seed(28)
    layers = gru.bigru_init(g, IN, H, NL, cuda_device)
    x = torch.randn((B, L, IN), generator=g).to(cuda_device)
    f = gru.birnn_apply
    flat = sum(gru._cudnn_layout('gru', IN if i == 0 else 2 * H, H, torch.bfloat16,
                                 x.device)[0] for i in range(NL)) * 2
    with torch.inference_mode():
        before = (f.calls, f.layers, f.pack_bytes)
        cud = f(layers, x, 'gru', torch.bfloat16, route='cudnn')
        assert (f.calls - before[0], f.layers - before[1], f.pack_bytes - before[2]) == \
            (1, NL, flat)
        packed = f.pack_bytes
        scan = f(layers, x, 'gru', torch.bfloat16, route='scan')
        assert f.pack_bytes == packed
        exact = f(layers, x.double(), 'gru', torch.float64, route='scan')
    torch.cuda.synchronize()

    def rel(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())
    assert cud.shape == (B, L, 2 * H) and bool(torch.isfinite(cud).all())
    assert rel(cud, scan.double()) < REL_TOL
    assert rel(cud, exact) < REL_TOL and rel(scan, exact) < REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize('kind,dt', [('gru', torch.bfloat16), ('gru', torch.float32),
                                     ('lstm', torch.bfloat16)])
def test_cudnn_graph_replays_the_eager_call(cuda_device, kind, dt):
    """Without gradients `_cudnn_layer` replays a captured CUDA graph of
    cuDNN's call: bit for bit the eager call on the same flat buffer, at the
    rnn_eval cell's two layer shapes (In=7 and 2H=200). A replay on other
    inputs leaves the output already returned as it was (in f32 too, where
    no cast copies it), and a call with gradients runs eagerly."""
    from turboae_tpu_torch.ops import gru
    B, L, H = 2000, 100, 100
    g = torch.Generator().manual_seed(280)
    for n_in in (7, 2 * H):
        layer = gru.birnn_init(g, n_in, H, 1, kind, cuda_device)[0]
        xs = [torch.randn((B, L, n_in), generator=g).to(cuda_device) for _ in range(2)]
        numel, places = gru._cudnn_layout(kind, n_in, H, dt, cuda_device)
        buf = torch.zeros(numel, dtype=dt, device=cuda_device)
        for (off, _), t in zip(places, [layer[d][k] for d in ('fwd', 'bwd')
                                        for k in gru._DIR_KEYS]):
            buf[off:off + t.numel()] = t.to(dt).reshape(-1)
        with torch.no_grad():
            eager = [gru._cudnn_call(kind, x.to(dt).contiguous(), buf, places, H,
                                     False).float() for x in xs]
        with torch.inference_mode():
            first = gru._cudnn_layer(layer, xs[0], kind, dt)
            second = gru._cudnn_layer(layer, xs[1], kind, dt)
        assert torch.equal(first, eager[0]) and torch.equal(second, eager[1])
        assert not torch.equal(first, second)
        with torch.enable_grad():
            trained = gru._cudnn_layer(layer, xs[0], kind, dt)
        assert trained.shape == first.shape and bool(torch.isfinite(trained).all())


@pytest.mark.gpu
def test_rnn_decoder_bf16_takes_cudnn_on_the_card(cuda_device):
    """The bf16 RNN pair in inference: every GRU layer takes K4 (the route
    that took cuDNN until K4 came), none the scan or cuDNN."""
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.models.channel_ae import forward_ae, init_ae, make_perms
    from turboae_tpu_torch.ops import gru
    cfg = Config(encoder='Turboae_rate3_rnn', decoder='TurboAE_rate3_rnn', dtype='bfloat16',
                 enc_num_unit=16, dec_num_unit=16, num_iteration=2, block_len=20)
    params = init_ae(torch.Generator().manual_seed(0), cfg, cuda_device)
    bits = (torch.rand((8, 20, 1), device=cuda_device) < 0.5).float()
    before = dict(gru.ROUTE_CALLS)
    with torch.inference_mode():
        out, _, _ = forward_ae(params, cfg, bits, torch.zeros((8, 20, 3), device=cuda_device),
                               make_perms(cfg, cuda_device), training=False)
    assert torch.isfinite(out).all()
    assert gru.ROUTE_CALLS['kernel'] > before['kernel']
    assert gru.ROUTE_CALLS['scan'] == before['scan'] and gru.ROUTE_CALLS['cudnn'] == before['cudnn']


@pytest.mark.gpu
@pytest.mark.parametrize('case', ['f32', 'lstm', 'gradient'])
def test_rnn_calls_k4_cannot_take_stay_on_cudnn(cuda_device, case):
    """f32, the LSTM and a call that needs gradients keep cuDNN."""
    from turboae_tpu_torch.ops import gru
    kind = 'lstm' if case == 'lstm' else 'gru'
    dtype = torch.float32 if case == 'f32' else torch.bfloat16
    layers = gru.birnn_init(torch.Generator().manual_seed(1), 7, 16, 2, kind, cuda_device)
    x = torch.randn((8, 20, 7), device=cuda_device)
    before = dict(gru.ROUTE_CALLS)
    if case == 'gradient':
        for layer in layers:
            for d in layer.values():
                for t in d.values():
                    t.requires_grad_(True)
        out = gru.birnn_apply(layers, x, kind, dtype)
        out.sum().backward()
    else:
        with torch.inference_mode():
            out = gru.birnn_apply(layers, x, kind, dtype)
    assert bool(torch.isfinite(out).all())
    assert gru.ROUTE_CALLS['cudnn'] == before['cudnn'] + 2
    assert gru.ROUTE_CALLS['kernel'] == before['kernel']


# ---------------------------------------------------------------- K4
# the rnn_eval cell's three layer shapes (In = 1, 7, 2H) at H = 100
K4_SHAPES = [(B, L, In) for In in (1, 7, 200) for B in (1, 63, 65, 500, 2000) for L in (1, 7, 100)]


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def _rms(a, b):
    """Root-mean-square error of a against b, relative to b's: over a few
    steps both bf16 routes err by the same rounding of x and the weights, and
    a maximum picks one value of that noise; the mean shows the carry."""
    a, b = a.double(), b.double()
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


@pytest.mark.gpu
@pytest.mark.parametrize('B,L,In', K4_SHAPES)
def test_k4_matches_the_scans(cuda_device, B, L, In):
    """One layer, both directions: K4 within the kernel tolerance of the bf16
    scan, and nearer the f64 scan than cuDNN's bf16 RNN on the same input
    (root-mean-square: K4 writes f32 and carries h in f32, cuDNN rounds both
    to bf16); its bf16 output is its f32 output rounded."""
    from turboae_tpu_torch.kernels import gru as k4
    from turboae_tpu_torch.ops import gru
    g = torch.Generator().manual_seed(B + L + In)
    layer = gru.birnn_init(g, In, 100, 1, 'gru', cuda_device)[0]
    x = torch.randn((B, L, In), generator=g).to(cuda_device)
    with torch.inference_mode():
        got = k4.gru_bf16(layer, x)
        half = k4.gru_bf16(layer, x, out_f32=False)
        scan = gru._scan_layer(layer, x, 'gru', torch.bfloat16)
        exact = gru._scan_layer(layer, x.double(), 'gru', torch.float64)
        cud = gru._cudnn_layer(layer, x, 'gru', torch.bfloat16)
    torch.cuda.synchronize()
    assert got.shape == (B, L, 200) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert _rel(got, scan) < REL_TOL
    assert _rms(got, exact) < _rms(cud, exact)
    assert torch.equal(half, got.to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize('B,L,In,H', [(5, 9, 13, 37), (70, 5, 150, 64), (33, 20, 208, 104)])
def test_k4_other_widths(cuda_device, B, L, In, H):
    """Odd and partial widths (x padded to 8 channels, units past H, the
    widest block) against K4's plain version on the card, f32 and bf16 out."""
    from turboae_tpu_torch.kernels import gru as k4
    from turboae_tpu_torch.ops import gru
    g = torch.Generator().manual_seed(B * In)
    layer = gru.birnn_init(g, In, H, 1, 'gru', cuda_device)[0]
    x = torch.randn((B, L, In), generator=g).to(cuda_device)
    with torch.inference_mode():
        for out_f32 in (True, False):
            got = k4.gru_bf16(layer, x, out_f32=out_f32)
            want = k4.gru_bf16_plain(layer, x, out_f32=out_f32)
            assert got.shape == (B, L, 2 * H) and got.dtype == want.dtype
            assert _rel(got, want) < REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize('In', [7, 200])
def test_k4_stack_of_two_layers(cuda_device, In):
    """A 2-layer stack through birnn_apply's own route: K4 twice, the inner
    layer handing bf16 to the outer, against the stack's bf16 and f64 scans."""
    from turboae_tpu_torch.ops import gru
    g = torch.Generator().manual_seed(In)
    layers = gru.birnn_init(g, In, 100, 2, 'gru', cuda_device)
    x = torch.randn((500, 100, In), generator=g).to(cuda_device)
    before = dict(gru.ROUTE_CALLS)
    with torch.inference_mode():
        got = gru.birnn_apply(layers, x, 'gru', torch.bfloat16)
        scan = gru.birnn_apply(layers, x, 'gru', torch.bfloat16, route='scan')
        exact = gru.birnn_apply(layers, x.double(), 'gru', torch.float64, route='scan')
        cud = gru.birnn_apply(layers, x, 'gru', torch.bfloat16, route='cudnn')
    assert gru.ROUTE_CALLS['kernel'] == before['kernel'] + 2
    assert got.dtype == torch.float32 and got.shape == (500, 100, 200)
    assert _rel(got, scan) < REL_TOL
    assert _rms(got, exact) < _rms(cud, exact)


@pytest.mark.gpu
def test_k4_counters(cuda_device):
    """One launch a layer; in inference mode a miss packs the layer, the
    second call hits, and only the miss adds its bytes to pack_bytes."""
    from turboae_tpu_torch.kernels import gru as k4
    from turboae_tpu_torch.ops import gru
    layers = gru.birnn_init(torch.Generator().manual_seed(3), 7, 100, 2, 'gru', cuda_device)
    x = torch.randn((300, 50, 7), device=cuda_device)
    ks.clear_packs()
    f = gru.birnn_apply
    counts = lambda: (k4.gru_bf16.launches, k4.gru_bf16.pack_hits, k4.gru_bf16.pack_misses,
                      f.layers, f.pack_bytes, gru.ROUTE_CALLS['kernel'])
    with torch.inference_mode():
        c0 = counts()
        first = gru.birnn_apply(layers, x, 'gru', torch.bfloat16)
        c1 = counts()
        second = gru.birnn_apply(layers, x, 'gru', torch.bfloat16)
        c2 = counts()
    ks.clear_packs()
    assert torch.equal(first, second)
    packed = k4.packed_bytes(7) + k4.packed_bytes(200)
    assert tuple(b - a for a, b in zip(c0, c1)) == (2, 0, 2, 2, packed, 2)
    assert tuple(b - a for a, b in zip(c1, c2)) == (2, 2, 0, 2, 0, 2)


@pytest.mark.gpu
def test_k4_refuses_what_it_cannot_hold(cuda_device):
    """H = 120 passes K4's block: route='kernel' raises, and the call's own
    route is cuDNN."""
    from turboae_tpu_torch.kernels import gru as k4
    from turboae_tpu_torch.ops import gru
    layers = gru.birnn_init(torch.Generator().manual_seed(4), 7, 120, 1, 'gru', cuda_device)
    x = torch.randn((16, 10, 7), device=cuda_device)
    with torch.inference_mode():
        with pytest.raises(ValueError):
            gru.birnn_apply(layers, x, 'gru', torch.bfloat16, route='kernel')
        with pytest.raises(ValueError):
            k4.gru_bf16(layers[0], x)
        before = dict(gru.ROUTE_CALLS)
        out = gru.birnn_apply(layers, x, 'gru', torch.bfloat16)
    assert out.shape == (16, 10, 240)
    assert gru.ROUTE_CALLS['cudnn'] == before['cudnn'] + 1
    assert gru.ROUTE_CALLS['kernel'] == before['kernel']


@pytest.mark.gpu
def test_k4_in_a_cuda_graph(cuda_device):
    """A launch captured in a CUDA graph replays equal to the eager launch,
    on new input too; the cache does not serve under the capture."""
    from turboae_tpu_torch.kernels import gru as k4
    from turboae_tpu_torch.ops import gru
    layer = gru.birnn_init(torch.Generator().manual_seed(5), 200, 100, 1, 'gru', cuda_device)[0]
    xs = [torch.randn((130, 40, 200), device=cuda_device) for _ in range(2)]
    with torch.inference_mode():
        eager = [k4.gru_bf16(layer, x) for x in xs]
        static = xs[0].clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            k4.gru_bf16(layer, static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        hits = k4.gru_bf16.pack_hits
        with torch.cuda.graph(graph):
            out = k4.gru_bf16(layer, static)
        assert k4.gru_bf16.pack_hits == hits
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager[0])
        static.copy_(xs[1])
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager[1])


@pytest.mark.gpu
@pytest.mark.parametrize('encoder,decoder,n', [
    ('turboae_2int', 'turboae_2int', 3), ('TurboAE_rate2_cnn', 'TurboAE_rate2_cnn', 2),
    ('rate3_cnn', 'rate3_cnn', 3), ('TurboAE_rate3_cnn2d', 'TurboAE_rate3_cnn2d', 3),
    ('TurboAE_rate3_cnn2d_dense', 'rate3_cnn2d', 3)])
def test_cnn_zoo_on_the_card_equals_the_cpu(cuda_device, encoder, decoder, n):
    """A CNN zoo pair at full width in f32 (TF32 off), card against CPU
    within 1e-4; its decoder never launches K2, even when asked to fuse."""
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.models.channel_ae import forward_ae, init_ae, make_perms
    from turboae_tpu_torch.train.sweep import params_to
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config(encoder=encoder, decoder=decoder, code_rate_n=n, use_fused_conv=True)
    params = init_ae(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(2)
    bits = (torch.rand((32, 100, 1), generator=g) < 0.5).float()
    noise = torch.randn((32, 100, n), generator=g)
    before = ks.conv_stack_bf16.launches
    with torch.inference_mode():
        got = forward_ae(params_to(params, cuda_device), cfg, bits.to(cuda_device),
                         noise.to(cuda_device), make_perms(cfg, cuda_device), training=False)[0]
        ref = forward_ae(params, cfg, bits, noise, make_perms(cfg, 'cpu'), training=False)[0]
    assert ks.conv_stack_bf16.launches == before
    assert (got.cpu() - ref).abs().max().item() < 1e-4


@pytest.mark.gpu
def test_mod_ae_decoder_fuses_through_k2(cuda_device):
    """artifacts/mod_ae.msgpack in bf16 with use_fused_conv: 12 K2 launches
    a forward, decisions as the unfused bf16 forward's on > 99 %."""
    import os
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.models.channel_ae import forward_mod_ae, make_perms
    from turboae_tpu_torch.train.checkpoint import load_checkpoint
    from turboae_tpu_torch.train.mod_trainer import ModTrainer
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config(dtype='bfloat16')
    tr = ModTrainer(cfg, cuda_device)
    tr.params = load_checkpoint(os.path.join(root, 'artifacts', 'mod_ae.msgpack'), tr.params)
    g = torch.Generator().manual_seed(3)
    bits = (torch.rand((256, 100, 1), generator=g) < 0.5).float().to(cuda_device)
    noise = torch.randn((256, 150, 2), generator=g).to(cuda_device)
    outs = {}
    for fused in (False, True):
        before = ks.conv_stack_bf16.launches
        with torch.inference_mode():
            outs[fused] = forward_mod_ae(tr.params, cfg.replace(use_fused_conv=fused), bits, noise,
                                         make_perms(cfg, cuda_device), training=False)[0]
        torch.cuda.synchronize()
        assert ks.conv_stack_bf16.launches - before == (12 if fused else 0)
    assert (outs[True].round() == outs[False].round()).float().mean().item() > 0.99


@pytest.mark.gpu
@pytest.mark.parametrize('dtype,fused,opt', [('float32', False, 'adam'), ('bfloat16', True, 'adam'),
                                             ('float32', False, 'lookahead'),
                                             ('float32', False, 'sgd')])
@pytest.mark.parametrize('mode', ['encoder', 'decoder'])
def test_graph_steps_match_eager_steps(cuda_device, dtype, fused, opt, mode):
    """steps_per_call as CUDA graphs: 2 replays of 3 steps against 6 eager
    steps from the same seeded init and generator seed. f32: every loss
    within 1e-5 relative (cuDNN may pick other algorithms under capture);
    bf16 fused within 1e-3. K2 counts the warm-up
    step's and each replayed step's 4 stacks (2 iterations), nothing for
    the capture; the optimizer's host count moves by the 6 steps."""
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.train.trainer import Trainer
    cfg = Config(batch_size=64, enc_num_unit=32, dec_num_unit=32, num_iteration=2,
                 dtype=dtype, use_fused_conv=fused, optimizer=opt)
    eager = Trainer(cfg, cuda_device)
    ref = torch.stack([eager._train_step(mode) for _ in range(6)])
    graph = Trainer(cfg, cuda_device)
    before = ks.conv_stack_bf16.launches
    got = torch.cat(graph._train_steps(mode, 3, 2))
    torch.cuda.synchronize()
    assert ks.conv_stack_bf16.launches - before == (4 * 7 if fused else 0)
    assert ((got - ref).abs() / ref.abs()).max().item() < (1e-5 if dtype == 'float32' else 1e-3)
    half = 'enc' if mode == 'encoder' else 'dec'
    if opt != 'sgd':
        assert graph.opt[half].count == eager.opt[half].count == 6
    for a, b in zip(graph._leaves[half], eager._leaves[half]):
        assert (a - b).abs().max().item() <= 1e-3 * b.abs().max().item()
    graph.marks = []
    with pytest.raises(RuntimeError, match='marks'):
        graph._train_steps(mode, 2, 1)


@pytest.mark.gpu
@pytest.mark.parametrize('block_len', [100, 1000])
def test_sweep_counts_with_kept_packs_equal_fresh_packs(cuda_device, block_len):
    """The crown's sweep batch (2000 blocks, full width, bf16, K2; at L=1000
    on windows): with the packed weights kept from the first call, three
    batches count what they count with clear_packs() before every call, bit
    for bit; each warm batch hits 12 times and packs nothing."""
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.models.channel_ae import init_ae, make_perms
    from turboae_tpu_torch.train.sweep import sweep_counts
    cfg = Config(batch_size=2000, block_len=block_len, dtype='bfloat16', use_fused_conv=True)
    params = init_ae(torch.Generator().manual_seed(0), cfg, cuda_device)
    perms = make_perms(cfg, cuda_device)
    batches = []
    for seed in range(3):
        g = torch.Generator().manual_seed(seed)
        bits = (torch.rand((2000, block_len, 1), generator=g) < 0.5).float()
        noise = 0.8 * torch.randn((2000, block_len, 3), generator=g)
        batches.append((bits.to(cuda_device), noise.to(cuda_device)))
    ks.clear_packs()
    sweep_counts(params, cfg, *batches[0], perms)
    warm = []
    for b in batches:
        h, m = ks.conv_stack_bf16.pack_hits, ks.conv_stack_bf16.pack_misses
        warm.append([t.cpu() for t in sweep_counts(params, cfg, *b, perms)])
        assert (ks.conv_stack_bf16.pack_hits - h, ks.conv_stack_bf16.pack_misses - m) == (12, 0)
    for b, w in zip(batches, warm):
        ks.clear_packs()
        m = ks.conv_stack_bf16.pack_misses
        fresh = [t.cpu() for t in sweep_counts(params, cfg, *b, perms)]
        assert ks.conv_stack_bf16.pack_misses - m == 12
        assert all(torch.equal(a, c) for a, c in zip(w, fresh))
    assert warm[0][0].item() > 0


@pytest.mark.gpu
def test_evaluation_after_graphed_steps_repacks(cuda_device):
    """A fused-conv Trainer with steps_per_call 3: a forward in inference
    mode, as Trainer.test's batches run it, keeps the decoder's packs; the
    graph's replays then write the params with no version bump, and
    _StepGraph.run empties the cache, so the next forward packs the new
    params anew: it equals one after clear_packs(), bit for bit, and
    differs from the first."""
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.models.channel_ae import forward_ae
    from turboae_tpu_torch.train.trainer import Trainer
    cfg = Config(batch_size=64, enc_num_unit=32, dec_num_unit=32, num_iteration=2,
                 dtype='bfloat16', use_fused_conv=True, steps_per_call=3)
    tr = Trainer(cfg, cuda_device)
    g = torch.Generator().manual_seed(5)
    bits = (torch.rand((64, 100, 1), generator=g) < 0.5).float().to(cuda_device)
    noise = (0.8 * torch.randn((64, 100, 3), generator=g)).to(cuda_device)

    @torch.inference_mode()
    def forward():
        return forward_ae(tr.params, cfg, bits, noise, tr.perms, training=False)[0].cpu()
    tr._train_steps('decoder', 3, 1)             # the capture, then a replay
    before = forward()
    h = ks.conv_stack_bf16.pack_hits
    assert torch.equal(forward(), before) and ks.conv_stack_bf16.pack_hits - h == 4
    tr._train_steps('decoder', 3, 2)             # replays alone
    m = ks.conv_stack_bf16.pack_misses
    got = forward()
    assert ks.conv_stack_bf16.pack_misses - m == 4
    ks.clear_packs()
    assert torch.equal(got, forward())
    assert not torch.equal(got, before)


# ---------------------------------------------------------------- the classical device decoders
# the f32 turbo LLRs, card against CPU, absolute: six iterations of
# extrinsic exchange amplify the two devices' f32 rounding on a few blocks
# (chip_smoke.py's CLASSICAL_LLR_TOL); decisions are held exactly wherever
# |LLR| exceeds CLASSICAL_NEAR_ZERO
CLASSICAL_LLR_TOL = 1e-2
CLASSICAL_NEAR_ZERO = 1e-3


def _turbo_rx(code, B, L, snr_db, seed=0):
    import numpy as np
    from turboae_tpu_torch.classical.interleavers import RandInterlv
    from turboae_tpu_torch.classical.trellis import turbo757_trellis, turbo_lte_trellis
    from turboae_tpu_torch.classical.turbo import turbo_encode_batch
    trellis = turbo_lte_trellis() if code == 'lte' else turbo757_trellis()
    rng = np.random.RandomState(seed)
    p = RandInterlv(L, 0).p_array
    sigma = 10 ** (-snr_db / 20)
    msgs = rng.randint(0, 2, (B, L))
    rx = 2.0 * turbo_encode_batch(msgs, trellis, p) - 1.0 + sigma * rng.randn(B, L, 3)
    return trellis, p, sigma, torch.as_tensor(rx, dtype=torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize('code', ['757', 'lte'])
@pytest.mark.parametrize('variant', ['hazzys', 'hazzys_g', 'standard'])
def test_turbo_decoder_on_the_card_equals_the_cpu(cuda_device, code, variant):
    """The batched log-BCJR turbo decoder (6 iterations, B=64, L=100, -1 dB)
    on the card against the same function on the CPU: LLRs within 1e-2,
    decisions equal wherever |LLR| > 1e-3."""
    from turboae_tpu_torch.classical.turbo import make_turbo_decoder
    trellis, p, sigma, rx = _turbo_rx(code, 64, 100, -1.0)
    dec = make_turbo_decoder(trellis, p, 6, variant)
    ref = dec.llr(*rx.unbind(2), sigma ** 2)
    got = dec.llr(*rx.to(cuda_device).unbind(2), sigma ** 2)
    assert got.device.type == 'cuda'
    assert (got.cpu() - ref).abs().max().item() < CLASSICAL_LLR_TOL
    firm = ref.abs() > CLASSICAL_NEAR_ZERO
    assert torch.equal((got.cpu() > 0)[firm], (ref > 0)[firm])


@pytest.mark.gpu
def test_turbo_mc_on_the_card_counts_errors(cuda_device):
    """make_turbo_mc on the card: seeded runs repeat, and at -1 dB (K=100,
    2,000 blocks) its BLER is within |z| < 4 of the committed anchor
    (artifacts/classical_awgn_k100.json: 593 of 2,000)."""
    from turboae_tpu_torch.classical.interleavers import RandInterlv
    from turboae_tpu_torch.classical.trellis import turbo757_trellis
    from turboae_tpu_torch.classical.turbo import make_turbo_mc
    from turboae_tpu_torch.utils.metrics import two_proportion_z
    step = make_turbo_mc(turbo757_trellis(), RandInterlv(100, 0).p_array, 6, 'hazzys', batch=2000)
    sigma = 10 ** (1.0 / 20)
    be, ble = step(torch.Generator(device=cuda_device).manual_seed(0), sigma)
    again = step(torch.Generator(device=cuda_device).manual_seed(0), sigma)
    assert be.device.type == 'cuda' and (int(be), int(ble)) == tuple(int(x) for x in again)
    assert abs(two_proportion_z(int(ble), 2000, 593, 2000)) < 4


@pytest.mark.gpu
@pytest.mark.parametrize('gens', [[7, 5], [7, 5, 6]], ids=['rate2', 'rate3'])
@pytest.mark.parametrize('decoding_type', ['hard', 'unquantized', 'tdist3', 'tdist5'])
def test_viterbi_on_the_card_equals_the_cpu(cuda_device, gens, decoding_type):
    import numpy as np
    from turboae_tpu_torch.classical.convcode import conv_encode_batch, make_viterbi
    from turboae_tpu_torch.classical.trellis import Trellis
    trellis = Trellis(np.array([2]), np.array([gens]))
    rng = np.random.RandomState(1)
    coded = conv_encode_batch(rng.randint(0, 2, (256, 100)), trellis)
    rx = (2.0 * coded - 1 + 0.9 * rng.randn(*coded.shape)).reshape(256, -1, trellis.n)
    if decoding_type == 'hard':
        rx = (rx > 0).astype(float)
    rx = torch.as_tensor(rx, dtype=torch.float32)
    dec = make_viterbi(trellis, decoding_type)
    got = dec(rx.to(cuda_device))
    assert got.device.type == 'cuda' and torch.equal(got.cpu(), dec(rx))


@pytest.mark.gpu
@pytest.mark.parametrize('alg', ['SPA', 'MSA'])
def test_ldpc_decoder_on_the_card_equals_the_cpu(cuda_device, alg):
    """The (96, 48) design at Eb/N0 2.5 dB, B=256, 100 iterations. MSA,
    exact arithmetic summed in one order on both devices: bits equal and
    LLRs within 1e-4 on every frame. SPA, whose atanh near its clip turns
    one ulp of tanh into up to ~1 of LLR: bits equal on the frames whose
    bits satisfy the parity on both devices, frame errors within |z| < 4."""
    import os

    import numpy as np
    from turboae_tpu_torch.classical.ldpc import DESIGNS, get_ldpc_code_params, make_ldpc_decoder
    params = get_ldpc_code_params(os.path.join(DESIGNS, '96.33.964.txt'))
    nv = 1.0 / (2 * 0.5 * 10 ** (2.5 / 10.0))
    llr = 2.0 * (1.0 + np.sqrt(nv) * np.random.RandomState(2).randn(256, 96)) / nv
    llr = torch.as_tensor(llr, dtype=torch.float32)
    from turboae_tpu_torch.utils.metrics import two_proportion_z
    dec = make_ldpc_decoder(params, alg, 100)
    ref_bits, ref_llr = dec(llr)
    bits, out = dec(llr.to(cuda_device))
    assert bits.device.type == 'cuda'
    bits, out = bits.cpu(), out.cpu()
    pmat = torch.as_tensor(params['pmat'], dtype=torch.float32)
    both = ((pmat @ bits.T.float()) % 2 == 0).all(0) & ((pmat @ ref_bits.T.float()) % 2 == 0).all(0)
    assert int(both.sum()) > 128 and torch.equal(bits[both], ref_bits[both])
    if alg == 'MSA':
        assert torch.equal(bits, ref_bits) and (out - ref_llr).abs().max().item() < 1e-4
    fe, ref_fe = (int((b.sum(dim=1) > 0).sum()) for b in (bits, ref_bits))
    assert abs(two_proportion_z(fe, 256, ref_fe, 256)) < 4


# ---------------------------------------------------------------- M15b and M16
@pytest.mark.gpu
def test_native_oracle_against_the_card_decoders(cuda_device):
    """The C++ oracle (f64, host) against the card (f32): Turbo-757 hazzys
    decisions equal wherever the card's |LLR| > 1e-3; Viterbi equal."""
    import numpy as np
    from turboae_tpu_torch import native
    from turboae_tpu_torch.classical.convcode import conv_encode_batch, make_viterbi
    from turboae_tpu_torch.classical.trellis import Trellis
    from turboae_tpu_torch.classical.turbo import make_turbo_decoder
    trellis, p, sigma, rx = _turbo_rx('757', 64, 100, -1.0)
    llr = make_turbo_decoder(trellis, p, 6, 'hazzys').llr(*rx.to(cuda_device).unbind(2),
                                                          sigma ** 2).cpu()
    host = native.native_turbo_decode_batch(*rx.double().numpy().transpose(2, 0, 1), trellis,
                                            sigma ** 2, 6, p)
    firm = llr.abs() > CLASSICAL_NEAR_ZERO
    assert torch.equal(torch.from_numpy(host).bool()[firm], (llr > 0)[firm])
    conv = Trellis(np.array([2]), np.array([[7, 5]]))
    rng = np.random.RandomState(3)
    coded = conv_encode_batch(rng.randint(0, 2, (64, 100)), conv)
    vrx = (2.0 * coded - 1 + 0.9 * rng.randn(*coded.shape)).reshape(64, -1, 2)
    card = make_viterbi(conv, 'unquantized')(torch.as_tensor(vrx, dtype=torch.float32,
                                                              device=cuda_device)).cpu().numpy()
    assert (card == np.stack([native.native_viterbi(r, conv) for r in vrx])).all()


@pytest.mark.gpu
def test_two_gloo_ranks_on_one_card_equal_one_process(cuda_device, tmp_path, monkeypatch):
    """tests/_torch_dist_worker.py's run at two gloo ranks, both on cuda:0,
    against this process alone on the card, TF32 off on both sides as the
    CLIs have it: epoch losses and each loss of the menu within 1e-5
    relative, its gradients within 1e-4 of each leaf's largest, the params
    after the epochs within rtol 1e-4 / atol 1e-5 (tests/test_dist.py's
    sharded tolerance); sweep counts equal but for blocks within 1e-5 of
    0.5; steps_per_call 2 under gloo refused."""
    import os
    import socket
    import subprocess
    import sys

    import numpy as np
    import _torch_dist_worker as W
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.models.channel_ae import init_ae
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    rng = np.random.RandomState(0)
    bits = torch.from_numpy((rng.random_sample((16, 16, 1)) < 0.5).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((16, 16, 3)).astype(np.float32))
    params = init_ae(torch.Generator().manual_seed(1), Config(**W.SMALL), 'cpu')
    inputs = {'bits': bits, 'noise': noise, 'params': params,
              'jax': {'cfg': W.SMALL, 'bits': bits, 'noise': noise, 'params': params}}
    torch.save(inputs, tmp_path / 'inputs.pt')
    s = socket.socket()
    s.bind(('localhost', 0))
    port = str(s.getsockname()[1])
    s.close()
    procs = [subprocess.Popen(
        [sys.executable, W.__file__, str(tmp_path / 'inputs.pt'), str(tmp_path / 'out')],
        env=dict(os.environ, MASTER_ADDR='localhost', MASTER_PORT=port, RANK=str(r),
                 WORLD_SIZE='2', LOCAL_RANK='0', DIST_DEVICE='cuda'),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    got = torch.load(tmp_path / 'out0.pt')
    ref = W.run_all(inputs, None, cuda_device)
    assert 'cannot be captured' in got['graph_under_gloo']
    for name in W.EPOCHS:
        g, r = got['epochs'][name], ref['epochs'][name]
        assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(g['losses'], r['losses'])), name
        assert all(torch.allclose(a, b, rtol=1e-4, atol=1e-5)
                   for a, b in zip(g['params'], r['params'])), name
    for name in W.LOSSES:
        g, r = got['losses'][name], ref['losses'][name]
        assert abs(g['loss'] - r['loss']) <= 1e-5 * abs(r['loss']), name
        for h in r['grads']:
            for a, b in zip(g['grads'][h], r['grads'][h]):
                assert (a - b).abs().max() <= 1e-4 * b.abs().max().clamp_min(1e-30), (name, h)
    for channel, r in ref['sweep'].items():
        g = got['sweep'][channel]
        near = g['near'] + r['near']
        assert all(abs(a - b) <= near for a, b in zip(g['blk_errors'], r['blk_errors']))
