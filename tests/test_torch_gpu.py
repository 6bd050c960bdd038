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
    (334, 100, 7, 100, 5, 5)])
def test_kernel_matches_plain(cuda_device, B, L, cin, c, k, nl):
    """K2 against its plain version; the last four cases: odd C, two and three
    column groups of warps (C=128, 256), and B=334 with three rows a block,
    which leaves the last block holding one."""
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
    (the rows 12 warps cover); the wrapper windows the time axis and
    launches once."""
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
@pytest.mark.parametrize('B,L,cin,c,k,nl', [
    (500, 100, 7, 100, 5, 5), (37, 100, 7, 100, 5, 1), (64, 100, 7, 100, 1, 3),
    (333, 100, 7, 100, 5, 5), (5, 23, 3, 30, 3, 2), (4, 500, 7, 100, 5, 2),
    (500, 100, 7, 25, 5, 5), (250, 100, 7, 128, 5, 5), (100, 100, 7, 256, 5, 5),
    (334, 100, 7, 100, 5, 5)])
def test_f32_kernel_matches_plain(cuda_device, B, L, cin, c, k, nl):
    """K1 against its plain version; the last four cases as K2's: odd C, two
    and three column groups of warps (C=128, 256), and B=334 with three rows
    a block, which leaves the last block holding one."""
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
def test_rnn_decoder_bf16_takes_cudnn_on_the_card(cuda_device):
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
    assert gru.ROUTE_CALLS['cudnn'] > before['cudnn'] and gru.ROUTE_CALLS['scan'] == before['scan']


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
