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
    (333, 100, 7, 100, 5, 5), (5, 23, 3, 30, 3, 2), (4, 500, 7, 100, 5, 2)])
def test_kernel_matches_plain(cuda_device, B, L, cin, c, k, nl):
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
    layers = _stack(2, 7, 100, 5, cuda_device)
    x = torch.zeros((1, 1200, 7), device=cuda_device)
    with pytest.raises(ValueError, match='shared'):
        ks.conv_stack_bf16(layers, x)


@pytest.mark.gpu
def test_fused_backward_on_gpu(cuda_device):
    layers = _stack(2, 7, 16, 5, cuda_device)
    leaves = [t.requires_grad_(True) for p in layers for t in (p['w'], p['b'])]
    x = torch.randn((3, 12, 7), device=cuda_device, requires_grad=True)
    out = ks.fused_stack_apply_bf16(layers, x)
    out.float().sum().backward()
    assert x.grad is not None and all(t.grad is not None for t in leaves)
