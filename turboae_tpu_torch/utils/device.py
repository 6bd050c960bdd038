"""Device choice for the port's entry points.

Entry points default to the GPU. Without one they raise: they never fall back
to the CPU. Tests ask for the CPU explicitly with device='cpu'.
"""
from __future__ import annotations

import torch


def resolve_device(device='cuda') -> torch.device:
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {str(dev)!r} was asked for but torch.cuda.is_available() '
            'is False; pass device="cpu" to run on the CPU')
    return dev


def no_tf32():
    """Full f32 on the card: no TF32 in matmuls or cuDNN convolutions (cuDNN
    allows it by default). The port's f32 references and benches run so."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def torch_dtype(name: str) -> torch.dtype:
    """Config.dtype -> torch dtype (float32 | bfloat16)."""
    return torch.bfloat16 if name == 'bfloat16' else torch.float32
