"""Device choice for the port's entry points.

Entry points default to the GPU. Without one they raise: they never fall back
to the CPU. Tests ask for the CPU explicitly with device='cpu'.
"""
from __future__ import annotations

import subprocess

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
    allows it by default). Every CLI of the port calls this before it builds
    anything; library code (Trainer, sweep) sets no global flag and leaves
    the choice to its caller."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def torch_dtype(name: str) -> torch.dtype:
    """Config.dtype -> torch dtype (float32 | bfloat16)."""
    return torch.bfloat16 if name == 'bfloat16' else torch.float32


def nvidia_smi() -> str:
    """The card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them (first card), or the reason it could not be read."""
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True, text=True,
                             timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f'nvidia-smi failed: {e}'
    return out.strip().splitlines()[0]


def describe(dev: torch.device):
    """What a result names its device by: 'cpu', or the card's torch name
    with nvidia-smi's name and power limit beside it."""
    if dev.type != 'cuda':
        return 'cpu'
    return {'torch': torch.cuda.get_device_name(dev), 'nvidia_smi': nvidia_smi()}
