"""What every run does around its cell: fixed cache directories inside the
checkout, the device checks, the check that no JAX module was loaded, the
card's name and power limit, and the result line."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CACHE = ROOT / 'benchmark' / '_cache'
# compared whole against the part of each loaded module's name before the first dot
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'turboae_tpu')


def fix_environment():
    """Point every cache the run could fill at a fixed directory inside the
    checkout, and keep libraries from loading JAX on their own."""
    os.environ.setdefault('TRITON_CACHE_DIR', str(CACHE / 'triton'))
    os.environ.setdefault('TORCH_EXTENSIONS_DIR', str(CACHE / 'torch_extensions'))
    os.environ.setdefault('TORCHINDUCTOR_CACHE_DIR', str(CACHE / 'inductor'))
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'


def forbidden_modules():
    """The loaded modules whose top-level name is a forbidden one."""
    return sorted({name for name in list(sys.modules)
                   if name.split('.', 1)[0] in FORBIDDEN})


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit,clocks.max.sm',
                              '--format=csv,noheader'], capture_output=True, text=True,
                             timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f'nvidia-smi failed: {e}'
    return ' | '.join(line.strip() for line in out.strip().splitlines())


def require_cards(n: int):
    """Exit 2 with no result unless torch sees a CUDA card, at least n."""
    import torch
    if not torch.cuda.is_available():
        log('no CUDA device: torch.cuda.is_available() is False; this benchmark runs on '
            'the card only')
        sys.exit(2)
    if torch.cuda.device_count() < n:
        log(f'the cell needs {n} cards, torch sees {torch.cuda.device_count()}')
        sys.exit(2)


def sync(device):
    """Wait for the device's work (nothing to wait for on the CPU)."""
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def print_result(result: dict, checks: dict):
    """The checks as the last lines on stderr, then the result line (checks
    last in it) as the last line of stdout."""
    for name, c in checks.items():
        log(f'check {name}: {c["value"]!r} limit {c["limit"]!r}')
    print(json.dumps({**result, 'checks': checks}), flush=True)
