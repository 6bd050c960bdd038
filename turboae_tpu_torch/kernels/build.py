"""Builds the port's CUDA sources into shared libraries loaded with ctypes.

Each source under `csrc/` has a plain `extern "C"` interface and includes no
PyTorch header, only the headers beside it (`csrc/*.cuh`), so `nvcc` compiles
it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -I csrc -o _build/<name>-<hash>.so csrc/<name>.cu

The library is built at first use into `_build/` beside this file (listed in
.gitignore), named by a hash of the source, every header and the flags, so an
edited source or header builds anew and an unchanged one is loaded as it is.
Several sources build in parallel: one nvcc process each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent / '_build'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']


@dataclass
class Built:
    path: Path
    seconds: float      # wall time of this build; 0.0 when the library was cached
    log: str            # nvcc's output (ptxas register and shared-memory report),
                        # kept beside the library for a cached build


_LOADED: Dict[str, ctypes.CDLL] = {}
_BUILT: Dict[str, Built] = {}


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
                 shutil.which('nvcc') or '',
                 '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH')


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f'{name}.cu').read_bytes())
    for header in sorted(CSRC.glob('*.cuh')):
        digest.update(header.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'{name}-{digest.hexdigest()[:16]}.so'


def _command(src: Path, out: Path) -> List[str]:
    """nvcc's command line that builds `src` into the library `out`; `-I`
    finds the headers of `csrc/` from a source anywhere (a variant's)."""
    return [find_nvcc(), *NVCC_FLAGS, '-I', str(CSRC), '-o', str(out), str(src)]


def build(names: List[str]) -> Dict[str, Built]:
    """Build every named source that is not built yet, all in parallel.

    Raises RuntimeError with nvcc's stderr when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {}
    for name in names:
        if name in _BUILT:
            continue
        out = _target(name)
        if out.exists():
            log = out.with_suffix('.log')
            _BUILT[name] = Built(out, 0.0, log.read_text() if log.exists() else '')
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        proc = subprocess.Popen(_command(CSRC / f'{name}.cu', tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        todo[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in todo.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f'nvcc failed on {name}.cu (exit {proc.returncode}):\n'
                          f'{stderr}{stdout}')
            continue
        out.with_suffix('.log').write_text(stdout + stderr)
        os.replace(tmp, out)   # atomic: another process sees all or nothing
        _BUILT[name] = Built(out, seconds, stdout + stderr)
    if failed:
        raise RuntimeError('\n'.join(failed))
    return {name: _BUILT[name] for name in names}


def build_texts(texts: Dict[str, str], out_dir: Path) -> Dict[str, Built]:
    """Builds each named source text (a variant of a kernel's source) into
    out_dir/<name>.so, all in parallel, every time (no cache).

    Raises RuntimeError with nvcc's output when a build fails."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        (out_dir / f'{name}.cu').write_text(text)
        procs[name] = (subprocess.Popen(
            _command(out_dir / f'{name}.cu', out_dir / f'{name}.so'), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), time.perf_counter())
    built = {}
    for name, (proc, t0) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on variant {name}:\n{log}')
        built[name] = Built(out_dir / f'{name}.so', time.perf_counter() - t0, log)
    return built


def load(name: str) -> ctypes.CDLL:
    """The named library, built first if needed."""
    if name not in _LOADED:
        built = build([name])[name]
        _LOADED[name] = ctypes.CDLL(str(built.path))
    return _LOADED[name]


def find_cuobjdump() -> str:
    """cuobjdump from the toolkit that holds nvcc."""
    path = os.path.join(os.path.dirname(find_nvcc()), 'cuobjdump')
    if not (os.path.isfile(path) and os.access(path, os.X_OK)):
        raise RuntimeError(f'cuobjdump not found beside nvcc ({path})')
    return path


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """Per kernel, from nvcc's `-Xptxas -v` output: registers, static shared
    memory bytes and spill store and load bytes."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
        if m:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r'Used (\d+) registers(?:.*?(\d+) bytes smem)?', line)
        if m:
            out[name].update(registers=int(m.group(1)), smem=int(m.group(2) or 0))
    return out


def tensor_core_counts(sass: str) -> Dict[str, Dict[str, int]]:
    """Per kernel in `cuobjdump -sass` output, its tensor-core instructions:
    HMMA (mma.sync, Ampere's warp-level path) and HGMMA (wgmma, Hopper's
    warpgroup path), apart."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in sass.splitlines():
        m = re.match(r'\s*Function : (\S+)', line)
        if m:
            name = m.group(1)
            out[name] = {'hmma': 0, 'hgmma': 0}
        elif name is not None:
            m = re.search(r'\b(HG?MMA)\b', line)
            if m:
                out[name][m.group(1).lower()] += 1
    return out


def sass(path: Path) -> str:
    """`cuobjdump -sass` of a built library."""
    return subprocess.run([find_cuobjdump(), '-sass', str(path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
