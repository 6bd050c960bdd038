"""The C++ oracle of the classical decoders, built with g++ and loaded with ctypes.

`kernels.cpp` decodes in f64 on the host: the hazzys turbo decoder, batched and
threaded over blocks, and the full Viterbi decoder. It runs on the CPU only;
`cli/turbo_benchmark.py` and `cli/conv_benchmark.py` use it as `-engine native`.

It is built at first use with

    g++ -O3 -march=native -shared -fPIC -pthread -o <lib> kernels.cpp

into `kernels/_build/` (listed in .gitignore), named by a hash of the source,
the flags and the host's CPU (-march=native builds for it), as
`kernels/build.py` names the CUDA libraries. A failed build, or no
g++ at all, raises with the compiler's output: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import numpy as np

SRC = Path(__file__).resolve().parent / 'kernels.cpp'
BUILD_DIR = Path(__file__).resolve().parent.parent / 'kernels' / '_build'
GXX_FLAGS = ['-O3', '-march=native', '-shared', '-fPIC', '-pthread']

_LOADED: Dict[Path, ctypes.CDLL] = {}
last_build_seconds = 0.0   # wall time of the last build; 0.0 when it was cached


def _cpu() -> bytes:
    """The host CPU's model and feature flags, which -march=native builds for."""
    try:
        lines = Path('/proc/cpuinfo').read_text().splitlines()
    except OSError:
        return platform.processor().encode()
    keep = [line for line in lines if line.startswith(('model name', 'flags', 'Features'))]
    return '\n'.join(sorted(set(keep))).encode()


def build(src: Path = SRC) -> Path:
    """The shared library of `src`, compiled now unless it is built already.

    Raises RuntimeError with g++'s output when g++ is missing or fails."""
    global last_build_seconds
    src = Path(src)
    gxx = shutil.which('g++')
    if gxx is None:
        raise RuntimeError('g++ not found: the native engine needs a C++ compiler')
    text = src.read_bytes() if src.is_file() else str(src).encode()   # g++ reports a bad path
    digest = hashlib.sha256(text + ' '.join(GXX_FLAGS).encode() + _cpu()).hexdigest()[:16]
    out = BUILD_DIR / f'native-{digest}.so'
    if out.exists() and src.is_file():
        last_build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    t0 = time.perf_counter()
    proc = subprocess.run([gxx, *GXX_FLAGS, '-o', str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'g++ failed on {src} (exit {proc.returncode}):\n'
                           f'{proc.stderr}{proc.stdout}')
    os.replace(tmp, out)   # atomic: another process sees all or nothing
    last_build_seconds = time.perf_counter() - t0
    return out


def load_native(src: Path = SRC) -> ctypes.CDLL:
    """The ctypes library with its argtypes set, built first if needed."""
    so = build(src)
    if so in _LOADED:
        return _LOADED[so]
    lib = ctypes.CDLL(str(so))
    d = ctypes.POINTER(ctypes.c_double)
    i = ctypes.POINTER(ctypes.c_int32)
    lib.bcjr_map_decode.argtypes = [d, d, ctypes.c_int, i, d, d,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_double, d, d]
    lib.turbo_decode_hazzys.argtypes = [d, d, d, ctypes.c_int, i, d, d,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_double, ctypes.c_int, i, i]
    lib.turbo_decode_hazzys_batch.argtypes = [d, d, d, ctypes.c_int,
                                              ctypes.c_int, i, d, d,
                                              ctypes.c_int, ctypes.c_int,
                                              ctypes.c_double, ctypes.c_int,
                                              i, i]
    lib.turbo_decode_batch_mt.argtypes = [d, d, d, ctypes.c_int,
                                          ctypes.c_int, i, d, d,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_double, ctypes.c_int,
                                          i, ctypes.c_int, ctypes.c_int, i]
    lib.viterbi_full.argtypes = [d, ctypes.c_int, ctypes.c_int, i, i, d,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int, i]
    _LOADED[so] = lib
    return lib


def _cptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def native_turbo_decode_batch(sys, par1, par2, trellis, noise_variance,
                              num_iterations, p_array, variant: str = 'hazzys',
                              num_threads: int = 0) -> np.ndarray:
    """(B, L) received systematic and parity symbols -> (B, L) int32 decisions.

    variant: 'hazzys' or 'hazzys_g' (damped). Threads over blocks;
    num_threads <= 0 uses every hardware thread."""
    lib = load_native()
    sys = np.ascontiguousarray(sys, dtype=np.float64)
    par1 = np.ascontiguousarray(par1, dtype=np.float64)
    par2 = np.ascontiguousarray(par2, dtype=np.float64)
    B, L = sys.shape
    obits = trellis.output_bits().astype(np.float64)
    out_msg = np.ascontiguousarray(2.0 * obits[:, :, 0] - 1.0)
    out_par = np.ascontiguousarray(2.0 * obits[:, :, 1] - 1.0)
    nst = np.ascontiguousarray(trellis.next_state_table, dtype=np.int32)
    p = np.ascontiguousarray(np.asarray(p_array), dtype=np.int32)
    decoded = np.zeros((B, L), dtype=np.int32)
    var = {'hazzys': 0, 'hazzys_g': 1}[variant]
    lib.turbo_decode_batch_mt(
        _cptr(sys, ctypes.c_double), _cptr(par1, ctypes.c_double),
        _cptr(par2, ctypes.c_double), B, L,
        _cptr(nst, ctypes.c_int32), _cptr(out_msg, ctypes.c_double),
        _cptr(out_par, ctypes.c_double),
        trellis.number_states, trellis.number_inputs,
        float(noise_variance), int(num_iterations),
        _cptr(p, ctypes.c_int32), var, int(num_threads),
        _cptr(decoded, ctypes.c_int32))
    return decoded


def native_viterbi(received, trellis, decoding_type: str = 'unquantized') -> np.ndarray:
    """(T, n) received symbols -> (T,) int32 decisions of the full Viterbi
    decoder; decoding_type 'hard', 'unquantized', 'tdist3' or 'tdist5'."""
    lib = load_native()
    received = np.ascontiguousarray(received, dtype=np.float64)
    T, n = received.shape
    S = trellis.number_states
    nst = trellis.next_state_table
    preds = [[] for _ in range(S)]
    for ps in range(S):
        for u in range(trellis.number_inputs):
            preds[nst[ps][u]].append((ps, u))
    P = len(preds[0])
    pred_state = np.ascontiguousarray(
        [[p0 for p0, _ in preds[s]] for s in range(S)], dtype=np.int32)
    pred_input = np.ascontiguousarray(
        [[u for _, u in preds[s]] for s in range(S)], dtype=np.int32)
    obits = trellis.output_bits()
    ideal = np.ascontiguousarray(
        obits[pred_state, pred_input].astype(np.float64))
    dt = {'hard': 0, 'unquantized': 1, 'tdist3': 2, 'tdist5': 3}[decoding_type]
    decoded = np.zeros(T, dtype=np.int32)
    lib.viterbi_full(_cptr(received, ctypes.c_double), T, n,
                     _cptr(pred_state, ctypes.c_int32),
                     _cptr(pred_input, ctypes.c_int32),
                     _cptr(ideal, ctypes.c_double), S, P, dt,
                     _cptr(decoded, ctypes.c_int32))
    return decoded
