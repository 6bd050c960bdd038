"""The kernels' build rule (kernels/build.py) and their shared header
(kernels/csrc/hopper.cuh), without nvcc: a library is named by a hash of
its source, every header and the flags; both build paths pass `-I csrc`;
and the Hopper helpers are defined in the header alone."""
import re
import shutil
import subprocess

import pytest

from turboae_tpu_torch.kernels import build
from turboae_tpu_torch.kernels.conv_stack import LIBRARIES

# defined once, in hopper.cuh, and in no kernel source
HELPERS = ('cdiv', 'launch_regs', 'consumer_regs', 'elu', 'saddr', 'ldsm_x4', 'mbar_init',
           'mbar_arrive', 'mbar_expect_tx', 'mbar_wait', 'bulk_copy', 'consumers_sync',
           'wgmma_fence', 'wgmma_commit', 'wgmma_wait_all', 'wgmma_wait', 'fence_proxy_async',
           'desc_sw128', 'desc_kmajor', 'prepare')


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that build.py reads, and a build directory of its own."""
    copy = tmp_path / 'csrc'
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, 'CSRC', copy)
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path / '_build')
    monkeypatch.setattr(build, '_BUILT', {})
    return copy


@pytest.mark.parametrize('name', LIBRARIES)
def test_target_hashes_the_headers(csrc, name):
    """The library's name is stable while nothing changes, and changes when
    a header, a new header or the source changes."""
    first = build._target(name)
    assert build._target(name) == first and first.parent == build.BUILD_DIR
    header = csrc / 'hopper.cuh'
    header.write_text(header.read_text() + '// edited\n')
    edited = build._target(name)
    assert edited != first
    (csrc / 'extra.cuh').write_text('#pragma once\n')
    assert build._target(name) not in (first, edited)
    (csrc / 'extra.cuh').unlink()
    assert build._target(name) == edited
    src = csrc / f'{name}.cu'
    src.write_text(src.read_text() + '// edited\n')
    assert build._target(name) not in (first, edited)


@pytest.mark.parametrize('name', LIBRARIES)
def test_every_include_is_a_hashed_header(name):
    """Each `#include "..."` of a kernel source names a header of csrc/
    that `_target` hashes; the four sources include hopper.cuh."""
    local = re.findall(r'^#include "([^"]+)"', (build.CSRC / f'{name}.cu').read_text(), re.M)
    assert 'hopper.cuh' in local
    hashed = {p.name for p in build.CSRC.glob('*.cuh')}
    assert set(local) <= hashed


class _Nvcc:
    """subprocess.Popen in build.py's place: records each command line and
    writes the library that `-o` names."""

    def __init__(self):
        self.commands = []

    def __call__(self, cmd, **kwargs):
        self.commands.append(cmd)
        out = cmd[cmd.index('-o') + 1]
        with open(out, 'w') as f:
            f.write('')
        proc = subprocess.CompletedProcess(cmd, 0)
        proc.communicate = lambda: ('ptxas info', '')
        return proc


def _includes_csrc(cmd, csrc):
    return any(a == '-I' and b == str(csrc) for a, b in zip(cmd, cmd[1:]))


def test_both_build_paths_pass_the_header_directory(csrc, tmp_path, monkeypatch):
    """`build` (a source of csrc/) and `build_texts` (a variant's text,
    written elsewhere) run one command line, with `-I <csrc>`, the flags,
    the output and the source last."""
    nvcc = _Nvcc()
    monkeypatch.setattr(build.subprocess, 'Popen', nvcc)
    monkeypatch.setattr(build, 'find_nvcc', lambda: 'nvcc')
    built = build.build(list(LIBRARIES))
    assert set(built) == set(LIBRARIES) and all(b.path.exists() for b in built.values())
    variants = build.build_texts({'v': (csrc / 'conv_stack_bf16.cu').read_text()},
                                 tmp_path / 'variants')
    assert variants['v'].path == tmp_path / 'variants' / 'v.so'
    assert len(nvcc.commands) == len(LIBRARIES) + 1
    for cmd in nvcc.commands:
        assert cmd[:1 + len(build.NVCC_FLAGS)] == ['nvcc', *build.NVCC_FLAGS]
        assert _includes_csrc(cmd, csrc)
        assert cmd[-1].endswith('.cu')
    assert nvcc.commands[-1][-1] == str(tmp_path / 'variants' / 'v.cu')
    # a cached library is not built again
    build.build(list(LIBRARIES))
    assert len(nvcc.commands) == len(LIBRARIES) + 1


@pytest.mark.parametrize('helper', HELPERS)
def test_helpers_are_defined_in_the_header_alone(helper):
    """A definition starts a line of its own at column 0 (calls are
    indented): each helper has one, in hopper.cuh, and none in a source."""
    definition = re.compile(rf'^[^\s/#].*\b{helper}\(', re.M)
    assert len(definition.findall((build.CSRC / 'hopper.cuh').read_text())) == 1
    for name in LIBRARIES:
        assert not definition.findall((build.CSRC / f'{name}.cu').read_text()), name


def test_bf16_products_are_in_the_header_alone():
    """The bf16 wgmma instructions (K2's, A from registers; K3's n104 and
    K4's n56 and n48, A by descriptor) are written once, in the header; K1's
    TF32 instructions stay in its source."""
    bf16 = re.compile(r'wgmma\.mma_async\.sync\.aligned\.m64n(\d+)k16\.f32\.bf16\.bf16')
    assert sorted(int(n) for n in bf16.findall((build.CSRC / 'hopper.cuh').read_text())) == [
        32, 48, 48, 56, 56, 104, 128, 256]
    for name in LIBRARIES:
        assert not bf16.findall((build.CSRC / f'{name}.cu').read_text()), name
    tf32 = re.findall(r'm64n(\d+)k8\.f32\.tf32\.tf32', (build.CSRC / 'conv_stack_f32.cu').read_text())
    assert sorted(map(int, tf32)) == [32, 104, 128]
