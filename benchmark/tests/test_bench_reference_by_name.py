"""A configuration names its plain reference (`"reference"` in its file), and
the harness reaches the reference only through the interface every
reference module gives (load, perms, encode, decode, forward_flops): a stub
module named only in a cell's configuration decides `correct` and the
FLOP count; a configuration that names no module, or one that does not
exist, is refused."""
import ast
import json
import shutil
import sys
import types
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _tiny  # noqa: E402
from benchmark.harness import yardstick as Y  # noqa: E402
from benchmark.harness.main import RunView, reader  # noqa: E402
from benchmark.harness.tracing import Spans  # noqa: E402
from benchmark.reference import turboae_cnn  # noqa: E402

STUB = 'stub_by_name'
STUB_FLOPS = 123_456_789


@pytest.fixture
def stub(monkeypatch):
    """benchmark.reference.<STUB>: turboae_cnn's functions, each call counted;
    `stub.invert` set inverts the decision at position 0 of every row that
    `decode` returns."""
    mod = types.ModuleType(f'benchmark.reference.{STUB}')
    mod.calls, mod.invert = [], False

    def counted(name, fn):
        def call(*args, **kwargs):
            mod.calls.append(name)
            return fn(*args, **kwargs)
        return call

    def decode(params, received, pm, arch, precision='f32'):
        out = turboae_cnn.decode(params, received, pm, arch, precision)
        if mod.invert:
            out = out.clone()
            out[:, 0] = 1.0 - out[:, 0]
        return out

    mod.load = counted('load', turboae_cnn.load)
    mod.perms = counted('perms', turboae_cnn.perms)
    mod.encode = counted('encode', turboae_cnn.encode)
    mod.decode = counted('decode', decode)
    mod.forward_flops = counted('forward_flops', lambda arch, block_len: STUB_FLOPS)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return mod


def _named(c):
    c['arch'] = dict(c['arch'], reference=STUB)
    return c


@pytest.mark.parametrize('name', ['crown_eval', 'k1000_eval'])
@pytest.mark.parametrize('invert', [False, True])
def test_stub_reference_decides_correct(name, invert, stub, tmp_path):
    # sound: a seeded init, which the stub reproduces; inverted: the trained
    # checkpoint at 4 dB, where one inverted position a row is an error a row
    c = _named(_tiny.fault_cell(name, 4.0) if invert else _tiny.sound_cell(name, tmp_path))
    stub.invert = invert
    rc, line = _tiny.run(c, seconds=0.0)
    assert rc == 0 and line['correct'] is (not invert), line['checks']
    assert {'load', 'perms', 'encode', 'decode'} <= set(stub.calls)


def test_stub_reference_counts_the_flops(stub):
    c = _named(_tiny.M.load_cell('crown_eval'))
    cell = types.SimpleNamespace(arch=c['arch'], traffic=c['traffic'], spans=Spans())
    view = RunView(cell, {'rest_units': 10, 'rest_seconds': 1.0}, None,
                   'NVIDIA H100 80GB HBM3', 1)
    mfu = reader('mfu_pct.eval')(view)
    assert mfu == pytest.approx(100.0 * 10 * 2000 * STUB_FLOPS / 989.4e12)
    assert stub.calls == ['forward_flops']


@pytest.mark.parametrize('name, flops', [('crown_eval', 519_880_000),
                                         ('k1000_eval', 5_198_800_000)])
def test_committed_configurations_flops(name, flops):
    arch = _tiny.M.load_cell(name)['arch']
    assert arch['reference'] == 'turboae_cnn'
    assert Y.forward_flops(arch, arch['block_len']) == flops


@pytest.mark.parametrize('value', [None, 'no_such_reference', '../harness/main'])
def test_load_cell_refuses_a_configuration_without_its_reference(value, monkeypatch,
                                                                tmp_path):
    shutil.copy(_tiny.ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(_tiny.ROOT / 'benchmark', tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('_cache', '__pycache__'))
    conf = tmp_path / 'benchmark' / 'configs' / 'turboae_cont_k100.json'
    arch = json.loads(conf.read_text())
    arch.pop('reference')
    if value is not None:
        arch['reference'] = value
    conf.write_text(json.dumps(arch))
    monkeypatch.setattr(_tiny.M, 'ROOT', tmp_path)
    assert _tiny.M.load_cell('k1000_eval')['arch']['reference'] == 'turboae_cnn'
    with pytest.raises(SystemExit, match=r'benchmark/configs/turboae_cont_k100\.json: '
                                         r'"reference"'):
        _tiny.M.load_cell('crown_eval')


HARNESS = sorted((_tiny.ROOT / 'benchmark' / 'harness').glob('*.py'))


@pytest.mark.parametrize('path', HARNESS, ids=lambda p: p.name)
def test_harness_names_no_reference_module(path):
    """The harness imports what references share, never a reference itself."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module:
            parts = node.module.split('.')
            if 'reference' in parts:
                rest = parts[parts.index('reference') + 1:]
                names = rest or [a.name for a in node.names]
                assert set(names) <= {'common', 'msgpack'}, (path.name, node.module)

