"""Nothing under benchmark/ imports JAX or the JAX package, and the plain
reference imports nothing of the package under test: each import's
top-level name (the part before the first dot) compared whole."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'turboae_tpu'}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split('.')[0]
        elif isinstance(node, ast.Call) and getattr(node.func, 'id', '') == '__import__' \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split('.')[0]


FILES = sorted(BENCH.rglob('*.py'))


@pytest.mark.parametrize('path', FILES, ids=[str(p.relative_to(BENCH)) for p in FILES])
def test_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize('path', sorted((BENCH / 'reference').glob('*.py')),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert not set(_imports(path)) & {'turboae_tpu_torch', 'benchmark'}


def test_whole_names():
    # turboae_tpu_torch begins with turboae_tpu: the comparison is of whole names
    assert 'turboae_tpu_torch'.split('.')[0] not in FORBIDDEN
