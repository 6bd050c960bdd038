"""The command on a machine with no card fails and prints no result, and so
does a directory that holds only BENCHMARK.json and the benchmark; on the
card (marker `gpu`) a short run of the crown's sweep comes out correct."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def _run(cwd, *args):
    return subprocess.run([sys.executable, 'benchmark/run.py', *args], cwd=str(cwd),
                          capture_output=True, text=True, timeout=900)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    p = _run(ROOT, '--workload', 'crown_eval', '--seed', '3000000001', '--seconds', '1')
    assert p.returncode == 2 and p.stdout == ''
    assert 'no CUDA device' in p.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'benchmark', tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('_cache', '__pycache__'))
    p = _run(tmp_path, '--workload', 'crown_eval', '--seed', '3000000001', '--seconds', '1')
    assert p.returncode != 0 and p.stdout == ''


@pytest.mark.gpu
def test_crown_eval_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    p = _run(ROOT, '--workload', 'crown_eval', '--seed', '3000000001', '--seconds', '2')
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line['correct'] and line['device']['platform'] == 'gpu'
