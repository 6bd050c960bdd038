"""BENCHMARK.json against the benchmark's contract: keys, names and units,
the files each entry names, which cell reports which metric, the share of
four-card cells and the time a full check of 24 cells takes."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
B = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
E2E = {m['name']: m for m in B['end_to_end']}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and '\n' not in s and '\t' not in s


def _reports(cell, metric):
    return cell in metric.get('workloads', [cell])


def test_top_level():
    assert set(B) == {'command', 'paths', 'run_seconds', 'configs', 'workloads', 'end_to_end',
                      'per_layer'}
    assert len((ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024
    assert 1 <= len(B['paths']) <= 16 and len(B['command']) <= 32
    for p in B['paths']:
        assert re.fullmatch(r'[A-Za-z0-9_./-]{1,200}', p) and (ROOT / p).is_dir()
    for word in B['command']:
        assert _line(word) and not word.startswith('/') and '..' not in word
    assert B['command'][1].startswith(B['paths'][0] + '/')


def test_names_units_and_text():
    names = [x['name'] for k in ('configs', 'workloads', 'end_to_end', 'per_layer')
             for x in B[k]]
    assert all(NAME.match(n) for n in names)
    for k in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        assert len({x['name'] for x in B[k]}) == len(B[k])
    for m in B['end_to_end'] + B['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    for x in B['configs'] + B['workloads']:
        assert _line(x['why'])
    for c in B['configs']:
        assert _line(c['source']) and len(c['reduced']) <= 16
        assert all(NAME.match(k) for k in c['reduced'])


def test_entries_have_just_their_keys():
    for c in B['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
    for w in B['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
    for m in B['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound', 'source'}
        assert m['source'] in ('host_clock', 'device_trace')
    for m in B['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source', 'layer', 'moves'}
        assert m['source'] in ('device_trace', 'program_span', 'program_counter', 'host_clock')
        assert _line(m['layer'])


def test_files_found_by_name():
    base = ROOT / B['paths'][0]
    for c in B['configs']:
        assert c['file'].startswith(B['paths'][0] + '/') and (ROOT / c['file']).is_file()
    assert len({c['file'] for c in B['configs']}) == len(B['configs'])
    for w in B['workloads']:
        assert (base / 'traffic' / f'{w["traffic"]}.json').is_file()
        assert (base / 'limits' / f'{w["name"]}.json').is_file()
    for m in B['per_layer']:
        assert (base / 'metrics' / f'{m["name"]}.py').is_file()


def test_cells():
    configs = {c['name'] for c in B['configs']}
    pairs = [(w['config'], w['traffic']) for w in B['workloads']]
    assert len(set(pairs)) == len(pairs) and 1 <= len(pairs) <= 24
    assert configs == {w['config'] for w in B['workloads']}
    four = [w for w in B['workloads'] if w['chips'] == 4]
    assert all(w['chips'] in (1, 4) for w in B['workloads'])
    assert len(four) <= max(1, len(B['workloads']) // 4)


@pytest.mark.parametrize('cell', [w['name'] for w in B['workloads']])
def test_each_cell_reports_what_it_must(cell):
    e2e = [m['name'] for m in B['end_to_end'] if _reports(cell, m)]
    assert set(e2e) == {'setup_s', 'eval_blocks_per_s'}
    layer = [m for m in B['per_layer'] if _reports(cell, m)]
    assert layer
    for m in layer:
        assert m['moves'] in E2E and _reports(cell, E2E[m['moves']])


def test_bounds():
    for m in B['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
    assert E2E['setup_s']['bound'] <= 0.25


def test_a_full_check_fits():
    rs = B['run_seconds']
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
