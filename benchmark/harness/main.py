"""One run of one cell: `python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`.

The cell, its configuration (benchmark/configs/<config>.json), its traffic
mix (benchmark/traffic/<traffic>.json), its correctness limits
(benchmark/limits/<cell>.json) and its metrics are all found by name from
BENCHMARK.json; the configuration's file names its plain reference
(benchmark/reference/<reference>.py) and each per-layer metric is read by
benchmark/metrics/<name>.py.
Every traffic mix is an evaluation sweep (evaluation.py). A traced run
traces the first whole points past TRACE_SECONDS of its window.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import statistics
import time

from . import host
from .host import ROOT, log

TRACE_SECONDS = 3.0


# --------------------------------------------------------------- manifest
def load_cell(name: str) -> dict:
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise SystemExit(f'unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}')
    w = cells[name]
    conf = next(c for c in bench['configs'] if c['name'] == w['config'])
    base = ROOT / 'benchmark'
    arch = json.loads((ROOT / conf['file']).read_text())
    ref = arch.get('reference')
    if not isinstance(ref, str) or not re.fullmatch(r'[A-Za-z_][A-Za-z0-9_]*', ref) \
            or not (base / 'reference' / f'{ref}.py').is_file():
        raise SystemExit(f'{conf["file"]}: "reference" must name a module of '
                         f'benchmark/reference/, got {ref!r}')
    return {
        'name': name, 'chips': w['chips'], 'arch': arch,
        'traffic': json.loads((base / 'traffic' / f'{w["traffic"]}.json').read_text()),
        'limits': json.loads((base / 'limits' / f'{name}.json').read_text()),
        'end_to_end': [m for m in bench['end_to_end'] if name in m.get('workloads', [name])],
        'per_layer': [m for m in bench['per_layer'] if name in m.get('workloads', [name])],
    }


def reader(metric: str):
    path = ROOT / 'benchmark' / 'metrics' / f'{metric}.py'
    spec = importlib.util.spec_from_file_location(f'_bench_metric_{abs(hash(metric))}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# --------------------------------------------------------------------- run
def run(args, cell: dict, t_start: float, device=None,
        trace_seconds: float = TRACE_SECONDS) -> int:
    """One run; `device` set (the CPU in the tests) skips the card, and
    `cell['options']`, where the tests set it, goes to the cell's loop."""
    import torch

    from .evaluation import EvalCell
    from .tracing import Spans
    traffic, arch = cell['traffic'], cell['arch']
    dev = device or torch.device('cuda', 0)
    on_card = dev.type == 'cuda'
    if on_card:
        torch.cuda.set_device(dev)
    from ..reference.common import no_tf32
    no_tf32()
    if on_card:
        log(f'device: {torch.cuda.get_device_name(dev)}; nvidia-smi: {host.nvidia_smi()}; '
            f'torch {torch.__version__}, CUDA {torch.version.cuda}')
    spans = Spans()
    c = EvalCell(arch, traffic, args.seed, dev, spans, **cell.get('options', {}))
    from turboae_tpu_torch.kernels import conv_stack as ks
    c.setup()
    setup_s = time.time() - t_start
    k2_before = ks.conv_stack_bf16.launches
    w = c.window(args.seconds, trace_seconds if args.trace else 0.0)
    k2 = (ks.conv_stack_bf16.launches - k2_before) / max(w['units'], 1)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    summary = w['slice'].summary() if w['slice'] is not None else None
    c.free()
    log(f'counters: units {w["units"]}, conv_stack_bf16 launches a unit {k2:g}, '
        f'window {w["seconds"]:.6f} s, setup {setup_s:.6f} s')
    pts = w['point_seconds']
    if len(pts) >= 2:
        log(f'points: {len(pts)} untraced of {traffic["blocks_per_point"]} blocks, seconds '
            f'median {statistics.median(pts):.6f}, p95 {statistics.quantiles(pts, n=20)[-1]:.6f}')
    if on_card:
        torch.cuda.empty_cache()
    verdict = c.check(cell['limits'])
    log('numbers: ' + json.dumps(verdict['numbers']))
    device = {'platform': 'gpu' if on_card else 'cpu',
              'kind': torch.cuda.get_device_name(dev) if on_card else 'cpu',
              'count': cell['chips'], 'memory_peak_bytes': int(peak)}
    result = {'correct': verdict['correct'], 'attempted': w['units'], 'failed': 0}
    if args.trace:
        view = RunView(c, w, summary, device['kind'], cell['chips'])
        metrics = {}
        for m in cell['per_layer']:
            v = reader(m['name'])(view)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
        device.update(busy_s=summary['busy_s'], window_s=summary['window_s'])
        result.update(metrics=metrics, device=device, breakdown=breakdown(summary))
    else:
        values = {'setup_s': setup_s, 'eval_blocks_per_s': w['blocks'] / w['seconds']}
        result.update(metrics={m['name']: {'value': values[m['name']], 'unit': m['unit']}
                               for m in cell['end_to_end']}, device=device)
    bad = host.forbidden_modules()
    if bad:
        log(f'loaded forbidden modules: {bad}')
        return 3
    host.print_result(result, verdict['checks'])
    return 0


class RunView:
    """What a per-layer metric's reader sees of a traced run: the host spans
    and totals of the window's untraced stretch (`rest_*`), the traced
    slice's device summary, the cell's configuration and traffic."""

    def __init__(self, cell, w: dict, summary: dict, device_name: str, chips: int):
        self.arch, self.traffic, self.spans = cell.arch, cell.traffic, cell.spans
        self.rest_units, self.rest_seconds = w['rest_units'], w['rest_seconds']
        self.trace = summary
        self.device_name, self.chips = device_name, chips


def breakdown(summary: dict) -> dict:
    from .yardstick import top
    return {'device_ops': top(summary['device_ops']), 'idle_gaps': top(summary['idle_by_span'])}


def parse(argv):
    p = argparse.ArgumentParser(description='Run one benchmark cell once.')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    host.fix_environment()
    args = parse(argv)
    cell = load_cell(args.workload)
    host.require_cards(cell['chips'])
    return run(args, cell, t_start)

