#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, from the root of a checkout:

    python3 benchmark/run.py --workload crown_eval --seed 7 --seconds 10 --trace 0

It loads, warms up the cell's own shapes, measures for --seconds, checks what
the timed path produced against the plain reference (benchmark/reference/)
and prints one JSON line: `correct`, `attempted`, `failed`, `metrics`
(--trace 0: the cell's end-to-end metrics; --trace 1: its per-layer ones),
`device`, with --trace 1 `breakdown`, and last `checks`. With no CUDA card,
or fewer than the cell asks for, it exits 2 and prints no result.
"""
import sys
import time

T_START = time.time()

from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness.main import main  # noqa: E402

if __name__ == '__main__':
    sys.exit(main(sys.argv[1:], T_START))
