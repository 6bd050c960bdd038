"""The numbers that decide `correct`, and their judgement against the
cell's limits (benchmark/limits/<cell>.json; PERF.md gives the readings
each limit was set from).

Evaluation (per sampled batch i, program p against reference r, both
decoding the same bits and noise):
  - bit_l1: sum_i |bit_p(i) - bit_r(i)| / sum_i bit_r(i);
  - blk_l1: the same of the block errors;
  - pos_l1: sum_i sum_t |pos_p(i, t) - pos_r(i, t)| / sum_i bit_r(i), the
    positional error counts, so that a decision moved from one position to
    another counts too.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np


def eval_numbers(prog: Sequence[tuple], ref: Sequence[tuple]) -> Dict[str, float]:
    bit_r = sum(r[0] for r in ref)
    den = max(bit_r, 1)
    return {
        'bit_l1': sum(abs(int(p[0]) - int(r[0])) for p, r in zip(prog, ref)) / den,
        'blk_l1': sum(abs(int(p[1]) - int(r[1])) for p, r in zip(prog, ref))
        / max(sum(r[1] for r in ref), 1),
        'pos_l1': sum(int(np.abs(np.asarray(p[2], np.int64) - np.asarray(r[2], np.int64)).sum())
                      for p, r in zip(prog, ref)) / den,
    }


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{'correct': every limited number finite and within its limit,
    'checks': {name: {'value', 'limit'}}, 'numbers': all of them}."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        if v is None or not math.isfinite(v) or v > limit:
            ok = False
        out[name] = {'value': v, 'limit': limit}
    return {'correct': ok, 'checks': out, 'numbers': numbers}
