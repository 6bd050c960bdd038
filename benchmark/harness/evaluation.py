"""The evaluation sweep cell: one caller, closed loop, in points of whole
batches cycling through the SNR grid.

Each batch's bits and noise are drawn on the device (inputs.draw) and
handed to the program's `train.sweep.sweep_counts(params, cfg, bits,
noise, perms)`; its counts are added on the device and read on the host at
the end of each point, as the program's own `sweep` does. The window ends
at the first point end past --seconds; it counts the blocks of every batch
in it (all finished: the point's host read waits for them) over its
seconds, and the seconds of each untraced point.

`correct`: after the window, a sample of its batches drawn from the seed
(CHECK_BATCHES of each grid point) is encoded and decoded again by the
configuration's plain reference (reference/<reference>.py, f32) from the
checkpoint read by its own reader, on the same bits and noise; the
program's counts of those batches are compared with the reference's
(checks.eval_numbers).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from . import checks, inputs, yardstick
from .host import ROOT, sync
from .tracing import Slice, Spans

CHECK_BATCHES = 2                 # sampled batches of each SNR point
REFERENCE_POSITIONS = 500_000     # rows x block length the reference decodes at once


class EvalCell:
    def __init__(self, arch: dict, traffic: dict, seed: int, device, spans: Spans,
                 check_batches: int = CHECK_BATCHES,
                 reference_positions: int = REFERENCE_POSITIONS):
        self.arch, self.traffic, self.seed, self.device, self.spans = \
            arch, traffic, seed, device, spans
        self.check_batches, self.reference_positions = check_batches, reference_positions
        self.batch, self.L = traffic['batch_size'], arch['block_len']
        self.grid = inputs.snr_grid(*traffic['snr_db'], traffic['snr_points'])
        self.per_point = traffic['blocks_per_point'] // self.batch
        self.gen = torch.Generator(device=device)

    # ------------------------------------------------------------ program
    def setup(self):
        import turboae_tpu_torch.train.sweep as sweep
        from turboae_tpu_torch.cli.eval_flagship import load_flagship
        from turboae_tpu_torch.models.channel_ae import make_perms
        self._sweep = sweep
        t = self.traffic
        self.cfg = inputs.program_config(self.arch, batch_size=t['batch_size'],
                                         channel=t['channel'],
                                         use_fused_conv=t['use_fused_conv'])
        self.params = load_flagship(str(ROOT / self.arch['checkpoint']), self.device)
        self.perms = make_perms(self.cfg, self.device)
        for unit in (-3, -4):                   # the cell's one shape, twice
            self.counts(*self.draw(unit))
        sync(self.device)

    def counts(self, bits, noise):
        """The timed call: the program's counts of one batch."""
        return self._sweep.sweep_counts(self.params, self.cfg, bits, noise, self.perms)

    def snr(self, unit: int) -> float:
        return self.grid[(unit // self.per_point) % len(self.grid)]

    def draw(self, unit: int):
        return inputs.draw(self.gen, self.seed, unit, self.batch, self.L, self.snr(unit),
                           self.device)

    def window(self, seconds: float, trace_seconds: float = 0.0) -> dict:
        """Run the closed loop for `seconds`; with trace_seconds, the first
        whole points past it are traced (and left out of the host totals)."""
        sp, dev = self.spans, self.device
        self.results: List[tuple] = []
        sl = Slice(sp, dev) if trace_seconds else None
        sync(dev)
        if sl:
            sl.start()
        t0 = time.perf_counter()
        rest = (t0, 0)
        units, point_s, start = 0, [], t0
        while True:
            acc_b = torch.zeros((), dtype=torch.int64, device=dev)
            acc_k = torch.zeros((), dtype=torch.int64, device=dev)
            for _ in range(self.per_point):
                with sp.span('draw'):
                    bits, noise = self.draw(units)
                with sp.span('sweep_counts'):
                    be, ke, pe = self.counts(bits, noise)
                with sp.span('accumulate'):
                    acc_b += be
                    acc_k += ke
                self.results.append((be, ke, pe))
                units += 1
            with sp.span('read_counts'):
                int(acc_b), int(acc_k)
            now = time.perf_counter()
            if sl is None or not sl.active:
                point_s.append(now - start)
            if sl is not None and sl.active and now - t0 >= trace_seconds:
                sl.stop()
                now = time.perf_counter()
                rest = (now, units)
            start = now
            if now - t0 >= seconds:
                break
        if sl is not None and sl.active:
            sl.stop()
        self.units = units
        return {'units': units, 'seconds': now - t0, 'blocks': units * self.batch,
                'rest_units': units - rest[1], 'rest_seconds': now - rest[0],
                'point_seconds': point_s, 'slice': sl}

    def free(self):
        """Keep the sampled batches' counts on the host; free the rest."""
        self.sample = self._sample(self.units)
        self.prog = [tuple(t.cpu() for t in self.results[i]) for i in self.sample]
        self.results = self.params = None

    def _sample(self, units: int) -> List[int]:
        rng = np.random.default_rng(inputs.unit_seed(self.seed, -2))
        k = self.check_batches
        out = []
        for p in range(len(self.grid)):
            cand = [i for i in range(units) if (i // self.per_point) % len(self.grid) == p]
            if cand:
                out += sorted(rng.choice(cand, size=min(k, len(cand)), replace=False).tolist())
        return sorted(out)

    # ---------------------------------------------------------- reference
    def reference_counts(self, units: List[int], precision: str = 'f32') -> List[tuple]:
        """(bit, block, positional) error counts of the reference on the
        units' inputs; rows decoded in blocks that fit."""
        ref, arch = yardstick.reference(self.arch), self.arch
        params = ref.load(str(ROOT / arch['checkpoint']), arch, self.device)
        pm = ref.perms(self.L, self.device)
        rows = max(1, self.reference_positions // self.L)
        out = []
        with torch.no_grad():
            for unit in units:
                bits, noise = self.draw(unit)
                code = ref.encode(params, bits, pm, arch, precision)
                pos = torch.zeros(self.L, dtype=torch.int64, device=self.device)
                blk = 0
                for s in range(0, self.batch, rows):
                    o = ref.decode(params, code[s:s + rows] + noise[s:s + rows], pm, arch,
                                   precision)
                    err = torch.round(o.reshape(o.shape[0], -1)) != bits[s:s + rows].reshape(
                        o.shape[0], -1)
                    pos += err.sum(dim=0)
                    blk += int(err.any(dim=1).sum())
                out.append((int(pos.sum()), blk, pos.cpu()))
        return out

    def check(self, limits: Dict[str, float]) -> dict:
        ref_counts = self.reference_counts(self.sample)
        return checks.judge(checks.eval_numbers(self.prog, ref_counts), limits)
