"""K4, the GRU layer kernel (kernels/gru.py, csrc/gru_bf16.cu), where no card
is present:
  - its plain version, which reads the packed planes by the kernel's address
    arithmetic, against ops/gru.py's bf16 scan: equal to f32 rounding over a
    step, and far closer to it than bf16 is to the f64 scan over 100 steps;
  - the packing: the column order of the hidden units, the zero padding,
    the biases, and the packed-weight cache it shares with K1-K3;
  - ops/gru.py's route rule as a pure function of what a call shows;
  - the reader of `rnn_kernel_pct.eval`, with and without the counters."""
import sys
from pathlib import Path

import pytest
import torch

from turboae_tpu_torch.kernels import conv_stack as ks
from turboae_tpu_torch.kernels import gru as k4
from turboae_tpu_torch.ops import gru

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the rnn_eval cell's three layer shapes: the encoder's first layer (In = 1),
# the decoder's (In = 7) and every second layer (In = 2H = 200), H = 100
CELL_SHAPES = (1, 7, 200)


def _layer(In, H, seed=0):
    return gru.birnn_init(torch.Generator().manual_seed(seed), In, H, 1)[0]


@pytest.mark.parametrize('In', CELL_SHAPES)
def test_plain_equals_the_bf16_scan_over_a_step(In):
    """With no earlier h to round, K4's order of operations (r's and z's
    products in one sum, the biases after them, sigmoid and tanh through e)
    leaves only f32 rounding against the scan."""
    layer = _layer(In, 100)
    x = torch.randn((64, 1, In), generator=torch.Generator().manual_seed(1))
    got = k4.gru_bf16_plain(layer, x)
    want = gru._scan_layer(layer, x, 'gru', torch.bfloat16)
    assert got.shape == want.shape == (64, 1, 200)
    assert (got - want).abs().max().item() < 1e-6


@pytest.mark.parametrize('In', CELL_SHAPES)
def test_plain_stays_with_the_bf16_scan_over_100_steps(In):
    """Over 100 steps an f32 rounding apart can round h's bf16 copy the other
    way; the gap stays a tenth of what bf16 itself costs against the f64
    scan. The bf16 output is the f32 output rounded."""
    layer = _layer(In, 100, seed=2)
    x = torch.randn((3, 100, In), generator=torch.Generator().manual_seed(3))
    got = k4.gru_bf16_plain(layer, x)
    scan = gru._scan_layer(layer, x, 'gru', torch.bfloat16)
    exact = gru._scan_layer(layer, x.double(), 'gru', torch.float64)
    gap = (got - scan).abs().max().item()
    bf16_cost = (scan.double() - exact).abs().max().item()
    assert gap < 0.1 * bf16_cost
    half = k4.gru_bf16_plain(layer, x, out_f32=False)
    assert half.dtype == torch.bfloat16 and torch.equal(half, got.to(torch.bfloat16))


@pytest.mark.parametrize('In,H', [(13, 37), (150, 64), (208, 104)])
def test_plain_on_other_widths(In, H):
    """Odd and partial widths: x padded to 8 channels, units past H zero in
    the packed planes and held at zero by the gates."""
    layer = _layer(In, H, seed=4)
    x = torch.randn((5, 9, In), generator=torch.Generator().manual_seed(5))
    got = k4.gru_bf16_plain(layer, x)
    scan = gru._scan_layer(layer, x, 'gru', torch.bfloat16)
    exact = gru._scan_layer(layer, x.double(), 'gru', torch.float64)
    assert got.shape == (5, 9, 2 * H)
    assert (got - scan).abs().max().item() < 0.1 * (scan.double() - exact).abs().max().item()


def test_units_are_a_permutation():
    """Each of a gate's 104 columns holds one unit, and a thread's units of
    a pair of groups are four contiguous ones from a multiple of 4."""
    units = k4._units()
    assert sorted(units.tolist()) == list(range(104))
    for c0, n in ((0, 56), (56, 48)):
        for j in range(0, n // 8 - n // 8 % 2, 2):
            for q in range(4):
                got = [units[c0 + 8 * (j + g) + 2 * q + e].item() for g in (0, 1) for e in (0, 1)]
                assert got == list(range(got[0], got[0] + 4)) and got[0] % 4 == 0


@pytest.mark.parametrize('In,H', [(1, 100), (7, 100), (200, 100), (13, 37)])
def test_packed_operands(In, H):
    """W_hh' and W_ih' as the kernel's descriptors read them: element (k, n)
    is W[g H + u(n'), ch] in bf16 for column n = 104 g + n', ch = u(k) in
    W_hh' and k in W_ih', zero past H units or In channels; the biases by
    gate and unit, r's and z's summed."""
    layer = _layer(In, H, seed=6)
    plan = k4.gru_plan(3, 4, In, H, True)
    w, b = k4.pack_gru_bf16(layer, plan)
    assert w.dtype == torch.bfloat16 and b.dtype == torch.float32
    assert w.shape == (2, 312 * (112 + plan.kx)) and b.shape == (2, 4, 104)
    assert k4.packed_bytes(In) == w.numel() * 2 + b.numel() * 4
    units, order = k4._units(), torch.arange(plan.kx)
    n = torch.arange(312)
    g, u = n // 104, units[n % 104]
    live = u < H
    for d, name in enumerate(('fwd', 'bwd')):
        p = {k: t.to(torch.bfloat16).float() for k, t in layer[name].items()}
        whh, wih = k4._operand(w[d], 112), k4._operand(w[d, 312 * 112:], plan.kx)
        want_hh = torch.zeros(112, 312)
        c = torch.arange(104)
        hh_ok = units[c] < H
        want_hh[c[hh_ok].view(-1, 1), n[live]] = p['w_hh'][(g * H + u)[live]][:, units[c[hh_ok]]].t()
        assert torch.equal(whh, want_hh)
        want_ih = torch.zeros(plan.kx, 312)
        k = torch.arange(plan.kx)
        ih_ok = order < In
        want_ih[k[ih_ok].view(-1, 1), n[live]] = p['w_ih'][(g * H + u)[live]][:, order[ih_ok]].t()
        assert torch.equal(wih, want_ih)
        bi, bh = layer[name]['b_ih'].view(3, H), layer[name]['b_hh'].view(3, H)
        want_b = torch.zeros(4, 104)
        want_b[:, :H] = torch.stack([bi[0] + bh[0], bi[1] + bh[1], bi[2], bh[2]])
        assert torch.equal(b[d], want_b)


def test_the_pack_cache_keeps_a_layers_planes():
    """In inference mode the layer's planes come from K1-K3's cache: a miss,
    then a hit; an in-place write packs anew."""
    layer = _layer(7, 100, seed=7)
    plan = k4.gru_plan(2, 3, 7, 100, True)
    ks.clear_packs()
    try:
        with torch.inference_mode():
            hits, misses = k4.gru_bf16.pack_hits, k4.gru_bf16.pack_misses
            first = ks.packed(k4.gru_bf16, [layer], plan)
            second = ks.packed(k4.gru_bf16, [layer], plan)
        assert (k4.gru_bf16.pack_hits - hits, k4.gru_bf16.pack_misses - misses) == (1, 1)
        assert all(a is b for a, b in zip(first, second))
        want = k4.pack_gru_bf16(layer, plan)
        assert all(torch.equal(a, b) for a, b in zip(first, want))
        with torch.no_grad():
            layer['bwd']['b_hh'].add_(1.0)
        with torch.inference_mode():
            third = ks.packed(k4.gru_bf16, [layer], plan)
        assert k4.gru_bf16.pack_misses - misses == 2
        assert not torch.equal(third[1], first[1])
    finally:
        ks.clear_packs()


def test_the_wrapper_runs_the_plain_version_on_the_cpu():
    layer = _layer(7, 100, seed=8)
    x = torch.randn((4, 5, 7), generator=torch.Generator().manual_seed(9))
    launches = k4.gru_bf16.launches
    assert torch.equal(k4.gru_bf16(layer, x), k4.gru_bf16_plain(layer, x))
    assert k4.gru_bf16.launches == launches


# ------------------------------------------------------------- the route
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize('args,want', [
    (('cpu', 'gru', BF16, False, False, 100, 200), 'scan'),
    (('cpu', 'lstm', F32, True, True, 100, 200), 'scan'),
    (('cuda', 'gru', BF16, False, False, 100, 200), 'kernel'),
    (('cuda', 'gru', BF16, False, False, 104, 208), 'kernel'),
    (('cuda', 'gru', BF16, False, False, 100, 1), 'kernel'),
    (('cuda', 'gru', F32, False, False, 100, 200), 'cudnn'),
    (('cuda', 'lstm', BF16, False, False, 100, 200), 'cudnn'),
    (('cuda', 'gru', BF16, True, False, 100, 200), 'cudnn'),
    (('cuda', 'gru', BF16, False, True, 100, 200), 'cudnn'),
    (('cuda', 'gru', BF16, False, False, 105, 210), 'cudnn'),
    (('cuda', 'gru', BF16, False, False, 100, 209), 'cudnn'),
    (('cuda', 'gru', torch.float64, False, False, 100, 200), 'cudnn'),
])
def test_the_route_rule(args, want):
    assert gru.route_for(*args) == want


@pytest.mark.parametrize('args,route,want', [
    (('cuda', 'gru', BF16, False, False, 100, 200), 'cudnn', 'cudnn'),
    (('cuda', 'gru', BF16, False, False, 100, 200), 'scan', 'scan'),
    (('cuda', 'gru', F32, False, False, 100, 200), 'scan', 'scan'),
    (('cuda', 'gru', BF16, False, False, 100, 200), 'kernel', 'kernel'),
])
def test_a_forced_route(args, route, want):
    assert gru.route_for(*args, route=route) == want


@pytest.mark.parametrize('args,route', [
    (('cpu', 'gru', BF16, False, False, 100, 200), 'kernel'),
    (('cpu', 'gru', BF16, False, False, 100, 200), 'cudnn'),
    (('cuda', 'gru', BF16, False, False, 120, 240), 'kernel'),
    (('cuda', 'gru', F32, False, False, 100, 200), 'kernel'),
    (('cuda', 'lstm', BF16, False, False, 100, 200), 'kernel'),
    (('cuda', 'gru', BF16, True, False, 100, 200), 'kernel'),
    (('cuda', 'gru', BF16, False, True, 100, 200), 'kernel'),
    (('cuda', 'gru', BF16, False, False, 100, 200), 'fast'),
])
def test_a_route_that_cannot_run_raises(args, route):
    with pytest.raises(ValueError):
        gru.route_for(*args, route=route)


def test_a_cpu_stack_takes_the_scan_and_refuses_the_kernel():
    layers = gru.bigru_init(torch.Generator().manual_seed(10), 7, 6, 2)
    x = torch.randn((2, 5, 7), generator=torch.Generator().manual_seed(11))
    before = dict(gru.ROUTE_CALLS)
    with torch.inference_mode():
        gru.bigru_apply(layers, x, torch.bfloat16)
    assert gru.ROUTE_CALLS['scan'] == before['scan'] + 2
    assert gru.ROUTE_CALLS['kernel'] == before['kernel']
    with pytest.raises(ValueError):
        gru.bigru_apply(layers, x, torch.bfloat16, route='kernel')


# ------------------------------------------------------------ the reader
def _view():
    import types
    from benchmark.harness import main as M
    from benchmark.harness.main import RunView
    from benchmark.harness.tracing import Spans
    c = M.load_cell('rnn_eval')
    cell = types.SimpleNamespace(arch=c['arch'], traffic=c['traffic'], spans=Spans())
    return RunView(cell, {'rest_units': 1, 'rest_seconds': 1.0}, None, 'NVIDIA H100 80GB HBM3', 1)


def test_the_reader_with_the_counters(monkeypatch):
    from benchmark.harness.main import reader
    monkeypatch.setattr(gru.birnn_apply, 'layers', 60)
    monkeypatch.setattr(k4.gru_bf16, 'launches', 60)
    assert reader('rnn_kernel_pct.eval')(_view()) == pytest.approx(100.0)
    monkeypatch.setattr(k4.gru_bf16, 'launches', 15)   # a quarter of the layers
    assert reader('rnn_kernel_pct.eval')(_view()) == pytest.approx(25.0)


def test_the_reader_without_the_counters(monkeypatch):
    """None without a layer call, without the launch counter, or without
    the kernel's module (the parent's program)."""
    from benchmark.harness.main import reader
    monkeypatch.setattr(gru.birnn_apply, 'layers', 0)
    monkeypatch.setattr(k4.gru_bf16, 'launches', 0)
    assert reader('rnn_kernel_pct.eval')(_view()) is None
    monkeypatch.setattr(gru.birnn_apply, 'layers', 60)
    monkeypatch.delattr(k4.gru_bf16, 'launches')
    assert reader('rnn_kernel_pct.eval')(_view()) is None
    monkeypatch.setitem(sys.modules, 'turboae_tpu_torch.kernels.gru', None)
    assert reader('rnn_kernel_pct.eval')(_view()) is None
