"""K3, the dense conv-stack kernel (kernels/conv_stack.py: dense_stack_bf16,
csrc/dense_stack_bf16.cu), on the CPU: its plan, its packer read back as
wgmma's descriptor reads it, a CPU model of the kernel's channel-blocked
buffer read by descriptor, the plain version against the f32 dense stack,
the decoder's routing, the counters and the gradient. The kernel itself runs
only on the card (tests/test_torch_gpu.py). The file imports no JAX.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from turboae_tpu_torch.config import Config
from turboae_tpu_torch.kernels import conv_stack as ks
from turboae_tpu_torch.models.channel_ae import init_ae, make_perms
from turboae_tpu_torch.ops import conv1d as cv
from turboae_tpu_torch.train.sweep import sweep_counts
from turboae_tpu_torch.utils import logging as tlog

# the plain version (bf16 operands, f32 sums, one bf16 rounding a layer)
# against the f32 stack: a few bf16 ulps of the largest output, as K2's
# plain version is held to its f32 reference (tests/test_kernels.py:33-41)
BF16_REL_TOL = 1e-2


def _rel(got, ref) -> float:
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max()).item()


def _stack(num_layer, cin, c, k, seed=0):
    return cv.dense_stack_init(torch.Generator().manual_seed(seed), num_layer, cin, c, k)


def _x(B, L, cin, seed=1):
    return torch.randn((B, L, cin), generator=torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------- the plan
def test_plan_at_deepturbos_shape():
    """B=2000, L=100, Cin=7, C=100, K=5, 5 layers on 132 SMs: two batch rows
    a block (M = 204 in four m64 tiles, four consumer warpgroups of n104),
    one channel-blocked buffer of 52 groups of 8 channels (x, a zero channel,
    four slots of 100: 408 channels, and the group that layer 4's rounding
    to 416 reads), each 2 x 104 rows of 16 bytes (the group stride, 3,328
    bytes), and a tail of the 52 rows that the padded tiles read past the
    last group (rows 208..259): 173,888 bytes, beside a 4-stage ring of
    13,312-byte chunks, five f32 biases and eight mbarriers: 230,304 bytes.
    Each layer contracts 16, 112, 208, 320, 416 rows a tap: 5,360 a stack
    against 5,175 exact. Three rows need five warpgroups and do not fit."""
    plan = ks.dense_plan(2000, 100, 7, 100, 5, 5, n_sm=132)
    assert (plan.R, plan.G, plan.nc, plan.N, plan.stages) == (2, 1056, 4, 104, 4)
    assert (plan.P, plan.Cinp, plan.Cs) == (104, 8, 100)
    assert (plan.GS, plan.groups, plan.tail) == (8 * 208, 52, 8 * 52)
    assert 2 * plan.GS == 3328 and 2 * plan.tail == 832 == 16 * (64 * plan.nc + 5 - 1 - 208)
    assert 2 * plan.buf == 52 * 208 * 16 + 832 == 173888
    assert plan.smem == 1024 + 4 * 104 * 128 + 2 * plan.buf + 4 * 5 * 104 + 16 * 4 == 230304
    assert plan.smem <= ks.SMEM_LIMIT == 232448
    assert 8 * plan.groups == plan.tap_rows(4) == 416 and 8 + 4 * 100 == 408
    assert [plan.tap_rows(i) for i in range(5)] == [16, 112, 208, 320, 416]
    assert 5 * sum(plan.tap_rows(i) for i in range(5)) == 5360
    assert 5 * sum(7 + 100 * i for i in range(5)) == 5175
    assert [plan.chunks(i) for i in range(5)] == [2, 9, 17, 25, 33]
    assert len(plan.as_ints()) == 16
    three = ks.dense_layout(100, 7, 100, 5, 5, R=3)
    assert three.nc == 5 and not three.fits()


@pytest.mark.parametrize('B', [2000, 1001, 500, 7, 1])
@pytest.mark.parametrize('L,cin,c', [(100, 7, 100), (100, 7, 12), (23, 3, 30), (100, 8, 104),
                                     (200, 7, 100)])
def test_plan_fills_whole_rounds(B, L, cin, c):
    """K2's rule of whole rounds: with Rmax the most rows a block holds,
    ceil(B / (n_sm * Rmax)) rounds of blocks over 132 SMs in G blocks that
    fill every round (or one a row), ceil(B/G) or one fewer rows each;
    every plan fits a block's shared memory and its warpgroups cover M."""
    plan = ks.dense_plan(B, L, cin, c, 5, 5, n_sm=132)
    r_max = 1
    while ks.dense_layout(L, cin, c, 5, 5, r_max + 1).fits() and r_max < B:
        r_max += 1
    assert plan.G == min(B, 132 * -(-B // (132 * r_max))) and plan.R <= r_max
    sizes = [(i + 1) * B // plan.G - i * B // plan.G for i in range(plan.G)]
    assert sum(sizes) == B and max(sizes) == plan.R and min(sizes) >= plan.R - 1
    assert plan.fits() and plan.nc * 64 >= plan.R * plan.P - 4
    assert plan.N == ks.DENSE_N and plan.nc <= ks.DENSE_NC and plan.Cs <= plan.N
    assert plan.GS == 8 * plan.R * plan.P and 8 * plan.groups >= plan.tap_rows(4) >= \
        plan.Cinp + 4 * plan.Cs
    assert plan.tail == 8 * (64 * plan.nc + 4 - plan.R * plan.P) >= 0


def test_long_blocks_are_windowed():
    """At L=1000 no block holds a row (the most: 239, in four m64 tiles
    with a 2-stage ring; 52 groups of 243 rows and a tail of 17), so the
    wrapper windows the time axis, halo 5 * (5 // 2) = 10 each side: 5
    windows of 220 rows, each window a row of a plan that fits (a 3-stage
    ring). L=239 still fits whole, L=240 does not."""
    assert ks.dense_plan(16, 1000, 7, 100, 5, 5, n_sm=132) is None
    assert ks.dense_max_rows(7, 100, 5, 5) == 239
    longest = ks.dense_layout(239, 7, 100, 5, 5, R=1)
    assert (longest.stages, longest.groups, longest.GS, longest.tail) == (2, 52, 8 * 243, 8 * 17)
    assert longest.fits() and not ks.dense_layout(240, 7, 100, 5, 5, R=1).fits()
    idx_in, _, r = ks.window_plan(1000, ks.dense_max_rows(7, 100, 5, 5), 10)
    assert (idx_in.numel() // r, r) == (5, 220)
    plan = ks.dense_plan(16 * 5, r, 7, 100, 5, 5, n_sm=132)
    assert (plan.R, plan.nc, plan.stages) == (1, 4, 3) and plan.fits()


def test_what_does_not_fit_is_refused():
    """K3 has one wgmma width, n104: C = 104 fits, more output channels never
    do, and the wrapper's check refuses them on the card. A stack whose halo
    fills every window is refused by window_plan's ValueError, as K2's is:
    C=100, K=5, 40 layers hold a row of 19 at most (490 groups of 23 rows)
    and need a halo of 80 on each side; only the shapes are read."""
    assert ks.dense_layout(100, 8, 104, 5, 2, R=1).fits()
    assert ks.dense_max_rows(7, 105, 5, 2) == ks.dense_max_rows(7, 300, 5, 2) == 0
    assert not ks.dense_layout(100, 7, 105, 5, 2, R=1).fits()
    for c in (105, 300):
        with pytest.raises(ValueError, match='at most 104 output channels'):
            ks._check_dense_layers(_stack(2, 7, c, 5), 7)
    assert ks._check_dense_layers(_stack(2, 7, 104, 5), 7) == (104, 5)
    rows = ks.dense_max_rows(7, 100, 5, 40)
    assert rows == 19 and ks.dense_layout(rows, 7, 100, 5, 40, R=1).groups == 490
    with pytest.raises(ValueError, match='shared memory'):
        ks.window_plan(100, rows, 40 * (5 // 2))


def test_wrapper_checks_dense_shapes_and_devices():
    layers = _stack(3, 7, 16, 5)
    x = _x(2, 10, 7)
    with pytest.raises(ValueError, match='runs on cuda or cpu'):
        ks.dense_stack_bf16(layers, x.to('meta'))
    plain = cv.stack_init(torch.Generator().manual_seed(0), 3, 7, 16, 5)
    with pytest.raises(ValueError, match='dense layer 1'):
        ks._check_dense_layers(plain, 7)
    assert ks._check_dense_layers(layers, 7) == (16, 5)


# ---------------------------------------------------------------- the packer
def _unpack(chunks, plan):
    """K3's packed chunks (nch, N*64) read back as the kernel's wgmma reads
    them: k16 step s of a chunk starts 32*s bytes in, 1024 bytes between
    8-row groups of N, 128 between the rows of a group, value (k, n) at 2*k
    more, with the 128-byte swizzle (address bits 4-6 ^= bits 7-9). Returns
    W' (nch*64, N)."""
    N = plan.N
    s, k, n = torch.arange(4).view(4, 1, 1), torch.arange(16).view(1, 16, 1), torch.arange(N)
    addr = 32 * s + n // 8 * 1024 + n % 8 * 128 + 2 * k           # (4, 16, N) bytes
    addr = addr ^ ((addr >> 7) & 7) << 4
    return chunks[:, addr // 2].reshape(-1, N)


def _layer_weights(w0, wr, plan):
    """Each layer's W' (K * tap_rows(i), N), cut from the unpacked chunks."""
    out, dense = [], [_unpack(w0, plan)] + ([_unpack(wr, plan)] if wr is not None else [])
    flat = torch.cat(dense)
    at = 0
    for i in range(plan.num_layer):
        n = plan.chunks(i) * 64
        out.append((flat[at:at + n], plan.K * plan.tap_rows(i)))
        at += n
    assert at == flat.shape[0]
    return out


def _buffer_channel_source(plan, i, ch):
    """The input channel of layer i that buffer channel ch holds, or None."""
    if ch < plan.Cin:
        return ch
    if ch < plan.Cinp or ch >= plan.Cinp + i * plan.Cs:
        return None
    slot, cc = divmod(ch - plan.Cinp, plan.Cs)
    return plan.Cin + slot * plan.C + cc if cc < plan.C else None


@pytest.mark.parametrize('cin,c,k,nl', [(7, 100, 5, 5), (7, 13, 3, 3), (8, 30, 5, 2),
                                        (3, 9, 1, 4), (7, 12, 5, 1)])
def test_packer_reads_back_per_tap_and_layer(cin, c, k, nl):
    """Row tap * tap_rows(i) + ch of layer i's W' is W_i[:, ci, tap] for the
    input channel ci that buffer channel ch holds (x; the zero channel of an
    odd Cin; slot s of earlier outputs, C of Cs used), zero on every pad, on
    channels at or past the layer's own, in the rows past K * tap_rows(i)
    and in the columns past C; biases f32, zero past C. One layer gives no
    other layers' chunks."""
    layers = _stack(nl, cin, c, k)
    plan = ks.dense_layout(20, cin, c, k, nl, R=1)
    w0, b0, wr, br = ks.pack_dense_bf16(layers, plan)
    assert w0.dtype == torch.bfloat16 and b0.dtype == torch.float32
    assert w0.shape == (plan.chunks(0), plan.N * 64) and b0.shape == (plan.N,)
    if nl == 1:
        assert wr is None and br is None
    else:
        assert wr.shape == (sum(plan.chunks(i) for i in range(1, nl)), plan.N * 64)
        assert br.shape == (nl - 1, plan.N)
    for i, (W, rows) in enumerate(_layer_weights(w0, wr, plan)):
        w = layers[i]['w'].to(torch.bfloat16)
        tr = plan.tap_rows(i)
        want = torch.zeros_like(W)
        for tap in range(k):
            for ch in range(tr):
                ci = _buffer_channel_source(plan, i, ch)
                if ci is not None:
                    want[tap * tr + ch, :c] = w[:, ci, tap]
        assert torch.equal(W, want), i
        assert not W[rows:].any() and not W[:, c:].any()
        b = b0 if i == 0 else br[i - 1]
        assert torch.equal(b[:c], layers[i]['b'].float()) and not b[c:].any()
    # every weight of every layer lands once
    total = sum(int((W != 0).sum()) for W, _ in _layer_weights(w0, wr, plan))
    assert total == sum(int((p['w'].to(torch.bfloat16) != 0).sum()) for p in layers)


# ---------------------------------------------------------------- the layout model
def _index(plan, m, c):
    """The buffer's value index of channel c of row m: channel-blocked,
    groups of 8 channels GS values apart, 8 values a row."""
    return c // 8 * plan.GS + 8 * m + c % 8


def _a_operand(plan, tile, tap, g):
    """Value indices (64, 16) of the A operand that wgmma reads by
    descriptor for m64 tile `tile`, tap `tap`, k16 step g of the tap: start
    at groups 2g, 2g+1 and row 64*tile + tap (16 bytes a row); row r of the
    operand at (r//8)*SBO + (r%8)*16 bytes, column q at (q//8)*LBO + (q%8)*2,
    SBO = 128, LBO = the group stride GS*2. Nothing clamps a row."""
    start = 2 * (2 * g * plan.GS) + 16 * (64 * tile + tap)
    r, q = torch.arange(64).view(-1, 1), torch.arange(16)
    return (start + r // 8 * 128 + r % 8 * 16 + q // 8 * 2 * plan.GS + q % 8 * 2) // 2


def _unread(plan, Rv):
    """The values of a block's buffer that no valid output reads with a
    nonzero weight: the absent rows (past Rv*P) of every group, the tail,
    and every pad channel (the zero channel, C..Cs-1 of a slot, the groups
    past the last slot) of every row."""
    v = torch.arange(plan.buf)
    g, rest = v // plan.GS, v % plan.GS
    row, ch = rest // 8, g * 8 + rest % 8
    tail = v >= plan.groups * plan.GS
    slot = ch - plan.Cinp
    real = (ch < plan.Cin) | ((slot >= 0) & (slot < (plan.num_layer - 1) * plan.Cs)
                              & (slot % plan.Cs < plan.C))
    return tail | (row >= Rv * plan.P) | ~real


def _model(layers, x, plan, poison=None):
    """K3's arithmetic in K3's own layout, on the CPU: block i takes batch
    rows [i*B//G, (i+1)*B//G) into one zeroed channel-blocked buffer of
    `buf` values (`_index`), x in channels [0, Cin); each layer, per tap,
    the A operand of each m64 tile that holds a row, read as the descriptor
    reads it (`_a_operand`: the padded rows on into the next group and the
    tail), times that tap's W' as wgmma reads it from the chunks, in f32;
    bias, ELU and bf16 written to the valid rows of the layer's slot (the
    last layer: channels [0, Cs)) only after every product of the layer;
    the output read back from the buffer. The kernel runs four products a
    chunk, so past a layer's last k16 step it multiplies the chunk's rows
    beyond K * tap_rows(i), which must be zero. `poison`, a value written
    over what no valid output reads with a nonzero weight (`_unread`) once
    x is in."""
    w0, b0, wr, br = ks.pack_dense_bf16(layers, plan)
    Ws = _layer_weights(w0, wr, plan)
    B, L, Cin = x.shape
    P, pad = plan.P, plan.K // 2
    outs = []
    for blk in range(plan.G):
        r0, r1 = blk * B // plan.G, (blk + 1) * B // plan.G
        Rv = r1 - r0
        assert 1 <= Rv <= plan.R
        M = Rv * P - (plan.K - 1)
        tiles = -(-M // 64)
        assert tiles <= plan.nc
        m = torch.arange(64 * tiles)
        valid = (m // P < Rv) & (m % P < L)
        buf = torch.zeros(plan.buf, dtype=torch.bfloat16)
        for r in range(Rv):
            rows = (r * P + pad + torch.arange(L)).view(-1, 1)
            buf[_index(plan, rows, torch.arange(Cin))] = x[r0 + r].to(torch.bfloat16)
        if poison is not None:
            buf[_unread(plan, Rv)] = poison
        for i in range(plan.num_layer):
            W, _ = Ws[i]
            tr = plan.tap_rows(i)
            assert not W[plan.K * tr:].any()
            v = 0
            for tap in range(plan.K):
                at = torch.cat([torch.cat([_a_operand(plan, t, tap, g) for g in range(tr // 16)],
                                          dim=1) for t in range(tiles)])
                assert int(at.max()) < plan.buf
                v = v + buf[at].float() @ W[tap * tr:(tap + 1) * tr].float()
            b = b0 if i == 0 else br[i - 1]
            y = torch.nn.functional.elu(v + b).to(torch.bfloat16)[:, :plan.Cs]
            col0 = 0 if i == plan.num_layer - 1 else plan.Cinp + i * plan.Cs
            buf[_index(plan, (m[valid] + pad).view(-1, 1), col0 + torch.arange(plan.Cs))] = \
                y[valid]
        outs += [buf[_index(plan, (r * P + pad + torch.arange(L)).view(-1, 1),
                            torch.arange(plan.C))] for r in range(Rv)]
    return torch.stack(outs)


def _blocks_partly_filled(L, cin, c, k, nl):
    """(plan, B): B = 2 Rmax + 1 rows over two SMs, so blocks hold fewer rows
    than the plan and their m64 tiles are partly filled."""
    r_max = 1
    while ks.dense_layout(L, cin, c, k, nl, r_max + 1).fits():
        r_max += 1
    B = 2 * r_max + 1
    return ks.dense_plan(B, L, cin, c, k, nl, n_sm=2), B


@pytest.mark.parametrize('cin,c,k,nl', [(7, 100, 5, 5), (7, 13, 3, 3), (8, 30, 5, 2),
                                        (3, 9, 1, 4), (7, 12, 5, 1), (7, 104, 3, 2)])
def test_layout_model_equals_plain(cin, c, k, nl):
    """The channel-blocked layout, the packer, both descriptors' reads (the
    padded tiles' rows reading on into the next group and the tail) and the
    row mask, run on the CPU, give the plain version's output: both round
    to bf16 once a layer, but the model sums per tap over the buffer's
    channel order and pads, so a sum on a rounding boundary may round the
    other way: at most one bf16 step (2^-8 of the largest output) on under
    1e-3 of the outputs. A fault of the layout moves most outputs. B = 2
    Rmax + 1 rows over two SMs leaves blocks of fewer rows than the plan
    holds and m64 tiles partly filled."""
    layers = _stack(nl, cin, c, k)
    L = 40
    plan, B = _blocks_partly_filled(L, cin, c, k, nl)
    x = _x(B, L, cin, seed=3)
    got = _model(layers, x, plan)
    ref = ks.dense_stack_bf16_plain(layers, x)
    assert got.shape == ref.shape == (B, L, c) and got.dtype == torch.bfloat16
    assert _rel(got, ref) <= 2 ** -8
    assert (got != ref).float().mean().item() < 1e-3


@pytest.mark.parametrize('cin,c,k,nl', [(7, 100, 5, 5), (7, 13, 3, 3), (3, 9, 1, 4),
                                        (7, 12, 5, 1)])
def test_layout_model_ignores_what_valid_rows_do_not_read(cin, c, k, nl):
    """Large finite values (2^100) over the tail, the absent rows of every
    group (which only the padded tiles read) and every pad channel (read
    with zero weights) leave every valid output bit for bit as it was: the
    kernel may leave them unzeroed without changing a result, and the
    padded rows read only finite values. L = 100, as DeepTurbo's: two rows a
    plan, a tail of 52 to 56 rows, blocks of one row beside blocks of two."""
    layers = _stack(nl, cin, c, k)
    plan, B = _blocks_partly_filled(100, cin, c, k, nl)
    x = _x(B, 100, cin, seed=4)
    assert plan.tail > 0 and any(
        (i + 1) * B // plan.G - i * B // plan.G < plan.R for i in range(plan.G))
    clean, poisoned = _model(layers, x, plan), _model(layers, x, plan, poison=2.0 ** 100)
    assert torch.isfinite(poisoned.float()).all()
    assert torch.equal(poisoned, clean)


# ---------------------------------------------------------------- plain version
@pytest.mark.parametrize('cin,c,k,nl', [(7, 100, 5, 5), (7, 16, 3, 3), (5, 12, 1, 2)])
def test_plain_matches_the_f32_dense_stack(cin, c, k, nl):
    """dense_stack_bf16_plain against the f32 dense_stack_apply on the same
    weights: within BF16_REL_TOL of the largest output; the CPU wrapper is
    the plain version and launches nothing."""
    layers = _stack(nl, cin, c, k)
    x = _x(4, 30, cin)
    ref = cv.dense_stack_apply(layers, x)
    got = ks.dense_stack_bf16_plain(layers, x)
    assert got.dtype == torch.bfloat16 and got.shape == (4, 30, c)
    assert _rel(got, ref) < BF16_REL_TOL
    before = ks.dense_stack_bf16.launches
    assert torch.equal(ks.dense_stack_bf16(layers, x), got)
    assert ks.dense_stack_bf16.launches == before


def test_windowed_plain_equals_the_whole_stack():
    """The windowing of long blocks, on the plain version at a window
    shorter than L: within bf16's 1e-2 (the matmuls see other row counts)."""
    layers = _stack(3, 7, 24, 5)
    x = _x(3, 90, 7)
    got = ks.run_windowed(ks.dense_stack_bf16_plain, layers, x, rows=37)
    assert got.dtype == torch.bfloat16
    assert _rel(got, ks.dense_stack_bf16_plain(layers, x)) < 1e-2


# ---------------------------------------------------------------- routing and counters
TINY = dict(block_len=20, enc_num_unit=8, dec_num_unit=8, dec_num_layer=3, batch_size=4)


def _batch(cfg, seed=1):
    g = torch.Generator().manual_seed(seed)
    shape = (cfg.batch_size, cfg.block_len)
    return (torch.rand((*shape, 1), generator=g) < 0.5).float(), torch.randn((*shape, 3),
                                                                             generator=g)


@pytest.mark.parametrize('encoder', ['Turbo_rate3_757', 'TurboAE_rate3_cnn_dense'])
@pytest.mark.parametrize('dtype,fused,routed', [('bfloat16', True, True),
                                                ('bfloat16', False, False),
                                                ('float32', True, False),
                                                ('float32', False, False)])
def test_decoder_routes_dense_stacks(tmp_path, encoder, dtype, fused, routed):
    """DEC_LargeCNN's 12 dense stacks of a batch go through K3's wrapper (a
    `k3` span in each of the decoder's `dense` spans) under use_fused_conv
    in bf16, else through the concatenating path; either way each adds 1 to
    dense_stack_apply.calls, and only the concatenating path adds bytes.
    The dense CNN code's encoder (three dense stacks) never fuses."""
    cfg = Config(encoder=encoder, dtype=dtype, use_fused_conv=fused, **TINY)
    params = init_ae(torch.Generator().manual_seed(0), cfg)
    enc = 3 if encoder.endswith('dense') else 0   # the encoder's three branches
    enc_bytes = enc * cfg.batch_size * cfg.block_len * (2 if dtype == 'bfloat16' else 4) * sum(
        cfg.code_rate_k + i * cfg.enc_num_unit for i in range(1, cfg.enc_num_layer))
    calls, copied = cv.dense_stack_apply.calls, cv.dense_stack_apply.copy_bytes
    k2 = ks.conv_stack_bf16.launches
    with tlog.trace(str(tmp_path)):
        sweep_counts(params, cfg, *_batch(cfg), make_perms(cfg, 'cpu'))
    sp = tlog.spans()
    dec = [i for i, s in enumerate(sp) if s.name == 'dense' and sp[s.parent].name == 'decode.iter']
    k3 = [s for s in sp if s.name == 'k3']
    assert len(dec) == 12 and sum(s.name == 'dense' for s in sp) == 12 + enc
    assert cv.dense_stack_apply.calls - calls == 12 + enc
    assert ks.conv_stack_bf16.launches == k2
    if routed:
        assert len(k3) == 12 and all(s.parent in dec for s in k3)
        assert cv.dense_stack_apply.copy_bytes - copied == enc_bytes
    else:
        assert not k3 and cv.dense_stack_apply.copy_bytes - copied > enc_bytes


@pytest.mark.parametrize('units', [104, 112])
def test_every_bf16_dense_stack_goes_to_the_kernels_wrapper(tmp_path, units):
    """Under the flag in bf16 the decoder routes every dense stack to K3's
    wrapper, also one wider than K3's one width (112 units), which the card
    then refuses (the wrapper's check) and the CPU runs as the plain
    version: 12 `k3` spans a batch and no concatenation; nothing gives way
    to the concatenating path."""
    cfg = Config(encoder='Turbo_rate3_757', dtype='bfloat16', use_fused_conv=True,
                 **dict(TINY, dec_num_unit=units, dec_num_layer=2))
    params = init_ae(torch.Generator().manual_seed(0), cfg)
    copied = cv.dense_stack_apply.copy_bytes
    with tlog.trace(str(tmp_path)):
        sweep_counts(params, cfg, *_batch(cfg), make_perms(cfg, 'cpu'))
    assert sum(s.name == 'k3' for s in tlog.spans()) == 12
    assert cv.dense_stack_apply.copy_bytes == copied
    if units > ks.DENSE_N:
        layers = params['dec']['iters'][0]['dec1_cnn']
        with pytest.raises(ValueError, match='at most 104'):
            ks._check_dense_layers(layers, layers[0]['w'].shape[1])


def test_fused_call_counts_one_call_and_no_bytes():
    layers = _stack(5, 7, 10, 5)
    x = _x(3, 11, 7)
    calls, copied = cv.dense_stack_apply.calls, cv.dense_stack_apply.copy_bytes
    with profile(activities=[ProfilerActivity.CPU]):    # counted with or without spans
        out = cv.dense_stack_apply(layers, x, compute_dtype=torch.bfloat16,
                                   fused=ks.fused_dense_stack_apply_bf16)
    assert out.dtype == torch.bfloat16 and out.shape == (3, 11, 10)
    assert torch.equal(out, ks.dense_stack_bf16_plain(layers, x))
    assert cv.dense_stack_apply.calls - calls == 1
    assert cv.dense_stack_apply.copy_bytes == copied


# ---------------------------------------------------------------- gradient
def test_backward_recomputes_the_unfused_f32_dense_stack():
    """Gradients are those of the f32 dense_stack_apply for the kernel's
    cotangent, exactly; only what asks for a gradient gets one."""
    layers = _stack(3, 7, 16, 5)
    x = _x(3, 12, 7)
    leaves = [t.clone().requires_grad_(True) for p in layers for t in (p['w'], p['b'])]
    lay = [{'w': leaves[2 * i], 'b': leaves[2 * i + 1]} for i in range(3)]
    xt = x.clone().requires_grad_(True)
    out = ks.fused_dense_stack_apply_bf16(lay, xt)
    assert out.dtype == torch.bfloat16
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0)).to(out.dtype)
    got = torch.autograd.grad(out, [xt, *leaves], g)

    x2 = x.clone().requires_grad_(True)
    leaves2 = [t.detach().clone().requires_grad_(True) for t in leaves]
    ref_out = cv.dense_stack_apply([{'w': leaves2[2 * i], 'b': leaves2[2 * i + 1]}
                                    for i in range(3)], x2)
    ref = torch.autograd.grad(ref_out, [x2, *leaves2], g.float())
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    # the weights alone
    frozen = [{'w': leaves[2 * i], 'b': leaves[2 * i + 1].detach()} for i in range(3)]
    out = ks.fused_dense_stack_apply_bf16(frozen, x)
    (gw,) = torch.autograd.grad(out.float().sum(), [leaves[0]])
    assert gw.shape == leaves[0].shape


def test_dense_stack_work_counts():
    flops, nbytes = ks.dense_stack_work(2000, 100, 7, 100, 5, 5)
    n_w = 5 * 100 * (7 + 107 + 207 + 307 + 407)
    assert flops == 2 * 2000 * 100 * n_w == 207000000000
    assert nbytes == (2000 * 100 * 7 + n_w + 2000 * 100 * 100) * 2 + 5 * 100 * 4
    assert np.isclose(flops / 989.4e12 * 1e3, 0.2092, atol=1e-4)
