"""The wrappers' cache of packed weights (kernels/conv_stack.py:packed), on
CPU tensors through the function `_prepared` calls: in inference mode and
outside a capture it packs a stack once, and packs anew after any write
to a weight, for other weights or another pack layout; elsewhere it keeps
and looks up nothing."""
import dataclasses
import gc

import pytest
import torch

from turboae_tpu_torch.kernels import conv_stack as ks

# (wrapper, its layout, its packer, whether its stack is dense)
KERNELS = {'K2': (ks.conv_stack_bf16, ks.k2_layout, ks.pack_weights_bf16, False),
           'K1': (ks.conv_stack_f32, ks.k1_layout, ks.pack_weights, False),
           'K3': (ks.dense_stack_bf16, ks.dense_layout, ks.pack_dense_bf16, True)}


@pytest.fixture(autouse=True)
def empty_cache():
    ks.clear_packs()
    yield
    ks.clear_packs()


def _layers(nl=3, cin=7, c=10, k=5, seed=0, dense=False):
    g = torch.Generator().manual_seed(seed)
    return [{'w': torch.randn((c, cin + i * c if dense else cin if i == 0 else c, k), generator=g),
             'b': torch.randn((c,), generator=g)} for i in range(nl)]


def _plan(layout, layers, L=20):
    C, Cin, K = layers[0]['w'].shape
    return layout(L, Cin, C, K, len(layers), 1)


def _equal(got, want):
    return all((a is None and b is None) or (a.dtype == b.dtype and torch.equal(a, b))
               for a, b in zip(got, want))


def _counts(wrapper):
    return wrapper.pack_hits, wrapper.pack_misses


@pytest.mark.parametrize('kernel', KERNELS)
def test_a_hit_returns_a_fresh_pack(kernel):
    wrapper, layout, pack, dense = KERNELS[kernel]
    layers = _layers(dense=dense)
    plan = _plan(layout, layers)
    h, m = _counts(wrapper)
    with torch.inference_mode():
        first = ks.packed(wrapper, layers, plan)
        second = ks.packed(wrapper, layers, plan)
    assert _counts(wrapper) == (h + 1, m + 1)
    assert all(a is b for a, b in zip(first, second))
    assert _equal(second, pack(layers, plan))
    assert len(ks._packs) == 1


@pytest.mark.parametrize('change', ['write', 'equal_copy', 'width', 'groups', 'layers'])
@pytest.mark.parametrize('kernel', KERNELS)
def test_a_change_misses_and_repacks(kernel, change):
    """An in-place write under no_grad (an optimizer's), new tensors of
    equal values, another wgmma width or column groups (K3: another channel
    layout), fewer layers: each misses, and the pack it returns is the fresh
    one."""
    wrapper, layout, pack, dense = KERNELS[kernel]
    layers = _layers(dense=dense)
    plan = _plan(layout, layers)
    with torch.inference_mode():
        ks.packed(wrapper, layers, plan)
    if change == 'write':
        with torch.no_grad():
            layers[1]['w'].add_(0.5)
    elif change == 'equal_copy':
        layers = [{k: t.clone() for k, t in p.items()} for p in layers]
    elif change == 'width':
        plan = dataclasses.replace(plan, N=128)
    elif change == 'groups':
        plan = dataclasses.replace(plan, **{'Cinp': plan.Cinp + 2} if dense else {'ngroups': 2})
    else:
        layers = layers[:2]
        plan = _plan(layout, layers)
    h, m = _counts(wrapper)
    with torch.inference_mode():
        got = ks.packed(wrapper, layers, plan)
    assert _counts(wrapper) == (h, m + 1)
    assert _equal(got, pack(layers, plan))


@pytest.mark.parametrize('kernel', KERNELS)
def test_another_length_shares_the_entry(kernel):
    """Windows and halo windows of other lengths (other R, G, P, rows) pack
    the same: the key holds only the pack's own plan fields."""
    wrapper, layout, pack, dense = KERNELS[kernel]
    layers = _layers(dense=dense)
    short, long_ = _plan(layout, layers, L=20), _plan(layout, layers, L=37)
    assert short != long_
    with torch.inference_mode():
        ks.packed(wrapper, layers, short)
        h, m = _counts(wrapper)
        got = ks.packed(wrapper, layers, long_)
    assert _counts(wrapper) == (h + 1, m)
    assert _equal(got, pack(layers, long_))


@pytest.mark.parametrize('mode', ['grad', 'no_grad', 'capture', 'inference_tensors'])
@pytest.mark.parametrize('kernel', KERNELS)
def test_no_lookup_or_store_where_it_must_not_serve(kernel, mode, monkeypatch):
    """Grad mode and no_grad (a caller that may train), a CUDA graph's
    capture in inference mode, and weights made in inference mode (no
    version to key on): every call packs, none is counted or kept."""
    wrapper, layout, pack, dense = KERNELS[kernel]
    if mode == 'capture':
        monkeypatch.setattr(torch.backends.cuda, 'is_built', lambda: True)
        monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing', lambda: True)
    if mode == 'inference_tensors':
        with torch.inference_mode():
            layers = _layers(dense=dense)
    else:
        layers = _layers(dense=dense)
    plan = _plan(layout, layers)
    h, m = _counts(wrapper)
    for _ in range(2):
        if mode == 'grad':
            got = ks.packed(wrapper, layers, plan)
        elif mode == 'no_grad':
            with torch.no_grad():
                got = ks.packed(wrapper, layers, plan)
        else:
            with torch.inference_mode():
                got = ks.packed(wrapper, layers, plan)
        assert _equal(got, pack(layers, plan))
    assert _counts(wrapper) == (h, m)
    assert len(ks._packs) == 0


def test_clear_packs_empties_the_cache():
    stacks = {name: _layers(dense=k[3]) for name, k in KERNELS.items()}   # alive: entries stay
    with torch.inference_mode():
        for name, (wrapper, layout, _, _) in KERNELS.items():
            ks.packed(wrapper, stacks[name], _plan(layout, stacks[name]))
    assert len(ks._packs) == 3
    ks.clear_packs()
    assert len(ks._packs) == 0
    layers = _layers()
    h, m = _counts(ks.conv_stack_bf16)
    with torch.inference_mode():
        ks.packed(ks.conv_stack_bf16, layers, _plan(ks.k2_layout, layers))
    assert _counts(ks.conv_stack_bf16) == (h, m + 1)


@pytest.mark.parametrize('kernel', KERNELS)
def test_a_freed_weight_leaves_no_entry(kernel):
    wrapper, layout, _, dense = KERNELS[kernel]
    layers = _layers(dense=dense)
    plan = _plan(layout, layers)
    with torch.inference_mode():
        ks.packed(wrapper, layers, plan)
    assert len(ks._packs) == 1
    del layers[0]['w']
    gc.collect()
    assert len(ks._packs) == 0


def test_the_bound_evicts_the_least_recently_used(monkeypatch):
    monkeypatch.setattr(ks, 'PACKS_HELD', 3)
    stacks = [_layers(seed=i) for i in range(4)]
    plan = _plan(ks.k2_layout, stacks[0])
    wrapper = ks.conv_stack_bf16
    with torch.inference_mode():
        for layers in stacks[:3]:
            ks.packed(wrapper, layers, plan)
        ks.packed(wrapper, stacks[0], plan)      # the first is used again
        ks.packed(wrapper, stacks[3], plan)      # and the second goes
        assert len(ks._packs) == 3
        h, m = _counts(wrapper)
        for layers in (stacks[0], stacks[2], stacks[3]):
            ks.packed(wrapper, layers, plan)
        assert _counts(wrapper) == (h + 3, m)
        ks.packed(wrapper, stacks[1], plan)
        assert _counts(wrapper) == (h + 3, m + 1)
