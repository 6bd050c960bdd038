"""The port's msgpack reader and writer, param conversion and checkpoints
(train/msgpack_io.py, train/convert.py, train/checkpoint.py), checked against
flax and the JAX package on the CPU."""
import glob
import os

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from turboae_tpu.config import Config as JaxConfig
from turboae_tpu.models.channel_ae import init_ae
from turboae_tpu.train.checkpoint import load_checkpoint
from turboae_tpu.train.trainer import Trainer as JaxTrainer
from turboae_tpu_torch.config import Config as PortConfig
from turboae_tpu_torch.models.channel_ae import init_ae as port_init
from turboae_tpu_torch.train.checkpoint import load_checkpoint as port_load
from turboae_tpu_torch.train.checkpoint import save_checkpoint
from turboae_tpu_torch.train.convert import from_jax, to_jax
from turboae_tpu_torch.train.msgpack_io import (load_msgpack, packb, save_msgpack,
                                                to_state_dict, unpackb)
from turboae_tpu_torch.train.trainer import Trainer
from turboae_tpu_torch.utils.tree import tree_leaves, tree_unflatten

from _torch_parity import CROWN, ROOT, SMALL, configs, small_params


def _flat(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f'{prefix}/{k}'))
        return out
    if isinstance(tree, (list, tuple)):
        return _flat({str(i): v for i, v in enumerate(tree)}, prefix)
    return {prefix: tree}


def _assert_bit_identical(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        if x is None or y is None:
            assert x is None and y is None, k
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def test_reader_matches_flax_on_the_crown():
    with open(CROWN, 'rb') as f:
        ref = serialization.msgpack_restore(f.read())
    got = load_msgpack(CROWN)
    _assert_bit_identical(got, ref)
    paths = _flat(got)
    for b in ('b1', 'b2', 'b3'):
        assert paths[f'/params/enc/{b}/cnn/0/w'].shape == (5, 1, 100)
    assert paths['/params/dec/scan/dec1_cnn/4/w'].shape == (5, 5, 100, 100)
    assert paths['/params/dec/final/dec2_lin/w'].shape == (100, 1)


def test_reader_decodes_every_msgpack_type():
    obj = {'ints': [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1,
                    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
           'floats': [0.5, -1e300], 'none': None, 'bools': [True, False],
           'strs': ['', 'a' * 31, 'b' * 32, 'c' * 256, 'd' * 65536],
           'bins': [b'', b'x' * 256, b'y' * 65536],
           'long_list': list(range(20)), 'long_map': {str(i): i for i in range(20)}}
    assert unpackb(msgpack.packb(obj, use_bin_type=True)) == obj
    assert unpackb(msgpack.packb(1.25, use_single_float=True)) == 1.25
    assert unpackb(msgpack.packb(list(range(70000)))) == list(range(70000))


def test_reader_decodes_flax_arrays():
    rng = np.random.RandomState(0)
    tree = {'f32': rng.standard_normal((3, 4)).astype(np.float32),
            'f64': rng.standard_normal(5), 'i32': np.arange(6, dtype=np.int32).reshape(2, 3),
            'u8': np.arange(4, dtype=np.uint8), 'bool': np.array([True, False]),
            'empty': np.zeros((0, 3), np.float32), 'scalar_array': np.asarray(2.5, np.float32),
            'step': 7, 'nested': [{'w': np.ones(2, np.float16)}]}
    blob = serialization.msgpack_serialize(tree)
    _assert_bit_identical(unpackb(blob), serialization.msgpack_restore(blob))


def test_round_trip_is_bit_exact_small():
    jcfg, _ = configs(**SMALL)
    jp, tp = small_params(jcfg)
    _assert_bit_identical(to_jax(tp), jp)
    it = tp['dec']['iters'][0]
    assert it['dec1_cnn'][0]['w'].shape == (12, 7, 5)      # (Cout, Cin, K)
    assert it['dec1_lin']['w'].shape == (5, 12)            # (out, in)
    assert tp['dec']['iters'][-1]['dec2_lin']['w'].shape == (1, 12)


def test_round_trip_is_bit_exact_one_iteration():
    jcfg, _ = configs(**dict(SMALL, num_iteration=1))
    jp, tp = small_params(jcfg)
    assert len(tp['dec']['iters']) == 1
    _assert_bit_identical(to_jax(tp), jp)


def test_round_trip_is_bit_exact_crown():
    template = init_ae(jax.random.PRNGKey(0), JaxConfig())
    stats = {}
    jp = jax.tree.map(np.asarray, load_checkpoint(CROWN, template, stats=stats))
    assert stats['kept'] == 0
    tp = from_jax(load_msgpack(CROWN)['params'])
    assert len(tp['dec']['iters']) == 6
    _assert_bit_identical(to_jax(tp), jp)


# ---------------------------------------------------------------- the writer
ARTIFACTS = sorted(glob.glob(os.path.join(ROOT, 'artifacts', '*.msgpack')))


def test_writer_encodes_every_type_as_msgpack_does():
    obj = {'ints': [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1, 2**64 - 1,
                    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
           'floats': [0.5, -1e300], 'none': None, 'bools': [True, False],
           'strs': ['', 'a' * 31, 'b' * 32, 'c' * 256, 'd' * 65536],
           'bins': [b'', b'x' * 256, b'y' * 65536],
           'long_list': list(range(20)), 'long_map': {str(i): i for i in range(20)},
           'big_list': list(range(70000))}
    blob = packb(obj)
    assert blob == msgpack.packb(obj, use_bin_type=True)
    assert unpackb(blob) == obj


def test_writer_bytes_equal_flax():
    """Arrays of every dtype flax writes, 0-d arrays, lists (stored as dicts
    keyed '0', '1', ..., sorted as strings) and an empty state: the
    writer's file is flax's, byte for byte."""
    rng = np.random.RandomState(0)
    tree = {'w': rng.standard_normal((3, 4)).astype(np.float32), 'count': np.asarray(7, np.int32),
            'f64': rng.standard_normal(5), 'u8': np.arange(4, dtype=np.uint8),
            'b': np.array([True, False]), 'empty': np.zeros((0, 3), np.float32),
            'step': 12, 'layers': [np.ones(2, np.float16)] * 12,
            'opt': ({'mu': np.zeros(2, np.float32)}, {})}
    blob = packb(to_state_dict(tree))
    assert blob == serialization.msgpack_serialize(serialization.to_state_dict(tree))
    _assert_bit_identical(unpackb(blob), serialization.msgpack_restore(blob))


def test_save_is_atomic(tmp_path, monkeypatch):
    path = tmp_path / 'c.msgpack'
    save_msgpack(str(path), {'a': 1})
    monkeypatch.setattr('turboae_tpu_torch.train.msgpack_io.packb',
                        lambda obj: (_ for _ in ()).throw(RuntimeError('disk full')))
    with pytest.raises(RuntimeError):
        save_msgpack(str(path), {'a': 2})
    assert load_msgpack(str(path)) == {'a': 1} and not (tmp_path / 'c.msgpack.tmp').exists()


@pytest.fixture(scope='module')
def port_trainer():
    """A full-width port Trainer from the crown with one encoder and two
    decoder steps of Adam (batch 2), so its optimizer state is not zero."""
    tr = Trainer(PortConfig(batch_size=2), 'cpu', params=from_jax(load_msgpack(CROWN)['params']))
    tr._train_step('encoder')
    tr._train_step('decoder')
    tr._train_step('decoder')
    return tr


def test_port_checkpoint_restores_in_flax_bit_for_bit(port_trainer, tmp_path):
    tr = port_trainer
    path = str(tmp_path / 'port.msgpack')
    save_checkpoint(path, tr.params, tr.opt_state, step=3)
    with open(path, 'rb') as f:
        got = serialization.msgpack_restore(f.read())
    assert set(got) == {'params', 'step', 'opt_state'} and got['step'] == 3
    _assert_bit_identical(got['params'], to_jax(tr.params))
    for h, count in (('enc', 1), ('dec', 2)):
        inner = got['opt_state'][h]
        assert inner['1'] == {} and set(inner['0']) == {'count', 'mu', 'nu'}
        c = inner['0']['count']
        assert c.dtype == np.int32 and c.shape == () and int(c) == count
        for k in ('mu', 'nu'):
            ref = to_jax({**tr.params, h: tree_unflatten(tr.params[h], tr.opt[h].state()[k])})[h]
            _assert_bit_identical(inner['0'][k], ref)
    assert np.abs(got['opt_state']['dec']['0']['nu']['final']['dec2_lin']['w']).max() > 0


def test_jax_loads_a_port_checkpoint(port_trainer, tmp_path):
    """JAX's load_checkpoint(path, params, opt_state) restores the port's
    file into optax's state and returns its step."""
    tr = port_trainer
    path = str(tmp_path / 'port.msgpack')
    save_checkpoint(path, tr.params, tr.opt_state, step=41)
    jt = JaxTrainer(JaxConfig())
    stats = {}
    params, opt, step = load_checkpoint(path, jt.params, jt.opt_state, stats=stats)
    assert step == 41 and stats == {'merged': 66, 'kept': 0}
    assert int(opt['enc'][0].count) == 1 and int(opt['dec'][0].count) == 2
    _assert_bit_identical(jax.tree.map(np.asarray, params), to_jax(tr.params))
    ref_mu = to_jax({**tr.params, 'dec': tree_unflatten(tr.params['dec'], tr.opt['dec'].mu)})['dec']
    for a, b in zip(jax.tree.leaves(opt['dec'][0].mu), jax.tree.leaves(ref_mu)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_port_reload_round_trips_params_and_adam(port_trainer, tmp_path):
    tr = port_trainer
    path = str(tmp_path / 'port.msgpack')
    save_checkpoint(path, tr.params, tr.opt_state, step=5)
    fresh = Trainer(PortConfig(batch_size=2), 'cpu')
    fresh.params, fresh.opt_state, step = port_load(path, fresh.params, fresh.opt_state)
    assert step == 5
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(fresh.params), tree_leaves(tr.params)))
    for h in ('enc', 'dec'):
        got, ref = fresh.opt[h].state(), tr.opt[h].state()
        assert got['count'] == ref['count']
        assert all(torch.equal(a, b) for k in ('mu', 'nu') for a, b in zip(got[k], ref[k]))
        # the optimizer still steps the trainer's own params
        assert fresh.opt[h].params[0] is tree_leaves(fresh.params[h])[0]


def test_tolerant_load_counts_equal_jax_on_a_drifted_template():
    """A 2-iteration template against the 6-iteration crown: the encoder and
    the final iteration merge, the stacked scan iterations (1 against 5) are
    kept, in the same counts as JAX's load."""
    jcfg, tcfg = configs(num_iteration=2)
    jstats, tstats = {}, {}
    jp = load_checkpoint(CROWN, init_ae(jax.random.PRNGKey(0), jcfg), stats=jstats)
    tp = port_init(torch.Generator().manual_seed(0), tcfg)
    got = port_load(CROWN, tp, stats=tstats)
    assert tstats == jstats and jstats['kept'] > 0 and jstats['merged'] > 0
    _assert_bit_identical(to_jax(got)['enc'], jax.tree.map(np.asarray, jp['enc']))
    _assert_bit_identical(to_jax(got)['dec']['final'], jax.tree.map(np.asarray, jp['dec']['final']))
    # kept leaves stay the template's
    assert torch.equal(got['dec']['iters'][0]['dec1_lin']['w'], tp['dec']['iters'][0]['dec1_lin']['w'])


def test_tolerant_load_counts_only_arrays_on_a_one_iteration_template():
    """A 1-iteration template has no scan iterations (None leaves in the JAX
    layout). The port counts the 42 leaves it merges; JAX's load reports 46
    there, because its shape test matches a None template leaf against a
    saved dict (np.shape of both is ()) before its try/except keeps the
    template (turboae_tpu/train/checkpoint.py:70-76)."""
    _, tcfg = configs(num_iteration=1)
    tp = port_init(torch.Generator().manual_seed(0), tcfg)
    stats = {}
    got = port_load(CROWN, tp, stats=stats)
    assert stats == {'merged': len(tree_leaves(tp)), 'kept': 0} == {'merged': 42, 'kept': 0}
    assert len(got['dec']['iters']) == 1


@pytest.mark.parametrize('path', ARTIFACTS, ids=os.path.basename)
def test_every_committed_checkpoint_loads(path):
    """All 13 committed files read; the flagship-architecture ones load
    whole into the port's flagship, with their Adam state and epoch."""
    tree = load_msgpack(path)
    assert 'params' in tree and 'step' in tree
    if not os.path.basename(path).startswith('flagship'):
        return
    tr = Trainer(PortConfig(batch_size=2), 'cpu')
    stats = {}
    loaded = port_load(path, tr.params, tr.opt_state, stats=stats)
    assert stats == {'merged': 66, 'kept': 0}
    if 'opt_state' not in tree:
        assert not isinstance(loaded, tuple)
        return
    params, opt, step = loaded
    assert step == tree['step'] > 0
    for h in ('enc', 'dec'):
        assert opt[h]['count'] == int(tree['opt_state'][h]['0']['count']) > 0
        assert all(bool((v >= 0).all()) for v in opt[h]['nu'])


def test_sgd_state_round_trips_with_optax(tmp_path):
    """-optimizer sgd: the momentum trace is written in optax's layout
    ({'0': {'trace'}, '1': {}}), which JAX's load takes, and read back."""
    jcfg, tcfg = configs(**SMALL, optimizer='sgd', batch_size=4)
    _, tp = small_params(jcfg)
    tr = Trainer(tcfg, 'cpu', params=tp)
    tr._train_step('joint')
    path = str(tmp_path / 'sgd.msgpack')
    save_checkpoint(path, tr.params, tr.opt_state, step=1)
    jt = JaxTrainer(jcfg)
    _, opt, step = load_checkpoint(path, jt.params, jt.opt_state)
    assert step == 1
    for h in ('enc', 'dec'):
        ref = to_jax({**tr.params, h: tree_unflatten(tr.params[h], tr.opt[h].trace)})[h]
        _assert_bit_identical(jax.tree.map(np.asarray, opt[h][0].trace), ref)
    fresh = Trainer(tcfg, 'cpu')
    fresh.params, fresh.opt_state, _ = port_load(path, fresh.params, fresh.opt_state)
    assert all(torch.equal(a, b) for a, b in zip(fresh.opt['dec'].trace, tr.opt['dec'].trace))
