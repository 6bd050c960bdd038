"""The port's msgpack reader and param conversion (train/msgpack_io.py,
train/convert.py), checked against flax and the JAX package on the CPU."""
import jax
import msgpack
import numpy as np
from flax import serialization

from turboae_tpu.config import Config as JaxConfig
from turboae_tpu.models.channel_ae import init_ae
from turboae_tpu.train.checkpoint import load_checkpoint
from turboae_tpu_torch.train.convert import from_jax, to_jax
from turboae_tpu_torch.train.msgpack_io import load_msgpack, unpackb

from _torch_parity import CROWN, SMALL, configs, small_params


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
