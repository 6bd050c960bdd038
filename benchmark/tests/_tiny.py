"""Small cells for the CPU tests: the committed cells' configurations and
traffic at sizes the CPU runs, with the committed limits."""
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import main as M  # noqa: E402

NARROW = dict(block_len=8, enc_num_unit=6, dec_num_unit=6, dec_num_layer=2, num_iteration=2)


def write_checkpoint(path, a, seed=3):
    """A seeded init of the port at arch `a`, written as a flax checkpoint."""
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.models.channel_ae import init_ae
    from turboae_tpu_torch.train.convert import to_jax
    from turboae_tpu_torch.train.msgpack_io import packb
    cfg = Config(**{k: v for k, v in a.items() if k in Config.__dataclass_fields__})
    params = init_ae(torch.Generator().manual_seed(seed), cfg)
    Path(path).write_bytes(packb({'params': to_jax(params)}))
    return params


def _point(c, batch, batches, snr_db=None):
    """One SNR point of `batches` batches, all of them checked."""
    c['traffic'].update(batch_size=batch, blocks_per_point=batch * batches)
    if snr_db is not None:
        c['traffic'].update(snr_db=[snr_db, snr_db], snr_points=1)
    c['options'] = {'check_batches': batches, 'reference_positions': 64 * c['arch']['block_len']}
    return c


def sound_cell(name, tmp_path):
    """The committed cell `name` on a seeded init at narrow widths (25 units,
    blocks of 8), at its first SNR point, six batches of 256. On the CPU the
    trained checkpoints, at batches small enough to run there, flip 1-5 % of
    their errors against the reference (f32 alike; iterative decoding near
    the threshold), above the limits set at the cell's size on the card;
    this init's decisions sit far from the threshold (bit_l1 0 to 0.0005)."""
    c = M.load_cell(name)
    c['arch'] = dict(c['arch'], **dict(NARROW, enc_num_unit=25, dec_num_unit=25),
                     checkpoint=str(Path(tmp_path) / 'tiny.msgpack'))
    write_checkpoint(c['arch']['checkpoint'], c['arch'])
    return _point(c, 256, 6)


def fault_cell(name, snr_db):
    """The committed cell `name` on its own checkpoint at blocks of 100, two
    batches of 50 at one SNR: a fault that leaves blocks out shows where
    there are many errors to count (-1.5 dB), one that alters an answer
    where there are none (4 dB)."""
    c = M.load_cell(name)
    c['arch'] = dict(c['arch'], block_len=100)
    return _point(c, 50, 2, snr_db)


def run(c, seconds=0.5, seed=3000000019, trace=0):
    """One run of cell dict `c` on the CPU; the result line as a dict."""
    args = M.parse(['--workload', c['name'], '--seed', str(seed), '--seconds', str(seconds),
                    '--trace', str(trace)])
    import io
    from contextlib import redirect_stdout
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = M.run(args, c, 0.0, device=torch.device('cpu'))
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
