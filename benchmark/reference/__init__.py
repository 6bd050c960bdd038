"""The plain reference of the benchmark: TurboAE's CNN flagship in plain
PyTorch (f32, TF32 off), written from the published description and
independent of the package under test. It imports nothing of that package
and takes nothing it made: it reads checkpoints with its own msgpack reader
(`msgpack.py`), converts them itself (`convert.py`) and draws its
interleaver from numpy's MT19937 (`model.perms`)."""
