"""The benchmark's plain references, one module an architecture, written from
the published descriptions in plain PyTorch (f32, TF32 off, or fp8 for the
control) and independent of the package under test. A configuration's file
names its module (`"reference": "turboae_cnn"` for TurboAE's CNN flagship);
each module gives `load`, `perms`, `encode`, `decode` and `forward_flops`
(README.md, "Adding a configuration"). They import nothing of that package
and take nothing it made: each reads checkpoints with the msgpack reader
here (`msgpack.py`) and converts them itself; `common.py` holds what they
share (TF32 off, the fp8 rounding, numpy's MT19937 interleaver)."""
