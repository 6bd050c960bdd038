"""PyTorch/CUDA port of `turboae_tpu` for NVIDIA Hopper.

The JAX package beside it is the reference. This package imports `torch` and
`numpy` only, never `jax`, `flax`, `msgpack` or `turboae_tpu`. Public functions
keep the JAX layout, (B, L, C) channels last.
"""
