"""PyTorch/CUDA port of the TinyLFU engine in ``repro``.

The JAX package ``repro`` is the reference; this package reproduces its
device trace engine bit for bit on an NVIDIA H100, with every TPU kernel on
its path replaced by a hand-written CUDA kernel (``kernels/csrc``).  It
imports torch and numpy, never jax and nothing of ``repro``.
"""
