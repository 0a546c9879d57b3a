"""PyTorch/CUDA port of the TinyLFU engine in ``repro``.

The JAX package ``repro`` is the reference.  This package reproduces its
device trace engine and its serving-admission path bit for bit on an
NVIDIA H100, and its LLM serving path (the dense models, ``extend`` and
``ServeEngine``) within float tolerances, with every TPU kernel on those
paths replaced by a hand-written CUDA kernel (``kernels/csrc``: the step
kernel, four sketch kernels and flash attention).  It imports torch and
numpy, never jax and nothing of ``repro``.
"""
