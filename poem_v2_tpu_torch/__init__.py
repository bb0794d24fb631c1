"""PyTorch + CUDA port of the POEM-v2 multi-view hand mesh system.

The JAX package ``poem_v2_tpu`` is the reference; this package mirrors its
tree (``geometry/``, ``ops/``, ``models/``, ``serving/``, ``mano/``) and
imports nothing of JAX. Every Pallas TPU kernel on the ported path has a
hand-written CUDA kernel under ``csrc/`` (built with ``nvcc`` for sm_90a at
first use) beside a plain PyTorch version of the same function: CPU tensors
take the plain version, CUDA tensors the kernel.
"""
