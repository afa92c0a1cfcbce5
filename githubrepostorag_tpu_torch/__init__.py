"""PyTorch/CUDA port of the githubrepostorag_tpu serving path.

The JAX package ``githubrepostorag_tpu`` is the reference; this package is
its port to PyTorch on an NVIDIA H100.  It imports ``torch`` and never
``jax`` or the JAX package.  Module names follow the JAX package so a
reader can find each counterpart.  Every Pallas TPU kernel on the ported
path is a CUDA kernel written by hand for Hopper (``csrc/``), built at
first use and bound through ``ctypes`` (``kernels.py``); each sits beside
a plain PyTorch version of the same function.

Entry points (``Engine``, ``AsyncEngine``, ``forward_paged``, the kernel
wrappers) run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
