"""PyTorch + CUDA port of EMIP: the short-term and the long-term model,
inference and training.

A second package beside :mod:`emip_tpu` (the JAX reference, which stays
as it is). Plain tensor code is PyTorch; every Pallas TPU kernel on the
ported path is a hand-written CUDA kernel for Hopper (``csrc/``), bound
through ``ctypes`` by :mod:`emip_tpu_torch.kernels`. The package imports
``torch`` and never ``jax`` or ``flax``.
"""
