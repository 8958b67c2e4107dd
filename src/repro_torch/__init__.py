"""repro_torch: the PyTorch and CUDA port of the embed-and-conquer system.

It sits beside the JAX package ``repro``, which stays the reference, and
imports neither it nor ``jax``. Hand-written Hopper kernels live in
``repro_torch.kernels``; the public estimator is ``repro_torch.api.KernelKMeans``.
"""
