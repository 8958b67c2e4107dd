"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Nothing here builds or loads a kernel at import time: ``build.load`` runs at
the first launch on a CUDA tensor.
"""
