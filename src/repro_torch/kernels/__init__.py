"""Hand-written Hopper kernels, each beside its plain PyTorch version.

``<name>/ref.py`` holds the plain version, ``<name>/ops.py`` the public
wrapper (plain version for CPU tensors, the CUDA kernel for CUDA tensors,
never a fallback between them), ``<name>/csrc/`` the CUDA source.
"""
