"""Hand-written Hopper kernels, each beside its plain PyTorch version.

``kernels/<name>/ref.py`` is the plain version, ``kernel.py`` the ctypes
binding of ``csrc/<source>.cu`` and ``ops.py`` the dispatch: the plain
version for a CPU tensor, the kernel for a CUDA tensor (or an error).
"""
