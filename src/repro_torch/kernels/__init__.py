"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their ctypes
wrappers, their plain PyTorch versions, and the dispatch in :mod:`.ops`."""
