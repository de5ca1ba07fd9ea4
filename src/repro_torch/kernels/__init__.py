"""Hand-written CUDA kernels of the port (``csrc/``) with their plain
PyTorch versions; see ``ops``."""
