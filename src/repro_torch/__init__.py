"""PyTorch/CUDA port of the CLUGP partitioner and vertex-cut GAS engine.

The JAX package ``repro`` is the reference; this package imports nothing
of it and nothing of JAX.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; the four TPU-era hot loops (clustering block
scan, game best response, PageRank gather, transform scan) are
hand-written CUDA kernels under ``csrc/``.
"""
