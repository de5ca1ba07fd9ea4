"""PyTorch/CUDA port of the CLUGP partitioner, the vertex-cut GAS engine
and the dense LM serving stack.

The JAX package ``repro`` is the reference; this package imports nothing
of it and nothing of JAX.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; the TPU-era hot loops (clustering block scan,
game best response, the Gauss–Seidel game sweep, PageRank gather,
transform scan, prefill flash attention) are hand-written CUDA kernels
under ``csrc/``.  The host oracle, the baselines and the theory
quantities stay numpy, as in the reference.
"""
