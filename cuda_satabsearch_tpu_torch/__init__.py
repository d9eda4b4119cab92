"""SA Tableau Search on PyTorch and CUDA (NVIDIA Hopper).

The port of ``cuda_satabsearch_tpu`` (JAX on a TPU) to PyTorch with a
hand-written CUDA kernel for the SA search.  It imports torch and
numpy, never jax and never the JAX package; the jax-free modules it
needs (``core/``, ``io/``, ``stats/``) are carried as copies, because
importing any submodule of the JAX package imports jax.

Package layout (module names mirror the JAX package):
  core/      constants and code tables
  io/        ASCII parsing and size-bucket packing
  stats/     norm2 / Gumbel z-score / p-value
  ops/       threefry uniform stream (rng), plain PyTorch engine
             (engine), the CUDA kernel's wrapper (sa_kernel, csrc/),
             bucket dispatch (kernel_search) and search_db (search)
  session.py resident DB + query stream
  cli.py     the ``torchsatabsearch`` command-line program
"""

__version__ = "0.1.0"
