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
             bucket dispatch (kernel_search), search_db (search), the
             golden scalar model (golden), load balance (balance)
  parallel/  entry sharding over devices and processes
  eval/      AUC/ROC50 evaluation, gold standards, Gumbel fits, drivers
  build/     PDB -> tableau + distance-matrix DB (``torchsatabsearch-build``)
  tools/     LSOLN SSE maps: parsing, PyMOL and HTML output, top hits
  session.py resident DB + query stream
  cli.py     the ``torchsatabsearch`` command-line program
  graft_entry.py     single-card check and multi-shard dry run
  latency_budget.py  a warm query's self time per span (trace.py)
  trace.py           spans at the search path's layer boundaries
  synthetic.py       seeded synthetic entries and PDB structures
"""

__version__ = "0.1.0"
