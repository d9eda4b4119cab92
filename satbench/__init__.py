"""The benchmark of cuda_satabsearch_tpu_torch, the SA tableau search on
one NVIDIA H100.

Run from the root of a checkout:

    python3 -m satbench.run --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

A cell of BENCHMARK.json is ``<config>.<traffic>``: a deployment
(``configs/<config>.json``: its DB, restarts and guarantees) under a
traffic mix (``traffic/<traffic>.json``, read by the one generator in
``gen.py``).  Each metric is read by ``metrics/<metric>.py``; the
limits of the correctness check are in ``checks/``.  Adding a cell, a
mix or a metric adds files and edits none.

Nothing here imports jax or the JAX package; the reference that decides
``correct`` (``reference/``) imports nothing of the program either.
"""
