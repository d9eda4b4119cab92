"""Evaluation: AUC/ROC50 tables, gold standards, Gumbel fits, parity.

Copies of the JAX package's eval/ modules (that package imports jax),
plus the three drivers that search on the card: ``acceptance_eval``,
``make_eval_artifact`` and ``gumbel_fit_artifact``.  Nothing here
imports scipy or matplotlib until it is used.
"""

from .gumbelfit import fit_from_slrtab, fit_gumbel  # noqa: F401
from .results import (iter_multiquery, parse_searchresult,  # noqa: F401
                      write_slrtab)
from .roc import auc, compute_auc, roc_curve, roc_n  # noqa: F401
