"""Ranking-parity evaluation (copies of the JAX package's roc and acceptance)."""
