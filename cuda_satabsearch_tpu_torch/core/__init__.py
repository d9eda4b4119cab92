"""Algorithm constants and code tables (copies of the JAX package's)."""
