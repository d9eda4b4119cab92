"""Score normalization and Gumbel statistics."""
