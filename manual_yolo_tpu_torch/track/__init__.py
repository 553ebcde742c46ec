"""Host-side multi-object trackers (copies of the JAX package's, numpy and scipy)."""
