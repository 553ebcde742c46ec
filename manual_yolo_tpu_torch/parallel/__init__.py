"""Tiling and tile merging for batched detection (host numpy)."""
