"""Per-stage wall-time statistics for the runtime loops."""
