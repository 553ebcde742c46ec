"""Frame pipeline and the single-screenshot runtime."""
