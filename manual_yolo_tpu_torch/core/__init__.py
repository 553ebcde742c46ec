"""Core helpers: checkpoint reading, weight layout conversion, device choice."""
