"""Game taxonomy, text rules and result schemas (host-only copies)."""
