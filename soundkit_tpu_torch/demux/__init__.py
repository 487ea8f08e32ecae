"""Container and codec detection (host side, no torch)."""
