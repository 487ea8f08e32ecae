"""Container and codec detection, and the Ogg page and packet layer
(host side, no torch)."""
