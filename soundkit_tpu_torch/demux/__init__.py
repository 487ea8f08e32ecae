"""Container and codec detection, the Ogg page and packet layer, and the
CAF and MP4 demuxers (host side, no torch)."""
