"""Container and codec detection, the Ogg page and packet layer, and the
CAF, MP4, WebM (EBML), MPEG-TS and LOAS/LATM demuxers with the
container-only track demuxer over them (host side, no torch)."""
