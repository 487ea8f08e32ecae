"""Host-side codec pieces the port needs: ADTS framing, the AAC wire
packers, the G.726 code packing, the MP3 and CELT parse bindings, and
the Opus TOC parse, OpusHead, Ogg Opus demuxer, RFC 6716 tables and CELT
IMDCT basis (numpy, no torch)."""
