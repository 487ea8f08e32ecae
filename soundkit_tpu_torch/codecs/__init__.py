"""Codecs of the port: the host pieces copied from the JAX package (ADTS
framing and the AAC-LC host decoder, the AAC wire packers, the G.726 code
packing, the MP3, CELT, SILK and Vorbis parse bindings, the Opus TOC
parse, OpusHead, Ogg Opus demuxer, RFC 6716 tables and CELT IMDCT basis,
the FLAC frame encoder) and the streaming codecs of the pipeline (G.711,
G.722, G.726 and MP3 over their kernels; FLAC, AAC-ADTS, Opus, Vorbis,
GSM, AC-3, Speex, ALAC and AIFF on the host, AIFF-C's G.711 through K3)."""
