"""Apple Lossless host decoder (from-scratch, native/src/alac.cpp).

Role-equivalent of the reference's `alac` crate wrapper
(soundkit-alac/src/lib.rs:11-49); packet decode is owned here instead
of delegated to avcodec.  Bit-exact vs golden/alac (M4A and CAF).

Port: the decoder loads the port's build of ``native_src/src/alac.cpp``
(``native.alac_library``); the rest is the JAX package's code.
"""
from __future__ import annotations

from typing import List

import numpy as np

from soundkit_tpu_torch.native import alac_library


class AlacError(ValueError):
    pass


class AlacPacketDecoder:
    """Decode raw ALAC packets given the magic cookie (from the MP4
    stsd 'alac' box or the CAF kuki chunk; atom-wrapped forms OK)."""

    def __init__(self, cookie: bytes):
        self._lib = alac_library()
        self._h = self._lib.skt_alac_new(bytes(cookie), len(cookie))
        if not self._h:
            raise AlacError("bad ALAC magic cookie")
        self.channels = self._lib.skt_alac_channels(self._h)
        self.sample_rate = self._lib.skt_alac_sample_rate(self._h)
        self.bits_per_sample = self._lib.skt_alac_sample_size(self._h)
        self.frame_length = self._lib.skt_alac_frame_length(self._h)
        self._out = np.zeros(self.frame_length * self.channels, dtype=np.int32)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.skt_alac_free(self._h)
            self._h = None

    def decode_packet(self, pkt: bytes) -> np.ndarray:
        """One packet -> interleaved int32 [frames*channels] (low
        ``bits_per_sample`` bits significant)."""
        n = self._lib.skt_alac_decode(self._h, bytes(pkt), len(pkt), self._out)
        if n < 0:
            raise AlacError(self._lib.skt_alac_error(self._h).decode())
        return self._out[: n * self.channels].copy()

    def decode_packets_i16(self, packets: List[bytes]) -> np.ndarray:
        """Decode packets to int16 (16-bit streams pass through;
        deeper streams shift down like the pipeline's i16 output)."""
        outs = [self.decode_packet(p) for p in packets]
        pcm = np.concatenate(outs) if outs else np.zeros(0, np.int32)
        shift = self.bits_per_sample - 16
        if shift > 0:
            pcm = pcm >> shift
        return pcm.astype(np.int16)
