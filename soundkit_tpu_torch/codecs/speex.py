"""Ogg Speex decoder.

API equivalent of the reference's oxideav-speex ``SpeexDecoder``
(soundkit-speex/src/lib.rs): own Ogg parsing, Speex header parse at
fixed offsets (rate@36, mode@40, channels@48, frames/packet@64 —
lib.rs:29-54), then per-packet decode.

All modes decode OWNED (codecs/speex_core.py): narrowband (mode 0,
CELP core), wideband (mode 1, + SB-CELP high band with QMF synthesis)
and ultra-wideband (mode 2, a second fold-only SB layer at 32 kHz) —
mono and stereo.  Stereo streams reconstruct L/R from the in-band
intensity-stereo requests (SpeexStereoState, stereo.c semantics,
oracle-matched); the reference only channel-duplicates mono here
(soundkit-speex/src/lib.rs:326-333).

Port: a header outside the owned modes (a mode outside 0-2, or more
than two channels), which the JAX package hands to libavcodec, raises
``UnsupportedFormat``; the rest is the JAX package's code.
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from soundkit_tpu_torch.codecs.avdec import f32_to_i16
from soundkit_tpu_torch.demux.ogg import OggPacketizer
from soundkit_tpu_torch.pipeline.output_options import UnsupportedFormat


class SpeexDecoder:
    def __init__(self) -> None:
        self._pkts = OggPacketizer()
        self._dec = None        # SpeexNbDecoder (owned path)
        self._stereo = None     # SpeexStereoState for 2-channel streams
        self._av = None  # the JAX package's libavcodec decoder; never set in the port
        self._primed = False
        self._skip_comment = False
        self.sample_rate: Optional[int] = None
        self.channels: Optional[int] = None
        self.mode: Optional[int] = None
        self.frames_per_packet: Optional[int] = None

    def _init_decoder(self, header: bytes) -> None:
        if self.mode in (0, 1, 2) and self.channels in (1, 2):
            from soundkit_tpu_torch.codecs.speex_core import (
                SpeexNbDecoder,
                SpeexSbDecoder,
                SpeexStereoState,
            )

            if self.mode == 0:
                self._dec = SpeexNbDecoder()
            else:
                self._dec = SpeexSbDecoder(uwb=self.mode == 2)
            if self.channels == 2:
                # in-band intensity stereo: the innermost NB layer
                # parses the requests, the stream layer expands L/R
                self._stereo = SpeexStereoState()
                nb = self._dec
                while not isinstance(nb, SpeexNbDecoder):
                    nb = nb.nb
                nb.stereo = self._stereo
        else:
            raise UnsupportedFormat(
                f"Unsupported format: Speex mode {self.mode} with {self.channels} channels "
                "decodes only through libavcodec, which the port does not build")

    def decode_f32(self, data: bytes) -> np.ndarray:
        out = []
        for packet, _g in self._pkts.push(data):
            if not self._primed:
                if len(packet) < 80 or packet[:8] != b"Speex   ":
                    raise ValueError("not a Speex header")
                self.sample_rate = struct.unpack_from("<I", packet, 36)[0]
                self.mode = struct.unpack_from("<I", packet, 40)[0]
                self.channels = struct.unpack_from("<I", packet, 48)[0]
                self.frames_per_packet = struct.unpack_from("<I", packet, 64)[0]
                self._init_decoder(packet)
                self._primed = True
                self._skip_comment = True
                continue
            if self._skip_comment:
                self._skip_comment = False
                continue
            if self._dec is not None:
                pcm = self._dec.decode_packet(
                    packet, self.frames_per_packet or 0)
                if self._stereo is not None and len(pcm):
                    nf = max(len(self._stereo.trail), 1)
                    fl = len(pcm) // nf
                    lr = np.concatenate([
                        self._stereo.apply(pcm[k * fl:(k + 1) * fl])
                        for k in range(nf)
                    ], axis=0)
                    pcm = lr.reshape(-1).astype(np.float32)
                out.append(pcm)
            else:
                out.append(self._av.push(packet))
        return np.concatenate(out) if out else np.zeros(0, dtype=np.float32)

    def decode_i16(self, data: bytes) -> np.ndarray:
        return f32_to_i16(self.decode_f32(data))

    def flush(self) -> np.ndarray:
        return self._av.flush() if self._av else np.zeros(0, dtype=np.float32)
