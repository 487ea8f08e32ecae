"""FLAC streaming decoder on the host (counterpart of
``soundkit_tpu/codecs/flac.py``).

``FlacDecoder.add(bytes) -> Optional[AudioData]`` emits newly decoded
whole frames as interleaved PCM, incrementally; ``decode_flac`` decodes
a whole stream. The decode is host C++, the port's own build of
``native_src/src/flac.cpp`` (``native.flac_library``), as in the JAX
package; the batched path on the card is ``models/flac_batch.py``. The
decoder is the JAX package's, but for the library it opens. A decode can
be checked against the STREAMINFO MD5 (``verify_md5``).
"""
from __future__ import annotations

import ctypes
import hashlib
from typing import Optional

import numpy as np

from soundkit_tpu_torch.core.audio_types import AudioData, EncodingFlag, Endianness
from soundkit_tpu_torch.native import flac_library


class FlacError(ValueError):
    pass


class FlacDecoder:
    def __init__(self) -> None:
        from soundkit_tpu_torch.utils.tracing import debug_init

        self._lib = flac_library()
        self._h = self._lib.skt_flac_new()
        self._info = None
        debug_init("flac")  # reference: debug! on init, flac lib.rs:717

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.skt_flac_free(self._h)
            self._h = None

    @property
    def info(self) -> Optional[dict]:
        if self._info is None:
            ch = ctypes.c_int()
            bits = ctypes.c_int()
            rate = ctypes.c_long()
            total = ctypes.c_longlong()
            if self._lib.skt_flac_info(self._h, ch, bits, rate, total):
                md5 = ctypes.create_string_buffer(16)
                self._lib.skt_flac_md5(self._h, md5)
                self._info = {
                    "channels": ch.value,
                    "bits_per_sample": bits.value,
                    "sample_rate": rate.value,
                    "total_samples": total.value,
                    "md5": bytes(md5.raw),
                }
        return self._info

    def add(self, chunk: bytes) -> Optional[AudioData]:
        """Feed bytes; returns newly decoded frames as AudioData or None."""
        rc = self._lib.skt_flac_push(self._h, bytes(chunk), len(chunk))
        if rc != 0:
            raise FlacError(self._lib.skt_flac_error(self._h).decode())
        return self._drain()

    def _drain(self) -> Optional[AudioData]:
        info = self.info
        if info is None:
            return None
        cap = 1 << 20
        buf = (ctypes.c_int32 * cap)()
        parts = []
        while True:
            n = self._lib.skt_flac_pull(self._h, buf, cap)
            if n == 0:
                break
            parts.append(np.frombuffer(buf, dtype=np.int32, count=n).copy())
        if not parts:
            return None
        samples = np.concatenate(parts)
        data = self._samples_to_bytes(samples, info["bits_per_sample"])
        return AudioData(
            bits_per_sample=info["bits_per_sample"],
            channel_count=info["channels"],
            sampling_rate=info["sample_rate"],
            data=data,
            audio_format=EncodingFlag.PCM_SIGNED,
            endianness=Endianness.LITTLE,
        )

    @staticmethod
    def _samples_to_bytes(samples: np.ndarray, bits: int) -> bytes:
        if bits == 16:
            return samples.astype(np.int16).astype("<i2").tobytes()
        if bits == 24:
            u = samples.astype(np.int32).view(np.uint32)
            out = np.empty((len(samples), 3), dtype=np.uint8)
            out[:, 0] = u & 0xFF
            out[:, 1] = (u >> 8) & 0xFF
            out[:, 2] = (u >> 16) & 0xFF
            return out.tobytes()
        if bits == 32:
            return samples.astype("<i4").tobytes()
        if bits == 8:
            return samples.astype(np.int8).tobytes()
        # other widths (12/20): pack to the next byte width, LE
        if bits <= 16:
            return samples.astype(np.int16).astype("<i2").tobytes()
        return samples.astype("<i4").tobytes()

    def verify_md5(self, decoded_bytes: bytes) -> bool:
        """Check decoded PCM against the STREAMINFO MD5 oracle."""
        info = self.info
        if info is None or info["md5"] == b"\x00" * 16:
            return True  # no md5 present
        return hashlib.md5(decoded_bytes).digest() == info["md5"]


def decode_flac(data: bytes) -> AudioData:
    """One-shot decode of a complete FLAC stream."""
    dec = FlacDecoder()
    audio = dec.add(data)
    if audio is None:
        raise FlacError("incomplete FLAC stream")
    return audio
