"""FLAC streaming decoder on the host (counterpart of
``soundkit_tpu/codecs/flac.py``).

``FlacDecoder.add(bytes) -> Optional[AudioData]`` emits newly decoded
whole frames as interleaved PCM, incrementally; ``decode_flac`` decodes
a whole stream. The decode is host C++, the port's own build of
``native_src/src/flac.cpp`` (``native.flac_library``), as in the JAX
package; the batched path on the card is ``models/flac_batch.py``. The
decoder is the JAX package's, but for the library it opens. A decode can
be checked against the STREAMINFO MD5 (``verify_md5``).

:class:`FlacPartsStream` and :class:`FlacSegsStream` are the JAX package's
single-stream split walks, verbatim but for the library they open: the
host walks one stream frame by frame and exports either its Rice-decoded
residual planes (``next_parts``, for the LPC restore on the device, K9)
or the frame's bytes with a table of its Rice and fixed-width spans
(``next``, for the Rice decode on the device, K8, then K9), falling back
to the residual planes for a frame the segment wire cannot carry.
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


class FlacPartsStream:
    """Entropy-decode-only FLAC stream for the device-LPC split.

    Host does bitstream + Rice (skt_flac_next_parts); LPC
    reconstruction / wasted shift / decorrelation run on device via
    ops.flac_lpc.  ``next_parts()`` returns
    (meta[12] i32, resw[2,stride] i32, coef[2,32] i32) or None.
    """

    def __init__(self, stride: int = 4608) -> None:
        self._lib = flac_library()
        self._h = self._lib.skt_flac_new()
        self.stride = stride

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.skt_flac_free(self._h)
            self._h = None

    def feed(self, chunk: bytes) -> None:
        if self._lib.skt_flac_feed(self._h, chunk, len(chunk)) != 0:
            raise FlacError(self._lib.skt_flac_error(self._h).decode())

    @property
    def max_block(self) -> int:
        return int(self._lib.skt_flac_max_block(self._h))

    def next_parts(self):
        meta = np.zeros(12, dtype=np.int32)
        resw = np.zeros((2, self.stride), dtype=np.int32)
        coef = np.zeros((2, 32), dtype=np.int32)
        rc = self._lib.skt_flac_next_parts(
            self._h, meta, resw.reshape(-1), coef.reshape(-1), self.stride
        )
        if rc == 0:
            return None
        if rc == -1:
            raise FlacError(self._lib.skt_flac_error(self._h).decode())
        if rc == -2:
            raise FlacError(
                f"frame exceeds parts stride {self.stride} or has >2 channels"
            )
        return meta, resw, coef


class FlacSegsStream:
    """Segment-wire FLAC stream for the device-Rice split.

    The host only WALKS the bitstream (skt_flac_next_segs): the wire
    ships the raw frame bytes plus a table of Rice/fixed-width coding
    spans, and the device decodes the residual payloads itself
    (ops/flac_rice.py) before running LPC reconstruction.  This drops
    the per-frame h2d wire from 4 B/sample of int32 residual plane to
    the compressed frame bytes (~0.4-2 B/sample).

    ``next()`` returns either
      ("segs", meta, coef, warm, xmeta, segs[n,4], frame_bytes) or
      ("parts", meta, resw, coef)  — rare shapes the segment wire
        cannot carry (>32-bit reads, oversized frames), exported via
        skt_flac_export_parts_last so nothing is ever re-decoded,
    or None when more input is needed.
    """

    SEG_CAP = 8192
    MAX_FRAME_BYTES = 65536

    def __init__(self, stride: int = 4608) -> None:
        self._lib = flac_library()
        self._h = self._lib.skt_flac_new()
        self.stride = stride
        # reused across next() calls: the C++ walk writes every cell
        # it reports (segs[:n], fbytes[:nb]) and the consumer copies
        # them out, so per-call zeroing was pure memset overhead
        # (~200 KB/frame dominated the 256-lane serving pass)
        self._segs = np.empty((self.SEG_CAP, 4), dtype=np.int32)
        self._fbytes = np.empty(self.MAX_FRAME_BYTES, dtype=np.uint8)
        # raw-pointer prototype for the per-frame hot call: the
        # ndpointer argtype re-validates six arrays per call (~40% of
        # the 256-lane host walk); this one takes plain addresses
        proto = ctypes.CFUNCTYPE(
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_long, ctypes.c_long)
        self._next_segs = proto(("skt_flac_next_segs", self._lib))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.skt_flac_free(self._h)
            self._h = None

    def feed(self, chunk: bytes) -> None:
        if self._lib.skt_flac_feed(self._h, chunk, len(chunk)) != 0:
            raise FlacError(self._lib.skt_flac_error(self._h).decode())

    def next(self):
        meta = np.zeros(12, dtype=np.int32)
        coef = np.zeros((2, 32), dtype=np.int32)
        warm = np.zeros((2, 32), dtype=np.int32)
        xmeta = np.zeros(8, dtype=np.int32)
        segs = self._segs
        fbytes = self._fbytes
        rc = self._next_segs(
            self._h, meta.ctypes.data, coef.ctypes.data,
            warm.ctypes.data, xmeta.ctypes.data, segs.ctypes.data,
            fbytes.ctypes.data, self.stride, self.SEG_CAP,
            self.MAX_FRAME_BYTES,
        )
        if rc == 0:
            return None
        if rc == -1:
            raise FlacError(self._lib.skt_flac_error(self._h).decode())
        if rc == -2:
            resw = np.zeros((2, self.stride), dtype=np.int32)
            rc2 = self._lib.skt_flac_export_parts_last(
                self._h, meta, resw.reshape(-1), coef.reshape(-1),
                self.stride,
            )
            if rc2 != 1:
                raise FlacError(
                    f"frame exceeds parts stride {self.stride} or has "
                    f">2 channels"
                )
            return "parts", meta, resw, coef
        n = int(xmeta[4])
        nb = int(xmeta[5])
        return ("segs", meta, coef, warm, xmeta, segs[:n].copy(),
                bytes(fbytes[:nb]))
