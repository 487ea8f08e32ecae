"""GSM 06.10, AMR-NB, G.729 and AC-3 host decoders (counterpart of
``soundkit_tpu/codecs/telephony.py``).

- ``GsmDecoder``: ``GsmVariant.STANDARD`` 33-byte frames / 160 samples
  @8k, ``GsmVariant.MICROSOFT`` (WAV49) 65-byte frames / 320 samples,
  over the port's build of ``native_src/src/gsm.cpp``
  (``native.gsm_library``).
- ``AmrNbDecoder``: ``#!AMR\\n`` magic strip, per-frame length from the
  CMR/FT header byte, 160-sample frames, over the owned AMR-NB decoder
  ``native_src/src/amrnb.cpp`` (``native.amrnb_library``; libavcodec's
  float decoder, all eight modes).
- ``G729Decoder``: 8 kbit/s, 10-byte frames, frame-buffered decode, over
  the owned G.729 decoder ``native_src/src/g729.cpp``
  (``native.g729_library``; libavcodec's integer decoder, bit for bit).
- ``Ac3Decoder``: raw 0x0B77 syncframe streams through the owned A/52
  core (``codecs/ac3_core.py``).

The JAX package decodes AMR-NB and G.729 through libavcodec
(``AvDecoder("amrnb")`` / ``AvDecoder("g729")``); the port keeps its
framing verbatim and hands each frame to the owned decoder where it
called ``AvDecoder.push``. Neither decoder delays a sample, so ``flush``
returns nothing, as libavcodec's does for them. The rest keeps the JAX
package's code but for the library ``GsmDecoder`` loads.
"""
from __future__ import annotations

import enum
from typing import List, Optional

import numpy as np

from soundkit_tpu_torch.codecs.avdec import f32_to_i16
from soundkit_tpu_torch.core.audio_types import AudioData, EncodingFlag, Endianness

AMR_MAGIC = b"#!AMR\n"
# AMR-NB frame payload bytes per FT (frame type) 0..7, plus SID etc.
# (soundkit-amr/src/lib.rs:449 amr_nb_frame_len)
_AMR_NB_FRAME_BYTES = {0: 12, 1: 13, 2: 15, 3: 17, 4: 19, 5: 20, 6: 26, 7: 31, 8: 5}


def amr_nb_frame_len(toc_byte: int) -> Optional[int]:
    ft = (toc_byte >> 3) & 0x0F
    if ft in _AMR_NB_FRAME_BYTES:
        return _AMR_NB_FRAME_BYTES[ft]
    if ft == 15:  # NO_DATA
        return 0
    return None


class GsmVariant(enum.Enum):
    STANDARD = "standard"  # 33-byte frame / 160 samples
    MICROSOFT = "microsoft"  # WAV49: 65-byte frame / 320 samples


class _OwnedCore:
    """The owned decoder of one stream where the JAX package opens
    ``AvDecoder``: ``push`` decodes one frame to float32 as libavcodec's
    sample format gives it to ``AvDecoder``, ``flush`` gives what
    libavcodec's does at the end of these streams: nothing."""

    def __del__(self):
        if getattr(self, "_h", None):
            self._free(self._h)
            self._h = None

    def flush(self) -> np.ndarray:
        return np.zeros(0, dtype=np.float32)


class _G729Core(_OwnedCore):
    """``native_src/src/g729.cpp``: int16 out, over 32768 as libavcodec's."""

    def __init__(self):
        from soundkit_tpu_torch.native import g729_library

        self._lib = g729_library()
        self._free = self._lib.skt_g729_free
        self._h = self._lib.skt_g729_new()

    def push(self, frame: bytes) -> np.ndarray:
        out = np.zeros(len(frame) // 10 * 80, dtype=np.int16)
        n = self._lib.skt_g729_decode(self._h, frame, len(frame), out)
        return out[:n].astype(np.float32) / 32768.0


class _AmrNbCore(_OwnedCore):
    """``native_src/src/amrnb.cpp``: float32 out, as libavcodec's."""

    def __init__(self):
        from soundkit_tpu_torch.native import amrnb_library

        self._lib = amrnb_library()
        self._free = self._lib.skt_amrnb_free
        self._h = self._lib.skt_amrnb_new()

    def push(self, frame: bytes) -> np.ndarray:
        out = np.zeros(160, dtype=np.float32)
        n = self._lib.skt_amrnb_decode_frame(self._h, frame, len(frame), out)
        return out[:n]


#: the owned core where the JAX package's ``_FrameBufferedDecoder`` opens
#: ``AvDecoder(codec_name, ...)``
_OWNED_CORES = {"g729": _G729Core}


class _FrameBufferedDecoder:
    """Base: buffer to fixed frame size, decode whole frames."""

    frame_bytes: int
    sample_rate: int
    channels = 1

    def __init__(self, codec_name: str, rate: int, frame_bytes: int):
        self._av = _OWNED_CORES[codec_name]()
        self.sample_rate = rate
        self.frame_bytes = frame_bytes
        self._pending = bytearray()

    def decode_f32(self, data: bytes) -> np.ndarray:
        self._pending.extend(data)
        out = []
        while len(self._pending) >= self.frame_bytes:
            frame = bytes(self._pending[: self.frame_bytes])
            del self._pending[: self.frame_bytes]
            out.append(self._av.push(frame))
        if not out:
            return np.zeros(0, dtype=np.float32)
        return np.concatenate(out)

    def decode_i16(self, data: bytes) -> np.ndarray:
        return f32_to_i16(self.decode_f32(data))

    def flush(self) -> np.ndarray:
        return self._av.flush()


class GsmDecoder:
    """From-scratch GSM 06.10 (RPE-LTP) decoder (native/src/gsm.cpp).

    Bit-exact with libgsm (verified against ``golden/gsm`` for the
    standard framing and the avcodec gsm_ms oracle for WAV49); replaces
    the earlier avcodec wrapper. Role-equivalent of the reference's
    libgsm FFI (soundkit-gsm/src/lib.rs:4-76).
    """

    sample_rate = 8000
    channels = 1

    def __init__(self, variant: GsmVariant = GsmVariant.STANDARD):
        from soundkit_tpu_torch.native import gsm_library

        self.variant = variant
        self.frame_bytes = 33 if variant is GsmVariant.STANDARD else 65
        self._samples_per_frame = 160 if variant is GsmVariant.STANDARD else 320
        self._lib = gsm_library()
        self._h = self._lib.skt_gsm_new(0 if variant is GsmVariant.STANDARD else 1)
        self._pending = bytearray()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.skt_gsm_free(self._h)
            self._h = None

    def decode_i16(self, data: bytes) -> np.ndarray:
        self._pending.extend(data)
        n_frames = len(self._pending) // self.frame_bytes
        if not n_frames:
            return np.zeros(0, dtype=np.int16)
        chunk = bytes(self._pending[: n_frames * self.frame_bytes])
        del self._pending[: n_frames * self.frame_bytes]
        out = np.zeros(n_frames * self._samples_per_frame, dtype=np.int16)
        n = self._lib.skt_gsm_decode(self._h, chunk, len(chunk), out)
        if n < 0:
            raise ValueError("bad GSM frame signature")
        return out[:n]

    def decode_f32(self, data: bytes) -> np.ndarray:
        return self.decode_i16(data).astype(np.float32) / 32768.0

    def flush(self) -> np.ndarray:
        return np.zeros(0, dtype=np.float32)


class G729Decoder(_FrameBufferedDecoder):
    def __init__(self) -> None:
        super().__init__("g729", 8000, 10)


class AmrNbDecoder:
    """Streaming AMR-NB: strips magic, walks per-frame TOC lengths."""

    sample_rate = 8000
    channels = 1

    def __init__(self) -> None:
        self._av = _AmrNbCore()
        self._pending = bytearray()
        self._magic_checked = False

    def decode_f32(self, data: bytes) -> np.ndarray:
        self._pending.extend(data)
        if not self._magic_checked:
            if len(self._pending) < len(AMR_MAGIC):
                return np.zeros(0, dtype=np.float32)
            if bytes(self._pending[: len(AMR_MAGIC)]) == AMR_MAGIC:
                del self._pending[: len(AMR_MAGIC)]
            self._magic_checked = True
        out = []
        while self._pending:
            toc = self._pending[0]
            payload = amr_nb_frame_len(toc)
            if payload is None:
                del self._pending[0]  # resync on bad TOC
                continue
            total = 1 + payload
            if len(self._pending) < total:
                break
            frame = bytes(self._pending[:total])
            del self._pending[:total]
            out.append(self._av.push(frame))
        if not out:
            return np.zeros(0, dtype=np.float32)
        return np.concatenate(out)

    def decode_i16(self, data: bytes) -> np.ndarray:
        return f32_to_i16(self.decode_f32(data))

    def flush(self) -> np.ndarray:
        return self._av.flush()


class Ac3Decoder:
    """Raw AC-3 syncframe stream decoder (owned A/52 core, no
    libavcodec: codecs/ac3_core.py; >139 dB vs the oracle on
    testdata/ac3 and on crafted stereo/5.1/coupled/short-block
    streams)."""

    def __init__(self) -> None:
        from soundkit_tpu_torch.codecs.ac3_core import Ac3Decoder as _Core

        self._core = _Core()

    @property
    def sample_rate(self) -> Optional[int]:
        return getattr(self._core, "sample_rate", None)

    @property
    def channels(self) -> Optional[int]:
        return getattr(self._core, "channels", None)

    def decode_f32(self, data: bytes) -> np.ndarray:
        return self._core.decode(data)

    def decode_i16(self, data: bytes) -> np.ndarray:
        return f32_to_i16(self.decode_f32(data))

    def flush(self) -> np.ndarray:
        return np.zeros(0, dtype=np.float32)


# --- pipeline adapters ---


class _I16Adapter:
    def __init__(self, dec, fixed_rate: Optional[int] = None, fixed_channels: Optional[int] = None):
        self._dec = dec
        self._rate = fixed_rate
        self._channels = fixed_channels

    def _emit(self, pcm16: np.ndarray) -> List[AudioData]:
        rate = self._rate or getattr(self._dec, "sample_rate", None)
        ch = self._channels or getattr(self._dec, "channels", None)
        if len(pcm16) == 0 or not rate or not ch:
            return []
        return [
            AudioData(
                bits_per_sample=16,
                channel_count=ch,
                sampling_rate=rate,
                data=np.asarray(pcm16, np.int16).astype("<i2").tobytes(),
                audio_format=EncodingFlag.PCM_SIGNED,
                endianness=Endianness.LITTLE,
            )
        ]

    def process(self, chunk: bytes) -> List[AudioData]:
        return self._emit(self._dec.decode_i16(chunk))

    def flush(self) -> List[AudioData]:
        return self._emit(f32_to_i16(self._dec.flush()))


def make_gsm_adapter(variant: GsmVariant = GsmVariant.STANDARD) -> _I16Adapter:
    return _I16Adapter(GsmDecoder(variant), 8000, 1)


def make_amr_adapter() -> _I16Adapter:
    return _I16Adapter(AmrNbDecoder(), 8000, 1)


def make_g729_adapter() -> _I16Adapter:
    return _I16Adapter(G729Decoder(), 8000, 1)


def make_ac3_adapter() -> _I16Adapter:
    return _I16Adapter(Ac3Decoder())
