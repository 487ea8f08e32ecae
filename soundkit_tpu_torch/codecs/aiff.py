"""AIFF / AIFF-C decoder.

API equivalent of the reference's aifc-crate wrapper
(soundkit-aiff/src/lib.rs:10-48): ``add()`` buffers chunks and the
container is decoded at EOF/flush (the reference is EOF-buffered the
same way because the aifc crate needs Read+Seek).

Supports PCM AIFF and AIFC compression types NONE/sowt/fl32/FL32/
fl64/twos, plus ulaw/alaw via the framework's own G.711.

Port: the G.711 codes decode through ``codecs/g711.decode_i16`` on the
decoder's ``device`` (K3 on one ``[1, N]`` lane, the card unless the
caller names the CPU); the rest is the JAX package's code.
"""
from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from soundkit_tpu_torch.codecs.g711 import G711Law, decode_i16 as g711_decode_i16
from soundkit_tpu_torch.core.audio_types import AudioData, EncodingFlag, Endianness


def _read_extended80(b: bytes) -> float:
    """80-bit IEEE 754 extended float (AIFF sample rate field)."""
    sign_exp = struct.unpack(">H", b[:2])[0]
    mant = struct.unpack(">Q", b[2:10])[0]
    sign = -1.0 if sign_exp & 0x8000 else 1.0
    exp = sign_exp & 0x7FFF
    if exp == 0 and mant == 0:
        return 0.0
    return sign * mant * 2.0 ** (exp - 16383 - 63)


class AiffError(ValueError):
    pass


def decode_aiff_container(data: bytes, device="cuda") -> AudioData:
    if len(data) < 12 or data[:4] != b"FORM" or data[8:12] not in (b"AIFF", b"AIFC"):
        raise AiffError("not an AIFF/AIFC file")
    is_aifc = data[8:12] == b"AIFC"
    pos = 12
    channels = bits = 0
    rate = 0
    comp = b"NONE"
    sound = b""
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack(">I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"COMM":
            channels = struct.unpack(">h", body[0:2])[0]
            bits = struct.unpack(">h", body[6:8])[0]
            rate = int(round(_read_extended80(body[8:18])))
            if is_aifc and len(body) >= 22:
                comp = body[18:22]
        elif cid == b"SSND":
            offset = struct.unpack(">I", body[0:4])[0]
            sound = body[8 + offset :]
        pos += 8 + size + (size & 1)  # chunks are word-aligned

    if channels <= 0 or rate <= 0:
        raise AiffError("missing COMM chunk")

    comp_l = comp.lower()
    if comp in (b"NONE", b"twos") or not is_aifc:
        # big-endian signed PCM -> keep LE AudioData
        width = (bits + 7) // 8
        if width == 2:
            pcm = np.frombuffer(sound[: len(sound) // 2 * 2], dtype=">i2").astype("<i2")
            return AudioData(16, channels, rate, pcm.tobytes(),
                             EncodingFlag.PCM_SIGNED, Endianness.LITTLE)
        if width == 3:
            u8 = np.frombuffer(sound[: len(sound) // 3 * 3], dtype=np.uint8).reshape(-1, 3)
            le = u8[:, ::-1].tobytes()
            return AudioData(24, channels, rate, le, EncodingFlag.PCM_SIGNED, Endianness.LITTLE)
        if width == 4:
            pcm = np.frombuffer(sound[: len(sound) // 4 * 4], dtype=">i4").astype("<i4")
            return AudioData(32, channels, rate, pcm.tobytes(),
                             EncodingFlag.PCM_SIGNED, Endianness.LITTLE)
        if width == 1:
            pcm = (np.frombuffer(sound, dtype=np.int8).astype(np.int16) << 8).astype("<i2")
            return AudioData(16, channels, rate, pcm.tobytes(),
                             EncodingFlag.PCM_SIGNED, Endianness.LITTLE)
        raise AiffError(f"unsupported PCM width {bits}")
    if comp_l == b"sowt":  # little-endian 16-bit
        pcm = np.frombuffer(sound[: len(sound) // 2 * 2], dtype="<i2")
        return AudioData(16, channels, rate, pcm.tobytes(),
                         EncodingFlag.PCM_SIGNED, Endianness.LITTLE)
    if comp_l in (b"fl32",):
        pcm = np.frombuffer(sound[: len(sound) // 4 * 4], dtype=">f4").astype("<f4")
        return AudioData(32, channels, rate, pcm.tobytes(),
                         EncodingFlag.PCM_FLOAT, Endianness.LITTLE)
    if comp_l in (b"fl64",):
        pcm = np.frombuffer(sound[: len(sound) // 8 * 8], dtype=">f8").astype("<f4")
        return AudioData(32, channels, rate, pcm.tobytes(),
                         EncodingFlag.PCM_FLOAT, Endianness.LITTLE)
    if comp_l in (b"ulaw", b"alaw"):
        law = G711Law.MU_LAW if comp_l == b"ulaw" else G711Law.A_LAW
        pcm = g711_decode_i16(law, sound, device).astype("<i2")
        return AudioData(16, channels, rate, pcm.tobytes(),
                         EncodingFlag.PCM_SIGNED, Endianness.LITTLE)
    raise AiffError(f"unsupported AIFC compression {comp!r}")


class AiffDecoder:
    """EOF-buffered streaming wrapper (soundkit-aiff/src/lib.rs:10-48)."""

    def __init__(self, device="cuda") -> None:
        self._buf = bytearray()
        self._device = device

    def add(self, chunk: bytes) -> Optional[AudioData]:
        if len(chunk) == 0:
            if not self._buf:
                return None
            data = bytes(self._buf)
            self._buf.clear()
            return decode_aiff_container(data, self._device)
        self._buf.extend(chunk)
        return None


class AiffAdapter:
    def __init__(self, device="cuda") -> None:
        self._dec = AiffDecoder(device)

    def process(self, chunk: bytes) -> List[AudioData]:
        out = self._dec.add(chunk)
        return [out] if out is not None else []

    def flush(self) -> List[AudioData]:
        out = self._dec.add(b"")
        return [out] if out is not None else []
