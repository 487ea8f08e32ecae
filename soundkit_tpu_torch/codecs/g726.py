"""G.726 rates and code packing (copied from ``soundkit_tpu/codecs/g726.py``).

``G726Packing`` Left/Right bit packing follows ffmpeg's ``g726`` and
``g726le``; packing and unpacking are vectorized numpy on the host.
"""
from __future__ import annotations

import enum

import numpy as np


class G726Rate(enum.Enum):
    RATE_16000 = 2  # bits per code
    RATE_24000 = 3
    RATE_32000 = 4
    RATE_40000 = 5

    @classmethod
    def from_bitrate(cls, bit_rate: int) -> "G726Rate":
        return {
            16000: cls.RATE_16000,
            24000: cls.RATE_24000,
            40000: cls.RATE_40000,
        }.get(bit_rate, cls.RATE_32000)

    @property
    def bits_per_sample(self) -> int:
        return self.value

    @property
    def bit_rate(self) -> int:
        return {2: 16000, 3: 24000, 4: 32000, 5: 40000}[self.value]

    @property
    def samples_per_byte_group(self) -> int:
        return {2: 4, 3: 8, 4: 2, 5: 8}[self.value]

    @property
    def bytes_per_group(self) -> int:
        return {2: 1, 3: 3, 4: 1, 5: 5}[self.value]


class G726Packing(enum.Enum):
    LEFT = "left"  # ffmpeg -f g726 (MSB-first)
    RIGHT = "right"  # ffmpeg -f g726le (LSB-first)


def unpack_codes(data: bytes, bits: int, packing: G726Packing) -> np.ndarray:
    """Packed bytes -> u8 codes, whole groups only."""
    arr = np.frombuffer(data, dtype=np.uint8)
    n_codes = (len(arr) * 8) // bits
    if packing is G726Packing.LEFT:
        bits_arr = np.unpackbits(arr)[: n_codes * bits].reshape(n_codes, bits)
        weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint16)
    else:
        bits_arr = np.unpackbits(arr, bitorder="little")[: n_codes * bits].reshape(
            n_codes, bits
        )
        weights = (1 << np.arange(bits)).astype(np.uint16)
    return (bits_arr.astype(np.uint16) @ weights).astype(np.uint8)


def pack_codes(codes: np.ndarray, bits: int, packing: G726Packing) -> bytes:
    """u8 codes -> packed bytes; len(codes)*bits must be /8."""
    codes = np.asarray(codes, dtype=np.uint8)
    if packing is G726Packing.LEFT:
        shifts = np.arange(bits - 1, -1, -1)
        bits_arr = ((codes[:, None] >> shifts) & 1).astype(np.uint8).reshape(-1)
        return np.packbits(bits_arr).tobytes()
    shifts = np.arange(bits)
    bits_arr = ((codes[:, None] >> shifts) & 1).astype(np.uint8).reshape(-1)
    return np.packbits(bits_arr, bitorder="little").tobytes()
