"""G.726 ADPCM streaming codec, 16/24/32/40 kbit/s (counterpart of
``soundkit_tpu/codecs/g726.py``).

``G726Rate``, ``G726Packing`` and the code packing are copied from the
JAX package: Left/Right bit packing follows ffmpeg's ``g726`` and
``g726le``, vectorized numpy on the host. The streaming
``G726Decoder`` / ``G726Encoder`` buffer to whole byte groups and run
K6 (``ops.adpcm.g726_decode_scan`` / ``g726_encode_scan``) on one lane of
the codec's device, the card unless the caller names the CPU, at the
exact length; the state is one ``[1, 24]`` int32 row
(``ops.adpcm.G726_LAYOUT``) kept on that device.
"""
from __future__ import annotations

import enum

import numpy as np
import torch

from soundkit_tpu_torch.ops import adpcm
from soundkit_tpu_torch.utils.device import resolve_device

G726_SAMPLE_RATE = 8000
G726_CHANNELS = 1


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


class G726Decoder:
    """Streaming decoder; buffers to whole byte groups."""

    def __init__(
        self,
        rate: G726Rate = G726Rate.RATE_32000,
        packing: G726Packing = G726Packing.LEFT,
        device="cuda",
    ):
        self.rate = rate
        self.packing = packing
        self.device = resolve_device(device)
        self._pending = bytearray()
        self._state = adpcm.g726_init_state(1, self.device)

    sample_rate = property(lambda self: G726_SAMPLE_RATE)
    channels = property(lambda self: G726_CHANNELS)

    def decode_i16(self, data: bytes) -> np.ndarray:
        self._pending.extend(data)
        group = self.rate.bytes_per_group
        complete = (len(self._pending) // group) * group
        if complete == 0:
            return np.zeros(0, dtype=np.int16)
        chunk = bytes(self._pending[:complete])
        del self._pending[:complete]

        codes = unpack_codes(chunk, self.rate.bits_per_sample, self.packing)
        lane = torch.from_numpy(codes).to(self.device).reshape(1, -1)
        pcm, self._state = adpcm.g726_decode_scan(lane, self._state, self.rate.bits_per_sample)
        return pcm[0].cpu().numpy()

    def decode_i32(self, data: bytes) -> np.ndarray:
        return self.decode_i16(data).astype(np.int32) << 16

    def decode_f32(self, data: bytes) -> np.ndarray:
        return (self.decode_i16(data).astype(np.float32) / np.float32(32768.0)).astype(
            np.float32
        )

    def flush(self) -> None:
        if self._pending:
            raise ValueError(
                f"G.726 stream ended with {len(self._pending)} trailing partial-packet byte(s)"
            )

    def reset(self) -> None:
        self._pending.clear()
        self._state = adpcm.g726_init_state(1, self.device)


class G726Encoder:
    """Streaming encoder; buffers to whole sample groups."""

    def __init__(
        self,
        rate: G726Rate = G726Rate.RATE_32000,
        packing: G726Packing = G726Packing.LEFT,
        device="cuda",
    ):
        self.rate = rate
        self.packing = packing
        self.device = resolve_device(device)
        self._pending: np.ndarray = np.zeros(0, dtype=np.int16)
        self._state = adpcm.g726_init_state(1, self.device)

    def encode_i16(self, samples: np.ndarray) -> bytes:
        samples = np.concatenate([self._pending, np.asarray(samples, dtype=np.int16)])
        group = self.rate.samples_per_byte_group
        complete = (len(samples) // group) * group
        self._pending = samples[complete:]
        if complete == 0:
            return b""
        return self._encode_exact(samples[:complete])

    def encode_i32(self, samples: np.ndarray) -> bytes:
        return self.encode_i16((np.asarray(samples, dtype=np.int32) >> 16).astype(np.int16))

    def flush(self) -> bytes:
        """Zero-pad the trailing partial group and encode it (lib.rs:607-625)."""
        if len(self._pending) == 0:
            return b""
        group = self.rate.samples_per_byte_group
        padded = np.zeros(group, dtype=np.int16)
        padded[: len(self._pending)] = self._pending
        self._pending = np.zeros(0, dtype=np.int16)
        return self._encode_exact(padded)

    def _encode_exact(self, samples: np.ndarray) -> bytes:
        lane = torch.from_numpy(np.ascontiguousarray(samples)).to(self.device).reshape(1, -1)
        codes, self._state = adpcm.g726_encode_scan(lane, self._state, self.rate.bits_per_sample)
        return pack_codes(codes[0].cpu().numpy(), self.rate.bits_per_sample, self.packing)

    def reset(self) -> None:
        self._pending = np.zeros(0, dtype=np.int16)
        self._state = adpcm.g726_init_state(1, self.device)
