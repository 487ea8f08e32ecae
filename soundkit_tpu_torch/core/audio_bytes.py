"""Vectorized sample-width / endianness / interleave conversions.

Host-side (numpy) equivalents of the reference's ~25 scalar conversion
kernels in ``soundkit/src/audio_bytes.rs`` and the scalers in
``soundkit/src/audio_pipeline.rs:14-47``.  Every function preserves the
reference's exact arithmetic, including its deliberate asymmetries:

- i16 -> f32 divides by 32768 (audio_bytes.rs:12, audio_pipeline.rs:30)
  while f32 -> i16 multiplies by 32767 with clamp + truncation toward
  zero (audio_bytes.rs:172, audio_pipeline.rs:19).
- s24 -> i16 sign-extends then arithmetic-shifts right by 8
  (audio_bytes.rs:61).
- s32 -> s24 masks with 0x00FFFFFF *without* re-sign-extending
  (audio_bytes.rs:106) — quirk preserved.
- f32 -> i32 multiplies by 2^31 (``i32::MAX as f32`` rounds to 2^31)
  with saturating truncation (audio_bytes.rs:195-199).
- f32 -> s24 uses 8388607 for positive and 8388608 for negative values
  (audio_bytes.rs:211-216).

These run on the host because they sit at the bytes<->tensor boundary;
the same math exists as jittable device ops in
``soundkit_tpu.ops.convert`` for data already resident on TPU.
"""
from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

Bytes = Union[bytes, bytearray, memoryview, np.ndarray]

_F32_2P31 = np.float32(2147483648.0)  # i32::MAX as f32 rounds up to 2^31
_I32_MIN = -2147483648
_I32_MAX = 2147483647


def _as_u8(data: Bytes) -> np.ndarray:
    arr = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    if arr.dtype != np.uint8:
        arr = arr.view(np.uint8)
    return arr


def _trunc_sat_i32(x_f32: np.ndarray) -> np.ndarray:
    """Rust `as i32` on f32: truncate toward zero, saturate at i32 bounds."""
    x = np.trunc(x_f32.astype(np.float64))
    return np.clip(x, _I32_MIN, _I32_MAX).astype(np.int32)


def _trunc_sat_i16(x_f32: np.ndarray) -> np.ndarray:
    x = np.trunc(x_f32.astype(np.float64))
    return np.clip(x, -32768, 32767).astype(np.int16)


# ---------------------------------------------------------------------------
# bytes -> samples
# ---------------------------------------------------------------------------

def s16le_to_i16(data: Bytes) -> np.ndarray:
    return np.frombuffer(_as_u8(data).tobytes(), dtype="<i2").copy()


def s16be_to_i16(data: Bytes) -> np.ndarray:
    return np.frombuffer(_as_u8(data).tobytes(), dtype=">i2").astype(np.int16)


def i16le_to_i16(data: Bytes) -> np.ndarray:
    return s16le_to_i16(data)


def s16le_to_i32(data: Bytes) -> np.ndarray:
    return s16le_to_i16(data).astype(np.int32)


def i16le_to_f32(data: Bytes) -> np.ndarray:
    """i16 LE bytes -> f32 in [-1, 1), dividing by 32768 (audio_bytes.rs:3-15)."""
    return (s16le_to_i16(data).astype(np.float32) / np.float32(32768.0)).astype(np.float32)


def _u24_words(data: Bytes, big_endian: bool) -> np.ndarray:
    u8 = _as_u8(data)
    n = len(u8) // 3
    u8 = u8[: n * 3].reshape(n, 3).astype(np.uint32)
    if big_endian:
        return (u8[:, 0] << 16) | (u8[:, 1] << 8) | u8[:, 2]
    return u8[:, 0] | (u8[:, 1] << 8) | (u8[:, 2] << 16)


def _sign_extend_24(u24: np.ndarray) -> np.ndarray:
    neg = (u24 & 0x800000) != 0
    return np.where(neg, (u24 | 0xFF000000).astype(np.uint32), u24).astype(np.uint32).view(np.int32)


def s24le_to_i32(data: Bytes) -> np.ndarray:
    """24-bit LE -> sign-extended i32 in 24-bit range (audio_bytes.rs:36-49)."""
    return _sign_extend_24(_u24_words(data, big_endian=False))


def s24le_to_i16(data: Bytes) -> np.ndarray:
    return (s24le_to_i32(data) >> 8).astype(np.int16)


def s24be_to_i16(data: Bytes) -> np.ndarray:
    return (_sign_extend_24(_u24_words(data, big_endian=True)) >> 8).astype(np.int16)


def s32le_to_i32(data: Bytes) -> np.ndarray:
    return np.frombuffer(_as_u8(data).tobytes(), dtype="<i4").copy()


def s32be_to_i32(data: Bytes) -> np.ndarray:
    return np.frombuffer(_as_u8(data).tobytes(), dtype=">i4").astype(np.int32)


def s32le_to_s24(data: Bytes) -> np.ndarray:
    """Mask to low 24 bits, NO sign extension (audio_bytes.rs:101-110)."""
    return (s32le_to_i32(data) & 0x00FFFFFF).astype(np.int32)


def s32be_to_s24(data: Bytes) -> np.ndarray:
    return (s32be_to_i32(data) & 0x00FFFFFF).astype(np.int32)


def s32le_to_f32(data: Bytes) -> np.ndarray:
    """i32 -> f32 dividing by f32(2^31-1) == 2^31 (audio_bytes.rs:123-132)."""
    return (s32le_to_i32(data).astype(np.float32) / _F32_2P31).astype(np.float32)


def s32be_to_f32(data: Bytes) -> np.ndarray:
    return (s32be_to_i32(data).astype(np.float32) / _F32_2P31).astype(np.float32)


def s32le_to_i16(data: Bytes) -> np.ndarray:
    return (s32le_to_i32(data) >> 16).astype(np.int16)


def s32be_to_i16(data: Bytes) -> np.ndarray:
    return (s32be_to_i32(data) >> 16).astype(np.int16)


def f32le_to_f32(data: Bytes) -> np.ndarray:
    return np.frombuffer(_as_u8(data).tobytes(), dtype="<f4").copy()


def f32be_to_f32(data: Bytes) -> np.ndarray:
    return np.frombuffer(_as_u8(data).tobytes(), dtype=">f4").astype(np.float32)


def f32le_to_i16(data: Bytes) -> np.ndarray:
    """clamp(-1,1) * 32767, truncating (audio_bytes.rs:167-176)."""
    return vec_f32_to_i16(f32le_to_f32(data))


def f32be_to_i16(data: Bytes) -> np.ndarray:
    return vec_f32_to_i16(f32be_to_f32(data))


def f32le_to_i32(data: Bytes) -> np.ndarray:
    """clamp(-1,1) * 2^31, saturating truncation (audio_bytes.rs:189-203)."""
    x = np.clip(f32le_to_f32(data), np.float32(-1.0), np.float32(1.0))
    scaled = (x * _F32_2P31).astype(np.float32)
    return _trunc_sat_i32(scaled)


def f32le_to_s24(data: Bytes) -> np.ndarray:
    """clamp(-1,1); * 8388607 if >= 0 else * 8388608 (audio_bytes.rs:205-220)."""
    x = np.clip(f32le_to_f32(data), np.float32(-1.0), np.float32(1.0))
    scaled = np.where(
        x >= 0,
        (x * np.float32(8388607.0)).astype(np.float32),
        (x * np.float32(8388608.0)).astype(np.float32),
    )
    return _trunc_sat_i32(scaled)


# ---------------------------------------------------------------------------
# samples -> bytes
# ---------------------------------------------------------------------------

def i16_to_i16le(samples: np.ndarray) -> bytes:
    return np.asarray(samples, dtype=np.int16).astype("<i2").tobytes()


def i32_to_s32le(samples: np.ndarray) -> bytes:
    return np.asarray(samples, dtype=np.int32).astype("<i4").tobytes()


def i32_to_s24le(samples: np.ndarray) -> bytes:
    arr = np.asarray(samples, dtype=np.int32)
    u = arr.view(np.uint32)
    out = np.empty((len(arr), 3), dtype=np.uint8)
    out[:, 0] = u & 0xFF
    out[:, 1] = (u >> 8) & 0xFF
    out[:, 2] = (u >> 16) & 0xFF
    return out.tobytes()


def f32_to_f32le(samples: np.ndarray) -> bytes:
    return np.asarray(samples, dtype=np.float32).astype("<f4").tobytes()


# ---------------------------------------------------------------------------
# scalers (audio_pipeline.rs:14-47)
# ---------------------------------------------------------------------------

def vec_f32_to_i16(samples: np.ndarray) -> np.ndarray:
    x = np.clip(np.asarray(samples, dtype=np.float32), np.float32(-1.0), np.float32(1.0))
    return _trunc_sat_i16((x * np.float32(32767.0)).astype(np.float32))


def vec_i16_to_f32(samples: np.ndarray) -> np.ndarray:
    return (np.asarray(samples, dtype=np.int16).astype(np.float32) / np.float32(32768.0)).astype(
        np.float32
    )


def vec_i32_to_f32(samples: np.ndarray) -> np.ndarray:
    return (np.asarray(samples, dtype=np.int32).astype(np.float32) / _F32_2P31).astype(np.float32)


# ---------------------------------------------------------------------------
# interleave / deinterleave (audio_bytes.rs:250-315)
# ---------------------------------------------------------------------------

def interleave_vecs_i16(channels: Sequence[np.ndarray]) -> bytes:
    stacked = np.stack([np.asarray(c, dtype=np.int16) for c in channels], axis=1)
    return stacked.astype("<i2").tobytes()


def deinterleave_vecs_i16(data: Bytes, channel_count: int) -> List[np.ndarray]:
    flat = s16le_to_i16(data)
    n = len(flat) // channel_count
    mat = flat[: n * channel_count].reshape(n, channel_count)
    return [mat[:, c].copy() for c in range(channel_count)]


def deinterleave_vecs_s24(data: Bytes, channel_count: int) -> List[np.ndarray]:
    flat = s24le_to_i32(data)
    n = len(flat) // channel_count
    mat = flat[: n * channel_count].reshape(n, channel_count)
    return [mat[:, c].copy() for c in range(channel_count)]


def deinterleave_vecs_f32(data: Bytes, channel_count: int) -> List[np.ndarray]:
    flat = f32le_to_f32(data)
    n = len(flat) // channel_count
    mat = flat[: n * channel_count].reshape(n, channel_count)
    return [mat[:, c].copy() for c in range(channel_count)]


def s24le_to_i32_sample(sample_bytes: bytes) -> int:
    return int(s24le_to_i32(bytes(sample_bytes))[0])


# ---------------------------------------------------------------------------
# stereo -> mono (audio_bytes.rs:317-373)
# ---------------------------------------------------------------------------

def stereo_to_mono_take_left(interleaved: np.ndarray) -> np.ndarray:
    arr = np.asarray(interleaved, dtype=np.int16)
    if len(arr) % 2:
        raise ValueError("Stereo buffer must contain an even number of samples")
    return arr[0::2].copy()


def stereo_to_mono_avg(interleaved: np.ndarray) -> np.ndarray:
    arr = np.asarray(interleaved, dtype=np.int16)
    if len(arr) % 2:
        raise ValueError("Stereo buffer must contain an even number of samples")
    l = arr[0::2].astype(np.int32)
    r = arr[1::2].astype(np.int32)
    # Rust `(l + r) / 2` is integer division truncating toward zero.
    s = l + r
    return (np.sign(s) * (np.abs(s) // 2)).astype(np.int16)


def f32s_to_le_bytes(samples: np.ndarray) -> bytes:
    return f32_to_f32le(samples)


def f32s_from_le_bytes(data: Bytes) -> np.ndarray:
    if len(_as_u8(data)) % 4:
        raise ValueError(f"invalid f32le byte length {len(_as_u8(data))}; expected multiple of 4")
    return f32le_to_f32(data)
