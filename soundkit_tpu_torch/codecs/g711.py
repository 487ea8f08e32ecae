"""G.711 mu-law / A-law streaming codec (counterpart of
``soundkit_tpu/codecs/g711.py``).

``G711Law``, the scalar helpers ``encode_sample`` / ``decode_sample``
and the streaming ``G711Decoder`` / ``G711Encoder`` keep the JAX
package's API and outputs. Decode runs K3 (``ops.companding.g711_decode``)
on one ``[1, N]`` lane on the codec's device, the card unless the caller
names the CPU; encode runs the elementwise ``encode_mulaw`` /
``encode_alaw``, which have no kernel in either package. Results come
back to the host as numpy, one copy a call.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch

from soundkit_tpu_torch.ops import companding as comp
from soundkit_tpu_torch.utils.device import resolve_device


class G711Law(enum.Enum):
    MU_LAW = "mulaw"
    A_LAW = "alaw"


def _codes(codes) -> np.ndarray:
    if isinstance(codes, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(codes), dtype=np.uint8)
    return np.asarray(codes, dtype=np.uint8)


def decode_i16(law: G711Law, codes, device="cuda") -> np.ndarray:
    """u8 codes (bytes or array) -> i16 samples, through K3 as one lane."""
    codes = _codes(codes)
    if len(codes) == 0:
        return np.zeros(0, dtype=np.int16)
    dev = resolve_device(device)
    lane = torch.from_numpy(codes.copy()).to(dev).reshape(1, -1)
    is_alaw = torch.full((1,), int(law is G711Law.A_LAW), dtype=torch.int32, device=dev)
    return comp.g711_decode(lane, is_alaw)[0].cpu().numpy()


def encode_i16(law: G711Law, samples, device="cuda") -> np.ndarray:
    """i16 samples -> u8 codes."""
    samples = np.asarray(samples, dtype=np.int16)
    if len(samples) == 0:
        return np.zeros(0, dtype=np.uint8)
    x = torch.from_numpy(samples.copy()).to(resolve_device(device))
    fn = comp.encode_mulaw if law is G711Law.MU_LAW else comp.encode_alaw
    return fn(x).cpu().numpy()


def encode_sample(law: G711Law, sample: int, device="cuda") -> int:
    return int(encode_i16(law, np.array([sample], dtype=np.int16), device)[0])


def decode_sample(law: G711Law, code: int, device="cuda") -> int:
    return int(decode_i16(law, np.array([code], dtype=np.uint8), device)[0])


@dataclass
class G711Decoder:
    """Streaming decoder (stateless)."""

    law: G711Law = G711Law.MU_LAW
    sample_rate: int = 8000
    channels: int = 1
    device: str = "cuda"

    @classmethod
    def new_mulaw(cls, sample_rate: int = 8000, channels: int = 1,
                  device="cuda") -> "G711Decoder":
        return cls(G711Law.MU_LAW, sample_rate, channels, device)

    @classmethod
    def new_alaw(cls, sample_rate: int = 8000, channels: int = 1,
                 device="cuda") -> "G711Decoder":
        return cls(G711Law.A_LAW, sample_rate, channels, device)

    def decode_i16(self, data) -> np.ndarray:
        return decode_i16(self.law, data, self.device)

    def decode_i32(self, data) -> np.ndarray:
        # the i16 value shifted into the high 16 bits
        return self.decode_i16(data).astype(np.int32) << 16

    def decode_f32(self, data) -> np.ndarray:
        return (self.decode_i16(data).astype(np.float32) / np.float32(32768.0)).astype(
            np.float32)


@dataclass
class G711Encoder:
    law: G711Law = G711Law.MU_LAW
    sample_rate: int = 8000
    channels: int = 1
    device: str = "cuda"

    @classmethod
    def new_mulaw(cls, sample_rate: int = 8000, channels: int = 1,
                  device="cuda") -> "G711Encoder":
        return cls(G711Law.MU_LAW, sample_rate, channels, device)

    @classmethod
    def new_alaw(cls, sample_rate: int = 8000, channels: int = 1,
                 device="cuda") -> "G711Encoder":
        return cls(G711Law.A_LAW, sample_rate, channels, device)

    def encode_i16(self, samples: np.ndarray) -> bytes:
        return encode_i16(self.law, samples, self.device).tobytes()

    def encode_i32(self, samples: np.ndarray) -> bytes:
        # i32 input uses the high 16 bits
        s = (np.asarray(samples, dtype=np.int32) >> 16).astype(np.int16)
        return encode_i16(self.law, s, self.device).tobytes()
