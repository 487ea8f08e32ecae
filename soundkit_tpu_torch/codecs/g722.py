"""G.722 sub-band ADPCM streaming codec, 64 kbit/s, 16 kHz mono
(counterpart of ``soundkit_tpu/codecs/g722.py``).

``G722Decoder`` (1 byte -> 2 samples) and ``G722Encoder`` (with the
odd-sample carry and ``flush``) run K7 (``ops.g722.g722_decode_scan`` /
``g722_encode_scan``) on one lane of the codec's device, the card unless
the caller names the CPU. The state is one ``[1, 70]`` int32 row
(``ops.g722.G722_LAYOUT``) kept on that device from chunk to chunk.
Each chunk is launched at its exact length: the JAX package pads to a
power-of-two bucket only to bound its recompiles, and its padded codes
are invalid, so the outputs and the state are the same.
"""
from __future__ import annotations

import numpy as np
import torch

from soundkit_tpu_torch.ops import g722 as g722_ops
from soundkit_tpu_torch.utils.device import resolve_device

G722_SAMPLE_RATE = 16000
G722_CHANNELS = 1


class G722Decoder:
    """Streaming decoder; stateless buffering (every byte is a unit)."""

    def __init__(self, device="cuda") -> None:
        self.device = resolve_device(device)
        self._state = g722_ops.g722_init_state(1, self.device)

    sample_rate = property(lambda self: G722_SAMPLE_RATE)
    channels = property(lambda self: G722_CHANNELS)

    @classmethod
    def new_64k(cls, device="cuda") -> "G722Decoder":
        return cls(device)

    def decode_i16(self, data: bytes) -> np.ndarray:
        if not data:
            return np.zeros(0, dtype=np.int16)
        codes = np.frombuffer(bytes(data), dtype=np.uint8)
        lane = torch.from_numpy(codes.copy()).to(self.device).reshape(1, -1)
        pcm, self._state = g722_ops.g722_decode_scan(lane, self._state)
        return pcm[0].cpu().numpy()

    def decode_i32(self, data: bytes) -> np.ndarray:
        return self.decode_i16(data).astype(np.int32) << 16

    def decode_f32(self, data: bytes) -> np.ndarray:
        return (self.decode_i16(data).astype(np.float32) / np.float32(32768.0)).astype(
            np.float32)

    def reset(self) -> None:
        self._state = g722_ops.g722_init_state(1, self.device)


class G722Encoder:
    """Streaming encoder; carries an odd trailing sample, so K7 always
    takes an even number of samples."""

    def __init__(self, device="cuda") -> None:
        self.device = resolve_device(device)
        self._state = g722_ops.g722_init_state(1, self.device)
        self._pending: np.ndarray = np.zeros(0, dtype=np.int16)

    @classmethod
    def new_64k(cls, device="cuda") -> "G722Encoder":
        return cls(device)

    def encode_i16(self, samples: np.ndarray) -> bytes:
        samples = np.concatenate([self._pending, np.asarray(samples, dtype=np.int16)])
        complete = len(samples) - (len(samples) % 2)
        self._pending = samples[complete:]
        if complete == 0:
            return b""
        return self._encode_exact(samples[:complete])

    def encode_i32(self, samples: np.ndarray) -> bytes:
        return self.encode_i16((np.asarray(samples, dtype=np.int32) >> 16).astype(np.int16))

    def flush(self) -> bytes:
        """Zero-pad the trailing odd sample and encode it (lib.rs:31-44)."""
        if len(self._pending) == 0:
            return b""
        pair = np.zeros(2, dtype=np.int16)
        pair[0] = self._pending[0]
        self._pending = np.zeros(0, dtype=np.int16)
        return self._encode_exact(pair)

    def _encode_exact(self, samples: np.ndarray) -> bytes:
        lane = torch.from_numpy(np.ascontiguousarray(samples)).to(self.device).reshape(1, -1)
        codes, self._state = g722_ops.g722_encode_scan(lane, self._state)
        return codes[0].cpu().numpy().astype(np.uint8).tobytes()

    def reset(self) -> None:
        self._state = g722_ops.g722_init_state(1, self.device)
        self._pending = np.zeros(0, dtype=np.int16)
