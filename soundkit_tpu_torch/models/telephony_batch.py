"""Batched multi-stream telephony decode and encode (G.711 / G.722 /
G.726) in PyTorch (counterpart of ``soundkit_tpu/models/telephony_batch.py``).

N concurrent headerless byte streams decode in one device step per
fixed-size chunk. Lanes are fully ragged: a step consumes up to
``chunk_codes`` codes per stream under a validity mask that freezes the
scan state of a lane past its code count, so slow producers never stall
the batch.

One step ships one uint8 wire ``[codes u8 B*chunk][pad to 4][counts
i32 B]`` to the device and unpacks it there in place. G.711 decodes
through K3 (``ops.companding.g711_decode``, the counts fused in), G.722
through K7 (``ops.g722``), G.726 through K6 (``ops.adpcm``); the ADPCM
state is one int32 tensor ``[B, width]`` that the decoder owns.

A decoder made with ``timed=True`` (CUDA only) times the stages of each
step: the host pack and the host-to-device copy on the host clock, the
device step with CUDA events; :meth:`BatchedTelephonyDecoder.stage_ms`
reads them.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from soundkit_tpu_torch.codecs.g726 import G726Packing, G726Rate, pack_codes, unpack_codes
from soundkit_tpu_torch.ops import adpcm, companding
from soundkit_tpu_torch.ops import g722 as g722_ops
from soundkit_tpu_torch.utils.device import resolve_device

CODECS = (
    "g711_mulaw",
    "g711_alaw",
    "g722",
    "g726_16",
    "g726_24",
    "g726_32",
    "g726_40",
)

_G726_RATES = {2: G726Rate.RATE_16000, 3: G726Rate.RATE_24000,
               4: G726Rate.RATE_32000, 5: G726Rate.RATE_40000}


def _g726_bits(codec: str) -> int:
    return int(codec.split("_")[1]) // 8


def _check_codec(codec: str) -> None:
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r}; one of {CODECS}")


def init_state(codec: str, batch: int, device) -> Optional[torch.Tensor]:
    """A fresh scan state for ``codec`` (None for G.711)."""
    if codec.startswith("g711"):
        return None
    if codec == "g722":
        return g722_ops.g722_init_state(batch, device)
    return adpcm.g726_init_state(batch, device)


def state_from_jax(st, device) -> torch.Tensor:
    """The JAX model's carried ``G726State`` or ``G722State`` (arrays
    read as numpy) as the port's state tensor on ``device``."""
    layout = g722_ops.G722_LAYOUT if "x" in st._fields else adpcm.G726_LAYOUT
    return layout.from_jax(st, device)


class BatchedTelephonyDecoder:
    """Decode ``num_streams`` ragged telephony byte streams of one codec
    on ``device`` ('cuda', the default, or 'cpu'), ``chunk_codes`` codes
    per step."""

    def __init__(self, codec: str, num_streams: int, chunk_codes: int = 2048, *, device="cuda",
                 timed: bool = False):
        _check_codec(codec)
        self.device = resolve_device(device)
        if timed and self.device.type != "cuda":
            raise ValueError("timed=True needs a CUDA device (the step is timed by CUDA events)")
        self.timed = timed
        # per timed step: (pack s, h2d s, step start event, step stop event)
        self._stage_times: List[tuple] = []
        self.codec = codec
        self.B = num_streams
        self.chunk = chunk_codes
        self._queues: List[bytearray] = [bytearray() for _ in range(num_streams)]
        self._g726_rate: Optional[G726Rate] = None
        self._off_counts = (num_streams * chunk_codes + 3) & ~3
        self._wire_total = self._off_counts + 4 * num_streams
        self._state = init_state(codec, num_streams, self.device)
        if codec.startswith("g711"):
            self._is_alaw = torch.full((num_streams,), int(codec.endswith("alaw")),
                                       dtype=torch.int32, device=self.device)
            self.samples_per_code = 1
            self.sample_rate = 8000
        elif codec == "g722":
            self.samples_per_code = 2
            self.sample_rate = 16000
        else:
            self._bits = _g726_bits(codec)
            self._g726_rate = _G726_RATES[self._bits]
            self.samples_per_code = 1
            self.sample_rate = 8000

    def push(self, stream_idx: int, data: bytes) -> None:
        self._queues[stream_idx].extend(data)

    @property
    def state(self) -> Optional[torch.Tensor]:
        """The scan state [B, width] int32 on the device (None for G.711)."""
        return self._state

    def set_state(self, state: torch.Tensor) -> None:
        """Continue from another decoder's carried state (see :func:`state_from_jax`)."""
        if self._state is None or tuple(state.shape) != tuple(self._state.shape):
            raise ValueError(f"state shape {tuple(state.shape)} for {self.codec}")
        self._state = state.to(self.device, torch.int32).contiguous()

    def reset_lane(self, b: int) -> None:
        """Recycle lane ``b``: empty queue, its state row back to the
        initial state (in place on the device)."""
        self._queues[b] = bytearray()
        if self._state is not None:
            self._state[b] = init_state(self.codec, 1, self.device)[0]

    def _pack_wire(self):
        """Take up to a chunk of codes from every queue into one wire
        buffer: (uint8 numpy wire, lens [B] int64 in produced samples)."""
        buf = np.zeros(self._wire_total, dtype=np.uint8)
        codes = buf[: self.B * self.chunk].reshape(self.B, self.chunk)
        counts = buf[self._off_counts:].view("<i4")
        lens = np.zeros(self.B, dtype=np.int64)
        for i, q in enumerate(self._queues):
            n = self._prepare_lane(i, q, codes)
            counts[i] = n
            lens[i] = n * self.samples_per_code
        return buf, lens

    def _step(self, wire: torch.Tensor) -> torch.Tensor:
        """The device step on one wire: PCM [B, chunk * samples_per_code]
        int16; advances the carried state. The codes and counts are
        views of the wire, read in place."""
        codes = wire[: self.B * self.chunk].view(self.B, self.chunk)
        counts = wire[self._off_counts: self._off_counts + 4 * self.B].view(torch.int32)
        if self.codec.startswith("g711"):
            return companding.g711_decode(codes, self._is_alaw, counts)
        valid = companding.valid_mask(counts, self.chunk)
        if self.codec == "g722":
            pcm, self._state = g722_ops.g722_decode_scan(codes, self._state, valid)
        else:
            pcm, self._state = adpcm.g726_decode_scan(codes, self._state, self._bits, valid)
        return pcm

    def decode_step(self, device_out: bool = False):
        """Decode up to chunk codes per stream: (pcm [B, chunk *
        samples_per_code] int16, lens [B] int64 of produced samples).
        The PCM is a tensor on the device if ``device_out``, else numpy."""
        t0 = time.perf_counter()
        buf, lens = self._pack_wire()
        t1 = time.perf_counter()
        wire = torch.from_numpy(buf).to(self.device)
        t2 = time.perf_counter()
        if self.timed:
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        pcm = self._step(wire)
        if self.timed:
            stop.record()
            self._stage_times.append((t1 - t0, t2 - t1, start, stop))
        return (pcm if device_out else pcm.cpu().numpy()), lens

    def stage_ms(self) -> dict:
        """Medians over the timed steps so far, in ms: ``pack`` (host
        queue drain and wire pack), ``h2d`` (host clock of the pageable
        copy) and ``step`` (CUDA events around the device step). Waits
        for the device."""
        if not self._stage_times:
            raise ValueError("no timed step yet")
        torch.cuda.synchronize(self.device)
        cols = list(zip(*self._stage_times))
        return {
            "steps": len(self._stage_times),
            "pack": 1e3 * float(np.median(cols[0])),
            "h2d": 1e3 * float(np.median(cols[1])),
            "step": float(np.median([a.elapsed_time(b) for a, b in zip(cols[2], cols[3])])),
        }

    def _prepare_lane(self, i, q, codes) -> int:
        """Fill lane i's uint8 code row; returns the code count."""
        rate = self._g726_rate
        if rate is None:
            n = min(len(q), self.chunk)
            codes[i, :n] = np.frombuffer(bytes(q[:n]), dtype=np.uint8)
            del q[:n]
            return n
        group = rate.bytes_per_group
        g = min(len(q) // group, self.chunk // rate.samples_per_byte_group)
        if not g:
            return 0
        nbytes = g * group
        cs = unpack_codes(bytes(q[:nbytes]), rate.bits_per_sample, G726Packing.LEFT)
        codes[i, : len(cs)] = cs
        del q[:nbytes]
        return len(cs)


class TelephonyLaneGroup:
    """Fleet lane-group adapter over :class:`BatchedTelephonyDecoder`:
    ``lane_ready`` counts pending decode rounds (``chunk`` codes each)
    and ``decode_batches`` stacks ``n`` steps into one [n, B, 1, S]
    int16 batch."""

    def __init__(self, codec: str, capacity: int, chunk_codes: int = 2048, *, device="cuda"):
        self.codec = codec
        self.B = capacity
        self._dec = BatchedTelephonyDecoder(codec, capacity, chunk_codes, device=device)

    def push(self, lane: int, data: bytes) -> None:
        self._dec.push(lane, data)

    def _pending_codes(self, lane: int) -> int:
        q = len(self._dec._queues[lane])
        rate = self._dec._g726_rate
        if rate is None:
            return q  # g711 / g722: one code per byte
        return (q // rate.bytes_per_group) * rate.samples_per_byte_group

    def lane_ready(self, lane: int) -> int:
        c = self._pending_codes(lane)
        return -(-c // self._dec.chunk) if c else 0

    def lane_sample_rate(self, lane: int) -> Optional[int]:
        return self._dec.sample_rate

    def reset_lane(self, lane: int) -> None:
        """Recycle one lane: empty queue and that lane's state row back to
        the initial state, in place on the device."""
        self._dec.reset_lane(lane)

    def decode_batches(self, n: int, device_out: bool = False):
        """Run ``n`` ragged scan rounds: (pcm [n, B, 1, S] int16, a tensor
        on the device if ``device_out`` else numpy, and lengths: a list
        of ``n`` [B] int64 arrays of produced samples)."""
        S = self._dec.chunk * self._dec.samples_per_code
        if n == 0:
            empty = torch.zeros((0, self.B, 1, S), dtype=torch.int16, device=self._dec.device)
            return (empty if device_out else empty.cpu().numpy()), []
        pcms, lens = [], []
        for _ in range(n):
            pcm, ln = self._dec.decode_step(device_out=True)
            pcms.append(pcm)
            lens.append(ln)
        out = torch.stack(pcms)[:, :, None, :]
        return (out if device_out else out.cpu().numpy()), lens


class BatchedTelephonyEncoder:
    """Encode ``num_streams`` ragged int16 PCM streams into G.711 / G.722
    / G.726 wire bytes on ``device`` ('cuda', the default, or 'cpu'),
    ``chunk_samples`` samples per step; G.726 bit packing happens on the
    host."""

    def __init__(self, codec: str, num_streams: int, chunk_samples: int = 2048, *,
                 device="cuda"):
        _check_codec(codec)
        if codec == "g722" and chunk_samples % 2:
            raise ValueError("g722 needs an even chunk (2 samples/code)")
        self.device = resolve_device(device)
        self.codec = codec
        self.B = num_streams
        self.chunk = chunk_samples
        self._queues: List[np.ndarray] = [np.zeros(0, dtype=np.int16) for _ in range(num_streams)]
        self._g726_rate: Optional[G726Rate] = None
        self._state = init_state(codec, num_streams, self.device)
        if codec.startswith("g711"):
            self.codes_per_sample = 1.0
        elif codec == "g722":
            self.codes_per_sample = 0.5
        else:
            self._bits = _g726_bits(codec)
            self._g726_rate = _G726_RATES[self._bits]
            self.codes_per_sample = 1.0

    def push(self, stream_idx: int, pcm: np.ndarray) -> None:
        self._queues[stream_idx] = np.concatenate(
            [self._queues[stream_idx], np.asarray(pcm, np.int16)])

    @property
    def state(self) -> Optional[torch.Tensor]:
        return self._state

    def encode_step(self) -> List[bytes]:
        """Encode up to chunk samples per stream -> wire bytes per lane."""
        pcm = np.zeros((self.B, self.chunk), dtype=np.int16)
        taken = np.zeros(self.B, dtype=np.int32)
        for i, q in enumerate(self._queues):
            n = min(len(q), self.chunk)
            if self.codec == "g722":
                n -= n % 2
            if self._g726_rate is not None:
                n -= n % self._g726_rate.samples_per_byte_group  # whole packing groups only
            pcm[i, :n] = q[:n]
            taken[i] = n
            self._queues[i] = q[n:]

        x = torch.from_numpy(pcm).to(self.device)
        counts = torch.from_numpy(taken).to(self.device)
        if self.codec.startswith("g711"):
            enc = (companding.encode_alaw if self.codec.endswith("alaw")
                   else companding.encode_mulaw)
            codes = torch.where(companding.valid_mask(counts, self.chunk), enc(x), 0)
        elif self.codec == "g722":
            # the scan masks per code (one code = a sample pair)
            valid = companding.valid_mask(counts // 2, self.chunk // 2)
            codes, self._state = g722_ops.g722_encode_scan(x, self._state, valid)
        else:
            valid = companding.valid_mask(counts, self.chunk)
            codes, self._state = adpcm.g726_encode_scan(x, self._state, self._bits, valid)
        codes = codes.to(torch.uint8).cpu().numpy()

        out: List[bytes] = []
        for i in range(self.B):
            n = int(taken[i])
            if n == 0:
                out.append(b"")
            elif self._g726_rate is not None:
                out.append(pack_codes(codes[i, :n], self._bits, G726Packing.LEFT))
            else:
                out.append(codes[i, : int(n * self.codes_per_sample)].tobytes())
        return out
