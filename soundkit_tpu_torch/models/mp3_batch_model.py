"""Batched multi-stream MP3 decoder in PyTorch (counterpart of
``soundkit_tpu/models/mp3_batch_model.py``).

N concurrent MP3 byte streams are parsed by the C++ host layer (one
``native_src/src/mp3_parse.cpp`` parser a stream, each with its own bit
reservoir) into compact granule lanes (int16 quant and
quarter-exponents), and decoded in lockstep granule batches on the
device: one launch of K10 (``ops.mp3_synth.mp3_granule_packed``) a
granule takes a row of the packed wire through requantize, M/S, alias
reduction, the IMDCT and the polyphase synthesis, with the overlap and
FIFO carried per lane on the device.

:meth:`BatchedMp3Decoder.decode_batches` pops a collect's granules with
one C call into a ``[G, stride]`` packed wire, copies it to the device
once, and steps its rows in order, each writing its PCM into its slice
of the collect's output. A decoder made with ``timed=True``
(CUDA only) times the stages: each push's parse, each collect's pop and
host-to-device copy on the host clock, each step with CUDA events;
:meth:`stage_ms` reads them.
"""
from __future__ import annotations

import ctypes
import time
from typing import List, Optional

import numpy as np
import torch

from soundkit_tpu_torch.codecs.mp3_native import NativeMp3Parser
from soundkit_tpu_torch.ops import mp3_batch as mb
from soundkit_tpu_torch.utils.device import resolve_device


class BatchedMp3Decoder:
    """Decode ``num_streams`` parallel MP3 streams of ``channels``
    channels (a mono stream in a stereo decoder gives silence on its
    second channel) on ``device`` ('cuda', the default, or 'cpu')."""

    def __init__(self, num_streams: int, channels: int = 2, *, device="cuda",
                 timed: bool = False):
        self.device = resolve_device(device)
        if timed and self.device.type != "cuda":
            raise ValueError("timed=True needs a CUDA device (the step is timed by CUDA events)")
        self.timed = timed
        self._parse_times: List[float] = []
        # per timed collect: (pop s, h2d s, [(step start event, step stop event)])
        self._stage_times: List[tuple] = []
        self.B = num_streams
        self.C = channels
        self._parsers = [NativeMp3Parser() for _ in range(num_streams)]
        self._lib = self._parsers[0]._lib
        self._handles = (ctypes.c_void_p * num_streams)(*[p._h for p in self._parsers])
        self._counts = [0] * num_streams
        self._overlap, self._fifo = mb.init_state(num_streams, channels, self.device)
        self.sample_rate: Optional[int] = None  # first rate seen
        self._rates = np.zeros(num_streams, dtype=np.int32)  # per lane

    def push(self, stream_idx: int, data: bytes) -> None:
        t0 = time.perf_counter()
        self._counts[stream_idx] = self._parsers[stream_idx].push(data)
        if self.timed:
            self._parse_times.append(time.perf_counter() - t0)

    @property
    def ready_granules(self) -> int:
        return min(self._counts)

    def lane_ready(self, b: int) -> int:
        return self._counts[b]

    def lane_sample_rate(self, b: int) -> Optional[int]:
        """Sample rate of lane ``b``'s stream (None until its first
        granule pops); mixed-rate groups report each lane's true rate."""
        r = int(self._rates[b])
        return r if r > 0 else None

    def reset_lane(self, b: int) -> None:
        """Recycle lane ``b``: fresh C parser (reservoir and queue) and
        zeroed device carry (overlap and polyphase FIFO)."""
        self._parsers[b] = NativeMp3Parser()
        self._handles[b] = ctypes.c_void_p(self._parsers[b]._h)
        self._counts[b] = 0
        self._rates[b] = 0
        self._overlap[b] = 0.0
        self._fifo[b] = 0.0

    def _note_rates(self, rate: np.ndarray) -> None:
        live = rate > 0
        self._rates[live] = rate[live]
        if self.sample_rate is None and live.any():
            self.sample_rate = int(rate[live][0])

    def _pop_rounds(self, G: int) -> np.ndarray:
        """One C call pops up to ``G`` granules from every lane into
        ``G`` packed wire rows; returns the [G, stride] uint8 wire and
        updates the per-lane counts and rates."""
        layout, stride = mb.mp3_wire_layout(self.B)
        offs = {name: off for name, off, _, _ in layout}
        wire = np.zeros((G, stride), dtype=np.uint8)
        rate = np.zeros(self.B, dtype=np.int32)
        popped = np.zeros(self.B, dtype=np.int32)
        self._lib.skt_mp3_pop_rounds(
            self._handles, self.B, G, wire.reshape(-1), stride,
            offs["bt"], offs["nal"], offs["quant"], offs["expq"],
            offs["mixed"], offs["ms"], offs["valid"], rate, popped,
        )
        self._note_rates(rate)
        for b in range(self.B):
            self._counts[b] -= int(popped[b])
        return wire

    def decode_ready(self, max_granules: Optional[int] = None, device_out: bool = False):
        """Decode lockstep granule batches (bounded by the least-ready
        lane) -> [granules, B, C, 576] f32."""
        n = self.ready_granules
        if max_granules is not None:
            n = min(n, max_granules)
        return self.decode_batches(n, device_out=device_out)

    def decode_batches(self, n: int, device_out: bool = False):
        """Decode exactly ``n`` lockstep batches; lanes whose queue is
        empty decode as silence with frozen state. Returns [n, B, C,
        576] float32: a tensor on the device with ``device_out``, else
        numpy."""
        if n == 0:
            empty = torch.zeros((0, self.B, self.C, 576), dtype=torch.float32, device=self.device)
            return empty if device_out else empty.cpu().numpy()
        t0 = time.perf_counter()
        wire = self._pop_rounds(n)
        t1 = time.perf_counter()
        d_wire = torch.from_numpy(wire).to(self.device)
        t2 = time.perf_counter()
        events = []
        out = torch.empty((n, self.B, self.C, 576), dtype=torch.float32, device=self.device)
        for g in range(n):
            if self.timed:
                start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            _, self._overlap, self._fifo = mb.mp3_granule_device_compact_packed(
                d_wire[g], self._overlap, self._fifo, pcm_out=out[g])
            if self.timed:
                stop.record()
                events.append((start, stop))
        if self.timed:
            self._stage_times.append((t1 - t0, t2 - t1, events))
        return out if device_out else out.cpu().numpy()

    def decode_multi(self, n: int, device_out: bool = False):
        """The reference's whole-collect decode; here the same as
        :meth:`decode_batches`."""
        return self.decode_batches(n, device_out)

    def stage_ms(self) -> dict:
        """Medians over the timed pushes and collects so far, in ms:
        ``parse`` (one push through the C++ parser), ``pop`` (a collect's
        wire popped), ``h2d`` (host clock of its pageable copy) and
        ``step`` (CUDA events around one granule's step). Waits for the
        device."""
        if not self._stage_times:
            raise ValueError("no timed collect yet")
        torch.cuda.synchronize(self.device)
        pops, h2ds, events = zip(*self._stage_times)
        steps = [a.elapsed_time(b) for ev in events for a, b in ev]
        return {
            "collects": len(self._stage_times),
            "granules": len(steps),
            "parse": 1e3 * float(np.median(self._parse_times)) if self._parse_times else 0.0,
            "pop": 1e3 * float(np.median(pops)),
            "h2d": 1e3 * float(np.median(h2ds)),
            "step": float(np.median(steps)),
        }
