"""Batched multi-stream FLAC decoder in PyTorch (counterpart of
``soundkit_tpu/models/flac_batch.py``): host walk, entropy decode and
LPC on the device.

N concurrent FLAC byte streams are walked by the C++ host layer (frame
and subframe headers, the coding-span table; ``native_src/src/flac.cpp``
``skt_flac_drain``, at push time) and decoded on the device: the Rice
and fixed-width residual payloads by K8 (``ops.flac_rice``), the LPC
reconstruction, wasted bits and stereo decorrelation by K9
(``ops.flac_lpc``). Bit-exact. The wire ships the compressed frame
bytes; ``skt_flac_export_rounds`` scatters a whole collect's wire (word
planes, the dense segment table, LPC metadata) in one call.

Frames the segment wire cannot carry (longer than ``max_frame_bytes``,
more than ``seg_cap`` coding spans, fixed reads wider than 32 bits)
queue as residual-plane records and merge on the device in a second,
small K9 call.

A decoder made with ``timed=True`` (CUDA only) times the stages: each
push's walk, each collect's export and host-to-device copies on the host
clock, the device step with CUDA events; :meth:`stage_ms` reads them.
"""
from __future__ import annotations

import ctypes
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from soundkit_tpu_torch.codecs.flac import FlacError
from soundkit_tpu_torch.native import flac_library
from soundkit_tpu_torch.ops import flac_lpc, flac_rice
from soundkit_tpu_torch.utils.device import resolve_device

SEG_CAP = 8192
MAX_FRAME_BYTES = 65536


class FlacWire(NamedTuple):
    """One collect's wire on the host, as :meth:`BatchedFlacDecoder.export_wire`
    scatters it."""

    #: words [L, W] (big-endian frame words as int32), the five segment
    #: arrays [S], warm [L, 2, 32], const_flag / const_val [L, 2], coef
    #: [L, 2, 32], order / shift / wasted [L, 2], chan_assign /
    #: block_size [L] int32, lane_valid [L] bool: the arguments of
    #: ``ops.flac_rice.flac_frames_segs`` in order, as numpy
    segs: tuple
    #: per round, [B, 12] int32: block size, channels, assignment, bits
    #: per sample, then (order, shift, wasted) per channel
    metas: list
    #: frames the segment wire cannot carry: (slot [P], meta [P, 12],
    #: resw [P, 2, stride], coef [P, 2, 32])
    parts: tuple


class BatchedFlacDecoder:
    """Decode ``num_streams`` parallel FLAC streams in lockstep batches
    of one frame a lane on ``device`` ('cuda', the default, or 'cpu');
    ``stride`` is the longest block a lane's row can hold."""

    def __init__(self, num_streams: int, stride: int = 4608, *, device="cuda",
                 timed: bool = False):
        self.device = resolve_device(device)
        if timed and self.device.type != "cuda":
            raise ValueError("timed=True needs a CUDA device (the step is timed by CUDA events)")
        self.timed = timed
        self._walk_times: List[float] = []
        # per timed collect: (export s, h2d s, step start event, step stop event)
        self._stage_times: List[tuple] = []
        self.B = num_streams
        self.stride = stride
        self._lib = flac_library()
        self._h = [self._lib.skt_flac_new() for _ in range(num_streams)]
        self._handles = (ctypes.c_void_p * num_streams)(*self._h)
        # per-instance caps so tests can force the parts fallback
        self.seg_cap = SEG_CAP
        self.max_frame_bytes = MAX_FRAME_BYTES

    def __del__(self):
        for i, h in enumerate(getattr(self, "_h", [])):
            if h:
                self._lib.skt_flac_free(h)
                self._h[i] = None

    def push(self, stream_idx: int, data: bytes) -> None:
        t0 = time.perf_counter()
        h = self._h[stream_idx]
        if self._lib.skt_flac_feed(h, data, len(data)) != 0:
            raise FlacError(self._lib.skt_flac_error(h).decode())
        if self._lib.skt_flac_drain(h, self.stride, self.seg_cap, self.max_frame_bytes) < 0:
            raise FlacError(self._lib.skt_flac_error(h).decode())
        if self.timed:
            self._walk_times.append(time.perf_counter() - t0)

    @property
    def ready_frames(self) -> int:
        return min(self.lane_ready(b) for b in range(self.B))

    def lane_ready(self, b: int) -> int:
        return int(self._lib.skt_flac_queued(self._h[b]))

    def lane_sample_rate(self, b: int) -> Optional[int]:
        """Sample rate of lane ``b``'s stream (None until STREAMINFO
        parses); mixed-rate groups report each lane's true rate."""
        ch, bits = ctypes.c_int(), ctypes.c_int()
        rate, total = ctypes.c_long(), ctypes.c_longlong()
        if self._lib.skt_flac_info(self._h[b], ch, bits, rate, total):
            return int(rate.value)
        return None

    def reset_lane(self, b: int) -> None:
        """Recycle lane ``b``: fresh entropy stream + empty queue (FLAC
        frames are independent; there is no device carry to clear)."""
        self._lib.skt_flac_free(self._h[b])
        self._h[b] = self._lib.skt_flac_new()
        self._handles[b] = ctypes.c_void_p(self._h[b])

    def decode_ready(self, max_frames: Optional[int] = None, device_out: bool = False):
        """Decode lockstep frame batches (bounded by the least-ready
        lane; use :meth:`decode_batches` for ragged fleets).

        Returns (samples [frames, B, 2, stride] int32, meta list of
        per-frame [B, 12] arrays: block size, channels, assignment and
        bits per sample live there).
        """
        n = self.ready_frames
        if max_frames is not None:
            n = min(n, max_frames)
        return self.decode_batches(n, device_out=device_out)

    def export_wire(self, n: int) -> "FlacWire":
        """Take up to ``n`` queued frames from every lane as one wire on
        the host: slot ``i * B + b`` is round ``i`` of lane ``b``."""
        B = self.B
        L = n * B
        stats = np.zeros(4, np.int64)
        self._lib.skt_flac_queue_stats(self._handles, B, n, stats)
        W = max((int(stats[0]) + 3) // 4, 1)
        S = max(int(stats[2]), 1)  # rows past the segments keep n = 0
        n_parts = int(stats[3])

        words = np.zeros((L, W), np.uint32)
        seg = tuple(np.zeros(S, np.int32) for _ in range(5))
        warm = np.zeros((L, 2, 32), np.int32)
        cflag = np.zeros((L, 2), np.int32)
        cval = np.zeros((L, 2), np.int32)
        coef = np.zeros((L, 2, 32), np.int32)
        order = np.zeros((L, 2), np.int32)
        shift = np.zeros((L, 2), np.int32)
        wasted = np.zeros((L, 2), np.int32)
        assign = np.zeros(L, np.int32)
        bs = np.zeros(L, np.int32)
        valid = np.zeros(L, np.uint8)
        meta_all = np.zeros((n, B, 12), np.int32)
        np1 = max(n_parts, 1)
        p_slot = np.zeros(np1, np.int32)
        p_meta = np.zeros((np1, 12), np.int32)
        p_resw = np.zeros((np1, 2, self.stride), np.int32)
        p_coef = np.zeros((np1, 2, 32), np.int32)
        r = self._lib.skt_flac_export_rounds(
            self._handles, B, n, self.stride, W,
            words.reshape(-1),
            seg[0], seg[1], seg[2], seg[3], seg[4],
            warm.reshape(-1), cflag.reshape(-1), cval.reshape(-1),
            coef.reshape(-1), order.reshape(-1), shift.reshape(-1),
            wasted.reshape(-1), assign, bs, valid,
            meta_all.reshape(-1),
            p_slot, p_meta.reshape(-1), p_resw.reshape(-1),
            p_coef.reshape(-1),
        )
        if r < 0:
            raise FlacError("export_rounds wire overflow")
        return FlacWire(
            (words.view(np.int32), *seg, warm, cflag, cval, coef, order, shift, wasted, assign, bs,
             valid.view(np.bool_)),
            [meta_all[i] for i in range(n)],
            (p_slot[:n_parts], p_meta[:n_parts], p_resw[:n_parts], p_coef[:n_parts]))

    def _to_device(self, arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in arrays]

    def decode_batches(self, n: int, device_out: bool = False):
        """Decode exactly ``n`` lockstep batches; lanes with nothing
        pending decode as invalid (silent, meta row zero).

        FLAC frames carry no device state, so every round folds into
        the lane axis of one K8 and one K9 call. With ``device_out`` the
        samples are a tensor on the device, else numpy.
        """
        B = self.B
        if n == 0:
            empty = torch.zeros((0, B, 2, self.stride), dtype=torch.int32, device=self.device)
            return (empty if device_out else empty.cpu().numpy()), []
        t0 = time.perf_counter()
        wire = self.export_wire(n)
        t1 = time.perf_counter()
        d_words, *d_rest = self._to_device(wire.segs)
        t2 = time.perf_counter()
        if self.timed:
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        out = flac_rice.flac_frames_segs(d_words, tuple(d_rest[:5]), *d_rest[5:], self.stride)
        if len(wire.parts[0]):
            self._merge_parts(out, *wire.parts)
        if self.timed:
            stop.record()
            self._stage_times.append((t1 - t0, t2 - t1, start, stop))
        out = out.reshape(n, B, 2, self.stride)
        return (out if device_out else out.cpu().numpy()), wire.metas

    def _merge_parts(self, out, slots, p_meta, p_resw, p_coef):
        """Second small K9 call for fallback frames (residual-plane
        wire), written into their slots of the segment output on the
        device."""
        order, shift, wasted = (p_meta[:, i::3][:, :2] for i in (4, 5, 6))
        *args, d_slots = self._to_device((
            p_resw, p_coef, order, shift, wasted, p_meta[:, 2], p_meta[:, 0],
            np.ones(len(slots), np.bool_), slots.astype(np.int64)))
        out[d_slots] = flac_lpc.flac_frame(*args)

    def stage_ms(self) -> dict:
        """Medians over the timed pushes and collects so far, in ms:
        ``walk`` (one push: feed and the C++ frame walk), ``export`` (a
        collect's wire sized and scattered), ``h2d`` (host clock of the
        pageable copies) and ``step`` (CUDA events around K8, K9 and the
        parts merge). Waits for the device."""
        if not self._stage_times:
            raise ValueError("no timed collect yet")
        torch.cuda.synchronize(self.device)
        cols = list(zip(*self._stage_times))
        return {
            "collects": len(self._stage_times),
            "walk": 1e3 * float(np.median(self._walk_times)) if self._walk_times else 0.0,
            "export": 1e3 * float(np.median(cols[0])),
            "h2d": 1e3 * float(np.median(cols[1])),
            "step": float(np.median([a.elapsed_time(b) for a, b in zip(cols[2], cols[3])])),
        }
