"""Batched multi-stream Opus CELT decoder in PyTorch (counterpart of
``BatchedCeltDecoder`` in ``soundkit_tpu/models/opus_batch.py``).

N concurrent CELT streams are parsed on the host by the port's build of
``native_src/src/celt_parse.cpp`` (range decode, allocation, PVQ,
anti-collapse, denormalization; one parse state a lane), which writes a
whole collect's spectral wire in one call, and synthesized in lockstep
20 ms rounds on the device: a round is one step of
``ops.celt_batch.celt_synth_step`` (the IMDCT products, then K11, the
overlap-add, comb postfilter and de-emphasis, one launch a round), with
the overlap, the comb history and the de-emphasis memory carried per
lane on the device in the JAX layout, ``[B, C, 120]``, ``[B, C, 1200]``
and ``[B, C]``.

The decoder serves single-frame 20 ms CELT packets; SILK, hybrid and
other frame sizes raise ``OpusUnsupported`` at push time. A mono-coded
packet in a stereo lane is duplicated across the channels by the parse.
Two spectral wires: ``wire="f32"`` (exact), and ``wire="i16"``, int16
spectra with one float32 scale a (lane, band), dequantized on the device.
Either wire is trimmed to the widest coded band of the collect and
padded back to 960 bins on the device.

The JAX package's Python ``CeltDecoder`` fallback is not ported: the port
always builds its library, and a failed build raises ``BuildError``. Its
eight-round device scan (``_celt_multi_step``) is a host loop over the
rounds here, as the MP3 decoder's is.

A decoder made with ``timed=True`` (CUDA only) times each collect's host
walk and host-to-device copy on the host clock and each round's step with
CUDA events; :meth:`BatchedCeltDecoder.stage_ms` reads them.
"""
from __future__ import annotations

import functools
import struct
import time
from typing import List, Optional

import numpy as np
import torch

from soundkit_tpu_torch.codecs.celt_native import NativeCeltBatch
from soundkit_tpu_torch.codecs.opus_celt import tables
from soundkit_tpu_torch.ops import celt_batch as cb
from soundkit_tpu_torch.utils.device import resolve_device


@functools.lru_cache(maxsize=8)
def _band_of_bin(width: int):
    """Static bin→band map for the quantized wire: band k covers
    [freq_bands[k]*8, freq_bands[k+1]*8) at the 960 frame size."""
    fb = tables()["celt_freq_bands"].astype(np.int64) * 8
    return np.clip(
        np.searchsorted(fb, np.arange(width), side="right") - 1, 0, 20
    ).astype(np.int32)


class BatchedCeltDecoder:
    """Lockstep decode of ``num_streams`` CELT streams of ``channels``
    channels on ``device`` ('cuda', the default, or 'cpu')."""

    FRAME = 960

    def __init__(self, num_streams: int, channels: int = 1, wire: str = "f32", *,
                 device="cuda", timed: bool = False):
        if wire not in ("f32", "i16"):
            raise ValueError(f"wire must be 'f32' or 'i16', not {wire!r}")
        self.device = resolve_device(device)
        if timed and self.device.type != "cuda":
            raise ValueError("timed=True needs a CUDA device (the step is timed by CUDA events)")
        self.timed = timed
        self._stage_times: List[tuple] = []  # per timed collect: (walk s, h2d s, [events])
        self.B = num_streams
        self.C = channels
        self.sample_rate = 48000
        self._wire_i16 = wire == "i16"
        self._native = NativeCeltBatch(num_streams, channels)
        # plain ints: numpy scalar indexing + int() in the per-packet
        # TOC split costs ~1 us/packet at fleet scale
        self._band_end_i = [int(v) for v in tables()["celt_band_end"]]
        self._buf = [bytearray() for _ in range(num_streams)]
        # per lane: queued (frame_bytes, end_band, coded_channels),
        # split from the TOC once, at push time
        self._packets: List[List[tuple]] = [[] for _ in range(num_streams)]
        self._head_done = [False] * num_streams
        self._skip = [0] * num_streams
        self._gain = np.ones(num_streams, np.float64)
        dev = self.device
        self._ola = torch.zeros((num_streams, channels, cb.OVERLAP), dtype=torch.float32,
                                device=dev)
        self._hist = torch.zeros((num_streams, channels, cb.HIST), dtype=torch.float32, device=dev)
        self._emph = torch.zeros((num_streams, channels), dtype=torch.float32, device=dev)
        # lanes recycled since the last decode: their state rows are
        # zeroed on the device at the next decode
        self._fresh = np.zeros(self.B, bool)

    def push(self, stream_idx: int, data: bytes) -> None:
        """Feed the soundkit raw-Opus wire: optional OpusHead(19B),
        then u16-LE length-prefixed packets."""
        buf = self._buf[stream_idx]
        buf.extend(data)
        if not self._head_done[stream_idx]:
            if len(buf) < 8:
                return
            if bytes(buf[:8]) == b"OpusHead":
                if len(buf) < 19:
                    return
                self._skip[stream_idx] = struct.unpack_from("<H", buf, 10)[0]
                gain_q8 = struct.unpack_from("<h", buf, 16)[0]
                if gain_q8:
                    self._gain[stream_idx] = 10.0 ** (gain_q8 / (20.0 * 256.0))
                del buf[:19]
            self._head_done[stream_idx] = True
        while len(buf) >= 2:
            (n,) = struct.unpack_from("<H", buf, 0)
            if len(buf) < 2 + n:
                break
            self._packets[stream_idx].append(
                self._frame_of(bytes(buf[2 : 2 + n])))
            del buf[: 2 + n]

    def push_packet(self, stream_idx: int, packet: bytes) -> None:
        """Enqueue one already-framed Opus packet."""
        self._packets[stream_idx].append(self._frame_of(packet))

    def push_frame(self, stream_idx: int, frame: bytes, end: int,
                   coded: int) -> None:
        """Enqueue one already TOC-split CELT frame (the fleet's Ogg
        layer classifies every packet anyway — no second split)."""
        self._packets[stream_idx].append((frame, end, coded))

    def configure_lane(self, b: int, pre_skip: int = 0,
                       gain_q8: int = 0) -> None:
        """Set the OpusHead-derived lane config when packets arrive via
        push_packet (an external demuxer owns the head, e.g. Ogg)."""
        self._skip[b] = pre_skip
        if gain_q8:
            self._gain[b] = 10.0 ** (gain_q8 / (20.0 * 256.0))
        self._head_done[b] = True

    def reset_lane(self, b: int) -> None:
        """Recycle one lane for a new stream: a fresh parse state, an
        empty queue, and its device state zeroed at the next decode."""
        self._native.reset_lane(b)
        self._buf[b] = bytearray()
        self._packets[b] = []
        self._head_done[b] = False
        self._skip[b] = 0
        self._gain[b] = 1.0
        self._fresh[b] = True

    def queued(self, b: int) -> int:
        return len(self._packets[b])

    @property
    def ready_packets(self) -> int:
        return min(len(p) for p in self._packets)

    def _frame_of(self, pkt: bytes):
        """TOC split: one packet -> (CELT frame bytes, end band,
        coded channels)."""
        from soundkit_tpu_torch.codecs.opus_core import (
            TOC_ATTRS,
            OpusUnsupported,
            parse_packet,
        )

        if pkt:
            mode, dur, stereo, bw, code = TOC_ATTRS[pkt[0]]
            if code == 0:
                # fast path: code-0 = exactly one frame, body is pkt[1:]
                if mode != "celt" or dur != 20:
                    raise OpusUnsupported(
                        "BatchedCeltDecoder serves single-frame 20 ms "
                        "CELT packets"
                    )
                coded = 2 if stereo else 1
                if coded > self.C:
                    raise OpusUnsupported("stereo packet in a mono lane")
                return pkt[1:], self._band_end_i[bw], coded
        toc, frames = parse_packet(pkt)
        if toc.mode != "celt" or toc.frame_duration != 20 or len(frames) != 1:
            raise OpusUnsupported(
                "BatchedCeltDecoder serves single-frame 20 ms CELT packets"
            )
        coded = 2 if toc.stereo else 1
        if coded > self.C:
            raise OpusUnsupported("stereo packet in a mono lane")
        return frames[0], self._band_end_i[toc.bandwidth], coded

    def _walk(self, n: int):
        """Pop up to ``n`` rounds of every lane's queue and parse them in
        one native call: (freq [n, B, C, W] f32 or i16, scales [n, B, 21]
        f32 or None, comb [n, B, 16] f32, sflag [n, B] i32, valid [n, B]
        bool, W), with the OpusHead gains folded in."""
        from soundkit_tpu_torch.codecs.opus_core import OpusUnsupported

        B = self.B
        quant = self._wire_i16
        fb = tables()["celt_freq_bands"].astype(np.int64)
        lens = np.zeros((B, n), np.int32)
        ends = np.zeros((B, n), np.int32)
        codedm = np.zeros((B, n), np.int32)
        base = np.zeros(B, np.int64)
        parts = []
        pos = 0
        for b in range(B):
            q = self._packets[b]
            k = min(len(q), n)
            if k == 0:
                continue
            take = q[:k]
            del q[:k]
            lens[b, :k] = [len(t[0]) for t in take]
            ends[b, :k] = [t[1] for t in take]
            codedm[b, :k] = [t[2] for t in take]
            base[b] = pos
            lane_buf = b"".join(t[0] for t in take)
            parts.append(lane_buf)
            pos += len(lane_buf)
        buf = b"".join(parts)
        valid = (lens > 0).T.copy()  # [n, B]
        end_max = int(ends.max())
        W = int(fb[end_max]) * 8 if end_max else self.FRAME
        freq, scales, comb, sflag, ok = self._native.parse_rounds(
            buf, base, lens, ends, codedm, n, W, quant)
        bad = valid & (ok != 0)
        if bad.any():
            i0, b0 = np.argwhere(bad)[0]
            raise OpusUnsupported(
                f"native celt parse failed on lane {int(b0)} "
                f"round {int(i0)} ({int(ok[i0, b0])})"
            )
        # fold the OpusHead output gain into the spectra: the whole
        # synthesis chain (IMDCT/overlap/comb/de-emphasis) is linear,
        # and the carried state scales consistently lane-wise (on the
        # quantized wire the gain rides the per-band scales instead)
        if np.any(self._gain != 1.0):
            g = self._gain.astype(np.float32)
            if quant:
                scales *= g[None, :, None]
            else:
                freq *= g[None, :, None, None]
        return freq, scales, comb, sflag, valid, W

    def _lengths(self, valid: np.ndarray) -> np.ndarray:
        """Per-slot valid lengths [n, B]: they depend only on packet
        presence and the remaining pre-skip, consumed greedily across
        the valid rounds."""
        n = valid.shape[0]
        vn = valid.astype(np.int64)
        cap = vn * self.FRAME  # per-slot capacity
        cum = np.cumsum(cap, axis=0)  # capacity incl this round
        skip0 = np.array(self._skip, np.int64)
        consumed = np.clip(skip0[None, :] - (cum - cap), 0, cap)
        lengths = (cap - consumed).astype(np.int32)
        if n:
            self._skip = list(np.maximum(skip0 - cum[-1], 0))
        return lengths

    def decode_ready(self, max_packets: Optional[int] = None,
                     device_out: bool = False):
        """Decode lockstep packet rounds: up to ``max_packets`` rounds of
        every lane's queue (all of the longest queue by default).

        Returns (pcm [rounds, B, C, 960] f32, lengths [rounds, B] i32).
        Lanes with no queued packet in a round emit silence (length 0)
        and keep their synthesis state frozen; a lane's first slots are
        short by its head's pre-skip.

        ``device_out=False``: pcm is a numpy array with the valid samples
        at the START of each slot. ``device_out=True``: pcm stays a
        tensor on the device, and the valid samples sit at the END of
        each slot (``slot[..., 960 - length:]``), because the pre-skip
        trim is not applied on the device; length-960 slots are the same
        under both conventions."""
        counts = [len(p) for p in self._packets]
        n = max(counts) if counts else 0
        if max_packets is not None:
            n = min(n, max_packets)
        if n == 0:
            empty = torch.zeros((0, self.B, self.C, self.FRAME), dtype=torch.float32,
                                device=self.device)
            return (empty if device_out else empty.cpu().numpy()), np.zeros((0, self.B), np.int32)
        t0 = time.perf_counter()
        freq, scales, comb, sflag, valid, W = self._walk(n)
        lengths = self._lengths(valid)
        t1 = time.perf_counter()
        dev = self.device
        d_freq = torch.from_numpy(freq).to(dev)
        d_scales = None if scales is None else torch.from_numpy(scales).to(dev)
        d_comb = torch.from_numpy(comb).to(dev)
        d_sflag = torch.from_numpy(sflag).to(dev)
        d_valid = torch.from_numpy(valid).to(dev)
        t2 = time.perf_counter()
        bidx = None
        if d_scales is not None:
            bidx = torch.from_numpy(_band_of_bin(W).astype(np.int64)).to(dev)
        if self._fresh.any():
            keep = torch.from_numpy(~self._fresh).to(dev, torch.float32)
            self._ola = self._ola * keep[:, None, None]
            self._hist = self._hist * keep[:, None, None]
            self._emph = self._emph * keep[:, None]
            self._fresh[:] = False
        events = []
        out = torch.empty((n, self.B, self.C, self.FRAME), dtype=torch.float32, device=dev)
        for r in range(n):
            if self.timed:
                start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            f = d_freq[r] if bidx is None else cb.dequant_wire(d_freq[r], d_scales[r], bidx)
            _, self._ola, self._hist, self._emph = cb.celt_synth_step(
                cb.pad_wire(f), d_sflag[r], d_comb[r], d_valid[r], self._ola, self._hist,
                self._emph, pcm_out=out[r])
            if self.timed:
                stop.record()
                events.append((start, stop))
        if self.timed:
            self._stage_times.append((t1 - t0, t2 - t1, events))
        if device_out:
            return out, lengths
        host = out.cpu().numpy()
        pcm = np.zeros_like(host)
        whole = lengths == self.FRAME
        pcm[whole] = host[whole]
        for i, b in np.argwhere((lengths > 0) & ~whole):
            m = int(lengths[i, b])
            pcm[i, b, :, :m] = host[i, b, :, self.FRAME - m:]
        return pcm, lengths

    def stage_ms(self) -> dict:
        """Medians over the timed collects so far, in ms: ``parse`` (a
        collect's host walk through the C++ parse), ``h2d`` (host clock
        of its pageable copies) and ``step`` (CUDA events around one
        round's step). Waits for the device."""
        if not self._stage_times:
            raise ValueError("no timed collect yet")
        torch.cuda.synchronize(self.device)
        walks, h2ds, events = zip(*self._stage_times)
        steps = [a.elapsed_time(b) for ev in events for a, b in ev]
        return {
            "collects": len(self._stage_times),
            "rounds": len(steps),
            "parse": 1e3 * float(np.median(walks)),
            "h2d": 1e3 * float(np.median(h2ds)),
            "step": float(np.median(steps)),
        }
