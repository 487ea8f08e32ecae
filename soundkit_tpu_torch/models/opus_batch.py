"""Batched multi-stream Opus decoders in PyTorch (counterparts of
``BatchedCeltDecoder``, ``BatchedSilkDeviceDecoder`` and
``BatchedHybridDecoder`` in ``soundkit_tpu/models/opus_batch.py``).

CELT
----

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

SILK
----
:class:`BatchedSilkDeviceDecoder` serves 20 ms single-frame SILK packets
(NB, MB or WB, a constant bandwidth a lane; mono or stereo coding may
change packet by packet, mid-only frames in-lane). A round is one call of
the port's ``skt_silk_parse_many`` (range decode and the export of the
synthesis inputs, one parse state a lane), one host-to-device copy of the
round's planes, and one ``ops.silk_batch.silk_round`` a bandwidth present
in the round, over all B lanes with the group's mask (K12 once each), as
the reference does; each bandwidth carries its own device state. A lane's
first slot is short by its bandwidth's ``lead_invalid`` (NB 23), then the
pre-skip is taken off; the lengths are kept on the host.

Hybrid
------
:class:`BatchedHybridDecoder` serves 20 ms single-frame hybrid packets
(SILK WB in the low band, CELT from band 17 on one range coder). A chunk
of ``ROUNDS_PER_CALL`` rounds is one call of
``skt_hybrid_parse_rounds_packed`` (the SILK export, then the CELT
continuation from the SILK walk's coder state), which writes every plane
of the chunk into one packed ``uint8`` wire (``_hybrid_wire_layout``),
one host-to-device copy of it, and then, on the device, the wire's
fields unpacked by slicing and ``Tensor.view(dtype)``, the int16 Q23
excitation dequantized, R SILK rounds at WB (K12 each) and R CELT rounds
(the IMDCT products and K11 each) on the CELT window padded back to 960
bins, and the two halves added. The wire buffer is one pageable array
reused from chunk to chunk: a pageable copy to the card returns only when
the buffer has been read, so the next walk may overwrite it. When the
walk finds an excitation beyond int16, the float32 wire is rebuilt from
the planes already walked and the walk's float64 excitation, with no
second walk (SILK parameters are delta-coded across frames). A lane whose
walk flags transition redundancy or a failed CELT continuation freezes
(``lane_error``); a fresh lane's CELT state is zeroed once.

The JAX package's host ``BatchedSilkDecoder`` (native synthesis and
libswresample on the host) is not ported.
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
from soundkit_tpu_torch.codecs.silk_native import NativeSilkBatch
from soundkit_tpu_torch.ops import celt_batch as cb
from soundkit_tpu_torch.ops import silk_batch as sb
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
        return _stage_ms(self._stage_times, self.device)


def _stage_ms(stage_times, device) -> dict:
    """Medians of a decoder's timed collects, in ms: ``parse`` (a
    collect's host walk), ``h2d`` (host clock of its copies) and ``step``
    (CUDA events around one step). Waits for the device."""
    if not stage_times:
        raise ValueError("no timed collect yet")
    torch.cuda.synchronize(device)
    walks, h2ds, events = zip(*stage_times)
    steps = [a.elapsed_time(b) for ev in events for a, b in ev]
    return {
        "collects": len(stage_times),
        "steps": len(steps),
        "parse": 1e3 * float(np.median(walks)),
        "h2d": 1e3 * float(np.median(h2ds)),
        "step": float(np.median(steps)),
    }


class BatchedSilkDeviceDecoder:
    """Lockstep decode of ``num_streams`` SILK voice streams of
    ``channels`` channels, synthesis on ``device`` ('cuda', the default,
    or 'cpu').

    Slot convention: every decoded round yields one 960-sample slot per
    lane with valid samples at the END; a lane's FIRST slot has
    ``960 - lead`` valid samples, where ``lead`` is the bandwidth's
    stream-start resampler offset (``ops.silk_batch.lead_invalid``: NB
    23, MB/WB 0), then the pre-skip is taken off."""

    FRAME = 960

    def __init__(self, num_streams: int, channels: int = 2, *, device="cuda",
                 timed: bool = False):
        self.device = resolve_device(device)
        if timed and self.device.type != "cuda":
            raise ValueError("timed=True needs a CUDA device (the step is timed by CUDA events)")
        self.timed = timed
        self._stage_times: List[tuple] = []  # per timed collect: (walk s, h2d s, [events])
        self.B = num_streams
        self.C = channels
        self.sample_rate = 48000
        self._batch = NativeSilkBatch(num_streams, channels)
        self._packets: List[List[tuple]] = [[] for _ in range(num_streams)]
        self.bw = [None] * num_streams
        self._fresh = np.ones(num_streams, bool)
        self._skip = [0] * num_streams
        self._gain = np.ones(num_streams, np.float32)
        self._state = {}  # bw -> (out_hist, lpch_tail, rs_tail) on the device

    def configure_lane(self, b: int, pre_skip: int = 0,
                       gain_q8: int = 0) -> None:
        self._skip[b] = pre_skip
        self._gain[b] = np.float32(
            10.0 ** (gain_q8 / (20.0 * 256.0)) if gain_q8 else 1.0)

    def reset_lane(self, b: int) -> None:
        self._batch.reset_lane(b)
        self._packets[b] = []
        self.bw[b] = None
        self._fresh[b] = True  # the step zeroes this lane's state
        self._skip[b] = 0
        self._gain[b] = np.float32(1.0)

    def lane_ready(self, b: int) -> int:
        return len(self._packets[b])

    def push_packet(self, b: int, frame: bytes, bandwidth: int,
                    coded: int) -> None:
        """Queue one 20 ms SILK frame payload (no TOC); the first
        packet pins the lane's bandwidth."""
        if self.bw[b] is None:
            self.bw[b] = bandwidth
        self._packets[b].append((frame, coded))

    def _group_state(self, bw: int):
        if bw not in self._state:
            self._state[bw] = sb.init_state(self.B, bw, self.device)
        return self._state[bw]

    # the round's planes, one after another in two host buffers (float32
    # and int32), one copy each to the device: (name, per-lane shape)
    _F32 = (("exc", (2, 320)), ("gains", (2, 4)), ("coef", (2, 2, 16)), ("ltp", (2, 4, 5)),
            ("ltpscale", (2,)), ("stereo_w", (4,)), ("gain48", ()), ("fresh", ()))
    _I32 = (("hl", (2,)), ("vo", (2,)), ("lags", (2, 4)), ("cc", (2,)), ("um", ()), ("sr", ()),
            ("ok", ()), ("bw", ()))

    def _to_device(self, p, ok, bws):
        """The round's parse export as device tensors {name: [B, ...]}."""
        B = self.B
        src = {"exc": p["exc"], "gains": p["gains"], "coef": p["coef"], "ltp": p["ltp"],
               "ltpscale": p["ltpscale"], "stereo_w": p["stereo_w"], "gain48": self._gain,
               "fresh": self._fresh & ok,
               "hl": p["flags"][:, 7:9], "vo": p["flags"][:, 5:7], "lags": p["lags"],
               "cc": p["flags"][:, 9:11], "um": p["flags"][:, 2] == 2, "sr": p["flags"][:, 4],
               "ok": ok, "bw": bws}
        out = {}
        for fields, dt in ((self._F32, np.float32), (self._I32, np.int32)):
            sizes = [B * int(np.prod(shp, dtype=np.int64)) for _, shp in fields]
            host = np.empty(sum(sizes), dt)
            pos = 0
            for (name, shp), n in zip(fields, sizes):
                np.copyto(host[pos: pos + n], np.reshape(src[name], n), casting="unsafe")
                pos += n
            dev = torch.from_numpy(host).to(self.device, copy=True)
            pos = 0
            for (name, shp), n in zip(fields, sizes):
                out[name] = dev[pos: pos + n].reshape((B, *shp))
                pos += n
        return out

    def _walk_round(self):
        """Pop one packet of every lane that has one and walk them in one
        call: (the walk's export, ok [B] bool: parsed, bws [B] i32)."""
        B = self.B
        frames = [b""] * B
        bws = np.zeros(B, np.int32)
        coded = np.ones(B, np.int32)
        valid = np.zeros(B, np.uint8)
        for b in range(B):
            if not self._packets[b]:
                continue
            frames[b], coded[b] = self._packets[b].pop(0)
            bws[b] = self.bw[b]
            valid[b] = 1
        p = self._batch.parse_many(frames, bws, coded,
                                   [20] * B, valid)
        return p, valid.astype(bool) & (p["n"] > 0), bws

    def decode_ready(self, max_packets: Optional[int] = None,
                     device_out: bool = False):
        """Decode lockstep rounds. Returns (pcm [rounds, B, C, 960]
        with valid samples at the END of each slot — a tensor on the
        device when ``device_out``, numpy otherwise — and lengths
        [rounds, B] i32)."""
        B, C = self.B, self.C
        counts = [len(p) for p in self._packets]
        n = max(counts) if counts else 0
        if max_packets is not None:
            n = min(n, max_packets)
        lengths = np.zeros((n, B), np.int32)
        out = torch.zeros((n, B, C, self.FRAME), dtype=torch.float32, device=self.device)
        walk_s = h2d_s = 0.0
        events = []
        for i in range(n):
            t0 = time.perf_counter()
            p, ok, bws = self._walk_round()
            groups = sorted({int(b_) for b_ in bws[ok]})
            t1 = time.perf_counter()
            walk_s += t1 - t0
            if groups:
                d = self._to_device(p, ok, bws)
                h2d_s += time.perf_counter() - t1
                if self.timed:
                    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                y_total = None
                ok_d = d["ok"] != 0
                for bw in groups:
                    g = ok_d & (d["bw"] == bw)
                    y, *state = sb.silk_round(
                        bw, C == 2, d["exc"], d["gains"], d["coef"], d["hl"], d["vo"],
                        d["lags"], d["ltp"], d["ltpscale"], d["cc"], d["um"], d["sr"],
                        d["stereo_w"], d["gain48"], g, d["fresh"] * g, *self._group_state(bw))
                    self._state[bw] = tuple(state)
                    y_total = y if y_total is None else y_total + y
                out[i] = y_total[:, :C]
                if self.timed:
                    stop.record()
                    events.append((start, stop))
            # host-side length bookkeeping: first slot is short by the
            # bandwidth's stream-start offset, then pre-skip consumes
            for b in np.flatnonzero(ok):
                m = self.FRAME
                if self._fresh[b]:
                    m -= sb.lead_invalid(int(bws[b]))
                    self._fresh[b] = False
                k = min(self._skip[b], m)
                self._skip[b] -= k
                lengths[i, b] = m - k
        if self.timed and n:
            self._stage_times.append((walk_s, h2d_s, events))
        if device_out:
            return out, lengths
        return out.cpu().numpy(), lengths

    def stage_ms(self) -> dict:
        """Medians over the timed collects so far, in ms: ``parse`` (a
        collect's SILK walks), ``h2d`` (its copies) and ``step`` (CUDA
        events around one round's device work). Waits for the device."""
        return _stage_ms(self._stage_times, self.device)


# rounds a hybrid chunk: one walk and one copy of a packed wire a chunk
ROUNDS_PER_CALL = 8

# hybrid CELT runs from start band 17 to at most band 21: at the 960
# frame size the spectrum is structurally zero outside bins
# [freq_bands[17]*8, freq_bands[21]*8) = [320, 800) — the wire ships
# only that window and the device pads it back
_HYB_BIN_LO, _HYB_BIN_HI = 320, 800


# SILK excitation exports as integer Q23 (silk_parse.cpp
# decode_excitation: e = value*256|qoff +-20, out = e / 2^23), so the
# wire ships raw Q23 ints — int16 when every |e| fits (always, in
# practice: |e| needs pulse magnitudes > 127), f32 otherwise
_EXC_Q = 8388608.0


@functools.lru_cache(maxsize=8)
def _hybrid_wire_layout(R: int, B: int, C: int, exc16: bool = True):
    """Packed one-buffer wire for a hybrid chunk (R rounds x B lanes):
    every SILK-export and CELT-continuation plane lives in ONE
    4-byte-aligned uint8 buffer, written by the native walk, copied to
    the device in one piece and sliced and bitcast there. Returns (layout
    [(name, off, dtype, shape)], total_bytes)."""
    fields = [
        ("exc", np.int16 if exc16 else np.float32, (R, B, 2, 320)),
        ("gains", np.float32, (R, B, 2, 4)),
        ("coef", np.float32, (R, B, 2, 2, 16)),
        ("ltp", np.float32, (R, B, 2, 4, 5)),
        ("ltpscale", np.float32, (R, B, 2)),
        ("stereo_w", np.float32, (R, B, 4)),
        ("freq", np.float32, (R, B, C, _HYB_BIN_HI - _HYB_BIN_LO)),
        ("comb", np.float32, (R, B, 16)),
        ("fresh", np.float32, (R, B)),
        ("gain48", np.float32, (B,)),
        ("lags", np.int32, (R, B, 2, 4)),
        ("hl", np.int32, (R, B, 2)),
        ("vo", np.int32, (R, B, 2)),
        ("cc", np.int32, (R, B, 2)),
        ("um", np.int32, (R, B)),
        ("sr", np.int32, (R, B)),
        ("sflag", np.int32, (R, B)),
        ("valid", np.int32, (R, B)),
    ]
    layout, off = [], 0
    for name, dt, shp in fields:
        layout.append((name, off, dt, shp))
        off += int(np.prod(shp)) * np.dtype(dt).itemsize
    return layout, off


def _wire_views(wire, R: int, B: int, C: int, exc16: bool):
    """Per-field numpy views into a packed hybrid wire buffer."""
    layout, _ = _hybrid_wire_layout(R, B, C, exc16)
    return {
        name: np.frombuffer(wire, dt, int(np.prod(shp)), off)
        .reshape(shp)
        for name, off, dt, shp in layout
    }


_TORCH_DTYPE = {np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
                np.dtype(np.float32): torch.float32}


def _hybrid_chunk(wire, R: int, B: int, C: int, exc16: bool, silk_state, celt_state):
    """A hybrid chunk on the device: unpack the packed wire (a uint8
    tensor) by slicing and ``view(dtype)``, dequantize the Q23
    excitation, run R SILK rounds at WB (``silk_round``, K12) and R
    CELT rounds (``celt_synth_step``, the IMDCT glue and K11) on the
    gain-scaled CELT window padded to 960 bins, and add the halves.
    Returns (pcm [R, B, C, 960], silk_state, celt_state)."""
    layout, _ = _hybrid_wire_layout(R, B, C, exc16)
    p = {}
    for name, off, dt, shp in layout:
        n = int(np.prod(shp)) * np.dtype(dt).itemsize
        p[name] = wire[off: off + n].view(_TORCH_DTYPE[np.dtype(dt)]).reshape(shp)
    exc = p["exc"].to(torch.float32) * (1.0 / _EXC_Q) if exc16 else p["exc"]
    g = p["valid"] != 0
    silk_state = tuple(silk_state)
    ola, hist, emph = celt_state
    freq = p["freq"] * p["gain48"][None, :, None, None]
    freq = torch.nn.functional.pad(freq, (_HYB_BIN_LO, cb.N - _HYB_BIN_HI))
    pcm = torch.empty((R, B, C, cb.N), dtype=torch.float32, device=wire.device)
    for r in range(R):
        y, *silk_state = sb.silk_round(
            2, C == 2, exc[r], p["gains"][r], p["coef"][r], p["hl"][r], p["vo"][r],
            p["lags"][r], p["ltp"][r], p["ltpscale"][r], p["cc"][r], p["um"][r], p["sr"][r],
            p["stereo_w"][r], p["gain48"], g[r], p["fresh"][r], *silk_state)
        cpcm, ola, hist, emph = cb.celt_synth_step(freq[r], p["sflag"][r], p["comb"][r], g[r],
                                                   ola, hist, emph)
        pcm[r] = y[:, :C] + cpcm
    return pcm, tuple(silk_state), (ola, hist, emph)


class BatchedHybridDecoder:
    """Lockstep decode of ``num_streams`` hybrid Opus streams of
    ``channels`` channels, both halves on ``device`` ('cuda', the
    default, or 'cpu').

    Packets carrying hybrid mode-transition redundancy are flagged by
    the native walk (red=1): real encoders attach redundancy only to
    mode-transition packets, which the fleet already reroutes at push
    (kind mismatch), so in-lane this only fires when a stream STARTS
    on a transition packet — the lane freezes (length 0) and the next
    push raises ``OpusLaneUnsupported``."""

    FRAME = 960

    def __init__(self, num_streams: int, channels: int = 2, *, device="cuda",
                 timed: bool = False):
        self.device = resolve_device(device)
        if timed and self.device.type != "cuda":
            raise ValueError("timed=True needs a CUDA device (the step is timed by CUDA events)")
        self.timed = timed
        self._stage_times: List[tuple] = []  # per timed collect: (walk s, h2d s, [events])
        self.B = num_streams
        self.C = channels
        self.sample_rate = 48000
        self._silk = NativeSilkBatch(num_streams, channels)
        self._celt = NativeCeltBatch(num_streams, channels)
        self._band_end = tables()["celt_band_end"].astype(int)
        self._packets: List[List[tuple]] = [[] for _ in range(num_streams)]
        self._fresh = np.ones(num_streams, bool)
        self._skip = [0] * num_streams
        self._gain = np.ones(num_streams, np.float32)
        self._error: List[Optional[str]] = [None] * num_streams
        dev = self.device
        self._silk_state = sb.init_state(num_streams, 2, dev)  # WB
        self._celt_state = (
            torch.zeros((num_streams, channels, cb.OVERLAP), dtype=torch.float32, device=dev),
            torch.zeros((num_streams, channels, cb.HIST), dtype=torch.float32, device=dev),
            torch.zeros((num_streams, channels), dtype=torch.float32, device=dev),
        )
        # the int16-excitation wire of a chunk, reused (see the module's docstring)
        self._wire16 = np.empty(_hybrid_wire_layout(ROUNDS_PER_CALL, num_streams, channels,
                                                    True)[1], np.uint8)

    def configure_lane(self, b: int, pre_skip: int = 0,
                       gain_q8: int = 0) -> None:
        self._skip[b] = pre_skip
        self._gain[b] = np.float32(
            10.0 ** (gain_q8 / (20.0 * 256.0)) if gain_q8 else 1.0)

    def reset_lane(self, b: int) -> None:
        self._silk.reset_lane(b)
        self._celt.reset_lane(b)
        self._packets[b] = []
        self._fresh[b] = True  # steps zero this lane's device state
        self._skip[b] = 0
        self._gain[b] = np.float32(1.0)
        self._error[b] = None

    def lane_error(self, b: int) -> Optional[str]:
        return self._error[b]

    def lane_ready(self, b: int) -> int:
        return len(self._packets[b])

    def push_packet(self, b: int, frame: bytes, bandwidth: int,
                    coded: int) -> None:
        """Queue one 20 ms hybrid frame payload (no TOC); bandwidth is
        the TOC index (3 = SWB, 4 = FB) driving the CELT band end."""
        self._packets[b].append(
            (frame, int(self._band_end[bandwidth]), coded))

    def _wire32_from_wire16(self, wire16, exc_f64):
        """Overflow fallback: rebuild the f32-excitation wire from
        the already-walked packed wire plus the native f64 excitation
        export.  NO re-walk: SILK parameters are delta-coded across
        frames, so walking the stateful handles twice would corrupt
        every later frame."""
        R, B, C = ROUNDS_PER_CALL, self.B, self.C
        _, total = _hybrid_wire_layout(R, B, C, False)
        wire = np.empty(total, np.uint8)
        v16 = _wire_views(wire16, R, B, C, True)
        v32 = _wire_views(wire, R, B, C, False)
        for k, dst in v32.items():
            if k == "exc":
                np.copyto(dst, exc_f64, casting="unsafe")
            else:
                dst[...] = v16[k]
        return wire

    def decode_ready(self, max_packets: Optional[int] = None,
                     device_out: bool = False):
        """Decode lockstep rounds. Returns (pcm [rounds, B, C, 960] with
        valid samples at the END of each slot — a tensor on the device
        when ``device_out``, numpy otherwise — and lengths [rounds, B])."""
        B, C = self.B, self.C
        dev = self.device
        counts = [len(p) for p in self._packets]
        n = max(counts) if counts else 0
        if max_packets is not None:
            n = min(n, max_packets)
        if n == 0:
            empty = torch.zeros((0, B, C, self.FRAME), dtype=torch.float32, device=dev)
            return (empty if device_out else empty.cpu().numpy()), np.zeros((0, B), np.int32)
        R = ROUNDS_PER_CALL
        n_pad = (n + R - 1) // R * R
        # drain the queues into per-lane packed byte runs
        plens = np.zeros((B, n_pad), np.int32)
        ends = np.zeros((B, n_pad), np.int32)
        codedm = np.ones((B, n_pad), np.int32)
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
            if self._error[b]:
                continue  # frozen lane: drop its queued packets
            plens[b, :k] = [len(t[0]) for t in take]
            ends[b, :k] = [t[1] for t in take]
            codedm[b, :k] = [t[2] for t in take]
            base[b] = pos
            lane_buf = b"".join(t[0] for t in take)
            parts.append(lane_buf)
            pos += len(lane_buf)
        buf = b"".join(parts)

        layout16, _ = _hybrid_wire_layout(R, B, C, True)
        d16 = {name: off for name, off, _, _ in layout16}
        offs16 = np.array(
            [d16[k] for k in ("exc", "gains", "coef", "ltp",
                              "ltpscale", "stereo_w", "freq", "comb",
                              "lags", "hl", "vo", "cc", "um", "sr",
                              "sflag")], np.int64)
        # overflow side-channel, filled by the native walk only when a
        # pulse run exceeds int16 Q23
        exc_f64 = np.empty((R, B, 2, 320), np.float64)
        sst = self._silk_state
        ola, hist, emph = self._celt_state
        # a lane's packets occupy rounds 0..k-1, so a fresh lane's
        # first valid round is ROUND 0: zero its celt carry once
        has_pkts = plens[:, 0] > 0
        fresh_lanes = self._fresh & has_pkts
        if fresh_lanes.any():
            keep = torch.from_numpy(~fresh_lanes).to(dev, torch.float32)
            ola = ola * keep[:, None, None]
            hist = hist * keep[:, None, None]
            emph = emph * keep[:, None]
        g_all = np.zeros((n_pad, B), bool)
        out = torch.empty((n_pad, B, C, self.FRAME), dtype=torch.float32, device=dev)
        cur = base.copy()
        err_mask = np.array([e is not None for e in self._error])
        walk_s = h2d_s = 0.0
        events = []
        for r0 in range(0, n_pad, R):
            t0 = time.perf_counter()
            pl = plens[:, r0:r0 + R].copy()
            pl[err_mask] = 0  # lanes errored in an earlier chunk
            cur0 = cur.copy()
            cur = cur + plens[:, r0:r0 + R].sum(axis=1)
            wire = self._wire16
            overflow, nn, ok, red = \
                self._silk.hybrid_parse_rounds_packed(
                    self._celt, buf, cur0, pl, ends[:, r0:r0 + R],
                    codedm[:, r0:r0 + R], wire, offs16, exc_f64,
                    bin_lo=_HYB_BIN_LO,
                    bin_len=_HYB_BIN_HI - _HYB_BIN_LO)
            valid_r = (pl > 0).T.copy()  # [R, B]
            bad = valid_r & (ok != 0)
            if bad.any():
                for r_, b_ in np.argwhere(bad):
                    bi = int(b_)
                    if self._error[bi] is None:
                        self._error[bi] = (
                            "hybrid transition redundancy"
                            if red[r_, b_] else
                            "celt continuation parse failed "
                            f"({int(ok[r_, b_])})")
                    self._packets[bi] = []
                    valid_r[int(r_):, bi] = False
                    err_mask[bi] = True
            g = valid_r & (nn > 0)
            g_all[r0:r0 + R] = g
            exc16 = not overflow
            if overflow:
                # a pulse run exceeded int16 Q23 (needs |pulses| > 127 per
                # coefficient): rebuild the f32 wire from the walked
                # planes + the native f64 excitation
                wire = self._wire32_from_wire16(wire, exc_f64)
            views = _wire_views(wire, R, B, C, exc16)
            np.copyto(views["valid"], g, casting="unsafe")
            views["gain48"][:] = self._gain
            views["fresh"][:] = 0.0
            if r0 == 0:
                views["fresh"][0] = fresh_lanes.astype(np.float32)
            t1 = time.perf_counter()
            d_wire = torch.from_numpy(wire).to(dev, copy=True)
            t2 = time.perf_counter()
            walk_s += t1 - t0
            h2d_s += t2 - t1
            if self.timed:
                start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            out[r0:r0 + R], sst, (ola, hist, emph) = _hybrid_chunk(
                d_wire, R, B, C, exc16, sst, (ola, hist, emph))
            if self.timed:
                stop.record()
                events.append((start, stop))
        self._silk_state = sst
        self._celt_state = (ola, hist, emph)
        self._fresh[has_pkts] = False
        if self.timed:
            self._stage_times.append((walk_s, h2d_s, events))
        # vectorised length/preskip bookkeeping (lead_invalid(WB)=0)
        vn = g_all[:n].astype(np.int64)
        cap = vn * self.FRAME
        cum = np.cumsum(cap, axis=0)
        skip0 = np.array(self._skip, np.int64)
        consumed = np.clip(skip0[None, :] - (cum - cap), 0, cap)
        lengths = (cap - consumed).astype(np.int32)
        self._skip = list(np.maximum(skip0 - cum[-1], 0))
        pcm = out[:n]
        if device_out:
            return pcm, lengths
        return pcm.cpu().numpy(), lengths

    def stage_ms(self) -> dict:
        """Medians over the timed collects so far, in ms: ``parse`` (a
        collect's hybrid walks), ``h2d`` (its wire copies) and ``step``
        (CUDA events around one chunk of ``ROUNDS_PER_CALL`` rounds on
        the device). Waits for the device."""
        return _stage_ms(self._stage_times, self.device)
