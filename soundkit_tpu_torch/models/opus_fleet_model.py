"""Ogg Opus fleet group in PyTorch (counterpart of
``soundkit_tpu/models/opus_fleet_model.py``): a per-lane Ogg demux over
three batched engines.

Each lane demuxes its Ogg pages on the host (``codecs/opus.OggOpusDemuxer``),
classifies every packet by its TOC and is pinned by its first audio
packet to one engine:

- CELT 20 ms (music) lanes queue into the shared ``BatchedCeltDecoder``
  (the C++ parse on the host, the synthesis on the device: IMDCT and K11);
- SILK 20 ms (voice) lanes queue into ``BatchedSilkDeviceDecoder`` (one
  C++ ``skt_silk_parse_many`` walk a round; the LTP/LPC synthesis, K12,
  the unmix and the 48 kHz resample on the device);
- hybrid 20 ms lanes queue into ``BatchedHybridDecoder`` (the SILK walk's
  coder state seeds the CELT continuation; both halves on the device).

All three engines take the pre-skip and output gain of the OpusHead. This
is a stated departure: the reference configures only the CELT and SILK
engines (``soundkit_tpu/models/opus_fleet_model.py:247-253``), so a hybrid
lane there keeps its first pre-skip samples and ignores its head's gain;
here a hybrid lane gives the streaming decoder's length and, within its
float32 synthesis, its samples (``codecs/opus.OggOpusDecoder``).

All three engines give [rounds, B, C, 960] slots with the valid samples at
the END on the device and zeros on other engines' lanes, so
``decode_batches`` adds them. A lane the reference would reroute to its
per-stream host decoder raises :class:`OpusLaneUnsupported` out of
``push``:

- an OpusHead with more channels than the group or a mapping family
  other than 0 (a multistream head, which the host decoder serves through
  ``codecs/opus_multistream``);
- a packet that is not a single 20 ms frame (10 ms, multi-frame);
- a mid-stream mode switch, or a mid-stream SILK bandwidth switch;
- a hybrid lane whose walk froze it (a stream that starts on a
  transition-redundancy packet, or a failed CELT continuation), on the
  push after the decode that found it.

The exception's ``replay`` seeds the fleet's per-stream host decoder,
:class:`_OpusTailFallback` (a verbatim copy of the JAX package's), from
the lane's own bounded state: the lane keeps its last ``TAIL_KEEP``
decoded packets beyond its undecoded queue (``_tail``, ~2 s), the 48 kHz
samples of the packets trimmed from it (``_tail_dropped``) and the
samples it delivered (``_emitted``), so the fleet retains no raw bytes of
an Opus stream. The host decoder replays the tail through the Python
decoder (``codecs/opus._OpusCore``; decoder state memory is short, so the
replay converges to the full-history decode well inside the tail) and
drops the samples the lane already delivered.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from soundkit_tpu_torch.codecs.opus import OggOpusDemuxer
from soundkit_tpu_torch.models.opus_batch import (
    BatchedCeltDecoder,
    BatchedHybridDecoder,
    BatchedSilkDeviceDecoder,
)


class OpusLaneUnsupported(Exception):
    """This stream needs the host pipeline (odd framing / mode
    switches); carries ``replay`` — everything the fleet needs to
    seed a :class:`_OpusTailFallback` (bounded tail, no raw-byte
    retention)."""

    replay: Optional[dict] = None


class _OpusTailFallback:
    """Per-stream host decoder seeded from a lane's bounded packet
    tail (fleet reroute target; codecs/opus.py converge-from-tail).

    Duck-types the ``StreamDecoder.process`` surface the fleet's
    fallback path consumes: ``process(data) -> [AudioData]`` with
    f32 PCM, where ``data`` is the stream's raw Ogg bytes arriving
    after the reroute (the lane's demuxer moves over for byte
    continuity) and ``b""`` drains/flushes.  The first replayed
    packet rebuilds the Python decoder's state from the retained
    tail and drops the ``emitted`` samples the lane already
    delivered, so interleaved push/collect callers see a gapless,
    duplicate-free stream."""

    def __init__(self, demux, head, tail, dropped, emitted, pending):
        from soundkit_tpu_torch.codecs.opus import _OpusCore, open_opus_core

        self._demux = demux
        core = open_opus_core(head)
        if isinstance(core, _OpusCore):
            core._fast = False  # native CELT state can't seed from a tail
            core._history = list(tail)
            core._dropped = int(dropped)
            core._emitted = int(emitted)
            self._primed = False
        else:
            # multistream head: rerouted at the push that brings the head,
            # before any packet decoded (nothing emitted, no tail to
            # converge); its streams keep their native CELT fast paths
            self._primed = True
        self._core = core
        self._queue: List[bytes] = list(pending)

    def process(self, data: bytes):
        from soundkit_tpu_torch.codecs.opus_core import OpusUnsupported
        from soundkit_tpu_torch.core.audio_types import AudioData, EncodingFlag

        pkts = self._queue
        self._queue = []
        if data:
            pkts = pkts + self._demux.push(data)
        outs = []
        for p in pkts:
            if not self._primed:
                self._core._history.append(p)
                self._core._trim_history()
                try:
                    pcm = self._core._replay_own()
                except OpusUnsupported:
                    pcm = self._core._fallback()
                self._primed = True
            else:
                pcm = self._core.decode_packet_f32(p)
            if pcm.size:
                outs.append(AudioData(
                    bits_per_sample=32,
                    channel_count=self._core.channels,
                    sampling_rate=self._core.sample_rate,
                    data=np.asarray(pcm, "<f4").tobytes(),
                    audio_format=EncodingFlag.PCM_FLOAT,
                ))
        return outs


def _classify(packet: bytes, channels: int):
    """(kind, toc, frame) for a servable packet, else (None, ..)."""
    from soundkit_tpu_torch.codecs.opus_core import (
        _TOC_CACHE,
        TOC_ATTRS,
        parse_packet,
    )

    if not packet:
        return None, None, None
    mode, dur, stereo, _bw, code = TOC_ATTRS[packet[0]]
    if code == 0:
        # fast path: code-0 packets (one frame) need no length parse
        if dur != 20 or (2 if stereo else 1) > channels:
            return None, None, None
        return mode, _TOC_CACHE[packet[0]], packet[1:]
    try:
        toc, frames = parse_packet(packet)
    except Exception:
        return None, None, None
    coded = 2 if toc.stereo else 1
    if (toc.frame_duration != 20 or len(frames) != 1
            or coded > channels):
        return None, None, None
    if toc.mode == "celt":
        return "celt", toc, frames[0]
    if toc.mode == "silk":
        return "silk", toc, frames[0]
    if toc.mode == "hybrid":
        return "hybrid", toc, frames[0]
    return None, None, None


class BatchedOggOpusDecoder:
    """B-lane Ogg Opus serving model over the CELT, SILK and hybrid
    engines, on ``device`` ('cuda', the default, or 'cpu')."""

    FRAME = 960

    def __init__(self, num_streams: int, channels: int = 2, celt_wire: str = "f32", *,
                 device="cuda"):
        self.B = num_streams
        self.C = channels
        self._celt = BatchedCeltDecoder(num_streams, channels, wire=celt_wire, device=device)
        self._silk = BatchedSilkDeviceDecoder(num_streams, channels, device=device)
        self._hyb = BatchedHybridDecoder(num_streams, channels, device=device)
        self._kind: List[Optional[str]] = [None] * num_streams
        self._demux: List[OggOpusDemuxer] = [OggOpusDemuxer() for _ in range(num_streams)]
        # converge-from-tail reroute state: bounded packet tail plus
        # trimmed-duration / emitted-sample accounting per lane
        self._tail: List[List[bytes]] = [[] for _ in range(num_streams)]
        self._tail_dropped = [0] * num_streams  # 48k samples trimmed
        self._emitted = [0] * num_streams  # samples delivered per lane

    #: warmup packets retained beyond the undecoded queue (~2 s at
    #: 20 ms — matches codecs/opus.py _HISTORY_KEEP; far beyond CELT/
    #: SILK state memory, so a tail replay converges before it ends)
    TAIL_KEEP = 96

    def reset_lane(self, b: int) -> None:
        self._celt.reset_lane(b)
        self._silk.reset_lane(b)
        self._hyb.reset_lane(b)
        self._kind[b] = None
        self._demux[b] = OggOpusDemuxer()
        self._tail[b] = []
        self._tail_dropped[b] = 0
        self._emitted[b] = 0

    def lane_configured(self, b: int) -> bool:
        # an Opus lane can still hit a reroute at any packet (mode
        # switch) — but the reroute replays from the lane's own
        # bounded tail, so the fleet retains NO raw bytes; report
        # configured as soon as the head has parsed
        return self._demux[b].head is not None

    def _reroute(self, b: int, msg: str, pending: List[bytes]):
        """Build the reroute exception: the lane's demuxer, head, and
        bounded tail (plus the still-unprocessed packets of the
        current push, offender first) seed a _OpusTailFallback."""
        exc = OpusLaneUnsupported(msg)
        exc.replay = dict(
            demux=self._demux[b], head=self._demux[b].head,
            tail=list(self._tail[b]), dropped=self._tail_dropped[b],
            emitted=self._emitted[b], pending=pending,
        )
        return exc

    def lane_sample_rate(self, b: int) -> Optional[int]:
        return 48000 if self._demux[b].head is not None else None

    def lane_ready(self, b: int) -> int:
        if self._kind[b] == "silk":
            return self._silk.lane_ready(b)
        if self._kind[b] == "hybrid":
            return self._hyb.lane_ready(b)
        return self._celt.queued(b)

    def push(self, b: int, data: bytes) -> None:
        dm = self._demux[b]
        had_head = dm.head is not None
        pkts = dm.push(data)
        if dm.head is not None and not had_head:
            if dm.head.channels > self.C or dm.head.mapping_family != 0:
                raise self._reroute(b, "unsupported OpusHead", pkts)
            self._celt.configure_lane(b, dm.head.pre_skip, dm.head.output_gain)
            self._silk.configure_lane(b, dm.head.pre_skip, dm.head.output_gain)
            self._hyb.configure_lane(b, dm.head.pre_skip, dm.head.output_gain)
        for i, pkt in enumerate(pkts):
            kind, toc, frame = _classify(pkt, self.C)
            if kind is None:
                raise self._reroute(b, "non-20ms/multiframe packet", pkts[i:])
            if self._kind[b] is None:
                self._kind[b] = kind
            if kind != self._kind[b]:
                raise self._reroute(b, "mid-stream mode switch", pkts[i:])
            coded = 2 if toc.stereo else 1
            if kind == "celt":
                # _classify already split the TOC: hand the frame, end band
                # and coded channels straight to the queue
                self._celt.push_frame(b, frame, self._celt._band_end_i[toc.bandwidth], coded)
            elif kind == "hybrid":
                # a transition-redundancy packet at stream START is flagged
                # by the engine at decode time; the lane raises on its
                # next push
                if self._hyb.lane_error(b):
                    raise self._reroute(b, self._hyb.lane_error(b), pkts[i:])
                self._hyb.push_packet(b, frame, toc.bandwidth, coded)
            else:
                bw0 = self._silk.bw[b]
                if bw0 is not None and toc.bandwidth != bw0:
                    raise self._reroute(b, "silk bandwidth switch", pkts[i:])
                self._silk.push_packet(b, frame, toc.bandwidth, coded)
            self._tail[b].append(pkt)

    def decode_batches(self, n: int, device_out: bool = False):
        """Decode up to ``n`` lockstep packet rounds.

        Returns (pcm, lengths): pcm [rounds, B, C, 960] (a tensor on the
        device when ``device_out``, valid samples at the END of each
        slot; numpy otherwise, valid samples at the START), lengths
        [rounds, B] int32. The engines' slots are lane-disjoint, with
        zeros elsewhere, so the device combine is an add."""
        parts = [engine.decode_ready(max_packets=n, device_out=True)
                 for engine in (self._celt, self._silk, self._hyb)]
        R = max(lens.shape[0] for _, lens in parts)
        lengths = np.zeros((R, self.B), np.int32)
        total = torch.zeros((R, self.B, self.C, self.FRAME), dtype=torch.float32,
                            device=parts[0][0].device)
        for pcm, lens in parts:
            r = lens.shape[0]
            lengths[:r] += lens
            if r:
                total[:r] += pcm
        if R:
            # the reroute tail: count delivered samples and trim each
            # lane's tail to its undecoded queue and TAIL_KEEP packets;
            # every trimmed packet is a decoded 20 ms frame
            tot = lengths.sum(axis=0)
            for b in range(self.B):
                self._emitted[b] += int(tot[b])
                t = self._tail[b]
                keep = self.lane_ready(b) + self.TAIL_KEEP
                if len(t) > keep:
                    cut = len(t) - keep
                    del t[:cut]
                    self._tail_dropped[b] += 960 * cut
        if device_out:
            return total, lengths
        # the host convention: the valid samples at the START of each slot
        host = total.cpu().numpy()
        out = np.zeros_like(host)
        whole = lengths == self.FRAME
        out[whole] = host[whole]
        for i, b in np.argwhere((lengths > 0) & ~whole):
            m = int(lengths[i, b])
            out[i, b, :, :m] = host[i, b, :, self.FRAME - m:]
        return out, lengths
