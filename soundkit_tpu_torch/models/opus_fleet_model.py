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

The CELT and SILK engines take the pre-skip and output gain of the
OpusHead. The hybrid engine does not: the reference never configures it
(``soundkit_tpu/models/opus_fleet_model.py:247-253``), so a hybrid lane
ignores its OpusHead's pre-skip and gain there, and the port, held to the
reference collect by collect, keeps that.

All three engines give [rounds, B, C, 960] slots with the valid samples at
the END on the device and zeros on other engines' lanes, so
``decode_batches`` adds them. A lane the reference would reroute to its
per-stream host decoder raises :class:`OpusLaneUnsupported` out of
``push``:

- an OpusHead with more channels than the group or a mapping family
  other than 0;
- a packet that is not a single 20 ms frame (10 ms, multi-frame);
- a mid-stream mode switch, or a mid-stream SILK bandwidth switch;
- a hybrid lane whose walk froze it (a stream that starts on a
  transition-redundancy packet, or a failed CELT continuation), on the
  push after the decode that found it.

The reference's reroute keeps a bounded packet tail per lane (``_tail``,
``_emitted``, ``TAIL_KEEP``) only to seed that host decoder
(``_OpusTailFallback``); the port has no host decoder yet and keeps no
tail.
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
    """This stream needs a per-stream host decoder (odd framing, a mode
    or SILK bandwidth switch, a frozen hybrid lane), which the port does
    not have."""


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

    def reset_lane(self, b: int) -> None:
        self._celt.reset_lane(b)
        self._silk.reset_lane(b)
        self._hyb.reset_lane(b)
        self._kind[b] = None
        self._demux[b] = OggOpusDemuxer()

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
                raise OpusLaneUnsupported("unsupported OpusHead")
            self._celt.configure_lane(b, dm.head.pre_skip, dm.head.output_gain)
            self._silk.configure_lane(b, dm.head.pre_skip, dm.head.output_gain)
        for pkt in pkts:
            kind, toc, frame = _classify(pkt, self.C)
            if kind is None:
                raise OpusLaneUnsupported("non-20ms/multiframe packet")
            if self._kind[b] is None:
                self._kind[b] = kind
            if kind != self._kind[b]:
                raise OpusLaneUnsupported("mid-stream mode switch")
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
                    raise OpusLaneUnsupported(self._hyb.lane_error(b))
                self._hyb.push_packet(b, frame, toc.bandwidth, coded)
            else:
                bw0 = self._silk.bw[b]
                if bw0 is not None and toc.bandwidth != bw0:
                    raise OpusLaneUnsupported("silk bandwidth switch")
                self._silk.push_packet(b, frame, toc.bandwidth, coded)

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
