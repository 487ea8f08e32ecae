"""Ogg Opus fleet group in PyTorch (counterpart of
``soundkit_tpu/models/opus_fleet_model.py``): a per-lane Ogg demux over
the batched CELT decoder.

Each lane demuxes its Ogg pages on the host (``codecs/opus.OggOpusDemuxer``),
takes its pre-skip and output gain from the OpusHead, classifies every
packet by its TOC and queues the CELT frames of single-frame 20 ms CELT
packets into the shared ``BatchedCeltDecoder`` (device synthesis over
all lanes a round).

The JAX package's group has three engines: CELT, SILK and hybrid. The
port has the CELT engine only, and behaves as the reference does when the
other two are missing. A lane the reference would reroute to its
per-stream host decoder raises :class:`OpusLaneUnsupported` out of
``push``:

- an OpusHead with more channels than the group or a mapping family
  other than 0;
- a packet that is not a single 20 ms frame (10 ms, multi-frame);
- a first audio packet that is SILK or hybrid;
- a mid-stream mode switch.

The reference's reroute keeps a bounded packet tail per lane (``_tail``,
``_emitted``, ``TAIL_KEEP``) only to seed that host decoder
(``_OpusTailFallback``); the port has no host decoder yet and keeps no
tail.
"""
from __future__ import annotations

from typing import List, Optional

from soundkit_tpu_torch.codecs.opus import OggOpusDemuxer
from soundkit_tpu_torch.models.opus_batch import BatchedCeltDecoder


class OpusLaneUnsupported(Exception):
    """This stream needs a per-stream host decoder (odd framing, a
    non-CELT mode, a mode switch), which the port does not have."""


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
    """B-lane Ogg Opus serving model over the device CELT synthesis, on
    ``device`` ('cuda', the default, or 'cpu')."""

    FRAME = 960

    def __init__(self, num_streams: int, channels: int = 2, celt_wire: str = "f32", *,
                 device="cuda"):
        self.B = num_streams
        self.C = channels
        self._celt = BatchedCeltDecoder(num_streams, channels, wire=celt_wire, device=device)
        self._kind: List[Optional[str]] = [None] * num_streams
        self._demux: List[OggOpusDemuxer] = [OggOpusDemuxer() for _ in range(num_streams)]

    def reset_lane(self, b: int) -> None:
        self._celt.reset_lane(b)
        self._kind[b] = None
        self._demux[b] = OggOpusDemuxer()

    def lane_sample_rate(self, b: int) -> Optional[int]:
        return 48000 if self._demux[b].head is not None else None

    def lane_ready(self, b: int) -> int:
        return self._celt.queued(b)

    def push(self, b: int, data: bytes) -> None:
        dm = self._demux[b]
        had_head = dm.head is not None
        pkts = dm.push(data)
        if dm.head is not None and not had_head:
            if dm.head.channels > self.C or dm.head.mapping_family != 0:
                raise OpusLaneUnsupported("unsupported OpusHead")
            self._celt.configure_lane(b, dm.head.pre_skip, dm.head.output_gain)
        for pkt in pkts:
            kind, toc, frame = _classify(pkt, self.C)
            if kind is None:
                raise OpusLaneUnsupported("non-20ms/multiframe packet")
            if self._kind[b] is None:
                if kind != "celt":
                    raise OpusLaneUnsupported(f"no batched {kind} engine")
                self._kind[b] = kind
            if kind != self._kind[b]:
                raise OpusLaneUnsupported("mid-stream mode switch")
            # _classify already split the TOC: hand the frame, end band
            # and coded channels straight to the queue
            self._celt.push_frame(b, frame, self._celt._band_end_i[toc.bandwidth],
                                  2 if toc.stereo else 1)

    def decode_batches(self, n: int, device_out: bool = False):
        """Decode up to ``n`` lockstep packet rounds.

        Returns (pcm, lengths): pcm [rounds, B, C, 960] (a tensor on the
        device when ``device_out``, valid samples at the END of each
        slot; numpy otherwise, valid samples at the START), lengths
        [rounds, B] int32."""
        return self._celt.decode_ready(max_packets=n, device_out=device_out)
