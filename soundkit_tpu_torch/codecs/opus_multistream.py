"""Multistream Opus: the OpusHead channel mapping table (RFC 7845
§5.1.1), the multistream packet (RFC 6716 Appendix B) and a decoder of
one elementary ``codecs/opus._OpusCore`` a stream, on the host.

A multistream stream carries N elementary Opus streams, the first M of
them coupled (stereo). Each packet is N - 1 self-delimited Opus packets
followed by one ordinary packet, all of one duration. The head's mapping
table gives, for each output channel, a stream channel: an index below
2M is channel ``i % 2`` of coupled stream ``i // 2``, an index from 2M to
N + M - 1 is mono stream ``i - M``, and 255 is silence.

The JAX package decodes these streams through libavcodec
(``AvDecoder("opus", extradata=head)``); this module owns the same
contract, measured against it:

- the heads it opens: mapping families 1 (up to 8 channels), 2 (an
  ambisonic count, (n + 1)^2 or (n + 1)^2 + 2, up to 227) and 255, each
  with its whole table, N > 0, M <= N, N + M <= 255 and every entry below
  N + M or 255. A head version above 15 is refused. The rest it refuses,
  as libavcodec does: family 0 beyond two channels, family 3 and up, a
  19-byte head without its table (:func:`parse_channel_mapping`);
- libavcodec's channel order: for family 1 it reorders the Vorbis order
  of RFC 7845 into its own layout (``VORBIS_TO_LIBAVCODEC``, FFmpeg's
  ``ff_vorbis_channel_layout_offsets``); families 2 and 255 keep the
  table's order;
- a duplicated table entry copies its stream channel, and libavcodec
  then scales the copy by the output gain once more (its gain loop runs
  over the copied channel after the copy);
- a packet whose streams decode to different sample counts (a SILK
  stream's resampler delay beside a CELT stream) gives the least count
  any stream has ready, and the rest waits for the next packet;
- the end of the stream flushes nothing: what one stream has decoded
  beyond the others stays unplayed, as libavcodec leaves it;
- output gain and pre-skip apply to the interleaved output once, with
  ``_OpusCore._post``'s float32 arithmetic.

Two stated departures, where the port gives what libopus's
``opus_multistream_decode_float`` gives:

- libavcodec points the output of stream 0's first channel at every
  table entry 255 as well (its silent channels keep the zeroed stream
  and channel indices), so a silent channel after that stream channel's
  own output takes its samples and is then cleared, and the output
  channel itself keeps whatever its buffer held before. The port gives
  that output channel its stream channel;
- where the streams' counts differ (above), libavcodec's sync buffer
  hands the waiting samples out at the next packet but drops as many of
  that packet's own, so the stream that was ahead runs that many samples
  early from then on. The port keeps every sample, and the streams stay
  aligned.

Each stream's ``_OpusCore`` is built from a family-0 head with no
pre-skip and no gain, so it keeps its own native CELT fast path and its
own replay history. A packet that does not split, whose streams disagree
in duration, or that an elementary decoder refuses raises
``DecodingFailed``, as the single-stream decoder does for a packet it
refuses; nothing is filled with silence.
"""
from __future__ import annotations

import math
import struct
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from soundkit_tpu_torch.pipeline.output_options import DecodingFailed, UnsupportedFormat

#: family-1 output channel k carries Vorbis-order input channel
#: ``VORBIS_TO_LIBAVCODEC[channels][k]`` (FFmpeg's
#: ``ff_vorbis_channel_layout_offsets``)
VORBIS_TO_LIBAVCODEC = {
    1: (0,),
    2: (0, 1),
    3: (0, 2, 1),
    4: (0, 1, 2, 3),
    5: (0, 2, 1, 3, 4),
    6: (0, 2, 1, 5, 3, 4),
    7: (0, 2, 1, 6, 5, 3, 4),
    8: (0, 2, 1, 7, 5, 6, 3, 4),
}


@dataclass(frozen=True)
class ChannelMapping:
    """A parsed channel mapping table: ``streams`` (N), ``coupled`` (M)
    and ``table`` (one entry a channel, in the head's order); ``order``
    is the table entry each output channel takes, in libavcodec's
    output order."""

    streams: int
    coupled: int
    table: Tuple[int, ...]
    order: Tuple[int, ...]

    @property
    def channels(self) -> int:
        return len(self.table)

    def source(self, k: int) -> Tuple[int, int]:
        """(stream, channel) of output channel ``k``, or (-1, 0) for
        silence."""
        idx = self.table[self.order[k]]
        if idx == 255:
            return -1, 0
        if idx < 2 * self.coupled:
            return idx // 2, idx % 2
        return idx - self.coupled, 0


def _refuse(head, why: str) -> UnsupportedFormat:
    return UnsupportedFormat(
        f"Unsupported format: OpusHead of mapping family {head.mapping_family} and "
        f"{head.channels} channels: {why}; the JAX package's libavcodec cannot open "
        "it either")


def parse_channel_mapping(head) -> ChannelMapping:
    """The channel mapping of an ``OpusHead`` of family 1, 2 or 255, with
    libavcodec's checks (``ff_opus_parse_extradata``); raises
    ``UnsupportedFormat`` for a head libavcodec does not open."""
    raw, ch, fam = head.raw, head.channels, head.mapping_family
    if head.version > 15:
        raise _refuse(head, f"version {head.version}")
    if ch == 0:
        raise _refuse(head, "no channels")
    if fam == 0:
        raise _refuse(head, "family 0 is specified for one or two channels")
    if fam not in (1, 2, 255):
        raise _refuse(head, "the family is not 1, 2 or 255")
    if len(raw) < 21 + ch:
        raise _refuse(head, f"a {len(raw)}-byte head has no whole channel mapping table")
    n, m = raw[19], raw[20]
    if n == 0 or m > n or n + m > 255:
        raise _refuse(head, f"{n} streams, {m} coupled")
    if fam == 1 and ch > 8:
        raise _refuse(head, "family 1 is specified for up to 8 channels")
    if fam == 2:
        side = math.isqrt(ch)
        if ch not in (side * side, side * side + 2) or ch > 227:
            raise _refuse(head, "family 2 needs (n + 1)^2 or (n + 1)^2 + 2 channels, at most 227")
    table = tuple(raw[21:21 + ch])
    for k, idx in enumerate(table):
        if idx != 255 and idx >= n + m:
            raise _refuse(head, f"channel {k} maps to {idx}, past {n} streams and {m} coupled")
    order = VORBIS_TO_LIBAVCODEC[ch] if fam == 1 else tuple(range(ch))
    return ChannelMapping(n, m, table, tuple(order))


def _bad(what: str) -> DecodingFailed:
    return DecodingFailed(f"multistream Opus packet: {what}")


def _parse_size(data: bytes, pos: int, avail: int) -> Tuple[int, int]:
    """(size, bytes read) of a 1- or 2-byte frame length at ``pos`` with
    ``avail`` bytes left (libopus's ``parse_size``)."""
    if avail < 1 or (data[pos] >= 252 and avail < 2):
        raise _bad("truncated frame length")
    if data[pos] < 252:
        return data[pos], 1
    return data[pos] + 4 * data[pos + 1], 2


def _samples_per_frame(toc: int) -> int:
    """48 kHz samples of one frame of TOC byte ``toc`` (RFC 6716 §3.1)."""
    if toc & 0x80:
        return 120 << ((toc >> 3) & 3)
    if (toc & 0x60) == 0x60:
        return 960 if toc & 0x08 else 480
    size = (toc >> 3) & 3
    return 2880 if size == 3 else 480 << size


def packet_samples(data: bytes) -> int:
    """48 kHz samples of an Opus packet, single-stream or multistream (its
    first stream's TOC and frame count; every stream lasts as long)."""
    code = data[0] & 3
    count = 1 if code == 0 else 2 if code < 3 else data[1] & 0x3F
    return _samples_per_frame(data[0]) * count


def _parse_one(data: bytes, pos: int, self_delimited: bool) -> Tuple[bytes, int, int, list]:
    """(ordinary packet, 48 kHz samples, end, frame sizes) of the Opus
    packet at ``pos``, after libopus's ``opus_packet_parse_impl``. A self-delimited
    packet comes back without the length of its last frame, which an
    ordinary packet leaves implicit; its padding stays."""
    if pos >= len(data):
        raise _bad("a stream has no bytes")
    toc = data[pos]
    p = pos + 1
    n = len(data) - p  # bytes left for lengths and frames (padding taken off)
    per_frame = _samples_per_frame(toc)
    code = toc & 3
    cbr = False
    pad = 0
    last = n
    sizes = []
    if code == 0:
        count = 1
    elif code == 1:
        count, cbr = 2, True
        if not self_delimited:
            if n & 1:
                raise _bad("code 1 of odd length")
            last = n // 2
            sizes = [last]
    elif code == 2:
        count = 2
        s, k = _parse_size(data, p, n)
        n -= k
        if s > n:
            raise _bad("code 2 length past the end")
        p += k
        sizes = [s]
        last = n - s
    else:
        if n < 1:
            raise _bad("code 3 without its frame count")
        ch = data[p]
        p += 1
        n -= 1
        count = ch & 0x3F
        if count == 0 or per_frame * count > 5760:
            raise _bad(f"code 3 of {count} frames of {per_frame} samples")
        if ch & 0x40:
            while True:
                if n <= 0:
                    raise _bad("truncated padding length")
                b = data[p]
                p += 1
                n -= 1
                n -= 254 if b == 255 else b
                pad += 254 if b == 255 else b
                if b != 255:
                    break
        if n < 0:
            raise _bad("padding past the end")
        cbr = not ch & 0x80
        if not cbr:
            last = n
            for _ in range(count - 1):
                s, k = _parse_size(data, p, n)
                n -= k
                if s > n:
                    raise _bad("frame length past the end")
                p += k
                sizes.append(s)
                last -= k + s
            if last < 0:
                raise _bad("frame lengths past the end")
        elif not self_delimited:
            last = n // count
            if last * count != n:
                raise _bad("code 3 CBR frames of uneven length")
            sizes = [last] * (count - 1)
    head_end = skip = p
    if self_delimited:
        s, k = _parse_size(data, p, n)
        n -= k
        if s > n:
            raise _bad("last frame past the end")
        p += k
        skip = p
        if cbr:
            if s * count > n:
                raise _bad("CBR frames past the end")
            sizes = [s] * count
        elif k + s > last:
            raise _bad("last frame past the end")
        else:
            sizes.append(s)
    else:
        if last > 1275:
            raise _bad(f"a frame of {last} bytes")
        sizes.append(last)
    stop = p + sum(sizes) + pad
    if stop > len(data):
        raise _bad("frames past the end")
    return data[pos:head_end] + data[skip:stop], per_frame * count, stop, sizes


def _split(data: bytes, n_streams: int) -> List[Tuple[bytes, list]]:
    """(ordinary packet, frame sizes) of each stream of a multistream
    packet."""
    data = bytes(data)
    out = []
    pos = 0
    duration = None
    for i in range(n_streams):
        packet, samples, pos, sizes = _parse_one(data, pos, i < n_streams - 1)
        if duration is None:
            duration = samples
        elif samples != duration:
            raise _bad(f"stream {i} lasts {samples} samples, stream 0 {duration}")
        out.append((packet, sizes))
    return out


def split_multistream_packet(data: bytes, n_streams: int) -> List[bytes]:
    """The ``n_streams`` ordinary Opus packets of a multistream packet
    (RFC 6716 Appendix B: ``n_streams - 1`` self-delimited packets, then
    one ordinary packet). Raises ``DecodingFailed`` for a packet that runs
    past its end or whose streams disagree in duration."""
    return [packet for packet, _sizes in _split(data, n_streams)]


def _elementary_head(channels: int) -> bytes:
    """A family-0 OpusHead of ``channels``, no pre-skip, no gain."""
    return b"OpusHead" + bytes([1, channels]) + struct.pack("<HIhB", 0, 48000, 0, 0)


class _MultistreamCore:
    """Multistream Opus decode with the ``_OpusCore`` surface
    (``channels``, ``sample_rate``, ``head``, ``decode_packet_f32``,
    ``flush_f32``): one elementary ``_OpusCore`` a stream, the outputs
    mapped to the head's channels in libavcodec's order."""

    def __init__(self, head):
        from soundkit_tpu_torch.codecs.opus import OPUS_SAMPLE_RATE, OpusHead, _OpusCore

        self.head = head
        m = parse_channel_mapping(head)
        self.sample_rate = OPUS_SAMPLE_RATE
        self.channels = head.channels
        self._cores = [
            _OpusCore(OpusHead.parse(_elementary_head(2 if s < m.coupled else 1)))
            for s in range(m.streams)
        ]
        self._sources = [m.source(k) for k in range(self.channels)]
        # a later duplicate of a stream channel: libavcodec copies the
        # earlier output channel, already scaled by the gain, and scales it
        # again
        seen = set()
        self._copies = []
        for k, src in enumerate(self._sources):
            self._copies.append(src[0] >= 0 and src in seen)
            seen.add(src)
        self._pending = [np.zeros((0, 2 if s < m.coupled else 1), np.float32)
                         for s in range(m.streams)]
        self._skip = head.pre_skip
        self._gain = 10.0 ** (head.output_gain / (20.0 * 256.0)) if head.output_gain else 1.0
        self._failed = False

    def _emit(self) -> np.ndarray:
        """The samples every stream has ready, mapped, scaled and
        trimmed; the rest of each stream waits."""
        n = min(p.shape[0] for p in self._pending)
        out = np.zeros((n, self.channels), np.float32)
        for k, (s, c) in enumerate(self._sources):
            if s >= 0:
                out[:, k] = self._pending[s][:n, c]
        self._pending = [p[n:] for p in self._pending]
        if self._gain != 1.0:
            g = np.float32(self._gain)
            out = out * g
            if any(self._copies):
                out[:, self._copies] *= g
        if self._skip:
            k = min(self._skip, n)
            out = out[k:]
            self._skip -= k
        return out.reshape(-1)

    def decode_packet_f32(self, packet: bytes) -> np.ndarray:
        if self._failed:
            return np.zeros(0, dtype=np.float32)
        try:
            split = _split(packet, len(self._cores))
            for s, (_part, sizes) in enumerate(split):
                if 0 in sizes:
                    # libopus and libavcodec conceal a frame of no bytes (a
                    # lost or DTX frame); the owned decoder has no
                    # concealment to match
                    raise _bad(f"stream {s} has a frame of no bytes (lost or DTX)")
            for s, (core, (part, _sizes)) in enumerate(zip(self._cores, split)):
                pcm = core.decode_packet_f32(part).reshape(-1, core.channels)
                self._pending[s] = np.concatenate([self._pending[s], pcm])
        except DecodingFailed:
            self._failed = True
            raise
        return self._emit()

    def flush_f32(self) -> np.ndarray:
        """Nothing: the samples one stream has beyond the others stay
        unplayed at the end, as libavcodec's flush leaves them."""
        return np.zeros(0, dtype=np.float32)
