"""The TOC layer of the JAX package's ``codecs/opus_core.py``, copied
verbatim: :class:`OpusUnsupported`, :class:`Toc`, the pre-evaluated
``_TOC_CACHE`` / ``TOC_ATTRS`` and :func:`parse_packet` (RFC 6716 §3).
The packet decoder ``OpusDecoder`` is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass


class OpusUnsupported(ValueError):
    pass


@dataclass(frozen=True)
class Toc:
    config: int
    stereo: bool
    code: int

    @property
    def mode(self) -> str:
        if self.config < 12:
            return "silk"
        if self.config < 16:
            return "hybrid"
        return "celt"

    @property
    def frame_duration(self) -> float:
        """Frame duration in ms."""
        c = self.config
        if c < 12:
            return (10, 20, 40, 60)[c % 4]
        if c < 16:
            return (10, 20)[c % 2]
        return (2.5, 5, 10, 20)[c % 4]

    @property
    def bandwidth(self) -> int:
        """0=NB 1=MB 2=WB 3=SWB 4=FB."""
        c = self.config
        if c < 12:
            return (0, 1, 2)[c // 4]
        if c < 16:
            return 3 + (c - 12) // 2
        return (0, 2, 3, 4)[(c - 16) // 4]


_TOC_CACHE = tuple(
    Toc(tb >> 3, bool((tb >> 2) & 1), tb & 3) for tb in range(256)
)

# (mode, frame_duration_ms, stereo, bandwidth, code) per TOC byte:
# the serving hot paths classify ~75k packets per 1024-stream fleet
# collect, so the Toc properties are pre-evaluated once here
TOC_ATTRS = tuple(
    (t.mode, t.frame_duration, t.stereo, t.bandwidth, t.code)
    for t in _TOC_CACHE
)


def parse_packet(data: bytes) -> tuple:
    """Split an Opus packet into (Toc, [frame bytes]) per RFC §3.2.

    ``data`` must be ``bytes``: the code-0 fast path returns
    ``data[1:]`` without copying, which aliases mutable input if a
    caller ever passed bytearray/memoryview (none do)."""
    if len(data) < 1:
        raise OpusUnsupported("empty packet")
    toc = _TOC_CACHE[data[0]]
    if toc.code == 0:
        # serving fast path: code-0 packets (one frame, no length
        # fields) are the whole fixture corpus — skip the body copy
        # and the per-call Toc construction (the fleet parses ~75k
        # packets per 1024-stream collect)
        return toc, [data[1:]]
    body = data[1:]

    def read_len(b, pos):
        if pos >= len(b):
            raise OpusUnsupported("truncated packet")
        v = b[pos]
        pos += 1
        if v >= 252:
            if pos >= len(b):
                raise OpusUnsupported("truncated packet")
            v += 4 * b[pos]
            pos += 1
        return v, pos

    if toc.code == 1:
        if len(body) % 2:
            raise OpusUnsupported("code 1 with odd payload")
        h = len(body) // 2
        frames = [bytes(body[:h]), bytes(body[h:])]
    elif toc.code == 2:
        n1, pos = read_len(body, 0)
        if n1 > len(body) - pos:
            raise OpusUnsupported("bad code 2 length")
        frames = [bytes(body[pos : pos + n1]), bytes(body[pos + n1 :])]
    else:
        if len(body) < 1:
            raise OpusUnsupported("truncated code 3")
        fc = body[0] & 0x3F
        vbr = bool(body[0] & 0x80)
        pad = bool(body[0] & 0x40)
        pos = 1
        if fc == 0:
            raise OpusUnsupported("zero frame count")
        padding = 0
        if pad:
            while True:
                if pos >= len(body):
                    raise OpusUnsupported("truncated padding")
                p = body[pos]
                pos += 1
                padding += 254 if p == 255 else p
                if p != 255:
                    break
        avail = len(body) - padding
        if vbr:
            lens = []
            for _ in range(fc - 1):
                n, pos = read_len(body, pos)
                lens.append(n)
            rest = avail - pos - sum(lens)
            if rest < 0:
                raise OpusUnsupported("bad vbr lengths")
            lens.append(rest)
        else:
            rest = avail - pos
            if rest % fc:
                raise OpusUnsupported("bad cbr split")
            lens = [rest // fc] * fc
        frames = []
        for n in lens:
            frames.append(bytes(body[pos : pos + n]))
            pos += n
    return toc, frames
