"""MP3 host syntax layer of the port (counterpart of
``soundkit_tpu/codecs/mp3_native.py``): :class:`Mp3Error` and
:class:`NativeMp3Parser`, the C++ parser of one stream.

The parser is the port's own build of ``native_src/src/mp3_parse.cpp``
(``native.mp3_library``): frame sync with ID3 skip, side info, bit
reservoir, MPEG-1 and LSF scalefactors, Huffman big-values and count1,
requantize exponents and the short-block reorder, emitting one compact
granule lane a pop (int16 quant, int16 quarter-exponents).
:func:`pop_wire_rounds` pops the queued granules of several parsers into
rows of the packed wire K10 takes (``ops.mp3_synth.mp3_wire_layout``),
for the batched decoder and the streaming one alike.

The JAX package's pure-Python decoder (``Mp3NativeDecoder``,
``Granule``, ``Mp3Frame``) is not on the batched path and is not
ported here.
"""
from __future__ import annotations

import numpy as np

from soundkit_tpu_torch.native import mp3_library


class Mp3Error(ValueError):
    pass


class NativeMp3Parser:
    """C++ MP3 parser wrapper: bytes -> compact granule lanes
    (int16 quant + int16 quarter-exponents, short-reordered)."""

    def __init__(self) -> None:
        self._lib = mp3_library()
        self._h = self._lib.skt_mp3_new()
        if not self._h:
            raise MemoryError("skt_mp3_new returned NULL")
        self._quant = np.zeros((2, 576), dtype=np.int16)
        self._expq = np.zeros((2, 576), dtype=np.int16)
        self._meta = np.zeros(10, dtype=np.int32)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.skt_mp3_free(self._h)
            self._h = None

    def push(self, data: bytes) -> int:
        """Returns number of granules now buffered."""
        return int(self._lib.skt_mp3_push(self._h, bytes(data), len(data)))

    def pop(self):
        """Returns (quant [2,576] i16, expq [2,576] i16, meta dict) or None."""
        if not self._lib.skt_mp3_pop(self._h, self._quant.reshape(-1),
                                     self._expq.reshape(-1), self._meta):
            return None
        m = self._meta
        meta = dict(
            block_type=(int(m[0]), int(m[3])),
            mixed=(bool(m[1]), bool(m[4])),
            n_alias=(int(m[2]), int(m[5])),
            ms=bool(m[6]),
            nch=int(m[7]),
            sample_rate=int(m[8]),
        )
        return self._quant.copy(), self._expq.copy(), meta


def pop_wire_rounds(lib, handles, B: int, G: int):
    """One C call pops up to ``G`` granules from each of the ``B``
    parsers behind ``handles`` into ``G`` rows of the packed wire;
    returns ``(wire uint8 [G, stride], rate int32 [B], popped int32
    [B])``, ``rate`` the sample rate of each parser's last popped
    granule (0 where none popped). A row of a parser with nothing queued
    is a silent, invalid lane."""
    from soundkit_tpu_torch.ops.mp3_synth import mp3_wire_layout

    layout, stride = mp3_wire_layout(B)
    offs = {name: off for name, off, _, _ in layout}
    wire = np.zeros((G, stride), dtype=np.uint8)
    rate = np.zeros(B, dtype=np.int32)
    popped = np.zeros(B, dtype=np.int32)
    lib.skt_mp3_pop_rounds(
        handles, B, G, wire.reshape(-1), stride,
        offs["bt"], offs["nal"], offs["quant"], offs["expq"],
        offs["mixed"], offs["ms"], offs["valid"], rate, popped,
    )
    return wire, rate, popped
