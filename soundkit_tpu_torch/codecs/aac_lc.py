"""AAC-LC host pieces for the port (copied from
``soundkit_tpu/codecs/aac_lc.py``): the ADTS framer, the window
sequence constants, the sample-rate table and the Huffman codebook
tables with their index unpacking.

The codebooks are the ISO tables in ``data/aac_tables.npz``, a copy of
the JAX package's ``native/generated/aac_tables.npz``.
"""
from __future__ import annotations

import functools
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

TABLES_PATH = Path(__file__).resolve().parent.parent / "data" / "aac_tables.npz"

ONLY_LONG_SEQUENCE = 0
LONG_START_SEQUENCE = 1
EIGHT_SHORT_SEQUENCE = 2
LONG_STOP_SEQUENCE = 3

SAMPLE_RATES = (96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
                16000, 12000, 11025, 8000, 7350)


class AacError(ValueError):
    pass


@functools.lru_cache(maxsize=1)
def raw_tables() -> dict:
    """Every array of ``aac_tables.npz`` by name."""
    return dict(np.load(TABLES_PATH))


# codebook properties: (dimension, label-av offset, signed)
_CB_INFO = {
    1: (4, 3, True), 2: (4, 3, True),        # base-3 signed quads (-1..1)
    3: (4, 3, False), 4: (4, 3, False),      # base-3 unsigned quads + signs
    5: (2, 9, True), 6: (2, 9, True),        # base-9 signed pairs (-4..4)
    7: (2, 8, False), 8: (2, 8, False),      # base-8 unsigned pairs + signs
    9: (2, 13, False), 10: (2, 13, False),   # base-13 unsigned pairs + signs
    11: (2, 17, False),                      # base-17, 16 = escape
}


def _unpack_index(cb: int, idx: int) -> List[int]:
    dim, base, signed = _CB_INFO[cb]
    vals = []
    for _ in range(dim):
        vals.append(idx % base)
        idx //= base
    vals.reverse()
    if signed:
        off = (base - 1) // 2
        vals = [v - off for v in vals]
    return vals


def parse_adts_header(data: bytes, pos: int) -> Tuple[int, int, int, int]:
    """Returns (frame_length, sr_index, channel_config, header_len)."""
    if len(data) - pos < 7:
        raise AacError("short ADTS header")
    b = data[pos : pos + 7]
    if b[0] != 0xFF or (b[1] & 0xF6) != 0xF0:
        raise AacError("bad ADTS sync")
    protection_absent = b[1] & 1
    sr_index = (b[2] >> 2) & 0xF
    chan_cfg = ((b[2] & 1) << 2) | (b[3] >> 6)
    frame_len = ((b[3] & 0x3) << 11) | (b[4] << 3) | (b[5] >> 5)
    header_len = 7 if protection_absent else 9
    return frame_len, sr_index, chan_cfg, header_len


class AdtsStream:
    """Incremental ADTS framer: bytes in, raw AUs (headers stripped)
    out. The first frame fixes ``sr_index`` and ``channel_config``."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self.sr_index: Optional[int] = None
        self.channel_config: Optional[int] = None

    def push(self, data: bytes) -> List[bytes]:
        """Returns raw AUs (ADTS headers stripped)."""
        self._buf.extend(data)
        aus = []
        while True:
            # resync
            i = 0
            while i + 1 < len(self._buf) and not (
                self._buf[i] == 0xFF and (self._buf[i + 1] & 0xF6) == 0xF0
            ):
                i += 1
            if i:
                del self._buf[:i]
            if len(self._buf) < 7:
                break
            try:
                frame_len, sr_idx, chan, hdr = parse_adts_header(bytes(self._buf), 0)
            except AacError:
                del self._buf[:1]
                continue
            if frame_len < hdr:
                del self._buf[:1]
                continue
            if len(self._buf) < frame_len:
                break
            if self.sr_index is None:
                self.sr_index = sr_idx
                self.channel_config = chan
            aus.append(bytes(self._buf[hdr:frame_len]))
            del self._buf[:frame_len]
        return aus
