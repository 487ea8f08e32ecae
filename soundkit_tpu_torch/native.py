"""The AAC-LC host syntax parser, bound for the port.

``AacHostParser`` holds a parser handle ``_h`` of the library ``_lib``,
which the wire packers of ``codecs/aac_lc_native.py``
(``prepare_v4_batch_packed``, ``prepare_frame_batch_grouped``) call;
:meth:`pack_v4` calls the first for callers of the port. The library
is the port's copy of the parser source, ``native_src/src/aac_parse.cpp``,
built alone (see ``_build.py``): no FFmpeg.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import numpy as np

from soundkit_tpu_torch import _build
from soundkit_tpu_torch.codecs.aac_lc_native import prepare_v4_batch_packed


@functools.lru_cache(maxsize=1)
def parser_library() -> ctypes.CDLL:
    """The standalone AAC parser with the signatures the wire packers
    call."""
    from numpy.ctypeslib import ndpointer

    lib = ctypes.CDLL(str(_build.parser_library_path()))

    def arr(dt):
        return ndpointer(dt, flags="C_CONTIGUOUS")

    lib.skt_aac_new.restype = ctypes.c_void_p
    lib.skt_aac_new.argtypes = [ctypes.c_int]
    lib.skt_aac_free.restype = None
    lib.skt_aac_free.argtypes = [ctypes.c_void_p]
    lib.skt_aac_parse_batch.restype = ctypes.c_int
    lib.skt_aac_parse_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, arr(np.int64), arr(np.int64), ctypes.c_int,
        arr(np.int32), arr(np.float32), arr(np.int32), arr(np.int32),
        arr(np.float32), arr(np.int32), arr(np.int32), arr(np.uint8),
        arr(np.uint8), arr(np.float32),
    ]
    lib.skt_aac_parse_batch_v4_ptrs.restype = ctypes.c_int
    lib.skt_aac_parse_batch_v4_ptrs.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), arr(np.int64),
        ctypes.c_int, ctypes.c_int,
        arr(np.int16),   # regions
        arr(np.uint8),   # sf_len
        arr(np.uint8),   # sf_val
        arr(np.uint8),   # msis_len
        arr(np.uint8),   # msis_ms
        arr(np.int8),    # msis_pos
        arr(np.int8),    # msis_sign
        arr(np.int8),    # refl
        arr(np.uint8),   # crb
        arr(np.uint8),   # order
        arr(np.uint32),  # runs
        arr(np.uint8),   # n_runs
        arr(np.uint16),  # spec_bit
        arr(np.uint8),   # pns (u32 view)
        arr(np.uint8),   # seq
        arr(np.uint8),   # shape
        arr(np.uint8),   # chan_valid
        arr(np.uint8),   # au bytes
        arr(np.int32),   # max_cw
        arr(np.int32),   # overflow
    ]
    return lib


class AacHostParser:
    def __init__(self, sr_index: int):
        self._lib = parser_library()
        self._h = self._lib.skt_aac_new(sr_index)
        if not self._h:
            raise MemoryError("skt_aac_new returned NULL")
        self.sr_index = sr_index

    def pack_v4(self, aus: List[Optional[bytes]]) -> Tuple[np.ndarray, bool]:
        """One lockstep batch of raw AUs (``None`` for an idle lane) as
        the packed v4 wire (uint8) and whether any lane overflowed it."""
        buf, _max_steps, overflow = prepare_v4_batch_packed(self, aus)
        return buf, overflow

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.skt_aac_free(self._h)
            self._h = None
