"""The host libraries of the port, bound with ``ctypes``: the AAC-LC
syntax parser, the FLAC walk, the MP3 syntax parser, the Opus parse
(CELT, SILK and the hybrid glue) and the Vorbis packet parse.

``AacHostParser`` holds a parser handle ``_h`` of the library ``_lib``,
which the wire packers of ``codecs/aac_lc_native.py``
(``prepare_v4_batch_packed``, ``prepare_frame_batch_grouped``) call;
:meth:`pack_v4` calls the first for callers of the port. The library
is the port's copy of the parser source, ``native_src/src/aac_parse.cpp``,
built alone (see ``_build.py``): no FFmpeg.

:func:`flac_library` is the port's copy of ``native_src/src/flac.cpp``
with the signatures ``models/flac_batch.py`` calls: a handle per stream
(``skt_flac_new`` / ``free``), ``feed`` and ``drain`` at push time,
``queued``, ``info`` and ``error``, and ``queue_stats`` /
``export_rounds``, which size and scatter a whole collect's wire.

:func:`mp3_library` is the port's copy of ``native_src/src/mp3_parse.cpp``
with the signatures ``codecs/mp3_native.py`` and
``models/mp3_batch_model.py`` call: a handle per stream (``skt_mp3_new``
/ ``free``), ``push``, and the three pops (one granule, one granule a
lane, up to ``G`` granules a lane into a collect's packed wire).

:func:`opus_library` is the port's build of ``native_src/src/celt_parse.cpp``,
``silk_parse.cpp`` and ``hybrid_glue.cpp`` as one library, with the
signatures ``codecs/celt_native.py`` and ``codecs/silk_native.py`` call:
the table pushes of both codecs, a handle per stream and codec
(``skt_celt_new`` / ``free`` / ``reset``, ``skt_silk_new`` / ``free`` /
``reset``), the CELT serving walk over a collect's rounds on the float32
and the int16 wire (``skt_celt_parse_rounds`` / ``_q``), the SILK
parse-export of one round (``skt_silk_parse_many``) and the hybrid walk
of a chunk of rounds into its packed wire
(``skt_hybrid_parse_rounds_packed``).

:func:`vorbis_library` is the port's copy of ``native_src/src/vorbis_parse.cpp``
with its ten entry points, as ``codecs/vorbis_native.py`` calls them: a
handle per stream (``skt_vorbis_new`` / ``free``), the setup pushes
(``add_codebook``, ``add_floor1``, ``add_residue``, ``add_mapping``,
``add_mode``, ``finish``) and the parse of one audio packet into its
spectrum (``skt_vorbis_packet``).

:func:`flac_pack_library` is the port's copy of ``native_src/src/flac_pack.cpp``,
the FLAC frame packer of the encode direction: many frames from the
analysis plans (``skt_flac_pack_frames`` and ``skt_flac_pack_frames16``,
which recompute each residual from its plan), one frame from explicit
subframe plans (``skt_flac_pack_frame1``, ``codecs/flac_encode.py``) and
the big-endian word scatter of frame bytes (``skt_pack_frames_be``).
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


@functools.lru_cache(maxsize=1)
def flac_library() -> ctypes.CDLL:
    """The standalone FLAC walk with the signatures the batched decoder
    calls (every pointer typed: a missing argtype cuts it to 32 bits)."""
    from numpy.ctypeslib import ndpointer

    lib = ctypes.CDLL(str(_build.flac_library_path()))

    def arr(dt):
        return ndpointer(dt, flags="C_CONTIGUOUS")

    vp, c_long = ctypes.c_void_p, ctypes.c_long
    handles = ctypes.POINTER(vp)
    i32 = arr(np.int32)
    lib.skt_flac_new.restype = vp
    lib.skt_flac_new.argtypes = []
    lib.skt_flac_free.restype = None
    lib.skt_flac_free.argtypes = [vp]
    lib.skt_flac_feed.restype = ctypes.c_int
    lib.skt_flac_feed.argtypes = [vp, ctypes.c_char_p, c_long]
    lib.skt_flac_drain.restype = c_long
    lib.skt_flac_drain.argtypes = [vp, c_long, c_long, c_long]
    lib.skt_flac_queued.restype = c_long
    lib.skt_flac_queued.argtypes = [vp]
    lib.skt_flac_info.restype = ctypes.c_int
    lib.skt_flac_info.argtypes = [vp, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(c_long), ctypes.POINTER(ctypes.c_longlong)]
    lib.skt_flac_error.restype = ctypes.c_char_p
    lib.skt_flac_error.argtypes = [vp]
    lib.skt_flac_queue_stats.restype = None
    lib.skt_flac_queue_stats.argtypes = [handles, ctypes.c_int, c_long, arr(np.int64)]
    lib.skt_flac_export_rounds.restype = c_long
    lib.skt_flac_export_rounds.argtypes = [
        handles, ctypes.c_int, c_long, c_long, c_long, arr(np.uint32),
        i32, i32, i32, i32, i32,                 # seg lane, bitoff, k, n, dest
        i32, i32, i32, i32, i32, i32, i32,       # warm, cflag, cval, coef, order, shift, wasted
        i32, i32, arr(np.uint8), i32,            # assign, block size, valid, meta
        i32, i32, i32, i32,                      # parts slot, meta, resw, coef
    ]
    return lib


@functools.lru_cache(maxsize=1)
def mp3_library() -> ctypes.CDLL:
    """The standalone MP3 parser with the signatures the batched decoder
    calls (every pointer typed: a missing argtype cuts it to 32 bits)."""
    from numpy.ctypeslib import ndpointer

    lib = ctypes.CDLL(str(_build.mp3_library_path()))

    def arr(dt):
        return ndpointer(dt, flags="C_CONTIGUOUS")

    vp, c_int, c_long = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    handles = ctypes.POINTER(vp)
    i16, i32, u8 = arr(np.int16), arr(np.int32), arr(np.uint8)
    lib.skt_mp3_new.restype = vp
    lib.skt_mp3_new.argtypes = []
    lib.skt_mp3_free.restype = None
    lib.skt_mp3_free.argtypes = [vp]
    lib.skt_mp3_push.restype = c_long
    lib.skt_mp3_push.argtypes = [vp, ctypes.c_char_p, c_long]
    lib.skt_mp3_pop.restype = c_int
    lib.skt_mp3_pop.argtypes = [vp, i16, i16, i32]
    lib.skt_mp3_pop_batch.restype = c_int
    lib.skt_mp3_pop_batch.argtypes = [
        handles, c_int, i16, i16,   # quant, expq
        i32, u8, i32,               # block type, mixed, n_alias
        u8, u8, i32,                # ms, valid, rate
    ]
    lib.skt_mp3_pop_rounds.restype = None
    lib.skt_mp3_pop_rounds.argtypes = [
        handles, c_int, c_int, u8,  # wire [G, stride]
        c_long,                     # stride
        c_long, c_long, c_long, c_long, c_long, c_long, c_long,  # field offsets
        i32, i32,                   # rate [B], popped [B]
    ]
    return lib


@functools.lru_cache(maxsize=1)
def opus_library() -> ctypes.CDLL:
    """The Opus parse library (CELT, SILK, hybrid glue) with the
    signatures the batched decoders call (every pointer typed: a missing
    argtype cuts it to 32 bits). Its tables are not pushed here
    (``codecs/celt_native.py`` and ``codecs/silk_native.py`` do)."""
    from numpy.ctypeslib import ndpointer

    lib = ctypes.CDLL(str(_build.opus_library_path()))

    def arr(dt):
        return ndpointer(dt, flags="C_CONTIGUOUS")

    vp, c_int, c_long = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    handles = ctypes.POINTER(vp)
    i32, i64, f32, f64 = arr(np.int32), arr(np.int64), arr(np.float32), arr(np.float64)
    lib.skt_celt_table_i.restype = c_int
    lib.skt_celt_table_i.argtypes = [ctypes.c_char_p, i64, c_long]
    lib.skt_celt_table_f.restype = c_int
    lib.skt_celt_table_f.argtypes = [ctypes.c_char_p, f64, c_long]
    lib.skt_celt_tables_done.restype = c_int
    lib.skt_celt_tables_done.argtypes = []
    lib.skt_celt_new.restype = vp
    lib.skt_celt_new.argtypes = [c_int]
    lib.skt_celt_free.restype = None
    lib.skt_celt_free.argtypes = [vp]
    lib.skt_celt_reset.restype = None
    lib.skt_celt_reset.argtypes = [vp]
    walk = [handles, c_int, c_int, ctypes.c_char_p, i64,  # handles, B, R, buf, base
            i32, i32, i32, c_int, c_int, c_int]           # lens, ends, coded, n, C, W
    lib.skt_celt_parse_rounds.restype = c_int
    lib.skt_celt_parse_rounds.argtypes = [*walk, f32, f32, i32, i32]  # freq, comb, sflag, ok
    lib.skt_celt_parse_rounds_q.restype = c_int
    lib.skt_celt_parse_rounds_q.argtypes = [*walk, arr(np.int16), f32, f32, i32, i32]  # + scales
    # the SILK and hybrid entries take ctypes pointers (``a.ctypes.data_as``),
    # as the JAX package's ``codecs/silk_native.py`` passes them
    P = ctypes.POINTER
    dp, ip, lp = P(ctypes.c_double), P(c_int), P(c_long)
    lib.skt_silk_table.restype = None
    lib.skt_silk_table.argtypes = [ctypes.c_char_p, P(ctypes.c_int64), c_long]
    lib.skt_silk_tables_done.restype = c_int
    lib.skt_silk_tables_done.argtypes = []
    lib.skt_silk_new.restype = vp
    lib.skt_silk_new.argtypes = []
    lib.skt_silk_free.restype = None
    lib.skt_silk_free.argtypes = [vp]
    lib.skt_silk_reset.restype = None
    lib.skt_silk_reset.argtypes = [vp]
    lib.skt_silk_parse_many.restype = c_int
    lib.skt_silk_parse_many.argtypes = [
        handles, c_int, ctypes.c_char_p, lp, lp,  # handles, B, buf, offs, lens
        ip, ip, ip, P(ctypes.c_ubyte),            # bws, coded, duration ms, valid
        dp, dp, dp, dp, dp, dp,                   # exc, gains, coef, ltp, ltpscale, stereo_w
        ip, ip, lp, lp,                           # lags, flags, n, info
    ]
    lib.skt_hybrid_parse_rounds_packed.restype = c_int
    lib.skt_hybrid_parse_rounds_packed.argtypes = [
        handles, handles, c_int, c_int, ctypes.c_char_p,  # silk, celt handles, B, R, buf
        lp, ip, ip, ip,                                   # base, lens, ends, coded
        c_int, c_int, c_int, c_int,                       # frame size, C, bin lo, bin len
        P(ctypes.c_ubyte), lp, lp, ip, ip, dp,            # wire, offsets, n, ok, red, exc f64
    ]
    return lib


@functools.lru_cache(maxsize=1)
def vorbis_library() -> ctypes.CDLL:
    """The Vorbis packet parse with the signatures ``NativeVorbisParser``
    calls (ctypes pointers, as the JAX package's
    ``codecs/vorbis_native.py`` passes them; every pointer typed)."""
    lib = ctypes.CDLL(str(_build.vorbis_library_path()))
    c_int, c_long = ctypes.c_int, ctypes.c_long
    I32P = ctypes.POINTER(ctypes.c_int32)
    F64P = ctypes.POINTER(ctypes.c_double)
    lib.skt_vorbis_new.restype = ctypes.c_void_p
    lib.skt_vorbis_new.argtypes = [c_int, c_int, c_int, F64P]
    lib.skt_vorbis_free.restype = None
    lib.skt_vorbis_free.argtypes = [ctypes.c_void_p]
    lib.skt_vorbis_add_codebook.restype = c_int
    lib.skt_vorbis_add_codebook.argtypes = [ctypes.c_void_p, c_int, c_int, I32P, F64P, c_long]
    lib.skt_vorbis_add_floor1.restype = c_int
    lib.skt_vorbis_add_floor1.argtypes = [ctypes.c_void_p, I32P, c_int, I32P, I32P, I32P, I32P,
                                          c_int, c_int, I32P, c_int]
    lib.skt_vorbis_add_residue.restype = c_int
    lib.skt_vorbis_add_residue.argtypes = [ctypes.c_void_p, c_int, c_long, c_long, c_long, c_int,
                                           c_int, I32P]
    lib.skt_vorbis_add_mapping.restype = c_int
    lib.skt_vorbis_add_mapping.argtypes = [ctypes.c_void_p, c_int, I32P, I32P, c_int, I32P, I32P,
                                           I32P]
    lib.skt_vorbis_add_mode.restype = c_int
    lib.skt_vorbis_add_mode.argtypes = [ctypes.c_void_p, c_int, c_int]
    lib.skt_vorbis_finish.restype = c_int
    lib.skt_vorbis_finish.argtypes = [ctypes.c_void_p]
    lib.skt_vorbis_packet.restype = c_int
    lib.skt_vorbis_packet.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, c_long, F64P,
        ctypes.POINTER(c_int), ctypes.POINTER(c_int), ctypes.POINTER(c_int)]
    return lib



@functools.lru_cache(maxsize=1)
def flac_pack_library() -> ctypes.CDLL:
    """The FLAC frame packer with the signatures the batched encoder and
    ``codecs/flac_encode.py`` call (the JAX package's argtypes; every
    pointer typed)."""
    from numpy.ctypeslib import ndpointer

    lib = ctypes.CDLL(str(_build.flac_pack_library_path()))
    i32 = ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64 = ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8 = ndpointer(np.uint8, flags="C_CONTIGUOUS")
    c_int, c_long = ctypes.c_int, ctypes.c_long
    for name, block in (("skt_flac_pack_frames", i32),
                        ("skt_flac_pack_frames16", ndpointer(np.int16, flags="C_CONTIGUOUS"))):
        fn = getattr(lib, name)
        fn.restype = c_long
        fn.argtypes = [c_long, c_long, c_int, c_int, c_int, c_int, i64, i32, i32, i32, i32, i32,
                       c_int, ctypes.c_void_p, block, u8, c_long, i64]
    lib.skt_flac_pack_frame1.restype = c_long
    lib.skt_flac_pack_frame1.argtypes = [
        c_long, c_int, c_int, c_int, ctypes.c_longlong, c_int, c_int, i32, i32, i32, i32, i64,
        i64, i32, u8, c_long]
    lib.skt_pack_frames_be.restype = None
    lib.skt_pack_frames_be.argtypes = [c_long, ctypes.c_char_p, i64, i64, c_long,
                                       ndpointer(np.uint32, flags="C_CONTIGUOUS")]
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
