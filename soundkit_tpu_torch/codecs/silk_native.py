"""SILK host parse of the port (counterpart of
``soundkit_tpu/codecs/silk_native.py``): range decode and the
NLSF / LTP / gain / excitation parse of ``native_src/src/silk_parse.cpp``
in the port's Opus parse library (``native.opus_library``), exporting the
synthesis inputs that the batched SILK synthesis (``ops/silk_batch.py``)
consumes, and the hybrid walk of ``native_src/src/hybrid_glue.cpp``,
which continues every lane's range coder into the CELT parse.

The spec tables are pushed from the port's copy of the RFC 6716 set
(``codecs/opus_tables.py``) when the library loads, as the JAX package
does. Bound here, as verbatim copies of the JAX package's methods:
``SilkNativeError``, ``_TABLE_KEYS``, :class:`NativeSilkDecoder` (one
stream's SILK state: ``__init__``, ``__del__``, ``flush``) and
:class:`NativeSilkBatch` with ``reset_lane``, the per-round
parse-export ``parse_many`` and the packed hybrid walk
``hybrid_parse_rounds_packed``. The single-stream
``NativeSilkDecoder.decode_superframe``, the batch ``decode_many``, the
unpacked ``hybrid_parse_rounds`` and ``NativeSilkEncoder`` are not
bound yet.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from soundkit_tpu_torch.codecs.opus_tables import tables
from soundkit_tpu_torch.native import opus_library


class SilkNativeError(RuntimeError):
    pass


_TABLE_KEYS = (
    "silk_model_stereo_s1", "silk_model_stereo_s2",
    "silk_model_stereo_s3", "silk_model_mid_only",
    "silk_model_frame_type_inactive", "silk_model_frame_type_active",
    "silk_model_gain_highbits", "silk_model_gain_lowbits",
    "silk_model_gain_delta", "silk_model_lsf_s1", "silk_model_lsf_s2",
    "silk_model_lsf_s2_ext", "silk_model_lsf_interpolation_offset",
    "silk_model_pitch_highbits", "silk_model_pitch_lowbits_nb",
    "silk_model_pitch_lowbits_mb", "silk_model_pitch_lowbits_wb",
    "silk_model_pitch_delta", "silk_model_pitch_contour_nb10ms",
    "silk_model_pitch_contour_nb20ms",
    "silk_model_pitch_contour_mbwb10ms",
    "silk_model_pitch_contour_mbwb20ms", "silk_model_ltp_filter",
    "silk_model_ltp_filter0_sel", "silk_model_ltp_filter1_sel",
    "silk_model_ltp_filter2_sel", "silk_model_ltp_scale_index",
    "silk_model_lcg_seed", "silk_model_exc_rate",
    "silk_model_pulse_count", "silk_model_pulse_location",
    "silk_model_excitation_lsb", "silk_model_excitation_sign",
    "silk_model_lbrr_flags_40", "silk_model_lbrr_flags_60",
    "silk_lsf_s2_model_sel_nbmb", "silk_lsf_s2_model_sel_wb",
    "silk_lsf_pred_weights_nbmb", "silk_lsf_pred_weights_wb",
    "silk_lsf_weight_sel_nbmb", "silk_lsf_weight_sel_wb",
    "silk_lsf_codebook_nbmb", "silk_lsf_codebook_wb",
    "silk_lsf_min_spacing_nbmb", "silk_lsf_min_spacing_wb",
    "silk_lsf_ordering_nbmb", "silk_lsf_ordering_wb", "silk_cosine",
    "silk_pitch_scale", "silk_pitch_min_lag", "silk_pitch_max_lag",
    "silk_pitch_offset_nb10ms", "silk_pitch_offset_nb20ms",
    "silk_pitch_offset_mbwb10ms", "silk_pitch_offset_mbwb20ms",
    "silk_ltp_filter0_taps", "silk_ltp_filter1_taps",
    "silk_ltp_filter2_taps", "silk_ltp_scale_factor",
    "silk_shell_blocks", "silk_quant_offset", "silk_stereo_weights",
    "silk_stereo_interp_len",
)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = opus_library()
    t = tables()
    for key in _TABLE_KEYS:
        a = np.ascontiguousarray(
            np.asarray(t[key]).reshape(-1), dtype=np.int64)
        lib.skt_silk_table(
            key[5:].encode(),
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), a.size)
    if lib.skt_silk_tables_done() != 0:
        raise SilkNativeError("silk table finalize failed")
    return lib


class NativeSilkDecoder:
    """One stream's SILK parse state (a handle of the library)."""

    def __init__(self) -> None:
        self._lib = _lib()
        self._h = self._lib.skt_silk_new()
        if not self._h:
            raise SilkNativeError("skt_silk_new failed")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.skt_silk_free(self._h)
            self._h = None

    def flush(self) -> None:
        self._lib.skt_silk_reset(self._h)


class NativeSilkBatch:
    """B lockstep SILK stream states with single-call batch walks (the
    fleet serving shape; mirrors NativeCeltBatch)."""

    def __init__(self, num_streams: int, channels: int = 1):
        self._lib = _lib()
        self.B = num_streams
        self.C = channels
        self._decoders = [NativeSilkDecoder() for _ in range(num_streams)]
        self._handles = (ctypes.c_void_p * num_streams)(
            *[d._h for d in self._decoders])

    def reset_lane(self, b: int) -> None:
        self._decoders[b].flush()

    def hybrid_parse_rounds_packed(self, celt_batch, buf, base, plens,
                                   ends, coded, wire, offs, exc_f64,
                                   frame_size: int = 960,
                                   bin_lo: int = 320,
                                   bin_len: int = 480):
        """Packed-wire fused hybrid walk: the native call converts
        every device-bound plane straight into ``wire`` (the
        models/opus_batch.py ``_hybrid_wire_layout``, int16 Q23
        excitation + f32 planes + trimmed CELT window) — the numpy
        conversions were ~0.5 s/pass on the 1-core host.  ``offs`` is
        the 15-entry field-offset table (int64, layout order).  On
        excitation overflow the full f64 excitation lands in
        ``exc_f64`` [R, B, 2, 320] so the caller can rebuild the f32
        wire without re-walking the stateful handles (SILK parameters
        are delta-coded across frames).  Returns (exc_overflowed,
        n [R, B], ok [R, B], red [R, B])."""
        lib = self._lib
        if not hasattr(lib, "_skt_hybrid_packed_ready"):
            lib.skt_hybrid_parse_rounds_packed.restype = ctypes.c_int
            lib._skt_hybrid_packed_ready = True
        B, R = plens.shape
        C = celt_batch.C
        n = np.zeros((R, B), np.int64)
        ok = np.zeros((R, B), np.int32)
        red = np.zeros((R, B), np.int32)
        i = lambda a: a.ctypes.data_as(  # noqa: E731
            ctypes.POINTER(ctypes.c_int))
        l = lambda a: a.ctypes.data_as(  # noqa: E731
            ctypes.POINTER(ctypes.c_long))
        base_a = np.ascontiguousarray(base, np.int64)
        plens_a = np.ascontiguousarray(plens, np.int32)
        ends_a = np.ascontiguousarray(ends, np.int32)
        coded_a = np.ascontiguousarray(coded, np.int32)
        offs_a = np.ascontiguousarray(offs, np.int64)
        overflow = lib.skt_hybrid_parse_rounds_packed(
            self._handles, celt_batch._handles, B, R, buf,
            l(base_a), i(plens_a), i(ends_a), i(coded_a),
            frame_size, C, bin_lo, bin_len,
            wire.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            l(offs_a), l(n), i(ok), i(red),
            exc_f64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return overflow, n, ok, red

    def parse_many(self, frames, bws, coded, durations, valid):
        """Parse-export for the device LTP/LPC split: walk every
        lane's single-frame (10/20 ms) payload, export the synthesis
        inputs and the final range-coder state (hybrid continuation),
        and leave synthesis + output history to the device kernel
        (ops/silk_batch.py).

        Returns a dict of per-lane arrays (layout documented at
        native/src/silk_parse.cpp skt_silk_parse_many)."""
        lib = self._lib
        if not hasattr(lib, "_skt_silk_parse_ready"):
            dp = ctypes.POINTER(ctypes.c_double)
            ip = ctypes.POINTER(ctypes.c_int)
            lp = ctypes.POINTER(ctypes.c_long)
            lib.skt_silk_parse_many.restype = ctypes.c_int
            lib.skt_silk_parse_many.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                ctypes.c_char_p, lp, lp, ip, ip, ip,
                ctypes.POINTER(ctypes.c_ubyte),
                dp, dp, dp, dp, dp, dp, ip, ip, lp, lp]
            lib._skt_silk_parse_ready = True
        B = self.B
        buf = b"".join(f for f, v in zip(frames, valid) if v)
        offs = np.zeros(B, dtype=np.int64)
        lens = np.zeros(B, dtype=np.int64)
        pos = 0
        for b in range(B):
            if valid[b]:
                offs[b] = pos
                lens[b] = len(frames[b])
                pos += lens[b]
        bws_a = np.ascontiguousarray(bws, dtype=np.int32)
        coded_a = np.ascontiguousarray(coded, dtype=np.int32)
        dur_a = np.ascontiguousarray(durations, dtype=np.int32)
        valid_a = np.ascontiguousarray(valid, dtype=np.uint8)
        r = {
            "exc": np.zeros((B, 2, 320), np.float64),
            "gains": np.zeros((B, 2, 4), np.float64),
            "coef": np.zeros((B, 2, 2, 16), np.float64),
            "ltp": np.zeros((B, 2, 4, 5), np.float64),
            "ltpscale": np.zeros((B, 2), np.float64),
            "stereo_w": np.zeros((B, 4), np.float64),
            "lags": np.zeros((B, 2, 4), np.int32),
            "flags": np.zeros((B, 12), np.int32),
            "n": np.zeros(B, np.int64),
            "info": np.zeros((B, 13), np.int64),
        }
        d = lambda a: a.ctypes.data_as(  # noqa: E731
            ctypes.POINTER(ctypes.c_double))
        i = lambda a: a.ctypes.data_as(  # noqa: E731
            ctypes.POINTER(ctypes.c_int))
        l = lambda a: a.ctypes.data_as(  # noqa: E731
            ctypes.POINTER(ctypes.c_long))
        lib.skt_silk_parse_many(
            self._handles, B, buf, l(offs), l(lens), i(bws_a),
            i(coded_a), i(dur_a),
            valid_a.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            d(r["exc"]), d(r["gains"]), d(r["coef"]), d(r["ltp"]),
            d(r["ltpscale"]), d(r["stereo_w"]), i(r["lags"]),
            i(r["flags"]), l(r["n"]), l(r["info"]))
        return r
