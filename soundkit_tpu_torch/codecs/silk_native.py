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
stream's SILK state: ``__init__``, ``__del__``, ``flush`` and the
single-stream ``decode_superframe`` of the host decoder,
``codecs/opus_core.OpusDecoder``) and :class:`NativeSilkBatch` with
``reset_lane``, the per-round parse-export ``parse_many`` and the packed
hybrid walk ``hybrid_parse_rounds_packed``, and
:class:`NativeSilkEncoder` (the ``skt_silk_enc_*`` frame encoders, mono
and stereo) that ``codecs/opus_silk_enc.OpusSilkEncoder`` codes its frames
with; and, as verbatim copies too, the batch decode ``decode_many`` (range
decode and synthesis at the internal rate, the host ``BatchedSilkDecoder``'s
round) and the unpacked hybrid walk ``hybrid_parse_rounds`` (float64 planes,
the layout reference of the packed wire).
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

    def decode_superframe(self, frame: bytes, bandwidth: int,
                          coded_channels: int, duration_ms: int,
                          read_redundancy: bool = False):
        nb = 1 + (duration_ms > 20) + (duration_ms > 40)
        flen = 20 * (bandwidth + 2) * (duration_ms // nb // 5)
        out = np.zeros((nb * flen, coded_channels), dtype=np.float64)
        info = np.zeros(13, dtype=np.int64)
        n = self._lib.skt_silk_decode(
            self._h, frame, len(frame), bandwidth, coded_channels,
            duration_ms, 1 if read_redundancy else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            info.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
        if n < 0:
            raise SilkNativeError(f"silk decode failed ({n})")
        red = None
        if info[0]:
            red = {"pos": int(info[1]), "offset": int(info[2]),
                   "size": int(info[3])}
        rc_state = tuple(int(x) for x in info[4:13])
        return out[:n], red, rc_state


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

    def decode_many(self, frames, bws, coded, durations, valid,
                    read_redundancy: bool = False):
        """frames: list of B byte strings (ignored where not valid).

        Returns (pcm [B, max_n, C] f64 at the per-lane internal rate,
        n [B] i64 samples per lane (-1 invalid/error), info [B, 13])."""
        B, C = self.B, self.C
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
        max_n = 0
        for b in range(B):
            if valid[b]:
                nb = 1 + (dur_a[b] > 20) + (dur_a[b] > 40)
                flen = 20 * (bws_a[b] + 2) * (int(dur_a[b]) // int(nb) // 5)
                max_n = max(max_n, int(nb) * flen)
        max_n = max(max_n, 1)
        out = np.zeros((B, max_n, C), dtype=np.float64)
        n_out = np.zeros(B, dtype=np.int64)
        info = np.zeros((B, 13), dtype=np.int64)
        self._lib.skt_silk_decode_many(
            self._handles, B, buf,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            bws_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            coded_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            dur_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            valid_a.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            1 if read_redundancy else 0, C, max_n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n_out.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            info.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
        return out, n_out, info

    def hybrid_parse_rounds(self, celt_batch, buf, base, plens, ends,
                            coded, frame_size: int = 960):
        """Fused hybrid rounds walk (native/src/hybrid_glue.cpp): ONE
        native call chains the SILK parse-export and the CELT
        continuation for R rounds x B lanes over per-lane packed
        packet bytes — the round-4 path paid two ctypes round-trips
        plus fresh marshalling per round (r4 VERDICT next #4).

        The serving path uses :meth:`hybrid_parse_rounds_packed`
        (same walk, planes converted into the packed wire in native
        code); this f64-plane export remains the layout reference and
        the debugging entry.  NOTE the handles are stateful (SILK
        delta-coded parameters) — never walk the same packets through
        both entries.

        ``plens``/``ends``/``coded`` are [B, R] int32 (0 length =
        lane invalid that round); ``base`` [B] int64 byte offset of
        each lane's first packet in ``buf``.  Returns a dict of
        [R, B, ...] silk-export planes plus the celt continuation
        planes (freq, comb, sflag, ok, red)."""
        lib = self._lib
        if not hasattr(lib, "_skt_hybrid_rounds_ready"):
            lib.skt_hybrid_parse_rounds.restype = ctypes.c_int
            lib._skt_hybrid_rounds_ready = True
        B, R = plens.shape
        C = celt_batch.C
        r = {
            "exc": np.zeros((R, B, 2, 320), np.float64),
            "gains": np.zeros((R, B, 2, 4), np.float64),
            "coef": np.zeros((R, B, 2, 2, 16), np.float64),
            "ltp": np.zeros((R, B, 2, 4, 5), np.float64),
            "ltpscale": np.zeros((R, B, 2), np.float64),
            "stereo_w": np.zeros((R, B, 4), np.float64),
            "lags": np.zeros((R, B, 2, 4), np.int32),
            "flags": np.zeros((R, B, 12), np.int32),
            "n": np.zeros((R, B), np.int64),
            "freq": np.zeros((R, B, C, frame_size), np.float64),
            "comb": np.zeros((R, B, 16), np.float64),
            "sflag": np.zeros((R, B), np.int32),
            "ok": np.zeros((R, B), np.int32),
            "red": np.zeros((R, B), np.int32),
        }
        d = lambda a: a.ctypes.data_as(  # noqa: E731
            ctypes.POINTER(ctypes.c_double))
        i = lambda a: a.ctypes.data_as(  # noqa: E731
            ctypes.POINTER(ctypes.c_int))
        l = lambda a: a.ctypes.data_as(  # noqa: E731
            ctypes.POINTER(ctypes.c_long))
        base_a = np.ascontiguousarray(base, np.int64)
        plens_a = np.ascontiguousarray(plens, np.int32)
        ends_a = np.ascontiguousarray(ends, np.int32)
        coded_a = np.ascontiguousarray(coded, np.int32)
        lib.skt_hybrid_parse_rounds(
            self._handles, celt_batch._handles, B, R, buf,
            l(base_a), i(plens_a), i(ends_a), i(coded_a),
            frame_size, C,
            d(r["exc"]), d(r["gains"]), d(r["coef"]), d(r["ltp"]),
            d(r["ltpscale"]), d(r["stereo_w"]), i(r["lags"]),
            i(r["flags"]), l(r["n"]), d(r["freq"]), d(r["comb"]),
            i(r["sflag"]), i(r["ok"]), i(r["red"]))
        return r

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


class NativeSilkEncoder:
    """Native SILK frame encoder (mono or stereo), byte-identical to
    the Python SilkEncoder / SilkStereoEncoder (differential-pinned in
    tests/test_silk_native.py).  One 20 ms frame per call at the
    internal rate; the 48 kHz packetizer (decimation + VBR rate loop +
    TOC) stays in codecs/opus_silk_enc.OpusSilkEncoder."""

    def __init__(self, bandwidth: int, channels: int = 1) -> None:
        self._lib = _lib()
        lib = self._lib
        if not hasattr(lib, "_skt_silk_enc_ready"):
            lib.skt_silk_enc_new.restype = ctypes.c_void_p
            lib.skt_silk_enc_new.argtypes = [ctypes.c_int]
            lib.skt_silk_enc_free.argtypes = [ctypes.c_void_p]
            lib.skt_silk_enc_reset.argtypes = [ctypes.c_void_p]
            lib.skt_silk_enc_frame.restype = ctypes.c_long
            lib.skt_silk_enc_frame.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
                ctypes.c_double, ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long]
            lib.skt_silk_enc_stereo_new.restype = ctypes.c_void_p
            lib.skt_silk_enc_stereo_new.argtypes = [ctypes.c_int]
            lib.skt_silk_enc_stereo_free.argtypes = [ctypes.c_void_p]
            lib.skt_silk_enc_stereo_reset.argtypes = [ctypes.c_void_p]
            lib.skt_silk_enc_stereo_frame.restype = ctypes.c_long
            lib.skt_silk_enc_stereo_frame.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double), ctypes.c_double,
                ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte),
                ctypes.c_long]
            lib._skt_silk_enc_ready = True
        self.channels = channels
        self.bandwidth = bandwidth
        self.flength = 20 * (bandwidth + 2) * 4
        if channels == 1:
            self._h = lib.skt_silk_enc_new(bandwidth)
            self._stereo = False
        else:
            self._h = lib.skt_silk_enc_stereo_new(bandwidth)
            self._stereo = True
        if not self._h:
            raise SilkNativeError("silk encoder create failed")

    def __del__(self):
        if getattr(self, "_h", None):
            if self._stereo:
                self._lib.skt_silk_enc_stereo_free(self._h)
            else:
                self._lib.skt_silk_enc_free(self._h)
            self._h = None

    def reset(self) -> None:
        if self._stereo:
            self._lib.skt_silk_enc_stereo_reset(self._h)
        else:
            self._lib.skt_silk_enc_reset(self._h)

    def encode_frame(self, frame: np.ndarray, target_pulse: float,
                     seed0: int = 0) -> bytes:
        """frame: [flength, channels] float at the internal rate ->
        the finalized SILK payload (no TOC byte)."""
        out = np.zeros(1275, dtype=np.uint8)
        op = out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
        if self._stereo:
            xl = np.ascontiguousarray(frame[:, 0], dtype=np.float64)
            xr = np.ascontiguousarray(frame[:, 1], dtype=np.float64)
            n = self._lib.skt_silk_enc_stereo_frame(
                self._h,
                xl.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                xr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                target_pulse, seed0, op, 1275)
        else:
            x = np.ascontiguousarray(frame[:, 0], dtype=np.float64)
            n = self._lib.skt_silk_enc_frame(
                self._h,
                x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                target_pulse, seed0, op, 1275)
        if n < 0:
            raise SilkNativeError("silk encode failed")
        return bytes(out[:n])
