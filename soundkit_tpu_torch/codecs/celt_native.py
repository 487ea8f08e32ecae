"""Opus CELT host parse of the port (counterpart of
``soundkit_tpu/codecs/celt_native.py``): range decode, allocation, PVQ,
anti-collapse and denormalization in the port's build of
``native_src/src/celt_parse.cpp`` (``native.opus_library``), emitting the
spectra and packed postfilter parameters that the batched synthesis
(``ops/celt_batch.py``) consumes.

The spec tables are pushed from the port's copy of the RFC 6716 set
(``codecs/opus_tables.py``) when the library loads, as the JAX package
does. Bound here: :class:`NativeCeltParser` (one stream's parse state,
with the single-frame ``parse`` of the host decoder's CELT fast path,
``codecs/opus._NativeCeltStream``) and :class:`NativeCeltBatch` with
``reset_lane``, the serving walk ``parse_rounds`` and, verbatim copies of
the JAX package's methods, the one-round batch parses ``parse_many`` (float64
spectra) and ``parse_many_q`` (int16 spectra with a scale a band) and the
hybrid continuation ``parse_many_cont`` (each lane's coder seeded from the
SILK walk's state), and the encoder :class:`NativeCeltEncoder`
(``skt_celt_enc_frame``, a verbatim copy of the JAX package's class) that
``codecs/opus_celt_enc.OpusCeltEncoder`` range-codes its frames with.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from soundkit_tpu_torch.codecs.opus_tables import tables, PVQ_U_ROW_OFFSETS
from soundkit_tpu_torch.native import opus_library

FRAME = 960


class CeltNativeError(RuntimeError):
    pass


@functools.lru_cache(maxsize=1)
def _lib():
    lib = opus_library()
    t = tables()

    def push_i(name, arr):
        a = np.ascontiguousarray(np.asarray(arr).reshape(-1), dtype=np.int64)
        lib.skt_celt_table_i(name.encode(), a, a.size)

    def push_f(name, arr):
        a = np.ascontiguousarray(np.asarray(arr).reshape(-1), dtype=np.float64)
        lib.skt_celt_table_f(name.encode(), a, a.size)

    push_i("pvq_u", t["celt_pvq_u"])
    push_i("pvq_row_off", np.asarray(PVQ_U_ROW_OFFSETS))
    push_i("freq_bands", t["celt_freq_bands"])
    push_i("log_freq_range", t["celt_log_freq_range"])
    push_f("mean_energy", t["celt_mean_energy"])
    push_f("alpha_coef", t["celt_alpha_coef"])
    push_f("beta_coef", t["celt_beta_coef"])
    push_i("coarse_energy_dist", t["celt_coarse_energy_dist"])
    push_i("static_alloc", t["celt_static_alloc"])
    push_i("static_caps", t["celt_static_caps"])
    push_i("cache_index", t["celt_cache_index"])
    push_i("cache_bits", t["celt_cache_bits"])
    push_i("log2_frac", t["celt_log2_frac"])
    push_i("tf_select", t["celt_tf_select"])
    push_i("qn_exp2", t["celt_qn_exp2"])
    push_i("bit_interleave", t["celt_bit_interleave"])
    push_i("bit_deinterleave", t["celt_bit_deinterleave"])
    push_i("model_spread", t["celt_model_spread"])
    push_i("model_tapset", t["celt_model_tapset"])
    push_i("model_alloc_trim", t["celt_model_alloc_trim"])
    push_i("model_energy_small", t["celt_model_energy_small"])
    push_f("postfilter_taps", t["celt_postfilter_taps"])
    push_f("window", t["celt_window"])  # encoder forward MDCT
    if lib.skt_celt_tables_done() != 0:
        raise CeltNativeError("celt table finalize failed")
    return lib


class NativeCeltParser:
    """One stream's CELT parse state (mirrors CeltDecoder parse_only)."""

    def __init__(self, channels: int):
        self._lib = _lib()
        self.channels = channels
        self._h = self._lib.skt_celt_new(channels)
        if not self._h:
            raise CeltNativeError("skt_celt_new failed")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.skt_celt_free(self._h)
            self._h = None

    def reset(self) -> None:
        self._lib.skt_celt_reset(self._h)

    def parse(self, frame: bytes, end: int, coded_channels: int = 0,
              frame_size: int = FRAME, start: int = 0):
        """Returns (freq [C, frame_size] f64, comb [16] f64, sflag)."""
        C = coded_channels or self.channels
        freq = np.zeros((C, frame_size), dtype=np.float64)
        comb = np.zeros(16, dtype=np.float64)
        sflag = ctypes.c_int(0)
        r = self._lib.skt_celt_parse(
            self._h, frame, len(frame), frame_size, start, end, C,
            freq.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            comb.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.byref(sflag))
        if r != 0:
            raise CeltNativeError(f"celt parse failed ({r})")
        return freq, comb, int(sflag.value)


class NativeCeltBatch:
    """B lockstep parse states with a single-call batch parse."""

    def __init__(self, num_streams: int, channels: int):
        self._lib = _lib()
        self.B = num_streams
        self.C = channels
        self._parsers = [NativeCeltParser(channels)
                         for _ in range(num_streams)]
        self._handles = (ctypes.c_void_p * num_streams)(
            *[p._h for p in self._parsers])

    def reset_lane(self, b: int) -> None:
        self._parsers[b].reset()

    def parse_many(self, frames, ends, coded, valid,
                   frame_size: int = FRAME):
        """frames: list of B byte strings (ignored where not valid).

        Returns (freq [B, C, frame_size] f64, comb [B, 16] f64,
        sflag [B] i32, ok [B] i32)."""
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
        ends_a = np.ascontiguousarray(ends, dtype=np.int32)
        coded_a = np.ascontiguousarray(coded, dtype=np.int32)
        valid_a = np.ascontiguousarray(valid, dtype=np.uint8)
        freq = np.zeros((B, C, frame_size), dtype=np.float64)
        comb = np.zeros((B, 16), dtype=np.float64)
        sflag = np.zeros(B, dtype=np.int32)
        ok = np.zeros(B, dtype=np.int32)
        self._lib.skt_celt_parse_many(
            self._handles, B, buf,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            ends_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            coded_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            valid_a.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            frame_size, C,
            freq.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            comb.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            sflag.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        return freq, comb, sflag, ok

    def parse_many_q(self, frames, ends, coded, valid,
                     frame_size: int = FRAME):
        """Quantized-wire batch parse (skt_celt_parse_many_q): the
        range decode is identical to :meth:`parse_many`, but spectra
        return as int16 with one f32 scale per (lane, band) — the
        half-width serving wire for the fleet's i16 output mode
        (~92 dB vs the exact f32 path on the fixture corpus).

        Returns (qfreq [B, C, frame_size] i16, scale [B, 21] f32,
        comb [B, 16] f64, sflag [B] i32, ok [B] i32)."""
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
        ends_a = np.ascontiguousarray(ends, dtype=np.int32)
        coded_a = np.ascontiguousarray(coded, dtype=np.int32)
        valid_a = np.ascontiguousarray(valid, dtype=np.uint8)
        qfreq = np.zeros((B, C, frame_size), dtype=np.int16)
        scale = np.zeros((B, 21), dtype=np.float32)
        comb = np.zeros((B, 16), dtype=np.float64)
        sflag = np.zeros(B, dtype=np.int32)
        ok = np.zeros(B, dtype=np.int32)
        self._lib.skt_celt_parse_many_q(
            self._handles, B, buf,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            ends_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            coded_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            valid_a.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            frame_size, C,
            qfreq.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            scale.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            comb.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            sflag.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        return qfreq, scale, comb, sflag, ok

    def parse_rounds(self, buf: bytes, base, lens, ends, coded,
                     n_rounds: int, W: int, quantized: bool,
                     frame_size: int = FRAME):
        """Multi-round serving walk (skt_celt_parse_rounds[_q]): ONE
        native call parses ``n_rounds`` lockstep rounds for all B
        lanes, writing the device wire directly in dispatch layout
        (``[R_alloc, B, C, W]`` with rounds past ``n_rounds`` left
        zero).

        ``buf``: every lane's frames concatenated in round order,
        lane b starting at ``base[b]``; ``lens/ends/coded``:
        [B, R_alloc] int32 with lens==0 marking empty slots.

        Returns (freq, scales, comb, sflag, ok): freq is
        [R_alloc, B, C, W] int16 with scales [R_alloc, B, 21] f32
        when ``quantized``, else float32 with scales None;
        comb [R_alloc, B, 16] f32, sflag/ok [R_alloc, B] i32
        (ok: 0 parsed, -100 skipped slot, else parse error)."""
        B, C = self.B, self.C
        base = np.ascontiguousarray(base, dtype=np.int64)
        lens = np.ascontiguousarray(lens, dtype=np.int32)
        ends = np.ascontiguousarray(ends, dtype=np.int32)
        coded = np.ascontiguousarray(coded, dtype=np.int32)
        R_alloc = lens.shape[1]
        comb = np.zeros((R_alloc, B, 16), dtype=np.float32)
        sflag = np.zeros((R_alloc, B), dtype=np.int32)
        ok = np.full((R_alloc, B), -100, dtype=np.int32)
        common = (self._handles, B, n_rounds, buf, base, lens, ends, coded, frame_size, C, W)
        if quantized:
            qfreq = np.zeros((R_alloc, B, C, W), dtype=np.int16)
            scales = np.zeros((R_alloc, B, 21), dtype=np.float32)
            self._lib.skt_celt_parse_rounds_q(*common, qfreq, scales, comb, sflag, ok)
            return qfreq, scales, comb, sflag, ok
        freq = np.zeros((R_alloc, B, C, W), dtype=np.float32)
        self._lib.skt_celt_parse_rounds(*common, freq, comb, sflag, ok)
        return freq, None, comb, sflag, ok

    def parse_many_cont(self, frames, starts, ends, coded, valid,
                        rc_init, frame_size: int = FRAME):
        """Hybrid continuation: each lane's range coder is seeded from
        the SILK stage's exported state (silk parse_many info[:, 4:13])
        over the same frame bytes, parsing from per-lane start band.

        Returns (freq [B, C, frame_size] f64, comb [B, 16] f64,
        sflag [B] i32, ok [B] i32, red [B] i32) — lanes whose packet
        carries hybrid mode-transition redundancy come back red=1 /
        ok=-90 unparsed (the caller reroutes them)."""
        lib = self._lib
        if not hasattr(lib, "_skt_celt_cont_ready"):
            lib.skt_celt_parse_many_cont.restype = ctypes.c_int
            lib._skt_celt_cont_ready = True
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
        starts_a = np.ascontiguousarray(starts, dtype=np.int32)
        ends_a = np.ascontiguousarray(ends, dtype=np.int32)
        coded_a = np.ascontiguousarray(coded, dtype=np.int32)
        valid_a = np.ascontiguousarray(valid, dtype=np.uint8)
        rc_a = np.ascontiguousarray(rc_init, dtype=np.int64)
        assert rc_a.shape == (B, 9)
        freq = np.zeros((B, C, frame_size), dtype=np.float64)
        comb = np.zeros((B, 16), dtype=np.float64)
        sflag = np.zeros(B, dtype=np.int32)
        ok = np.zeros(B, dtype=np.int32)
        red = np.zeros(B, dtype=np.int32)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.skt_celt_parse_many_cont(
            self._handles, B, buf,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            starts_a.ctypes.data_as(ip),
            ends_a.ctypes.data_as(ip),
            coded_a.ctypes.data_as(ip),
            valid_a.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            rc_a.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            frame_size, C,
            freq.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            comb.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            sflag.ctypes.data_as(ip), ok.ctypes.data_as(ip),
            red.ctypes.data_as(ip))
        return freq, comb, sflag, ok, red


class NativeCeltEncoder:
    """One stream's CELT encode state (mirrors CeltEncoder
    encode_frame via native/src/celt_parse.cpp skt_celt_enc_frame)."""

    def __init__(self, channels: int):
        self._lib = _lib()
        self.channels = channels
        self._h = self._lib.skt_celt_new(channels)
        if not self._h:
            raise CeltNativeError("skt_celt_new failed")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.skt_celt_free(self._h)
            self._h = None

    def reset(self) -> None:
        self._lib.skt_celt_reset(self._h)

    def encode_frame(self, freq: np.ndarray, frame_size: int,
                     nbytes: int, transient: bool = False) -> bytes:
        """``freq``: [C, frame_size] forward-MDCT spectra (the caller
        runs the dense MDCT matmul through BLAS, batched over frames;
        bin-interleaved short blocks when ``transient``) -> the nbytes
        CBR range-coded payload (no TOC)."""
        freq = np.ascontiguousarray(freq, dtype=np.float64)
        out = np.zeros(nbytes, dtype=np.uint8)
        r = self._lib.skt_celt_enc_frame(
            self._h,
            freq.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            frame_size, nbytes, 1 if transient else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        if r != nbytes:
            raise CeltNativeError(f"celt encode failed ({r})")
        return out.tobytes()
