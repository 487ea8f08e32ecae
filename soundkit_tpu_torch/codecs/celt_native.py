"""Opus CELT host parse of the port (counterpart of
``soundkit_tpu/codecs/celt_native.py``): range decode, allocation, PVQ,
anti-collapse and denormalization in the port's build of
``native_src/src/celt_parse.cpp`` (``native.opus_library``), emitting the
spectra and packed postfilter parameters that the batched synthesis
(``ops/celt_batch.py``) consumes.

The spec tables are pushed from the port's copy of the RFC 6716 set
(``codecs/opus_tables.py``) when the library loads, as the JAX package
does. Bound here: :class:`NativeCeltParser` (one stream's parse state)
and :class:`NativeCeltBatch` with ``reset_lane`` and the serving walk
``parse_rounds``. The single-frame parses (``parse``, ``parse_many``,
``parse_many_q``), the hybrid continuation ``parse_many_cont`` and the
encoder ``NativeCeltEncoder`` of the JAX package are not bound yet.
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
