"""Typed views over the RFC 6716 data tables.

The raw bytes are sliced out of the system libavcodec archive's
opustab.o by native/tools/extract_tables.py (extract_opus) into
native/generated/opus_tables.npz; this module reinterprets each blob
with its declared dtype/shape.  These are the published RFC 6716
tables (identical numbers in libopus), not anyone's code.

Parity reference: soundkit-opus/src/lib.rs wraps libopus; this
framework owns the decode (opus_rc.py / opus_celt.py / opus_silk.py).
"""
from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

_NPZ = Path(__file__).resolve().parent.parent / "data" / "opus_tables.npz"

# dtype/shape declarations per table (flat if shape omitted)
_SPEC = {
    # --- CELT ---
    "ff_celt_band_end": ("u1", None),
    "ff_celt_freq_bands": ("u1", None),          # [22]
    "ff_celt_freq_range": ("u1", None),          # [21]
    "ff_celt_log_freq_range": ("u1", None),      # [21]
    "ff_celt_model_energy_small": ("<u2", None),
    "ff_celt_model_tapset": ("<u2", None),
    "ff_celt_model_spread": ("<u2", None),
    "ff_celt_model_alloc_trim": ("<u2", None),
    "ff_celt_alpha_coef": ("<f4", None),         # [4]
    "ff_celt_beta_coef": ("<f4", None),          # [4]
    "ff_celt_coarse_energy_dist": ("u1", (4, 2, 42)),
    "ff_celt_static_alloc": ("u1", (11, 21)),
    "ff_celt_static_caps": ("u1", (4, 2, 21)),
    "ff_celt_cache_index": ("<i2", None),        # [105]
    "ff_celt_cache_bits": ("u1", None),          # [392]
    "ff_celt_log2_frac": ("u1", None),           # [24]
    "ff_celt_bit_interleave": ("u1", None),
    "ff_celt_bit_deinterleave": ("u1", None),
    "ff_celt_hadamard_order": ("u1", None),
    "ff_celt_qn_exp2": ("<u2", None),            # [8]
    "ff_celt_tf_select": ("i1", (4, 2, 2, 2)),
    "ff_celt_mean_energy": ("<f4", None),
    "ff_celt_window_padded": ("<f4", None),      # [136]; window = [8:128]
    "ff_celt_window2": ("<f4", None),            # [120]
    "ff_celt_postfilter_taps": ("<f4", (3, 3)),
    "celt_pvq_u": ("<u4", None),                 # [1272]
    # --- SILK ---
    "ff_silk_model_stereo_s1": ("<u2", None),
    "ff_silk_model_stereo_s2": ("<u2", None),
    "ff_silk_model_stereo_s3": ("<u2", None),
    "ff_silk_model_mid_only": ("<u2", None),
    "ff_silk_model_frame_type_inactive": ("<u2", None),
    "ff_silk_model_frame_type_active": ("<u2", None),
    "ff_silk_model_gain_highbits": ("<u2", (3, 9)),
    "ff_silk_model_gain_lowbits": ("<u2", None),
    "ff_silk_model_gain_delta": ("<u2", None),
    "ff_silk_model_lsf_s1": ("<u2", (2, 2, 33)),
    "ff_silk_model_lsf_s2": ("<u2", (32, 10)),
    "ff_silk_model_lsf_s2_ext": ("<u2", None),
    "ff_silk_model_lsf_interpolation_offset": ("<u2", None),
    "ff_silk_model_pitch_highbits": ("<u2", None),
    "ff_silk_model_pitch_lowbits_nb": ("<u2", None),
    "ff_silk_model_pitch_lowbits_mb": ("<u2", None),
    "ff_silk_model_pitch_lowbits_wb": ("<u2", None),
    "ff_silk_model_pitch_delta": ("<u2", None),
    "ff_silk_model_pitch_contour_nb10ms": ("<u2", None),
    "ff_silk_model_pitch_contour_nb20ms": ("<u2", None),
    "ff_silk_model_pitch_contour_mbwb10ms": ("<u2", None),
    "ff_silk_model_pitch_contour_mbwb20ms": ("<u2", None),
    "ff_silk_model_ltp_filter": ("<u2", None),
    "ff_silk_model_ltp_filter0_sel": ("<u2", None),
    "ff_silk_model_ltp_filter1_sel": ("<u2", None),
    "ff_silk_model_ltp_filter2_sel": ("<u2", None),
    "ff_silk_model_ltp_scale_index": ("<u2", None),
    "ff_silk_model_lcg_seed": ("<u2", None),
    "ff_silk_model_exc_rate": ("<u2", (2, 10)),
    "ff_silk_model_pulse_count": ("<u2", (11, 19)),
    "ff_silk_model_pulse_location": ("<u2", (4, None)),
    "ff_silk_model_excitation_lsb": ("<u2", None),
    "ff_silk_model_excitation_sign": ("<u2", (3, 2, 7, 3)),
    "ff_silk_model_lbrr_flags_40": ("<u2", None),
    "ff_silk_model_lbrr_flags_60": ("<u2", None),
    "ff_silk_lsf_s2_model_sel_nbmb": ("u1", (32, 10)),
    "ff_silk_lsf_s2_model_sel_wb": ("u1", (32, 16)),
    "ff_silk_lsf_pred_weights_nbmb": ("u1", (2, 9)),
    "ff_silk_lsf_pred_weights_wb": ("u1", (2, 15)),
    "ff_silk_lsf_weight_sel_nbmb": ("u1", (32, 9)),
    "ff_silk_lsf_weight_sel_wb": ("u1", (32, 15)),
    "ff_silk_lsf_codebook_nbmb": ("u1", (32, 10)),
    "ff_silk_lsf_codebook_wb": ("u1", (32, 16)),
    "ff_silk_lsf_min_spacing_nbmb": ("<i2", None),
    "ff_silk_lsf_min_spacing_wb": ("<i2", None),
    "ff_silk_lsf_ordering_nbmb": ("u1", None),
    "ff_silk_lsf_ordering_wb": ("u1", None),
    "ff_silk_cosine": ("<i2", None),             # [129]
    "ff_silk_pitch_scale": ("<u2", None),
    "ff_silk_pitch_min_lag": ("<u2", None),
    "ff_silk_pitch_max_lag": ("<u2", None),
    "ff_silk_pitch_offset_nb10ms": ("i1", None),
    "ff_silk_pitch_offset_nb20ms": ("i1", (11, 4)),
    "ff_silk_pitch_offset_mbwb10ms": ("i1", (12, 2)),
    "ff_silk_pitch_offset_mbwb20ms": ("i1", (34, 4)),
    "ff_silk_ltp_filter0_taps": ("i1", (8, 5)),
    "ff_silk_ltp_filter1_taps": ("i1", (16, 5)),
    "ff_silk_ltp_filter2_taps": ("i1", (32, 5)),
    "ff_silk_ltp_scale_factor": ("<u2", None),
    "ff_silk_shell_blocks": ("u1", (3, 2)),
    "ff_silk_quant_offset": ("u1", (2, 2)),
    "ff_silk_stereo_weights": ("<i2", None),
    "ff_silk_stereo_interp_len": ("<i4", None),
    "ff_opus_default_coupled_streams": ("u1", None),
}

# offsets of CELT_PVQ_U_ROW[1..15] into celt_pvq_u (standard CELT row
# starts; validated against the U recurrence in tests/test_opus.py)
PVQ_U_ROW_OFFSETS = (
    0, 176, 351, 525, 698, 870, 1041, 1131, 1178,
    1207, 1226, 1240, 1248, 1254, 1257,
)


@functools.lru_cache(maxsize=1)
def tables() -> dict:
    z = np.load(_NPZ)
    out = {}
    for name, (dt, shape) in _SPEC.items():
        raw = z[name]
        a = np.frombuffer(raw.tobytes(), dtype=dt)
        if shape is not None:
            if None in shape:
                fixed = [s for s in shape if s is not None]
                rest = len(a) // int(np.prod(fixed))
                shape = tuple(rest if s is None else s for s in shape)
            a = a.reshape(shape)
        out[name[3:] if name.startswith("ff_") else name] = a
    out["celt_window"] = out["celt_window_padded"][8:128]
    return out
