// G.729 (8 kbit/s) decoder, integer throughout.
//
// Follows libavcodec's fixed-point G.729 decoder (g729dec.c,
// g729postfilter.c and the ACELP / CELP / LSP helpers they call) so that
// its int16 output is the same bit for bit: 10-byte frames of two 40-sample
// subframes, LSP decode with the switched MA predictor, pitch delay with
// the parity check, the 4-pulse fixed codebook with pitch sharpening, the
// two-stage gain codebook with the MA energy predictor, LP synthesis with
// its overflow rescale, the long-term / short-term / tilt postfilter and
// its adaptive gain control, and the output high-pass. An all-zero frame is
// an erasure (libavcodec's rule): the LSFs are rebuilt from the previous
// frame, the pitch repeats and the fixed codebook is drawn from the
// decoder's random generator.
//
// Every table comes from generated/g729_tables.h, which
// tools/extract_celp_tables.py writes from data/g729_tables.npz.
//
// C ABI: skt_g729_new / skt_g729_decode (whole frames -> int16) /
// skt_g729_reset / skt_g729_free.

#include <cmath>
#include <cstdint>
#include <cstring>

#include "../generated/g729_tables.h"

namespace {

using namespace g729_tab;

constexpr int SUBFRAME_SIZE = 40;
constexpr int FRAME_BYTES = 10;
constexpr int LP_ORDER = 10;
constexpr int MA_NP = 4;
constexpr int PITCH_DELAY_MIN = 20;
constexpr int PITCH_DELAY_MAX = 143;
constexpr int INTERPOL_LEN = 11;
constexpr int LSFQ_MIN = 40;
constexpr int LSFQ_MAX = 25681;
constexpr int LSFQ_DIFF_MIN = 321;
constexpr int SHARP_MIN = 3277;
constexpr int SHARP_MAX = 13017;
constexpr int MR_ENERGY = 1018156;
// postfilter
constexpr int SHORT_INT_FILT_LEN = 2;
constexpr int LONG_INT_FILT_LEN = 8;
constexpr int ANALYZED_FRAC_DELAYS = 7;
constexpr int RES_PREV_DATA_SIZE = PITCH_DELAY_MAX + LONG_INT_FILT_LEN + 1;
constexpr int MIN_LT_FILT_FACTOR_A = 21845;  // 1 / (1 + 0.5) in Q15
constexpr int G729_TILT_FACTOR_PLUS = 6554;  // 0.2 in Q15
constexpr int G729_TILT_FACTOR_MINUS = 29491;  // 0.9 in Q15
constexpr int G729_AGC_FACTOR = 32358;  // 0.9875 in Q15
constexpr int G729_AGC_FAC1 = 32768 - G729_AGC_FACTOR;

inline int clip_int16(int v) { return v < -32768 ? -32768 : (v > 32767 ? 32767 : v); }
inline int clip(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
inline int iabs(int v) { return v < 0 ? -v : v; }
inline int imax(int a, int b) { return a > b ? a : b; }
inline int imin(int a, int b) { return a < b ? a : b; }
// floor(log2(v)) of a positive value, 0 for 0 (av_log2)
inline int ilog2(uint32_t v) { return v ? 31 - __builtin_clz(v) : 0; }
inline int bidir_sal(int value, int offset) {
    return offset < 0 ? value >> -offset : (int)((unsigned)value << offset);
}
inline int parity(unsigned v) { return __builtin_popcount(v) & 1; }

// the saturating 32-bit dot product libavcodec's decoder installs
int32_t dot16(const int16_t* a, const int16_t* b, int n) {
    int64_t r = 0;
    while (n--) r += *a++ * *b++;
    if (r > INT32_MAX) return INT32_MAX;
    if (r < INT32_MIN) return INT32_MIN;
    return (int32_t)r;
}

struct BitReader {
    const uint8_t* p;
    int pos = 0;
    explicit BitReader(const uint8_t* d) : p(d) {}
    unsigned get(int n) {
        unsigned v = 0;
        for (int i = 0; i < n; ++i, ++pos) v = (v << 1) | ((p[pos >> 3] >> (7 - (pos & 7))) & 1);
        return v;
    }
};

// ---- celp_math / lsp ----

int16_t ff_cos(uint16_t arg) {
    uint8_t offset = arg;
    uint8_t ind = arg >> 8;
    return tab_cos[ind] + ((offset * (tab_cos[ind + 1] - tab_cos[ind])) >> 8);
}

int log2_q15(uint32_t value) {
    int power_int = ilog2(value);
    value <<= (31 - power_int);
    int frac_x0 = (value & 0x7c000000) >> 26;
    int frac_dx = (value & 0x03fff800) >> 11;
    int v = tab_log2[frac_x0];
    v += (frac_dx * (tab_log2[frac_x0 + 1] - tab_log2[frac_x0])) >> 15;
    return (power_int << 15) + v;
}

void lsf2lsp(int16_t* lsp, const int16_t* lsf) {
    for (int i = 0; i < LP_ORDER; ++i) lsp[i] = ff_cos((lsf[i] * 20861) >> 15);
}

void reorder_lsf(int16_t* lsfq, int min_distance, int lsfq_min, int lsfq_max) {
    for (int i = 0; i < LP_ORDER - 1; ++i)
        for (int j = i; j >= 0 && lsfq[j] > lsfq[j + 1]; --j) {
            int16_t t = lsfq[j];
            lsfq[j] = lsfq[j + 1];
            lsfq[j + 1] = t;
        }
    for (int i = 0; i < LP_ORDER; ++i) {
        lsfq[i] = imax(lsfq[i], lsfq_min);
        lsfq_min = lsfq[i] + min_distance;
    }
    lsfq[LP_ORDER - 1] = imin(lsfq[LP_ORDER - 1], lsfq_max);
}

void lsp2poly(int* f, const int16_t* lsp, int half) {
    f[0] = 0x400000;
    f[1] = -lsp[0] * 256;
    for (int i = 2; i <= half; ++i) {
        f[i] = f[i - 2];
        for (int j = i; j > 1; --j)
            f[j] -= (int)(((int64_t)f[j - 1] * lsp[2 * i - 2]) >> 14) - f[j - 2];
        f[1] -= lsp[2 * i - 2] * 256;
    }
}

void lsp2lpc(int16_t* lp, const int16_t* lsp) {
    constexpr int half = LP_ORDER / 2;
    int f1[half + 1], f2[half + 1];
    lsp2poly(f1, lsp, half);
    lsp2poly(f2, lsp + 1, half);
    lp[0] = 4096;
    for (int i = 1; i < half + 1; ++i) {
        int ff1 = f1[i] + f1[i - 1];
        int ff2 = f2[i] - f2[i - 1];
        ff1 += 1 << 10;
        lp[i] = (ff1 + ff2) >> 11;
        lp[(half << 1) + 1 - i] = (ff1 - ff2) >> 11;
    }
}

void lp_decode(int16_t* lp_1st, int16_t* lp_2nd, const int16_t* lsp_2nd, const int16_t* lsp_prev) {
    int16_t lsp_1st[LP_ORDER];
    for (int i = 0; i < LP_ORDER; ++i) lsp_1st[i] = (lsp_2nd[i] + lsp_prev[i]) >> 1;
    lsp2lpc(lp_1st, lsp_1st);
    lsp2lpc(lp_2nd, lsp_2nd);
}

// ---- acelp helpers ----

int decode_8bit_to_1st_delay3(int ac_index) {
    ac_index += 58;
    if (ac_index > 254) ac_index = 3 * ac_index - 510;
    return ac_index;
}

int decode_5_6_bit_to_2nd_delay3(int ac_index, int pitch_delay_min) {
    return 3 * pitch_delay_min + ac_index - 2;
}

void fc_pulse_per_track(int16_t* fc_v, const uint8_t* tab1, const uint8_t* tab2,
                        int pulse_indexes, int pulse_signs, int pulse_count, int bits) {
    int mask = (1 << bits) - 1;
    for (int i = 0; i < pulse_count; ++i) {
        fc_v[i + tab1[pulse_indexes & mask]] += (pulse_signs & 1) ? 8191 : -8192;
        pulse_indexes >>= bits;
        pulse_signs >>= 1;
    }
    fc_v[tab2[pulse_indexes]] += (pulse_signs & 1) ? 8191 : -8192;
}

void weighted_vector_sum(int16_t* out, const int16_t* in_a, const int16_t* in_b,
                         int16_t weight_a, int16_t weight_b, int16_t rounder, int shift, int length) {
    for (int i = 0; i < length; ++i)
        out[i] = clip_int16((in_a[i] * weight_a + in_b[i] * weight_b + rounder) >> shift);
}

void interpolate(int16_t* out, const int16_t* in, const int16_t* filter_coeffs, int precision,
                 int frac_pos, int filter_length, int length) {
    for (int n = 0; n < length; ++n) {
        int idx = 0;
        int v = 0x4000;
        for (int i = 0; i < filter_length;) {
            v += in[n + i] * filter_coeffs[idx + frac_pos];
            idx += precision;
            ++i;
            v += in[n - i] * filter_coeffs[idx - frac_pos];
        }
        out[n] = v >> 15;
    }
}

int16_t decode_gain_code(int gain_corr_factor, const int16_t* fc_v, int mr_energy,
                         const int16_t* quant_energy, const int16_t* pred_coeff,
                         int subframe_size, int ma_pred_order) {
    mr_energy <<= 10;
    for (int i = 0; i < ma_pred_order; ++i) mr_energy += quant_energy[i] * pred_coeff[i];
    mr_energy = gain_corr_factor * exp(M_LN10 / (20 << 23) * mr_energy) /
                sqrt(dot16(fc_v, fc_v, subframe_size));
    return mr_energy >> 12;
}

void update_past_gain(int16_t* quant_energy, int gain_corr_factor, int log2_ma_pred_order,
                      int erasure) {
    int avg_gain = quant_energy[(1 << log2_ma_pred_order) - 1];
    for (int i = (1 << log2_ma_pred_order) - 1; i > 0; --i) {
        avg_gain += quant_energy[i - 1];
        quant_energy[i] = quant_energy[i - 1];
    }
    if (erasure)
        quant_energy[0] = imax(avg_gain >> log2_ma_pred_order, -10240) - 4096;
    else
        quant_energy[0] = (6165 * ((log2_q15(gain_corr_factor) >> 2) - (13 << 13))) >> 13;
}

int lp_synthesis_filter(int16_t* out, const int16_t* filter_coeffs, const int16_t* in,
                        int buffer_length, int filter_length, int stop_on_overflow, int shift,
                        int rounder) {
    for (int n = 0; n < buffer_length; ++n) {
        int sum = rounder, sum1;
        for (int i = 1; i <= filter_length; ++i)
            sum = (int)((unsigned)sum - (unsigned)(filter_coeffs[i - 1] * out[n - i]));
        sum1 = ((sum >> 12) + in[n]) >> shift;
        sum = clip_int16(sum1);
        if (stop_on_overflow && sum != sum1) return 1;
        out[n] = sum;
    }
    return 0;
}

void high_pass_filter(int16_t* out, int hpf_f[2], const int16_t* in, int length) {
    for (int i = 0; i < length; ++i) {
        int tmp = (int)((hpf_f[0] * 15836LL) >> 13);
        tmp += (int)((hpf_f[1] * -7667LL) >> 13);
        tmp += 7699 * (in[i] - 2 * in[i - 1] + in[i - 2]);
        out[i] = clip_int16((tmp + 0x800) >> 12);
        hpf_f[1] = hpf_f[0];
        hpf_f[0] = tmp;
    }
}

// ---- postfilter (g729postfilter.c) ----

void residual_filter(int16_t* out, const int16_t* filter_coeffs, const int16_t* in,
                     int subframe_size) {
    for (int n = subframe_size - 1; n >= 0; --n) {
        int sum = 0x800;
        for (int i = 0; i < 10; ++i) sum += filter_coeffs[i] * in[n - i - 1];
        out[n] = in[n] + (sum >> 12);
    }
}

int long_term_filter(int pitch_delay_int, const int16_t* residual, int16_t* residual_filt,
                     int subframe_size) {
    int i, k, tmp, tmp2;
    int sum;
    int L_temp0, L_temp1;
    int64_t L64_temp0, L64_temp1;
    int16_t shift;
    int corr_int_num, corr_int_den;
    int ener;
    int16_t sh_ener;
    int16_t gain_num, gain_den;
    int16_t sh_gain_num = 0, sh_gain_den = 0;
    int gain_num_square;
    int16_t gain_long_num, gain_long_den;
    int16_t sh_gain_long_num, sh_gain_long_den;
    int16_t best_delay_int = 0, best_delay_frac = 0;
    int16_t delayed_signal_offset = 0;
    int lt_filt_factor_a, lt_filt_factor_b;
    int16_t* selected_signal;
    const int16_t* selected_signal_const;
    int16_t sig_scaled[SUBFRAME_SIZE + RES_PREV_DATA_SIZE];
    int16_t delayed_signal[ANALYZED_FRAC_DELAYS][SUBFRAME_SIZE + 1];
    int corr_den[ANALYZED_FRAC_DELAYS][2];

    tmp = 0;
    for (i = 0; i < subframe_size + RES_PREV_DATA_SIZE; ++i) tmp |= iabs(residual[i]);
    if (!tmp)
        shift = 3;
    else
        shift = ilog2(tmp) - 11;
    if (shift > 0)
        for (i = 0; i < subframe_size + RES_PREV_DATA_SIZE; ++i) sig_scaled[i] = residual[i] >> shift;
    else
        for (i = 0; i < subframe_size + RES_PREV_DATA_SIZE; ++i)
            sig_scaled[i] = (int16_t)((unsigned)residual[i] << -shift);

    gain_num = 0;
    ener = dot16(sig_scaled + RES_PREV_DATA_SIZE, sig_scaled + RES_PREV_DATA_SIZE, subframe_size);
    if (ener) {
        sh_ener = ilog2(ener) - 14;
        sh_ener = imax(sh_ener, 0);
        ener >>= sh_ener;
        corr_int_num = 0;
        best_delay_int = pitch_delay_int - 1;
        for (i = pitch_delay_int - 1; i <= pitch_delay_int + 1; ++i) {
            sum = dot16(sig_scaled + RES_PREV_DATA_SIZE, sig_scaled + RES_PREV_DATA_SIZE - i,
                        subframe_size);
            if (sum > corr_int_num) {
                corr_int_num = sum;
                best_delay_int = i;
            }
        }
        if (corr_int_num) {
            corr_int_den = dot16(sig_scaled + RES_PREV_DATA_SIZE - best_delay_int,
                                 sig_scaled + RES_PREV_DATA_SIZE - best_delay_int, subframe_size);
            for (k = 0; k < ANALYZED_FRAC_DELAYS; ++k)
                interpolate(&delayed_signal[k][0], &sig_scaled[RES_PREV_DATA_SIZE - best_delay_int],
                            ff_g729_interp_filt_short, ANALYZED_FRAC_DELAYS + 1, 8 - k - 1,
                            SHORT_INT_FILT_LEN, subframe_size + 1);
            tmp = corr_int_den;
            for (k = 0; k < ANALYZED_FRAC_DELAYS; ++k) {
                sum = dot16(&delayed_signal[k][1], &delayed_signal[k][1], subframe_size - 1);
                corr_den[k][0] = sum + delayed_signal[k][0] * delayed_signal[k][0];
                corr_den[k][1] = sum + delayed_signal[k][subframe_size] * delayed_signal[k][subframe_size];
                tmp = imax(tmp, imax(corr_den[k][0], corr_den[k][1]));
            }
            sh_gain_den = ilog2(tmp) - 14;
            if (sh_gain_den >= 0) {
                sh_gain_num = imax(sh_gain_den, sh_ener);
                delayed_signal_offset = 1;
                best_delay_frac = 0;
                gain_den = corr_int_den >> sh_gain_den;
                gain_num = corr_int_num >> sh_gain_num;
                gain_num_square = gain_num * gain_num;
                for (k = 0; k < ANALYZED_FRAC_DELAYS; ++k) {
                    for (i = 0; i < 2; ++i) {
                        int16_t gain_num_short, gain_den_short;
                        int gain_num_short_square;
                        sum = dot16(&delayed_signal[k][i], sig_scaled + RES_PREV_DATA_SIZE,
                                    subframe_size);
                        gain_num_short = imax(sum >> sh_gain_num, 0);
                        gain_num_short_square = gain_num_short * gain_num_short;
                        gain_den_short = corr_den[k][i] >> sh_gain_den;
                        tmp = (int)(((int64_t)gain_num_short_square * gain_den) >> 15);
                        tmp2 = (int)(((int64_t)gain_num_square * gain_den_short) >> 15);
                        if (tmp > tmp2) {
                            gain_num = gain_num_short;
                            gain_den = gain_den_short;
                            gain_num_square = gain_num_short_square;
                            delayed_signal_offset = i;
                            best_delay_frac = k + 1;
                        }
                    }
                }
                L64_temp0 = (int64_t)gain_num_square << ((sh_gain_num << 1) + 1);
                L64_temp1 = ((int64_t)gain_den * ener) << (sh_gain_den + sh_ener);
                if (L64_temp0 < L64_temp1) gain_num = 0;
            }
        }
    }

    if (!gain_num) {
        memcpy(residual_filt, residual + RES_PREV_DATA_SIZE, subframe_size * sizeof(int16_t));
        return 0;
    }
    if (best_delay_frac) {
        interpolate(residual_filt,
                    &sig_scaled[RES_PREV_DATA_SIZE - best_delay_int + delayed_signal_offset],
                    ff_g729_interp_filt_long, ANALYZED_FRAC_DELAYS + 1, 8 - best_delay_frac,
                    LONG_INT_FILT_LEN, subframe_size + 1);
        sum = dot16(residual_filt, sig_scaled + RES_PREV_DATA_SIZE, subframe_size);
        if (sum < 0) {
            gain_long_num = 0;
            sh_gain_long_num = 0;
        } else {
            tmp = ilog2(sum) - 14;
            tmp = imax(tmp, 0);
            sum >>= tmp;
            gain_long_num = sum;
            sh_gain_long_num = tmp;
        }
        sum = dot16(residual_filt, residual_filt, subframe_size);
        tmp = ilog2(sum) - 14;
        tmp = imax(tmp, 0);
        sum >>= tmp;
        gain_long_den = sum;
        sh_gain_long_den = tmp;

        L_temp0 = gain_num * gain_num;
        L_temp0 = (int)(((int64_t)L_temp0 * gain_long_den) >> 15);
        L_temp1 = gain_long_num * gain_long_num;
        L_temp1 = (int)(((int64_t)L_temp1 * gain_den) >> 15);
        tmp = ((sh_gain_long_num - sh_gain_num) * 2) - (sh_gain_long_den - sh_gain_den);
        if (tmp > 0)
            L_temp0 >>= tmp;
        else
            L_temp1 >>= imin(-tmp, 31);

        if (L_temp1 > L_temp0) {
            selected_signal = residual_filt;
            gain_num = gain_long_num;
            gain_den = gain_long_den;
            sh_gain_num = sh_gain_long_num;
            sh_gain_den = sh_gain_long_den;
        } else {
            selected_signal = &delayed_signal[best_delay_frac - 1][delayed_signal_offset];
        }
        if (shift > 0)
            for (i = 0; i < subframe_size; ++i) selected_signal[i] = (int16_t)(selected_signal[i] * (1 << shift));
        else
            for (i = 0; i < subframe_size; ++i) selected_signal[i] >>= -shift;
        selected_signal_const = selected_signal;
    } else {
        selected_signal_const =
            residual + RES_PREV_DATA_SIZE - (best_delay_int + 1 - delayed_signal_offset);
    }

    L64_temp0 = (((int64_t)gain_num) << sh_gain_num) >> 1;
    L64_temp1 = ((int64_t)gain_den) << sh_gain_den;
    int64_t q = (L64_temp1 << 15) / (L64_temp1 + L64_temp0);
    lt_filt_factor_a = (int)(q > MIN_LT_FILT_FACTOR_A ? q : MIN_LT_FILT_FACTOR_A);
    lt_filt_factor_b = 32767 - lt_filt_factor_a + 1;

    weighted_vector_sum(residual_filt, residual + RES_PREV_DATA_SIZE, selected_signal_const,
                        (int16_t)lt_filt_factor_a, (int16_t)lt_filt_factor_b, 1 << 14, 15,
                        subframe_size);
    return 1;
}

int16_t get_tilt_comp(int16_t* lp_gn, const int16_t* lp_gd, int16_t* speech, int subframe_size) {
    int rh1, rh0;
    int temp;
    int gain_term;

    lp_gn[10] = 4096;
    lp_synthesis_filter(lp_gn + 11, lp_gd + 1, lp_gn + 11, 22, 10, 0, 0, 0x800);

    rh0 = dot16(lp_gn + 10, lp_gn + 10, 20);
    rh1 = dot16(lp_gn + 10, lp_gn + 11, 20);

    temp = ilog2(rh0) - 14;
    if (temp > 0) {
        rh0 >>= temp;
        rh1 >>= temp;
    }
    if (iabs(rh1) > rh0 || !rh0) return 0;

    gain_term = 0;
    for (int i = 0; i < 20; ++i) gain_term += iabs(lp_gn[i + 10]);
    gain_term >>= 2;
    if (gain_term > 0x400) {
        temp = 0x2000000 / gain_term;
        for (int i = 0; i < subframe_size; ++i) speech[i] = (speech[i] * temp + 0x4000) >> 15;
    }
    return -(rh1 * (1 << 15)) / rh0;
}

int16_t apply_tilt_comp(int16_t* out, int16_t* res_pst, int refl_coeff, int subframe_size,
                        int16_t ht_prev_data) {
    int tmp, tmp2;
    int gt, ga;
    int fact, sh_fact;

    if (refl_coeff > 0) {
        gt = (refl_coeff * G729_TILT_FACTOR_PLUS + 0x4000) >> 15;
        fact = 0x4000;
        sh_fact = 15;
    } else {
        gt = (refl_coeff * G729_TILT_FACTOR_MINUS + 0x4000) >> 15;
        fact = 0x800;
        sh_fact = 12;
    }
    ga = (fact << 15) / clip_int16(32768 - iabs(gt));
    gt >>= 1;

    tmp = res_pst[subframe_size - 1];
    for (int i = subframe_size - 1; i >= 1; --i) {
        tmp2 = (gt * res_pst[i - 1]) * 2 + 0x4000;
        tmp2 = res_pst[i] + (tmp2 >> 15);
        tmp2 = (tmp2 * ga * 2 + fact) >> sh_fact;
        out[i] = tmp2;
    }
    tmp2 = (gt * ht_prev_data) * 2 + 0x4000;
    tmp2 = res_pst[0] + (tmp2 >> 15);
    tmp2 = (tmp2 * ga * 2 + fact) >> sh_fact;
    out[0] = tmp2;
    return tmp;
}

void postfilter(int16_t* ht_prev_data, int* voicing, const int16_t* lp_filter_coeffs,
                int pitch_delay_int, int16_t* residual, int16_t* res_filter_data,
                int16_t* pos_filter_data, int16_t* speech, int subframe_size) {
    int16_t residual_filt_buf[SUBFRAME_SIZE + 11];
    int16_t lp_gn[33];
    int16_t lp_gd[11];
    int tilt_comp_coeff;
    int i;

    memset(lp_gn, 0, sizeof lp_gn);
    for (i = 0; i < 10; ++i)
        lp_gn[i + 11] = (lp_filter_coeffs[i + 1] * formant_pp_factor_num_pow[i] + 0x4000) >> 15;
    for (i = 0; i < 10; ++i)
        lp_gd[i + 1] = (lp_filter_coeffs[i + 1] * formant_pp_factor_den_pow[i] + 0x4000) >> 15;

    memcpy(speech - 10, res_filter_data, 10 * sizeof(int16_t));
    residual_filter(residual + RES_PREV_DATA_SIZE, lp_gn + 11, speech, subframe_size);
    memcpy(res_filter_data, speech + subframe_size - 10, 10 * sizeof(int16_t));

    i = long_term_filter(pitch_delay_int, residual, residual_filt_buf + 10, subframe_size);
    *voicing = imax(*voicing, i);

    memmove(residual, residual + subframe_size, RES_PREV_DATA_SIZE * sizeof(int16_t));

    tilt_comp_coeff = get_tilt_comp(lp_gn, lp_gd, residual_filt_buf + 10, subframe_size);

    lp_synthesis_filter(pos_filter_data + 10, lp_gd + 1, residual_filt_buf + 10, subframe_size, 10,
                        0, 0, 0x800);
    memcpy(pos_filter_data, pos_filter_data + subframe_size, 10 * sizeof(int16_t));

    *ht_prev_data = apply_tilt_comp(speech, pos_filter_data + 10, tilt_comp_coeff, subframe_size,
                                    *ht_prev_data);
}

int16_t adaptive_gain_control(int gain_before, int gain_after, int16_t* speech, int subframe_size,
                              int16_t gain_prev) {
    int gain;
    int exp_before, exp_after;

    if (!gain_after && gain_before) return 0;
    if (gain_before) {
        exp_before = 14 - ilog2(gain_before);
        gain_before = bidir_sal(gain_before, exp_before);
        exp_after = 14 - ilog2(gain_after);
        gain_after = bidir_sal(gain_after, exp_after);
        if (gain_before < gain_after) {
            gain = (gain_before << 15) / gain_after;
            gain = bidir_sal(gain, exp_after - exp_before - 1);
        } else {
            gain = ((gain_before - gain_after) << 14) / gain_after + 0x4000;
            gain = bidir_sal(gain, exp_after - exp_before);
        }
        // the ratio saturates at 1.0 (Q15), compared unsigned: a shift that
        // wraps saturates too
        unsigned g = (unsigned)gain > 0x7fff ? 0x7fff : (unsigned)gain;
        gain = (g * G729_AGC_FAC1 + 0x4000) >> 15;
    } else {
        gain = 0;
    }
    for (int n = 0; n < subframe_size; ++n) {
        gain_prev = (G729_AGC_FACTOR * gain_prev + 0x4000) >> 15;
        gain_prev = clip_int16(gain + gain_prev);
        speech[n] = clip_int16((speech[n] * gain_prev + 0x2000) >> 14);
    }
    return gain_prev;
}

// ---- the decoder ----

struct Decoder {
    int16_t exc_base[2 * SUBFRAME_SIZE + PITCH_DELAY_MAX + INTERPOL_LEN];
    int16_t* exc;
    int pitch_delay_int_prev;
    int16_t past_quantizer_output_buf[MA_NP + 1][10];
    int16_t* past_quantizer_outputs[MA_NP + 1];
    int16_t lsfq[10];
    int16_t lsp_buf[2][10];
    int16_t* lsp[2];
    int16_t quant_energy[4];
    int16_t syn_filter_data[10];
    int16_t residual[SUBFRAME_SIZE + RES_PREV_DATA_SIZE];
    int16_t res_filter_data[SUBFRAME_SIZE + 10];
    int16_t pos_filter_data[SUBFRAME_SIZE + 10];
    int16_t past_gain_pitch[6];
    int16_t past_gain_code[2];
    int16_t was_periodic;
    int16_t ht_prev_data;
    int gain_coeff;
    uint16_t rand_value;
    int ma_predictor_prev;
    int hpf_f[2];
    int16_t hpf_z[2];

    void reset() {
        memset(this, 0, sizeof *this);
        gain_coeff = 16384;
        for (int k = 0; k < MA_NP + 1; ++k) {
            past_quantizer_outputs[k] = past_quantizer_output_buf[k];
            for (int i = 1; i < 11; ++i) past_quantizer_outputs[k][i - 1] = (18717 * i) >> 3;
        }
        lsp[0] = lsp_buf[0];
        lsp[1] = lsp_buf[1];
        memcpy(lsp[0], lsp_init, 10 * sizeof(int16_t));
        exc = &exc_base[PITCH_DELAY_MAX + INTERPOL_LEN];
        pitch_delay_int_prev = PITCH_DELAY_MIN;
        rand_value = 21845;
        for (int i = 0; i < 4; ++i) quant_energy[i] = -14336;
    }

    void lsf_decode(int ma_predictor, int vq_1st, int vq_2nd_low, int vq_2nd_high) {
        static const uint8_t min_distance[2] = {10, 5};
        int16_t* quantizer_output = past_quantizer_outputs[MA_NP];
        for (int i = 0; i < 5; ++i) {
            quantizer_output[i] = cb_lsp_1st[vq_1st][i] + cb_lsp_2nd[vq_2nd_low][i];
            quantizer_output[i + 5] = cb_lsp_1st[vq_1st][i + 5] + cb_lsp_2nd[vq_2nd_high][i + 5];
        }
        for (int j = 0; j < 2; ++j)
            for (int i = 1; i < 10; ++i) {
                int diff = (quantizer_output[i - 1] - quantizer_output[i] + min_distance[j]) >> 1;
                if (diff > 0) {
                    quantizer_output[i - 1] -= diff;
                    quantizer_output[i] += diff;
                }
            }
        for (int i = 0; i < 10; ++i) {
            int sum = quantizer_output[i] * cb_ma_predictor_sum[ma_predictor][i];
            for (int j = 0; j < MA_NP; ++j)
                sum += past_quantizer_outputs[j][i] * cb_ma_predictor[ma_predictor][j][i];
            lsfq[i] = sum >> 15;
        }
        reorder_lsf(lsfq, LSFQ_DIFF_MIN, LSFQ_MIN, LSFQ_MAX);
    }

    void lsf_restore_from_previous() {
        int16_t* quantizer_output = past_quantizer_outputs[MA_NP];
        for (int i = 0; i < 10; ++i) {
            int tmp = lsfq[i] << 15;
            for (int k = 0; k < MA_NP; ++k)
                tmp -= past_quantizer_outputs[k][i] * cb_ma_predictor[ma_predictor_prev][k][i];
            quantizer_output[i] = ((tmp >> 15) * cb_ma_predictor_sum_inv[ma_predictor_prev][i]) >> 12;
        }
    }

    void decode_frame(const uint8_t* buf, int16_t* out_frame) {
        int16_t lp[2][11];
        int pitch_delay_int[2];
        int pitch_delay_3x;
        int16_t fc[SUBFRAME_SIZE];
        int16_t synth[SUBFRAME_SIZE + 10];
        int frame_erasure = 0;
        int bad_pitch = 0;
        int is_periodic = 0;

        for (int i = 0; i < FRAME_BYTES; ++i) frame_erasure |= buf[i];
        frame_erasure = !frame_erasure;

        BitReader gb(buf);
        int ma_predictor = gb.get(1);
        int quantizer_1st = gb.get(7);
        int quantizer_2nd_lo = gb.get(5);
        int quantizer_2nd_hi = gb.get(5);

        if (frame_erasure) {
            lsf_restore_from_previous();
        } else {
            lsf_decode(ma_predictor, quantizer_1st, quantizer_2nd_lo, quantizer_2nd_hi);
            ma_predictor_prev = ma_predictor;
        }
        int16_t* tmp = past_quantizer_outputs[MA_NP];
        memmove(past_quantizer_outputs + 1, past_quantizer_outputs, MA_NP * sizeof(int16_t*));
        past_quantizer_outputs[0] = tmp;

        lsf2lsp(lsp[1], lsfq);
        lp_decode(&lp[0][0], &lp[1][0], lsp[1], lsp[0]);
        int16_t* t = lsp[1];
        lsp[1] = lsp[0];
        lsp[0] = t;

        for (int i = 0; i < 2; ++i) {
            int gain_corr_factor;
            int ac_index = gb.get(i == 0 ? 8 : 5);
            if (!i) bad_pitch = parity(ac_index >> 2) == (int)gb.get(1);
            int fc_indexes = gb.get(13);
            int pulses_signs = gb.get(4);
            int gc_1st_index = gb.get(3);
            int gc_2nd_index = gb.get(4);

            if (frame_erasure) {
                pitch_delay_3x = 3 * pitch_delay_int_prev;
            } else if (!i) {
                if (bad_pitch)
                    pitch_delay_3x = 3 * pitch_delay_int_prev;
                else
                    pitch_delay_3x = decode_8bit_to_1st_delay3(ac_index);
            } else {
                int pitch_delay_min =
                    clip(pitch_delay_int_prev - 5, PITCH_DELAY_MIN, PITCH_DELAY_MAX - 9);
                pitch_delay_3x = decode_5_6_bit_to_2nd_delay3(ac_index, pitch_delay_min);
            }

            pitch_delay_int[i] = (pitch_delay_3x + 1) / 3;
            if (pitch_delay_int[i] > PITCH_DELAY_MAX) pitch_delay_int[i] = PITCH_DELAY_MAX;

            if (frame_erasure) {
                rand_value = 31821 * rand_value + 13849;
                fc_indexes = rand_value & ((1 << 13) - 1);
                rand_value = 31821 * rand_value + 13849;
                pulses_signs = rand_value;
            }

            memset(fc, 0, sizeof fc);
            fc_pulse_per_track(fc, ff_fc_4pulses_8bits_tracks_13, ff_fc_4pulses_8bits_track_4,
                               fc_indexes, pulses_signs, 3, 3);

            if (SUBFRAME_SIZE > pitch_delay_int[i])
                weighted_vector_sum(fc + pitch_delay_int[i], fc + pitch_delay_int[i], fc, 1 << 14,
                                    (int16_t)clip(past_gain_pitch[0], SHARP_MIN, SHARP_MAX), 0, 14,
                                    SUBFRAME_SIZE - pitch_delay_int[i]);

            memmove(past_gain_pitch + 1, past_gain_pitch, 5 * sizeof(int16_t));
            past_gain_code[1] = past_gain_code[0];

            if (frame_erasure) {
                past_gain_pitch[0] = (29491 * past_gain_pitch[0]) >> 15;
                past_gain_code[0] = (2007 * past_gain_code[0]) >> 11;
                gain_corr_factor = 0;
            } else {
                past_gain_pitch[0] = cb_gain_1st_8k[gc_1st_index][0] + cb_gain_2nd_8k[gc_2nd_index][0];
                gain_corr_factor = cb_gain_1st_8k[gc_1st_index][1] + cb_gain_2nd_8k[gc_2nd_index][1];
                past_gain_code[0] = decode_gain_code(gain_corr_factor, fc, MR_ENERGY, quant_energy,
                                                     ma_prediction_coeff, SUBFRAME_SIZE, 4);
            }
            update_past_gain(quant_energy, gain_corr_factor, 2, frame_erasure);

            interpolate(exc + i * SUBFRAME_SIZE, exc + i * SUBFRAME_SIZE - pitch_delay_3x / 3,
                        ff_acelp_interp_filter, 6, (pitch_delay_3x % 3) << 1, 10, SUBFRAME_SIZE);

            weighted_vector_sum(exc + i * SUBFRAME_SIZE, exc + i * SUBFRAME_SIZE, fc,
                                (!was_periodic && frame_erasure) ? 0 : past_gain_pitch[0],
                                (was_periodic && frame_erasure) ? 0 : past_gain_code[0], 1 << 13,
                                14, SUBFRAME_SIZE);

            memcpy(synth, syn_filter_data, 10 * sizeof(int16_t));
            if (lp_synthesis_filter(synth + 10, &lp[i][1], exc + i * SUBFRAME_SIZE, SUBFRAME_SIZE,
                                    10, 1, 0, 0x800))
                // overflow: scale the excitation down (and synthesize again below)
                for (int j = 0; j < 2 * SUBFRAME_SIZE + PITCH_DELAY_MAX + INTERPOL_LEN; ++j)
                    exc_base[j] >>= 2;
            lp_synthesis_filter(synth + 10, &lp[i][1], exc + i * SUBFRAME_SIZE, SUBFRAME_SIZE, 10,
                                0, 0, 0x800);
            memcpy(syn_filter_data, synth + SUBFRAME_SIZE, 10 * sizeof(int16_t));

            int gain_before = 0;
            for (int j = 0; j < SUBFRAME_SIZE; ++j) gain_before += iabs(synth[j + 10]);

            postfilter(&ht_prev_data, &is_periodic, &lp[i][0], pitch_delay_int[0], residual,
                       res_filter_data, pos_filter_data, synth + 10, SUBFRAME_SIZE);

            int gain_after = 0;
            for (int j = 0; j < SUBFRAME_SIZE; ++j) gain_after += iabs(synth[j + 10]);

            gain_coeff = adaptive_gain_control(gain_before, gain_after, synth + 10, SUBFRAME_SIZE,
                                               gain_coeff);

            if (frame_erasure)
                pitch_delay_int_prev = imin(pitch_delay_int_prev + 1, PITCH_DELAY_MAX);
            else
                pitch_delay_int_prev = pitch_delay_int[i];

            memcpy(synth + 8, hpf_z, 2 * sizeof(int16_t));
            high_pass_filter(out_frame + i * SUBFRAME_SIZE, hpf_f, synth + 10, SUBFRAME_SIZE);
            memcpy(hpf_z, synth + 8 + SUBFRAME_SIZE, 2 * sizeof(int16_t));
        }
        was_periodic = is_periodic;
        memmove(exc_base, exc_base + 2 * SUBFRAME_SIZE,
                (PITCH_DELAY_MAX + INTERPOL_LEN) * sizeof(int16_t));
    }
};

}  // namespace

extern "C" {

void* skt_g729_new() {
    auto* d = new Decoder();
    d->reset();
    return d;
}

void skt_g729_free(void* h) { delete (Decoder*)h; }

void skt_g729_reset(void* h) { ((Decoder*)h)->reset(); }

// Decode the whole 10-byte frames of `data` (n frames -> n * 80 samples);
// a trailing partial frame is ignored. Returns the samples written.
long skt_g729_decode(void* h, const uint8_t* data, long nbytes, int16_t* out) {
    auto* d = (Decoder*)h;
    long written = 0;
    for (long off = 0; off + FRAME_BYTES <= nbytes; off += FRAME_BYTES) {
        d->decode_frame(data + off, out + written);
        written += 2 * SUBFRAME_SIZE;
    }
    return written;
}

}  // extern "C"
