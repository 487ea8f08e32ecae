// AMR-NB decoder (all eight modes, 4.75 to 12.2 kbit/s), float.
//
// Follows libavcodec's float decoder (amrnbdec.c and the ACELP / CELP /
// LSP helpers it calls) operation for operation, in the same float and
// double types, so that its output is libavcodec's to rounding: the
// storage-format bit reordering (order tables), the split (12.2) and
// predictive (other modes) LSF quantizers, the 1/3 and 1/6 resolution pitch
// lags with the windowed-sinc interpolation, the algebraic codebooks of each
// mode, the gain tables with the MA energy prediction, pitch sharpening,
// fixed-gain smoothing, the anti-sparseness filters, the LP synthesis with
// its overflow rescale, the formant / tilt postfilter with its adaptive
// gain control, and the output high-pass.
//
// A frame is its TOC byte and its payload, as libavcodec takes it. A SID
// frame (FT 8) and a frame type of 9 or more give no samples and leave the
// state as it was, as libavcodec refuses them; the quality bit is read and
// not used, as libavcodec does.
//
// Every table comes from generated/amrnb_tables.h, which
// tools/extract_celp_tables.py writes from data/amrnb_tables.npz.
//
// C ABI: skt_amrnb_new / skt_amrnb_decode_frame (one frame -> 160 floats
// or none) / skt_amrnb_reset / skt_amrnb_free.

#include <cmath>
#include <cstdint>
#include <cstring>

#include "../generated/amrnb_tables.h"

namespace {

using namespace amrnb_tab;

enum Mode { MODE_4k75 = 0, MODE_5k15, MODE_5k9, MODE_6k7, MODE_7k4, MODE_7k95, MODE_10k2,
            MODE_12k2, MODE_DTX, N_MODES, NO_DATA = 15 };

constexpr int LP_FILTER_ORDER = 10;
constexpr int AMR_BLOCK_SIZE = 160;
constexpr int AMR_SUBFRAME_SIZE = 40;
constexpr int PITCH_DELAY_MIN = 20;
constexpr int PITCH_DELAY_MAX = 143;
constexpr int PITCH_LAG_MIN_MODE_12k2 = 18;
constexpr double AMR_SAMPLE_BOUND = 32768.0;
constexpr double PRED_FAC_MODE_12k2 = 0.65;
constexpr double LSF_R_FAC = 8000.0 / 32768.0;
constexpr double MIN_LSF_SPACING = 50.0488 / 8000.0;
constexpr double MIN_ENERGY = -14.0;
constexpr double SHARP_MAX = 0.79449462890625;
constexpr int AMR_TILT_RESPONSE = 22;
constexpr double AMR_TILT_GAMMA_T = 0.8;
constexpr double AMR_AGC_ALPHA = 0.9;
constexpr double M_LOG2_10 = 3.32192809488736234787;  // log2(10), libavutil's

inline int clip(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
inline float clipf(float v, float lo, float hi) { return v < lo ? lo : (v > hi ? hi : v); }

// ---- the unpacked frame: lsf[5], then four subframes of
// {p_lag, p_gain, fixed_gain, pulses[10]} (libavcodec's AMRNBFrame) ----

constexpr int FRAME_FIELDS = 5 + 4 * 13;

struct Subframe {
    const uint16_t* f;
    uint16_t p_lag() const { return f[0]; }
    uint16_t p_gain() const { return f[1]; }
    uint16_t fixed_gain() const { return f[2]; }
    const uint16_t* pulses() const { return f + 3; }
};

const uint8_t* order_table(int mode) {
    static const uint8_t* const t[8] = {order_MODE_4k75, order_MODE_5k15, order_MODE_5k9,
                                        order_MODE_6k7,  order_MODE_7k4,  order_MODE_7k95,
                                        order_MODE_10k2, order_MODE_12k2};
    return t[mode];
}

// each entry: field size, field offset in bytes, then the bits, MSB first
void bit_reorder(uint16_t* out, const uint8_t* data, const uint8_t* ord) {
    memset(out, 0, FRAME_FIELDS * sizeof(uint16_t));
    int field_size;
    while ((field_size = *ord++)) {
        int field = 0;
        int field_offset = *ord++;
        while (field_size--) {
            int bit = *ord++;
            field <<= 1;
            field |= (data[bit >> 3] >> (bit & 7)) & 1;
        }
        out[field_offset >> 1] = field;
    }
}

// ---- the shared ACELP / CELP helpers ----

struct AMRFixed {
    int n;
    int x[10];
    float y[10];
    int no_repeat_mask;
    int pitch_lag;
    float pitch_fac;
};

float scalarproduct_float(const float* v1, const float* v2, int len) {
    float p = 0.0;
    for (int i = 0; i < len; i++) p += v1[i] * v2[i];
    return p;
}

void weighted_vector_sumf(float* out, const float* in_a, const float* in_b, float weight_coeff_a,
                          float weight_coeff_b, int length) {
    for (int i = 0; i < length; i++) out[i] = weight_coeff_a * in_a[i] + weight_coeff_b * in_b[i];
}

void weighted_vector_sumd(double* out, const double* in_a, const double* in_b,
                          double weight_coeff_a, double weight_coeff_b, int length) {
    for (int i = 0; i < length; i++) out[i] = weight_coeff_a * in_a[i] + weight_coeff_b * in_b[i];
}

void set_min_dist_lsf(float* lsf, double min_spacing, int size) {
    float prev = 0.0;
    for (int i = 0; i < size; i++) {
        double m = prev + min_spacing;
        prev = lsf[i] = lsf[i] > m ? lsf[i] : m;
    }
}

void lsf2lspd(double* lsp, const float* lsf, int lp_order) {
    for (int i = 0; i < lp_order; i++) lsp[i] = cos(2.0 * M_PI * lsf[i]);
}

void lsp2polyf(const double* lsp, double* f, int lp_half_order) {
    f[0] = 1.0;
    f[1] = -2 * lsp[0];
    lsp -= 2;
    for (int i = 2; i <= lp_half_order; i++) {
        double val = -2 * lsp[2 * i];
        f[i] = val * f[i - 1] + 2 * f[i - 2];
        for (int j = i - 1; j > 1; j--) f[j] += f[j - 1] * val + f[j - 2];
        f[1] += val;
    }
}

void lspd2lpc(const double* lsp, float* lpc, int lp_half_order) {
    double pa[6], qa[6];
    float* lpc2 = lpc + (lp_half_order << 1) - 1;
    lsp2polyf(lsp, pa, lp_half_order);
    lsp2polyf(lsp + 1, qa, lp_half_order);
    while (lp_half_order--) {
        double paf = pa[lp_half_order + 1] + pa[lp_half_order];
        double qaf = qa[lp_half_order + 1] - qa[lp_half_order];
        lpc[lp_half_order] = 0.5 * (paf + qaf);
        lpc2[-lp_half_order] = 0.5 * (paf - qaf);
    }
}

void interpolatef(float* out, const float* in, const float* filter_coeffs, int precision,
                  int frac_pos, int filter_length, int length) {
    for (int n = 0; n < length; n++) {
        int idx = 0;
        float v = 0;
        for (int i = 0; i < filter_length;) {
            v += in[n + i] * filter_coeffs[idx + frac_pos];
            idx += precision;
            i++;
            v += in[n - i] * filter_coeffs[idx - frac_pos];
        }
        out[n] = v;
    }
}

void decode_pitch_lag(int* lag_int, int* lag_frac, int pitch_index, int prev_lag_int,
                      int subframe, int third_as_first, int resolution) {
    if (subframe == 0 || (subframe == 2 && third_as_first)) {
        if (pitch_index < 197)
            pitch_index += 59;
        else
            pitch_index = 3 * pitch_index - 335;
    } else {
        if (resolution == 4) {
            int search_range_min = clip(prev_lag_int - 5, PITCH_DELAY_MIN, PITCH_DELAY_MAX - 9);
            if (pitch_index < 4)
                pitch_index = 3 * (pitch_index + search_range_min) + 1;
            else if (pitch_index < 12)
                pitch_index += 3 * search_range_min + 7;
            else
                pitch_index = 3 * (pitch_index + search_range_min) - 17;
        } else {
            // 1/3 resolution over [min, min + 19] (resolution 5, the 6-bit
            // index of 7.95 kbit/s) or [min, min + 9] (resolution 6, the 5-bit
            // ones), libavcodec's numbering
            int half = resolution == 5 ? 10 : 5;
            pitch_index += 3 * clip(prev_lag_int - half, PITCH_DELAY_MIN,
                                    PITCH_DELAY_MAX - 2 * half + 1) - 1;
        }
    }
    *lag_int = (pitch_index * 10923) >> 15;
    *lag_frac = pitch_index - 3 * *lag_int - 1;
}

void decode_10_pulses_35bits(const uint16_t* fixed_index, AMRFixed* fixed_sparse,
                             const uint8_t* gray, int half_pulse_count, int bits) {
    int mask = (1 << bits) - 1;
    fixed_sparse->no_repeat_mask = 0;
    fixed_sparse->n = 2 * half_pulse_count;
    for (int i = 0; i < half_pulse_count; i++) {
        const int pos1 = gray[fixed_index[2 * i + 1] & mask] + i;
        const int pos2 = gray[fixed_index[2 * i] & mask] + i;
        const float sign = (fixed_index[2 * i + 1] & (1 << bits)) ? -1.0 : 1.0;
        fixed_sparse->x[2 * i + 1] = pos1;
        fixed_sparse->x[2 * i] = pos2;
        fixed_sparse->y[2 * i + 1] = sign;
        fixed_sparse->y[2 * i] = pos2 < pos1 ? -sign : sign;
    }
}

void set_fixed_vector(float* out, const AMRFixed* in, float scale, int size) {
    for (int i = 0; i < in->n; i++) {
        int x = in->x[i], repeats = !((in->no_repeat_mask >> i) & 1);
        float y = in->y[i] * scale;
        if (in->pitch_lag > 0) do {
                out[x] += y;
                y *= in->pitch_fac;
                x += in->pitch_lag;
            } while (x < size && repeats);
    }
}

void clear_fixed_vector(float* out, const AMRFixed* in, int size) {
    for (int i = 0; i < in->n; i++) {
        int x = in->x[i], repeats = !((in->no_repeat_mask >> i) & 1);
        if (in->pitch_lag > 0) do {
                out[x] = 0.0;
                x += in->pitch_lag;
            } while (x < size && repeats);
    }
}

float amr_set_fixed_gain(float fixed_gain_factor, float fixed_mean_energy,
                         float* prediction_error, float energy_mean_, const float* pred_table) {
    // 10^(0.05 x) as exp2(log2(10) 0.05 x)
    float val = fixed_gain_factor *
                exp2(M_LOG2_10 * (0.05 * (scalarproduct_float(pred_table, prediction_error, 4) +
                                          energy_mean_))) /
                sqrtf(fixed_mean_energy ? fixed_mean_energy : 1.0);
    memmove(&prediction_error[0], &prediction_error[1], 3 * sizeof(prediction_error[0]));
    prediction_error[3] = 20.0 * log10f(fixed_gain_factor);
    return val;
}

void scale_vector_to_given_sum_of_squares(float* out, const float* in, float sum_of_squares,
                                          const int n) {
    float scalefactor = scalarproduct_float(in, in, n);
    if (scalefactor) scalefactor = sqrt(sum_of_squares / scalefactor);
    for (int i = 0; i < n; i++) out[i] = in[i] * scalefactor;
}

// the 1/A(z) filter in libavcodec's order: four outputs at a time, the
// taps applied in its sequence
void lp_synthesis_filterf(float* out, const float* filter_coeffs, const float* in,
                          int buffer_length, int filter_length) {
    int i, n;
    float out0, out1, out2, out3;
    float old_out0, old_out1, old_out2, old_out3;
    float a, b, c;

    a = filter_coeffs[0];
    b = filter_coeffs[1];
    c = filter_coeffs[2];
    b -= filter_coeffs[0] * filter_coeffs[0];
    c -= filter_coeffs[1] * filter_coeffs[0];
    c -= filter_coeffs[0] * b;

    old_out0 = out[-4];
    old_out1 = out[-3];
    old_out2 = out[-2];
    old_out3 = out[-1];
    for (n = 0; n <= buffer_length - 4; n += 4) {
        float tmp0, tmp1, tmp2;
        float val;

        out0 = in[0];
        out1 = in[1];
        out2 = in[2];
        out3 = in[3];

        out0 -= filter_coeffs[2] * old_out1;
        out1 -= filter_coeffs[2] * old_out2;
        out2 -= filter_coeffs[2] * old_out3;

        out0 -= filter_coeffs[1] * old_out2;
        out1 -= filter_coeffs[1] * old_out3;

        out0 -= filter_coeffs[0] * old_out3;

        val = filter_coeffs[3];

        out0 -= val * old_out0;
        out1 -= val * old_out1;
        out2 -= val * old_out2;
        out3 -= val * old_out3;

        for (i = 5; i < filter_length; i += 2) {
            old_out3 = out[-i];
            val = filter_coeffs[i - 1];

            out0 -= val * old_out3;
            out1 -= val * old_out0;
            out2 -= val * old_out1;
            out3 -= val * old_out2;

            old_out2 = out[-i - 1];

            val = filter_coeffs[i];

            out0 -= val * old_out2;
            out1 -= val * old_out3;
            out2 -= val * old_out0;
            out3 -= val * old_out1;

            float t = old_out0;
            old_out0 = old_out2;
            old_out2 = t;
            old_out1 = old_out3;
        }

        tmp0 = out0;
        tmp1 = out1;
        tmp2 = out2;

        out3 -= a * tmp2;
        out2 -= a * tmp1;
        out1 -= a * tmp0;

        out3 -= b * tmp1;
        out2 -= b * tmp0;

        out3 -= c * tmp0;

        out[0] = out0;
        out[1] = out1;
        out[2] = out2;
        out[3] = out3;

        old_out0 = out0;
        old_out1 = out1;
        old_out2 = out2;
        old_out3 = out3;

        out += 4;
        in += 4;
    }

    out -= n;
    in -= n;
    for (; n < buffer_length; n++) {
        out[n] = in[n];
        for (i = 1; i <= filter_length; i++) out[n] -= filter_coeffs[i - 1] * out[n - i];
    }
}

void lp_zero_synthesis_filterf(float* out, const float* filter_coeffs, const float* in,
                               int buffer_length, int filter_length) {
    for (int n = 0; n < buffer_length; n++) {
        out[n] = in[n];
        for (int i = 1; i <= filter_length; i++) out[n] += filter_coeffs[i - 1] * in[n - i];
    }
}

void circ_addf(float* out, const float* in, const float* lagged, int lag, float fac, int n) {
    int k;
    for (k = 0; k < lag; k++) out[k] = in[k] + fac * lagged[n + k - lag];
    for (; k < n; k++) out[k] = in[k] + fac * lagged[k - lag];
}

void tilt_compensation(float* mem, float tilt, float* samples, int size) {
    float new_tilt_mem = samples[size - 1];
    for (int i = size - 1; i > 0; i--) samples[i] -= tilt * samples[i - 1];
    samples[0] -= tilt * *mem;
    *mem = new_tilt_mem;
}

void adaptive_gain_control(float* out, const float* in, float speech_energ, int size,
                           float alpha, float* gain_mem) {
    float postfilter_energ = scalarproduct_float(in, in, size);
    float gain_scale_factor = 1.0;
    float mem = *gain_mem;
    if (postfilter_energ) gain_scale_factor = sqrt(speech_energ / postfilter_energ);
    gain_scale_factor *= 1.0 - alpha;
    for (int i = 0; i < size; i++) {
        mem = alpha * mem + gain_scale_factor;
        out[i] = in[i] * mem;
    }
    *gain_mem = mem;
}

void apply_order_2_transfer_function(float* out, const float* in, const float zero_coeffs[2],
                                     const float pole_coeffs[2], float gain, float mem[2], int n) {
    for (int i = 0; i < n; i++) {
        float tmp = gain * in[i] - pole_coeffs[0] * mem[0] - pole_coeffs[1] * mem[1];
        out[i] = tmp + zero_coeffs[0] * mem[0] + zero_coeffs[1] * mem[1];
        mem[1] = mem[0];
        mem[0] = tmp;
    }
}

// ---- the decoder (amrnbdec.c) ----

struct Decoder {
    uint16_t frame[FRAME_FIELDS];
    int cur_frame_mode;
    int16_t prev_lsf_r[LP_FILTER_ORDER];
    double lsp[4][LP_FILTER_ORDER];
    double prev_lsp_sub4[LP_FILTER_ORDER];
    float lsf_q[4][LP_FILTER_ORDER];
    float lsf_avg[LP_FILTER_ORDER];
    float lpc[4][LP_FILTER_ORDER];
    uint8_t pitch_lag_int;
    float excitation_buf[PITCH_DELAY_MAX + LP_FILTER_ORDER + 1 + AMR_SUBFRAME_SIZE];
    float* excitation;
    float pitch_vector[AMR_SUBFRAME_SIZE];
    float fixed_vector[AMR_SUBFRAME_SIZE];
    float prediction_error[4];
    float pitch_gain[5];
    float fixed_gain[5];
    float beta;
    uint8_t diff_count;
    uint8_t hang_count;
    float prev_sparse_fixed_gain;
    uint8_t prev_ir_filter_nr;
    uint8_t ir_filter_onset;
    float postfilter_mem[10];
    float tilt_mem;
    float postfilter_agc;
    float high_pass_mem[2];
    float samples_in[LP_FILTER_ORDER + AMR_SUBFRAME_SIZE];

    void reset() {
        memset(this, 0, sizeof *this);
        excitation = &excitation_buf[PITCH_DELAY_MAX + LP_FILTER_ORDER + 1];
        for (int i = 0; i < LP_FILTER_ORDER; i++) {
            prev_lsp_sub4[i] = lsp_sub4_init[i] * 1000 / (float)(1 << 15);
            lsf_avg[i] = lsf_q[3][i] = lsp_avg_init[i] / (float)(1 << 15);
        }
        for (int i = 0; i < 4; i++) prediction_error[i] = MIN_ENERGY;
    }

    Subframe sub(int i) const { return Subframe{frame + 5 + 13 * i}; }

    void interpolate_lsf(float lsf_new[LP_FILTER_ORDER]) {
        for (int i = 0; i < 4; i++)
            weighted_vector_sumf(lsf_q[i], lsf_q[3], lsf_new, 0.25 * (3 - i), 0.25 * (i + 1),
                                 LP_FILTER_ORDER);
    }

    void lsf2lsp_for_mode12k2(double lsp_out[LP_FILTER_ORDER], const float lsf_no_r[LP_FILTER_ORDER],
                              const int16_t* lsf_quantizer[5], int quantizer_offset, int sign,
                              int update) {
        int16_t lsf_r[LP_FILTER_ORDER];
        float lsf_q_[LP_FILTER_ORDER];
        for (int i = 0; i < LP_FILTER_ORDER >> 1; i++)
            memcpy(&lsf_r[i << 1], &lsf_quantizer[i][quantizer_offset], 2 * sizeof(*lsf_r));
        if (sign) {
            lsf_r[4] *= -1;
            lsf_r[5] *= -1;
        }
        if (update) memcpy(prev_lsf_r, lsf_r, LP_FILTER_ORDER * sizeof(*lsf_r));
        for (int i = 0; i < LP_FILTER_ORDER; i++)
            lsf_q_[i] = lsf_r[i] * (LSF_R_FAC / 8000.0) + lsf_no_r[i] * (1.0 / 8000.0);
        set_min_dist_lsf(lsf_q_, MIN_LSF_SPACING, LP_FILTER_ORDER);
        if (update) interpolate_lsf(lsf_q_);
        lsf2lspd(lsp_out, lsf_q_, LP_FILTER_ORDER);
    }

    void lsf2lsp_5() {
        const uint16_t* lsf_param = frame;
        float lsf_no_r[LP_FILTER_ORDER];
        const int16_t* lsf_quantizer[5];
        lsf_quantizer[0] = lsf_5_1[lsf_param[0]];
        lsf_quantizer[1] = lsf_5_2[lsf_param[1]];
        lsf_quantizer[2] = lsf_5_3[lsf_param[2] >> 1];
        lsf_quantizer[3] = lsf_5_4[lsf_param[3]];
        lsf_quantizer[4] = lsf_5_5[lsf_param[4]];
        for (int i = 0; i < LP_FILTER_ORDER; i++)
            lsf_no_r[i] = prev_lsf_r[i] * LSF_R_FAC * PRED_FAC_MODE_12k2 + lsf_5_mean[i];
        lsf2lsp_for_mode12k2(lsp[1], lsf_no_r, lsf_quantizer, 0, lsf_param[2] & 1, 0);
        lsf2lsp_for_mode12k2(lsp[3], lsf_no_r, lsf_quantizer, 2, lsf_param[2] & 1, 1);
        weighted_vector_sumd(lsp[0], prev_lsp_sub4, lsp[1], 0.5, 0.5, LP_FILTER_ORDER);
        weighted_vector_sumd(lsp[2], lsp[1], lsp[3], 0.5, 0.5, LP_FILTER_ORDER);
    }

    void lsf2lsp_3() {
        const uint16_t* lsf_param = frame;
        int16_t lsf_r[LP_FILTER_ORDER];
        float lsf_q_[LP_FILTER_ORDER];
        const int16_t* q;
        q = cur_frame_mode == MODE_7k95 ? lsf_3_1_MODE_7k95[lsf_param[0]] : lsf_3_1[lsf_param[0]];
        memcpy(lsf_r, q, 3 * sizeof(*lsf_r));
        q = lsf_3_2[lsf_param[1] << (cur_frame_mode <= MODE_5k15)];
        memcpy(lsf_r + 3, q, 3 * sizeof(*lsf_r));
        q = cur_frame_mode <= MODE_5k15 ? lsf_3_3_MODE_5k15[lsf_param[2]] : lsf_3_3[lsf_param[2]];
        memcpy(lsf_r + 6, q, 4 * sizeof(*lsf_r));
        // lsf_3_mean_8000 is the mean vector times 1 / 8000, as the compiler
        // folds lsf_3_mean[i] * (1.0 / 8000.0)
        for (int i = 0; i < LP_FILTER_ORDER; i++)
            lsf_q_[i] = (lsf_r[i] + prev_lsf_r[i] * pred_fac[i]) * (LSF_R_FAC / 8000.0) +
                        lsf_3_mean_8000[i];
        set_min_dist_lsf(lsf_q_, MIN_LSF_SPACING, LP_FILTER_ORDER);
        interpolate_lsf(lsf_q_);
        memcpy(prev_lsf_r, lsf_r, LP_FILTER_ORDER * sizeof(*lsf_r));
        lsf2lspd(lsp[3], lsf_q_, LP_FILTER_ORDER);
        for (int i = 1; i <= 3; i++)
            for (int j = 0; j < LP_FILTER_ORDER; j++)
                lsp[i - 1][j] = prev_lsp_sub4[j] + (lsp[3][j] - prev_lsp_sub4[j]) * 0.25 * i;
    }

    static void decode_pitch_lag_1_6(int* lag_int, int* lag_frac, int pitch_index,
                                     int prev_lag_int, int subframe) {
        if (subframe == 0 || subframe == 2) {
            if (pitch_index < 463) {
                *lag_int = ((pitch_index + 107) * 10923) >> 16;
                *lag_frac = pitch_index - *lag_int * 6 + 105;
            } else {
                *lag_int = pitch_index - 368;
                *lag_frac = 0;
            }
        } else {
            *lag_int = (((pitch_index + 5) * 10923) >> 16) - 1;
            *lag_frac = pitch_index - *lag_int * 6 - 3;
            *lag_int += clip(prev_lag_int - 5, PITCH_LAG_MIN_MODE_12k2, PITCH_DELAY_MAX - 9);
        }
    }

    void decode_pitch_vector(Subframe s, int subframe) {
        int lag_int, lag_frac;
        int mode = cur_frame_mode;
        if (mode == MODE_12k2) {
            decode_pitch_lag_1_6(&lag_int, &lag_frac, s.p_lag(), pitch_lag_int, subframe);
        } else {
            decode_pitch_lag(&lag_int, &lag_frac, s.p_lag(), pitch_lag_int, subframe,
                             mode != MODE_4k75 && mode != MODE_5k15,
                             mode <= MODE_6k7 ? 4 : (mode == MODE_7k95 ? 5 : 6));
            lag_frac *= 2;
        }
        pitch_lag_int = lag_int;  // kept in a byte, as libavcodec keeps it
        lag_int += lag_frac > 0;
        interpolatef(excitation, excitation + 1 - lag_int, ff_b60_sinc, 6,
                     lag_frac + 6 - 6 * (lag_frac > 0), 10, AMR_SUBFRAME_SIZE);
        memcpy(pitch_vector, excitation, AMR_SUBFRAME_SIZE * sizeof(float));
    }

    static void decode_10bit_pulse(int code, int pulse_position[8], int i1, int i2, int i3) {
        const uint8_t* positions = base_five_table[code >> 3];
        pulse_position[i1] = (positions[2] << 1) + (code & 1);
        pulse_position[i2] = (positions[1] << 1) + ((code >> 1) & 1);
        pulse_position[i3] = (positions[0] << 1) + ((code >> 2) & 1);
    }

    static void decode_8_pulses_31bits(const uint16_t* fixed_index, AMRFixed* fixed_sparse) {
        int pulse_position[8];
        int temp;
        decode_10bit_pulse(fixed_index[4], pulse_position, 0, 4, 1);
        decode_10bit_pulse(fixed_index[5], pulse_position, 2, 6, 5);
        temp = ((fixed_index[6] >> 2) * 25 + 12) >> 5;
        pulse_position[3] = temp % 5;
        pulse_position[7] = temp / 5;
        if (pulse_position[7] & 1) pulse_position[3] = 4 - pulse_position[3];
        pulse_position[3] = (pulse_position[3] << 1) + (fixed_index[6] & 1);
        pulse_position[7] = (pulse_position[7] << 1) + ((fixed_index[6] >> 1) & 1);
        fixed_sparse->n = 8;
        for (int i = 0; i < 4; i++) {
            const int pos1 = (pulse_position[i] << 2) + i;
            const int pos2 = (pulse_position[i + 4] << 2) + i;
            const float sign = fixed_index[i] ? -1.0 : 1.0;
            fixed_sparse->x[i] = pos1;
            fixed_sparse->x[i + 4] = pos2;
            fixed_sparse->y[i] = sign;
            fixed_sparse->y[i + 4] = pos2 < pos1 ? -sign : sign;
        }
    }

    static void decode_fixed_sparse(AMRFixed* fixed_sparse, const uint16_t* pulses, int mode,
                                    int subframe) {
        if (mode == MODE_12k2) {
            decode_10_pulses_35bits(pulses, fixed_sparse, gray_decode, 5, 3);
        } else if (mode == MODE_10k2) {
            decode_8_pulses_31bits(pulses, fixed_sparse);
        } else {
            int* pulse_position = fixed_sparse->x;
            int pulse_subset;
            const int fixed_index = pulses[0];
            if (mode <= MODE_5k15) {
                pulse_subset = ((fixed_index >> 3) & 8) + (subframe << 1);
                pulse_position[0] = (fixed_index & 7) * 5 + track_position[pulse_subset];
                pulse_position[1] = ((fixed_index >> 3) & 7) * 5 + track_position[pulse_subset + 1];
                fixed_sparse->n = 2;
            } else if (mode == MODE_5k9) {
                pulse_subset = ((fixed_index & 1) << 1) + 1;
                pulse_position[0] = ((fixed_index >> 1) & 7) * 5 + pulse_subset;
                pulse_subset = (fixed_index >> 4) & 3;
                pulse_position[1] =
                    ((fixed_index >> 6) & 7) * 5 + pulse_subset + (pulse_subset == 3 ? 1 : 0);
                fixed_sparse->n = pulse_position[0] == pulse_position[1] ? 1 : 2;
            } else if (mode == MODE_6k7) {
                pulse_position[0] = (fixed_index & 7) * 5;
                pulse_subset = (fixed_index >> 2) & 2;
                pulse_position[1] = ((fixed_index >> 4) & 7) * 5 + pulse_subset + 1;
                pulse_subset = (fixed_index >> 6) & 2;
                pulse_position[2] = ((fixed_index >> 8) & 7) * 5 + pulse_subset + 2;
                fixed_sparse->n = 3;
            } else {  // MODE_7k4 and MODE_7k95
                pulse_position[0] = gray_decode[fixed_index & 7];
                pulse_position[1] = gray_decode[(fixed_index >> 3) & 7] + 1;
                pulse_position[2] = gray_decode[(fixed_index >> 6) & 7] + 2;
                pulse_subset = (fixed_index >> 9) & 1;
                pulse_position[3] = gray_decode[(fixed_index >> 10) & 7] + pulse_subset + 3;
                fixed_sparse->n = 4;
            }
            for (int i = 0; i < fixed_sparse->n; i++)
                fixed_sparse->y[i] = (pulses[1] >> i) & 1 ? 1.0 : -1.0;
        }
    }

    void decode_gains(Subframe s, int mode, int subframe, float* fixed_gain_factor) {
        if (mode == MODE_12k2 || mode == MODE_7k95) {
            pitch_gain[4] = qua_gain_pit[s.p_gain()] * (1.0 / 16384.0);
            *fixed_gain_factor = qua_gain_code[s.fixed_gain()] * (1.0 / 2048.0);
        } else {
            const uint16_t* gains;
            if (mode >= MODE_6k7) {
                gains = gains_high[s.p_gain()];
            } else if (mode >= MODE_5k15) {
                gains = gains_low[s.p_gain()];
            } else {
                // the 4.75 kbit/s gains are coded in subframes 0 and 2, two rows each
                gains = &gains_MODE_4k75[0][0] +
                        2 * ((sub(subframe & 2).p_gain() << 1) + (subframe & 1));
            }
            pitch_gain[4] = gains[0] * (1.0 / 16384.0);
            *fixed_gain_factor = gains[1] * (1.0 / 4096.0);
        }
    }

    void pitch_sharpening(int subframe, int mode, AMRFixed* fixed_sparse) {
        if (mode == MODE_12k2) beta = pitch_gain[4] < 1.0 ? pitch_gain[4] : 1.0;
        fixed_sparse->pitch_lag = pitch_lag_int;
        fixed_sparse->pitch_fac = beta;
        if (mode != MODE_4k75 || subframe & 1) beta = clipf(pitch_gain[4], 0.0, SHARP_MAX);
    }

    float fixed_gain_smooth(const float* lsf, const float* lsf_avg_, int mode) {
        float diff = 0.0;
        for (int i = 0; i < LP_FILTER_ORDER; i++) diff += fabs(lsf_avg_[i] - lsf[i]) / lsf_avg_[i];
        diff_count++;
        if (diff <= 0.65) diff_count = 0;
        if (diff_count > 10) {
            hang_count = 0;
            diff_count--;
        }
        if (hang_count < 40) {
            hang_count++;
        } else if (mode < MODE_7k4 || mode == MODE_10k2) {
            const float smoothing_factor = clipf(4.0 * diff - 1.6, 0.0, 1.0);
            const float fixed_gain_mean = (fixed_gain[0] + fixed_gain[1] + fixed_gain[2] +
                                           fixed_gain[3] + fixed_gain[4]) * 0.2;
            return smoothing_factor * fixed_gain[4] + (1.0 - smoothing_factor) * fixed_gain_mean;
        }
        return fixed_gain[4];
    }

    static void apply_ir_filter(float* out, const AMRFixed* in, const float* filter) {
        float filter1[AMR_SUBFRAME_SIZE], filter2[AMR_SUBFRAME_SIZE];
        int lag = in->pitch_lag;
        float fac = in->pitch_fac;
        if (lag < AMR_SUBFRAME_SIZE) {
            circ_addf(filter1, filter, filter, lag, fac, AMR_SUBFRAME_SIZE);
            if (lag < AMR_SUBFRAME_SIZE >> 1)
                circ_addf(filter2, filter, filter1, lag, fac, AMR_SUBFRAME_SIZE);
        }
        memset(out, 0, sizeof(float) * AMR_SUBFRAME_SIZE);
        for (int i = 0; i < in->n; i++) {
            int x = in->x[i];
            float y = in->y[i];
            const float* filterp;
            if (x >= AMR_SUBFRAME_SIZE - lag)
                filterp = filter;
            else if (x >= AMR_SUBFRAME_SIZE - (lag << 1))
                filterp = filter1;
            else
                filterp = filter2;
            circ_addf(out, out, filterp, x, y, AMR_SUBFRAME_SIZE);
        }
    }

    const float* anti_sparseness(AMRFixed* fixed_sparse, const float* fixed_vector_,
                                 float fixed_gain_, float* out) {
        int ir_filter_nr;
        if (pitch_gain[4] < 0.6)
            ir_filter_nr = 0;
        else if (pitch_gain[4] < 0.9)
            ir_filter_nr = 1;
        else
            ir_filter_nr = 2;

        if (fixed_gain_ > 2.0 * prev_sparse_fixed_gain)
            ir_filter_onset = 2;
        else if (ir_filter_onset)
            ir_filter_onset--;

        if (!ir_filter_onset) {
            int count = 0;
            for (int i = 0; i < 5; i++)
                if (pitch_gain[i] < 0.6) count++;
            if (count > 2) ir_filter_nr = 0;
            if (ir_filter_nr > prev_ir_filter_nr + 1) ir_filter_nr--;
        } else if (ir_filter_nr < 2) {
            ir_filter_nr++;
        }
        if (fixed_gain_ < 5.0) ir_filter_nr = 2;

        if (cur_frame_mode != MODE_7k4 && cur_frame_mode < MODE_10k2 && ir_filter_nr < 2) {
            const float* lookup[2] = {ir_filter_strong, ir_filter_medium};
            const float* lookup_7k95[2] = {ir_filter_strong_MODE_7k95, ir_filter_medium};
            apply_ir_filter(out, fixed_sparse,
                            (cur_frame_mode == MODE_7k95 ? lookup_7k95 : lookup)[ir_filter_nr]);
            fixed_vector_ = out;
        }
        prev_ir_filter_nr = ir_filter_nr;
        prev_sparse_fixed_gain = fixed_gain_;
        return fixed_vector_;
    }

    int synthesis(const float* lpc_, float fixed_gain_, const float* fixed_vector_, float* samples,
                  uint8_t overflow) {
        float excitation_[AMR_SUBFRAME_SIZE];
        if (overflow)
            for (int i = 0; i < AMR_SUBFRAME_SIZE; i++) pitch_vector[i] *= 0.25;
        weighted_vector_sumf(excitation_, pitch_vector, fixed_vector_, pitch_gain[4], fixed_gain_,
                             AMR_SUBFRAME_SIZE);
        if (pitch_gain[4] > 0.5 && !overflow) {
            float energy = scalarproduct_float(excitation_, excitation_, AMR_SUBFRAME_SIZE);
            float pitch_factor =
                pitch_gain[4] *
                (cur_frame_mode == MODE_12k2
                     ? 0.25 * (pitch_gain[4] < 1.0 ? (double)pitch_gain[4] : 1.0)
                     : 0.5 * (pitch_gain[4] < SHARP_MAX ? (double)pitch_gain[4] : SHARP_MAX));
            for (int i = 0; i < AMR_SUBFRAME_SIZE; i++)
                excitation_[i] += pitch_factor * pitch_vector[i];
            scale_vector_to_given_sum_of_squares(excitation_, excitation_, energy,
                                                 AMR_SUBFRAME_SIZE);
        }
        lp_synthesis_filterf(samples, lpc_, excitation_, AMR_SUBFRAME_SIZE, LP_FILTER_ORDER);
        for (int i = 0; i < AMR_SUBFRAME_SIZE; i++)
            if (fabsf(samples[i]) > AMR_SAMPLE_BOUND) return 1;
        return 0;
    }

    float tilt_factor(const float* lpc_n, const float* lpc_d) {
        float rh0, rh1;
        float impulse_buffer[LP_FILTER_ORDER + AMR_TILT_RESPONSE] = {0};
        float* hf = impulse_buffer + LP_FILTER_ORDER;
        hf[0] = 1.0;
        memcpy(hf + 1, lpc_n, sizeof(float) * LP_FILTER_ORDER);
        lp_synthesis_filterf(hf, lpc_d, hf, AMR_TILT_RESPONSE, LP_FILTER_ORDER);
        rh0 = scalarproduct_float(hf, hf, AMR_TILT_RESPONSE);
        rh1 = scalarproduct_float(hf, hf + 1, AMR_TILT_RESPONSE - 1);
        return rh1 >= 0.0 ? rh1 / rh0 * AMR_TILT_GAMMA_T : 0.0;
    }

    void postfilter(const float* lpc_, float* buf_out) {
        float* samples = samples_in + LP_FILTER_ORDER;
        float speech_gain = scalarproduct_float(samples, samples, AMR_SUBFRAME_SIZE);
        float pole_out[AMR_SUBFRAME_SIZE + LP_FILTER_ORDER];
        const float *gamma_n, *gamma_d;
        float lpc_n[LP_FILTER_ORDER], lpc_d[LP_FILTER_ORDER];
        if (cur_frame_mode == MODE_12k2 || cur_frame_mode == MODE_10k2) {
            gamma_n = ff_pow_0_7;
            gamma_d = ff_pow_0_75;
        } else {
            gamma_n = ff_pow_0_55;
            gamma_d = ff_pow_0_7;
        }
        for (int i = 0; i < LP_FILTER_ORDER; i++) {
            lpc_n[i] = lpc_[i] * gamma_n[i];
            lpc_d[i] = lpc_[i] * gamma_d[i];
        }
        memcpy(pole_out, postfilter_mem, sizeof(float) * LP_FILTER_ORDER);
        lp_synthesis_filterf(pole_out + LP_FILTER_ORDER, lpc_d, samples, AMR_SUBFRAME_SIZE,
                             LP_FILTER_ORDER);
        memcpy(postfilter_mem, pole_out + AMR_SUBFRAME_SIZE, sizeof(float) * LP_FILTER_ORDER);
        lp_zero_synthesis_filterf(buf_out, lpc_n, pole_out + LP_FILTER_ORDER, AMR_SUBFRAME_SIZE,
                                  LP_FILTER_ORDER);
        tilt_compensation(&tilt_mem, tilt_factor(lpc_n, lpc_d), buf_out, AMR_SUBFRAME_SIZE);
        adaptive_gain_control(buf_out, buf_out, speech_gain, AMR_SUBFRAME_SIZE, AMR_AGC_ALPHA,
                              &postfilter_agc);
    }

    void update_state() {
        memcpy(prev_lsp_sub4, lsp[3], LP_FILTER_ORDER * sizeof(lsp[3][0]));
        memmove(&excitation_buf[0], &excitation_buf[AMR_SUBFRAME_SIZE],
                (PITCH_DELAY_MAX + LP_FILTER_ORDER + 1) * sizeof(float));
        memmove(&pitch_gain[0], &pitch_gain[1], 4 * sizeof(float));
        memmove(&fixed_gain[0], &fixed_gain[1], 4 * sizeof(float));
        memmove(&samples_in[0], &samples_in[AMR_SUBFRAME_SIZE], LP_FILTER_ORDER * sizeof(float));
    }

    // libavcodec's amrnb_decode_frame for one channel: 160 samples, or 0
    // where it refuses the frame (no data, SID, a zero pitch lag)
    int decode(const uint8_t* buf, long buf_size, float* buf_out) {
        if (buf_size < 1) return 0;
        int mode = (buf[0] >> 3) & 0x0F;
        if (mode >= N_MODES || buf_size < frame_sizes_nb[mode] + 1) return 0;
        if (mode == MODE_DTX) {
            cur_frame_mode = mode;
            return 0;
        }
        bit_reorder(frame, buf + 1, order_table(mode));
        cur_frame_mode = mode;

        if (mode == MODE_12k2)
            lsf2lsp_5();
        else
            lsf2lsp_3();
        for (int i = 0; i < 4; i++) lspd2lpc(lsp[i], lpc[i], 5);

        AMRFixed fixed_sparse = {};
        float spare_vector[AMR_SUBFRAME_SIZE];
        for (int subframe = 0; subframe < 4; subframe++) {
            Subframe s = sub(subframe);
            float fixed_gain_factor;
            decode_pitch_vector(s, subframe);
            decode_fixed_sparse(&fixed_sparse, s.pulses(), mode, subframe);
            decode_gains(s, mode, subframe, &fixed_gain_factor);
            pitch_sharpening(subframe, mode, &fixed_sparse);
            if (fixed_sparse.pitch_lag == 0) return 0;
            set_fixed_vector(fixed_vector, &fixed_sparse, 1.0, AMR_SUBFRAME_SIZE);
            fixed_gain[4] = amr_set_fixed_gain(
                fixed_gain_factor,
                scalarproduct_float(fixed_vector, fixed_vector, AMR_SUBFRAME_SIZE) /
                    AMR_SUBFRAME_SIZE,
                prediction_error, energy_mean[mode], energy_pred_fac);
            for (int i = 0; i < AMR_SUBFRAME_SIZE; i++) excitation[i] *= pitch_gain[4];
            set_fixed_vector(excitation, &fixed_sparse, fixed_gain[4], AMR_SUBFRAME_SIZE);
            for (int i = 0; i < AMR_SUBFRAME_SIZE; i++) excitation[i] = truncf(excitation[i]);

            float synth_fixed_gain = fixed_gain_smooth(lsf_q[subframe], lsf_avg, mode);
            const float* synth_fixed_vector =
                anti_sparseness(&fixed_sparse, fixed_vector, synth_fixed_gain, spare_vector);
            if (synthesis(lpc[subframe], synth_fixed_gain, synth_fixed_vector,
                          &samples_in[LP_FILTER_ORDER], 0))
                // overflow: synthesize again with the pitch vector scaled down
                synthesis(lpc[subframe], synth_fixed_gain, synth_fixed_vector,
                          &samples_in[LP_FILTER_ORDER], 1);
            postfilter(lpc[subframe], buf_out + subframe * AMR_SUBFRAME_SIZE);
            clear_fixed_vector(fixed_vector, &fixed_sparse, AMR_SUBFRAME_SIZE);
            update_state();
        }
        apply_order_2_transfer_function(buf_out, buf_out, highpass_zeros, highpass_poles,
                                        highpass_scale[0], high_pass_mem, AMR_BLOCK_SIZE);
        weighted_vector_sumf(lsf_avg, lsf_avg, lsf_q[3], 0.84, 0.16, LP_FILTER_ORDER);
        return AMR_BLOCK_SIZE;
    }
};

}  // namespace

extern "C" {

void* skt_amrnb_new() {
    auto* d = new Decoder();
    d->reset();
    return d;
}

void skt_amrnb_free(void* h) { delete (Decoder*)h; }

void skt_amrnb_reset(void* h) { ((Decoder*)h)->reset(); }

// Decode one frame (its TOC byte and payload) into `out` (room for 160
// floats). Returns the samples written: 160, or 0 for a frame libavcodec
// refuses.
int skt_amrnb_decode_frame(void* h, const uint8_t* frame, long nbytes, float* out) {
    return ((Decoder*)h)->decode(frame, nbytes, out);
}

}  // extern "C"
