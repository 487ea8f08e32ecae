// SILK (RFC 6716 §4.2) host decode stage: range decoder + NLSF/LTP/
// gain/excitation parse + LTP/LPC synthesis at the SILK internal
// rate, a C++ port of the owned Python decoder (codecs/opus_silk.py)
// for the serving loop — the LP layer is per-sample sequential IIR
// work that belongs on the host.  The caller (codecs/silk_native.py)
// keeps the oracle-matched 48 kHz resampler and the redundancy/
// transition machinery in Python; for hybrid frames the final range-
// coder state is exported so the CELT layer can continue from it.
// Parity reference: soundkit-opus/src/lib.rs (libopus wrapper).
//
// Spec tables are pushed from Python (the extracted RFC set in
// opus_tables.py) via skt_silk_table — nothing is hardcoded here
// beyond structure.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <map>
#include <string>
#include <vector>

namespace {

constexpr int LTP_ORDER = 5;
constexpr int SILK_HISTORY = 322;
constexpr int SILK_MAX_LAG = 288 + LTP_ORDER / 2;

inline int ilogi(uint64_t v) { return v ? 64 - __builtin_clzll(v) : 0; }
inline int32_t wrap32(int64_t x) {
  return (int32_t)(uint32_t)(x & 0xFFFFFFFFll);
}
inline int32_t mulh32(int64_t a, int64_t b) { return wrap32((a * b) >> 32); }
inline int32_t round_mull(int64_t a, int64_t b, int s) {
  return wrap32((((a * b) >> (s - 1)) + 1) >> 1);
}
inline int64_t sat32(int64_t x) {
  return x < -0x80000000ll ? -0x80000000ll
                           : (x > 0x7FFFFFFFll ? 0x7FFFFFFFll : x);
}

// ---------------------------------------------------------------- tables
struct Tables {
  std::map<std::string, std::vector<int64_t>> raw;
  // resolved views (names mirror opus_tables.py keys minus "silk_")
  const int64_t *stereo_s1, *stereo_s2, *stereo_s3, *mid_only;
  const int64_t *ft_inactive, *ft_active;
  const int64_t *gain_high;  // [3][9]
  const int64_t *gain_low, *gain_delta;
  const int64_t *lsf_s1;     // [2][2][33]
  const int64_t *lsf_s2;     // [32][10]
  const int64_t *lsf_s2_ext, *lsf_interp;
  const int64_t *pitch_high, *pitch_low_nb, *pitch_low_mb, *pitch_low_wb;
  const int64_t *pitch_delta;
  const int64_t *contour_nb10, *contour_nb20, *contour_mw10, *contour_mw20;
  const int64_t *ltp_filter, *ltp_sel0, *ltp_sel1, *ltp_sel2;
  const int64_t *ltp_scale_idx, *lcg_seed_m;
  const int64_t *exc_rate;      // [2][10]
  const int64_t *pulse_count;   // [11][19]
  const int64_t *pulse_loc;     // [4][168]
  const int64_t *exc_lsb;
  const int64_t *exc_sign;      // [3][2][7][3]
  const int64_t *lbrr40, *lbrr60;
  const int64_t *s2_sel_nbmb, *s2_sel_wb;        // [32][10] / [32][16]
  const int64_t *predw_nbmb, *predw_wb;          // [2][9] / [2][15]
  const int64_t *wsel_nbmb, *wsel_wb;            // [32][9] / [32][15]
  const int64_t *cb_nbmb, *cb_wb;                // [32][10] / [32][16]
  const int64_t *minsp_nbmb, *minsp_wb;          // [11] / [17]
  const int64_t *order_nbmb, *order_wb;          // [10] / [16]
  const int64_t *cosine;                         // [129]
  const int64_t *pitch_scale, *pitch_min, *pitch_max;  // [3]
  const int64_t *off_nb10, *off_nb20, *off_mw10, *off_mw20;
  int n_off_nb10, n_off_mw10;  // contour row counts for 10 ms tables
  const int64_t *taps0, *taps1, *taps2;          // [8/16/32][5]
  const int64_t *ltp_scale_f;                    // [3]
  const int64_t *shell_blocks;                   // [3][2]
  const int64_t *quant_offset;                   // [2][2]
  const int64_t *stereo_w;                       // [16]
  const int64_t *stereo_interp_len;              // [3]
  bool ready = false;

  const int64_t* get(const char* n, size_t minlen) {
    auto it = raw.find(n);
    if (it == raw.end() || it->second.size() < minlen) return nullptr;
    return it->second.data();
  }
  bool finalize() {
    struct Req { const int64_t** dst; const char* name; size_t n; };
    const Req reqs[] = {
      {&stereo_s1, "model_stereo_s1", 26}, {&stereo_s2, "model_stereo_s2", 4},
      {&stereo_s3, "model_stereo_s3", 6}, {&mid_only, "model_mid_only", 3},
      {&ft_inactive, "model_frame_type_inactive", 3},
      {&ft_active, "model_frame_type_active", 5},
      {&gain_high, "model_gain_highbits", 27},
      {&gain_low, "model_gain_lowbits", 9},
      {&gain_delta, "model_gain_delta", 42},
      {&lsf_s1, "model_lsf_s1", 132}, {&lsf_s2, "model_lsf_s2", 320},
      {&lsf_s2_ext, "model_lsf_s2_ext", 3},
      {&lsf_interp, "model_lsf_interpolation_offset", 6},
      {&pitch_high, "model_pitch_highbits", 33},
      {&pitch_low_nb, "model_pitch_lowbits_nb", 5},
      {&pitch_low_mb, "model_pitch_lowbits_mb", 6},
      {&pitch_low_wb, "model_pitch_lowbits_wb", 9},
      {&pitch_delta, "model_pitch_delta", 22},
      {&contour_nb10, "model_pitch_contour_nb10ms", 4},
      {&contour_nb20, "model_pitch_contour_nb20ms", 12},
      {&contour_mw10, "model_pitch_contour_mbwb10ms", 13},
      {&contour_mw20, "model_pitch_contour_mbwb20ms", 35},
      {&ltp_filter, "model_ltp_filter", 4},
      {&ltp_sel0, "model_ltp_filter0_sel", 9},
      {&ltp_sel1, "model_ltp_filter1_sel", 17},
      {&ltp_sel2, "model_ltp_filter2_sel", 33},
      {&ltp_scale_idx, "model_ltp_scale_index", 4},
      {&lcg_seed_m, "model_lcg_seed", 5},
      {&exc_rate, "model_exc_rate", 20},
      {&pulse_count, "model_pulse_count", 11 * 19},
      {&pulse_loc, "model_pulse_location", 4 * 168},
      {&exc_lsb, "model_excitation_lsb", 3},
      {&exc_sign, "model_excitation_sign", 3 * 2 * 7 * 3},
      {&lbrr40, "model_lbrr_flags_40", 5},
      {&lbrr60, "model_lbrr_flags_60", 9},
      {&s2_sel_nbmb, "lsf_s2_model_sel_nbmb", 320},
      {&s2_sel_wb, "lsf_s2_model_sel_wb", 512},
      {&predw_nbmb, "lsf_pred_weights_nbmb", 18},
      {&predw_wb, "lsf_pred_weights_wb", 30},
      {&wsel_nbmb, "lsf_weight_sel_nbmb", 288},
      {&wsel_wb, "lsf_weight_sel_wb", 480},
      {&cb_nbmb, "lsf_codebook_nbmb", 320},
      {&cb_wb, "lsf_codebook_wb", 512},
      {&minsp_nbmb, "lsf_min_spacing_nbmb", 11},
      {&minsp_wb, "lsf_min_spacing_wb", 17},
      {&order_nbmb, "lsf_ordering_nbmb", 10},
      {&order_wb, "lsf_ordering_wb", 16},
      {&cosine, "cosine", 129},
      {&pitch_scale, "pitch_scale", 3}, {&pitch_min, "pitch_min_lag", 3},
      {&pitch_max, "pitch_max_lag", 3},
      {&off_nb10, "pitch_offset_nb10ms", 6},
      {&off_nb20, "pitch_offset_nb20ms", 44},
      {&off_mw10, "pitch_offset_mbwb10ms", 24},
      {&off_mw20, "pitch_offset_mbwb20ms", 136},
      {&taps0, "ltp_filter0_taps", 40}, {&taps1, "ltp_filter1_taps", 80},
      {&taps2, "ltp_filter2_taps", 160},
      {&ltp_scale_f, "ltp_scale_factor", 3},
      {&shell_blocks, "shell_blocks", 6},
      {&quant_offset, "quant_offset", 4},
      {&stereo_w, "stereo_weights", 16},
      {&stereo_interp_len, "stereo_interp_len", 3},
    };
    for (const auto& r : reqs) {
      *r.dst = get(r.name, r.n);
      if (!*r.dst) return false;
    }
    n_off_nb10 = (int)(raw["pitch_offset_nb10ms"].size() / 2);
    n_off_mw10 = (int)(raw["pitch_offset_mbwb10ms"].size() / 2);
    ready = true;
    return true;
  }
};

Tables g_t;

// ------------------------------------------------------ range decoder
// exact port of codecs/opus_rc.py RangeDecoder (shared with CELT)
struct RC {
  const uint8_t* buf;
  int64_t storage, offs, end_offs;
  uint64_t end_window;
  int nend_bits, nbits_total;
  uint32_t rng, val, ext;
  int rem;
  bool error;

  void init(const uint8_t* data, int64_t len) {
    buf = data; storage = len; offs = 0; end_offs = 0;
    end_window = 0; nend_bits = 0;
    nbits_total = 33 - ((32 - 7) / 8) * 8;  // 9
    rng = 1u << 7;
    rem = read_byte();
    val = rng - 1 - (uint32_t)(rem >> 1);
    error = false;
    normalize();
  }
  int read_byte() { return offs < storage ? buf[offs++] : 0; }
  void normalize() {
    while (rng <= (1u << 23)) {
      nbits_total += 8;
      rng <<= 8;
      int sym = rem;
      rem = read_byte();
      sym = ((sym << 8) | rem) >> 1;
      val = ((val << 8) + (0xFF & ~sym)) & ((1u << 31) - 1);
    }
  }
  void update(uint32_t fl, uint32_t fh, uint32_t ft) {
    uint32_t s = ext * (ft - fh);
    val -= s;
    rng = fl > 0 ? ext * (fh - fl) : rng - s;
    normalize();
  }
  int dec_bit_logp(int logp) {
    uint32_t r = rng, d = val, s = r >> logp;
    int ret = d < s ? 1 : 0;
    if (!ret) val = d - s;
    rng = ret ? s : r - s;
    normalize();
    return ret;
  }
  int dec_cdf(const int64_t* cdf) {
    uint32_t total = (uint32_t)cdf[0];
    uint32_t scale = rng / total;
    ext = scale;
    uint32_t m = val / scale + 1;
    uint32_t sym = total - (m < total ? m : total);
    int k = 1;
    while ((uint32_t)cdf[k] <= sym) k++;
    uint32_t high = (uint32_t)cdf[k];
    uint32_t low = k > 1 ? (uint32_t)cdf[k - 1] : 0;
    update(low, high, total);
    return k - 1;
  }
  int tell() const { return nbits_total - ilogi(rng); }
};

// ------------------------------------------------------ decoder state
struct SilkFrame {
  bool coded;
  int log_gain;
  int64_t nlsf[16];
  double lpc[16];
  double output[2 * SILK_HISTORY];
  double lpc_history[2 * SILK_HISTORY];
  int primarylag;
  bool prev_voiced;
  void reset() {
    coded = false; log_gain = 0; primarylag = 0; prev_voiced = false;
    memset(nlsf, 0, sizeof nlsf);
    memset(lpc, 0, sizeof lpc);
    memset(output, 0, sizeof output);
    memset(lpc_history, 0, sizeof lpc_history);
  }
};

struct SilkDec {
  SilkFrame frames[2];
  int nlsf_interp_factor = 4;
  bool wb = false;
  int bandwidth = 0, subframes = 0, sflength = 0, flength = 0;
  double stereo_weights[2] = {0, 0};
  double prev_stereo_weights[2] = {0, 0};
  int midonly = 0;
  int prev_channels = 0;
  void flush() {
    frames[0].reset();
    frames[1].reset();
    stereo_weights[0] = stereo_weights[1] = 0;
    prev_stereo_weights[0] = prev_stereo_weights[1] = 0;
    midonly = 0;
    prev_channels = 0;
    nlsf_interp_factor = 4;
  }
};

// -------------------------------------------------- LSF helper chain
// opus_silk.py _stabilize_lsf
void stabilize_lsf(int64_t* nlsf, int order, const int64_t* spacing) {
  for (int pass = 0; pass < 20; pass++) {
    int64_t min_diff = 0;
    int k = 0;
    for (int i = 0; i < order + 1; i++) {
      int64_t low = i ? nlsf[i - 1] : 0;
      int64_t high = i != order ? nlsf[i] : 32768;
      int64_t diff = (high - low) - spacing[i];
      if (diff < min_diff) { min_diff = diff; k = i; }
    }
    if (min_diff == 0) return;
    if (k == 0) {
      nlsf[0] = spacing[0];
    } else if (k == order) {
      nlsf[order - 1] = 32768 - spacing[order];
    } else {
      int64_t min_center = 0, max_center = 32768;
      for (int i = 0; i < k; i++) min_center += spacing[i];
      min_center += spacing[k] >> 1;
      for (int i = k + 1; i < order + 1; i++) max_center -= spacing[i];
      max_center -= spacing[k] >> 1;
      int64_t cv = nlsf[k - 1] + nlsf[k];
      cv = (cv >> 1) + (cv & 1);
      if (cv < min_center) cv = min_center;
      if (cv > max_center) cv = max_center;
      nlsf[k - 1] = cv - (spacing[k] >> 1);
      nlsf[k] = nlsf[k - 1] + spacing[k];
    }
  }
  // fallback: sort + push apart
  std::vector<int64_t> vals(nlsf, nlsf + order);
  std::sort(vals.begin(), vals.end());
  for (int i = 0; i < order; i++) nlsf[i] = vals[i];
  if (nlsf[0] < spacing[0]) nlsf[0] = spacing[0];
  for (int i = 1; i < order; i++) {
    int64_t lim = nlsf[i - 1] + spacing[i];
    if (lim > 32767) lim = 32767;
    if (nlsf[i] < lim) nlsf[i] = lim;
  }
  if (nlsf[order - 1] > 32768 - spacing[order])
    nlsf[order - 1] = 32768 - spacing[order];
  for (int i = order - 2; i >= 0; i--)
    if (nlsf[i] > nlsf[i + 1] - spacing[i + 1])
      nlsf[i] = nlsf[i + 1] - spacing[i + 1];
}

// opus_silk.py _lsp2poly (wrapping int32 arithmetic by design)
void lsp2poly(const int64_t* lsp, int stride, int64_t* pol, int half) {
  pol[0] = 65536;
  pol[1] = wrap32(-lsp[0]);
  for (int i = 1; i < half; i++) {
    int64_t l = lsp[stride * 2 * i];
    pol[i + 1] = wrap32(wrap32(pol[i - 1] * 2) - round_mull(l, pol[i], 16));
    for (int j = i; j > 1; j--)
      pol[j] = wrap32(pol[j] + pol[j - 2] - round_mull(l, pol[j - 1], 16));
    pol[1] = wrap32(pol[1] - l);
  }
}

// opus_silk.py _is_lpc_stable
bool is_lpc_stable(const int64_t* lpc, int order) {
  int64_t dc_resp = 0;
  for (int i = 0; i < order; i++) dc_resp += lpc[i];
  if (dc_resp > 4095) return false;
  std::vector<int64_t> row(order), nrow(order);
  for (int i = 0; i < order; i++) row[i] = lpc[i] * 4096;  // Q24
  int64_t totalinvgain = 1ll << 30;
  int k = order - 1;
  while (true) {
    if (row[k] > 16773022 || row[k] < -16773022) return false;
    int64_t rc = wrap32(-(row[k] * 128));
    int64_t gaindiv = (1ll << 30) - mulh32(rc, rc);
    totalinvgain = wrap32(((int64_t)mulh32(totalinvgain, gaindiv)) << 2);
    if (k == 0) return totalinvgain >= 107374;
    int fbits = ilogi((uint64_t)gaindiv);
    int sh = fbits + 1 - 16;
    int64_t dv = sh >= 0 ? (gaindiv >> sh) : (gaindiv << -sh);
    if (dv <= 0) return false;
    int64_t gain = ((1ll << 29) - 1) / dv;
    int sh2 = 15 + 16 - fbits;
    int64_t shifted = sh2 >= 0 ? (gaindiv << sh2) : (gaindiv >> -sh2);
    int64_t error =
        wrap32((1ll << 29) - wrap32(((int64_t)wrap32(shifted) * gain) >> 16));
    gain = wrap32(((int64_t)wrap32(gain << 16)) + (wrap32(error * gain) >> 13));
    for (int j = 0; j < k; j++) {
      int64_t x = sat32(row[j] - round_mull(row[k - j - 1], rc, 31));
      int64_t r = (x * gain) >> (fbits - 1);
      r = (r + 1) >> 1;
      if (r != wrap32(r)) return false;
      nrow[j] = r;
    }
    row.swap(nrow);
    k--;
  }
}

// opus_silk.py _lsf2lpc
void lsf2lpc(const int64_t* nlsf, double* lpcf, int order) {
  const int64_t* ordering = order == 16 ? g_t.order_wb : g_t.order_nbmb;
  int64_t lsp[16];
  for (int k = 0; k < order; k++) {
    int index = (int)(nlsf[k] >> 8);
    int64_t offset = nlsf[k] & 255;
    int k2 = (int)ordering[k];
    int64_t v = g_t.cosine[index] * 256;
    v += (g_t.cosine[index + 1] - g_t.cosine[index]) * offset;
    lsp[k2] = (v + 4) >> 3;
  }
  int half = order >> 1;
  int64_t p[9], q[9];
  lsp2poly(lsp, 1, p, half);
  lsp2poly(lsp + 1, 1, q, half);
  int64_t lpc32[16], lpc16[16];
  for (int k = 0; k < half; k++) {
    int64_t p_tmp = wrap32(p[k + 1] + p[k]);
    int64_t q_tmp = wrap32(q[k + 1] - q[k]);
    lpc32[k] = wrap32(-q_tmp - p_tmp);
    lpc32[order - k - 1] = wrap32(q_tmp - p_tmp);
  }
  int it = 0;
  int64_t maxabs = 0;
  for (it = 0; it < 10; it++) {
    maxabs = 0;
    int kmax = 0;
    for (int j = 0; j < order; j++) {
      int64_t x = lpc32[j] < 0 ? -lpc32[j] : lpc32[j];
      if (x > maxabs) { maxabs = x; kmax = j; }
    }
    maxabs = (maxabs + 16) >> 5;  // Q17 -> Q12
    if (maxabs > 32767) {
      if (maxabs > 163838) maxabs = 163838;
      int64_t chirp_base =
          65470 - ((maxabs - 32767) << 14) / ((maxabs * (kmax + 1)) >> 2);
      int64_t chirp = chirp_base;
      for (int k = 0; k < order; k++) {
        lpc32[k] = round_mull(lpc32[k], chirp, 16);
        chirp = (chirp_base * chirp + 32768) >> 16;
      }
    } else {
      break;
    }
  }
  if (it == 9 && maxabs > 32767) it = 10;
  if (it == 10) {
    for (int k = 0; k < order; k++) {
      int64_t x = (lpc32[k] + 16) >> 5;
      if (x < -32768) x = -32768;
      if (x > 32767) x = 32767;
      lpc16[k] = x;
      lpc32[k] = lpc16[k] * 32;
    }
  } else {
    for (int k = 0; k < order; k++) lpc16[k] = (lpc32[k] + 16) >> 5;
  }
  for (int i = 1; i < 17; i++) {
    if (is_lpc_stable(lpc16, order)) break;
    int64_t chirp_base = 65536 - (1ll << i);
    int64_t chirp = chirp_base;
    for (int k = 0; k < order; k++) {
      lpc32[k] = round_mull(lpc32[k], chirp, 16);
      lpc16[k] = (lpc32[k] + 16) >> 5;
      chirp = (chirp_base * chirp + 32768) >> 16;
    }
  }
  for (int i = 0; i < order; i++) lpcf[i] = (double)lpc16[i] / 4096.0;
}

// ------------------------------------------------------ frame decode
struct LpcOut {
  double leadin[16];
  double lpc[16];
  bool has_leadin;
};

// opus_silk.py _decode_lpc
void decode_lpc(SilkDec& s, RC& rc, SilkFrame& frame, int order, bool voiced,
                LpcOut& out) {
  bool wb = s.wb;
  int lsf_i1 =
      rc.dec_cdf(g_t.lsf_s1 + ((wb ? 1 : 0) * 2 + (voiced ? 1 : 0)) * 33);
  const int64_t* sel =
      (wb ? g_t.s2_sel_wb + lsf_i1 * 16 : g_t.s2_sel_nbmb + lsf_i1 * 10);
  int64_t lsf_i2[16];
  for (int i = 0; i < order; i++) {
    lsf_i2[i] = rc.dec_cdf(g_t.lsf_s2 + sel[i] * 10) - 4;
    if (lsf_i2[i] == -4)
      lsf_i2[i] -= rc.dec_cdf(g_t.lsf_s2_ext);
    else if (lsf_i2[i] == 4)
      lsf_i2[i] += rc.dec_cdf(g_t.lsf_s2_ext);
  }
  int64_t qstep = wb ? 9830 : 11796;
  const int64_t* wsel =
      (wb ? g_t.wsel_wb + lsf_i1 * 15 : g_t.wsel_nbmb + lsf_i1 * 9);
  const int64_t* pred = wb ? g_t.predw_wb : g_t.predw_nbmb;
  int predw = wb ? 15 : 9;
  int64_t res[16];
  for (int i = order - 1; i >= 0; i--) {
    int64_t v = lsf_i2[i] * 1024;
    if (lsf_i2[i] < 0) v += 102;
    else if (lsf_i2[i] > 0) v -= 102;
    v = (v * qstep) >> 16;
    if (i + 1 < order) v += (res[i + 1] * pred[wsel[i] * predw + i]) >> 8;
    res[i] = v;
  }
  const int64_t* codebook =
      (wb ? g_t.cb_wb + lsf_i1 * 16 : g_t.cb_nbmb + lsf_i1 * 10);
  int64_t nlsf[16];
  for (int i = 0; i < order; i++) {
    int64_t cur = codebook[i];
    int64_t prev = i ? codebook[i - 1] : 0;
    int64_t nxt = i + 1 < order ? codebook[i + 1] : 256;
    int64_t weight_sq = (1024 / (cur - prev) + 1024 / (nxt - cur)) << 16;
    int ipart = ilogi((uint64_t)weight_sq);
    int64_t fpart = (weight_sq >> (ipart - 8)) & 127;
    int64_t y = ((ipart & 1) ? 32768 : 46214) >> ((32 - ipart) >> 1);
    int64_t weight = y + ((213 * fpart * y) >> 16);
    int64_t num = res[i] * 16384;
    int64_t value = cur * 128 + num / weight;  // C truncation, as mandated
    if (value < 0) value = 0;
    if (value > 32767) value = 32767;
    nlsf[i] = value;
  }
  const int64_t* spacing = wb ? g_t.minsp_wb : g_t.minsp_nbmb;
  stabilize_lsf(nlsf, order, spacing);

  memset(out.leadin, 0, sizeof out.leadin);
  memset(out.lpc, 0, sizeof out.lpc);
  out.has_leadin = false;
  if (s.subframes == 4) {
    int offset = rc.dec_cdf(g_t.lsf_interp);
    if (offset != 4 && frame.coded) {
      out.has_leadin = true;
      if (offset != 0) {
        int64_t nlsf_leadin[16];
        for (int i = 0; i < order; i++)
          nlsf_leadin[i] =
              frame.nlsf[i] + (((nlsf[i] - frame.nlsf[i]) * offset) >> 2);
        lsf2lpc(nlsf_leadin, out.leadin, order);
      } else {
        memcpy(out.leadin, frame.lpc, sizeof out.leadin);
      }
    } else {
      offset = 4;
    }
    s.nlsf_interp_factor = offset;
    lsf2lpc(nlsf, out.lpc, order);
  } else {
    s.nlsf_interp_factor = 4;
    lsf2lpc(nlsf, out.lpc, order);
  }
  for (int i = 0; i < order; i++) frame.nlsf[i] = nlsf[i];
  memcpy(frame.lpc, out.lpc, sizeof frame.lpc);
}

// opus_silk.py _decode_excitation
void decode_excitation(SilkDec& s, RC& rc, int qoffset_high, int active,
                       int voiced, double* out /* [flength] */) {
  uint32_t seed = (uint32_t)rc.dec_cdf(g_t.lcg_seed_m);
  int shellblocks =
      (int)g_t.shell_blocks[s.bandwidth * 2 + (s.subframes >> 2)];
  int ratelevel = rc.dec_cdf(g_t.exc_rate + voiced * 10);

  std::vector<int64_t> pulsecount(shellblocks), lsbcount(shellblocks, 0);
  for (int i = 0; i < shellblocks; i++) {
    int p = rc.dec_cdf(g_t.pulse_count + ratelevel * 19);
    if (p == 17) {
      int lsb = 0;
      while (p == 17) {
        lsb += 1;
        if (lsb == 10) break;
        p = rc.dec_cdf(g_t.pulse_count + 9 * 19);
      }
      if (lsb == 10) p = rc.dec_cdf(g_t.pulse_count + 10 * 19);
      lsbcount[i] = lsb;
    }
    pulsecount[i] = p;
  }

  auto count_children = [&](int model, int total, int* a, int* b) {
    if (total == 0) { *a = 0; *b = 0; return; }
    int off = ((total - 1 + 5) * (total - 1)) >> 1;
    *a = rc.dec_cdf(g_t.pulse_loc + model * 168 + off);
    *b = total - *a;
  };

  std::vector<int64_t> exc(shellblocks * 16, 0);
  for (int i = 0; i < shellblocks; i++) {
    if (pulsecount[i] == 0) continue;
    int64_t* loc = exc.data() + 16 * i;
    int b1[2];
    count_children(0, (int)pulsecount[i], &b1[0], &b1[1]);
    for (int bi = 0; bi < 2; bi++) {
      int b2[2];
      count_children(1, b1[bi], &b2[0], &b2[1]);
      for (int ci = 0; ci < 2; ci++) {
        int b3[2];
        count_children(2, b2[ci], &b3[0], &b3[1]);
        for (int di = 0; di < 2; di++) {
          int d1, d2;
          count_children(3, b3[di], &d1, &d2);
          int k = bi * 8 + ci * 4 + di * 2;
          loc[k] = d1;
          loc[k + 1] = d2;
        }
      }
    }
  }

  for (int i = 0; i < shellblocks * 16; i++)
    for (int64_t b = 0; b < lsbcount[i >> 4]; b++)
      exc[i] = (exc[i] << 1) | rc.dec_cdf(g_t.exc_lsb);

  for (int i = 0; i < shellblocks * 16; i++) {
    if (exc[i] != 0) {
      int pc = (int)pulsecount[i >> 4];
      if (pc > 6) pc = 6;
      const int64_t* m =
          g_t.exc_sign + (((active + voiced) * 2 + qoffset_high) * 7 + pc) * 3;
      if (rc.dec_cdf(m) == 0) exc[i] = -exc[i];
    }
  }

  int64_t qoff = g_t.quant_offset[voiced * 2 + qoffset_high];
  for (int i = 0; i < shellblocks * 16; i++) {
    int64_t value = exc[i];
    int64_t e = wrap32((value * 256) | qoff);
    if (value < 0) e += 20;
    else if (value > 0) e -= 20;
    seed = 196314165u * seed + 907633515u;
    if (seed & 0x80000000u) e = -e;
    seed = seed + (uint32_t)value;
    if (i < s.flength) out[i] = (double)e / 8388608.0;
  }
  for (int i = shellblocks * 16; i < s.flength; i++) out[i] = 0.0;
}

// Per-channel synthesis parameters for the device LTP/LPC split
// (ops/silk_batch.py): everything decode_frame's synthesis block
// consumes, so the [B]-lane device scan can reproduce it exactly.
struct SynthParams {
  double exc[320];
  double gains[4];
  double leadin[16], lpc[16];
  int has_leadin;
  int voiced;
  int64_t pitchlag[4];
  double ltptaps[4][LTP_ORDER];
  double ltpscale;
  int coded;  // this channel carried a frame this superframe
};

// opus_silk.py _decode_frame (incl. the LBRR condCoding + parse-state
// rules validated against libopus this round).  With ``sp`` set the
// synthesis block is skipped and its inputs are exported instead —
// all parse-visible state (log_gain, nlsf, lpc, primarylag,
// prev_voiced) still advances, exactly like the LBRR parse-only path.
void decode_frame(SilkDec& s, RC& rc, int channel, int coded_channels,
                  bool active, int frame_num, int active1, bool lbrr,
                  int independent, SynthParams* sp = nullptr) {
  SilkFrame& frame = s.frames[channel];
  int order = s.wb ? 16 : 10;
  int sfl = s.sflength;

  if (coded_channels == 2 && channel == 0) {
    int n = rc.dec_cdf(g_t.stereo_s1);
    int wi0 = rc.dec_cdf(g_t.stereo_s2) + 3 * (n / 5);
    int ws0 = rc.dec_cdf(g_t.stereo_s3);
    int wi1 = rc.dec_cdf(g_t.stereo_s2) + 3 * (n % 5);
    int ws1 = rc.dec_cdf(g_t.stereo_s3);
    int64_t w[2];
    const int wis[2] = {wi0, wi1};
    const int wss[2] = {ws0, ws1};
    for (int k = 0; k < 2; k++) {
      int64_t lo = g_t.stereo_w[wis[k]];
      int64_t hi = g_t.stereo_w[wis[k] + 1];
      w[k] = lo + (((hi - lo) * 6554) >> 16) * (wss[k] * 2 + 1);
    }
    s.stereo_weights[0] = (double)(w[0] - w[1]) / 8192.0;
    s.stereo_weights[1] = (double)w[1] / 8192.0;
    s.midonly = active1 == 0 ? rc.dec_cdf(g_t.mid_only) : 0;
  }

  int qoffset_high, sigtype;
  bool voiced;
  if (active) {
    int ftype = rc.dec_cdf(g_t.ft_active);
    qoffset_high = ftype & 1;
    voiced = (ftype >> 1) != 0;
    sigtype = voiced ? 2 : 1;
  } else {
    int ftype = rc.dec_cdf(g_t.ft_inactive);
    qoffset_high = ftype & 1;
    voiced = false;
    sigtype = 0;
  }

  double gains[4];
  int log_gain = frame.log_gain;
  for (int i = 0; i < s.subframes; i++) {
    if (i == 0 && (independent || !frame.coded)) {
      int x = rc.dec_cdf(g_t.gain_high + sigtype * 9);
      log_gain = (x << 3) | rc.dec_cdf(g_t.gain_low);
      if (frame.coded && log_gain < frame.log_gain - 16)
        log_gain = frame.log_gain - 16;
    } else {
      int delta = rc.dec_cdf(g_t.gain_delta);
      int a = 2 * delta - 16;
      int b = log_gain + delta - 4;
      log_gain = a > b ? a : b;
      if (log_gain < 0) log_gain = 0;
      if (log_gain > 63) log_gain = 63;
    }
    frame.log_gain = log_gain;
    int64_t lg = (((int64_t)log_gain * 0x1D1C71) >> 16) + 2090;
    int ipart = (int)(lg >> 7);
    int64_t fpart = lg & 127;
    int64_t lingain =
        (1ll << ipart) +
        ((((-174 * fpart * (128 - fpart)) >> 16) + fpart) *
         ((1ll << ipart) >> 7));
    gains[i] = (double)lingain / 65536.0;
  }

  LpcOut lo;
  decode_lpc(s, rc, frame, order, voiced, lo);

  int64_t pitchlag[4] = {0, 0, 0, 0};
  double ltptaps[4][LTP_ORDER];
  memset(ltptaps, 0, sizeof ltptaps);
  double ltpscale = 15565.0 / 16384.0;
  if (voiced) {
    bool lag_absolute = independent || !frame.prev_voiced;
    int primarylag = 0;
    if (!lag_absolute) {
      int delta = rc.dec_cdf(g_t.pitch_delta);
      if (delta)
        primarylag = frame.primarylag + delta - 9;
      else
        lag_absolute = true;
    }
    if (lag_absolute) {
      const int64_t* low_model =
          (s.bandwidth == 0 ? g_t.pitch_low_nb
                            : (s.bandwidth == 1 ? g_t.pitch_low_mb
                                                : g_t.pitch_low_wb));
      int highbits = rc.dec_cdf(g_t.pitch_high);
      int lowbits = rc.dec_cdf(low_model);
      primarylag = (int)(g_t.pitch_min[s.bandwidth] +
                         highbits * g_t.pitch_scale[s.bandwidth] + lowbits);
    }
    frame.primarylag = primarylag;
    const int64_t* offsets;
    if (s.subframes == 2) {
      if (s.bandwidth == 0)
        offsets = g_t.off_nb10 + rc.dec_cdf(g_t.contour_nb10) * 2;
      else
        offsets = g_t.off_mw10 + rc.dec_cdf(g_t.contour_mw10) * 2;
    } else {
      if (s.bandwidth == 0)
        offsets = g_t.off_nb20 + rc.dec_cdf(g_t.contour_nb20) * 4;
      else
        offsets = g_t.off_mw20 + rc.dec_cdf(g_t.contour_mw20) * 4;
    }
    int64_t lomin = g_t.pitch_min[s.bandwidth];
    int64_t himax = g_t.pitch_max[s.bandwidth];
    for (int i = 0; i < s.subframes; i++) {
      int64_t v = primarylag + offsets[i];
      if (v < lomin) v = lomin;
      if (v > himax) v = himax;
      pitchlag[i] = v;
    }
    const int64_t* fsel[3] = {g_t.ltp_sel0, g_t.ltp_sel1, g_t.ltp_sel2};
    const int64_t* ftaps[3] = {g_t.taps0, g_t.taps1, g_t.taps2};
    int ltpfilter = rc.dec_cdf(g_t.ltp_filter);
    for (int i = 0; i < s.subframes; i++) {
      int index = rc.dec_cdf(fsel[ltpfilter]);
      for (int k = 0; k < LTP_ORDER; k++)
        ltptaps[i][k] =
            (double)ftaps[ltpfilter][index * LTP_ORDER + k] / 128.0;
    }
    if (independent)
      ltpscale =
          (double)g_t.ltp_scale_f[rc.dec_cdf(g_t.ltp_scale_idx)] / 16384.0;
  }

  int flength = s.flength;
  double excitation[320];
  decode_excitation(s, rc, qoffset_high, active ? 1 : 0, voiced ? 1 : 0,
                    excitation);

  if (lbrr) {
    // parse-only: synthesis + output history skipped, all parse-
    // visible state persists (libopus decode_indices semantics)
    frame.prev_voiced = voiced;
    frame.coded = true;
    return;
  }
  if (sp) {
    // device-synthesis split: export the synthesis inputs, advance
    // the parse state, leave output/lpc history to the device
    memcpy(sp->exc, excitation, sizeof(double) * flength);
    for (int i = flength; i < 320; i++) sp->exc[i] = 0.0;
    memcpy(sp->gains, gains, sizeof gains);
    memcpy(sp->leadin, lo.leadin, sizeof lo.leadin);
    memcpy(sp->lpc, lo.lpc, sizeof lo.lpc);
    sp->has_leadin = lo.has_leadin ? 1 : 0;
    sp->voiced = voiced ? 1 : 0;
    memcpy(sp->pitchlag, pitchlag, sizeof pitchlag);
    memcpy(sp->ltptaps, ltptaps, sizeof ltptaps);
    sp->ltpscale = ltpscale;
    sp->coded = 1;
    frame.prev_voiced = voiced;
    frame.coded = true;
    return;
  }

  double residual[SILK_MAX_LAG + 320];
  memset(residual, 0, sizeof(double) * SILK_MAX_LAG);
  memcpy(residual + SILK_MAX_LAG, excitation, sizeof(double) * flength);
  double* dst = frame.output;
  double* lpch = frame.lpc_history;
  const int base = SILK_HISTORY;
  for (int i = 0; i < s.subframes; i++) {
    const double* coeff = (i < 2 && lo.has_leadin) ? lo.leadin : lo.lpc;
    int r0 = SILK_MAX_LAG + i * sfl;
    int d0 = base + i * sfl;
    if (voiced) {
      int out_end;
      double rescale;
      if (i < 2 || s.nlsf_interp_factor == 4) {
        out_end = -i * sfl;
        rescale = ltpscale;
      } else {
        out_end = -(i - 2) * sfl;
        rescale = 1.0;
      }
      int start = -(int)pitchlag[i] - LTP_ORDER / 2;
      for (int j = start; j < out_end; j++) {
        double v = dst[d0 + j];
        for (int k = 0; k < (s.wb ? 16 : 10); k++)
          v -= coeff[k] * dst[d0 + j - 1 - k];
        if (v < -1.0) v = -1.0;
        if (v > 1.0) v = 1.0;
        residual[r0 + j] = v * rescale / gains[i];
      }
      if (out_end) {
        double rescale2 = gains[i - 1] / gains[i];
        for (int j = out_end; j < 0; j++) residual[r0 + j] *= rescale2;
      }
      int lag = (int)pitchlag[i];
      for (int j = 0; j < sfl; j++) {
        double v = residual[r0 + j];
        int off = r0 + j - lag + LTP_ORDER / 2;
        for (int k = 0; k < LTP_ORDER; k++)
          v += ltptaps[i][k] * residual[off - k];
        residual[r0 + j] = v;
      }
    }
    double g = gains[i];
    int ord = s.wb ? 16 : 10;
    for (int j = 0; j < sfl; j++) {
      double v = residual[r0 + j] * g;
      for (int k = 0; k < ord; k++) v += coeff[k] * lpch[d0 + j - 1 - k];
      lpch[d0 + j] = v;
      dst[d0 + j] = v < -1.0 ? -1.0 : (v > 1.0 ? 1.0 : v);
    }
  }
  frame.prev_voiced = voiced;
  memmove(frame.lpc_history, frame.lpc_history + flength,
          sizeof(double) * SILK_HISTORY);
  memmove(frame.output, frame.output + flength,
          sizeof(double) * SILK_HISTORY);
  frame.coded = true;
}

// opus_silk.py _unmix
void unmix(SilkDec& s, int flen, double* out /* [flen][2] */) {
  int base = SILK_HISTORY - flen - 2;
  const double* mid = s.frames[0].output + base;
  const double* side = s.frames[1].output + base;
  int n1 = (int)g_t.stereo_interp_len[s.bandwidth];
  double w0p = s.prev_stereo_weights[0], w1p = s.prev_stereo_weights[1];
  double w0 = s.stereo_weights[0], w1 = s.stereo_weights[1];
  for (int c = 0; c < flen; c++) {
    double i0 = c < n1 ? w0p + c * (w0 - w0p) / n1 : w0;
    double i1 = c < n1 ? w1p + c * (w1 - w1p) / n1 : w1;
    double p0 = 0.25 * (mid[c] + 2.0 * mid[c + 1] + mid[c + 2]);
    double m1 = mid[c + 1];
    double s1 = side[c + 1];
    double left = (1.0 + i1) * m1 + s1 + i0 * p0;
    double right = (1.0 - i1) * m1 - s1 - i0 * p0;
    out[c * 2] = left < -1.0 ? -1.0 : (left > 1.0 ? 1.0 : left);
    out[c * 2 + 1] = right < -1.0 ? -1.0 : (right > 1.0 ? 1.0 : right);
  }
  s.prev_stereo_weights[0] = s.stereo_weights[0];
  s.prev_stereo_weights[1] = s.stereo_weights[1];
}

// opus_silk.py decode_superframe
long decode_superframe(SilkDec& s, RC& rc, int bandwidth, int coded_channels,
                       int duration_ms, double* out) {
  int nb_frames = 1 + (duration_ms > 20) + (duration_ms > 40);
  s.subframes = duration_ms / nb_frames / 5;
  s.sflength = 20 * (bandwidth + 2);
  s.flength = s.sflength * s.subframes;
  s.bandwidth = bandwidth;
  s.wb = bandwidth == 2;
  if (s.prev_channels < coded_channels) s.frames[1].reset();
  s.prev_channels = coded_channels;

  bool active[2][3];
  bool redundancy[2] = {false, false};
  for (int c = 0; c < coded_channels; c++) {
    for (int j = 0; j < nb_frames; j++)
      active[c][j] = rc.dec_bit_logp(1) != 0;
    redundancy[c] = rc.dec_bit_logp(1) != 0;
  }
  bool lbrr[2][3];
  memset(lbrr, 0, sizeof lbrr);
  for (int c = 0; c < coded_channels; c++) {
    if (redundancy[c]) {
      if (nb_frames == 1) {
        lbrr[c][0] = true;
      } else {
        // leading-0 cdf entry: dec_cdf returns the 1-based pattern
        int flags = rc.dec_cdf(nb_frames == 2 ? g_t.lbrr40 : g_t.lbrr60);
        for (int j = 0; j < nb_frames; j++)
          lbrr[c][j] = ((flags >> j) & 1) != 0;
      }
    }
  }
  for (int j = 0; j < nb_frames; j++) {
    for (int c = 0; c < coded_channels; c++) {
      if (lbrr[c][j]) {
        bool side_lbrr = coded_channels == 2 && lbrr[1][j];
        int active1 = (c == 0 && !side_lbrr) ? 0 : 1;
        int ind = !(j > 0 && lbrr[c][j - 1]);
        decode_frame(s, rc, c, coded_channels, true, j, active1, true, ind);
      }
    }
    s.midonly = 0;
  }
  int flen = s.flength;
  for (int j = 0; j < nb_frames; j++) {
    for (int c = 0; c < coded_channels; c++) {
      if (c == 1 && s.midonly) {
        if (s.frames[1].coded) s.frames[1].reset();
        break;
      }
      int act1 = coded_channels == 2 ? (active[1][j] ? 1 : 0) : 1;
      decode_frame(s, rc, c, coded_channels, active[c][j], j, act1, false,
                   j == 0);
    }
    double* dst = out + (long)j * flen * coded_channels;
    if (coded_channels == 2) {
      unmix(s, flen, dst);
    } else {
      int base = SILK_HISTORY - flen - 2;
      const double* src = s.frames[0].output + base;
      for (int k = 0; k < flen; k++) dst[k] = src[k];
    }
    s.midonly = 0;
  }
  return (long)nb_frames * flen;
}

// opus_silk.py decode_superframe, parse-export variant for the
// device LTP/LPC split: single-frame (10/20 ms) packets only; fills
// sp[0..coded_channels) with the synthesis inputs, advances every
// parse-visible state, and leaves synthesis + output history to the
// device kernel (ops/silk_batch.py).  stereo_out = [w0_prev, w1_prev,
// w0_cur, w1_cur] captured before the prev update.  Returns flength
// (samples per channel at the internal rate) or -1 on bad args.
long parse_superframe(SilkDec& s, RC& rc, int bandwidth,
                      int coded_channels, int duration_ms,
                      SynthParams sp[2], double stereo_out[4],
                      int* midonly_out, int* side_reset_out) {
  if (duration_ms != 10 && duration_ms != 20) return -1;
  s.subframes = duration_ms / 5;
  s.sflength = 20 * (bandwidth + 2);
  s.flength = s.sflength * s.subframes;
  s.bandwidth = bandwidth;
  s.wb = bandwidth == 2;
  *side_reset_out = 0;
  if (s.prev_channels < coded_channels) {
    s.frames[1].reset();
    *side_reset_out = 1;
  }
  s.prev_channels = coded_channels;
  sp[0].coded = 0;
  sp[1].coded = 0;

  bool active[2];
  bool redundancy[2] = {false, false};
  for (int c = 0; c < coded_channels; c++) {
    active[c] = rc.dec_bit_logp(1) != 0;
    redundancy[c] = rc.dec_bit_logp(1) != 0;
  }
  for (int c = 0; c < coded_channels; c++) {
    if (redundancy[c]) {
      bool side_lbrr = coded_channels == 2 && redundancy[1];
      int active1 = (c == 0 && !side_lbrr) ? 0 : 1;
      decode_frame(s, rc, c, coded_channels, true, 0, active1, true, 1);
    }
  }
  s.midonly = 0;
  for (int c = 0; c < coded_channels; c++) {
    if (c == 1 && s.midonly) {
      if (s.frames[1].coded) {
        s.frames[1].reset();
        *side_reset_out = 1;
      }
      break;
    }
    int act1 = coded_channels == 2 ? (active[1] ? 1 : 0) : 1;
    decode_frame(s, rc, c, coded_channels, active[c], 0, act1, false, 1,
                 &sp[c]);
  }
  stereo_out[0] = s.prev_stereo_weights[0];
  stereo_out[1] = s.prev_stereo_weights[1];
  stereo_out[2] = s.stereo_weights[0];
  stereo_out[3] = s.stereo_weights[1];
  *midonly_out = s.midonly;
  if (coded_channels == 2) {
    s.prev_stereo_weights[0] = s.stereo_weights[0];
    s.prev_stereo_weights[1] = s.stereo_weights[1];
  }
  s.midonly = 0;
  return s.flength;
}

}  // namespace

// ------------------------------------------------------------ C API
extern "C" {

void skt_silk_table(const char* name, const int64_t* data, long n) {
  g_t.raw[name] = std::vector<int64_t>(data, data + n);
}

int skt_silk_tables_done() { return g_t.finalize() ? 0 : 1; }

void* skt_silk_new() {
  if (!g_t.ready) return nullptr;
  SilkDec* s = new SilkDec();
  s->flush();
  return s;
}

void skt_silk_free(void* h) { delete (SilkDec*)h; }

void skt_silk_reset(void* h) { ((SilkDec*)h)->flush(); }

// Decode one SILK superframe from an Opus frame payload.
// out: [n, coded_ch] doubles (n = nb_frames * flength at the internal
// rate).  info[0]=has_redundancy, info[1]=red_pos, info[2]=red byte
// offset in frame, info[3]=red size; info[4..12] = final range-coder
// state (offs, rem, end_offs, end_window, nend_bits, nbits_total,
// rng, val, error) for the hybrid CELT continuation.
// Returns n (samples per channel), or -1 on bad args.
long skt_silk_decode(void* h, const uint8_t* frame, long len, int bw,
                     int coded_ch, int duration_ms, int read_redundancy,
                     double* out, long* info) {
  if (!h || bw < 0 || bw > 2 || coded_ch < 1 || coded_ch > 2) return -1;
  if (duration_ms != 10 && duration_ms != 20 && duration_ms != 40 &&
      duration_ms != 60)
    return -1;
  SilkDec& s = *(SilkDec*)h;
  RC rc;
  rc.init(frame, len);
  long n = decode_superframe(s, rc, bw, coded_ch, duration_ms, out);
  info[0] = 0; info[1] = 0; info[2] = 0; info[3] = 0;
  if (read_redundancy) {
    // opus_core.py _silk_transition: >=17 bits of slack mean the
    // trailing bytes carry a 5 ms CELT redundancy frame
    long total = len * 8;
    long tell = rc.tell();
    if (tell + 17 <= total) {
      int pos = rc.dec_bit_logp(1);
      long red_size = len - ((tell + 7) >> 3);
      long main_size = len - red_size;
      if (red_size >= 1 && main_size >= 0) {
        info[0] = 1;
        info[1] = pos;
        info[2] = main_size;
        info[3] = red_size;
      }
    }
  }
  info[4] = rc.offs;
  info[5] = rc.rem;
  info[6] = rc.end_offs;
  info[7] = (long)rc.end_window;
  info[8] = rc.nend_bits;
  info[9] = rc.nbits_total;
  info[10] = (long)rc.rng;
  info[11] = (long)rc.val;
  info[12] = rc.error ? 1 : 0;
  return n;
}

// Batched superframe decode over B independent stream handles (the
// fleet's lockstep serving shape; one native call for the whole
// batch).  frames are packed into buf at offs/lens; lanes with
// valid=0 are skipped.  out is [B, max_n, Cmax]; n_out[b] receives
// the per-lane sample count (or -1 on error).  info layout is the
// same 13 longs per lane as skt_silk_decode.
int skt_silk_decode_many(void** handles, int B, const uint8_t* buf,
                         const long* offs, const long* lens,
                         const int* bws, const int* coded,
                         const int* dur_ms,
                         const unsigned char* valid,
                         int read_redundancy, int Cmax, long max_n,
                         double* out, long* n_out, long* info) {
  if (!g_t.ready) return -1;
  int rc_all = 0;
  std::vector<double> tmp;
  for (int b = 0; b < B; b++) {
    n_out[b] = -1;
    if (!valid[b]) continue;
    int C = coded[b] ? coded[b] : 1;
    tmp.assign((size_t)max_n * C, 0.0);
    long n = skt_silk_decode(handles[b], buf + offs[b], lens[b], bws[b],
                             C, dur_ms[b], read_redundancy, tmp.data(),
                             info + (size_t)b * 13);
    n_out[b] = n;
    if (n < 0) { rc_all = -2; continue; }
    double* dst = out + (size_t)b * max_n * Cmax;
    for (long i = 0; i < n && i < max_n; i++)
      for (int c = 0; c < Cmax; c++)
        dst[i * Cmax + c] = tmp[i * C + (c < C ? c : C - 1)];
  }
  return rc_all;
}

// Batched parse-export for the device LTP/LPC split: one call walks
// every lane's single-frame (10/20 ms) SILK payload, exporting the
// synthesis inputs (ops/silk_batch.py consumes them) and the final
// range-coder state (hybrid CELT continuation).  Per-lane layout:
//   exc      [B, 2, 320] f64      excitation at the internal rate
//   gains    [B, 2, 4]   f64
//   coef     [B, 2, 2, 16] f64    [leadin, lpc]
//   ltp      [B, 2, 4, 5] f64
//   ltpscale [B, 2]      f64
//   stereo_w [B, 4]      f64      [w0_prev, w1_prev, w0, w1]
//   lags     [B, 2, 4]   i32
//   flags    [B, 12]     i32      0 flength, 1 order, 2 coded_ch,
//     3 midonly, 4 side_reset, 5/6 voiced ch0/1, 7/8 has_leadin,
//     9/10 frame-coded ch0/1, 11 reserved
//   info     [B, 13]     i64      rc state as skt_silk_decode
// n_out[b] = flength or -1.  Lanes with valid=0 are untouched.
int skt_silk_parse_many(void** handles, int B, const uint8_t* buf,
                        const long* offs, const long* lens,
                        const int* bws, const int* coded,
                        const int* dur_ms, const unsigned char* valid,
                        double* exc, double* gains, double* coef,
                        double* ltp, double* ltpscale, double* stereo_w,
                        int* lags, int* flags, long* n_out, long* info) {
  if (!g_t.ready) return -1;
  int rc_all = 0;
  for (int b = 0; b < B; b++) {
    if (!valid[b]) continue;
    n_out[b] = -1;
    int C = coded[b] ? coded[b] : 1;
    if (bws[b] < 0 || bws[b] > 2 || C > 2) { rc_all = -2; continue; }
    SilkDec& s = *(SilkDec*)handles[b];
    RC rc;
    rc.init(buf + offs[b], lens[b]);
    SynthParams sp[2];
    memset(sp, 0, sizeof sp);
    double sw[4] = {0, 0, 0, 0};
    int midonly = 0, side_reset = 0;
    long n = parse_superframe(s, rc, bws[b], C, dur_ms[b], sp, sw,
                              &midonly, &side_reset);
    n_out[b] = n;
    if (n < 0) { rc_all = -2; continue; }
    for (int c = 0; c < 2; c++) {
      memcpy(exc + ((size_t)b * 2 + c) * 320, sp[c].exc,
             sizeof(double) * 320);
      memcpy(gains + ((size_t)b * 2 + c) * 4, sp[c].gains,
             sizeof(double) * 4);
      memcpy(coef + (((size_t)b * 2 + c) * 2 + 0) * 16, sp[c].leadin,
             sizeof(double) * 16);
      memcpy(coef + (((size_t)b * 2 + c) * 2 + 1) * 16, sp[c].lpc,
             sizeof(double) * 16);
      memcpy(ltp + ((size_t)b * 2 + c) * 20, sp[c].ltptaps,
             sizeof(double) * 20);
      ltpscale[(size_t)b * 2 + c] = sp[c].ltpscale;
      for (int i = 0; i < 4; i++)
        lags[((size_t)b * 2 + c) * 4 + i] = (int)sp[c].pitchlag[i];
    }
    memcpy(stereo_w + (size_t)b * 4, sw, sizeof sw);
    int* fl = flags + (size_t)b * 12;
    fl[0] = (int)n;
    fl[1] = s.wb ? 16 : 10;
    fl[2] = C;
    fl[3] = midonly;
    fl[4] = side_reset;
    fl[5] = sp[0].voiced;
    fl[6] = sp[1].voiced;
    fl[7] = sp[0].has_leadin;
    fl[8] = sp[1].has_leadin;
    fl[9] = sp[0].coded;
    fl[10] = sp[1].coded;
    fl[11] = 0;
    long* li = info + (size_t)b * 13;
    li[0] = 0; li[1] = 0; li[2] = 0; li[3] = 0;
    li[4] = rc.offs;
    li[5] = rc.rem;
    li[6] = rc.end_offs;
    li[7] = (long)rc.end_window;
    li[8] = rc.nend_bits;
    li[9] = rc.nbits_total;
    li[10] = (long)rc.rng;
    li[11] = (long)rc.val;
    li[12] = rc.error ? 1 : 0;
  }
  return rc_all;
}

}  // extern "C"

// ===================================================================
// SILK ENCODER (port of codecs/opus_silk_enc.py): LPC analysis + LSF
// quantization against the extracted NLSF codebooks, open-loop pitch
// + contour + LTP codebook search, subframe gain quantization, and a
// closed-loop excitation quantizer running the decoder's synthesis
// arithmetic sample by sample.  Every symbol goes through the exact
// interval the owned range decoder reads.
// ===================================================================

namespace {

// -- range encoder (port of opus_enc_rc.py RangeEncoder) ------------
struct RE {
  static constexpr uint32_t CODE_TOP = 1u << 31;
  static constexpr uint32_t CODE_BOT = CODE_TOP >> 8;
  static constexpr int CODE_SHIFT = 23;
  std::vector<uint8_t> buf;
  int64_t size, offs, end_offs;
  uint32_t val, rng;
  int rem;
  int64_t ext;
  uint64_t end_window;
  int nend_bits, nbits_total;
  bool error;
  void init(int64_t sz) {
    size = sz; buf.assign(sz, 0);
    offs = end_offs = 0; val = 0; rng = CODE_TOP;
    rem = -1; ext = 0; end_window = 0; nend_bits = 0;
    nbits_total = 33; error = false;
  }
  void write_byte(int b) {
    if (offs + end_offs >= size) { error = true; return; }
    buf[offs++] = (uint8_t)(b & 0xFF);
  }
  void write_byte_at_end(int b) {
    if (offs + end_offs >= size) { error = true; return; }
    end_offs++;
    buf[size - end_offs] = (uint8_t)(b & 0xFF);
  }
  void carry_out(int c) {
    if (c != 0xFF) {
      int carry = c >> 8;
      if (rem >= 0) write_byte(rem + carry);
      if (ext > 0) {
        int sym = (0xFF + carry) & 0xFF;
        for (int64_t i = 0; i < ext; i++) write_byte(sym);
        ext = 0;
      }
      rem = c & 0xFF;
    } else {
      ext++;
    }
  }
  void normalize() {
    while (rng <= CODE_BOT) {
      carry_out((int)(val >> CODE_SHIFT));
      val = (val << 8) & (CODE_TOP - 1);
      rng <<= 8;
      nbits_total += 8;
    }
  }
  void encode(uint32_t fl, uint32_t fh, uint32_t ft) {
    uint32_t r = rng / ft;
    if (fl > 0) {
      val += rng - r * (ft - fl);
      rng = r * (fh - fl);
    } else {
      rng -= r * (ft - fh);
    }
    normalize();
  }
  void enc_bit_logp(int bit, int logp) {
    uint32_t r = rng;
    uint32_t s = r >> logp;
    r -= s;
    if (bit) { val += r; rng = s; } else { rng = r; }
    normalize();
  }
  void enc_cdf(int sym, const int64_t* cdf) {
    uint32_t total = (uint32_t)cdf[0];
    uint32_t fl = sym >= 1 ? (uint32_t)cdf[sym] : 0;
    uint32_t fh = (uint32_t)cdf[sym + 1];
    encode(fl, fh, total);
  }
  int finalize() {
    int l = 32 - ilogi(rng);
    uint32_t msk = (CODE_TOP - 1) >> l;
    uint32_t end = (val + msk) & ~msk;
    if ((end | msk) >= val + rng) {
      l += 1; msk >>= 1; end = (val + msk) & ~msk;
    }
    while (l > 0) {
      carry_out((int)(end >> CODE_SHIFT));
      end = (end << 8) & (CODE_TOP - 1);
      l -= 8;
    }
    if (rem >= 0 || ext > 0) carry_out(0);
    uint64_t window = end_window;
    int used = nend_bits;
    while (used >= 8) {
      write_byte_at_end((int)(window & 0xFF));
      window >>= 8;
      used -= 8;
    }
    if (!error && used > 0) {
      if (end_offs >= size) error = true;
      else buf[size - end_offs - 1] |= (uint8_t)(window & 0xFF);
    }
    return error ? -1 : 0;
  }
};

// -- analysis helpers (opus_silk_enc.py) ----------------------------
void enc_levinson(const double* ac, int order, double* a) {
  for (int i = 0; i < order; i++) a[i] = 0.0;
  double err = ac[0];
  if (err <= 0) return;
  double tmp[16];
  for (int i = 0; i < order; i++) {
    double acc = ac[i + 1];
    for (int k = 0; k < i; k++) acc -= a[k] * ac[i - k];
    double kref = acc / err;
    if (kref > 0.999) kref = 0.999;
    if (kref < -0.999) kref = -0.999;
    for (int k = 0; k < i; k++) tmp[k] = a[k] - kref * a[i - 1 - k];
    tmp[i] = kref;
    for (int k = 0; k <= i; k++) a[k] = tmp[k];
    err *= 1.0 - kref * kref;
    if (err <= 0) break;
  }
}

constexpr int NLSF_GRID = 1024;

double cheb_eval(const double* c, int K, double x) {
  double t_prev = 1.0, t_cur = x;
  double acc = c[K] + 2.0 * c[K - 1] * x;
  for (int m = 2; m <= K; m++) {
    double t_next = 2.0 * x * t_cur - t_prev;
    t_prev = t_cur; t_cur = t_next;
    acc += 2.0 * c[K - m] * t_cur;
  }
  return acc;
}

// returns true on success; nlsf[order] filled
bool lpc_to_nlsf(const double* a, int order, int64_t* nlsf) {
  static double grid[NLSF_GRID];
  static bool grid_ready = false;
  if (!grid_ready) {
    for (int i = 0; i < NLSF_GRID; i++)
      grid[i] = std::cos(M_PI * (i + 0.5) / NLSF_GRID);
    grid_ready = true;
  }
  int K = order / 2;
  double A[18];
  A[0] = 1.0;
  for (int k = 0; k < order; k++) A[k + 1] = -a[k];
  A[order + 1] = 0.0;
  double p[9], q[9];
  p[0] = 1.0; q[0] = 1.0;
  for (int k = 1; k <= K; k++) {
    p[k] = A[k] + A[order + 1 - k] - p[k - 1];
    q[k] = A[k] - A[order + 1 - k] + q[k - 1];
  }
  double roots[16];
  int which_arr[16];
  int nroots = 0;
  for (int which = 0; which < 2; which++) {
    const double* c = which == 0 ? p : q;
    double v_prev = cheb_eval(c, K, grid[0]);
    int found = 0;
    for (int i = 1; i < NLSF_GRID; i++) {
      double v = cheb_eval(c, K, grid[i]);
      if (((v_prev < 0.0) != (v < 0.0)) || v == 0.0) {
        double lo_x = grid[i - 1], hi_x = grid[i];
        double lo_v = v_prev;
        for (int it = 0; it < 46; it++) {
          double mid = 0.5 * (lo_x + hi_x);
          double mv = cheb_eval(c, K, mid);
          if ((lo_v < 0.0) != (mv < 0.0)) hi_x = mid;
          else { lo_x = mid; lo_v = mv; }
        }
        double x = 0.5 * (lo_x + hi_x);
        if (x > 1.0) x = 1.0;
        if (x < -1.0) x = -1.0;
        if (nroots < 16 && found < K) {
          roots[nroots] = std::acos(x);
          which_arr[nroots] = which;
          nroots++;
        }
        found++;
      }
      v_prev = v;
    }
    if (found != K) return false;
  }
  // sort by angle, check P/Q interleave
  int idx[16];
  for (int i = 0; i < nroots; i++) idx[i] = i;
  std::sort(idx, idx + nroots,
            [&](int x, int y) { return roots[x] < roots[y]; });
  for (int i = 0; i < nroots; i++)
    if (which_arr[idx[i]] != (i % 2)) return false;
  for (int i = 0; i < order; i++) {
    double v = std::nearbyint(roots[idx[i]] / M_PI * 32768.0);
    if (v < 1) v = 1;
    if (v > 32767) v = 32767;
    nlsf[i] = (int64_t)v;
  }
  for (int i = 1; i < order; i++)
    if (nlsf[i] <= nlsf[i - 1]) nlsf[i] = nlsf[i - 1] + 1;
  return true;
}

double cdf_cost_bits(const int64_t* cdf, int sym) {
  int64_t total = cdf[0];
  int64_t lo = sym >= 1 ? cdf[sym] : 0;
  int64_t hi = cdf[sym + 1];
  int64_t w = hi - lo;
  if (w < 1) w = 1;
  return -std::log2((double)w / (double)total);
}

// -- encoder state --------------------------------------------------
struct SilkEnc {
  int bandwidth, order, subframes, sflength, flength;
  bool wb;
  double target_pulse;
  // decoder-mirror state
  int log_gain;
  bool coded;
  bool prev_voiced;
  int64_t prev_nlsf[16];
  double output[2 * SILK_HISTORY];
  double lpc_history[2 * SILK_HISTORY];
  // analysis input history
  double xhist[SILK_MAX_LAG + 16 + 1];
  int xhist_len;
  double lingain[64];
  int lg_last;

  void reset_state() {
    log_gain = 0; coded = false; prev_voiced = false;
    memset(prev_nlsf, 0, sizeof prev_nlsf);
    memset(output, 0, sizeof output);
    memset(lpc_history, 0, sizeof lpc_history);
    memset(xhist, 0, sizeof xhist);
    lg_last = 0;
  }
  void init(int bw, double tp) {
    bandwidth = bw; wb = bw == 2;
    order = wb ? 16 : 10;
    subframes = 4;
    sflength = 20 * (bw + 2);
    flength = sflength * subframes;
    target_pulse = tp;
    xhist_len = SILK_MAX_LAG + order;
    for (int idx = 0; idx < 64; idx++) {
      int64_t lg = (((int64_t)idx * 0x1D1C71) >> 16) + 2090;
      int ip = (int)(lg >> 7);
      int64_t fp = lg & 127;
      int64_t lin = (1ll << ip) +
          ((((-174 * fp * (128 - fp)) >> 16) + fp) * ((1ll << ip) >> 7));
      lingain[idx] = (double)lin / 65536.0;
    }
    reset_state();
  }

  // gain quantization -> symbols stored in gsyms (abs: hi,lo; delta: d)
  struct GainSyms { int kind[4]; int s1[4]; int s2[4]; };
  void quant_gains(const double* desired, GainSyms& gs, double* gains) {
    int lg = log_gain;
    for (int i = 0; i < subframes; i++) {
      int want = 0;
      double bd = std::fabs(lingain[0] - desired[i]);
      for (int k = 1; k < 64; k++) {
        double d = std::fabs(lingain[k] - desired[i]);
        if (d < bd) { bd = d; want = k; }
      }
      if (i == 0) {
        int idx = want;
        gs.kind[i] = 0; gs.s1[i] = idx >> 3; gs.s2[i] = idx & 7;
        lg = idx;
        if (coded && lg < log_gain - 16) lg = log_gain - 16;
      } else {
        int best_d = 0, best_eff = -1;
        for (int d = 0; d < 41; d++) {
          int a = 2 * d - 16, b = lg + d - 4;
          int eff = a > b ? a : b;
          if (eff < 0) eff = 0;
          if (eff > 63) eff = 63;
          if (best_eff < 0 ||
              std::abs(eff - want) < std::abs(best_eff - want)) {
            best_eff = eff; best_d = d;
          }
        }
        gs.kind[i] = 1; gs.s1[i] = best_d;
        lg = best_eff;
      }
      gains[i] = lingain[lg];
      lg_last = lg;
    }
  }

  // NLSF quantization (opus_silk_enc._quant_nlsf)
  void quant_nlsf(const int64_t* target, int* i1_out, int64_t* i2s_out,
                  int64_t* nlsf_out) {
    int64_t qstep = wb ? 9830 : 11796;
    const int64_t* codebooks = wb ? g_t.cb_wb : g_t.cb_nbmb;
    const int64_t* pred_tab = wb ? g_t.predw_wb : g_t.predw_nbmb;
    const int64_t* wsel_tab = wb ? g_t.wsel_wb : g_t.wsel_nbmb;
    int cb_stride = wb ? 16 : 10;
    int w_stride = wb ? 15 : 9;
    double best_err = 0.0;
    int best_i1 = 0;
    int64_t best_i2[16], best_nlsf[16];
    for (int i1 = 0; i1 < 32; i1++) {
      const int64_t* cb = codebooks + i1 * cb_stride;
      const int64_t* wsel = wsel_tab + i1 * w_stride;
      int64_t w[16];
      for (int i = 0; i < order; i++) {
        int64_t cur = cb[i];
        int64_t prev = i ? cb[i - 1] : 0;
        int64_t nxt = i + 1 < order ? cb[i + 1] : 256;
        int64_t weight_sq = (1024 / (cur - prev) + 1024 / (nxt - cur)) << 16;
        int ip = ilogi((uint64_t)weight_sq);
        int64_t fp = (weight_sq >> (ip - 8)) & 127;
        int64_t y = ((ip & 1) ? 32768 : 46214) >> ((32 - ip) >> 1);
        w[i] = y + ((213 * fp * y) >> 16);
      }
      auto f_res = [&](int64_t i2) -> int64_t {
        int64_t v = i2 * 1024;
        if (i2 < 0) v += 102;
        else if (i2 > 0) v -= 102;
        return (v * qstep) >> 16;
      };
      double res_des[16];
      for (int i = 0; i < order; i++)
        res_des[i] = (double)((target[i] - cb[i] * 128) * w[i]) / 16384.0;
      int64_t res_q[16], i2s[16];
      for (int i = order - 1; i >= 0; i--) {
        int64_t pred = 0;
        if (i + 1 < order)
          pred = (res_q[i + 1] * pred_tab[wsel[i] * w_stride + i]) >> 8;
        double d = res_des[i] - (double)pred;
        long guess = std::lround(d * 65536.0 / (1024.0 * (double)qstep));
        int64_t bi = 0;
        double bv = 0.0;
        bool have = false;
        for (int dc = -1; dc <= 1; dc++) {
          long c = guess + dc;
          if (c < -10) c = -10;
          if (c > 10) c = 10;
          double v = (double)(f_res(c) + pred);
          if (!have || std::fabs(v - res_des[i]) < std::fabs(bv - res_des[i])) {
            bv = v; bi = c; have = true;
          }
        }
        i2s[i] = bi;
        res_q[i] = f_res(bi) + pred;
      }
      int64_t nlsf[16];
      for (int i = 0; i < order; i++) {
        int64_t num = res_q[i] * 16384;
        int64_t value = cb[i] * 128 + num / w[i];  // C truncation
        if (value < 0) value = 0;
        if (value > 32767) value = 32767;
        nlsf[i] = value;
      }
      double err = 0.0;
      for (int i = 0; i < order; i++) {
        double d = (double)(nlsf[i] - target[i]);
        err += d * d;
      }
      if (i1 == 0 || err < best_err) {
        best_err = err; best_i1 = i1;
        memcpy(best_i2, i2s, sizeof best_i2);
        memcpy(best_nlsf, nlsf, sizeof best_nlsf);
      }
    }
    *i1_out = best_i1;
    memcpy(i2s_out, best_i2, 16 * sizeof(int64_t));
    memcpy(nlsf_out, best_nlsf, 16 * sizeof(int64_t));
    stabilize_lsf(nlsf_out, order, wb ? g_t.minsp_wb : g_t.minsp_nbmb);
  }

  // pitch search over the open-loop residual (res[SILK_MAX_LAG+flength])
  void pitch_search(const double* res, int* lag_out, double* corr_out) {
    int lo = (int)g_t.pitch_min[bandwidth];
    int scale = (int)g_t.pitch_scale[bandwidth];
    int hi = (int)g_t.pitch_max[bandwidth];
    int hi_abs = lo + 32 * scale - 1;
    if (hi > hi_abs) hi = hi_abs;
    const double* f = res + SILK_MAX_LAG;
    int n = flength;
    double e0 = 0.0;
    for (int i = 0; i < n; i++) e0 += f[i] * f[i];
    e0 += 1e-9;
    int best_lag = lo;
    double best_c = 0.0;
    for (int lag = lo; lag <= hi; lag++) {
      const double* p = res + SILK_MAX_LAG - lag;
      double num = 0.0, pe = 0.0;
      for (int i = 0; i < n; i++) { num += f[i] * p[i]; pe += p[i] * p[i]; }
      double den = std::sqrt(e0 * (pe + 1e-9));
      double c = den > 0 ? num / den : 0.0;
      if (c > best_c) { best_c = c; best_lag = lag; }
    }
    for (int div = 2; div <= 3; div++) {
      int cand = best_lag / div;
      if (cand >= lo) {
        const double* p = res + SILK_MAX_LAG - cand;
        double num = 0.0, pe = 0.0;
        for (int i = 0; i < n; i++) { num += f[i] * p[i]; pe += p[i] * p[i]; }
        double den = std::sqrt(e0 * (pe + 1e-9));
        double c = den > 0 ? num / den : 0.0;
        if (c > 0.85 * best_c) { best_lag = cand; best_c = c; break; }
      }
    }
    *lag_out = best_lag;
    *corr_out = best_c;
  }

  void contour_search(const double* res, int lag, int* primary_out,
                      int* ci_out, int64_t* eff_out) {
    int lo = (int)g_t.pitch_min[bandwidth];
    int scale = (int)g_t.pitch_scale[bandwidth];
    int hi_abs = lo + 32 * scale - 1;
    int hi = (int)g_t.pitch_max[bandwidth];
    const int64_t* offs = bandwidth == 0 ? g_t.off_nb20 : g_t.off_mw20;
    int n_ci = bandwidth == 0 ? 11 : 34;
    int sfl = sflength;
    int64_t sub_lag[4];
    double sub_w[4];
    for (int i = 0; i < subframes; i++) {
      const double* f = res + SILK_MAX_LAG + i * sfl;
      double e0 = 0.0;
      for (int k = 0; k < sfl; k++) e0 += f[k] * f[k];
      e0 += 1e-9;
      int best_l = lag;
      double best_c = -1.0;
      int clo = lag - 10 < lo ? lo : lag - 10;
      int chi = lag + 10 > hi ? hi : lag + 10;
      for (int cand = clo; cand <= chi; cand++) {
        const double* p = res + SILK_MAX_LAG + i * sfl - cand;
        double num = 0.0, pe = 0.0;
        for (int k = 0; k < sfl; k++) { num += f[k] * p[k]; pe += p[k] * p[k]; }
        double den = std::sqrt(e0 * (pe + 1e-9));
        double c = den > 0 ? num / den : 0.0;
        if (c > best_c) { best_c = c; best_l = cand; }
      }
      sub_lag[i] = best_l;
      sub_w[i] = e0 * (best_c > 0.0 ? best_c : 0.0);
    }
    double wsum = 1e-12;
    for (int i = 0; i < subframes; i++) wsum += sub_w[i];
    for (int i = 0; i < subframes; i++) sub_w[i] /= wsum;
    double best_err = 0.0;
    int best_p = lo, best_ci = 0;
    int64_t best_eff[4] = {0, 0, 0, 0};
    bool have = false;
    for (int ci = 0; ci < n_ci; ci++) {
      double acc = 0.0;
      for (int i = 0; i < subframes; i++)
        acc += sub_w[i] * (double)(sub_lag[i] - offs[ci * 4 + i]);
      long p0 = (long)std::nearbyint(acc);
      for (int dp = -1; dp <= 1; dp++) {
        long p = p0 + dp;
        if (p < lo) p = lo;
        if (p > hi_abs) p = hi_abs;
        int64_t eff[4];
        double err = 0.0;
        for (int i = 0; i < subframes; i++) {
          int64_t v = p + offs[ci * 4 + i];
          if (v < lo) v = lo;
          if (v > hi) v = hi;
          eff[i] = v;
          double d = (double)(v - sub_lag[i]);
          err += sub_w[i] * d * d;
        }
        if (!have || err < best_err) {
          have = true; best_err = err; best_p = (int)p; best_ci = ci;
          memcpy(best_eff, eff, sizeof eff);
        }
      }
    }
    *primary_out = best_p;
    *ci_out = best_ci;
    memcpy(eff_out, best_eff, 4 * sizeof(int64_t));
  }

  void ltp_select(const double* res, const int64_t* lags, double corr,
                  int* period_out, int* tap_idx) {
    int period = corr < 0.65 ? 0 : (corr < 0.8 ? 1 : 2);
    const int64_t* books =
        period == 0 ? g_t.taps0 : (period == 1 ? g_t.taps1 : g_t.taps2);
    int nbook = period == 0 ? 8 : (period == 1 ? 16 : 32);
    int sfl = sflength;
    for (int i = 0; i < subframes; i++) {
      const double* target = res + SILK_MAX_LAG + i * sfl;
      int lag = (int)lags[i];
      const double* base = res + SILK_MAX_LAG + i * sfl - lag + 2;
      // G = P P^T (5x5), b = P target; rows P[k] = base - k
      double G[5][5], b[5];
      for (int k = 0; k < 5; k++) {
        const double* pk = base - k;
        double acc = 0.0;
        for (int s = 0; s < sfl; s++) acc += pk[s] * target[s];
        b[k] = acc;
        for (int l = k; l < 5; l++) {
          const double* pl = base - l;
          double g2 = 0.0;
          for (int s = 0; s < sfl; s++) g2 += pk[s] * pl[s];
          G[k][l] = g2; G[l][k] = g2;
        }
      }
      int best = 0;
      double best_e = 0.0;
      for (int nI = 0; nI < nbook; nI++) {
        double c[5];
        for (int k = 0; k < 5; k++)
          c[k] = (double)books[nI * 5 + k] / 128.0;
        double e = 0.0;
        for (int k = 0; k < 5; k++) {
          e -= 2.0 * c[k] * b[k];
          for (int l = 0; l < 5; l++) e += c[k] * G[k][l] * c[l];
        }
        if (nI == 0 || e < best_e) { best_e = e; best = nI; }
      }
      tap_idx[i] = best;
    }
    *period_out = period;
  }

  // closed-loop excitation quantization (decoder synthesis in loop)
  void quantize_frame(const double* x, const double* gains,
                      const double* lpc, bool voiced, const int64_t* lags,
                      const double ltptaps[4][5], double ltpscale,
                      int qoff, uint32_t seed, int64_t* values) {
    int sfl = sflength;
    double residual[SILK_MAX_LAG + 320];
    memset(residual, 0, sizeof residual);
    double* dst = output;
    double* lpch = lpc_history;
    const int base = SILK_HISTORY;
    for (int i = 0; i < subframes; i++) {
      int r0 = SILK_MAX_LAG + i * sfl;
      int d0 = base + i * sfl;
      double g = gains[i];
      if (voiced) {
        int out_end = -i * sfl;
        double rescale = ltpscale;
        int start = -(int)lags[i] - 2;
        for (int j = start; j < out_end; j++) {
          double v = dst[d0 + j];
          for (int k = 0; k < order; k++) v -= lpc[k] * dst[d0 + j - 1 - k];
          if (v < -1.0) v = -1.0;
          if (v > 1.0) v = 1.0;
          residual[r0 + j] = v * rescale / g;
        }
        if (out_end) {
          double rescale2 = gains[i - 1] / g;
          for (int j = out_end; j < 0; j++) residual[r0 + j] *= rescale2;
        }
      }
      for (int j = 0; j < sfl; j++) {
        double lpc_pred = 0.0;
        for (int k = 0; k < order; k++)
          lpc_pred += lpc[k] * lpch[d0 + j - 1 - k];
        double ltp_pred = 0.0;
        if (voiced) {
          int off = r0 + j - (int)lags[i] + 2;
          for (int k = 0; k < 5; k++)
            ltp_pred += ltptaps[i][k] * residual[off - k];
        }
        double res_des = (x[i * sfl + j] - lpc_pred) / g;
        double e_des = res_des - ltp_pred;
        seed = 196314165u * seed + 907633515u;
        bool flip = (seed & 0x80000000u) != 0;
        double d23 = (flip ? -e_des : e_des) * 8388608.0;
        long guess = (long)std::floor((d23 - qoff) / 256.0);
        long bv = 0;
        double be = std::fabs((double)qoff - d23);
        for (int dc = -1; dc <= 2; dc++) {
          long c = guess + dc;
          if (c < -4095) c = -4095;
          if (c > 4095) c = 4095;
          long e23 = c * 256 + qoff;
          if (c < 0) e23 += 20;
          else if (c > 0) e23 -= 20;
          if (std::fabs((double)e23 - d23) < be) {
            be = std::fabs((double)e23 - d23);
            bv = c;
          }
        }
        seed = seed + (uint32_t)(int32_t)bv;
        long e23 = bv * 256 + qoff;
        if (bv < 0) e23 += 20;
        else if (bv > 0) e23 -= 20;
        double e_q = (double)(flip ? -e23 : e23) / 8388608.0;
        values[i * sfl + j] = bv;
        residual[r0 + j] = e_q + ltp_pred;
        double s = residual[r0 + j] * g + lpc_pred;
        lpch[d0 + j] = s;
        dst[d0 + j] = s < -1.0 ? -1.0 : (s > 1.0 ? 1.0 : s);
      }
    }
    memmove(lpc_history, lpc_history + flength,
            sizeof(double) * SILK_HISTORY);
    memmove(output, output + flength, sizeof(double) * SILK_HISTORY);
  }

  void encode_excitation(RE& rc, const int64_t* values, int seed0,
                         bool voiced, int qoffset_high) {
    const int active = 1;
    rc.enc_cdf(seed0, g_t.lcg_seed_m);
    int shellblocks = (int)g_t.shell_blocks[bandwidth * 2 + (subframes >> 2)];
    int64_t mags[320];
    for (int i = 0; i < flength; i++)
      mags[i] = values[i] < 0 ? -values[i] : values[i];
    int64_t lsbcount[20], tops[320], pulses[20];
    for (int b = 0; b < shellblocks; b++) {
      int lsb = 0;
      for (;;) {
        int64_t tot = 0;
        for (int k = 0; k < 16; k++) tot += mags[16 * b + k] >> lsb;
        if (tot <= 16) break;
        lsb++;
      }
      lsbcount[b] = lsb;
      int64_t tot = 0;
      for (int k = 0; k < 16; k++) {
        tops[16 * b + k] = mags[16 * b + k] >> lsb;
        tot += tops[16 * b + k];
      }
      pulses[b] = tot;
    }
    // rate level by exact entropy cost of the count symbols
    auto count_cost = [&](int rl, int b) -> double {
      int lsb = (int)lsbcount[b];
      int p = (int)pulses[b];
      const int64_t* pc = g_t.pulse_count;
      if (lsb == 0) return cdf_cost_bits(pc + rl * 19, p);
      double c = cdf_cost_bits(pc + rl * 19, 17);
      for (int k = 0; k < lsb - 1; k++) c += cdf_cost_bits(pc + 9 * 19, 17);
      c += cdf_cost_bits(pc + (lsb == 10 ? 10 : 9) * 19, p);
      return c;
    };
    int best_rl = 0;
    double best_cost = 0.0;
    for (int rl = 0; rl < 9; rl++) {
      double c = 0.0;
      for (int b = 0; b < shellblocks; b++) c += count_cost(rl, b);
      if (rl == 0 || c < best_cost) { best_cost = c; best_rl = rl; }
    }
    rc.enc_cdf(best_rl, g_t.exc_rate + (voiced ? 1 : 0) * 10);
    for (int b = 0; b < shellblocks; b++) {
      int lsb = (int)lsbcount[b];
      int p = (int)pulses[b];
      if (lsb == 0) {
        rc.enc_cdf(p, g_t.pulse_count + best_rl * 19);
      } else {
        rc.enc_cdf(17, g_t.pulse_count + best_rl * 19);
        for (int k = 0; k < lsb - 1; k++)
          rc.enc_cdf(17, g_t.pulse_count + 9 * 19);
        rc.enc_cdf(p, g_t.pulse_count + (lsb == 10 ? 10 : 9) * 19);
      }
    }
    auto enc_split = [&](int model, int left, int total) {
      if (total == 0) return;
      int off = ((total - 1 + 5) * (total - 1)) >> 1;
      rc.enc_cdf(left, g_t.pulse_loc + model * 168 + off);
    };
    for (int b = 0; b < shellblocks; b++) {
      if (pulses[b] == 0) continue;
      const int64_t* tb = tops + 16 * b;
      int64_t h8[2] = {0, 0};
      for (int k = 0; k < 8; k++) h8[0] += tb[k];
      for (int k = 8; k < 16; k++) h8[1] += tb[k];
      enc_split(0, (int)h8[0], (int)pulses[b]);
      for (int bi = 0; bi < 2; bi++) {
        int64_t q4[2] = {0, 0};
        for (int k = 0; k < 4; k++) q4[0] += tb[8 * bi + k];
        for (int k = 4; k < 8; k++) q4[1] += tb[8 * bi + k];
        enc_split(1, (int)q4[0], (int)h8[bi]);
        for (int ci = 0; ci < 2; ci++) {
          int base2 = 8 * bi + 4 * ci;
          int64_t p2[2] = {tb[base2] + tb[base2 + 1],
                           tb[base2 + 2] + tb[base2 + 3]};
          enc_split(2, (int)p2[0], (int)q4[ci]);
          for (int di = 0; di < 2; di++) {
            int k = base2 + 2 * di;
            enc_split(3, (int)tb[k], (int)p2[di]);
          }
        }
      }
    }
    for (int i = 0; i < shellblocks * 16; i++) {
      int lsb = (int)lsbcount[i >> 4];
      for (int b = 0; b < lsb; b++) {
        int bit = (int)((mags[i] >> (lsb - 1 - b)) & 1);
        rc.enc_cdf(bit, g_t.exc_lsb);
      }
    }
    for (int i = 0; i < shellblocks * 16; i++) {
      if (mags[i] != 0) {
        int pc = (int)pulses[i >> 4];
        if (pc > 6) pc = 6;
        const int64_t* m =
            g_t.exc_sign +
            (((active + (voiced ? 1 : 0)) * 2 + qoffset_high) * 7 + pc) * 3;
        rc.enc_cdf(values[i] < 0 ? 0 : 1, m);
      }
    }
  }

  // one frame payload (no superframe header bits)
  void encode_frame(RE& rc, const double* x, int seed0) {
    // windowed autocorrelation over history tail + frame
    int awin_n = flength + order;
    double xe[320 + 16];
    {
      // xh = xhist ++ x; awin = last (flength+order)
      double win;
      int M = awin_n;
      for (int i = 0; i < M; i++) {
        double v;
        int j = xhist_len + flength - M + i;  // index into xh
        if (j < xhist_len) v = xhist[j];
        else v = x[j - xhist_len];
        win = 0.5 - 0.5 * std::cos(2.0 * M_PI * i / (M - 1));
        xe[i] = v * win;
      }
      double ac[17];
      for (int k = 0; k <= order; k++) {
        double acc = 0.0;
        for (int i = 0; i + k < M; i++) acc += xe[i] * xe[i + k];
        ac[k] = acc;
      }
      ac[0] = ac[0] * 1.0001 + 1e-9;
      double a_raw[16];
      enc_levinson(ac, order, a_raw);
      int64_t nlsf_t[16];
      if (!lpc_to_nlsf(a_raw, order, nlsf_t)) {
        if (coded) {
          memcpy(nlsf_t, prev_nlsf, sizeof nlsf_t);
        } else {
          for (int i = 0; i < order; i++)
            nlsf_t[i] = (int64_t)(2048.0 +
                                  (30720.0 - 2048.0) * i / (order - 1));
        }
      }
      int i1;
      int64_t i2s[16], nlsf_q[16];
      quant_nlsf(nlsf_t, &i1, i2s, nlsf_q);
      double lpc[16];
      memset(lpc, 0, sizeof lpc);
      lsf2lpc(nlsf_q, lpc, order);

      // open-loop residual
      double res_ol[SILK_MAX_LAG + 320];
      for (int j = -SILK_MAX_LAG; j < flength; j++) {
        int idx = xhist_len + j;
        double v = idx < xhist_len ? (idx >= 0 ? xhist[idx] : 0.0)
                                   : x[idx - xhist_len];
        double acc = v;
        for (int k = 0; k < order; k++) {
          int jdx = idx - 1 - k;
          double h = jdx < xhist_len ? (jdx >= 0 ? xhist[jdx] : 0.0)
                                     : x[jdx - xhist_len];
          acc -= lpc[k] * h;
        }
        res_ol[SILK_MAX_LAG + j] = acc;
      }

      int lag;
      double corr;
      pitch_search(res_ol, &lag, &corr);
      bool voiced = corr > 0.55;
      int period = 0;
      int tap_idx[4] = {0, 0, 0, 0};
      double ltptaps[4][5];
      memset(ltptaps, 0, sizeof ltptaps);
      int primary = lag, contour = 0;
      int64_t lags[4] = {lag, lag, lag, lag};
      if (voiced) {
        contour_search(res_ol, lag, &primary, &contour, lags);
        ltp_select(res_ol, lags, corr, &period, tap_idx);
        const int64_t* books =
            period == 0 ? g_t.taps0 : (period == 1 ? g_t.taps1 : g_t.taps2);
        for (int i = 0; i < subframes; i++)
          for (int k = 0; k < 5; k++)
            ltptaps[i][k] = (double)books[tap_idx[i] * 5 + k] / 128.0;
      }

      int sfl = sflength;
      double desired[4];
      for (int i = 0; i < subframes; i++) {
        double seg[100];
        for (int k = 0; k < sfl; k++)
          seg[k] = res_ol[SILK_MAX_LAG + i * sfl + k];
        if (voiced) {
          const double* pred = res_ol + SILK_MAX_LAG + i * sfl - (int)lags[i];
          double tt = 0.0;
          for (int k = 0; k < 5; k++) tt += ltptaps[i][k] * ltptaps[i][k];
          double g_ltp = std::sqrt(tt);
          if (g_ltp > 1.0) g_ltp = 1.0;
          double sp = 0.0, pp = 1e-9;
          for (int k = 0; k < sfl; k++) {
            sp += seg[k] * pred[k];
            pp += pred[k] * pred[k];
          }
          double coef = g_ltp * sp / pp;
          for (int k = 0; k < sfl; k++) seg[k] -= coef * pred[k];
        }
        double ss = 1e-12;
        for (int k = 0; k < sfl; k++) ss += seg[k] * seg[k];
        double rms = std::sqrt(ss / sfl);
        double want = rms * 32768.0 / target_pulse;
        desired[i] = want > 1.0 ? want : 1.0;
      }
      GainSyms gs;
      double gains[4];
      quant_gains(desired, gs, gains);

      int qoffset_high = 0;
      int ftype = (voiced ? 2 : 0) | qoffset_high;
      rc.enc_cdf(ftype, g_t.ft_active);
      for (int i = 0; i < subframes; i++) {
        if (gs.kind[i] == 0) {
          int sigtype = voiced ? 2 : 1;
          rc.enc_cdf(gs.s1[i], g_t.gain_high + sigtype * 9);
          rc.enc_cdf(gs.s2[i], g_t.gain_low);
        } else {
          rc.enc_cdf(gs.s1[i], g_t.gain_delta);
        }
      }
      rc.enc_cdf(i1, g_t.lsf_s1 +
                         ((wb ? 1 : 0) * 2 + (voiced ? 1 : 0)) * 33);
      const int64_t* sel =
          (wb ? g_t.s2_sel_wb + i1 * 16 : g_t.s2_sel_nbmb + i1 * 10);
      for (int i = 0; i < order; i++) {
        int i2 = (int)i2s[i];
        int bsym = i2 < -4 ? -4 : (i2 > 4 ? 4 : i2);
        rc.enc_cdf(bsym + 4, g_t.lsf_s2 + sel[i] * 10);
        if (bsym == -4) rc.enc_cdf(-4 - i2, g_t.lsf_s2_ext);
        else if (bsym == 4) rc.enc_cdf(i2 - 4, g_t.lsf_s2_ext);
      }
      rc.enc_cdf(4, g_t.lsf_interp);

      double ltpscale = 15565.0 / 16384.0;
      if (voiced) {
        int lo = (int)g_t.pitch_min[bandwidth];
        int scale = (int)g_t.pitch_scale[bandwidth];
        int pmax = lo + 32 * scale - 1;
        if (primary < lo) primary = lo;
        if (primary > pmax) primary = pmax;
        int high = (primary - lo) / scale;
        int low = (primary - lo) % scale;
        const int64_t* low_model =
            bandwidth == 0 ? g_t.pitch_low_nb
                           : (bandwidth == 1 ? g_t.pitch_low_mb
                                             : g_t.pitch_low_wb);
        rc.enc_cdf(high, g_t.pitch_high);
        rc.enc_cdf(low, low_model);
        rc.enc_cdf(contour,
                   bandwidth == 0 ? g_t.contour_nb20 : g_t.contour_mw20);
        const int64_t* fsel =
            period == 0 ? g_t.ltp_sel0
                        : (period == 1 ? g_t.ltp_sel1 : g_t.ltp_sel2);
        rc.enc_cdf(period, g_t.ltp_filter);
        for (int i = 0; i < subframes; i++) rc.enc_cdf(tap_idx[i], fsel);
        rc.enc_cdf(0, g_t.ltp_scale_idx);
        ltpscale = (double)g_t.ltp_scale_f[0] / 16384.0;
      }

      int qoff = (int)g_t.quant_offset[(voiced ? 1 : 0) * 2 + qoffset_high];
      int64_t values[320];
      quantize_frame(x, gains, lpc, voiced, lags, ltptaps, ltpscale, qoff,
                     (uint32_t)seed0, values);
      encode_excitation(rc, values, seed0, voiced, qoffset_high);

      memcpy(prev_nlsf, nlsf_q, order * sizeof(int64_t));
      prev_voiced = voiced;
      log_gain = lg_last;
      coded = true;
      // advance analysis history: keep last xhist_len of (xhist ++ x)
      double merged[SILK_MAX_LAG + 16 + 320];
      memcpy(merged, xhist, xhist_len * sizeof(double));
      memcpy(merged + xhist_len, x, flength * sizeof(double));
      memcpy(xhist, merged + xhist_len + flength - xhist_len,
             xhist_len * sizeof(double));
    }
  }
};

}  // namespace

extern "C" {

void* skt_silk_enc_new(int bandwidth) {
  if (!g_t.ready || bandwidth < 0 || bandwidth > 2) return nullptr;
  SilkEnc* e = new SilkEnc();
  e->init(bandwidth, 3.0);
  return e;
}

void skt_silk_enc_free(void* h) { delete (SilkEnc*)h; }

void skt_silk_enc_reset(void* h) { ((SilkEnc*)h)->reset_state(); }

// Encode one mono 20 ms frame (VAD/LBRR header + payload) with the
// given target_pulse (the VBR rate-loop control).  x: [flength]
// floats at the internal rate.  Returns payload length written to
// out (cap bytes), or -1 on error.
long skt_silk_enc_frame(void* h, const double* x, double target_pulse,
                        int seed0, uint8_t* out, long cap) {
  SilkEnc& e = *(SilkEnc*)h;
  e.target_pulse = target_pulse;
  RE rc;
  rc.init(1275);
  rc.enc_bit_logp(1, 1);
  rc.enc_bit_logp(0, 1);
  e.encode_frame(rc, x, seed0);
  if (rc.finalize() != 0) return -1;
  if (rc.offs > cap) return -1;
  memcpy(out, rc.buf.data(), rc.offs);
  return rc.offs;
}

}  // extern "C"

// -- stereo (mid/side) encoder (opus_silk_enc.SilkStereoEncoder) ----

namespace {

struct SilkStereoEnc {
  SilkEnc mid, side;
  int bandwidth, flength;
  double w[2];        // last coded [w_p0, w_m] (decoder scale)
  double mhist[2], dhist[2];
  void init(int bw, double tp) {
    mid.init(bw, tp);
    side.init(bw, tp);
    bandwidth = bw;
    flength = mid.flength;
    w[0] = w[1] = 0.0;
    mhist[0] = mhist[1] = 0.0;
    dhist[0] = dhist[1] = 0.0;
  }
  void reset_state() {
    mid.reset_state();
    side.reset_state();
    w[0] = w[1] = 0.0;
    mhist[0] = mhist[1] = 0.0;
    dhist[0] = dhist[1] = 0.0;
  }

  // nearest representable stereo weight: (value_q13, wi, ws)
  void quant_weight(double target_q13, int64_t* val, int* wi_out,
                    int* ws_out) {
    bool have = false;
    int64_t bv = 0;
    int bwi = 0, bws = 0;
    for (int wi = 0; wi < 15; wi++) {
      int64_t lo = g_t.stereo_w[wi], hi = g_t.stereo_w[wi + 1];
      int64_t step = ((hi - lo) * 6554) >> 16;
      for (int ws = 0; ws < 5; ws++) {
        int64_t v = lo + step * (ws * 2 + 1);
        if (!have || std::fabs((double)v - target_q13) <
                         std::fabs((double)bv - target_q13)) {
          have = true; bv = v; bwi = wi; bws = ws;
        }
      }
    }
    *val = bv; *wi_out = bwi; *ws_out = bws;
  }

  void encode_superframe(RE& rc, const double* xl, const double* xr,
                         int seed0) {
    int fl = flength;
    double m[320], d[320];
    for (int i = 0; i < fl; i++) {
      m[i] = 0.5 * (xl[i] + xr[i]);
      d[i] = 0.5 * (xl[i] - xr[i]);
    }
    for (int c = 0; c < 2; c++) {
      rc.enc_bit_logp(1, 1);
      rc.enc_bit_logp(0, 1);
    }
    // weight estimation (open loop, true mid): grid k=0..fl-1 with
    // m1[k]=mx[k+1], p0 low-pass centered at k-1, target dd[k]=dx[k+1]
    double m1[320], p0[320], dd[320];
    auto mx = [&](int i) { return i < 2 ? mhist[i] : m[i - 2]; };
    auto dx = [&](int i) { return i < 2 ? dhist[i] : d[i - 2]; };
    for (int k = 0; k < fl; k++) {
      m1[k] = mx(k + 1);
      p0[k] = 0.25 * (mx(k) + 2.0 * mx(k + 1) + mx(k + 2));
      dd[k] = dx(k + 1);
    }
    double g00 = 0, g01 = 0, g11 = 0, b0 = 0, b1 = 0;
    for (int k = 0; k < fl; k++) {
      g00 += m1[k] * m1[k];
      g01 += m1[k] * p0[k];
      g11 += p0[k] * p0[k];
      b0 += m1[k] * dd[k];
      b1 += p0[k] * dd[k];
    }
    // solve (G + 1e-9 I) [wm wp]' = b via LU with partial pivoting
    double a00 = g00 + 1e-9, a01 = g01, a10 = g01, a11 = g11 + 1e-9;
    double r0 = b0, r1 = b1;
    double wm = 0.0, wp = 0.0;
    {
      double A00 = a00, A01 = a01, A10 = a10, A11 = a11, B0 = r0, B1 = r1;
      if (std::fabs(A10) > std::fabs(A00)) {
        std::swap(A00, A10); std::swap(A01, A11); std::swap(B0, B1);
      }
      if (A00 != 0.0) {
        double f = A10 / A00;
        A11 -= f * A01;
        B1 -= f * B0;
        if (A11 != 0.0) {
          wp = B1 / A11;
          wm = (B0 - A01 * wp) / A00;
        }
      }
    }
    double t1 = wm * 8192.0;
    if (t1 < -13732) t1 = -13732;
    if (t1 > 13732) t1 = 13732;
    int64_t w1v; int wi1, ws1;
    quant_weight(t1, &w1v, &wi1, &ws1);
    double t0 = wp * 8192.0 + (double)w1v;
    if (t0 < -13732) t0 = -13732;
    if (t0 > 13732) t0 = 13732;
    int64_t w0v; int wi0, ws0;
    quant_weight(t0, &w0v, &wi0, &ws0);
    int n_sym = 5 * (wi0 / 3) + (wi1 / 3);
    rc.enc_cdf(n_sym, g_t.stereo_s1);
    rc.enc_cdf(wi0 % 3, g_t.stereo_s2);
    rc.enc_cdf(ws0, g_t.stereo_s3);
    rc.enc_cdf(wi1 % 3, g_t.stereo_s2);
    rc.enc_cdf(ws1, g_t.stereo_s3);
    double w_new[2] = {(double)(w0v - w1v) / 8192.0,
                       (double)w1v / 8192.0};

    mid.encode_frame(rc, m, seed0);

    // side target against the decoded mid + weight interpolation
    int base = SILK_HISTORY - fl;
    auto ms = [&](int tp) {  // t' in [-2, fl]; extrapolate t'=fl
      int idx = tp >= fl ? fl - 1 : tp;
      return mid.output[base + idx];
    };
    int n1 = (int)g_t.stereo_interp_len[bandwidth];
    double x_side[320];
    double w0p = w[0], w1p = w[1];
    for (int t = 0; t < fl; t++) {
      double k = (double)(t + 1);
      double i0 = k < n1 ? w0p + k * (w_new[0] - w0p) / n1 : w_new[0];
      double i1v = k < n1 ? w1p + k * (w_new[1] - w1p) / n1 : w_new[1];
      double p0d = 0.25 * (ms(t - 1) + 2.0 * ms(t) + ms(t + 1));
      x_side[t] = d[t] - i1v * ms(t) - i0 * p0d;
    }
    side.encode_frame(rc, x_side, seed0);

    w[0] = w_new[0];
    w[1] = w_new[1];
    mhist[0] = m[fl - 2]; mhist[1] = m[fl - 1];
    dhist[0] = d[fl - 2]; dhist[1] = d[fl - 1];
  }
};

}  // namespace

extern "C" {

void* skt_silk_enc_stereo_new(int bandwidth) {
  if (!g_t.ready || bandwidth < 0 || bandwidth > 2) return nullptr;
  SilkStereoEnc* e = new SilkStereoEnc();
  e->init(bandwidth, 3.0);
  return e;
}

void skt_silk_enc_stereo_free(void* h) { delete (SilkStereoEnc*)h; }

void skt_silk_enc_stereo_reset(void* h) {
  ((SilkStereoEnc*)h)->reset_state();
}

// Encode one stereo 20 ms frame; xl/xr: [flength] at the internal
// rate.  Returns payload length, or -1 on error.
long skt_silk_enc_stereo_frame(void* h, const double* xl,
                               const double* xr, double target_pulse,
                               int seed0, uint8_t* out, long cap) {
  SilkStereoEnc& e = *(SilkStereoEnc*)h;
  e.mid.target_pulse = target_pulse;
  e.side.target_pulse = target_pulse;
  RE rc;
  rc.init(1275);
  e.encode_superframe(rc, xl, xr, seed0);
  if (rc.finalize() != 0) return -1;
  if (rc.offs > cap) return -1;
  memcpy(out, rc.buf.data(), rc.offs);
  return rc.offs;
}

}  // extern "C"
