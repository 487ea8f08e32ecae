// CELT (RFC 6716 §4.3) host parse stage: range decoder + energy +
// allocation + PVQ + anti-collapse + denormalize, emitting the
// spectra/postfilter parameters consumed by the batched device
// synthesis (ops/celt_batch.py).  This is a C++ port of the owned
// Python decoder (codecs/opus_rc.py + codecs/opus_celt.py) — the
// entropy stage is per-symbol sequential and belongs on the host;
// this port removes the Python interpreter from the serving loop.
// Parity reference: soundkit-opus/src/lib.rs (libopus wrapper).
//
// Spec tables are pushed from Python (the extracted RFC set in
// opus_tables.py) via skt_celt_table_{i,f} — nothing is hardcoded
// here beyond structure.
#include <cstdint>
#include <cstring>
#include <cmath>
#include <map>
#include <string>
#include <vector>

namespace {

constexpr int BITRES = 3;
constexpr int MAX_FINE_BITS = 8;
constexpr int FINE_OFFSET = 21;
constexpr int ALLOC_STEPS = 6;
constexpr int NB_BANDS = 21;
constexpr int SPREAD_NONE = 0;
constexpr int SPREAD_AGGRESSIVE = 3;
constexpr int COMB_MINPERIOD = 15;

// ---------------------------------------------------------------- tables
struct Tables {
  std::map<std::string, std::vector<int64_t>> ints;
  std::map<std::string, std::vector<double>> flts;
  // derived
  std::vector<uint64_t> pvq_u;
  int64_t pvq_row_off[15];
  int64_t eBands[22], logN[21];
  double eMeans[25], alpha[4], beta[4];
  int64_t e_prob[4][2][42];
  int64_t static_alloc_rows;            // 11
  int64_t static_alloc[16][21];
  int64_t static_caps[4][2][21];
  int64_t cache_index[105];
  int64_t cache_bits[392];
  int64_t log2_frac[24];
  int64_t tf_select[4][2][2][2];
  int64_t qn_exp2[8];
  int64_t bit_interleave[16], bit_deinterleave[16];
  std::vector<int64_t> spread_cdf, tapset_cdf, trim_cdf, esmall_cdf;
  double pf_taps[3][3];
  std::vector<double> window;  // celt_window (encoder MDCT; optional)
  bool ready = false;

  bool finalize() {
    auto geti = [&](const char* n) -> std::vector<int64_t>* {
      auto it = ints.find(n);
      return it == ints.end() ? nullptr : &it->second;
    };
    auto getf = [&](const char* n) -> std::vector<double>* {
      auto it = flts.find(n);
      return it == flts.end() ? nullptr : &it->second;
    };
    auto* u = geti("pvq_u");
    auto* ro = geti("pvq_row_off");
    auto* eb = geti("freq_bands");
    auto* ln = geti("log_freq_range");
    auto* me = getf("mean_energy");
    auto* al = getf("alpha_coef");
    auto* be = getf("beta_coef");
    auto* ep = geti("coarse_energy_dist");
    auto* sa = geti("static_alloc");
    auto* sc = geti("static_caps");
    auto* ci = geti("cache_index");
    auto* cb = geti("cache_bits");
    auto* lf = geti("log2_frac");
    auto* ts = geti("tf_select");
    auto* qe = geti("qn_exp2");
    auto* bi = geti("bit_interleave");
    auto* bd = geti("bit_deinterleave");
    auto* sp = geti("model_spread");
    auto* tp = geti("model_tapset");
    auto* tr = geti("model_alloc_trim");
    auto* es = geti("model_energy_small");
    auto* pt = getf("postfilter_taps");
    if (!u || !ro || !eb || !ln || !me || !al || !be || !ep || !sa ||
        !sc || !ci || !cb || !lf || !ts || !qe || !bi || !bd || !sp ||
        !tp || !tr || !es || !pt)
      return false;
    if (ro->size() != 15 || eb->size() != 22 || ln->size() != 21 ||
        me->size() < 21 || al->size() != 4 || be->size() != 4 ||
        ep->size() != 4 * 2 * 42 || sa->size() % 21 != 0 ||
        sc->size() != 4 * 2 * 21 || ci->size() != 105 ||
        cb->size() != 392 || lf->size() != 24 || ts->size() != 32 ||
        qe->size() != 8 || bi->size() != 16 || bd->size() != 16 ||
        pt->size() != 9)
      return false;
    pvq_u.assign(u->begin(), u->end());
    for (int i = 0; i < 15; i++) pvq_row_off[i] = (*ro)[i];
    for (int i = 0; i < 22; i++) eBands[i] = (*eb)[i];
    for (int i = 0; i < 21; i++) logN[i] = (*ln)[i];
    for (size_t i = 0; i < 25 && i < me->size(); i++) eMeans[i] = (*me)[i];
    for (int i = 0; i < 4; i++) { alpha[i] = (*al)[i]; beta[i] = (*be)[i]; }
    for (int a = 0; a < 4; a++)
      for (int b = 0; b < 2; b++)
        for (int c = 0; c < 42; c++)
          e_prob[a][b][c] = (*ep)[(a * 2 + b) * 42 + c];
    static_alloc_rows = (int64_t)(sa->size() / 21);
    if (static_alloc_rows > 16) return false;
    for (int64_t r = 0; r < static_alloc_rows; r++)
      for (int j = 0; j < 21; j++)
        static_alloc[r][j] = (*sa)[r * 21 + j];
    for (int a = 0; a < 4; a++)
      for (int b = 0; b < 2; b++)
        for (int c = 0; c < 21; c++)
          static_caps[a][b][c] = (*sc)[(a * 2 + b) * 21 + c];
    for (int i = 0; i < 105; i++) cache_index[i] = (*ci)[i];
    for (int i = 0; i < 392; i++) cache_bits[i] = (*cb)[i];
    for (int i = 0; i < 24; i++) log2_frac[i] = (*lf)[i];
    for (int a = 0; a < 4; a++)
      for (int b = 0; b < 2; b++)
        for (int c = 0; c < 2; c++)
          for (int d = 0; d < 2; d++)
            tf_select[a][b][c][d] = (*ts)[((a * 2 + b) * 2 + c) * 2 + d];
    for (int i = 0; i < 8; i++) qn_exp2[i] = (*qe)[i];
    for (int i = 0; i < 16; i++) {
      bit_interleave[i] = (*bi)[i];
      bit_deinterleave[i] = (*bd)[i];
    }
    spread_cdf = *sp; tapset_cdf = *tp; trim_cdf = *tr; esmall_cdf = *es;
    for (int i = 0; i < 3; i++)
      for (int j = 0; j < 3; j++)
        pf_taps[i][j] = (*pt)[i * 3 + j];
    auto* wd = getf("window");
    if (wd) window = *wd;  // optional: only the encoder needs it
    ready = true;
    return true;
  }
};

Tables g_tables;

// ------------------------------------------------------ range decoder
inline int ilog64(uint64_t v) { return v ? 64 - __builtin_clzll(v) : 0; }
inline int ilog32(uint32_t v) { return v ? 32 - __builtin_clz(v) : 0; }

struct RC {
  const uint8_t* buf;
  int64_t storage, offs, end_offs;
  uint64_t end_window;
  int nend_bits, nbits_total;
  uint32_t rng, val, ext;
  int rem;
  bool error;

  // opus_rc.py RangeDecoder.__init__ (CODE_EXTRA = 7)
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
  int read_byte_from_end() {
    if (end_offs < storage) { end_offs++; return buf[storage - end_offs]; }
    return 0;
  }
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
  uint32_t decode(uint32_t ft) {
    ext = rng / ft;
    uint32_t s = val / ext;
    return ft - (s + 1 < ft ? s + 1 : ft);
  }
  uint32_t decode_bin(int ftb) {
    ext = rng >> ftb;
    uint32_t s = val / ext;
    uint32_t ft = 1u << ftb;
    return ft - (s + 1 < ft ? s + 1 : ft);
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
  // ffmpeg-layout model table: cdf[0] = ft, then cumulative freqs
  int dec_cdf(const std::vector<int64_t>& cdf) {
    uint32_t total = (uint32_t)cdf[0];
    uint32_t scale = rng / total;
    ext = scale;
    uint32_t sym = total -
        (val / scale + 1 < total ? val / scale + 1 : total);
    size_t k = 1;
    while ((uint32_t)cdf[k] <= sym) k++;
    uint32_t high = (uint32_t)cdf[k];
    uint32_t low = k > 1 ? (uint32_t)cdf[k - 1] : 0;
    update(low, high, total);
    return (int)k - 1;
  }
  uint32_t rawbits(int bits) {
    while (nend_bits < bits) {
      end_window |= (uint64_t)read_byte_from_end() << nend_bits;
      nend_bits += 8;
    }
    uint32_t ret = (uint32_t)(end_window & ((1ull << bits) - 1));
    end_window >>= bits;
    nend_bits -= bits;
    nbits_total += bits;
    return ret;
  }
  uint64_t dec_uint(uint64_t ft) {
    if (ft <= 1) return 0;
    int ftb = ilog64(ft - 1);
    if (ftb > 8) {
      ftb -= 8;
      uint32_t ft1 = (uint32_t)(((ft - 1) >> ftb) + 1);
      uint32_t fs = decode(ft1);
      update(fs, fs + 1, ft1);
      uint64_t t = ((uint64_t)fs << ftb) | rawbits(ftb);
      if (t <= ft - 1) return t;
      error = true;
      return ft - 1;
    }
    uint32_t fs = decode((uint32_t)ft);
    update(fs, fs + 1, (uint32_t)ft);
    return fs;
  }
  uint32_t dec_uint_tri(uint32_t qn) {
    uint32_t ft = ((qn >> 1) + 1) * ((qn >> 1) + 1);
    uint32_t fm = decode(ft);
    uint32_t itheta, fs, fl;
    if (fm < ((qn >> 1) * ((qn >> 1) + 1) >> 1)) {
      itheta = (isqrt64(8ull * fm + 1) - 1) >> 1;
      fs = itheta + 1;
      fl = itheta * (itheta + 1) >> 1;
    } else {
      itheta = (2 * (qn + 1) -
                (uint32_t)isqrt64(8ull * (ft - fm - 1) + 1)) >> 1;
      fs = qn + 1 - itheta;
      fl = ft - ((qn + 1 - itheta) * (qn + 2 - itheta) >> 1);
    }
    update(fl, fl + fs, ft);
    return itheta;
  }
  static uint64_t isqrt64(uint64_t v) {
    if (!v) return 0;
    uint64_t r = (uint64_t)std::sqrt((double)v);
    while (r * r > v) r--;
    while ((r + 1) * (r + 1) <= v) r++;
    return r;
  }
  int tell() const { return nbits_total - ilog32(rng); }
  int tell_frac() const {
    static const uint32_t corr[8] = {35733, 38967, 42495, 46340,
                                     50535, 55109, 60097, 65535};
    int nbits = nbits_total << 3;
    int l = ilog32(rng);
    uint32_t r = rng >> (l - 16);
    int b = (int)(r >> 12) - 8;
    b += r > corr[b] ? 1 : 0;
    l = (l << 3) + b;
    return nbits - l;
  }
  int64_t total_bits() const { return storage * 8; }
};

// Laplace decoder (opus_rc.py laplace_decode)
int laplace_decode(RC& rc, int fs, int decay) {
  int val = 0, fl = 0;
  int fm = (int)rc.decode_bin(15);
  if (fm >= fs) {
    val += 1;
    fl = fs;
    int ft = 32768 - 2 * 16 - fs;
    fs = ((ft * (16384 - decay)) >> 15) + 1;
    while (fs > 1 && fm >= fl + 2 * fs) {
      fs *= 2;
      fl += fs;
      fs = ((fs - 2) * decay) >> 15;
      fs += 1;
      val += 1;
    }
    if (fs <= 1) {
      int di = (fm - fl) >> 1;
      val += di;
      fl += 2 * di;
    }
    if (fm < fl + fs) val = -val;
    else fl += fs;
  }
  uint32_t fh = fl + fs < 32768 ? fl + fs : 32768;
  rc.update((uint32_t)fl, fh, 32768);
  return val;
}

// ------------------------------------------------------ range encoder
// Port of opus_enc_rc.py RangeEncoder: carry-propagating, entropy
// bytes from the front of a fixed buffer, raw bits LSB-first from the
// end (the layout RC reads).  Exact mirror of the Python encoder,
// which is round-trip-validated against the owned decoder.
struct RE {
  static constexpr uint32_t CODE_TOP = 1u << 31;
  static constexpr uint32_t CODE_BOT = CODE_TOP >> 8;
  static constexpr int CODE_SHIFT = 23;

  std::vector<uint8_t> buf;
  int64_t size, offs, end_offs;
  uint32_t val, rng;
  int rem;        // pending carry byte (-1 = none yet)
  int64_t ext;    // run of 0xFF bytes awaiting carry
  uint64_t end_window;
  int nend_bits, nbits_total;
  bool error;

  void init(int64_t sz) {
    size = sz;
    buf.assign(sz, 0);
    offs = end_offs = 0;
    val = 0;
    rng = CODE_TOP;
    rem = -1;
    ext = 0;
    end_window = 0;
    nend_bits = 0;
    nbits_total = 32 + 1;
    error = false;
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
  void encode_bin(uint32_t fl, uint32_t fh, int ftb) {
    uint32_t r = rng >> ftb;
    if (fl > 0) {
      val += rng - r * ((1u << ftb) - fl);
      rng = r * (fh - fl);
    } else {
      rng -= r * ((1u << ftb) - fh);
    }
    normalize();
  }
  void enc_bit_logp(int bit, int logp) {
    uint32_t r = rng;
    uint32_t s = r >> logp;
    r -= s;
    if (bit) {
      val += r;
      rng = s;
    } else {
      rng = r;
    }
    normalize();
  }
  void enc_cdf(int sym, const std::vector<int64_t>& cdf) {
    uint32_t total = (uint32_t)cdf[0];
    uint32_t fl = sym >= 1 ? (uint32_t)cdf[sym] : 0;
    uint32_t fh = (uint32_t)cdf[sym + 1];
    encode(fl, fh, total);
  }
  void enc_uint(uint64_t t_, uint64_t ft) {
    if (ft <= 1) return;
    int ftb = ilog64(ft - 1);
    if (ftb > 8) {
      ftb -= 8;
      uint32_t ft1 = (uint32_t)(((ft - 1) >> ftb) + 1);
      uint32_t fs = (uint32_t)(t_ >> ftb);
      encode(fs, fs + 1, ft1);
      rawbits((uint32_t)(t_ & ((1ull << ftb) - 1)), ftb);
    } else {
      encode((uint32_t)t_, (uint32_t)t_ + 1, (uint32_t)ft);
    }
  }
  void enc_uint_tri(uint32_t itheta, uint32_t qn) {
    uint32_t half = qn >> 1;
    uint32_t ft = (half + 1) * (half + 1);
    uint32_t fs, fl;
    if (itheta <= half) {
      fs = itheta + 1;
      fl = itheta * (itheta + 1) >> 1;
    } else {
      fs = qn + 1 - itheta;
      fl = ft - ((qn + 1 - itheta) * (qn + 2 - itheta) >> 1);
    }
    encode(fl, fl + fs, ft);
  }
  void enc_uint_step(uint32_t k, uint32_t k0) {
    const uint32_t p0 = 3;
    uint32_t total = (k0 + 1) * p0 + k0;
    uint32_t fl, fh;
    if (k <= k0) {
      fl = p0 * k;
      fh = p0 * (k + 1);
    } else {
      fl = (k - 1 - k0) + (k0 + 1) * p0;
      fh = (k - k0) + (k0 + 1) * p0;
    }
    encode(fl, fh, total);
  }
  void rawbits(uint32_t value, int bits) {
    if (nend_bits + bits > 32) {
      while (nend_bits >= 8) {
        write_byte_at_end((int)(end_window & 0xFF));
        end_window >>= 8;
        nend_bits -= 8;
      }
    }
    end_window |= (uint64_t)(value & ((1ull << bits) - 1)) << nend_bits;
    nend_bits += bits;
    nbits_total += bits;
  }
  int tell() const { return nbits_total - ilog32(rng); }
  int tell_frac() const {
    static const uint32_t corr[8] = {35733, 38967, 42495, 46340,
                                     50535, 55109, 60097, 65535};
    int nbits = nbits_total << 3;
    int l = ilog32(rng);
    uint32_t r = rng >> (l - 16);
    int b = (int)(r >> 12) - 8;
    b += r > corr[b] ? 1 : 0;
    l = (l << 3) + b;
    return nbits - l;
  }
  int64_t total_bits() const { return size * 8; }
  // returns 0 on success (buf holds the full CBR packet)
  int finalize() {
    int l = 32 - ilog32(rng);
    uint32_t msk = (CODE_TOP - 1) >> l;
    uint32_t end = (val + msk) & ~msk;
    if ((end | msk) >= val + rng) {
      l += 1;
      msk >>= 1;
      end = (val + msk) & ~msk;
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
      if (end_offs >= size) {
        error = true;
      } else {
        if (offs + end_offs >= size && -l < used) {
          window &= (1ull << -l) - 1;
          error = true;
        }
        buf[size - end_offs - 1] |= (uint8_t)(window & 0xFF);
      }
    }
    return error ? -1 : 0;
  }
};

// Laplace encoder (opus_enc_rc.py laplace_interval/laplace_encode)
int laplace_encode(RE& rc, int val, int fs0, int decay) {
  constexpr int MINP = 1, NMIN = 16;
  int fl = 0, fs = fs0, coded = 0;
  if (val != 0) {
    bool neg = val < 0;
    int m = neg ? -val : val;
    fl = fs0;
    int64_t ft0 = 32768 - MINP * (2 * NMIN) - fs0;
    fs = (int)((ft0 * (16384 - decay)) >> 15) + MINP;
    int mag = 1;
    while (fs > MINP && mag < m) {
      int nfs = fs * 2;
      int nfl = fl + nfs;
      nfs = ((nfs - 2 * MINP) * decay) >> 15;
      nfs += MINP;
      if (nfl + 2 * nfs > 32768) break;
      fs = nfs;
      fl = nfl;
      mag += 1;
    }
    if (fs <= MINP && mag < m) {
      int di = m - mag;
      int max_di = (32768 - fl - 2 * fs) / (2 * MINP);
      if (di > max_di) di = max_di;
      fl += 2 * di * MINP;
      mag += di;
    }
    if (!neg) fl += fs;
    coded = neg ? -mag : mag;
  }
  uint32_t fh = (uint32_t)(fl + fs) < 32768u ? (uint32_t)(fl + fs) : 32768u;
  rc.encode_bin((uint32_t)fl, fh, 15);
  return coded;
}

// ----------------------------------------------------------- helpers
inline uint32_t lcg(uint32_t seed) {
  return seed * 1664525u + 1013904223u;
}
inline int64_t sdiv(int64_t a, int64_t b) { return a / b; }  // C trunc
inline int frac_mul16(int a, int b) { return (16384 + a * b) >> 15; }

int bitexact_cos(int x) {
  int tmp = (4096 + x * x) >> 13;
  int x2 = tmp;
  x2 = (32767 - x2) + frac_mul16(
      x2, -7651 + frac_mul16(x2, 8277 + frac_mul16(-626, x2)));
  return 1 + x2;
}

int bitexact_log2tan(int isin, int icos) {
  int lc = ilog32((uint32_t)icos);
  int ls = ilog32((uint32_t)isin);
  icos <<= 15 - lc;
  isin <<= 15 - ls;
  return (ls - lc) * (1 << 11)
      + frac_mul16(isin, frac_mul16(isin, -2597) + 7932)
      - frac_mul16(icos, frac_mul16(icos, -2597) + 7932);
}

inline int get_pulses(int i) {
  return i < 8 ? i : (8 + (i & 7)) << ((i >> 3) - 1);
}

void haar1(double* X, int n0, int stride) {
  n0 >>= 1;
  const double s = 1.0 / std::sqrt(2.0);
  for (int i = 0; i < stride; i++)
    for (int j = 0; j < n0; j++) {
      int i1 = stride * 2 * j + i, i2 = i1 + stride;
      double t1 = s * X[i1], t2 = s * X[i2];
      X[i1] = t1 + t2;
      X[i2] = t1 - t2;
    }
}

const int ORDERY2[2] = {1, 0};
const int ORDERY4[4] = {3, 0, 2, 1};
const int ORDERY8[8] = {7, 0, 4, 3, 6, 1, 5, 2};
const int ORDERY16[16] = {15, 0, 8, 7, 12, 3, 11, 4,
                          14, 1, 9, 6, 13, 2, 10, 5};
const int* ordery_for(int stride) {
  switch (stride) {
    case 2: return ORDERY2;
    case 4: return ORDERY4;
    case 8: return ORDERY8;
    case 16: return ORDERY16;
  }
  return nullptr;
}

void deinterleave_hadamard(double* X, int n0, int stride, bool hadamard,
                           double* tmp) {
  int n = n0 * stride;
  if (hadamard) {
    const int* ordery = ordery_for(stride);
    for (int i = 0; i < stride; i++)
      for (int j = 0; j < n0; j++)
        tmp[ordery[i] * n0 + j] = X[i + j * stride];
  } else {
    for (int i = 0; i < stride; i++)
      for (int j = 0; j < n0; j++)
        tmp[i * n0 + j] = X[i + j * stride];
  }
  std::memcpy(X, tmp, n * sizeof(double));
}

void interleave_hadamard(double* X, int n0, int stride, bool hadamard,
                         double* tmp) {
  int n = n0 * stride;
  if (hadamard) {
    const int* ordery = ordery_for(stride);
    for (int i = 0; i < stride; i++)
      for (int j = 0; j < n0; j++)
        tmp[i + j * stride] = X[ordery[i] * n0 + j];
  } else {
    for (int i = 0; i < stride; i++)
      for (int j = 0; j < n0; j++)
        tmp[i + j * stride] = X[i * n0 + j];
  }
  std::memcpy(X, tmp, n * sizeof(double));
}

void exp_rotation1(double* X, int length, int stride, double c, double s) {
  double ms = -s;
  for (int i = 0; i < length - stride; i++) {
    double x1 = X[i], x2 = X[i + stride];
    X[i + stride] = c * x2 + s * x1;
    X[i] = c * x1 + ms * x2;
  }
  for (int i = length - 2 * stride - 1; i >= 0; i--) {
    double x1 = X[i], x2 = X[i + stride];
    X[i + stride] = c * x2 + s * x1;
    X[i] = c * x1 + ms * x2;
  }
}

void exp_rotation(double* X, int length, int direction, int stride,
                  int K, int spread) {
  static const int factors[4] = {0, 15, 10, 5};
  if (2 * K >= length || spread == SPREAD_NONE) return;
  int factor = factors[spread];
  double gain = 1.0 * length / (length + factor * K);
  double theta = 0.5 * gain * gain;
  double c = std::cos(0.5 * M_PI * theta);
  double s = std::cos(0.5 * M_PI * (1.0 - theta));
  int stride2 = 0;
  if (length >= 8 * stride) {
    stride2 = 1;
    while ((stride2 * stride2 + stride2) * stride + (stride >> 2) < length)
      stride2++;
  }
  length /= stride;
  for (int i = 0; i < stride; i++) {
    double* seg = X + i * length;
    if (direction < 0) {
      if (stride2) exp_rotation1(seg, length, stride2, s, c);
      exp_rotation1(seg, length, 1, c, s);
    } else {
      exp_rotation1(seg, length, 1, c, -s);
      if (stride2) exp_rotation1(seg, length, stride2, s, -c);
    }
  }
}

void renormalise(double* X, int N, double gain) {
  double e = 0.0;
  for (int j = 0; j < N; j++) e += X[j] * X[j];
  if (e > 0) {
    double g = gain / std::sqrt(e);
    for (int j = 0; j < N; j++) X[j] *= g;
  }
}

int extract_collapse_mask(const int64_t* iy, int N, int B) {
  if (B <= 1) return 1;
  int n0 = N / B;
  int mask = 0;
  for (int i = 0; i < B; i++) {
    bool any = false;
    for (int j = 0; j < n0; j++)
      if (iy[i * n0 + j] != 0) { any = true; break; }
    if (any) mask |= 1 << i;
  }
  return mask;
}

// ------------------------------------------------------------- PVQ
struct PVQ {
  const Tables& t;
  explicit PVQ(const Tables& tt) : t(tt) {}
  // bounds-checked flat access: valid streams never leave the table
  // (the Python port IndexErrors there); malformed ones read 0
  uint64_t at(int r, int idx) const {
    if (r < 0 || r >= 15 || idx < 0) return 0;
    size_t pos = (size_t)t.pvq_row_off[r] + idx;
    return pos < t.pvq_u.size() ? t.pvq_u[pos] : 0;
  }
  uint64_t U(int n, int k) const {
    int lo = n < k ? n : k, hi = n < k ? k : n;
    if (lo >= 15) return 0;  // matches Python's guarded range
    return at(lo, hi);
  }
  uint64_t V(int n, int k) const { return U(n, k) + U(n, k + 1); }
  // opus_celt.py _PVQ.cwrsi
  void cwrsi(int n, int k, uint64_t i, int64_t* y) const {
    int pos = 0;
    while (n > 2) {
      if (k >= n) {
        uint64_t p = at(n, k + 1);
        int64_t s = i >= p ? -1 : 0;
        if (s) i -= p;
        int k0 = k;
        uint64_t q = at(n, n);
        if (q > i) {
          k = n;
          do {
            k--;
            p = at(k, n);
          } while (p > i && k > 0);
        } else {
          p = at(n, k);
          while (p > i && k > 0) {
            k--;
            p = at(n, k);
          }
        }
        i -= p;
        int64_t val = ((int64_t)(k0 - k) + s) ^ s;
        y[pos++] = val;
      } else {
        uint64_t p = at(k, n);
        uint64_t q = at(k + 1, n);
        if (p <= i && i < q) {
          i -= p;
          y[pos++] = 0;
        } else {
          int64_t s = i >= q ? -1 : 0;
          if (s) i -= q;
          int k0 = k;
          do {
            k--;
            p = at(k, n);
          } while (p > i && k > 0);
          i -= p;
          int64_t val = ((int64_t)(k0 - k) + s) ^ s;
          y[pos++] = val;
        }
      }
      n--;
    }
    // n == 2
    {
      uint64_t p = 2 * (uint64_t)k + 1;
      int64_t s = i >= p ? -1 : 0;
      if (s) i -= p;
      int k0 = k;
      k = (int)((i + 1) >> 1);
      if (k) i -= 2 * (uint64_t)k - 1;
      y[pos++] = ((int64_t)(k0 - k) + s) ^ s;
    }
    // n == 1
    {
      int64_t s = -(int64_t)i;
      y[pos] = ((int64_t)k + s) ^ s;
    }
  }
};

// ------------------------------------------------------------ decoder
struct Celt {
  int channels;
  double oldE[2][NB_BANDS];
  double oldLogE[2][NB_BANDS];
  double oldLogE2[2][NB_BANDS];
  uint32_t rng;
  int pf_period, pf_period_old, pf_tapset, pf_tapset_old;
  double pf_gain, pf_gain_old;

  void reset() {
    std::memset(oldE, 0, sizeof(oldE));
    for (int c = 0; c < 2; c++)
      for (int i = 0; i < NB_BANDS; i++)
        oldLogE[c][i] = oldLogE2[c][i] = -28.0;
    rng = 0;
    pf_period = pf_period_old = 15;
    pf_gain = pf_gain_old = 0.0;
    pf_tapset = pf_tapset_old = 0;
  }
};

struct Ctx {
  RC* rc;
  int spread;
  uint32_t seed;
  int64_t remaining_bits;
  int band, tf_change, B0, intensity;
};

// Allocation in-band coder: the decoder reads the three decisions
// (band skip, intensity, dual stereo) from RC; the encoder scripts
// them (keep all bands / full intensity offset / dual off — the
// opus_celt_enc.py _AllocCoder policy) and writes them through RE, so
// one allocation implementation drives both directions bit-exactly.
struct AllocCoder {
  RC* dec = nullptr;
  RE* enc = nullptr;
  bool saw_uint = false;
  // encode-side band-skip script: trailing bands above skip_to are
  // skipped so their bits redistribute to the occupied spectrum.
  // The skip loop walks down from end_band-1, one band per answered
  // 0, so the band under question is inferred by counting.
  int end_band = NB_BANDS;
  int skip_to = -1;
  int skip_asked = 0;
  int bit_logp(int logp) {
    if (dec) return dec->dec_bit_logp(logp);
    int v;
    if (!saw_uint) {  // skip loop
      int j = end_band - 1 - skip_asked;
      skip_asked++;
      v = (skip_to < 0 || j <= skip_to) ? 1 : 0;
    } else {  // dual-stereo flag: off
      v = 0;
    }
    enc->enc_bit_logp(v, logp);
    return v;
  }
  uint64_t uint_(uint64_t ft) {
    if (dec) return dec->dec_uint(ft);
    saw_uint = true;
    enc->enc_uint(ft - 1, ft);
    return ft - 1;
  }
};

struct Parser {
  Celt* st;
  const Tables& t;
  PVQ pvq;
  bool fail = false;  // malformed-stream guard

  Parser(Celt* s) : st(s), t(g_tables), pvq(g_tables) {}

  // -- energy (opus_celt.py _coarse_energy/_fine_energy/_finalize) --
  void coarse_energy(RC& rc, int start, int end, bool intra, int LM, int C) {
    const int64_t* prob = t.e_prob[LM][intra ? 1 : 0];
    double coef, beta;
    if (intra) {
      coef = 0.0;
      beta = 1.0 - 4915.0 / 32768.0;
    } else {
      coef = t.alpha[LM];
      beta = t.beta[LM];
    }
    int64_t budget = rc.total_bits();
    double prev[2] = {0.0, 0.0};
    for (int i = start; i < end; i++)
      for (int c = 0; c < C; c++) {
        int tell = rc.tell();
        int qi;
        if (budget - tell >= 15) {
          int pi = 2 * (i < 20 ? i : 20);
          qi = laplace_decode(rc, (int)prob[pi] << 7,
                              (int)prob[pi + 1] << 6);
        } else if (budget - tell >= 2) {
          qi = rc.dec_cdf(t.esmall_cdf);
          qi = (qi >> 1) ^ -(qi & 1);
        } else if (budget - tell >= 1) {
          qi = -rc.dec_bit_logp(1);
        } else {
          qi = -1;
        }
        double q = (double)qi;
        double oe = st->oldE[c][i];
        double tmp = coef * (oe > -9.0 ? oe : -9.0) + prev[c] + q;
        st->oldE[c][i] = tmp;
        prev[c] = prev[c] + beta * q;
      }
  }

  void fine_energy(RC& rc, int start, int end, const int64_t* fine_quant,
                   int C) {
    for (int i = start; i < end; i++) {
      if (fine_quant[i] <= 0) continue;
      for (int c = 0; c < C; c++) {
        uint32_t q2 = rc.rawbits((int)fine_quant[i]);
        st->oldE[c][i] += (q2 + 0.5) / (double)(1 << fine_quant[i]) - 0.5;
      }
    }
  }

  void finalize_energy(RC& rc, int start, int end,
                       const int64_t* fine_quant,
                       const int64_t* fine_priority,
                       int64_t bits_left, int C) {
    for (int prio = 0; prio < 2; prio++) {
      int i = start;
      while (i < end && bits_left >= C) {
        if (fine_quant[i] >= MAX_FINE_BITS || fine_priority[i] != prio) {
          i++;
          continue;
        }
        for (int c = 0; c < C; c++) {
          uint32_t q2 = rc.rawbits(1);
          st->oldE[c][i] +=
              ((double)q2 - 0.5) / (double)(1 << (fine_quant[i] + 1));
        }
        bits_left -= C;
        i++;
      }
    }
  }

  // -- allocation helpers --
  int bits2pulses(int band, int LM, int64_t bits) const {
    int64_t off = t.cache_index[(LM + 1) * NB_BANDS + band];
    const int64_t* cache = t.cache_bits + off;
    int lo = 0, hi = (int)cache[0];
    bits -= 1;
    for (int it = 0; it < 6; it++) {
      int mid = (lo + hi + 1) >> 1;
      if (cache[mid] >= bits) hi = mid;
      else lo = mid;
    }
    int64_t lo_val = lo == 0 ? -1 : cache[lo];
    if (bits - lo_val <= cache[hi] - bits) return lo;
    return hi;
  }

  int64_t pulses2bits(int band, int LM, int pulses) const {
    int64_t off = t.cache_index[(LM + 1) * NB_BANDS + band];
    const int64_t* cache = t.cache_bits + off;
    return pulses == 0 ? 0 : cache[pulses] + 1;
  }

  // opus_celt.py _interp_bits2pulses
  void interp_bits2pulses(int start, int end, int skip_start,
                          const int64_t* bits1, const int64_t* bits2,
                          const int64_t* thresh, const int64_t* cap,
                          int64_t total, int64_t skip_rsv,
                          int64_t intensity_rsv, int64_t dual_stereo_rsv,
                          AllocCoder& io, int LM, int C,
                          int64_t* bits, int64_t* ebits,
                          int64_t* fine_priority, int* codedBands_out,
                          int64_t* balance_out, int* intensity_out,
                          int* dual_stereo_out) {
    const int64_t* eBands = t.eBands;
    int64_t alloc_floor = (int64_t)C << BITRES;
    int stereo = C > 1 ? 1 : 0;
    int64_t logM = (int64_t)LM << BITRES;
    std::memset(bits, 0, NB_BANDS * sizeof(int64_t));
    std::memset(ebits, 0, NB_BANDS * sizeof(int64_t));
    std::memset(fine_priority, 0, NB_BANDS * sizeof(int64_t));

    int64_t lo = 0, hi = 1 << ALLOC_STEPS;
    for (int it = 0; it < ALLOC_STEPS; it++) {
      int64_t mid = (lo + hi) >> 1;
      int64_t psum = 0;
      bool done = false;
      for (int j = end - 1; j >= start; j--) {
        int64_t tmp = bits1[j] + ((mid * bits2[j]) >> ALLOC_STEPS);
        if (tmp >= thresh[j] || done) {
          done = true;
          psum += tmp < cap[j] ? tmp : cap[j];
        } else if (tmp >= alloc_floor) {
          psum += alloc_floor;
        }
      }
      if (psum > total) hi = mid;
      else lo = mid;
    }
    int64_t psum = 0;
    bool done = false;
    for (int j = end - 1; j >= start; j--) {
      int64_t tmp = bits1[j] + ((lo * bits2[j]) >> ALLOC_STEPS);
      if (tmp < thresh[j] && !done) {
        tmp = tmp >= alloc_floor ? alloc_floor : 0;
      } else {
        done = true;
      }
      tmp = tmp < cap[j] ? tmp : cap[j];
      bits[j] = tmp;
      psum += tmp;
    }

    int codedBands = end;
    while (true) {
      int j = codedBands - 1;
      if (j <= skip_start) {
        total += skip_rsv;
        break;
      }
      int64_t left = total - psum;
      int64_t span = eBands[codedBands] - eBands[start];
      int64_t percoeff = left / span;
      left -= span * percoeff;
      int64_t rem = left - (eBands[j] - eBands[start]);
      if (rem < 0) rem = 0;
      int64_t band_width = eBands[codedBands] - eBands[j];
      int64_t band_bits = bits[j] + percoeff * band_width + rem;
      int64_t th = thresh[j] > alloc_floor + (1 << BITRES)
          ? thresh[j] : alloc_floor + (1 << BITRES);
      if (band_bits >= th) {
        if (io.bit_logp(1)) break;
        psum += 1 << BITRES;
        band_bits -= 1 << BITRES;
      }
      psum -= bits[j] + intensity_rsv;
      if (intensity_rsv > 0)
        intensity_rsv = t.log2_frac[j - start];
      psum += intensity_rsv;
      if (band_bits >= alloc_floor) {
        psum += alloc_floor;
        bits[j] = alloc_floor;
      } else {
        bits[j] = 0;
      }
      codedBands--;
    }

    int intensity = 0;
    if (intensity_rsv > 0)
      intensity = start + (int)io.uint_(codedBands + 1 - start);
    if (intensity <= start) {
      total += dual_stereo_rsv;
      dual_stereo_rsv = 0;
    }
    int dual_stereo = dual_stereo_rsv > 0 ? io.bit_logp(1) : 0;

    int64_t left = total - psum;
    int64_t span = eBands[codedBands] - eBands[start];
    int64_t percoeff = left / span;
    left -= span * percoeff;
    for (int j = start; j < codedBands; j++)
      bits[j] += percoeff * (eBands[j + 1] - eBands[j]);
    for (int j = start; j < codedBands; j++) {
      int64_t tmp = left < eBands[j + 1] - eBands[j]
          ? left : eBands[j + 1] - eBands[j];
      bits[j] += tmp;
      left -= tmp;
    }

    int64_t balance = 0;
    for (int j = start; j < codedBands; j++) {
      int64_t N0 = eBands[j + 1] - eBands[j];
      int64_t N = N0 << LM;
      int64_t bit = bits[j] + balance;
      int64_t excess = 0;
      if (N > 1) {
        excess = bit - cap[j];
        if (excess < 0) excess = 0;
        bits[j] = bit - excess;
        int64_t den = (int64_t)C * N +
            ((C == 2 && N > 2 && !dual_stereo && j < intensity) ? 1 : 0);
        int64_t NClogN = den * (t.logN[j] + logM);
        int64_t offset = (NClogN >> 1) - den * FINE_OFFSET;
        if (N == 2) offset += (den << BITRES) >> 2;
        if (bits[j] + offset < (den * 2) << BITRES)
          offset += NClogN >> 2;
        else if (bits[j] + offset < (den * 3) << BITRES)
          offset += NClogN >> 3;
        int64_t num = bits[j] + offset + (den << (BITRES - 1));
        if (num < 0) num = 0;
        ebits[j] = num / (den << BITRES);
        if ((int64_t)C * ebits[j] << BITRES > bits[j])
          ebits[j] = bits[j] >> stereo >> BITRES;
        if (ebits[j] > MAX_FINE_BITS) ebits[j] = MAX_FINE_BITS;
        fine_priority[j] =
            ebits[j] * (den << BITRES) >= bits[j] + offset ? 1 : 0;
        bits[j] -= (int64_t)C * ebits[j] << BITRES;
      } else {
        excess = bit - ((int64_t)C << BITRES);
        if (excess < 0) excess = 0;
        bits[j] = bit - excess;
        ebits[j] = 0;
        fine_priority[j] = 1;
      }
      if (excess > 0) {
        int64_t extra_fine = excess >> (stereo + BITRES);
        if (extra_fine > MAX_FINE_BITS - ebits[j])
          extra_fine = MAX_FINE_BITS - ebits[j];
        ebits[j] += extra_fine;
        int64_t extra_bits = extra_fine * C << BITRES;
        fine_priority[j] = extra_bits >= excess - balance ? 1 : 0;
        excess -= extra_bits;
      }
      balance = excess;
    }
    for (int j = codedBands; j < end; j++) {
      ebits[j] = bits[j] >> stereo >> BITRES;
      bits[j] = 0;
      fine_priority[j] = ebits[j] < 1 ? 1 : 0;
    }
    *codedBands_out = codedBands;
    *balance_out = balance;
    *intensity_out = intensity;
    *dual_stereo_out = dual_stereo;
  }

  // opus_celt.py _compute_allocation
  void compute_allocation(int start, int end, const int64_t* offsets,
                          const int64_t* cap, int alloc_trim,
                          int64_t total, AllocCoder& io, int LM, int C,
                          int64_t* bits, int64_t* ebits,
                          int64_t* fine_priority, int* codedBands_out,
                          int64_t* balance_out, int* intensity_out,
                          int* dual_stereo_out) {
    const int64_t* eBands = t.eBands;
    if (total < 0) total = 0;
    int skip_start = start;
    int64_t skip_rsv = total >= (1 << BITRES) ? (1 << BITRES) : 0;
    total -= skip_rsv;
    int64_t intensity_rsv = 0, dual_stereo_rsv = 0;
    if (C == 2) {
      intensity_rsv = t.log2_frac[end - start];
      if (intensity_rsv > total) {
        intensity_rsv = 0;
      } else {
        total -= intensity_rsv;
        dual_stereo_rsv = total >= (1 << BITRES) ? (1 << BITRES) : 0;
        total -= dual_stereo_rsv;
      }
    }
    int64_t thresh[NB_BANDS] = {0}, trim_offset[NB_BANDS] = {0};
    for (int j = start; j < end; j++) {
      int64_t w = eBands[j + 1] - eBands[j];
      int64_t th = (3 * w << LM << BITRES) >> 4;
      int64_t fl = (int64_t)C << BITRES;
      thresh[j] = th > fl ? th : fl;
      trim_offset[j] = (C * w * (alloc_trim - 5 - LM) * (end - j - 1) *
                        ((int64_t)1 << (LM + BITRES))) >> 6;
      if ((w << LM) == 1) trim_offset[j] -= (int64_t)C << BITRES;
    }
    int64_t lo = 1, hi = t.static_alloc_rows - 1;
    while (lo <= hi) {
      int64_t mid = (lo + hi) >> 1;
      int64_t psum = 0;
      bool done = false;
      for (int j = end - 1; j >= start; j--) {
        int64_t bitsj = ((int64_t)C * (eBands[j + 1] - eBands[j]) *
                         t.static_alloc[mid][j] << LM) >> 2;
        if (bitsj > 0) {
          bitsj += trim_offset[j];
          if (bitsj < 0) bitsj = 0;
        }
        bitsj += offsets[j];
        if (bitsj >= thresh[j] || done) {
          done = true;
          psum += bitsj < cap[j] ? bitsj : cap[j];
        } else if (bitsj >= (int64_t)C << BITRES) {
          psum += (int64_t)C << BITRES;
        }
      }
      if (psum > total) hi = mid - 1;
      else lo = mid + 1;
    }
    hi = lo;
    lo -= 1;
    int64_t bits1[NB_BANDS] = {0}, bits2[NB_BANDS] = {0};
    for (int j = start; j < end; j++) {
      int64_t N = eBands[j + 1] - eBands[j];
      int64_t b1 = ((int64_t)C * N * t.static_alloc[lo][j] << LM) >> 2;
      int64_t b2 = hi >= t.static_alloc_rows
          ? cap[j]
          : ((int64_t)C * N * t.static_alloc[hi][j] << LM) >> 2;
      if (b1 > 0) {
        b1 += trim_offset[j];
        if (b1 < 0) b1 = 0;
      }
      if (b2 > 0) {
        b2 += trim_offset[j];
        if (b2 < 0) b2 = 0;
      }
      if (lo > 0) b1 += offsets[j];
      b2 += offsets[j];
      if (offsets[j] > 0) skip_start = j;
      b2 = b2 - b1 > 0 ? b2 - b1 : 0;
      bits1[j] = b1;
      bits2[j] = b2;
    }
    interp_bits2pulses(start, end, skip_start, bits1, bits2, thresh, cap,
                       total, skip_rsv, intensity_rsv, dual_stereo_rsv,
                       io, LM, C, bits, ebits, fine_priority,
                       codedBands_out, balance_out, intensity_out,
                       dual_stereo_out);
  }

  // -- PVQ band decode --
  int alg_unquant(double* X, int N, int K, int spread, int B, RC& rc,
                  double gain) {
    if (N > 512) { fail = true; return 1; }  // max leaf N is 352 (LM=3)
    uint64_t idx = rc.dec_uint(pvq.V(N, K));
    int64_t iy[512];
    pvq.cwrsi(N, K, idx, iy);
    double Ryy = 0.0;
    for (int j = 0; j < N; j++) Ryy += (double)iy[j] * (double)iy[j];
    double g = gain / std::sqrt(Ryy);
    for (int j = 0; j < N; j++) X[j] = iy[j] * g;
    exp_rotation(X, N, -1, B, K, spread);
    return extract_collapse_mask(iy, N, B);
  }

  int compute_qn(int N, int64_t b, int64_t offset, int64_t pulse_cap,
                 bool stereo) const {
    int N2 = 2 * N - 1;
    if (stereo && N == 2) N2--;
    int64_t qb = sdiv(b + N2 * offset, N2);
    int64_t cap = b - pulse_cap - (4 << BITRES);
    if (cap < qb) qb = cap;
    if (qb > (8 << BITRES)) qb = 8 << BITRES;
    if (qb < (1 << BITRES >> 1)) return 1;
    int qn = (int)(t.qn_exp2[qb & 0x7] >> (14 - (qb >> BITRES)));
    return ((qn + 1) >> 1) << 1;
  }

  // opus_celt.py _compute_theta; returns via out-params
  void compute_theta(Ctx& ctx, int N, int64_t b, int B, int B0, int LM,
                     int& fill, bool stereo, int* itheta_out,
                     int64_t* delta_out, int* qalloc_out, int* inv_out) {
    RC& rc = *ctx.rc;
    int band = ctx.band;
    int64_t pulse_cap = t.logN[band] + (int64_t)LM * (1 << BITRES);
    int64_t offset = (pulse_cap >> 1) - ((stereo && N == 2) ? 16 : 4);
    int qn = compute_qn(N, b, offset, pulse_cap, stereo);
    if (stereo && band >= ctx.intensity) qn = 1;
    int tell = rc.tell_frac();
    int itheta = 0;
    int inv = 0;
    if (qn != 1) {
      if (stereo && N > 2) {
        // step pdf: p0 below the midpoint, 1 above
        const uint32_t p0 = 3;
        uint32_t x0 = qn >> 1;
        uint32_t ft = p0 * (x0 + 1) + x0;
        uint32_t fs = rc.decode(ft);
        uint32_t x = fs < (x0 + 1) * p0 ? fs / p0
                                        : x0 + 1 + (fs - (x0 + 1) * p0);
        uint32_t fl = x <= x0 ? p0 * x : (x - 1 - x0) + (x0 + 1) * p0;
        uint32_t fh = x <= x0 ? p0 * (x + 1) : (x - x0) + (x0 + 1) * p0;
        rc.update(fl, fh, ft);
        itheta = (int)x;
      } else if (B0 > 1 || stereo) {
        itheta = (int)rc.dec_uint(qn + 1);
      } else {
        itheta = (int)rc.dec_uint_tri(qn);
      }
      itheta = (int)(((int64_t)itheta * 16384) / qn);
    } else if (stereo) {
      inv = (b > 2 << BITRES && ctx.remaining_bits > 2 << BITRES)
          ? rc.dec_bit_logp(2) : 0;
      itheta = 0;
    }
    int qalloc = rc.tell_frac() - tell;
    int64_t delta;
    if (itheta == 0) {
      delta = -16384;
      fill &= (1 << B) - 1;
    } else if (itheta == 16384) {
      delta = 16384;
      fill &= ((1 << B) - 1) << B;
    } else {
      int imid = bitexact_cos(itheta);
      int iside = bitexact_cos(16384 - itheta);
      delta = frac_mul16((N - 1) << 7, bitexact_log2tan(iside, imid));
    }
    *itheta_out = itheta;
    *delta_out = delta;
    *qalloc_out = qalloc;
    *inv_out = inv;
  }

  int quant_band_n1(Ctx& ctx, double* X, double* Y, double* lowband_out) {
    RC& rc = *ctx.rc;
    double* x = X;
    for (int rep = 0; rep < (Y ? 2 : 1); rep++) {
      int sign = 0;
      if (ctx.remaining_bits >= 1 << BITRES) {
        sign = (int)rc.rawbits(1);
        ctx.remaining_bits -= 1 << BITRES;
      }
      x[0] = sign ? -1.0 : 1.0;
      x = Y;
    }
    if (lowband_out) lowband_out[0] = X[0];
    return 1;
  }

  void stereo_merge(double* X, double* Y, double mid, int N) {
    double xp = 0.0, side = 0.0;
    for (int j = 0; j < N; j++) {
      xp += X[j] * Y[j];
      side += Y[j] * Y[j];
    }
    xp *= mid;
    double El = mid * mid + side - 2.0 * xp;
    double Er = mid * mid + side + 2.0 * xp;
    if (Er < 6e-4 || El < 6e-4) {
      for (int j = 0; j < N; j++) Y[j] = X[j];
      return;
    }
    double lgain = 1.0 / std::sqrt(El);
    double rgain = 1.0 / std::sqrt(Er);
    for (int j = 0; j < N; j++) {
      double l = mid * X[j];
      double r = Y[j];
      X[j] = lgain * (l - r);
      Y[j] = rgain * (l + r);
    }
  }

  // opus_celt.py _quant_partition
  int quant_partition(Ctx& ctx, double* X, int N, int64_t b, int B,
                      double* lowband, int LM, double gain, int fill) {
    if (fail) return 0;
    int band = ctx.band;
    int64_t off = t.cache_index[(LM + 1) * NB_BANDS + band];
    const int64_t* cache = t.cache_bits + off;
    if (LM != -1 && b > cache[cache[0]] + 12 && N > 2) {
      int B0 = B;
      N >>= 1;
      double* Y = X + N;
      LM -= 1;
      if (B == 1) fill = (fill & 1) | (fill << 1);
      B = (B + 1) >> 1;
      int itheta, qalloc, inv;
      int64_t delta;
      compute_theta(ctx, N, b, B, B0, LM, fill, false, &itheta, &delta,
                    &qalloc, &inv);
      double mid, side;
      if (itheta == 0) {
        mid = 32767 / 32768.0;
        side = 0.0;
      } else if (itheta == 16384) {
        mid = 0.0;
        side = 32767 / 32768.0;
      } else {
        mid = bitexact_cos(itheta) / 32768.0;
        side = bitexact_cos(16384 - itheta) / 32768.0;
      }
      if (B0 > 1 && (itheta & 0x3FFF)) {
        if (itheta > 8192) {
          delta -= delta >> (4 - LM);
        } else {
          int64_t d2 = delta + ((int64_t)N << BITRES >> (5 - LM));
          delta = d2 < 0 ? d2 : 0;
        }
      }
      b -= qalloc;
      int64_t mbits = sdiv(b - delta, 2);
      if (mbits > b) mbits = b;
      if (mbits < 0) mbits = 0;
      int64_t sbits = b - mbits;
      ctx.remaining_bits -= qalloc;
      int64_t rebalance = ctx.remaining_bits;
      int cm;
      if (mbits >= sbits) {
        cm = quant_partition(ctx, X, N, mbits, B, lowband, LM,
                             gain * mid, fill);
        rebalance = mbits - (rebalance - ctx.remaining_bits);
        if (rebalance > 3 << BITRES && itheta != 0)
          sbits += rebalance - (3 << BITRES);
        double* next_lb = lowband ? lowband + N : nullptr;
        cm |= quant_partition(ctx, Y, N, sbits, B, next_lb, LM,
                              gain * side, fill >> B) << (B0 >> 1);
      } else {
        double* next_lb = lowband ? lowband + N : nullptr;
        cm = quant_partition(ctx, Y, N, sbits, B, next_lb, LM,
                             gain * side, fill >> B) << (B0 >> 1);
        rebalance = sbits - (rebalance - ctx.remaining_bits);
        if (rebalance > 3 << BITRES && itheta != 16384)
          mbits += rebalance - (3 << BITRES);
        cm |= quant_partition(ctx, X, N, mbits, B, lowband, LM,
                              gain * mid, fill);
      }
      return cm;
    }
    // leaf: PVQ or folding
    int q = bits2pulses(band, LM, b);
    int64_t curr_bits = pulses2bits(band, LM, q);
    ctx.remaining_bits -= curr_bits;
    while (ctx.remaining_bits < 0 && q > 0) {
      ctx.remaining_bits += curr_bits;
      q--;
      curr_bits = pulses2bits(band, LM, q);
      ctx.remaining_bits -= curr_bits;
    }
    if (q != 0) {
      int K = get_pulses(q);
      return alg_unquant(X, N, K, ctx.spread, B, *ctx.rc, gain);
    }
    int cm_mask = (1 << B) - 1;
    fill &= cm_mask;
    if (!fill) {
      std::memset(X, 0, N * sizeof(double));
      return 0;
    }
    uint32_t seed = ctx.seed;
    int cm;
    if (!lowband) {
      for (int j = 0; j < N; j++) {
        seed = lcg(seed);
        X[j] = (double)((int32_t)seed >> 20);
      }
      cm = cm_mask;
    } else {
      for (int j = 0; j < N; j++) {
        seed = lcg(seed);
        double tmp = 1.0 / 256.0;
        if (!(seed & 0x8000)) tmp = -tmp;
        X[j] = lowband[j] + tmp;
      }
      cm = fill;
    }
    ctx.seed = seed;
    renormalise(X, N, gain);
    return cm;
  }

  // opus_celt.py _quant_band_stereo
  int quant_band_stereo(Ctx& ctx, double* X, double* Y, int N, int64_t b,
                        int B, double* lowband, int LM,
                        double* lowband_out, double* lowband_scratch,
                        int fill) {
    if (N == 1) return quant_band_n1(ctx, X, Y, lowband_out);
    RC& rc = *ctx.rc;
    int orig_fill = fill;
    int itheta, qalloc, inv;
    int64_t delta;
    compute_theta(ctx, N, b, B, B, LM, fill, true, &itheta, &delta,
                  &qalloc, &inv);
    b -= qalloc;
    double mid, side;
    if (itheta == 0) {
      mid = 32767 / 32768.0;
      side = 0.0;
    } else if (itheta == 16384) {
      mid = 0.0;
      side = 32767 / 32768.0;
    } else {
      mid = bitexact_cos(itheta) / 32768.0;
      side = bitexact_cos(16384 - itheta) / 32768.0;
    }
    int cm;
    if (N == 2) {
      int64_t mbits = b;
      int64_t sbits = (itheta != 0 && itheta != 16384) ? (1 << BITRES) : 0;
      mbits -= sbits;
      bool c = itheta > 8192;
      ctx.remaining_bits -= qalloc + sbits;
      double* x2 = c ? Y : X;
      double* y2 = c ? X : Y;
      int sign = sbits ? (int)rc.rawbits(1) : 0;
      sign = 1 - 2 * sign;
      cm = quant_band(ctx, x2, N, mbits, B, lowband, LM, lowband_out,
                      1.0, lowband_scratch, orig_fill);
      y2[0] = -sign * x2[1];
      y2[1] = sign * x2[0];
      X[0] = mid * X[0];
      X[1] = mid * X[1];
      Y[0] = side * Y[0];
      Y[1] = side * Y[1];
      double tmp = X[0];
      X[0] = tmp - Y[0];
      Y[0] = tmp + Y[0];
      tmp = X[1];
      X[1] = tmp - Y[1];
      Y[1] = tmp + Y[1];
    } else {
      int64_t mbits = sdiv(b - delta, 2);
      if (mbits > b) mbits = b;
      if (mbits < 0) mbits = 0;
      int64_t sbits = b - mbits;
      ctx.remaining_bits -= qalloc;
      int64_t rebalance = ctx.remaining_bits;
      if (mbits >= sbits) {
        cm = quant_band(ctx, X, N, mbits, B, lowband, LM, lowband_out,
                        1.0, lowband_scratch, fill);
        rebalance = mbits - (rebalance - ctx.remaining_bits);
        if (rebalance > 3 << BITRES && itheta != 0)
          sbits += rebalance - (3 << BITRES);
        cm |= quant_band(ctx, Y, N, sbits, B, nullptr, LM, nullptr,
                         side, nullptr, fill >> B);
      } else {
        cm = quant_band(ctx, Y, N, sbits, B, nullptr, LM, nullptr,
                        side, nullptr, fill >> B);
        rebalance = sbits - (rebalance - ctx.remaining_bits);
        if (rebalance > 3 << BITRES && itheta != 16384)
          mbits += rebalance - (3 << BITRES);
        cm |= quant_band(ctx, X, N, mbits, B, lowband, LM, lowband_out,
                         1.0, lowband_scratch, fill);
      }
      stereo_merge(X, Y, mid, N);
    }
    if (inv)
      for (int j = 0; j < N; j++) Y[j] = -Y[j];
    return cm;
  }

  // opus_celt.py _quant_band
  int quant_band(Ctx& ctx, double* X, int N, int64_t b, int B,
                 double* lowband, int LM, double* lowband_out,
                 double gain, double* lowband_scratch, int fill) {
    if (fail) return 0;
    int N0 = N;
    int N_B = N / B;
    int B0 = B;
    int time_divide = 0;
    int recombine = 0;
    bool longBlocks = B0 == 1;
    if (N == 1) return quant_band_n1(ctx, X, nullptr, lowband_out);
    int tf_change = ctx.tf_change;
    if (tf_change > 0) recombine = tf_change;
    if (lowband_scratch && lowband &&
        (recombine || ((N_B & 1) == 0 && tf_change < 0) || B0 > 1)) {
      std::memcpy(lowband_scratch, lowband, N * sizeof(double));
      lowband = lowband_scratch;
    }
    for (int k = 0; k < recombine; k++) {
      if (lowband) haar1(lowband, N >> k, 1 << k);
      fill = (int)(t.bit_interleave[fill & 0xF] |
                   t.bit_interleave[fill >> 4] << 2);
    }
    B >>= recombine;
    N_B <<= recombine;
    while ((N_B & 1) == 0 && tf_change < 0) {
      if (lowband) haar1(lowband, N_B, B);
      fill |= fill << B;
      B <<= 1;
      N_B >>= 1;
      time_divide++;
      tf_change++;
    }
    B0 = B;
    int N_B0 = N_B;
    double tmpbuf[1408];
    if (B0 > 1 && lowband)
      deinterleave_hadamard(lowband, N_B >> recombine,
                            B0 << recombine, longBlocks, tmpbuf);
    ctx.B0 = B0;
    int cm = quant_partition(ctx, X, N, b, B, lowband, LM, gain, fill);
    if (B0 > 1)
      interleave_hadamard(X, N_B >> recombine, B0 << recombine,
                          longBlocks, tmpbuf);
    B = B0;
    N_B = N_B0;
    while (time_divide > 0) {
      B >>= 1;
      N_B <<= 1;
      cm |= cm >> B;
      haar1(X, N_B, B);
      time_divide--;
    }
    for (int k = 0; k < recombine; k++) {
      cm = (int)t.bit_deinterleave[cm];
      haar1(X, N0 >> k, 1 << k);
    }
    B <<= recombine;
    if (lowband_out) {
      double n = std::sqrt((double)N0);
      for (int j = 0; j < N0; j++) lowband_out[j] = n * X[j];
    }
    cm &= (1 << B) - 1;
    return cm;
  }

  // opus_celt.py _quant_all_bands
  void quant_all_bands(RC& rc, int start, int end, double* X_, double* Y_,
                       const int64_t* pulses, bool shortBlocks, int spread,
                       const int64_t* tf_res, int64_t total_bits,
                       int64_t balance, int LM, int codedBands,
                       int intensity, int dual_stereo,
                       int64_t collapse_masks[2][NB_BANDS]) {
    int C = Y_ ? 2 : 1;
    int M = 1 << LM;
    const int64_t* eBands = t.eBands;
    int B = shortBlocks ? M : 1;
    int64_t norm_offset = M * eBands[start];
    int64_t norm_size = M * eBands[NB_BANDS - 1] - norm_offset;
    std::vector<double> norm(norm_size, 0.0);
    std::vector<double> norm2(C == 2 ? norm_size : 0, 0.0);
    std::vector<double> lowband_scratch(M * 176, 0.0);
    std::memset(collapse_masks, 0, 2 * NB_BANDS * sizeof(int64_t));
    int lowband_offset = 0;
    bool update_lowband = true;
    Ctx ctx;
    ctx.rc = &rc;
    ctx.spread = spread;
    ctx.seed = st->rng;
    ctx.remaining_bits = 0;
    ctx.band = 0;
    ctx.tf_change = 0;
    ctx.B0 = B;
    ctx.intensity = intensity;
    for (int i = start; i < end && !fail; i++) {
      bool last = i == end - 1;
      int64_t effective_lowband = -1;
      double* X = X_ + M * eBands[i];
      double* Y = C == 2 ? Y_ + M * eBands[i] : nullptr;
      int N = (int)(M * (eBands[i + 1] - eBands[i]));
      int tell = rc.tell_frac();
      if (i != start) balance -= tell;
      int64_t remaining_bits = total_bits - tell - 1;
      ctx.remaining_bits = remaining_bits;
      ctx.band = i;
      int64_t b;
      if (i <= codedBands - 1) {
        int64_t den = codedBands - i < 3 ? codedBands - i : 3;
        int64_t curr_balance = sdiv(balance, den);
        b = pulses[i] + curr_balance;
        if (b > remaining_bits + 1) b = remaining_bits + 1;
        if (b > 16383) b = 16383;
        if (b < 0) b = 0;
      } else {
        b = 0;
      }
      if (M * eBands[i] - N >= M * eBands[start] &&
          (update_lowband || lowband_offset == 0))
        lowband_offset = i;
      int tf_change = (int)tf_res[i];
      ctx.tf_change = tf_change;
      int x_cm, y_cm;
      if (lowband_offset != 0 &&
          (spread != SPREAD_AGGRESSIVE || B > 1 || tf_change < 0)) {
        effective_lowband = M * eBands[lowband_offset] - norm_offset - N;
        if (effective_lowband < 0) effective_lowband = 0;
        int fold_start = lowband_offset;
        do {
          fold_start--;
        } while (M * eBands[fold_start] > effective_lowband + norm_offset);
        int fold_end = lowband_offset - 1;
        do {
          fold_end++;
        } while (M * eBands[fold_end] < effective_lowband + norm_offset + N);
        x_cm = y_cm = 0;
        int fold_i = fold_start;
        do {
          x_cm |= (int)collapse_masks[0][fold_i];
          y_cm |= (int)collapse_masks[C - 1][fold_i];
          fold_i++;
        } while (fold_i < fold_end);
      } else {
        x_cm = y_cm = (1 << B) - 1;
      }
      double* lowband =
          effective_lowband != -1 ? norm.data() + effective_lowband : nullptr;
      double* lowband2 = (C == 2 && effective_lowband != -1)
          ? norm2.data() + effective_lowband : nullptr;
      double* lowband_out =
          last ? nullptr : norm.data() + (M * eBands[i] - norm_offset);
      double* lowband_out2 = (last || C == 1)
          ? nullptr : norm2.data() + (M * eBands[i] - norm_offset);
      if (dual_stereo && i == intensity) {
        dual_stereo = 0;
        int64_t upto = M * eBands[i] - norm_offset;
        for (int64_t j = 0; j < upto; j++)
          norm[j] = 0.5 * (norm[j] + norm2[j]);
      }
      if (dual_stereo) {
        x_cm = quant_band(ctx, X, N, b / 2, B, lowband, LM, lowband_out,
                          1.0, lowband_scratch.data(), x_cm);
        y_cm = quant_band(ctx, Y, N, b / 2, B, lowband2, LM, lowband_out2,
                          1.0, lowband_scratch.data(), y_cm);
      } else {
        if (C == 2) {
          x_cm = quant_band_stereo(ctx, X, Y, N, b, B, lowband, LM,
                                   lowband_out, lowband_scratch.data(),
                                   x_cm | y_cm);
        } else {
          x_cm = quant_band(ctx, X, N, b, B, lowband, LM, lowband_out,
                            1.0, lowband_scratch.data(), x_cm | y_cm);
        }
        y_cm = x_cm;
      }
      collapse_masks[0][i] = x_cm;
      collapse_masks[C - 1][i] = y_cm;
      balance += pulses[i] + tell;
      update_lowband = b > ((int64_t)N << BITRES);
    }
    st->rng = ctx.seed;
  }

  // opus_celt.py _anti_collapse (channel-outer order)
  void anti_collapse(double X[2][1608],
                     int64_t collapse_masks[2][NB_BANDS],
                     int LM, int start, int end, const int64_t* pulses,
                     int C, int cm_channels) {
    const int64_t* eBands = t.eBands;
    uint32_t seed = st->rng;
    for (int c = 0; c < C; c++) {
      for (int i = start; i < end; i++) {
        int N0 = (int)(eBands[i + 1] - eBands[i]);
        int depth = (int)(((1 + pulses[i]) / N0) >> LM);
        double thresh = 0.5 * std::pow(2.0, -0.125 * depth);
        double sqrt_1 = 1.0 / std::sqrt((double)(N0 << LM));
        double prev1 = st->oldLogE[c][i];
        double prev2 = st->oldLogE2[c][i];
        if (C == 1 && st->channels > 1) {
          if (st->oldLogE[1][i] > prev1) prev1 = st->oldLogE[1][i];
          if (st->oldLogE2[1][i] > prev2) prev2 = st->oldLogE2[1][i];
        }
        double mn = prev1 < prev2 ? prev1 : prev2;
        double Ediff = st->oldE[c][i] - mn;
        if (Ediff < 0.0) Ediff = 0.0;
        double r = 2.0 * std::pow(2.0, -Ediff);
        if (LM == 3) r *= 1.41421356;
        r = (r < thresh ? r : thresh) * sqrt_1;
        double* band = &X[c][(size_t)(eBands[i] << LM)];
        bool renorm = false;
        int mask = (int)collapse_masks[cm_channels == 2 ? c : 0][i];
        for (int k = 0; k < (1 << LM); k++) {
          if (!(mask & (1 << k))) {
            for (int j = 0; j < N0; j++) {
              seed = lcg(seed);
              band[(j << LM) + k] = (seed & 0x8000) ? r : -r;
            }
            renorm = true;
          }
        }
        if (renorm)
          renormalise(band, N0 << LM, 1.0);
      }
    }
    st->rng = seed;
  }

  void post_frame_energy(int start, int end, bool isTransient, int C) {
    if (!isTransient) {
      for (int c = 0; c < C; c++)
        for (int i = 0; i < NB_BANDS; i++) {
          st->oldLogE2[c][i] = st->oldLogE[c][i];
          st->oldLogE[c][i] = st->oldE[c][i];
        }
    } else {
      for (int c = 0; c < C; c++)
        for (int i = 0; i < NB_BANDS; i++)
          if (st->oldE[c][i] < st->oldLogE[c][i])
            st->oldLogE[c][i] = st->oldE[c][i];
    }
    for (int c = 0; c < C; c++)
      for (int i = 0; i < NB_BANDS; i++)
        if (i < start || i >= end) {
          st->oldE[c][i] = 0.0;
          st->oldLogE[c][i] = -28.0;
          st->oldLogE2[c][i] = -28.0;
        }
  }

  void pack_comb(int new_period, double new_gain, int new_tapset,
                 double* out) {
    // pre-rotation state (ops/celt_batch.py pack_comb_params layout)
    const double (*taps)[3] = t.pf_taps;
    int p_old = st->pf_period_old, p_cur = st->pf_period;
    double g_old = st->pf_gain_old, g_cur = st->pf_gain;
    int t_old = st->pf_tapset_old, t_cur = st->pf_tapset;
    out[0] = p_old > 15 ? p_old : 15;
    out[1] = p_cur > 15 ? p_cur : 15;
    for (int j = 0; j < 3; j++) out[2 + j] = g_old * taps[t_old][j];
    for (int j = 0; j < 3; j++) out[5 + j] = g_cur * taps[t_cur][j];
    out[8] = p_cur > 15 ? p_cur : 15;
    out[9] = new_period > 15 ? new_period : 15;
    for (int j = 0; j < 3; j++) out[10 + j] = g_cur * taps[t_cur][j];
    for (int j = 0; j < 3; j++) out[13 + j] = new_gain * taps[new_tapset][j];
  }

  void rotate_pf(int new_period, double new_gain, int new_tapset, int LM) {
    st->pf_period_old = st->pf_period;
    st->pf_gain_old = st->pf_gain;
    st->pf_tapset_old = st->pf_tapset;
    st->pf_period = new_period;
    st->pf_gain = new_gain;
    st->pf_tapset = new_tapset;
    if (LM != 0) {
      st->pf_period_old = st->pf_period;
      st->pf_gain_old = st->pf_gain;
      st->pf_tapset_old = st->pf_tapset;
    }
  }

  // ================= encode direction (opus_celt_enc.py port) =======
  // Encoder context: same fields as Ctx plus the band energies the
  // intensity projection needs, over the encode-side coder.
  struct CtxE {
    RE* rc;
    int spread;
    uint32_t seed;
    int64_t remaining_bits;
    int band, tf_change, B0, intensity;
    const double* bandE;  // [2 * NB_BANDS]
  };

  void coarse_energy_enc(RE& rc, int start, int end, bool intra, int LM,
                         const double* band_log_e, int C) {
    const int64_t* prob = t.e_prob[LM][intra ? 1 : 0];
    double coef, beta;
    if (intra) {
      coef = 0.0;
      beta = 1.0 - 4915.0 / 32768.0;
    } else {
      coef = t.alpha[LM];
      beta = t.beta[LM];
    }
    int64_t budget = rc.total_bits();
    double prev[2] = {0.0, 0.0};
    for (int i = start; i < end; i++)
      for (int c = 0; c < C; c++) {
        double x = band_log_e[c * NB_BANDS + i];
        double oe = st->oldE[c][i] > -9.0 ? st->oldE[c][i] : -9.0;
        double f = x - coef * oe - prev[c];
        int qi = (int)std::floor(0.5 + f);
        int tell = rc.tell();
        if (budget - tell >= 15) {
          int pi = 2 * (i < 20 ? i : 20);
          qi = laplace_encode(rc, qi, (int)prob[pi] << 7,
                              (int)prob[pi + 1] << 6);
        } else if (budget - tell >= 2) {
          qi = qi < -1 ? -1 : (qi > 1 ? 1 : qi);
          int sym = (2 * qi) ^ -(qi < 0 ? 1 : 0);
          rc.enc_cdf(sym, t.esmall_cdf);
        } else if (budget - tell >= 1) {
          qi = qi > 0 ? 0 : (qi < -1 ? -1 : qi);
          rc.enc_bit_logp(-qi, 1);
        } else {
          qi = -1;
        }
        double q = (double)qi;
        st->oldE[c][i] = coef * oe + prev[c] + q;
        prev[c] = prev[c] + beta * q;
      }
  }

  void fine_energy_enc(RE& rc, int start, int end,
                       const int64_t* fine_quant,
                       const double* band_log_e, int C) {
    for (int i = start; i < end; i++) {
      if (fine_quant[i] <= 0) continue;
      int frac = 1 << fine_quant[i];
      for (int c = 0; c < C; c++) {
        double err = band_log_e[c * NB_BANDS + i] - st->oldE[c][i];
        int q2 = (int)std::floor((err + 0.5) * frac);
        q2 = q2 < 0 ? 0 : (q2 > frac - 1 ? frac - 1 : q2);
        rc.rawbits((uint32_t)q2, (int)fine_quant[i]);
        st->oldE[c][i] += (q2 + 0.5) / frac - 0.5;
      }
    }
  }

  void finalize_energy_enc(RE& rc, int start, int end,
                           const int64_t* fine_quant,
                           const int64_t* fine_priority,
                           int64_t bits_left, const double* band_log_e,
                           int C) {
    for (int prio = 0; prio < 2; prio++) {
      int i = start;
      while (i < end && bits_left >= C) {
        if (fine_quant[i] >= MAX_FINE_BITS || fine_priority[i] != prio) {
          i++;
          continue;
        }
        for (int c = 0; c < C; c++) {
          double err = band_log_e[c * NB_BANDS + i] - st->oldE[c][i];
          int q2 = err > 0 ? 1 : 0;
          rc.rawbits((uint32_t)q2, 1);
          st->oldE[c][i] += (q2 - 0.5) / (double)(1 << (fine_quant[i] + 1));
        }
        bits_left -= C;
        i++;
      }
    }
  }

  // codeword index of a pulse vector: exact inverse of pvq.cwrsi
  uint64_t icwrs(int n, const int64_t* y) const {
    int j = n - 1;
    uint64_t i = y[j] < 0 ? 1 : 0;
    int64_t k = y[j] < 0 ? -y[j] : y[j];
    while (j > 0) {
      j--;
      i += pvq.U(n - j, (int)k);
      k += y[j] < 0 ? -y[j] : y[j];
      if (y[j] < 0) i += pvq.U(n - j, (int)k + 1);
    }
    return i;
  }

  // nearest PVQ codepoint: projection + greedy pulse fill maximizing
  // correlation^2 / energy (opus_celt_enc.py _pvq_search)
  static void pvq_search(const double* x, int N, int K, int64_t* iy) {
    double ax[512];
    int sign[512];
    double s = 0.0;
    for (int j = 0; j < N; j++) {
      sign[j] = x[j] < 0 ? -1 : 1;
      ax[j] = x[j] < 0 ? -x[j] : x[j];
      s += ax[j];
    }
    for (int j = 0; j < N; j++) iy[j] = 0;
    int left = K;
    if (s > 1e-12 && K > (N >> 1)) {
      double f = (double)K / s;
      for (int j = 0; j < N; j++) {
        iy[j] = (int64_t)std::floor(ax[j] * f);
        left -= (int)iy[j];
      }
    }
    double xy = 0.0, yy = 0.0;
    for (int j = 0; j < N; j++) {
      xy += ax[j] * (double)iy[j];
      yy += (double)iy[j] * (double)iy[j];
    }
    for (int p = 0; p < left; p++) {
      int best = 0;
      double bestv = -1.0;
      for (int j = 0; j < N; j++) {
        double num = xy + ax[j];
        num *= num;
        double v = num / (yy + 2.0 * (double)iy[j] + 1.0);
        if (v > bestv) {
          bestv = v;
          best = j;
        }
      }
      iy[best] += 1;
      xy += ax[best];
      yy += 2.0 * (double)iy[best] - 1.0;
    }
    for (int j = 0; j < N; j++) iy[j] *= sign[j];
  }

  int alg_quant(double* X, int N, int K, int spread, int B, RE& rc,
                double gain) {
    if (N > 512) { fail = true; return 1; }
    exp_rotation(X, N, 1, B, K, spread);
    int64_t iy[512];
    pvq_search(X, N, K, iy);
    rc.enc_uint(icwrs(N, iy), pvq.V(N, K));
    double Ryy = 0.0;
    for (int j = 0; j < N; j++) Ryy += (double)iy[j] * (double)iy[j];
    double g = gain / std::sqrt(Ryy);
    for (int j = 0; j < N; j++) X[j] = iy[j] * g;
    exp_rotation(X, N, -1, B, K, spread);
    return extract_collapse_mask(iy, N, B);
  }

  static int itheta_full(const double* X, const double* Y, int N,
                         bool stereo) {
    double emid = 0.0, eside = 0.0;
    if (stereo) {
      for (int j = 0; j < N; j++) {
        double m = 0.5 * (X[j] + Y[j]);
        double sd = 0.5 * (X[j] - Y[j]);
        emid += m * m;
        eside += sd * sd;
      }
    } else {
      for (int j = 0; j < N; j++) emid += X[j] * X[j];
      for (int j = 0; j < N; j++) eside += Y[j] * Y[j];
    }
    return (int)std::floor(
        0.5 + 16384.0 * (2.0 / M_PI) *
                  std::atan2(std::sqrt(eside), std::sqrt(emid)));
  }

  static void stereo_split(double* X, double* Y, int N) {
    double s = std::sqrt(0.5);
    for (int j = 0; j < N; j++) {
      double l = s * X[j];
      double r = s * Y[j];
      X[j] = l + r;
      Y[j] = r - l;
    }
  }

  static void intensity_stereo(CtxE& ctx, double* X, const double* Y,
                               int N) {
    int i = ctx.band;
    double left = ctx.bandE[0 * NB_BANDS + i];
    double right = ctx.bandE[1 * NB_BANDS + i];
    double norm = 1e-15 + std::sqrt(1e-15 + left * left + right * right);
    double a1 = left / norm, a2 = right / norm;
    for (int j = 0; j < N; j++) X[j] = a1 * X[j] + a2 * Y[j];
  }

  void compute_theta_enc(CtxE& ctx, double* X, double* Y, int N,
                         int64_t b, int B, int B0, int LM, int& fill,
                         bool stereo, int* itheta_out, int64_t* delta_out,
                         int* qalloc_out, int* inv_out) {
    RE& rc = *ctx.rc;
    int band = ctx.band;
    int64_t pulse_cap = t.logN[band] + (int64_t)LM * (1 << BITRES);
    int64_t offset = (pulse_cap >> 1) - ((stereo && N == 2) ? 16 : 4);
    int qn = compute_qn(N, b, offset, pulse_cap, stereo);
    if (stereo && band >= ctx.intensity) qn = 1;
    int itf = Y ? itheta_full(X, Y, N, stereo) : 0;
    int tell = rc.tell_frac();
    int itheta = 0, inv = 0;
    if (qn != 1) {
      itheta = (int)(((int64_t)itf * qn + 8192) >> 14);
      if (stereo && N > 2)
        rc.enc_uint_step((uint32_t)itheta, (uint32_t)(qn >> 1));
      else if (B0 > 1 || stereo)
        rc.enc_uint((uint64_t)itheta, (uint64_t)qn + 1);
      else
        rc.enc_uint_tri((uint32_t)itheta, (uint32_t)qn);
      itheta = (int)(((int64_t)itheta * 16384) / qn);
      if (stereo) {
        if (itheta == 0)
          intensity_stereo(ctx, X, Y, N);
        else
          stereo_split(X, Y, N);
      }
    } else if (stereo) {
      if (b > (2 << BITRES) && ctx.remaining_bits > (2 << BITRES)) {
        inv = itf > 8192 ? 1 : 0;
        if (inv)
          for (int j = 0; j < N; j++) Y[j] = -Y[j];
        intensity_stereo(ctx, X, Y, N);
        rc.enc_bit_logp(inv, 2);
      } else {
        inv = 0;
        intensity_stereo(ctx, X, Y, N);
      }
      itheta = 0;
    }
    int qalloc = rc.tell_frac() - tell;
    int64_t delta;
    if (itheta == 0) {
      delta = -16384;
      fill &= (1 << B) - 1;
    } else if (itheta == 16384) {
      delta = 16384;
      fill &= ((1 << B) - 1) << B;
    } else {
      int imid = bitexact_cos(itheta);
      int iside = bitexact_cos(16384 - itheta);
      delta = frac_mul16((N - 1) << 7, bitexact_log2tan(iside, imid));
    }
    *itheta_out = itheta;
    *delta_out = delta;
    *qalloc_out = qalloc;
    *inv_out = inv;
  }

  int quant_band_n1_enc(CtxE& ctx, double* X, double* Y,
                        double* lowband_out) {
    RE& rc = *ctx.rc;
    double* x = X;
    for (int rep = 0; rep < (Y ? 2 : 1); rep++) {
      int sign = 0;
      if (ctx.remaining_bits >= 1 << BITRES) {
        sign = x[0] < 0 ? 1 : 0;
        rc.rawbits((uint32_t)sign, 1);
        ctx.remaining_bits -= 1 << BITRES;
      }
      x[0] = sign ? -1.0 : 1.0;
      x = Y;
    }
    if (lowband_out) lowband_out[0] = X[0];
    return 1;
  }

  int quant_partition_enc(CtxE& ctx, double* X, int N, int64_t b, int B,
                          double* lowband, int LM, double gain, int fill) {
    if (fail) return 0;
    int band = ctx.band;
    int64_t off = t.cache_index[(LM + 1) * NB_BANDS + band];
    const int64_t* cache = t.cache_bits + off;
    if (LM != -1 && b > cache[cache[0]] + 12 && N > 2) {
      int B0 = B;
      N >>= 1;
      double* Y = X + N;
      LM -= 1;
      if (B == 1) fill = (fill & 1) | (fill << 1);
      B = (B + 1) >> 1;
      int itheta, qalloc, inv;
      int64_t delta;
      compute_theta_enc(ctx, X, Y, N, b, B, B0, LM, fill, false,
                        &itheta, &delta, &qalloc, &inv);
      double mid, side;
      if (itheta == 0) {
        mid = 32767 / 32768.0;
        side = 0.0;
      } else if (itheta == 16384) {
        mid = 0.0;
        side = 32767 / 32768.0;
      } else {
        mid = bitexact_cos(itheta) / 32768.0;
        side = bitexact_cos(16384 - itheta) / 32768.0;
      }
      if (B0 > 1 && (itheta & 0x3FFF)) {
        if (itheta > 8192) {
          delta -= delta >> (4 - LM);
        } else {
          int64_t d2 = delta + ((int64_t)N << BITRES >> (5 - LM));
          delta = d2 < 0 ? d2 : 0;
        }
      }
      b -= qalloc;
      int64_t mbits = sdiv(b - delta, 2);
      if (mbits > b) mbits = b;
      if (mbits < 0) mbits = 0;
      int64_t sbits = b - mbits;
      ctx.remaining_bits -= qalloc;
      int64_t rebalance = ctx.remaining_bits;
      int cm;
      if (mbits >= sbits) {
        cm = quant_partition_enc(ctx, X, N, mbits, B, lowband, LM,
                                 gain * mid, fill);
        rebalance = mbits - (rebalance - ctx.remaining_bits);
        if (rebalance > 3 << BITRES && itheta != 0)
          sbits += rebalance - (3 << BITRES);
        double* next_lb = lowband ? lowband + N : nullptr;
        cm |= quant_partition_enc(ctx, Y, N, sbits, B, next_lb, LM,
                                  gain * side, fill >> B) << (B0 >> 1);
      } else {
        double* next_lb = lowband ? lowband + N : nullptr;
        cm = quant_partition_enc(ctx, Y, N, sbits, B, next_lb, LM,
                                 gain * side, fill >> B) << (B0 >> 1);
        rebalance = sbits - (rebalance - ctx.remaining_bits);
        if (rebalance > 3 << BITRES && itheta != 16384)
          mbits += rebalance - (3 << BITRES);
        cm |= quant_partition_enc(ctx, X, N, mbits, B, lowband, LM,
                                  gain * mid, fill);
      }
      return cm;
    }
    // leaf: PVQ or the decoder-identical fold (reads no bits)
    int q = bits2pulses(band, LM, b);
    int64_t curr_bits = pulses2bits(band, LM, q);
    ctx.remaining_bits -= curr_bits;
    while (ctx.remaining_bits < 0 && q > 0) {
      ctx.remaining_bits += curr_bits;
      q--;
      curr_bits = pulses2bits(band, LM, q);
      ctx.remaining_bits -= curr_bits;
    }
    if (q != 0) {
      int K = get_pulses(q);
      return alg_quant(X, N, K, ctx.spread, B, *ctx.rc, gain);
    }
    int cm_mask = (1 << B) - 1;
    fill &= cm_mask;
    if (!fill) {
      std::memset(X, 0, N * sizeof(double));
      return 0;
    }
    uint32_t seed = ctx.seed;
    int cm;
    if (!lowband) {
      for (int j = 0; j < N; j++) {
        seed = lcg(seed);
        X[j] = (double)((int32_t)seed >> 20);
      }
      cm = cm_mask;
    } else {
      for (int j = 0; j < N; j++) {
        seed = lcg(seed);
        double tmp = 1.0 / 256.0;
        if (!(seed & 0x8000)) tmp = -tmp;
        X[j] = lowband[j] + tmp;
      }
      cm = fill;
    }
    ctx.seed = seed;
    renormalise(X, N, gain);
    return cm;
  }

  int quant_band_enc(CtxE& ctx, double* X, int N, int64_t b, int B,
                     double* lowband, int LM, double* lowband_out,
                     double gain, double* lowband_scratch, int fill) {
    if (fail) return 0;
    int N0 = N;
    int N_B = N / B;
    int B0 = B;
    int time_divide = 0;
    int recombine = 0;
    bool longBlocks = B0 == 1;
    if (N == 1) return quant_band_n1_enc(ctx, X, nullptr, lowband_out);
    int tf_change = ctx.tf_change;
    if (tf_change > 0) recombine = tf_change;
    if (lowband_scratch && lowband &&
        (recombine || ((N_B & 1) == 0 && tf_change < 0) || B0 > 1)) {
      std::memcpy(lowband_scratch, lowband, N * sizeof(double));
      lowband = lowband_scratch;
    }
    // encode side: X transforms INTO the coding domain here (the
    // decoder-identical undo passes run after quant_partition_enc)
    for (int k = 0; k < recombine; k++) {
      haar1(X, N >> k, 1 << k);
      if (lowband) haar1(lowband, N >> k, 1 << k);
      fill = (int)(t.bit_interleave[fill & 0xF] |
                   t.bit_interleave[fill >> 4] << 2);
    }
    B >>= recombine;
    N_B <<= recombine;
    while ((N_B & 1) == 0 && tf_change < 0) {
      haar1(X, N_B, B);
      if (lowband) haar1(lowband, N_B, B);
      fill |= fill << B;
      B <<= 1;
      N_B >>= 1;
      time_divide++;
      tf_change++;
    }
    B0 = B;
    int N_B0 = N_B;
    double tmpbuf[1408];
    if (B0 > 1) {
      deinterleave_hadamard(X, N_B >> recombine, B0 << recombine,
                            longBlocks, tmpbuf);
      if (lowband)
        deinterleave_hadamard(lowband, N_B >> recombine,
                              B0 << recombine, longBlocks, tmpbuf);
    }
    ctx.B0 = B0;
    int cm = quant_partition_enc(ctx, X, N, b, B, lowband, LM, gain, fill);
    // resynthesis: rebuild the decoded X (identical undo passes)
    if (B0 > 1)
      interleave_hadamard(X, N_B >> recombine, B0 << recombine,
                          longBlocks, tmpbuf);
    B = B0;
    N_B = N_B0;
    while (time_divide > 0) {
      B >>= 1;
      N_B <<= 1;
      cm |= cm >> B;
      haar1(X, N_B, B);
      time_divide--;
    }
    for (int k = 0; k < recombine; k++) {
      cm = (int)t.bit_deinterleave[cm];
      haar1(X, N0 >> k, 1 << k);
    }
    B <<= recombine;
    if (lowband_out) {
      double n = std::sqrt((double)N0);
      for (int j = 0; j < N0; j++) lowband_out[j] = n * X[j];
    }
    cm &= (1 << B) - 1;
    return cm;
  }

  int quant_band_stereo_enc(CtxE& ctx, double* X, double* Y, int N,
                            int64_t b, int B, double* lowband, int LM,
                            double* lowband_out, double* lowband_scratch,
                            int fill) {
    if (N == 1) return quant_band_n1_enc(ctx, X, Y, lowband_out);
    RE& rc = *ctx.rc;
    int orig_fill = fill;
    int itheta, qalloc, inv;
    int64_t delta;
    compute_theta_enc(ctx, X, Y, N, b, B, B, LM, fill, true, &itheta,
                      &delta, &qalloc, &inv);
    b -= qalloc;
    double mid, side;
    if (itheta == 0) {
      mid = 32767 / 32768.0;
      side = 0.0;
    } else if (itheta == 16384) {
      mid = 0.0;
      side = 32767 / 32768.0;
    } else {
      mid = bitexact_cos(itheta) / 32768.0;
      side = bitexact_cos(16384 - itheta) / 32768.0;
    }
    int cm;
    if (N == 2) {
      int64_t mbits = b;
      int64_t sbits = (itheta != 0 && itheta != 16384) ? (1 << BITRES) : 0;
      mbits -= sbits;
      bool c = itheta > 8192;
      ctx.remaining_bits -= qalloc + sbits;
      double* x2 = c ? Y : X;
      double* y2 = c ? X : Y;
      int sign = 0;
      if (sbits) {
        sign = (x2[0] * y2[1] - x2[1] * y2[0]) < 0 ? 1 : 0;
        rc.rawbits((uint32_t)sign, 1);
      }
      sign = 1 - 2 * sign;
      cm = quant_band_enc(ctx, x2, N, mbits, B, lowband, LM, lowband_out,
                          1.0, lowband_scratch, orig_fill);
      y2[0] = -sign * x2[1];
      y2[1] = sign * x2[0];
      X[0] = mid * X[0];
      X[1] = mid * X[1];
      Y[0] = side * Y[0];
      Y[1] = side * Y[1];
      double tmp = X[0];
      X[0] = tmp - Y[0];
      Y[0] = tmp + Y[0];
      tmp = X[1];
      X[1] = tmp - Y[1];
      Y[1] = tmp + Y[1];
    } else {
      int64_t mbits = sdiv(b - delta, 2);
      if (mbits > b) mbits = b;
      if (mbits < 0) mbits = 0;
      int64_t sbits = b - mbits;
      ctx.remaining_bits -= qalloc;
      int64_t rebalance = ctx.remaining_bits;
      if (mbits >= sbits) {
        cm = quant_band_enc(ctx, X, N, mbits, B, lowband, LM, lowband_out,
                            1.0, lowband_scratch, fill);
        rebalance = mbits - (rebalance - ctx.remaining_bits);
        if (rebalance > 3 << BITRES && itheta != 0)
          sbits += rebalance - (3 << BITRES);
        cm |= quant_band_enc(ctx, Y, N, sbits, B, nullptr, LM, nullptr,
                             side, nullptr, fill >> B);
      } else {
        cm = quant_band_enc(ctx, Y, N, sbits, B, nullptr, LM, nullptr,
                            side, nullptr, fill >> B);
        rebalance = sbits - (rebalance - ctx.remaining_bits);
        if (rebalance > 3 << BITRES && itheta != 16384)
          mbits += rebalance - (3 << BITRES);
        cm |= quant_band_enc(ctx, X, N, mbits, B, lowband, LM, lowband_out,
                             1.0, lowband_scratch, fill);
      }
      stereo_merge(X, Y, mid, N);
    }
    if (inv)
      for (int j = 0; j < N; j++) Y[j] = -Y[j];
    return cm;
  }

  void quant_all_bands_enc(RE& rc, int start, int end, double* X_,
                           double* Y_, const double* bandE,
                           const int64_t* pulses, bool shortBlocks,
                           int spread, const int64_t* tf_res,
                           int64_t total_bits, int64_t balance, int LM,
                           int codedBands, int intensity,
                           int dual_stereo) {
    int C = Y_ ? 2 : 1;
    int M = 1 << LM;
    const int64_t* eBands = t.eBands;
    int B = shortBlocks ? M : 1;
    int64_t norm_offset = M * eBands[start];
    int64_t norm_size = M * eBands[NB_BANDS - 1] - norm_offset;
    std::vector<double> norm(norm_size, 0.0);
    std::vector<double> norm2(C == 2 ? norm_size : 0, 0.0);
    std::vector<double> lowband_scratch(M * 176, 0.0);
    int64_t collapse_masks[2][NB_BANDS];
    std::memset(collapse_masks, 0, sizeof(collapse_masks));
    int lowband_offset = 0;
    bool update_lowband = true;
    CtxE ctx;
    ctx.rc = &rc;
    ctx.spread = spread;
    ctx.seed = st->rng;
    ctx.remaining_bits = 0;
    ctx.band = 0;
    ctx.tf_change = 0;
    ctx.B0 = B;
    ctx.intensity = intensity;
    ctx.bandE = bandE;
    for (int i = start; i < end && !fail; i++) {
      bool last = i == end - 1;
      int64_t effective_lowband = -1;
      double* X = X_ + M * eBands[i];
      double* Y = C == 2 ? Y_ + M * eBands[i] : nullptr;
      int N = (int)(M * (eBands[i + 1] - eBands[i]));
      int tell = rc.tell_frac();
      if (i != start) balance -= tell;
      int64_t remaining_bits = total_bits - tell - 1;
      ctx.remaining_bits = remaining_bits;
      ctx.band = i;
      int64_t b;
      if (i <= codedBands - 1) {
        int64_t den = codedBands - i < 3 ? codedBands - i : 3;
        int64_t curr_balance = sdiv(balance, den);
        b = pulses[i] + curr_balance;
        if (b > remaining_bits + 1) b = remaining_bits + 1;
        if (b > 16383) b = 16383;
        if (b < 0) b = 0;
      } else {
        b = 0;
      }
      if (M * eBands[i] - N >= M * eBands[start] &&
          (update_lowband || lowband_offset == 0))
        lowband_offset = i;
      int tf_change = (int)tf_res[i];
      ctx.tf_change = tf_change;
      int x_cm, y_cm;
      if (lowband_offset != 0 &&
          (spread != SPREAD_AGGRESSIVE || B > 1 || tf_change < 0)) {
        effective_lowband = M * eBands[lowband_offset] - norm_offset - N;
        if (effective_lowband < 0) effective_lowband = 0;
        int fold_start = lowband_offset;
        do {
          fold_start--;
        } while (M * eBands[fold_start] > effective_lowband + norm_offset);
        int fold_end = lowband_offset - 1;
        do {
          fold_end++;
        } while (M * eBands[fold_end] < effective_lowband + norm_offset + N);
        x_cm = y_cm = 0;
        int fold_i = fold_start;
        do {
          x_cm |= (int)collapse_masks[0][fold_i];
          y_cm |= (int)collapse_masks[C - 1][fold_i];
          fold_i++;
        } while (fold_i < fold_end);
      } else {
        x_cm = y_cm = (1 << B) - 1;
      }
      double* lowband =
          effective_lowband != -1 ? norm.data() + effective_lowband
                                  : nullptr;
      double* lowband2 = (C == 2 && effective_lowband != -1)
          ? norm2.data() + effective_lowband : nullptr;
      double* lowband_out =
          last ? nullptr : norm.data() + (M * eBands[i] - norm_offset);
      double* lowband_out2 = (last || C == 1)
          ? nullptr : norm2.data() + (M * eBands[i] - norm_offset);
      if (dual_stereo && i == intensity) {
        dual_stereo = 0;
        int64_t upto = M * eBands[i] - norm_offset;
        for (int64_t j = 0; j < upto; j++)
          norm[j] = 0.5 * (norm[j] + norm2[j]);
      }
      if (dual_stereo) {
        x_cm = quant_band_enc(ctx, X, N, b / 2, B, lowband, LM,
                              lowband_out, 1.0, lowband_scratch.data(),
                              x_cm);
        y_cm = quant_band_enc(ctx, Y, N, b / 2, B, lowband2, LM,
                              lowband_out2, 1.0, lowband_scratch.data(),
                              y_cm);
      } else {
        if (C == 2) {
          x_cm = quant_band_stereo_enc(ctx, X, Y, N, b, B, lowband, LM,
                                       lowband_out,
                                       lowband_scratch.data(),
                                       x_cm | y_cm);
        } else {
          x_cm = quant_band_enc(ctx, X, N, b, B, lowband, LM, lowband_out,
                                1.0, lowband_scratch.data(), x_cm | y_cm);
        }
        y_cm = x_cm;
      }
      collapse_masks[0][i] = x_cm;
      collapse_masks[C - 1][i] = y_cm;
      balance += pulses[i] + tell;
      update_lowband = b > ((int64_t)N << BITRES);
    }
    st->rng = ctx.seed;
  }

  // opus_celt_enc.py CeltEncoder.encode_frame, from precomputed
  // MDCT spectra: the forward MDCT is a dense [N, N+OVERLAP] matmul
  // the caller runs through BLAS (numpy, batched over frames) —
  // identical math to the Python encoder, and far faster than a
  // scalar loop here.
  int encode_frame(RE& rc, const double* freq_in /* C rows of N */,
                   int frame_size, int C, bool transient) {
    int LM;
    switch (frame_size) {
      case 120: LM = 0; break;
      case 240: LM = 1; break;
      case 480: LM = 2; break;
      case 960: LM = 3; break;
      default: return -2;
    }
    int N = frame_size;
    int M = 1 << LM;
    const int64_t* eBands = t.eBands;
    int start = 0, end = NB_BANDS;
    int64_t total = rc.total_bits();

    if (LM == 0) transient = false;  // no short split at 2.5 ms
    int tell = rc.tell();
    if (tell == 1) rc.enc_bit_logp(0, 15);  // not silence
    if (start == 0 && rc.tell() + 16 <= total)
      rc.enc_bit_logp(0, 1);  // no comb postfilter
    if (LM > 0 && rc.tell() + 3 <= total) {
      rc.enc_bit_logp(transient ? 1 : 0, 3);
    } else if (transient) {
      return -7;  // caller passed short spectra but the flag can't
                  // be coded; a silent long-block flip would desync
    }
    bool intra = false;
    if (rc.tell() + 3 <= total) rc.enc_bit_logp(0, 3);  // inter

    // band energies + per-band normalization
    static thread_local double freq[2][960];
    static thread_local double Xn[2][1608];
    std::memset(Xn, 0, sizeof(Xn));
    for (int c = 0; c < C; c++)
      std::memcpy(freq[c], freq_in + (size_t)c * N, N * sizeof(double));
    double bandE[2][NB_BANDS];
    double band_log_e[2][NB_BANDS];
    for (int c = 0; c < 2; c++)
      for (int i = 0; i < NB_BANDS; i++) {
        bandE[c][i] = 0.0;
        band_log_e[c][i] = -28.0;
      }
    for (int c = 0; c < C; c++)
      for (int i = start; i < end; i++) {
        int64_t lo = M * eBands[i], hi = M * eBands[i + 1];
        double e2 = 0.0;
        for (int64_t j = lo; j < hi; j++) e2 += freq[c][j] * freq[c][j];
        double e = std::sqrt(e2);
        bandE[c][i] = e;
        if (e > 1e-27) {
          double bl = std::log2(e) - t.eMeans[i];
          band_log_e[c][i] = bl > -28.0 ? bl : -28.0;
          for (int64_t j = lo; j < hi; j++) Xn[c][j] = freq[c][j] / e;
        }
      }

    coarse_energy_enc(rc, start, end, intra, LM, &band_log_e[0][0], C);

    // tf_res all zero; libopus tf_encode budget semantics (the
    // tf_select bit is reserved from the per-band budget up front)
    int64_t tf_res[NB_BANDS] = {0};
    int it = transient ? 1 : 0;
    int logp = transient ? 2 : 4;
    int64_t budget = total;
    tell = rc.tell();
    int tf_changed = 0;
    int tf_select_rsv = (LM > 0 && tell + logp + 1 <= budget) ? 1 : 0;
    budget -= tf_select_rsv;
    for (int i = start; i < end; i++) {
      if (tell + logp <= budget) {
        rc.enc_bit_logp(0, logp);
        tell = rc.tell();
      }
      logp = transient ? 4 : 5;
    }
    int tf_select = 0;
    if (tf_select_rsv &&
        t.tf_select[LM][it][0][tf_changed] !=
            t.tf_select[LM][it][1][tf_changed])
      rc.enc_bit_logp(0, 1);
    for (int i = start; i < end; i++)
      tf_res[i] = t.tf_select[LM][it][tf_select][0];

    int spread = 2;  // SPREAD_NORMAL
    if (rc.tell() + 4 <= total) rc.enc_cdf(spread, t.spread_cdf);

    int64_t cap[NB_BANDS];
    for (int i = 0; i < NB_BANDS; i++)
      cap[i] = ((t.static_caps[LM][C - 1][i] + 64) * C *
                (eBands[i + 1] - eBands[i]) << LM) >> 2;

    // dynalloc band boosts: waterfilling toward the frame's spectral
    // peaks (opus_celt_enc.py dynalloc_analysis), encoded in the
    // decoder's exact escalating-cost bit pattern
    int64_t want[NB_BANDS];
    {
      double e[NB_BANDS];
      double emax = -1e30;
      for (int i = 0; i < NB_BANDS; i++) {
        e[i] = band_log_e[0][i];
        if (C == 2 && band_log_e[1][i] > e[i]) e[i] = band_log_e[1][i];
      }
      for (int i = start; i < end; i++)
        if (e[i] > emax) emax = e[i];
      for (int i = 0; i < NB_BANDS; i++) {
        if (emax <= -27.0) { want[i] = 0; continue; }
        double w = e[i] - (emax - 8.0);
        if (w < 0.0) w = 0.0;
        double b = std::floor(w / 1.5);
        if (b > 6.0) b = 6.0;
        want[i] = (int64_t)b;
      }
    }
    int64_t offsets[NB_BANDS] = {0};
    int64_t total_bits_8 = total << BITRES;
    int tell_frac = rc.tell_frac();
    int dynalloc_logp = 6;
    int64_t total_boost = 0;
    for (int i = start; i < end; i++) {
      int64_t width = (int64_t)C * (eBands[i + 1] - eBands[i]) << LM;
      int64_t quanta = width << BITRES;
      int64_t mx = width > (6 << BITRES) ? width : (6 << BITRES);
      if (quanta > mx) quanta = mx;
      int dyn_loop = dynalloc_logp;
      int64_t boost = 0;
      while (tell_frac + (dyn_loop << BITRES) <
                 total_bits_8 - total_boost &&
             boost < cap[i]) {
        int flag = boost < want[i] * quanta ? 1 : 0;
        rc.enc_bit_logp(flag, dyn_loop);
        tell_frac = rc.tell_frac();
        if (!flag) break;
        boost += quanta;
        total_boost += quanta;
        dyn_loop = 1;
      }
      if (boost > 0 && dynalloc_logp > 2) dynalloc_logp--;
      offsets[i] = boost;
    }

    // content-adaptive allocation trim (opus_celt_enc.py
    // alloc_trim_analysis): energy-weighted spectral slope
    int alloc_trim = 5;
    if (rc.tell_frac() + (6 << BITRES) <= total_bits_8 - total_boost) {
      double e[NB_BANDS], w[NB_BANDS];
      int n = end - start;
      double em0 = -1e30;
      for (int k = 0; k < n; k++) {
        e[k] = band_log_e[0][start + k];
        if (C == 2 && band_log_e[1][start + k] > e[k])
          e[k] = band_log_e[1][start + k];
        if (e[k] > em0) em0 = e[k];
      }
      double sw = 0.0;
      for (int k = 0; k < n; k++) {
        w[k] = e[k] - em0 + 30.0;
        if (w[k] < 0.0) w[k] = 0.0;
        sw += w[k];
      }
      if (sw > 0.0) {
        double siw = 0.0, sew = 0.0;
        for (int k = 0; k < n; k++) {
          siw += (start + k) * w[k];
          sew += e[k] * w[k];
        }
        double im = siw / sw, em = sew / sw;
        double num = 0.0, den = 0.0;
        for (int k = 0; k < n; k++) {
          double di = (start + k) - im;
          num += di * (e[k] - em) * w[k];
          den += di * di * w[k];
        }
        double slope = num / (den > 1e-9 ? den : 1e-9);
        double tr = std::floor(5.0 - 6.0 * slope + 0.5);
        if (tr < 0.0) tr = 0.0;
        if (tr > 10.0) tr = 10.0;
        alloc_trim = (int)tr;
      }
      rc.enc_cdf(alloc_trim, t.trim_cdf);
    }

    int64_t bits_8 = (total << BITRES) - rc.tell_frac() - 1;
    int64_t anti_collapse_rsv =
        (transient && LM >= 2 && bits_8 >= ((int64_t)(LM + 2) << BITRES))
            ? (1 << BITRES) : 0;
    bits_8 -= anti_collapse_rsv;

    AllocCoder io;
    io.enc = &rc;
    io.end_band = end;
    // skip trailing empty bands (band-limited sources)
    io.skip_to = start;
    for (int i = start; i < end; i++)
      for (int c = 0; c < C; c++)
        if (band_log_e[c][i] > -20.0) io.skip_to = i;
    int64_t pulses[NB_BANDS], fine_quant[NB_BANDS],
        fine_priority[NB_BANDS];
    int codedBands, intensity, dual_stereo;
    int64_t balance;
    compute_allocation(start, end, offsets, cap, alloc_trim, bits_8, io,
                       LM, C, pulses, fine_quant, fine_priority,
                       &codedBands, &balance, &intensity, &dual_stereo);

    fine_energy_enc(rc, start, end, fine_quant, &band_log_e[0][0], C);

    quant_all_bands_enc(rc, start, end, Xn[0], C == 2 ? Xn[1] : nullptr,
                        &bandE[0][0], pulses, transient, spread, tf_res,
                        (total << BITRES) - anti_collapse_rsv, balance,
                        LM, codedBands, intensity, dual_stereo);

    if (anti_collapse_rsv > 0)
      rc.rawbits(0, 1);  // anti-collapse off: decode == resynthesis

    finalize_energy_enc(rc, start, end, fine_quant, fine_priority,
                        total - rc.tell(), &band_log_e[0][0], C);

    if (fail) return -4;
    post_frame_energy(start, end, transient, C);
    st->rng = rc.rng;
    return 0;
  }

  // opus_celt.py decode_frame with parse_only=True
  int parse_frame(const uint8_t* data, int64_t len, int frame_size,
                  int start, int end, int C, double* freq_out,
                  double* comb_out, int* sflag_out) {
    RC rc;
    rc.init(data, len);
    return parse_frame_rc(rc, frame_size, start, end, C, freq_out,
                          comb_out, sflag_out);
  }

  // same, continuing from a seeded range coder (the hybrid path: the
  // SILK layer decoded the low band from this coder already —
  // opus_core.py _decode_hybrid_frame)
  int parse_frame_rc(RC& rc, int frame_size, int start, int end, int C,
                     double* freq_out, double* comb_out,
                     int* sflag_out) {
    int LM;
    switch (frame_size) {
      case 120: LM = 0; break;
      case 240: LM = 1; break;
      case 480: LM = 2; break;
      case 960: LM = 3; break;
      default: return -2;
    }
    if (C < 1 || C > 2) return -3;
    int N = frame_size;
    int M = 1 << LM;
    const int64_t* eBands = t.eBands;
    int64_t total = rc.total_bits();

    int tell = rc.tell();
    bool silence;
    if (tell >= total) silence = true;
    else if (tell == 1) silence = rc.dec_bit_logp(15) != 0;
    else silence = false;
    if (silence) {
      for (int c = 0; c < 2; c++)
        for (int i = 0; i < NB_BANDS; i++) st->oldE[c][i] = -28.0;
      std::memset(freq_out, 0, (size_t)C * N * sizeof(double));
      pack_comb(st->pf_period, st->pf_gain, st->pf_tapset, comb_out);
      st->pf_period_old = st->pf_period;
      st->pf_gain_old = st->pf_gain;
      st->pf_tapset_old = st->pf_tapset;
      *sflag_out = 0;
      post_frame_energy(start, end, false, C);
      return 0;
    }

    int pf_period = 15, pf_tapset = 0;
    double pf_gain = 0.0;
    if (start == 0 && rc.tell() + 16 <= total) {
      if (rc.dec_bit_logp(1)) {
        int octave = (int)rc.dec_uint(6);
        pf_period = (16 << octave) + (int)rc.rawbits(4 + octave) - 1;
        int qg = (int)rc.rawbits(3);
        pf_gain = 0.09375 * (qg + 1);
        if (rc.tell() + 2 <= total)
          pf_tapset = rc.dec_cdf(t.tapset_cdf);
      }
    }

    bool isTransient = false;
    if (LM > 0 && rc.tell() + 3 <= total)
      isTransient = rc.dec_bit_logp(3) != 0;
    bool shortBlocks = isTransient;
    bool intra = false;
    if (rc.tell() + 3 <= total)
      intra = rc.dec_bit_logp(3) != 0;

    coarse_energy(rc, start, end, intra, LM, C);

    // libopus tf_decode: the tf_select bit is RESERVED from the
    // per-band budget up front
    int64_t tf_res[NB_BANDS] = {0};
    int curr = 0, tf_changed = 0;
    int logp = isTransient ? 2 : 4;
    int64_t budget = total;
    tell = rc.tell();
    int tf_select_rsv = (LM > 0 && tell + logp + 1 <= budget) ? 1 : 0;
    budget -= tf_select_rsv;
    for (int i = start; i < end; i++) {
      if (tell + logp <= budget) {
        curr ^= rc.dec_bit_logp(logp);
        tell = rc.tell();
        tf_changed |= curr;
      }
      tf_res[i] = curr;
      logp = isTransient ? 4 : 5;
    }
    int tf_select = 0;
    int it = isTransient ? 1 : 0;
    if (tf_select_rsv &&
        t.tf_select[LM][it][0][tf_changed] !=
            t.tf_select[LM][it][1][tf_changed])
      tf_select = rc.dec_bit_logp(1);
    for (int i = start; i < end; i++)
      tf_res[i] = t.tf_select[LM][it][tf_select][tf_res[i]];

    int spread = 2;  // SPREAD_NORMAL
    if (rc.tell() + 4 <= total)
      spread = rc.dec_cdf(t.spread_cdf);

    int64_t cap[NB_BANDS];
    for (int i = 0; i < NB_BANDS; i++)
      cap[i] = ((t.static_caps[LM][C - 1][i] + 64) * C *
                (eBands[i + 1] - eBands[i]) << LM) >> 2;

    int64_t offsets[NB_BANDS] = {0};
    int64_t total_bits_8 = total << BITRES;
    int tell_frac = rc.tell_frac();
    int dynalloc_logp = 6;
    int64_t total_boost = 0;
    for (int i = start; i < end; i++) {
      int64_t width = (int64_t)C * (eBands[i + 1] - eBands[i]) << LM;
      int64_t quanta = width << BITRES;
      int64_t mx = width > (6 << BITRES) ? width : (6 << BITRES);
      if (quanta > mx) quanta = mx;
      int dynalloc_loop_logp = dynalloc_logp;
      int64_t boost = 0;
      while (tell_frac + (dynalloc_loop_logp << BITRES) <
                 total_bits_8 - total_boost &&
             boost < cap[i]) {
        int flag = rc.dec_bit_logp(dynalloc_loop_logp);
        tell_frac = rc.tell_frac();
        if (!flag) break;
        boost += quanta;
        total_boost += quanta;
        dynalloc_loop_logp = 1;
      }
      if (boost > 0 && dynalloc_logp > 2) dynalloc_logp--;
      offsets[i] = boost;
    }

    int alloc_trim = 5;
    if (rc.tell_frac() + (6 << BITRES) <= total_bits_8 - total_boost)
      alloc_trim = rc.dec_cdf(t.trim_cdf);

    int64_t bits_8 = (total << BITRES) - rc.tell_frac() - 1;
    int64_t anti_collapse_rsv =
        (isTransient && LM >= 2 && bits_8 >= ((LM + 2) << BITRES))
            ? (1 << BITRES) : 0;
    bits_8 -= anti_collapse_rsv;

    int64_t pulses[NB_BANDS], fine_quant[NB_BANDS], fine_priority[NB_BANDS];
    int codedBands, intensity, dual_stereo;
    int64_t balance;
    AllocCoder alloc_io;
    alloc_io.dec = &rc;
    compute_allocation(start, end, offsets, cap, alloc_trim, bits_8,
                       alloc_io, LM, C, pulses, fine_quant, fine_priority,
                       &codedBands, &balance, &intensity, &dual_stereo);

    fine_energy(rc, start, end, fine_quant, C);

    static thread_local double X[2][1608];
    std::memset(X, 0, sizeof(X));
    int64_t collapse_masks[2][NB_BANDS];
    quant_all_bands(rc, start, end, X[0], C == 2 ? X[1] : nullptr,
                    pulses, shortBlocks, spread, tf_res,
                    (total << BITRES) - anti_collapse_rsv, balance, LM,
                    codedBands, intensity, dual_stereo, collapse_masks);

    int anti_collapse_on = 0;
    if (anti_collapse_rsv > 0)
      anti_collapse_on = (int)rc.rawbits(1);

    finalize_energy(rc, start, end, fine_quant, fine_priority,
                    total - rc.tell(), C);

    if (fail) return -4;

    if (anti_collapse_on)
      anti_collapse(X, collapse_masks, LM, start, end, pulses, C, C);

    for (int c = 0; c < C; c++) {
      std::memset(freq_out + (size_t)c * N, 0, N * sizeof(double));
      for (int i = start; i < end; i++) {
        double e = st->oldE[c][i] + t.eMeans[i];
        if (e > 32.0) e = 32.0;
        double g = std::exp(e * std::log(2.0));
        int64_t lo_b = M * eBands[i], hi_b = M * eBands[i + 1];
        for (int64_t j = lo_b; j < hi_b; j++)
          freq_out[(size_t)c * N + j] = X[c][j] * g;
      }
    }

    int new_period = pf_period > COMB_MINPERIOD ? pf_period : COMB_MINPERIOD;
    pack_comb(new_period, pf_gain, pf_tapset, comb_out);
    rotate_pf(new_period, pf_gain, pf_tapset, LM);
    *sflag_out = shortBlocks ? 1 : 0;

    post_frame_energy(start, end, isTransient, C);
    st->rng = rc.rng;
    return 0;
  }
};

}  // namespace

// ---------------------------------------------------------------- C API
extern "C" {

int skt_celt_table_i(const char* name, const int64_t* data, long n) {
  g_tables.ints[name] = std::vector<int64_t>(data, data + n);
  g_tables.ready = false;
  return 0;
}

int skt_celt_table_f(const char* name, const double* data, long n) {
  g_tables.flts[name] = std::vector<double>(data, data + n);
  g_tables.ready = false;
  return 0;
}

int skt_celt_tables_done(void) {
  return g_tables.finalize() ? 0 : -1;
}

void* skt_celt_new(int channels) {
  if (channels < 1 || channels > 2) return nullptr;
  Celt* st = new Celt();
  st->channels = channels;
  st->reset();
  return st;
}

void skt_celt_free(void* h) { delete (Celt*)h; }

void skt_celt_reset(void* h) { ((Celt*)h)->reset(); }

// Parse one CELT frame: freq_out [C*frame_size] f64, comb_out [16]
// f64 (packed postfilter params, pre-rotation layout of
// ops/celt_batch.py pack_comb_params), sflag_out transient flag.
int skt_celt_parse(void* h, const uint8_t* data, long len, int frame_size,
                   int start, int end, int coded_channels,
                   double* freq_out, double* comb_out, int* sflag_out) {
  if (!g_tables.ready) return -1;
  Celt* st = (Celt*)h;
  Parser p(st);
  return p.parse_frame(data, len, frame_size, start, end,
                       coded_channels ? coded_channels : st->channels,
                       freq_out, comb_out, sflag_out);
}

// Lockstep batch: one call parses lane b's frame at buf[offs[b]..]
// when valid[b], writing freq[b] ([Cmax*frame_size] f64, mono lanes
// duplicated across channels), comb[b*16], sflag[b]. ok[b] gets the
// per-lane status (0 ok; untouched lanes keep -100).
int skt_celt_parse_many(void** handles, int B, const uint8_t* buf,
                        const long* offs, const long* lens,
                        const int* ends, const int* coded,
                        const unsigned char* valid, int frame_size,
                        int Cmax, double* freq, double* comb,
                        int* sflag, int* ok) {
  if (!g_tables.ready) return -1;
  int rc_all = 0;
  for (int b = 0; b < B; b++) {
    ok[b] = -100;
    if (!valid[b]) continue;
    Celt* st = (Celt*)handles[b];
    Parser p(st);
    int C = coded[b] ? coded[b] : st->channels;
    double* fo = freq + (size_t)b * Cmax * frame_size;
    int r = p.parse_frame(buf + offs[b], lens[b], frame_size, 0, ends[b],
                          C, fo, comb + (size_t)b * 16, sflag + b);
    if (r == 0 && C < Cmax)
      for (int c = C; c < Cmax; c++)
        std::memcpy(fo + (size_t)c * frame_size, fo,
                    frame_size * sizeof(double));
    ok[b] = r;
    if (r != 0) rc_all = r;
  }
  return rc_all;
}

// Quantized-wire lockstep batch: identical parse to
// skt_celt_parse_many, but the spectra leave as int16 with ONE f32
// scale per (lane, band) — the serving wire for the batched device
// synthesis is half the bytes of the f32 plane (~92 dB vs the exact
// path on the fixture corpus, above the fleet's i16 output floor).
// qfreq [B, Cmax, frame_size] i16, scale [B, NB_BANDS] f32
// (scale==0 for silent/uncoded bands; bins past eBands[21] are
// structurally zero).  The quantization runs here, cache-hot on the
// just-parsed lane, instead of as extra numpy passes over the full
// [rounds, B, C, N] plane on the host.
int skt_celt_parse_many_q(void** handles, int B, const uint8_t* buf,
                          const long* offs, const long* lens,
                          const int* ends, const int* coded,
                          const unsigned char* valid, int frame_size,
                          int Cmax, int16_t* qfreq, float* scale,
                          double* comb, int* sflag, int* ok) {
  if (!g_tables.ready) return -1;
  int rc_all = 0;
  const int m8 = frame_size / 120;
  std::vector<double> tmp((size_t)Cmax * frame_size);
  for (int b = 0; b < B; b++) {
    ok[b] = -100;
    if (!valid[b]) continue;
    Celt* st = (Celt*)handles[b];
    Parser p(st);
    int C = coded[b] ? coded[b] : st->channels;
    double* fo = tmp.data();
    int r = p.parse_frame(buf + offs[b], lens[b], frame_size, 0, ends[b],
                          C, fo, comb + (size_t)b * 16, sflag + b);
    if (r == 0 && C < Cmax)
      for (int c = C; c < Cmax; c++)
        std::memcpy(fo + (size_t)c * frame_size, fo,
                    frame_size * sizeof(double));
    ok[b] = r;
    if (r != 0) { rc_all = r; continue; }
    int16_t* qf = qfreq + (size_t)b * Cmax * frame_size;
    float* sc = scale + (size_t)b * NB_BANDS;
    for (int k = 0; k < NB_BANDS; k++) {
      long lo = (long)g_tables.eBands[k] * m8;
      long hi = (long)g_tables.eBands[k + 1] * m8;
      if (lo >= frame_size) { sc[k] = 0.f; continue; }
      if (hi > frame_size) hi = frame_size;
      double m = 0.0;
      for (int c = 0; c < Cmax; c++) {
        const double* src = fo + (size_t)c * frame_size;
        for (long i = lo; i < hi; i++) {
          double a = src[i] < 0 ? -src[i] : src[i];
          if (a > m) m = a;
        }
      }
      if (m <= 0.0) {
        sc[k] = 0.f;
        for (int c = 0; c < Cmax; c++)
          std::memset(qf + (size_t)c * frame_size + lo, 0,
                      (size_t)(hi - lo) * sizeof(int16_t));
        continue;
      }
      sc[k] = (float)(m / 32767.0);
      double inv = 32767.0 / m;
      for (int c = 0; c < Cmax; c++) {
        const double* src = fo + (size_t)c * frame_size;
        int16_t* dq = qf + (size_t)c * frame_size;
        for (long i = lo; i < hi; i++)
          dq[i] = (int16_t)std::lround(src[i] * inv);
      }
    }
    long W = (long)g_tables.eBands[NB_BANDS] * m8;
    if (W < frame_size)
      for (int c = 0; c < Cmax; c++)
        std::memset(qf + (size_t)c * frame_size + W, 0,
                    (size_t)(frame_size - W) * sizeof(int16_t));
  }
  return rc_all;
}

// Hybrid-continuation lockstep batch: like skt_celt_parse_many, but
// each lane's range coder is SEEDED from the SILK stage's exported
// state (rc_init[b*9..]: offs, rem, end_offs, end_window, nend_bits,
// nbits_total, rng, val, error — silk_parse.cpp info[4..12] layout)
// over the SAME frame bytes, and the frame parses from per-lane
// start band (17 for hybrid).  Before the CELT frame, the hybrid
// redundancy flag is read exactly as opus_core.py
// _decode_hybrid_frame does (tell+37 guard, logp 12); lanes with
// redundancy set red[b]=1 and ok[b]=-90 WITHOUT parsing — the caller
// reroutes them (transition packets carry the redundancy).
int skt_celt_parse_many_cont(void** handles, int B, const uint8_t* buf,
                             const long* offs, const long* lens,
                             const int* starts, const int* ends,
                             const int* coded,
                             const unsigned char* valid,
                             const long* rc_init, int frame_size,
                             int Cmax, double* freq, double* comb,
                             int* sflag, int* ok, int* red) {
  if (!g_tables.ready) return -1;
  int rc_all = 0;
  for (int b = 0; b < B; b++) {
    ok[b] = -100;
    red[b] = 0;
    if (!valid[b]) continue;
    Celt* st = (Celt*)handles[b];
    Parser p(st);
    int C = coded[b] ? coded[b] : st->channels;
    RC rc;
    rc.buf = buf + offs[b];
    rc.storage = lens[b];
    const long* ri = rc_init + (size_t)b * 9;
    rc.offs = ri[0];
    rc.rem = (int)ri[1];
    rc.end_offs = ri[2];
    rc.end_window = (uint64_t)ri[3];
    rc.nend_bits = (int)ri[4];
    rc.nbits_total = (int)ri[5];
    rc.rng = (uint32_t)ri[6];
    rc.val = (uint32_t)ri[7];
    rc.error = ri[8] != 0;
    rc.ext = 0;
    if (rc.tell() + 37 <= rc.total_bits() && rc.dec_bit_logp(12)) {
      red[b] = 1;
      ok[b] = -90;
      rc_all = rc_all ? rc_all : -90;
      continue;
    }
    double* fo = freq + (size_t)b * Cmax * frame_size;
    int r = p.parse_frame_rc(rc, frame_size, starts[b], ends[b], C, fo,
                             comb + (size_t)b * 16, sflag + b);
    if (r == 0 && C < Cmax)
      for (int c = C; c < Cmax; c++)
        std::memcpy(fo + (size_t)c * frame_size, fo,
                    frame_size * sizeof(double));
    ok[b] = r;
    if (r != 0) rc_all = r;
  }
  return rc_all;
}

// Multi-round serving walk (round-5 fleet host diet): parse R
// lockstep rounds for B lanes in ONE call, writing the device wire
// DIRECTLY in dispatch layout.  buf holds each lane's frames
// concatenated in round order starting at base[b];
// lens[b*R + r] == 0 marks an empty slot (the lane skips that round,
// its wire slot must arrive pre-zeroed — np.zeros).  Lane state
// carries across rounds exactly as R successive parse_many calls
// would.  Outputs: qfreq [R, B, Cmax, W] i16 with one f32 scale per
// (round, lane, band) in scale [R, B, 21] (W = trimmed wire width,
// eBands[end_max]*m8), comb [R, B, 16] f32, sflag/ok [R, B] i32
// (ok: 0 parsed, -100 skipped, else the parse error).
int skt_celt_parse_rounds_q(void** handles, int B, int R,
                            const uint8_t* buf, const int64_t* base,
                            const int* lens, const int* ends,
                            const int* coded, int frame_size, int Cmax,
                            int W, int16_t* qfreq, float* scale,
                            float* comb, int* sflag, int* ok) {
  if (!g_tables.ready) return -1;
  int rc_all = 0;
  const int m8 = frame_size / 120;
  std::vector<double> tmp((size_t)Cmax * frame_size);
  double comb64[16];
  for (int b = 0; b < B; b++) {
    Celt* st = (Celt*)handles[b];
    int64_t off = base[b];
    for (int r = 0; r < R; r++) {
      size_t slot = (size_t)r * B + b;
      int len = lens[(size_t)b * R + r];
      ok[slot] = -100;
      if (len <= 0) continue;
      Parser p(st);
      int C = coded[(size_t)b * R + r];
      if (!C) C = st->channels;
      int sf = 0;
      int rr = p.parse_frame(buf + off, len, frame_size, 0,
                             ends[(size_t)b * R + r], C, tmp.data(),
                             comb64, &sf);
      off += len;
      ok[slot] = rr;
      sflag[slot] = sf;
      if (rr != 0) { rc_all = rr; continue; }
      for (int i = 0; i < 16; i++)
        comb[slot * 16 + i] = (float)comb64[i];
      if (C < Cmax)
        for (int c = C; c < Cmax; c++)
          std::memcpy(tmp.data() + (size_t)c * frame_size, tmp.data(),
                      frame_size * sizeof(double));
      int16_t* qf = qfreq + slot * (size_t)Cmax * W;
      float* sc = scale + slot * NB_BANDS;
      for (int k = 0; k < NB_BANDS; k++) {
        long lo = (long)g_tables.eBands[k] * m8;
        long hi = (long)g_tables.eBands[k + 1] * m8;
        if (lo >= W) { sc[k] = 0.f; continue; }
        if (hi > W) hi = W;
        double m = 0.0;
        for (int c = 0; c < Cmax; c++) {
          const double* src = tmp.data() + (size_t)c * frame_size;
          for (long i = lo; i < hi; i++) {
            double a = src[i] < 0 ? -src[i] : src[i];
            if (a > m) m = a;
          }
        }
        if (m <= 0.0) { sc[k] = 0.f; continue; }  // slot pre-zeroed
        sc[k] = (float)(m / 32767.0);
        double inv = 32767.0 / m;
        for (int c = 0; c < Cmax; c++) {
          const double* src = tmp.data() + (size_t)c * frame_size;
          int16_t* dq = qf + (size_t)c * W;
          for (long i = lo; i < hi; i++)
            dq[i] = (int16_t)std::lround(src[i] * inv);
        }
      }
    }
  }
  return rc_all;
}

// f32 sibling of skt_celt_parse_rounds_q for the exact serving wire:
// freq [R, B, Cmax, W] f32 (bins past W are structurally zero and
// the device pads them back).
int skt_celt_parse_rounds(void** handles, int B, int R,
                          const uint8_t* buf, const int64_t* base,
                          const int* lens, const int* ends,
                          const int* coded, int frame_size, int Cmax,
                          int W, float* freq, float* comb, int* sflag,
                          int* ok) {
  if (!g_tables.ready) return -1;
  int rc_all = 0;
  std::vector<double> tmp((size_t)Cmax * frame_size);
  double comb64[16];
  for (int b = 0; b < B; b++) {
    Celt* st = (Celt*)handles[b];
    int64_t off = base[b];
    for (int r = 0; r < R; r++) {
      size_t slot = (size_t)r * B + b;
      int len = lens[(size_t)b * R + r];
      ok[slot] = -100;
      if (len <= 0) continue;
      Parser p(st);
      int C = coded[(size_t)b * R + r];
      if (!C) C = st->channels;
      int sf = 0;
      int rr = p.parse_frame(buf + off, len, frame_size, 0,
                             ends[(size_t)b * R + r], C, tmp.data(),
                             comb64, &sf);
      off += len;
      ok[slot] = rr;
      sflag[slot] = sf;
      if (rr != 0) { rc_all = rr; continue; }
      for (int i = 0; i < 16; i++)
        comb[slot * 16 + i] = (float)comb64[i];
      if (C < Cmax)
        for (int c = C; c < Cmax; c++)
          std::memcpy(tmp.data() + (size_t)c * frame_size, tmp.data(),
                      frame_size * sizeof(double));
      float* fo = freq + slot * (size_t)Cmax * W;
      for (int c = 0; c < Cmax; c++) {
        const double* src = tmp.data() + (size_t)c * frame_size;
        float* dst = fo + (size_t)c * W;
        for (int i = 0; i < W; i++) dst[i] = (float)src[i];
      }
    }
  }
  return rc_all;
}

// Encode one CELT frame (opus_celt_enc.py CeltEncoder.encode_frame):
// freq = C rows of frame_size forward-MDCT spectra (the caller runs
// the [N, N+OVERLAP] matmul through BLAS); out receives the
// nbytes-long CBR range-coded payload (no TOC byte).  The handle is
// a skt_celt_new() Celt state.  Returns nbytes, or negative on error.
long skt_celt_enc_frame(void* h, const double* freq, int frame_size,
                        int nbytes, int transient, uint8_t* out) {
  if (!g_tables.ready) return -1;
  Celt* st = (Celt*)h;
  Parser p(st);
  RE re;
  re.init(nbytes);
  int r = p.encode_frame(re, freq, frame_size, st->channels,
                         transient != 0);
  if (r != 0) return r;
  if (re.finalize() != 0) return -6;
  std::memcpy(out, re.buf.data(), nbytes);
  return nbytes;
}

}  // extern "C"
