// GSM 06.10 full-rate (RPE-LTP) decoder, from scratch.
//
// Implements the ETSI GSM 06.10 fixed-point decode algorithm (saturated
// 16-bit adds, rounded Q15 multiplies) so output is bit-exact with the
// canonical libgsm decode the reference wraps via FFI
// (soundkit-gsm/src/lib.rs:4-76, GsmVariant Standard/Microsoft).  Both
// framings: standard 33-byte frames (0xD signature nibble, fields
// MSB-first) and WAV49 65-byte blocks (two frames, fields LSB-first).
//
// Decode stages per 160-sample frame (ETSI 06.10 §5.3):
//   LARc -> LARpp (inverse log-area quantization)
//   LARpp interpolation over 4 regions -> reflection coefficients rp
//   per subframe: RPE dequant (xmaxc exp/mant, FAC table) + grid
//   positioning, LTP long-term filter (lag Nc, gain QLB[bc])
//   short-term synthesis lattice (8 stages), de-emphasis, 13-bit
//   output truncation.

#include <cstdint>
#include <cstring>

namespace {

// ---- ETSI 06.10 fixed-point primitives ----

inline int16_t sat16(int32_t x) {
    return x > 32767 ? 32767 : (x < -32768 ? (int16_t)-32768 : (int16_t)x);
}
inline int16_t gadd(int16_t a, int16_t b) { return sat16((int32_t)a + b); }
inline int16_t gsub(int16_t a, int16_t b) { return sat16((int32_t)a - b); }
inline int16_t gmult_r(int16_t a, int16_t b) {
    if (a == -32768 && b == -32768) return 32767;
    return (int16_t)((((int32_t)a * b) + 16384) >> 15);
}
inline int16_t gasr(int16_t a, int n) { return (int16_t)(a >> n); }

// ---- spec constant tables (ETSI 06.10 §5.3 quantization tables) ----

const int16_t MIC[8] = {-32, -32, -16, -16, -8, -8, -4, -4};
const int16_t B[8] = {0, 0, 2048, -2560, 94, -1792, -341, -1144};
const int16_t INVA[8] = {13107, 13107, 13107, 13107, 19223, 17476, 31454, 29708};
const int16_t QLB[4] = {3277, 11469, 21299, 32767};
const int16_t FAC[8] = {18431, 20479, 22527, 24575, 26623, 28671, 30719, 32767};
const int LAR_BITS[8] = {6, 6, 5, 5, 4, 4, 3, 3};

struct Frame {
    int16_t LARc[8];
    int16_t Nc[4], bc[4], Mc[4], xmaxc[4];
    int16_t xMc[4][13];
};

struct Decoder {
    int wav49;            // 0 = standard 33B frames, 1 = WAV49 65B blocks
    int16_t larpp_prev[8];
    int16_t v[9];         // short-term lattice state
    int16_t d[160];       // LTP history: d[0..119] = drp[-120..-1]
    int16_t nrp;
    int16_t msr;

    void reset() {
        memset(larpp_prev, 0, sizeof larpp_prev);
        memset(v, 0, sizeof v);
        memset(d, 0, sizeof d);
        nrp = 40;
        msr = 0;
    }

    // LARc -> LARpp (§5.3.2 decoding of the coded log-area ratios)
    void lar_decode(const int16_t* LARc, int16_t* LARpp) {
        for (int i = 0; i < 8; ++i) {
            int16_t t1 = (int16_t)(gadd(LARc[i], MIC[i]) << 10);
            int16_t t2 = (int16_t)(B[i] << 1);
            t1 = gsub(t1, t2);
            t1 = gmult_r(INVA[i], t1);
            LARpp[i] = gadd(t1, t1);
        }
    }

    // LARp -> reflection coefficient (§5.2.8.3 / decoder reuse)
    static inline int16_t lar_to_rp(int16_t larp) {
        int16_t t = larp < 0 ? (larp == -32768 ? 32767 : (int16_t)-larp) : larp;
        if (t < 11059) t = (int16_t)(t << 1);
        else if (t < 20070) t = gadd(t, 11059);
        else t = gadd(gasr(t, 2), 26112);
        return larp < 0 ? (int16_t)-t : t;
    }

    // 8-stage short-term synthesis lattice over [k0, k1) (§5.3.4)
    void short_term_synth(const int16_t* rp, int16_t* s, int k0, int k1) {
        for (int k = k0; k < k1; ++k) {
            int16_t sri = s[k];
            for (int i = 7; i >= 0; --i) {
                sri = gsub(sri, gmult_r(rp[i], v[i]));
                v[i + 1] = gadd(v[i], gmult_r(rp[i], sri));
            }
            s[k] = v[0] = sri;
        }
    }

    void decode_frame(const Frame& f, int16_t* out) {
        int16_t wt[160];

        for (int j = 0; j < 4; ++j) {
            // ---- RPE decoding (§5.3.1): xmaxc -> exp/mant ----
            int16_t xmaxc = f.xmaxc[j];
            int16_t exp = 0;
            if (xmaxc > 15) exp = (int16_t)(gasr(xmaxc, 3) - 1);
            int16_t mant = (int16_t)(xmaxc - (exp << 3));
            if (mant == 0) {
                exp = -4;
                mant = 7;
            } else {
                while (mant <= 7) {
                    mant = (int16_t)(mant << 1 | 1);
                    --exp;
                }
                mant = (int16_t)(mant - 8);
            }

            // APCM inverse quantization
            int16_t xMp[13];
            int16_t t1 = FAC[mant];
            int16_t t2 = gsub(6, exp);
            // exp==6 gives t2==0; libgsm's gsm_asl(1,-1) is defined as 0
            // there, while 1<<-1 is UB — guard the shift explicitly
            int16_t t3 = t2 > 0 ? (int16_t)(1 << (t2 - 1)) : (int16_t)0;
            for (int i = 0; i < 13; ++i) {
                int16_t temp = (int16_t)((f.xMc[j][i] << 1) - 7);  // [-7, 7]
                temp = (int16_t)(temp << 12);
                temp = gmult_r(t1, temp);
                temp = gadd(temp, t3);
                xMp[i] = gasr(temp, t2);
            }

            // RPE grid positioning (§5.3.1)
            int16_t erp[40];
            memset(erp, 0, sizeof erp);
            for (int i = 0; i < 13; ++i) erp[f.Mc[j] + 3 * i] = xMp[i];

            // ---- long-term synthesis filter (§5.3.3) ----
            int16_t Nr = f.Nc[j];
            if (Nr < 40 || Nr > 120) Nr = nrp;
            nrp = Nr;
            int16_t brp = QLB[f.bc[j]];
            // d[120+k] is the current subframe; d[120+k-Nr] the history
            for (int k = 0; k < 40; ++k) {
                int16_t drpp = gmult_r(brp, d[120 + k - Nr]);
                d[120 + k] = gadd(erp[k], drpp);
            }
            memcpy(wt + j * 40, d + 120, 40 * sizeof(int16_t));
            memmove(d, d + 40, 120 * sizeof(int16_t));
        }

        // ---- short-term synthesis with LARpp interpolation (§5.3.4) ----
        int16_t LARpp[8], LARp[8], rp[8];
        lar_decode(f.LARc, LARpp);

        // region 1: k = 0..12, 3/4 previous + 1/4 current
        for (int i = 0; i < 8; ++i) {
            LARp[i] = gadd(gasr(larpp_prev[i], 2), gasr(LARpp[i], 2));
            LARp[i] = gadd(LARp[i], gasr(larpp_prev[i], 1));
            rp[i] = lar_to_rp(LARp[i]);
        }
        short_term_synth(rp, wt, 0, 13);
        // region 2: k = 13..26, 1/2 + 1/2
        for (int i = 0; i < 8; ++i) {
            LARp[i] = gadd(gasr(larpp_prev[i], 1), gasr(LARpp[i], 1));
            rp[i] = lar_to_rp(LARp[i]);
        }
        short_term_synth(rp, wt, 13, 27);
        // region 3: k = 27..39, 1/4 previous + 3/4 current
        for (int i = 0; i < 8; ++i) {
            LARp[i] = gadd(gasr(larpp_prev[i], 2), gasr(LARpp[i], 2));
            LARp[i] = gadd(LARp[i], gasr(LARpp[i], 1));
            rp[i] = lar_to_rp(LARp[i]);
        }
        short_term_synth(rp, wt, 27, 40);
        // region 4: k = 40..159, current
        for (int i = 0; i < 8; ++i) rp[i] = lar_to_rp(LARpp[i]);
        short_term_synth(rp, wt, 40, 160);

        memcpy(larpp_prev, LARpp, sizeof LARpp);

        // ---- de-emphasis + 13-bit output truncation (§5.3.5) ----
        for (int k = 0; k < 160; ++k) {
            msr = gadd(wt[k], gmult_r(msr, 28180));
            out[k] = (int16_t)(gadd(msr, msr) & ~7);
        }
    }
};

// MSB-first reader for the standard 33-byte frame
struct MsbReader {
    const uint8_t* p;
    int bit = 0;
    explicit MsbReader(const uint8_t* d) : p(d) {}
    int16_t get(int n) {
        int v = 0;
        for (int i = 0; i < n; ++i) {
            v = (v << 1) | ((p[bit >> 3] >> (7 - (bit & 7))) & 1);
            ++bit;
        }
        return (int16_t)v;
    }
};

// LSB-first reader for WAV49 blocks (fields low-bit-first, bytes in order)
struct LsbReader {
    const uint8_t* p;
    int bit = 0;
    explicit LsbReader(const uint8_t* d) : p(d) {}
    int16_t get(int n) {
        int v = 0;
        for (int i = 0; i < n; ++i) {
            v |= ((p[bit >> 3] >> (bit & 7)) & 1) << i;
            ++bit;
        }
        return (int16_t)v;
    }
};

template <typename Reader>
void read_fields(Reader& br, Frame& f) {
    for (int i = 0; i < 8; ++i) f.LARc[i] = br.get(LAR_BITS[i]);
    for (int j = 0; j < 4; ++j) {
        f.Nc[j] = br.get(7);
        f.bc[j] = br.get(2);
        f.Mc[j] = br.get(2);
        f.xmaxc[j] = br.get(6);
        for (int i = 0; i < 13; ++i) f.xMc[j][i] = br.get(3);
    }
}

}  // namespace

extern "C" {

void* skt_gsm_new(int wav49) {
    auto* d = new Decoder();
    d->wav49 = wav49;
    d->reset();
    return d;
}

void skt_gsm_free(void* h) { delete (Decoder*)h; }

// Decode whole frames/blocks from `data` (standard: n*33 bytes -> n*160
// samples; wav49: n*65 bytes -> n*320 samples).  Returns samples
// written, or -1 on a malformed standard frame (bad signature nibble).
long skt_gsm_decode(void* h, const uint8_t* data, long nbytes, int16_t* out) {
    auto* dec = (Decoder*)h;
    long written = 0;
    if (!dec->wav49) {
        for (long off = 0; off + 33 <= nbytes; off += 33) {
            MsbReader br(data + off);
            if (br.get(4) != 0xD) return -1;  // GSM magic nibble
            Frame f;
            read_fields(br, f);
            dec->decode_frame(f, out + written);
            written += 160;
        }
    } else {
        for (long off = 0; off + 65 <= nbytes; off += 65) {
            LsbReader br(data + off);
            for (int half = 0; half < 2; ++half) {
                Frame f;
                read_fields(br, f);
                dec->decode_frame(f, out + written);
                written += 160;
            }
        }
    }
    return written;
}

void skt_gsm_reset(void* h) { ((Decoder*)h)->reset(); }

}  // extern "C"
