// Apple Lossless (ALAC) decoder, from scratch.
//
// Implements the ALAC bitstream (adaptive-Golomb entropy coding with
// zero-run mode, adaptive integer LPC with per-sample coefficient
// updates, stereo decorrelation, shifted-extra-bits side channel) per
// the published format.  Role-equivalent of the reference's `alac`
// crate wrapper (soundkit-alac/src/lib.rs:11-49); replaces the avcodec
// delegation so the repo owns its second lossless codec alongside
// FLAC (native/src/flac.cpp).
//
// Bit-exactness is enforced by tests against golden/alac and the
// avcodec oracle for both the M4A and CAF container paths.

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

constexpr int MAX_CH = 8;
constexpr int MAX_ORDER = 32;

struct BitReader {
    const uint8_t* data;
    long nbits;
    long pos = 0;
    bool bad = false;

    BitReader(const uint8_t* d, long len) : data(d), nbits(len * 8) {}

    inline uint32_t get(int n) {
        if (pos + n > nbits) { bad = true; pos = nbits; return 0; }
        uint32_t v = 0;
        for (int i = 0; i < n; ++i) {
            v = (v << 1) | ((data[pos >> 3] >> (7 - (pos & 7))) & 1);
            ++pos;
        }
        return v;
    }
    inline int32_t get_s(int n) {
        uint32_t v = get(n);
        if (n && (v >> (n - 1))) v |= ~((1u << n) - 1);
        return (int32_t)v;
    }
    inline uint32_t peek(int n) {
        long save = pos;
        bool b = bad;
        uint32_t v = get(n);
        pos = save;
        bad = b;
        return v;
    }
    inline void skip(long n) {
        pos += n;
        if (pos > nbits) { bad = true; pos = nbits; }
    }
    // unary count of 1-bits, stopping at (and consuming) a 0, max `len`
    inline int unary(int len) {
        int i = 0;
        while (i < len && pos < nbits) {
            int b = (data[pos >> 3] >> (7 - (pos & 7))) & 1;
            ++pos;
            if (!b) return i;
            ++i;
        }
        return i;
    }
};

inline int log2u(uint32_t x) {  // floor(log2(x)), log2u(0) == 0
    int n = 0;
    while (x > 1) { x >>= 1; ++n; }
    return n;
}

inline int32_t sign_extend(int32_t v, int bits) {
    uint32_t m = 1u << (bits - 1);
    uint32_t x = (uint32_t)v & (m | (m - 1));  // mask to field width first
    return (int32_t)((x ^ m) - m);
}

struct Decoder {
    // ALACSpecificConfig
    uint32_t frame_length = 4096;
    int sample_size = 16;
    int rice_history_mult = 40;  // pb
    int rice_initial_history = 10;  // mb
    int rice_limit = 14;  // kb
    int channels = 2;
    uint32_t sample_rate = 44100;

    int32_t* bufs[MAX_CH] = {nullptr};
    int32_t* extra[MAX_CH] = {nullptr};
    int32_t* pred = nullptr;
    char error[128] = {0};

    ~Decoder() {
        for (auto*& b : bufs) delete[] b;
        for (auto*& b : extra) delete[] b;
        delete[] pred;
    }

    bool fail(const char* msg) {
        snprintf(error, sizeof error, "%s", msg);
        return false;
    }

    bool set_cookie(const uint8_t* c, long len) {
        // accept the bare 24-byte ALACSpecificConfig or the atom-
        // wrapped forms ([size]'alac'[version] prefix, 36 bytes)
        if (len >= 36 && !memcmp(c + 4, "alac", 4)) { c += 12; len -= 12; }
        else if (len >= 36 && !memcmp(c + 4, "frma", 4)) {
            // 'frma' + 'alac' chunk wrapper (CAF kuki)
            c += 12; len -= 12;
            if (len >= 36 && !memcmp(c + 4, "alac", 4)) { c += 12; len -= 12; }
        }
        if (len < 24) return fail("ALAC magic cookie too short");
        frame_length = (uint32_t)c[0] << 24 | c[1] << 16 | c[2] << 8 | c[3];
        sample_size = c[5];
        rice_history_mult = c[6];
        rice_initial_history = c[7];
        rice_limit = c[8];
        channels = c[9];
        sample_rate = (uint32_t)c[20] << 24 | c[21] << 16 | c[22] << 8 | c[23];
        if (frame_length == 0 || frame_length > 1 << 20)
            return fail("bad ALAC frame length");
        if (channels < 1 || channels > MAX_CH) return fail("bad channel count");
        if (sample_size < 8 || sample_size > 32) return fail("bad sample size");
        for (int ch = 0; ch < channels; ++ch) {
            bufs[ch] = new int32_t[frame_length];
            extra[ch] = new int32_t[frame_length];
        }
        pred = new int32_t[frame_length];
        return true;
    }

    // adaptive-Golomb scalar (prefix of 1s; >8 escapes to raw bits)
    static inline uint32_t decode_scalar(BitReader& br, int k, int bps) {
        uint32_t x = (uint32_t)br.unary(9);
        if (x > 8) {
            x = br.get(bps);
        } else if (k != 1) {
            uint32_t ext = br.peek(k);
            x = (x << k) - x;  // x * (2^k - 1)
            if (ext > 1) { x += ext - 1; br.skip(k); }
            else br.skip(k - 1);
        }
        return x;
    }

    // entropy decode one channel's prediction errors
    void rice_decompress(BitReader& br, int32_t* out, long n, int bps,
                         int hist_mult) {
        uint32_t history = (uint32_t)rice_initial_history;
        int sign_modifier = 0;
        for (long i = 0; i < n && !br.bad; ++i) {
            int k = log2u((history >> 9) + 3);
            if (k > rice_limit) k = rice_limit;
            uint32_t x = decode_scalar(br, k, bps) + (uint32_t)sign_modifier;
            sign_modifier = 0;
            out[i] = (int32_t)((x >> 1) ^ (uint32_t)-(int32_t)(x & 1));
            if (x > 0xFFFF) history = 0xFFFF;
            else history += x * (uint32_t)hist_mult
                            - ((history * (uint32_t)hist_mult) >> 9);
            // compressed zero runs
            if (history < 128 && i + 1 < n) {
                k = 7 - log2u(history) + (int)((history + 16) >> 6);
                if (k > rice_limit) k = rice_limit;
                uint32_t run = decode_scalar(br, k, 16);
                if (run > 0) {
                    if ((long)run >= n - i) run = (uint32_t)(n - i - 1);
                    memset(out + i + 1, 0, run * sizeof(int32_t));
                    i += run;
                }
                if (run <= 0xFFFF) sign_modifier = 1;
                history = 0;
            }
        }
    }

    // integer LPC reconstruction with per-sample coefficient adaptation
    static void lpc_predict(const int32_t* err, int32_t* out, long n, int bps,
                            int16_t* coefs, int order, int quant) {
        if (order == 0) {  // no predictor: errors are the samples
            if (out != err) memcpy(out, err, (size_t)n * sizeof(int32_t));
            return;
        }
        out[0] = err[0];
        if (n <= 1) return;
        if (order == 31) {  // special-cased first-order pass
            for (long i = 1; i < n; ++i)
                out[i] = sign_extend(out[i - 1] + err[i], bps);
            return;
        }
        long i = 1;
        for (; i <= order && i < n; ++i)
            out[i] = sign_extend(out[i - 1] + err[i], bps);
        for (; i < n; ++i) {
            int32_t d = out[i - order - 1];
            int64_t sum = 0;
            for (int j = 0; j < order; ++j)
                sum += (int64_t)(out[i - order + j] - d) * coefs[j];
            int32_t round = quant > 0 ? 1 << (quant - 1) : 0;
            int32_t val = (int32_t)((sum + round) >> quant);
            int32_t e = err[i];
            out[i] = sign_extend(val + d + e, bps);
            // adapt coefficients toward the error
            if (e > 0) {
                for (int j = 0; j < order && e > 0; ++j) {
                    int32_t v = d - out[i - order + j];
                    int sg = v > 0 ? 1 : (v < 0 ? -1 : 0);
                    coefs[j] -= (int16_t)sg;
                    v *= sg;
                    e -= (int32_t)((v >> quant) * (j + 1));
                }
            } else if (e < 0) {
                for (int j = 0; j < order && e < 0; ++j) {
                    int32_t v = d - out[i - order + j];
                    int sg = v > 0 ? 1 : (v < 0 ? -1 : 0);
                    coefs[j] += (int16_t)sg;
                    v *= -sg;
                    e -= (int32_t)((v >> quant) * (j + 1));
                }
            }
        }
    }

    // one SCE/CPE element; writes `nch` channels starting at ch_base.
    // Returns samples in the element or -1 on error.
    long decode_element(BitReader& br, int nch, int ch_base) {
        br.get(12);  // unused header bits (must be zero)
        int has_size = (int)br.get(1);
        int extra_bits = (int)br.get(2) << 3;  // bytes shifted * 8
        int uncompressed = (int)br.get(1);
        long n = has_size ? (long)br.get(32) : (long)frame_length;
        if (n < 1 || n > (long)frame_length) { fail("bad element size"); return -1; }
        int bps = sample_size - extra_bits + nch - 1;
        if (bps > 32 || bps < 1) { fail("bad bits per sample"); return -1; }

        int decorr_shift = 0, decorr_weight = 0;
        if (!uncompressed) {
            // interlacing bytes are present for mono elements too
            // (weight is simply 0 there)
            decorr_shift = (int)br.get(8);
            decorr_weight = (int)br.get(8);
            int pred_type[2], quant[2], pbf[2], order[2];
            int16_t coefs[2][MAX_ORDER];
            for (int c = 0; c < nch; ++c) {
                pred_type[c] = (int)br.get(4);
                quant[c] = (int)br.get(4);
                pbf[c] = (int)br.get(3);
                order[c] = (int)br.get(5);
                if (order[c] > MAX_ORDER) { fail("bad lpc order"); return -1; }
                for (int j = order[c] - 1; j >= 0; --j)
                    coefs[c][j] = (int16_t)br.get_s(16);
            }
            if (extra_bits) {
                for (long i = 0; i < n; ++i)
                    for (int c = 0; c < nch; ++c)
                        extra[ch_base + c][i] = (int32_t)br.get(extra_bits);
            }
            for (int c = 0; c < nch; ++c) {
                int hm = rice_history_mult * pbf[c] / 4;
                rice_decompress(br, pred, n, bps, hm);
                if (br.bad) { fail("entropy overrun"); return -1; }
                if (pred_type[c])
                    lpc_predict(pred, pred, n, bps, nullptr, 31, 0);
                lpc_predict(pred, bufs[ch_base + c], n, bps,
                            coefs[c], order[c], quant[c]);
            }
        } else {
            for (long i = 0; i < n; ++i)
                for (int c = 0; c < nch; ++c)
                    bufs[ch_base + c][i] = br.get_s(sample_size);
            extra_bits = 0;
        }
        if (br.bad) { fail("bitstream overrun"); return -1; }

        if (nch == 2 && decorr_weight) {
            int32_t* u = bufs[ch_base];
            int32_t* v = bufs[ch_base + 1];
            for (long i = 0; i < n; ++i) {
                int32_t a = u[i] - (int32_t)(((int64_t)v[i] * decorr_weight)
                                             >> decorr_shift);
                int32_t b = a + v[i];
                u[i] = b;
                v[i] = a;
            }
        }
        if (extra_bits) {
            for (int c = 0; c < nch; ++c)
                for (long i = 0; i < n; ++i)
                    bufs[ch_base + c][i] =
                        (int32_t)(((uint32_t)bufs[ch_base + c][i] << extra_bits)
                                  | (uint32_t)extra[ch_base + c][i]);
        }
        return n;
    }

    // decode one packet into interleaved int32 (low sample_size bits
    // significant); returns frames or -1
    long decode_packet(const uint8_t* pkt, long len, int32_t* out) {
        BitReader br(pkt, len);
        long n = -1;
        int ch_done = 0;
        while (ch_done < channels) {
            int element = (int)br.get(3);
            if (br.bad) { fail("truncated packet"); return -1; }
            if (element == 7) break;  // END
            int nch;
            if (element == 0 || element == 3) nch = 1;       // SCE / LFE
            else if (element == 1) nch = 2;                   // CPE
            else { fail("unsupported element"); return -1; }
            if (ch_done + nch > channels) {  // buffers sized for `channels`
                fail("element exceeds channel count");
                return -1;
            }
            br.get(4);  // instance tag
            long got = decode_element(br, nch, ch_done);
            if (got < 0) return -1;
            if (n >= 0 && got != n) { fail("element size mismatch"); return -1; }
            n = got;
            ch_done += nch;
        }
        if (n < 0) { fail("no audio element"); return -1; }
        for (long i = 0; i < n; ++i)
            for (int c = 0; c < channels; ++c)
                out[i * channels + c] = bufs[c][i];
        return n;
    }
};

}  // namespace

extern "C" {

void* skt_alac_new(const uint8_t* cookie, long cookie_len) {
    auto* d = new Decoder();
    if (!d->set_cookie(cookie, cookie_len)) { delete d; return nullptr; }
    return d;
}

void skt_alac_free(void* h) { delete (Decoder*)h; }

int skt_alac_channels(void* h) { return ((Decoder*)h)->channels; }
int skt_alac_sample_size(void* h) { return ((Decoder*)h)->sample_size; }
long skt_alac_sample_rate(void* h) { return (long)((Decoder*)h)->sample_rate; }
long skt_alac_frame_length(void* h) { return (long)((Decoder*)h)->frame_length; }
const char* skt_alac_error(void* h) { return ((Decoder*)h)->error; }

// out must hold frame_length * channels int32s; returns frames or -1
long skt_alac_decode(void* h, const uint8_t* pkt, long len, int32_t* out) {
    return ((Decoder*)h)->decode_packet(pkt, len, out);
}

}  // extern "C"
