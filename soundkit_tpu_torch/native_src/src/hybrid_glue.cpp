// Fused hybrid-Opus rounds walk (r4 VERDICT next #4).
//
// A hybrid packet codes SILK-WB then CELT (start band 17) on ONE
// shared range coder.  The round-4 serving path paid two ctypes
// round-trips plus fresh Python-side marshalling per (round) — this
// glue walks R rounds x B lanes in ONE call, chaining the existing
// exports: skt_silk_parse_many (silk_parse.cpp) exports the synthesis
// inputs and the final coder state per lane, and
// skt_celt_parse_many_cont (celt_parse.cpp) continues the same bytes
// from that state.  Outputs land in caller-provided [R, B, ...]
// planes ready for the chunked device dispatch.
//
// Reference role: soundkit-opus/src/lib.rs:295-430 per-pipeline
// hybrid decode (the repo owns the math; layout documented at the
// two chained exports).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

int skt_silk_parse_many(void** handles, int B, const uint8_t* buf,
                        const long* offs, const long* lens,
                        const int* bws, const int* coded,
                        const int* dur_ms, const unsigned char* valid,
                        double* exc, double* gains, double* coef,
                        double* ltp, double* ltpscale, double* stereo_w,
                        int* lags, int* flags, long* n_out, long* info);

int skt_celt_parse_many_cont(void** handles, int B, const uint8_t* buf,
                             const long* offs, const long* lens,
                             const int* starts, const int* ends,
                             const int* coded,
                             const unsigned char* valid,
                             const long* rc_init, int frame_size,
                             int Cmax, double* freq, double* comb,
                             int* sflag, int* ok, int* red);

// One call per chunk of R rounds.  Layouts (all row-major):
//   base  [B] i64   current byte offset of each lane's next packet in
//                   buf (per-lane packets are contiguous)
//   plens [B*R] i32 packet byte length per (lane, round); 0 = no
//                   packet this round (lane invalid, state frozen)
//   ends/coded [B*R] i32 per (lane, round)
//   silk outputs: exc [R*B*2*320] gains [R*B*2*4] coef [R*B*2*2*16]
//     ltp [R*B*2*4*5] ltpscale [R*B*2] stereo_w [R*B*4] f64,
//     lags [R*B*2*4] flags [R*B*12] i32, n_out [R*B] i64
//   celt outputs: freq [R*B*Cmax*frame_size] comb [R*B*16] f64,
//     sflag/ok/red [R*B] i32
// Returns 0 (per-lane failures surface via n_out / ok planes).
int skt_hybrid_parse_rounds(void** silk_h, void** celt_h, int B, int R,
                            const uint8_t* buf, const long* base,
                            const int* plens, const int* ends,
                            const int* coded, int frame_size, int Cmax,
                            double* exc, double* gains, double* coef,
                            double* ltp, double* ltpscale,
                            double* stereo_w, int* lags, int* flags,
                            long* n_out, double* freq, double* comb,
                            int* sflag, int* ok, int* red) {
  std::vector<long> cur(base, base + B);
  std::vector<long> offs(B), lens(B);
  std::vector<int> bws(B, 2), dur(B, 20), starts(B, 17);
  std::vector<int> coded_r(B), ends_r(B);
  std::vector<unsigned char> valid(B);
  std::vector<long> info((size_t)B * 13), rc((size_t)B * 9);
  for (int r = 0; r < R; r++) {
    int any = 0;
    for (int b = 0; b < B; b++) {
      long len = plens[(size_t)b * R + r];
      offs[b] = cur[b];
      lens[b] = len;
      valid[b] = len > 0;
      coded_r[b] = coded[(size_t)b * R + r];
      ends_r[b] = ends[(size_t)b * R + r];
      if (len > 0) {
        cur[b] += len;
        any = 1;
      }
    }
    if (!any) continue;
    size_t rb = (size_t)r * B;
    skt_silk_parse_many(silk_h, B, buf, offs.data(), lens.data(),
                        bws.data(), coded_r.data(), dur.data(),
                        valid.data(), exc + rb * 2 * 320,
                        gains + rb * 2 * 4, coef + rb * 2 * 2 * 16,
                        ltp + rb * 2 * 4 * 5, ltpscale + rb * 2,
                        stereo_w + rb * 4, lags + rb * 2 * 4,
                        flags + rb * 12, n_out + rb,
                        info.data());
    for (int b = 0; b < B; b++)
      memcpy(rc.data() + (size_t)b * 9, info.data() + (size_t)b * 13 + 4,
             9 * sizeof(long));
    skt_celt_parse_many_cont(celt_h, B, buf, offs.data(), lens.data(),
                             starts.data(), ends_r.data(), coded_r.data(),
                             valid.data(), rc.data(), frame_size, Cmax,
                             freq + rb * (size_t)Cmax * frame_size,
                             comb + rb * 16, sflag + rb, ok + rb,
                             red + rb);
  }
  return 0;
}

// Packed-wire variant: same walk, but every device-bound plane is
// converted in native code straight into the caller's packed uint8
// wire (the _hybrid_wire_layout in models/opus_batch.py) — the
// Python side was spending ~0.5 s/pass on f64->f32/i16 numpy
// conversions on the 1-core host.  ``off`` is the field-offset table
// in layout order: [exc, gains, coef, ltp, ltpscale, stereo_w, freq,
// comb, lags, hl, vo, cc, um, sr, sflag] (fresh/gain48/valid are
// Python-written).  The excitation ships as int16 in integer Q23
// units (silk_parse.cpp exports e / 2^23); returns 1 if any |e|
// overflowed int16, in which case the full f64 excitation is ALSO
// copied to ``exc_f64`` so the caller can build the f32 wire without
// re-walking the stateful decoder handles (SILK parameters are
// delta-coded across frames — a re-walk would corrupt them).
// ``bin_lo``/``bin_len`` trim the CELT spectrum to the coded hybrid
// window ([320, 800) at the 960 frame size).
int skt_hybrid_parse_rounds_packed(
    void** silk_h, void** celt_h, int B, int R, const uint8_t* buf,
    const long* base, const int* plens, const int* ends,
    const int* coded, int frame_size, int Cmax, int bin_lo,
    int bin_len, uint8_t* wire, const long* off, long* n_out,
    int* ok, int* red, double* exc_f64) {
  size_t rb = (size_t)R * B;
  std::vector<double> exc(rb * 2 * 320), gains(rb * 2 * 4),
      coef(rb * 2 * 2 * 16), ltp(rb * 2 * 4 * 5), ltpscale(rb * 2),
      stereo_w(rb * 4), freq(rb * (size_t)Cmax * frame_size),
      comb(rb * 16);
  std::vector<int> lags(rb * 2 * 4), flags(rb * 12), sflag(rb);
  skt_hybrid_parse_rounds(
      silk_h, celt_h, B, R, buf, base, plens, ends, coded, frame_size,
      Cmax, exc.data(), gains.data(), coef.data(), ltp.data(),
      ltpscale.data(), stereo_w.data(), lags.data(), flags.data(),
      n_out, freq.data(), comb.data(), sflag.data(), ok, red);
  auto f32 = [&](int fi, const double* src, size_t n) {
    float* dst = (float*)(wire + off[fi]);
    for (size_t i = 0; i < n; i++) dst[i] = (float)src[i];
  };
  int overflow = 0;
  {
    int16_t* dst = (int16_t*)(wire + off[0]);
    for (size_t i = 0; i < exc.size(); i++) {
      double e = exc[i] * 8388608.0;
      if (e > 32766.5 || e < -32766.5) {
        overflow = 1;
        e = e > 0 ? 32767.0 : -32767.0;
      }
      dst[i] = (int16_t)llround(e);
    }
    if (overflow && exc_f64)
      memcpy(exc_f64, exc.data(), exc.size() * sizeof(double));
  }
  f32(1, gains.data(), gains.size());
  f32(2, coef.data(), coef.size());
  f32(3, ltp.data(), ltp.size());
  f32(4, ltpscale.data(), ltpscale.size());
  f32(5, stereo_w.data(), stereo_w.size());
  {
    float* dst = (float*)(wire + off[6]);
    const double* src = freq.data() + bin_lo;
    size_t rows = rb * (size_t)Cmax;
    for (size_t r = 0; r < rows; r++)
      for (int i = 0; i < bin_len; i++)
        dst[r * bin_len + i] = (float)src[r * frame_size + i];
  }
  f32(7, comb.data(), comb.size());
  memcpy(wire + off[8], lags.data(), lags.size() * sizeof(int));
  {
    int* hl = (int*)(wire + off[9]);
    int* vo = (int*)(wire + off[10]);
    int* cc = (int*)(wire + off[11]);
    int* um = (int*)(wire + off[12]);
    int* sr = (int*)(wire + off[13]);
    for (size_t i = 0; i < rb; i++) {
      const int* f = flags.data() + i * 12;
      hl[i * 2] = f[7];
      hl[i * 2 + 1] = f[8];
      vo[i * 2] = f[5];
      vo[i * 2 + 1] = f[6];
      cc[i * 2] = f[9];
      cc[i * 2 + 1] = f[10];
      um[i] = f[2] == 2;
      sr[i] = f[4];
    }
  }
  memcpy(wire + off[14], sflag.data(), sflag.size() * sizeof(int));
  return overflow;
}

}  // extern "C"
