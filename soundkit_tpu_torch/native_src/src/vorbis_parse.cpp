// Vorbis I audio-packet parse stage: bit unpack + codebook Huffman +
// floor1 curve + residue accumulate + inverse coupling + floor
// multiply, emitting the spectra the batched device synthesis
// (ops/vorbis_batch.py) consumes.  C++ port of the owned Python
// decoder's hot path (codecs/vorbis_core.py decode_packet_spectrum);
// header/setup parsing stays in Python, which pushes the parsed setup
// (codebooks with prebuilt VQ tables, floor1/residue/mapping/mode
// configs and the floor1 inverse-dB table) through the skt_vorbis_*
// setup calls below.  Floor0 streams are not exported — the Python
// path keeps them.
// Parity reference: soundkit-vorbis/src/lib.rs (lewton wrapper).
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

// ------------------------------------------------------------ bit reader
struct BR {
  const uint8_t* data;
  int64_t nbits, pos;
  bool fail = false;

  void init(const uint8_t* d, int64_t len) {
    data = d;
    nbits = len * 8;
    pos = 0;
    fail = false;
  }
  // LSB-first within bytes (Vorbis I spec 2)
  uint32_t read(int n) {
    if (n == 0) return 0;
    if (pos + n > nbits) {
      fail = true;
      pos = nbits;
      return 0;
    }
    uint32_t v = 0;
    int got = 0;
    int64_t p = pos;
    while (got < n) {
      int byte = data[p >> 3];
      int avail = 8 - (int)(p & 7);
      int take = avail < n - got ? avail : n - got;
      uint32_t bits = (uint32_t)(byte >> (p & 7)) & ((1u << take) - 1);
      v |= bits << got;
      got += take;
      p += take;
    }
    pos = p;
    return v;
  }
  int read1() {
    if (pos >= nbits) {
      fail = true;
      return 0;
    }
    int b = (data[pos >> 3] >> (pos & 7)) & 1;
    pos++;
    return b;
  }
};

// ------------------------------------------------------------ codebook
struct Node {
  int32_t child[2];  // negative: ~entry; positive: node index; 0 unset
};

struct Codebook {
  int dim = 0;
  int entries = 0;
  int single = -1;               // single-entry codebook: 0-bit code
  std::vector<Node> nodes;       // binary decode tree, root at 0
  // 8-bit root LUT: >=0 and len<=8 -> entry|len<<24; -1 -> walk tree
  int32_t lut[256];
  std::vector<double> vq;        // [entries * dim], empty if scalar-only
  bool has_vq = false;

  bool build(const int32_t* lengths) {
    nodes.clear();
    nodes.push_back({{0, 0}});
    int n_used = 0;
    for (int i = 0; i < entries; i++)
      if (lengths[i] > 0) n_used++;
    if (n_used == 1) {
      for (int i = 0; i < entries; i++)
        if (lengths[i] > 0) single = i;
      return true;
    }
    // canonical assignment: lowest available code per length, entry
    // order (vorbis_core.py Codebook.__init__ marker algorithm)
    uint32_t marker[33] = {0};
    for (int i = 0; i < entries; i++) {
      int l = lengths[i];
      if (l == 0) continue;
      uint32_t word = marker[l];
      if (word >> l) return false;  // over-subscribed
      // insert (l, word) -> i into the tree (MSB-first walk)
      int node = 0;
      for (int b = l - 1; b >= 0; b--) {
        int bit = (word >> b) & 1;
        if (b == 0) {
          nodes[node].child[bit] = ~i;
        } else {
          int nxt = nodes[node].child[bit];
          if (nxt == 0) {
            nodes.push_back({{0, 0}});
            nxt = (int)nodes.size() - 1;
            nodes[node].child[bit] = nxt;
          }
          node = nxt;
        }
      }
      for (int j = l; j > 0; j--) {
        if (marker[j] & 1) {
          if (j == 1) marker[1]++;
          else marker[j] = marker[j - 1] << 1;
          break;
        }
        marker[j]++;
      }
      for (int j = l + 1; j < 33; j++) {
        if ((marker[j] >> 1) == word) {
          word = marker[j];
          marker[j] = marker[j - 1] << 1;
        } else {
          break;
        }
      }
    }
    // root LUT over the first (up to) 8 bits, MSB-first code order
    for (int c = 0; c < 256; c++) {
      int node = 0;
      int32_t hit = -1;
      for (int b = 7; b >= 0; b--) {
        int bit = (c >> b) & 1;
        int32_t nxt = nodes[node].child[bit];
        if (nxt < 0) {
          hit = (~nxt) | ((8 - b) << 24);
          break;
        }
        if (nxt == 0) break;  // invalid prefix
        node = nxt;
      }
      lut[c] = hit;
    }
    return true;
  }

  // MSB-first canonical walk fed by the LSB-first bit reader
  int decode_scalar(BR& br) const {
    if (single >= 0) return single;
    // fast path: peek 8 bits when available
    if (br.pos + 8 <= br.nbits) {
      uint32_t peek = 0;
      int64_t p = br.pos;
      for (int i = 0; i < 8; i++)
        peek |= (uint32_t)((br.data[(p + i) >> 3] >> ((p + i) & 7)) & 1)
                << (7 - i);
      int32_t hit = lut[peek];
      if (hit >= 0) {
        br.pos += hit >> 24;
        return hit & 0xFFFFFF;
      }
    }
    int node = 0;
    for (int l = 0; l < 33; l++) {
      int bit = br.read1();
      if (br.fail) return -1;
      int32_t nxt = nodes[node].child[bit];
      if (nxt < 0) return ~nxt;
      if (nxt == 0) {
        br.fail = true;
        return -1;
      }
      node = nxt;
    }
    br.fail = true;
    return -1;
  }
};

// ------------------------------------------------------------ configs
struct Floor1 {
  std::vector<int> pcl, dims, subs, masters;
  std::vector<std::vector<int>> subbooks;
  int multiplier = 1;
  std::vector<int> xlist;
};

struct Residue {
  int kind, begin, end, psize, ncls, classbook;
  int books[64][8];
};

struct Mapping {
  int submaps;
  std::vector<int> coup_m, coup_a, mux, submap_floor, submap_residue;
};

struct Mode {
  int blockflag, mapping;
};

struct Vorbis {
  int channels, n0, n1, mode_bits;
  std::vector<Codebook> books;
  std::vector<Floor1> floors;     // only floor1 exported
  std::vector<Residue> residues;
  std::vector<Mapping> mappings;
  std::vector<Mode> modes;
  double inv_db[256];
  // scratch
  std::vector<double> res_out, curves;
  std::vector<uint8_t> has_floor;
  std::vector<int64_t> classifs;

  int ilog(int x) const {
    int n = 0;
    while (x > 0) {
      n++;
      x >>= 1;
    }
    return n;
  }
};

int64_t render_point(int64_t x0, int64_t y0, int64_t x1, int64_t y1,
                     int64_t x) {
  int64_t dy = y1 - y0;
  int64_t adx = x1 - x0;
  int64_t ady = dy < 0 ? -dy : dy;
  int64_t err = ady * (x - x0);
  int64_t off = err / adx;
  return dy < 0 ? y0 - off : y0 + off;
}

void render_line(int64_t x0, int64_t y0, int64_t x1, int64_t y1,
                 int32_t* v, int n2) {
  int64_t dy = y1 - y0;
  int64_t adx = x1 - x0;
  int64_t base = (dy < 0 ? -dy : dy) / adx;
  if (dy < 0) base = -base;
  int64_t sy = dy < 0 ? base - 1 : base + 1;
  int64_t ady = (dy < 0 ? -dy : dy) - (base < 0 ? -base : base) * adx;
  int64_t x1c = x1 < n2 ? x1 : n2;
  if (x0 < n2) v[x0] = (int32_t)y0;
  int64_t y = y0;
  int64_t err = 0;
  for (int64_t x = x0 + 1; x < x1c; x++) {
    err += ady;
    if (err >= adx) {
      err -= adx;
      y += sy;
    } else {
      y += base;
    }
    v[x] = (int32_t)y;
  }
}

// floor1 decode (vorbis_core.py Floor1.decode): fills curve[n2] with
// the linear-amplitude floor; returns false if the channel is unused.
bool floor1_decode(const Vorbis& s, const Floor1& f, BR& br, int n2,
                   double* curve) {
  if (!br.read1()) return false;
  static const int RANGES[4] = {256, 128, 86, 64};
  int rng = RANGES[f.multiplier - 1];
  int nx = (int)f.xlist.size();
  int64_t y[65];
  int bits = 0;
  {
    int x = rng - 1, n = 0;
    while (x > 0) {
      n++;
      x >>= 1;
    }
    bits = n;
  }
  y[0] = br.read(bits);
  y[1] = br.read(bits);
  int offset = 2;
  for (int p : f.pcl) {
    int cdim = f.dims[p];
    int cbits = f.subs[p];
    int csub = (1 << cbits) - 1;
    int cval = 0;
    if (cbits) {
      cval = s.books[f.masters[p]].decode_scalar(br);
      if (br.fail) return false;
    }
    for (int d = 0; d < cdim; d++) {
      int book = f.subbooks[p][cval & csub];
      cval >>= cbits;
      if (book >= 0) {
        y[offset] = s.books[book].decode_scalar(br);
        if (br.fail) return false;
      } else {
        y[offset] = 0;
      }
      offset++;
    }
  }
  if (br.fail) return false;

  // amplitude synthesis (spec 7.2.4 step 2)
  bool step2[65];
  int64_t fin[65];
  for (int i = 0; i < nx; i++) step2[i] = false;
  step2[0] = step2[1] = true;
  fin[0] = y[0];
  fin[1] = y[1];
  for (int i = 2; i < nx; i++) {
    int ln = 0, hn = 1;
    for (int j = 0; j < i; j++) {
      if (f.xlist[j] < f.xlist[i] && f.xlist[j] > f.xlist[ln]) ln = j;
      if (f.xlist[j] > f.xlist[i] && f.xlist[j] < f.xlist[hn]) hn = j;
    }
    int64_t predicted = render_point(f.xlist[ln], fin[ln], f.xlist[hn],
                                     fin[hn], f.xlist[i]);
    int64_t val = y[i];
    int64_t highroom = rng - predicted;
    int64_t lowroom = predicted;
    int64_t room = 2 * (highroom < lowroom ? highroom : lowroom);
    if (val) {
      step2[ln] = step2[hn] = step2[i] = true;
      if (val >= room) {
        fin[i] = highroom > lowroom ? val - lowroom + predicted
                                    : predicted - val + highroom - 1;
      } else {
        fin[i] = (val & 1) ? predicted - ((val + 1) >> 1)
                           : predicted + (val >> 1);
      }
    } else {
      step2[i] = false;
      fin[i] = predicted;
    }
  }

  // curve synthesis (step 3): posts in X order
  int order[65];
  for (int i = 0; i < nx; i++) order[i] = i;
  for (int i = 1; i < nx; i++) {  // insertion sort by xlist
    int k = order[i];
    int j = i - 1;
    while (j >= 0 && f.xlist[order[j]] > f.xlist[k]) {
      order[j + 1] = order[j];
      j--;
    }
    order[j + 1] = k;
  }
  std::vector<int32_t> cv(n2, 0);
  int64_t hx = 0, lx = 0;
  int64_t ly = (fin[0] < rng - 1 ? fin[0] : rng - 1) * f.multiplier;
  for (int oi = 0; oi < nx; oi++) {
    int i = order[oi];
    if (!step2[i] || i == 0) continue;
    int64_t hy = (fin[i] < rng - 1 ? fin[i] : rng - 1) * f.multiplier;
    hx = f.xlist[i];
    render_line(lx, ly, hx, hy, cv.data(), n2);
    lx = hx;
    ly = hy;
  }
  if (hx < n2)
    for (int64_t x = hx < n2 ? hx : n2; x < n2; x++) cv[x] = (int32_t)ly;
  for (int i = 0; i < n2; i++) {
    int idx = cv[i];
    if (idx < 0) idx = 0;
    if (idx > 255) idx = 255;
    curve[i] = s.inv_db[idx];
  }
  return true;
}

// residue decode (vorbis_core.py Residue._decode_loop); EOP mid-way
// keeps everything decoded so far (spec 1.1.3)
void residue_decode(const Vorbis& s, const Residue& r, BR& br,
                    const uint8_t* do_not_decode, int ch, double* out,
                    int64_t stride, int64_t actual_size,
                    std::vector<int64_t>& classifs) {
  int64_t limit_begin = r.begin < actual_size ? r.begin : actual_size;
  int64_t limit_end = r.end < actual_size ? r.end : actual_size;
  int64_t n_to_read = limit_end - limit_begin;
  if (n_to_read <= 0) return;
  int64_t ptr = n_to_read / r.psize;
  const Codebook& cbook = s.books[r.classbook];
  int cw = cbook.dim;
  classifs.assign((size_t)ch * (ptr + cw), 0);
  for (int p = 0; p < 8; p++) {
    int64_t pc = 0;
    while (pc < ptr) {
      if (p == 0) {
        for (int j = 0; j < ch; j++) {
          if (do_not_decode[j]) continue;
          int temp = cbook.decode_scalar(br);
          if (br.fail) return;
          for (int i = cw - 1; i >= 0; i--) {
            classifs[(size_t)j * (ptr + cw) + pc + i] =
                temp % r.ncls;
            temp /= r.ncls;
          }
        }
      }
      for (int w = 0; w < cw; w++) {
        if (pc >= ptr) break;
        for (int j = 0; j < ch; j++) {
          if (do_not_decode[j]) continue;
          int vq = (int)classifs[(size_t)j * (ptr + cw) + pc];
          int book = r.books[vq][p];
          if (book < 0) continue;
          const Codebook& bk = s.books[book];
          if (!bk.has_vq) {  // malformed setup: scalar book as VQ
            br.fail = true;
            return;
          }
          int64_t offset = limit_begin + pc * r.psize;
          double* dst = out + (size_t)j * stride;
          if (r.kind == 0) {
            int64_t step = r.psize / bk.dim;
            for (int64_t k = 0; k < step; k++) {
              int e = bk.decode_scalar(br);
              if (br.fail) return;
              const double* vec = bk.vq.data() + (size_t)e * bk.dim;
              for (int l = 0; l < bk.dim; l++)
                dst[offset + k + l * step] += vec[l];
            }
          } else {  // kind 1 (and 2 via interleave)
            int64_t k = 0;
            while (k < r.psize) {
              int e = bk.decode_scalar(br);
              if (br.fail) return;
              const double* vec = bk.vq.data() + (size_t)e * bk.dim;
              for (int l = 0; l < bk.dim; l++)
                dst[offset + k + l] += vec[l];
              k += bk.dim;
            }
          }
        }
        pc++;
      }
    }
  }
}

}  // namespace

extern "C" {

void* skt_vorbis_new(int channels, int n0, int n1,
                     const double* inv_db256) {
  Vorbis* s = new Vorbis();
  s->channels = channels;
  s->n0 = n0;
  s->n1 = n1;
  std::memcpy(s->inv_db, inv_db256, 256 * sizeof(double));
  return s;
}

void skt_vorbis_free(void* h) { delete (Vorbis*)h; }

int skt_vorbis_add_codebook(void* h, int dim, int entries,
                            const int32_t* lengths, const double* vq,
                            long vq_len) {
  Vorbis* s = (Vorbis*)h;
  s->books.emplace_back();
  Codebook& b = s->books.back();
  b.dim = dim;
  b.entries = entries;
  if (!b.build(lengths)) return -1;
  if (vq_len > 0) {
    b.vq.assign(vq, vq + vq_len);
    b.has_vq = true;
  }
  return 0;
}

int skt_vorbis_add_floor1(void* h, const int32_t* pcl, int npart,
                          const int32_t* dims, const int32_t* subs,
                          const int32_t* masters,
                          const int32_t* subbooks_flat, int nclasses,
                          int multiplier, const int32_t* xlist, int nx) {
  Vorbis* s = (Vorbis*)h;
  s->floors.emplace_back();
  Floor1& f = s->floors.back();
  f.pcl.assign(pcl, pcl + npart);
  f.dims.assign(dims, dims + nclasses);
  f.subs.assign(subs, subs + nclasses);
  f.masters.assign(masters, masters + nclasses);
  f.subbooks.resize(nclasses);
  const int32_t* p = subbooks_flat;
  for (int c = 0; c < nclasses; c++) {
    int n = 1 << subs[c];
    f.subbooks[c].assign(p, p + n);
    p += n;
  }
  f.multiplier = multiplier;
  f.xlist.assign(xlist, xlist + nx);
  return 0;
}

int skt_vorbis_add_residue(void* h, int kind, long begin, long end,
                           long psize, int ncls, int classbook,
                           const int32_t* books_flat) {
  Vorbis* s = (Vorbis*)h;
  if (ncls > 64) return -1;
  s->residues.emplace_back();
  Residue& r = s->residues.back();
  r.kind = kind;
  r.begin = (int)begin;
  r.end = (int)end;
  r.psize = (int)psize;
  r.ncls = ncls;
  r.classbook = classbook;
  for (int c = 0; c < ncls; c++)
    for (int p = 0; p < 8; p++)
      r.books[c][p] = books_flat[c * 8 + p];
  return 0;
}

int skt_vorbis_add_mapping(void* h, int submaps, const int32_t* coup_m,
                           const int32_t* coup_a, int nsteps,
                           const int32_t* mux, const int32_t* sm_floor,
                           const int32_t* sm_residue) {
  Vorbis* s = (Vorbis*)h;
  s->mappings.emplace_back();
  Mapping& m = s->mappings.back();
  m.submaps = submaps;
  m.coup_m.assign(coup_m, coup_m + nsteps);
  m.coup_a.assign(coup_a, coup_a + nsteps);
  m.mux.assign(mux, mux + s->channels);
  m.submap_floor.assign(sm_floor, sm_floor + submaps);
  m.submap_residue.assign(sm_residue, sm_residue + submaps);
  return 0;
}

int skt_vorbis_add_mode(void* h, int blockflag, int mapping) {
  Vorbis* s = (Vorbis*)h;
  s->modes.push_back({blockflag, mapping});
  return 0;
}

int skt_vorbis_finish(void* h) {
  Vorbis* s = (Vorbis*)h;
  int n = (int)s->modes.size() - 1;
  int bits = 0;
  while (n > 0) {
    bits++;
    n >>= 1;
  }
  s->mode_bits = bits;
  return 0;
}

// Decode one audio packet.  spectrum_out: [channels * n1/2] doubles
// (only the first n/2 of each channel row is meaningful).  Returns
// 0 = audio packet decoded, 1 = not an audio packet, negative = error.
int skt_vorbis_packet(void* h, const uint8_t* data, long len,
                      double* spectrum_out, int* n_out, int* prev_out,
                      int* next_out) {
  Vorbis* s = (Vorbis*)h;
  int ch = s->channels;
  int h1 = s->n1 / 2;
  BR br;
  br.init(data, len);
  if (br.read1() != 0 || br.fail) return 1;
  uint32_t mi = br.read(s->mode_bits);
  if (mi >= s->modes.size() || br.fail) return -2;
  const Mode& mode = s->modes[mi];
  int n = mode.blockflag ? s->n1 : s->n0;
  int prev = 1, next = 1;
  if (mode.blockflag) {
    prev = br.read1();
    next = br.read1();
  }
  int n2 = n / 2;
  const Mapping& map = s->mappings[mode.mapping];
  *n_out = n;
  *prev_out = prev;
  *next_out = next;
  std::memset(spectrum_out, 0, (size_t)ch * h1 * sizeof(double));

  // floors
  s->curves.assign((size_t)ch * n2, 0.0);
  s->has_floor.assign(ch, 0);
  std::vector<uint8_t> no_residue(ch, 0);
  for (int c = 0; c < ch; c++) {
    const Floor1& fl = s->floors[map.submap_floor[map.mux[c]]];
    bool got = floor1_decode(s[0], fl, br, n2,
                             s->curves.data() + (size_t)c * n2);
    if (br.fail) return 0;  // EOP in floor decode: silence packet
    s->has_floor[c] = got;
    no_residue[c] = !got;
  }

  // coupling forces both channels of a step on
  for (size_t k = 0; k < map.coup_m.size(); k++) {
    int m = map.coup_m[k], a = map.coup_a[k];
    if (!(no_residue[m] && no_residue[a]))
      no_residue[m] = no_residue[a] = 0;
  }

  s->res_out.assign((size_t)ch * n2, 0.0);
  std::vector<double> inter;
  for (int sm = 0; sm < map.submaps; sm++) {
    std::vector<int> idx;
    for (int c = 0; c < ch; c++)
      if (map.mux[c] == sm) idx.push_back(c);
    int nch = (int)idx.size();
    const Residue& r = s->residues[map.submap_residue[sm]];
    if (r.kind == 2) {
      bool all_dnd = true;
      for (int c : idx)
        if (!no_residue[c]) all_dnd = false;
      inter.assign((size_t)n2 * nch, 0.0);
      if (!all_dnd) {
        uint8_t dnd0 = 0;
        residue_decode(*s, r, br, &dnd0, 1, inter.data(),
                       (int64_t)n2 * nch, (int64_t)n2 * nch,
                       s->classifs);
      }
      // deinterleave
      for (int k = 0; k < nch; k++) {
        double* dst = s->res_out.data() + (size_t)idx[k] * n2;
        for (int i = 0; i < n2; i++) dst[i] = inter[(size_t)i * nch + k];
      }
    } else {
      std::vector<uint8_t> dnd(nch);
      for (int k = 0; k < nch; k++) dnd[k] = no_residue[idx[k]];
      inter.assign((size_t)nch * n2, 0.0);
      residue_decode(*s, r, br, dnd.data(), nch, inter.data(), n2, n2,
                     s->classifs);
      for (int k = 0; k < nch; k++)
        std::memcpy(s->res_out.data() + (size_t)idx[k] * n2,
                    inter.data() + (size_t)k * n2, n2 * sizeof(double));
    }
  }

  // inverse coupling, sign-bit convention (vorbis_core.py notes)
  for (int k = (int)map.coup_m.size() - 1; k >= 0; k--) {
    double* m = s->res_out.data() + (size_t)map.coup_m[k] * n2;
    double* a = s->res_out.data() + (size_t)map.coup_a[k] * n2;
    for (int i = 0; i < n2; i++) {
      double mv = m[i], av = a[i];
      double nm, na;
      if (mv >= 0) {
        nm = av > 0 ? mv : mv + av;
        na = av > 0 ? mv - av : mv;
      } else {
        nm = av > 0 ? mv : mv - av;
        na = av > 0 ? mv + av : mv;
      }
      m[i] = nm;
      a[i] = na;
    }
  }

  for (int c = 0; c < ch; c++) {
    if (!s->has_floor[c]) continue;
    const double* cv = s->curves.data() + (size_t)c * n2;
    const double* rs = s->res_out.data() + (size_t)c * n2;
    double* dst = spectrum_out + (size_t)c * h1;
    for (int i = 0; i < n2; i++) dst[i] = rs[i] * cv[i];
  }
  return 0;
}

}  // extern "C"
