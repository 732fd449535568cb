// Host-side library of psdr_jit_tpu_torch: the work that is not device
// compute. The same algorithms and file formats as the JAX package's host
// library, kept here as the port's own copy: the Morton order of triangle
// centroids, the edge list of a triangle mesh (mesh.cpp:112-149), an OBJ
// parser (the tinyobjloader subset of mesh.cpp:165-314) and EXR read and
// write (src/core/bitmap_loader.cpp).
//
// A plain C interface, bound with ctypes (native/__init__.py), which builds
// it at first use:
//   g++ -O3 -shared -fPIC -std=c++17 hostops.cpp -o libhostops.so -lz
//
// EXR support: scanline images, compression NONE / ZIPS / ZIP / PIZ, pixel
// types HALF / FLOAT / UINT; the reference's environment map
// (ballroom_1k.exr) is PIZ. Tiled, deep and multipart files are rejected.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// Morton ordering (for triangle clustering)
// ---------------------------------------------------------------------------

static inline uint32_t expand_bits_10(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

// centroids: (n, 3) float32.  Writes a permutation of [0, n) sorted by the
// 30-bit Morton code of each centroid inside the overall bounding box.
void morton_order(const float* centroids, int64_t n, int32_t* order_out) {
  if (n <= 0) return;
  float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < n; ++i)
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], centroids[3 * i + k]);
      hi[k] = std::max(hi[k], centroids[3 * i + k]);
    }
  float inv[3];
  for (int k = 0; k < 3; ++k) {
    float ext = hi[k] - lo[k];
    inv[k] = ext > 0 ? 1023.0f / ext : 0.0f;
  }
  std::vector<std::pair<uint32_t, int32_t>> keys(n);
  for (int64_t i = 0; i < n; ++i) {
    uint32_t code = 0;
    for (int k = 0; k < 3; ++k) {
      float f = (centroids[3 * i + k] - lo[k]) * inv[k];
      uint32_t q = (uint32_t)std::min(std::max(f, 0.0f), 1023.0f);
      code |= expand_bits_10(q) << (2 - k);
    }
    keys[i] = {code, (int32_t)i};
  }
  std::stable_sort(keys.begin(), keys.end());
  for (int64_t i = 0; i < n; ++i) order_out[i] = keys[i].second;
}

// ---------------------------------------------------------------------------
// Edge-map construction (mesh.cpp:112-149 semantics)
// ---------------------------------------------------------------------------

// faces: (nf, 3) int32.  out: capacity 3*nf rows of 5 int32
// [v_lo, v_hi, face0, face1|-1, third_vertex_of_face0]; face0 is the
// lowest-index face containing the edge.  Returns the number of edges.
int64_t build_edge_list(const int32_t* faces, int64_t nf, int32_t* out) {
  struct DirEdge {
    int32_t lo, hi, face, third;
  };
  std::vector<DirEdge> edges;
  edges.reserve(3 * nf);
  for (int64_t f = 0; f < nf; ++f) {
    const int32_t* v = faces + 3 * f;
    const int32_t pairs[3][3] = {
        {v[0], v[1], v[2]}, {v[1], v[2], v[0]}, {v[2], v[0], v[1]}};
    for (int e = 0; e < 3; ++e) {
      DirEdge de;
      de.lo = std::min(pairs[e][0], pairs[e][1]);
      de.hi = std::max(pairs[e][0], pairs[e][1]);
      de.face = (int32_t)f;
      de.third = pairs[e][2];
      edges.push_back(de);
    }
  }
  std::stable_sort(edges.begin(), edges.end(),
                   [](const DirEdge& a, const DirEdge& b) {
                     if (a.lo != b.lo) return a.lo < b.lo;
                     if (a.hi != b.hi) return a.hi < b.hi;
                     return a.face < b.face;
                   });
  int64_t ne = 0;
  for (size_t i = 0; i < edges.size();) {
    size_t j = i + 1;
    while (j < edges.size() && edges[j].lo == edges[i].lo &&
           edges[j].hi == edges[i].hi)
      ++j;
    int32_t* row = out + 5 * ne;
    row[0] = edges[i].lo;
    row[1] = edges[i].hi;
    row[2] = edges[i].face;
    row[3] = (j - i >= 2) ? edges[i + 1].face : -1;
    row[4] = edges[i].third;
    ++ne;
    i = j;
  }
  return ne;
}

// ---------------------------------------------------------------------------
// OBJ parsing (tinyobjloader-equivalent subset: v / vt / f with fan
// triangulation and negative indices)
// ---------------------------------------------------------------------------

struct ObjData {
  std::vector<float> vertices;  // 3 per vertex
  std::vector<float> uvs;       // 2 per uv
  std::vector<int32_t> faces;     // 3 per face
  std::vector<int32_t> face_uvs;  // 3 per face (-1 = none)
  bool any_uv = false;
};

ObjData* obj_parse(const char* text, int64_t len) {
  ObjData* d = new ObjData();
  const char* p = text;
  const char* end = text + len;
  std::vector<std::pair<int32_t, int32_t>> corners;
  while (p < end) {
    // find line end
    const char* eol = (const char*)memchr(p, '\n', end - p);
    if (!eol) eol = end;
    // skip leading spaces
    const char* q = p;
    while (q < eol && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
    if (q + 1 < eol && q[0] == 'v' && (q[1] == ' ' || q[1] == '\t')) {
      char* rest = nullptr;
      double x = strtod(q + 2, &rest);
      double y = strtod(rest, &rest);
      double z = strtod(rest, &rest);
      d->vertices.push_back((float)x);
      d->vertices.push_back((float)y);
      d->vertices.push_back((float)z);
    } else if (q + 2 < eol && q[0] == 'v' && q[1] == 't' &&
               (q[2] == ' ' || q[2] == '\t')) {
      char* rest = nullptr;
      double u = strtod(q + 3, &rest);
      double v = strtod(rest, &rest);
      d->uvs.push_back((float)u);
      d->uvs.push_back((float)v);
    } else if (q + 1 < eol && q[0] == 'f' && (q[1] == ' ' || q[1] == '\t')) {
      corners.clear();
      const char* t = q + 2;
      int64_t nv = (int64_t)d->vertices.size() / 3;
      int64_t nt = (int64_t)d->uvs.size() / 2;
      while (t < eol) {
        while (t < eol && (*t == ' ' || *t == '\t' || *t == '\r')) ++t;
        if (t >= eol) break;
        char* rest = nullptr;
        long vi = strtol(t, &rest, 10);
        long ti = 0;
        bool has_t = false;
        if (rest < eol && *rest == '/') {
          ++rest;
          if (rest < eol && *rest != '/') {
            ti = strtol(rest, &rest, 10);
            has_t = true;
          }
          if (rest < eol && *rest == '/') {  // normal index — skipped
            ++rest;
            strtol(rest, &rest, 10);
          }
        }
        int32_t v_idx = vi > 0 ? (int32_t)(vi - 1) : (int32_t)(nv + vi);
        int32_t t_idx = -1;
        if (has_t) {
          t_idx = ti > 0 ? (int32_t)(ti - 1) : (int32_t)(nt + ti);
          d->any_uv = true;
        }
        corners.push_back({v_idx, t_idx});
        t = rest;
      }
      for (size_t k = 1; k + 1 < corners.size(); ++k) {
        d->faces.push_back(corners[0].first);
        d->faces.push_back(corners[k].first);
        d->faces.push_back(corners[k + 1].first);
        d->face_uvs.push_back(corners[0].second);
        d->face_uvs.push_back(corners[k].second);
        d->face_uvs.push_back(corners[k + 1].second);
      }
    }
    p = eol + 1;
  }
  return d;
}

int64_t obj_num_vertices(ObjData* d) { return (int64_t)d->vertices.size() / 3; }
int64_t obj_num_uvs(ObjData* d) { return (int64_t)d->uvs.size() / 2; }
int64_t obj_num_faces(ObjData* d) { return (int64_t)d->faces.size() / 3; }
int32_t obj_has_uv(ObjData* d) { return d->any_uv ? 1 : 0; }
void obj_copy(ObjData* d, float* verts, float* uvs, int32_t* faces,
              int32_t* face_uvs) {
  if (verts && !d->vertices.empty())
    memcpy(verts, d->vertices.data(), d->vertices.size() * sizeof(float));
  if (uvs && !d->uvs.empty())
    memcpy(uvs, d->uvs.data(), d->uvs.size() * sizeof(float));
  if (faces && !d->faces.empty())
    memcpy(faces, d->faces.data(), d->faces.size() * sizeof(int32_t));
  if (face_uvs && !d->face_uvs.empty())
    memcpy(face_uvs, d->face_uvs.data(), d->face_uvs.size() * sizeof(int32_t));
}
void obj_free(ObjData* d) { delete d; }

// ---------------------------------------------------------------------------
// EXR (scanline; NONE / ZIPS / ZIP; HALF / FLOAT / UINT)
// ---------------------------------------------------------------------------

static inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h >> 15) << 31;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t man = h & 0x3FF;
  uint32_t f;
  if (exp == 0) {
    if (man == 0) {
      f = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while (!(man & 0x400)) {
        man <<= 1;
        --exp;
      }
      man &= 0x3FF;
      f = sign | (exp << 23) | (man << 13);
    }
  } else if (exp == 31) {
    f = sign | 0x7F800000u | (man << 13);
  } else {
    f = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float out;
  memcpy(&out, &f, 4);
  return out;
}

static inline uint16_t float_to_half(float x) {
  uint32_t f;
  memcpy(&f, &x, 4);
  uint32_t sign = (f >> 31) << 15;
  int32_t exp = (int32_t)((f >> 23) & 0xFF) - 127 + 15;
  uint32_t man = f & 0x7FFFFF;
  if (exp <= 0) return (uint16_t)sign;  // flush to zero
  if (exp >= 31) return (uint16_t)(sign | 0x7C00);
  return (uint16_t)(sign | ((uint32_t)exp << 10) | (man >> 13));
}

// EXR "reorder" decode: inflate output -> delta reconstruct -> deinterleave.
static void exr_postdecompress(std::vector<uint8_t>& buf) {
  size_t n = buf.size();
  for (size_t i = 1; i < n; ++i)
    buf[i] = (uint8_t)((int)buf[i] + (int)buf[i - 1] - 128);
  std::vector<uint8_t> out(n);
  size_t half = (n + 1) / 2;
  const uint8_t* s1 = buf.data();
  const uint8_t* s2 = buf.data() + half;
  for (size_t i = 0; i < n; ++i)
    out[i] = (i & 1) ? s2[i / 2] : s1[i / 2];
  buf.swap(out);
}

static void exr_precompress(std::vector<uint8_t>& buf) {
  size_t n = buf.size();
  std::vector<uint8_t> tmp(n);
  size_t half = (n + 1) / 2;
  for (size_t i = 0; i < n; ++i) {
    if (i & 1)
      tmp[half + i / 2] = buf[i];
    else
      tmp[i / 2] = buf[i];
  }
  for (size_t i = n; i-- > 1;)
    tmp[i] = (uint8_t)((int)tmp[i] - (int)tmp[i - 1] + 128);
  buf.swap(tmp);
}

struct ExrChannel {
  std::string name;
  int32_t pixel_type;  // 0 UINT, 1 HALF, 2 FLOAT
};

// ===========================================================================
// PIZ codec (wavelet + Huffman), written from the OpenEXR format
// specification.  Replaces the reference's vendored tinyexr PIZ path
// (include/misc/tinyexr.h) — real-world envmap assets (e.g. the reference's
// own ballroom_1k.exr) ship PIZ-compressed.
// ===========================================================================

static const int PIZ_BITMAP_BYTES = 8192;  // 65536 bits
static const int HUF_ENCSIZE = 65537;      // 16-bit symbols + 1 rlc slot
static const int HUF_MAXLEN = 58;          // code lengths fit in 6 bits < 59

// -- bit streams (MSB-first, as the EXR Huffman format specifies) -----------

struct BitOut {
  std::vector<uint8_t> bytes;
  uint64_t acc = 0;
  int nbits = 0;
  uint64_t total_bits = 0;
  void put(int n, uint64_t v) {
    acc = (acc << n) | (v & ((n == 64) ? ~0ull : ((1ull << n) - 1)));
    nbits += n;
    total_bits += n;
    while (nbits >= 8) {
      nbits -= 8;
      bytes.push_back((uint8_t)(acc >> nbits));
    }
  }
  void flush() {
    if (nbits > 0) {
      bytes.push_back((uint8_t)(acc << (8 - nbits)));
      nbits = 0;
    }
  }
};

struct BitIn {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;
  bool overrun = false;
  BitIn(const uint8_t* data, size_t len) : p(data), end(data + len) {}
  uint64_t get(int n) {
    while (nbits < n) {
      if (p >= end) {
        overrun = true;
        return 0;
      }
      acc = (acc << 8) | *p++;
      nbits += 8;
    }
    nbits -= n;
    return (acc >> nbits) & ((n == 64) ? ~0ull : ((1ull << n) - 1));
  }
};

// -- canonical Huffman codes from lengths (the EXR canonical rule) ----------

static void huf_canonical_codes(const uint8_t* len, uint64_t* code) {
  uint64_t n[HUF_MAXLEN + 1] = {0};
  for (int i = 0; i < HUF_ENCSIZE; ++i) n[len[i]] += 1;
  uint64_t c = 0;
  for (int i = HUF_MAXLEN; i > 0; --i) {
    uint64_t nc = (c + n[i]) >> 1;
    n[i] = c;
    c = nc;
  }
  for (int i = 0; i < HUF_ENCSIZE; ++i)
    code[i] = (len[i] > 0) ? n[len[i]]++ : 0;
}

// -- packed code-length table (6-bit lengths with zero-run codes) -----------

static const int SHORT_ZEROCODE_RUN = 59;
static const int LONG_ZEROCODE_RUN = 63;
static const int SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN;

static void huf_pack_table(const uint8_t* len, int im, int iM, BitOut& out) {
  for (int i = im; i <= iM;) {
    int l = len[i];
    if (l == 0) {
      int z = 1;
      while (i + z <= iM && len[i + z] == 0 && z < 255 + SHORTEST_LONG_RUN)
        ++z;
      if (z >= SHORTEST_LONG_RUN) {
        out.put(6, LONG_ZEROCODE_RUN);
        out.put(8, z - SHORTEST_LONG_RUN);
        i += z;
      } else if (z >= 2) {
        out.put(6, SHORT_ZEROCODE_RUN + z - 2);
        i += z;
      } else {
        out.put(6, 0);
        ++i;
      }
    } else {
      out.put(6, l);
      ++i;
    }
  }
}

static bool huf_unpack_table(BitIn& in, int im, int iM, uint8_t* len) {
  memset(len, 0, HUF_ENCSIZE);
  for (int i = im; i <= iM;) {
    int l = (int)in.get(6);
    if (in.overrun) return false;
    if (l == LONG_ZEROCODE_RUN) {
      int z = (int)in.get(8) + SHORTEST_LONG_RUN;
      if (i + z > iM + 1) return false;
      i += z;
    } else if (l >= SHORT_ZEROCODE_RUN) {
      int z = l - SHORT_ZEROCODE_RUN + 2;
      if (i + z > iM + 1) return false;
      i += z;
    } else {
      len[i++] = (uint8_t)l;
    }
  }
  return !in.overrun;
}

// -- Huffman code-length construction (heap Huffman, flattened to <= 58) ----

static void huf_build_lengths(const uint64_t* freq, uint8_t* len) {
  struct Node {
    uint64_t w;
    int idx;  // < HUF_ENCSIZE: leaf symbol; else internal node id
  };
  std::vector<uint64_t> f(freq, freq + HUF_ENCSIZE);
  for (int attempt = 0;; ++attempt) {
    memset(len, 0, HUF_ENCSIZE);
    std::vector<int> syms;
    for (int i = 0; i < HUF_ENCSIZE; ++i)
      if (f[i]) syms.push_back(i);
    if (syms.empty()) return;
    if (syms.size() == 1) {
      len[syms[0]] = 1;
      return;
    }
    // heap of (weight, node); internal nodes get parents recorded
    auto cmp = [](const Node& a, const Node& b) { return a.w > b.w; };
    std::vector<Node> heap;
    std::vector<int> parent(syms.size() * 2, -1);
    std::vector<int> leaf_of(syms.size());
    for (size_t k = 0; k < syms.size(); ++k) {
      heap.push_back({f[syms[k]], (int)k});
      leaf_of[k] = syms[k];
    }
    std::make_heap(heap.begin(), heap.end(), cmp);
    int next_id = (int)syms.size();
    while (heap.size() > 1) {
      std::pop_heap(heap.begin(), heap.end(), cmp);
      Node a = heap.back();
      heap.pop_back();
      std::pop_heap(heap.begin(), heap.end(), cmp);
      Node b = heap.back();
      heap.pop_back();
      parent[a.idx] = next_id;
      parent[b.idx] = next_id;
      if ((size_t)next_id + 1 > parent.size()) parent.resize(next_id + 1, -1);
      heap.push_back({a.w + b.w, next_id++});
      std::push_heap(heap.begin(), heap.end(), cmp);
    }
    int maxlen = 0;
    for (size_t k = 0; k < syms.size(); ++k) {
      int d = 0;
      for (int n = (int)k; parent[n] >= 0; n = parent[n]) ++d;
      len[leaf_of[k]] = (uint8_t)d;
      if (d > maxlen) maxlen = d;
    }
    if (maxlen <= HUF_MAXLEN) return;
    // flatten the distribution and retry (rare pathological skew)
    for (int i = 0; i < HUF_ENCSIZE; ++i)
      if (f[i]) f[i] = (f[i] >> 1) + 1;
  }
}

// -- Huffman encode/decode with the EXR run-length extension ----------------

static void huf_send(BitOut& out, uint64_t scode, int slen, int run,
                     uint64_t rcode, int rlen) {
  // emits the symbol (run + 1) times, using the run-length code when shorter
  if (slen + rlen + 8 < slen * (run + 1)) {
    out.put(slen, scode);
    out.put(rlen, rcode);
    out.put(8, (uint64_t)run);
  } else {
    for (int i = 0; i <= run; ++i) out.put(slen, scode);
  }
}

static void huf_encode_data(const uint16_t* raw, size_t n, const uint8_t* len,
                            const uint64_t* code, int rlc, BitOut& out) {
  if (n == 0) return;
  int cs = raw[0];
  int run = 0;
  for (size_t i = 1; i < n; ++i) {
    if ((int)raw[i] == cs && run < 255) {
      ++run;
    } else {
      huf_send(out, code[cs], len[cs], run, code[rlc], len[rlc]);
      cs = raw[i];
      run = 0;
    }
  }
  huf_send(out, code[cs], len[cs], run, code[rlc], len[rlc]);
}

static bool huf_decode_data(BitIn& in, uint64_t nbits, const uint8_t* len,
                            int rlc, uint16_t* out, size_t n_out) {
  // per-length first-code + symbol lists for canonical decode
  uint64_t first[HUF_MAXLEN + 1];
  {
    uint64_t n[HUF_MAXLEN + 1] = {0};
    for (int i = 0; i < HUF_ENCSIZE; ++i) n[len[i]] += 1;
    uint64_t c = 0;
    for (int i = HUF_MAXLEN; i > 0; --i) {
      uint64_t nc = (c + n[i]) >> 1;
      first[i] = c;
      c = nc;
    }
  }
  std::vector<std::vector<int>> syms(HUF_MAXLEN + 1);
  for (int i = 0; i < HUF_ENCSIZE; ++i)
    if (len[i] > 0) syms[len[i]].push_back(i);

  size_t produced = 0;
  uint64_t used_bits = 0;
  int last = -1;
  uint64_t c = 0;
  int l = 0;
  while (produced < n_out && used_bits < nbits) {
    c = (c << 1) | in.get(1);
    ++used_bits;
    if (in.overrun) return false;
    if (++l > HUF_MAXLEN) return false;
    const std::vector<int>& sl = syms[l];
    if (!sl.empty() && c >= first[l] && c - first[l] < sl.size()) {
      int s = sl[c - first[l]];
      c = 0;
      l = 0;
      if (s == rlc) {
        if (last < 0 || used_bits + 8 > nbits) return false;
        int cnt = (int)in.get(8);
        used_bits += 8;
        if (in.overrun || produced + cnt > n_out) return false;
        for (int k = 0; k < cnt; ++k) out[produced++] = (uint16_t)last;
      } else {
        if (produced >= n_out) return false;
        out[produced++] = (uint16_t)s;
        last = s;
      }
    }
  }
  return produced == n_out && l == 0;
}

static void huf_compress(const uint16_t* raw, size_t n,
                         std::vector<uint8_t>& out) {
  uint64_t freq[HUF_ENCSIZE] = {0};
  for (size_t i = 0; i < n; ++i) freq[raw[i]] += 1;
  int iM = HUF_ENCSIZE - 1;
  while (iM > 0 && !freq[iM]) --iM;
  int rlc = (n > 0) ? iM + 1 : 1;  // run-length pseudo-symbol past the data
  freq[rlc] = 1;
  iM = rlc;
  int im = 0;
  while (!freq[im]) ++im;

  uint8_t len[HUF_ENCSIZE];
  uint64_t code[HUF_ENCSIZE];
  huf_build_lengths(freq, len);
  huf_canonical_codes(len, code);

  BitOut table;
  huf_pack_table(len, im, iM, table);
  table.flush();
  BitOut data;
  huf_encode_data(raw, n, len, code, rlc, data);
  uint64_t nbits = data.total_bits;
  data.flush();

  out.resize(20 + table.bytes.size() + data.bytes.size());
  uint32_t hdr[5] = {(uint32_t)im, (uint32_t)iM,
                     (uint32_t)table.bytes.size(), (uint32_t)nbits, 0};
  memcpy(out.data(), hdr, 20);
  memcpy(out.data() + 20, table.bytes.data(), table.bytes.size());
  memcpy(out.data() + 20 + table.bytes.size(), data.bytes.data(),
         data.bytes.size());
}

static bool huf_uncompress(const uint8_t* in, size_t in_len, uint16_t* out,
                           size_t n_out) {
  if (in_len < 20) return false;
  uint32_t hdr[5];
  memcpy(hdr, in, 20);
  int im = (int)hdr[0], iM = (int)hdr[1];
  uint64_t nbits = hdr[3];
  if (im < 0 || iM >= HUF_ENCSIZE || im > iM) return false;
  if (20 + (nbits + 7) / 8 > in_len + 8) return false;
  BitIn tin(in + 20, in_len - 20);
  static thread_local std::vector<uint8_t> len_store(HUF_ENCSIZE);
  uint8_t* len = len_store.data();
  if (!huf_unpack_table(tin, im, iM, len)) return false;
  // data begins on the byte boundary after the packed table
  size_t table_bytes = (size_t)(tin.p - (in + 20)) - tin.nbits / 8;
  BitIn din(in + 20 + table_bytes, in_len - 20 - table_bytes);
  return huf_decode_data(din, nbits, len, iM, out, n_out);
}

// -- 2D wavelet (the EXR wav2 transform) ------------------------------------

static const int W16_NBITS = 16;
static const int W16_A_OFFSET = 1 << (W16_NBITS - 1);
static const int W16_MOD_MASK = (1 << W16_NBITS) - 1;

static inline void wenc14(uint16_t a, uint16_t b, uint16_t& l, uint16_t& h) {
  int16_t as = (int16_t)a, bs = (int16_t)b;
  int16_t ms = (int16_t)((as + bs) >> 1);
  int16_t ds = (int16_t)(as - bs);
  l = (uint16_t)ms;
  h = (uint16_t)ds;
}

static inline void wdec14(uint16_t l, uint16_t h, uint16_t& a, uint16_t& b) {
  int16_t ls = (int16_t)l, hs = (int16_t)h;
  int hi = hs;
  int ai = ls + (hi & 1) + (hi >> 1);
  int16_t as = (int16_t)ai;
  int16_t bs = (int16_t)(ai - hi);
  a = (uint16_t)as;
  b = (uint16_t)bs;
}

static inline void wenc16(uint16_t a, uint16_t b, uint16_t& l, uint16_t& h) {
  int ao = (a + W16_A_OFFSET) & W16_MOD_MASK;
  int m = (ao + b) >> 1;
  int d = ao - b;
  if (d < 0) m = (m + W16_A_OFFSET) & W16_MOD_MASK;
  d &= W16_MOD_MASK;
  l = (uint16_t)m;
  h = (uint16_t)d;
}

static inline void wdec16(uint16_t l, uint16_t h, uint16_t& a, uint16_t& b) {
  int m = l, d = h;
  int bb = (m - (d >> 1)) & W16_MOD_MASK;
  int aa = (d + bb - W16_A_OFFSET) & W16_MOD_MASK;
  b = (uint16_t)bb;
  a = (uint16_t)aa;
}

static void wav2_encode(uint16_t* in, int nx, int ox, int ny, int oy,
                        uint16_t mx) {
  bool w14 = mx < (1 << 14);
  int n = (nx > ny) ? ny : nx;
  int p = 1, p2 = 2;
  while (p2 <= n) {
    uint16_t* py = in;
    uint16_t* ey = in + (size_t)oy * (ny - p2);
    int oy1 = oy * p, oy2 = oy * p2, ox1 = ox * p, ox2 = ox * p2;
    uint16_t i00, i01, i10, i11;
    for (; py <= ey; py += oy2) {
      uint16_t* px = py;
      uint16_t* ex = py + (size_t)ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        uint16_t* p10 = px + oy1;
        uint16_t* p11 = p10 + ox1;
        if (w14) {
          wenc14(*px, *p01, i00, i01);
          wenc14(*p10, *p11, i10, i11);
          wenc14(i00, i10, *px, *p10);
          wenc14(i01, i11, *p01, *p11);
        } else {
          wenc16(*px, *p01, i00, i01);
          wenc16(*p10, *p11, i10, i11);
          wenc16(i00, i10, *px, *p10);
          wenc16(i01, i11, *p01, *p11);
        }
      }
      if (nx & p) {
        uint16_t* p10 = px + oy1;
        if (w14)
          wenc14(*px, *p10, i00, *p10);
        else
          wenc16(*px, *p10, i00, *p10);
        *px = i00;
      }
    }
    if (ny & p) {
      uint16_t* px = py;
      uint16_t* ex = py + (size_t)ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        if (w14)
          wenc14(*px, *p01, i00, *p01);
        else
          wenc16(*px, *p01, i00, *p01);
        *px = i00;
      }
    }
    p = p2;
    p2 <<= 1;
  }
}

static void wav2_decode(uint16_t* in, int nx, int ox, int ny, int oy,
                        uint16_t mx) {
  bool w14 = mx < (1 << 14);
  int n = (nx > ny) ? ny : nx;
  int p = 1, p2;
  while (p <= n) p <<= 1;
  p >>= 1;
  p2 = p;
  p >>= 1;
  while (p >= 1) {
    uint16_t* py = in;
    uint16_t* ey = in + (size_t)oy * (ny - p2);
    int oy1 = oy * p, oy2 = oy * p2, ox1 = ox * p, ox2 = ox * p2;
    uint16_t i00, i01, i10, i11;
    for (; py <= ey; py += oy2) {
      uint16_t* px = py;
      uint16_t* ex = py + (size_t)ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        uint16_t* p10 = px + oy1;
        uint16_t* p11 = p10 + ox1;
        if (w14) {
          wdec14(*px, *p10, i00, i10);
          wdec14(*p01, *p11, i01, i11);
          wdec14(i00, i01, *px, *p01);
          wdec14(i10, i11, *p10, *p11);
        } else {
          wdec16(*px, *p10, i00, i10);
          wdec16(*p01, *p11, i01, i11);
          wdec16(i00, i01, *px, *p01);
          wdec16(i10, i11, *p10, *p11);
        }
      }
      if (nx & p) {
        uint16_t* p10 = px + oy1;
        if (w14)
          wdec14(*px, *p10, i00, *p10);
        else
          wdec16(*px, *p10, i00, *p10);
        *px = i00;
      }
    }
    if (ny & p) {
      uint16_t* px = py;
      uint16_t* ex = py + (size_t)ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        if (w14)
          wdec14(*px, *p01, i00, *p01);
        else
          wdec16(*px, *p01, i00, *p01);
        *px = i00;
      }
    }
    p2 = p;
    p >>= 1;
  }
}

// -- PIZ block compress / uncompress ----------------------------------------

static int piz_channel_size(int pixel_type) {  // in uint16 units
  return (pixel_type == 1) ? 1 : 2;            // HALF: 1, FLOAT/UINT: 2
}

static bool piz_uncompress_block(const uint8_t* in, size_t in_len, int w,
                                 int lines,
                                 const std::vector<ExrChannel>& channels,
                                 std::vector<uint8_t>& out) {
  if (in_len < 4) return false;
  uint16_t min_nz, max_nz;
  memcpy(&min_nz, in, 2);
  memcpy(&max_nz, in + 2, 2);
  const uint8_t* p = in + 4;
  size_t rem = in_len - 4;
  std::vector<uint8_t> bitmap(PIZ_BITMAP_BYTES, 0);
  if (min_nz <= max_nz) {
    if (max_nz >= PIZ_BITMAP_BYTES) return false;
    size_t nb = (size_t)max_nz - min_nz + 1;
    if (nb > rem) return false;
    memcpy(bitmap.data() + min_nz, p, nb);
    p += nb;
    rem -= nb;
  }
  static thread_local std::vector<uint16_t> lut(65536);
  int k = 0;
  for (int i = 0; i < 65536; ++i)
    if (i == 0 || (bitmap[i >> 3] & (1 << (i & 7)))) lut[k++] = (uint16_t)i;
  uint16_t max_value = (uint16_t)(k - 1);
  for (int i = k; i < 65536; ++i) lut[i] = 0;

  if (rem < 4) return false;
  int32_t hlen;
  memcpy(&hlen, p, 4);
  p += 4;
  rem -= 4;
  if (hlen < 0 || (size_t)hlen > rem) return false;

  size_t total = 0;
  for (const auto& c : channels)
    total += (size_t)w * lines * piz_channel_size(c.pixel_type);
  std::vector<uint16_t> tmp(total);
  if (!huf_uncompress(p, (size_t)hlen, tmp.data(), total)) return false;

  size_t off = 0;
  std::vector<size_t> ch_off(channels.size());
  for (size_t ci = 0; ci < channels.size(); ++ci) {
    int size = piz_channel_size(channels[ci].pixel_type);
    ch_off[ci] = off;
    for (int j = 0; j < size; ++j)
      wav2_decode(tmp.data() + off + j, w, size, lines, w * size, max_value);
    off += (size_t)w * lines * size;
  }
  for (size_t i = 0; i < total; ++i) tmp[i] = lut[tmp[i]];

  // interleave planar channel data back to scanline order
  out.resize(total * 2);
  uint8_t* dst = out.data();
  for (int y = 0; y < lines; ++y) {
    for (size_t ci = 0; ci < channels.size(); ++ci) {
      int size = piz_channel_size(channels[ci].pixel_type);
      const uint16_t* row = tmp.data() + ch_off[ci] + (size_t)y * w * size;
      memcpy(dst, row, (size_t)w * size * 2);
      dst += (size_t)w * size * 2;
    }
  }
  return true;
}

static void piz_compress_block(const uint8_t* raw, int w, int lines,
                               const std::vector<ExrChannel>& channels,
                               std::vector<uint8_t>& out) {
  size_t total = 0;
  for (const auto& c : channels)
    total += (size_t)w * lines * piz_channel_size(c.pixel_type);
  // deinterleave scanline layout -> planar per channel
  std::vector<uint16_t> tmp(total);
  std::vector<size_t> ch_off(channels.size());
  {
    size_t off = 0;
    for (size_t ci = 0; ci < channels.size(); ++ci) {
      ch_off[ci] = off;
      off += (size_t)w * lines * piz_channel_size(channels[ci].pixel_type);
    }
    const uint8_t* src = raw;
    for (int y = 0; y < lines; ++y) {
      for (size_t ci = 0; ci < channels.size(); ++ci) {
        int size = piz_channel_size(channels[ci].pixel_type);
        memcpy(tmp.data() + ch_off[ci] + (size_t)y * w * size, src,
               (size_t)w * size * 2);
        src += (size_t)w * size * 2;
      }
    }
  }

  std::vector<uint8_t> bitmap(PIZ_BITMAP_BYTES, 0);
  for (size_t i = 0; i < total; ++i)
    bitmap[tmp[i] >> 3] |= (uint8_t)(1 << (tmp[i] & 7));
  bitmap[0] &= ~1;  // zero is always representable
  static thread_local std::vector<uint16_t> lut(65536);
  int k = 0;
  for (int i = 0; i < 65536; ++i) {
    if (i == 0 || (bitmap[i >> 3] & (1 << (i & 7))))
      lut[i] = (uint16_t)k++;
    else
      lut[i] = 0;
  }
  uint16_t max_value = (uint16_t)(k - 1);
  for (size_t i = 0; i < total; ++i) tmp[i] = lut[tmp[i]];

  for (size_t ci = 0; ci < channels.size(); ++ci) {
    int size = piz_channel_size(channels[ci].pixel_type);
    for (int j = 0; j < size; ++j)
      wav2_encode(tmp.data() + ch_off[ci] + j, w, size, lines, w * size,
                  max_value);
  }

  int min_nz = 0, max_nz = PIZ_BITMAP_BYTES - 1;
  while (min_nz < PIZ_BITMAP_BYTES && bitmap[min_nz] == 0) ++min_nz;
  while (max_nz >= 0 && bitmap[max_nz] == 0) --max_nz;
  if (min_nz > max_nz) {
    min_nz = max_nz = 0;
    // empty bitmap: emit min > max so the reader writes no bitmap bytes
    min_nz = 1;
    max_nz = 0;
  }

  std::vector<uint8_t> huf;
  huf_compress(tmp.data(), total, huf);

  out.clear();
  uint16_t mn = (uint16_t)min_nz, mxz = (uint16_t)max_nz;
  out.insert(out.end(), (uint8_t*)&mn, (uint8_t*)&mn + 2);
  out.insert(out.end(), (uint8_t*)&mxz, (uint8_t*)&mxz + 2);
  if (min_nz <= max_nz)
    out.insert(out.end(), bitmap.begin() + min_nz,
               bitmap.begin() + max_nz + 1);
  int32_t hlen = (int32_t)huf.size();
  out.insert(out.end(), (uint8_t*)&hlen, (uint8_t*)&hlen + 4);
  out.insert(out.end(), huf.begin(), huf.end());
}

struct ExrImage {
  int width = 0, height = 0;
  std::vector<ExrChannel> channels;
  std::vector<float> data;  // HWC, header channel order
  std::string error;
};

static bool read_bytes(FILE* f, void* dst, size_t n) {
  return fread(dst, 1, n, f) == n;
}

static bool read_cstr(FILE* f, std::string& s, size_t maxlen = 256) {
  s.clear();
  for (size_t i = 0; i < maxlen; ++i) {
    int c = fgetc(f);
    if (c == EOF) return false;
    if (c == 0) return true;
    s.push_back((char)c);
  }
  return false;
}

ExrImage* exr_load(const char* path) {
  ExrImage* img = new ExrImage();
  FILE* f = fopen(path, "rb");
  if (!f) {
    img->error = "cannot open file";
    return img;
  }
  uint32_t magic = 0, version = 0;
  if (!read_bytes(f, &magic, 4) || magic != 20000630u) {
    img->error = "not an EXR file";
    fclose(f);
    return img;
  }
  read_bytes(f, &version, 4);
  if (version & 0x600) {  // tiled-only bit 9 / deep bit 11 handled below
  }
  if ((version & 0x200) || (version & 0x800) || (version & 0x1000)) {
    img->error = "tiled/deep/multipart EXR not supported";
    fclose(f);
    return img;
  }

  int32_t dw[4] = {0, 0, 0, 0};
  uint8_t compression = 0;
  bool have_dw = false, have_ch = false;

  for (;;) {
    std::string name;
    if (!read_cstr(f, name)) {
      img->error = "truncated header";
      fclose(f);
      return img;
    }
    if (name.empty()) break;  // end of header
    std::string type;
    read_cstr(f, type);
    int32_t size = 0;
    read_bytes(f, &size, 4);
    long next = ftell(f) + size;
    if (name == "dataWindow" && type == "box2i") {
      read_bytes(f, dw, 16);
      have_dw = true;
    } else if (name == "compression" && type == "compression") {
      read_bytes(f, &compression, 1);
    } else if (name == "channels" && type == "chlist") {
      for (;;) {
        std::string cname;
        if (!read_cstr(f, cname)) break;
        if (cname.empty()) break;
        int32_t ptype = 0, plin = 0, xs = 0, ys = 0;
        read_bytes(f, &ptype, 4);
        read_bytes(f, &plin, 4);
        read_bytes(f, &xs, 4);
        read_bytes(f, &ys, 4);
        img->channels.push_back({cname, ptype});
      }
      have_ch = true;
    }
    fseek(f, next, SEEK_SET);
  }
  if (!have_dw || !have_ch) {
    img->error = "missing dataWindow/channels";
    fclose(f);
    return img;
  }
  if (compression != 0 && compression != 2 && compression != 3 &&
      compression != 4) {
    img->error = "unsupported compression (only NONE/ZIPS/ZIP/PIZ)";
    fclose(f);
    return img;
  }
  // Validate header-supplied sizes before trusting them: a corrupt file
  // must produce an error string, not a crash or OOM.
  long long wll = (long long)dw[2] - dw[0] + 1;
  long long hll = (long long)dw[3] - dw[1] + 1;
  int nc = (int)img->channels.size();
  if (wll <= 0 || hll <= 0 || wll > (1 << 20) || hll > (1 << 20) ||
      nc <= 0 || nc > 64 || wll * hll * nc > (1ll << 31)) {
    img->error = "implausible dataWindow/channel count";
    fclose(f);
    return img;
  }
  int w = (int)wll, h = (int)hll;
  img->width = w;
  img->height = h;
  img->data.assign((size_t)w * h * nc, 0.0f);

  int lines_per_block = (compression == 3) ? 16 : (compression == 4) ? 32 : 1;
  int n_blocks = (h + lines_per_block - 1) / lines_per_block;
  std::vector<uint64_t> offsets(n_blocks);
  if (!read_bytes(f, offsets.data(), 8 * (size_t)n_blocks)) {
    img->error = "truncated offset table";
    fclose(f);
    return img;
  }

  size_t pix_bytes = 0;
  for (auto& c : img->channels) pix_bytes += (c.pixel_type == 1) ? 2 : 4;
  size_t max_block = (size_t)w * pix_bytes * lines_per_block;

  std::vector<uint8_t> packed, raw;
  for (int b = 0; b < n_blocks; ++b) {
    fseek(f, (long)offsets[b], SEEK_SET);
    int32_t y0 = 0, psize = 0;
    if (!read_bytes(f, &y0, 4) || !read_bytes(f, &psize, 4)) {
      img->error = "truncated block header";
      fclose(f);
      return img;
    }
    int y_start = y0 - dw[1];
    if (y_start < 0 || y_start >= h) {
      img->error = "block scanline out of range";
      fclose(f);
      return img;
    }
    int block_lines = std::min(lines_per_block, h - y_start);
    size_t unpacked = (size_t)w * pix_bytes * block_lines;
    // zlib can expand by ~0.1% + header; PIZ adds bitmap + code table;
    // anything past that is corrupt
    if (psize < 0 || (size_t)psize > max_block + max_block / 8 + 65536) {
      img->error = "implausible block size";
      fclose(f);
      return img;
    }
    packed.resize(psize);
    if (!read_bytes(f, packed.data(), psize)) {
      img->error = "truncated block data";
      fclose(f);
      return img;
    }
    if (compression == 0 || (size_t)psize >= unpacked) {
      if ((size_t)psize < unpacked) {
        img->error = "uncompressed block smaller than scanline";
        fclose(f);
        return img;
      }
      raw.assign(packed.begin(), packed.begin() + unpacked);
    } else if (compression == 4) {
      if (!piz_uncompress_block(packed.data(), packed.size(), w, block_lines,
                                img->channels, raw)) {
        img->error = "PIZ decode failed";
        fclose(f);
        return img;
      }
      if (raw.size() != unpacked) {
        img->error = "PIZ size mismatch";
        fclose(f);
        return img;
      }
    } else {
      raw.resize(unpacked);
      uLongf dlen = (uLongf)unpacked;
      if (uncompress(raw.data(), &dlen, packed.data(), psize) != Z_OK ||
          dlen != unpacked) {
        img->error = "zlib inflate failed";
        fclose(f);
        return img;
      }
      exr_postdecompress(raw);
    }
    // layout: per scanline, per channel (header order), w samples
    const uint8_t* src = raw.data();
    for (int line = 0; line < block_lines; ++line) {
      int y = y_start + line;
      for (int c = 0; c < nc; ++c) {
        int pt = img->channels[c].pixel_type;
        for (int x = 0; x < w; ++x) {
          float v;
          if (pt == 1) {
            uint16_t hv;
            memcpy(&hv, src, 2);
            src += 2;
            v = half_to_float(hv);
          } else if (pt == 2) {
            memcpy(&v, src, 4);
            src += 4;
          } else {
            uint32_t uv;
            memcpy(&uv, src, 4);
            src += 4;
            v = (float)uv;
          }
          img->data[((size_t)y * w + x) * nc + c] = v;
        }
      }
    }
  }
  fclose(f);
  return img;
}

int32_t exr_width(ExrImage* i) { return i->width; }
int32_t exr_height(ExrImage* i) { return i->height; }
int32_t exr_num_channels(ExrImage* i) { return (int32_t)i->channels.size(); }
const char* exr_error(ExrImage* i) { return i->error.c_str(); }
const char* exr_channel_name(ExrImage* i, int32_t c) {
  return i->channels[c].name.c_str();
}
void exr_copy(ExrImage* i, float* out) {
  memcpy(out, i->data.data(), i->data.size() * sizeof(float));
}
void exr_free(ExrImage* i) { delete i; }

// Write a scanline ZIP FLOAT EXR.  data: HWC float32; channels named
// Y (c=1), BGR order on disk for c=3, ABGR for c=4 (alphabetical, as the
// format requires).
int32_t exr_save_ex(const char* path, const float* data, int32_t w, int32_t h,
                    int32_t c, int32_t compression) {
  if (compression != 3 && compression != 4) return -3;  // ZIP or PIZ
  static const char* names1[] = {"Y"};
  static const char* names3[] = {"B", "G", "R"};
  static const char* names4[] = {"A", "B", "G", "R"};
  // map disk channel -> data channel index
  std::vector<const char*> names;
  std::vector<int> src_idx;
  if (c == 1) {
    names = {names1[0]};
    src_idx = {0};
  } else if (c == 3) {
    names = {names3[0], names3[1], names3[2]};
    src_idx = {2, 1, 0};
  } else if (c == 4) {
    names = {names4[0], names4[1], names4[2], names4[3]};
    src_idx = {3, 2, 1, 0};
  } else {
    return -1;
  }
  FILE* f = fopen(path, "wb");
  if (!f) return -2;
  uint32_t magic = 20000630u, version = 2;
  fwrite(&magic, 4, 1, f);
  fwrite(&version, 4, 1, f);

  auto attr = [&](const char* name, const char* type,
                  const void* payload, int32_t size) {
    fwrite(name, 1, strlen(name) + 1, f);
    fwrite(type, 1, strlen(type) + 1, f);
    fwrite(&size, 4, 1, f);
    fwrite(payload, 1, size, f);
  };

  // channels
  {
    std::vector<uint8_t> ch;
    for (size_t i = 0; i < names.size(); ++i) {
      const char* n = names[i];
      ch.insert(ch.end(), (const uint8_t*)n, (const uint8_t*)n + strlen(n) + 1);
      int32_t vals[4] = {2 /*FLOAT*/, 0, 1, 1};
      const uint8_t* vb = (const uint8_t*)vals;
      ch.insert(ch.end(), vb, vb + 16);
    }
    ch.push_back(0);
    attr("channels", "chlist", ch.data(), (int32_t)ch.size());
  }
  uint8_t comp = (uint8_t)compression;
  attr("compression", "compression", &comp, 1);
  int32_t dw[4] = {0, 0, w - 1, h - 1};
  attr("dataWindow", "box2i", dw, 16);
  attr("displayWindow", "box2i", dw, 16);
  uint8_t lo = 0;  // increasing Y
  attr("lineOrder", "lineOrder", &lo, 1);
  float par = 1.0f;
  attr("pixelAspectRatio", "float", &par, 4);
  float swc[2] = {0.0f, 0.0f};
  attr("screenWindowCenter", "v2f", swc, 8);
  float sww = 1.0f;
  attr("screenWindowWidth", "float", &sww, 4);
  fputc(0, f);  // end of header

  int lines_per_block = (compression == 4) ? 32 : 16;
  int n_blocks = (h + lines_per_block - 1) / lines_per_block;
  long offset_table_pos = ftell(f);
  std::vector<uint64_t> offsets(n_blocks, 0);
  fwrite(offsets.data(), 8, n_blocks, f);  // placeholder

  std::vector<uint8_t> raw, packed;
  for (int b = 0; b < n_blocks; ++b) {
    offsets[b] = (uint64_t)ftell(f);
    int y_start = b * lines_per_block;
    int block_lines = std::min(lines_per_block, h - y_start);
    raw.resize((size_t)w * 4 * names.size() * block_lines);
    uint8_t* dst = raw.data();
    for (int line = 0; line < block_lines; ++line) {
      int y = y_start + line;
      for (size_t ci = 0; ci < names.size(); ++ci) {
        int sc = src_idx[ci];
        for (int x = 0; x < w; ++x) {
          float v = data[((size_t)y * w + x) * c + sc];
          memcpy(dst, &v, 4);
          dst += 4;
        }
      }
    }
    size_t clen;
    if (compression == 4) {
      std::vector<ExrChannel> chans(names.size());
      for (size_t ci = 0; ci < names.size(); ++ci)
        chans[ci] = {names[ci], 2 /*FLOAT*/};
      piz_compress_block(raw.data(), w, block_lines, chans, packed);
      clen = packed.size();
    } else {
      std::vector<uint8_t> enc(raw);
      exr_precompress(enc);
      uLongf zlen = compressBound((uLong)enc.size());
      packed.resize(zlen);
      compress2(packed.data(), &zlen, enc.data(), (uLong)enc.size(), 6);
      clen = zlen;
    }
    int32_t y0 = y_start, psize;
    const uint8_t* payload;
    if (clen < raw.size()) {
      psize = (int32_t)clen;
      payload = packed.data();
    } else {
      psize = (int32_t)raw.size();
      payload = raw.data();
    }
    fwrite(&y0, 4, 1, f);
    fwrite(&psize, 4, 1, f);
    fwrite(payload, 1, psize, f);
  }
  fseek(f, offset_table_pos, SEEK_SET);
  fwrite(offsets.data(), 8, n_blocks, f);
  fclose(f);
  return 0;
}

int32_t exr_save(const char* path, const float* data, int32_t w, int32_t h,
                 int32_t c) {
  return exr_save_ex(path, data, w, h, c, 3);
}

}  // extern "C"
