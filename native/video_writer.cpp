// Native video writer: multi-threaded MJPEG-in-AVI encoder.
//
// The reference writes its orbit videos as mp4 through imageio's ffmpeg
// binary (/root/reference/mlx_nerf/entrypoints/__test_nerf.py:326-341).
// Headless hosts often ship no ffmpeg, so this library provides a
// dependency-free video path: a baseline JPEG encoder (ITU T.81 Annex K
// tables, 4:4:4, quality-scaled quantization) packed into a RIFF/AVI
// container with the MJPG fourcc — playable by VLC/ffplay/browsers.
// Frames are JPEG-encoded across hardware threads, then written serially.
//
// Scope: 8-bit RGB input [n, h, w, 3]; h and w arbitrary (edge blocks
// replicate). Returns nonzero on I/O errors; the Python binding falls
// back to GIF/PNG writing.
//
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// JPEG constants (ITU T.81 Annex K)
// ---------------------------------------------------------------------------

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const int kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

const int kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcChromaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};

const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA};

const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA};

struct HuffTable {
  uint16_t code[256];
  uint8_t size[256];
};

// Canonical code assignment (T.81 C.2) from (bits, vals).
HuffTable build_huff(const uint8_t* bits, const uint8_t* vals) {
  HuffTable t{};
  uint16_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len]; ++i) {
      t.code[vals[k]] = code;
      t.size[vals[k]] = uint8_t(len);
      ++code;
      ++k;
    }
    code <<= 1;
  }
  return t;
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int nbits = 0;

  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}

  void put(uint16_t code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      uint8_t b = uint8_t((acc >> (nbits - 8)) & 0xFF);
      out.push_back(b);
      if (b == 0xFF) out.push_back(0x00);  // byte stuffing
      nbits -= 8;
    }
  }

  void flush() {
    if (nbits > 0) put(uint16_t((1 << (8 - nbits)) - 1), 8 - nbits);  // pad 1s
  }
};

inline int bit_category(int v) {
  int a = v < 0 ? -v : v;
  int n = 0;
  while (a) {
    ++n;
    a >>= 1;
  }
  return n;
}

// Forward 8x8 DCT (separable, straightforward; 160 frames is small work).
struct CosTable {
  float c[8][8];
  CosTable() {
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x)
        c[u][x] = float(std::cos((2 * x + 1) * u * 3.14159265358979323846 / 16.0));
  }
};

void fdct8x8(const float* in, float* out) {
  // C++11 magic static: thread-safe one-time init (encode threads race here)
  static const CosTable tbl;
  const auto& c = tbl.c;
  float tmp[64];
  for (int u = 0; u < 8; ++u)
    for (int x = 0; x < 8; ++x) {
      float s = 0;
      for (int k = 0; k < 8; ++k) s += in[x * 8 + k] * c[u][k];
      tmp[x * 8 + u] = s;
    }
  for (int u = 0; u < 8; ++u)
    for (int v = 0; v < 8; ++v) {
      float s = 0;
      for (int k = 0; k < 8; ++k) s += tmp[k * 8 + v] * c[u][k];
      float cu = (u == 0) ? 0.70710678f : 1.0f;
      float cv = (v == 0) ? 0.70710678f : 1.0f;
      out[u * 8 + v] = 0.25f * cu * cv * s;
    }
}

void emit_block(BitWriter& bw, const float* block, const uint16_t* quant_recip_unused,
                const int* quant, int& prev_dc, const HuffTable& dc_t,
                const HuffTable& ac_t) {
  float dct[64];
  fdct8x8(block, dct);
  int q[64];
  for (int i = 0; i < 64; ++i) {
    int zi = kZigzag[i];
    float v = dct[zi] / float(quant[zi]);
    q[i] = int(std::lround(v));
  }
  // DC
  int diff = q[0] - prev_dc;
  prev_dc = q[0];
  int s = bit_category(diff);
  bw.put(dc_t.code[s], dc_t.size[s]);
  if (s) bw.put(uint16_t(diff < 0 ? diff + (1 << s) - 1 : diff), s);
  // AC
  int run = 0;
  for (int i = 1; i < 64; ++i) {
    if (q[i] == 0) {
      ++run;
      continue;
    }
    while (run >= 16) {
      bw.put(ac_t.code[0xF0], ac_t.size[0xF0]);  // ZRL
      run -= 16;
    }
    int sa = bit_category(q[i]);
    int sym = (run << 4) | sa;
    bw.put(ac_t.code[sym], ac_t.size[sym]);
    bw.put(uint16_t(q[i] < 0 ? q[i] + (1 << sa) - 1 : q[i]), sa);
    run = 0;
  }
  if (run > 0) bw.put(ac_t.code[0x00], ac_t.size[0x00]);  // EOB
}

void put16(std::vector<uint8_t>& o, uint16_t v) {
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v & 0xFF));
}

// Encode one RGB frame [h, w, 3] to baseline JPEG (4:4:4).
void encode_jpeg(const uint8_t* rgb, int h, int w, int quality,
                 std::vector<uint8_t>& out) {
  // quality-scaled quant tables (libjpeg convention)
  int scale = quality < 50 ? 5000 / (quality < 1 ? 1 : quality) : 200 - 2 * quality;
  int qy[64], qc[64];
  for (int i = 0; i < 64; ++i) {
    int vy = (kLumaQuant[i] * scale + 50) / 100;
    int vc = (kChromaQuant[i] * scale + 50) / 100;
    qy[i] = vy < 1 ? 1 : (vy > 255 ? 255 : vy);
    qc[i] = vc < 1 ? 1 : (vc > 255 ? 255 : vc);
  }

  out.clear();
  out.reserve(size_t(h) * w / 2 + 1024);
  // SOI
  out.push_back(0xFF);
  out.push_back(0xD8);
  // APP0 JFIF
  out.push_back(0xFF);
  out.push_back(0xE0);
  put16(out, 16);
  const char jfif[] = "JFIF";
  out.insert(out.end(), jfif, jfif + 5);
  out.push_back(1);
  out.push_back(1);
  out.push_back(0);
  put16(out, 1);
  put16(out, 1);
  out.push_back(0);
  out.push_back(0);
  // DQT (both tables in one marker)
  out.push_back(0xFF);
  out.push_back(0xDB);
  put16(out, 2 + 2 * 65);
  out.push_back(0x00);
  for (int i = 0; i < 64; ++i) out.push_back(uint8_t(qy[kZigzag[i]]));
  out.push_back(0x01);
  for (int i = 0; i < 64; ++i) out.push_back(uint8_t(qc[kZigzag[i]]));
  // SOF0: 3 components, 4:4:4
  out.push_back(0xFF);
  out.push_back(0xC0);
  put16(out, 8 + 3 * 3);
  out.push_back(8);
  put16(out, uint16_t(h));
  put16(out, uint16_t(w));
  out.push_back(3);
  for (int c = 0; c < 3; ++c) {
    out.push_back(uint8_t(c + 1));
    out.push_back(0x11);  // h=1, v=1
    out.push_back(c == 0 ? 0 : 1);
  }
  // DHT (all four tables)
  auto emit_dht = [&](uint8_t cls_id, const uint8_t* bits, const uint8_t* vals,
                      int nvals) {
    out.push_back(0xFF);
    out.push_back(0xC4);
    put16(out, uint16_t(2 + 1 + 16 + nvals));
    out.push_back(cls_id);
    for (int i = 1; i <= 16; ++i) out.push_back(bits[i]);
    out.insert(out.end(), vals, vals + nvals);
  };
  emit_dht(0x00, kDcLumaBits, kDcLumaVals, 12);
  emit_dht(0x10, kAcLumaBits, kAcLumaVals, 162);
  emit_dht(0x01, kDcChromaBits, kDcChromaVals, 12);
  emit_dht(0x11, kAcChromaBits, kAcChromaVals, 162);
  // SOS
  out.push_back(0xFF);
  out.push_back(0xDA);
  put16(out, 6 + 2 * 3);
  out.push_back(3);
  out.push_back(1);
  out.push_back(0x00);
  out.push_back(2);
  out.push_back(0x11);
  out.push_back(3);
  out.push_back(0x11);
  out.push_back(0);
  out.push_back(63);
  out.push_back(0);

  HuffTable dcl = build_huff(kDcLumaBits, kDcLumaVals);
  HuffTable acl = build_huff(kAcLumaBits, kAcLumaVals);
  HuffTable dcc = build_huff(kDcChromaBits, kDcChromaVals);
  HuffTable acc = build_huff(kAcChromaBits, kAcChromaVals);

  BitWriter bw(out);
  int prev_dc[3] = {0, 0, 0};
  float blk[3][64];
  for (int by = 0; by < h; by += 8) {
    for (int bx = 0; bx < w; bx += 8) {
      for (int y = 0; y < 8; ++y) {
        int sy = by + y < h ? by + y : h - 1;  // edge replicate
        for (int x = 0; x < 8; ++x) {
          int sx = bx + x < w ? bx + x : w - 1;
          const uint8_t* p = rgb + (size_t(sy) * w + sx) * 3;
          float r = p[0], g = p[1], b = p[2];
          blk[0][y * 8 + x] = 0.299f * r + 0.587f * g + 0.114f * b - 128.0f;
          blk[1][y * 8 + x] = -0.168736f * r - 0.331264f * g + 0.5f * b;
          blk[2][y * 8 + x] = 0.5f * r - 0.418688f * g - 0.081312f * b;
        }
      }
      emit_block(bw, blk[0], nullptr, qy, prev_dc[0], dcl, acl);
      emit_block(bw, blk[1], nullptr, qc, prev_dc[1], dcc, acc);
      emit_block(bw, blk[2], nullptr, qc, prev_dc[2], dcc, acc);
    }
  }
  bw.flush();
  // EOI
  out.push_back(0xFF);
  out.push_back(0xD9);
}

// ---------------------------------------------------------------------------
// AVI (RIFF) container
// ---------------------------------------------------------------------------

void put_le32(std::vector<uint8_t>& o, uint32_t v) {
  o.push_back(uint8_t(v));
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v >> 16));
  o.push_back(uint8_t(v >> 24));
}

void put_fourcc(std::vector<uint8_t>& o, const char* s) {
  o.insert(o.end(), s, s + 4);
}

}  // namespace

extern "C" {

// Encode frames [n, h, w, 3] u8 RGB into an MJPG AVI at `path`.
// Returns 0 on success.
int avi_write_mjpeg(const char* path, const uint8_t* frames, int n, int h,
                    int w, int fps, int quality) {
  if (n <= 0 || h <= 0 || w <= 0 || fps <= 0) return 1;

  // Encode all frames across hardware threads.
  std::vector<std::vector<uint8_t>> jpegs(n);
  std::atomic<int> next{0};
  int n_threads = int(std::thread::hardware_concurrency());
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    pool.emplace_back([&] {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
        encode_jpeg(frames + size_t(i) * h * w * 3, h, w, quality, jpegs[i]);
      }
    });
  }
  for (auto& th : pool) th.join();

  // movi payload + idx1
  std::vector<uint8_t> movi;
  std::vector<uint8_t> idx1;
  put_fourcc(movi, "movi");
  for (int i = 0; i < n; ++i) {
    uint32_t off = uint32_t(movi.size() - 4);  // offset relative to 'movi'+4
    uint32_t sz = uint32_t(jpegs[i].size());
    put_fourcc(movi, "00dc");
    put_le32(movi, sz);
    movi.insert(movi.end(), jpegs[i].begin(), jpegs[i].end());
    if (sz & 1) movi.push_back(0);  // RIFF chunks are 2-byte aligned
    put_fourcc(idx1, "00dc");
    put_le32(idx1, 0x10);  // AVIIF_KEYFRAME
    put_le32(idx1, off + 4);
    put_le32(idx1, sz);
  }

  uint32_t max_bytes = 0;
  for (auto& j : jpegs)
    if (j.size() > max_bytes) max_bytes = uint32_t(j.size());

  // hdrl
  std::vector<uint8_t> hdrl;
  put_fourcc(hdrl, "hdrl");
  // avih
  put_fourcc(hdrl, "avih");
  put_le32(hdrl, 56);
  put_le32(hdrl, 1000000u / uint32_t(fps));  // us per frame
  put_le32(hdrl, max_bytes * uint32_t(fps));  // max bytes/sec
  put_le32(hdrl, 0);                          // padding granularity
  put_le32(hdrl, 0x10 | 0x100);               // HASINDEX | ISINTERLEAVED
  put_le32(hdrl, uint32_t(n));
  put_le32(hdrl, 0);  // initial frames
  put_le32(hdrl, 1);  // streams
  put_le32(hdrl, max_bytes);
  put_le32(hdrl, uint32_t(w));
  put_le32(hdrl, uint32_t(h));
  for (int i = 0; i < 4; ++i) put_le32(hdrl, 0);  // reserved
  // strl list
  std::vector<uint8_t> strl;
  put_fourcc(strl, "strl");
  put_fourcc(strl, "strh");
  put_le32(strl, 56);
  put_fourcc(strl, "vids");
  put_fourcc(strl, "MJPG");
  put_le32(strl, 0);  // flags
  put_le32(strl, 0);  // priority + language
  put_le32(strl, 0);  // initial frames
  put_le32(strl, 1);  // scale
  put_le32(strl, uint32_t(fps));  // rate
  put_le32(strl, 0);  // start
  put_le32(strl, uint32_t(n));  // length
  put_le32(strl, max_bytes);
  put_le32(strl, 0xFFFFFFFFu);  // quality
  put_le32(strl, 0);  // sample size
  put_le32(strl, 0);  // rcFrame left/top
  uint16_t rw = uint16_t(w), rh = uint16_t(h);
  strl.push_back(uint8_t(rw));
  strl.push_back(uint8_t(rw >> 8));
  strl.push_back(uint8_t(rh));
  strl.push_back(uint8_t(rh >> 8));
  // strf: BITMAPINFOHEADER
  put_fourcc(strl, "strf");
  put_le32(strl, 40);
  put_le32(strl, 40);
  put_le32(strl, uint32_t(w));
  put_le32(strl, uint32_t(h));
  put_le32(strl, 1 | (24u << 16));  // planes=1, bitcount=24
  put_fourcc(strl, "MJPG");
  put_le32(strl, uint32_t(w) * uint32_t(h) * 3u);
  put_le32(strl, 0);
  put_le32(strl, 0);
  put_le32(strl, 0);
  put_le32(strl, 0);
  // wrap strl as LIST inside hdrl
  put_fourcc(hdrl, "LIST");
  put_le32(hdrl, uint32_t(strl.size()));
  hdrl.insert(hdrl.end(), strl.begin(), strl.end());

  // assemble RIFF
  std::vector<uint8_t> riff;
  put_fourcc(riff, "AVI ");
  put_fourcc(riff, "LIST");
  put_le32(riff, uint32_t(hdrl.size()));
  riff.insert(riff.end(), hdrl.begin(), hdrl.end());
  put_fourcc(riff, "LIST");
  put_le32(riff, uint32_t(movi.size()));
  riff.insert(riff.end(), movi.begin(), movi.end());
  put_fourcc(riff, "idx1");
  put_le32(riff, uint32_t(idx1.size()));
  riff.insert(riff.end(), idx1.begin(), idx1.end());

  FILE* f = std::fopen(path, "wb");
  if (!f) return 2;
  bool ok = true;
  uint8_t hdr[8];
  std::memcpy(hdr, "RIFF", 4);
  uint32_t total = uint32_t(riff.size());
  hdr[4] = uint8_t(total);
  hdr[5] = uint8_t(total >> 8);
  hdr[6] = uint8_t(total >> 16);
  hdr[7] = uint8_t(total >> 24);
  ok = ok && std::fwrite(hdr, 1, 8, f) == 8;
  ok = ok && std::fwrite(riff.data(), 1, riff.size(), f) == riff.size();
  ok = std::fclose(f) == 0 && ok;
  return ok ? 0 : 3;
}

// Encode one RGB frame to JPEG into caller buffer; returns byte count or
// negative on error / insufficient capacity. (Used by tests and the image
// snapshot path.)
long jpeg_encode_rgb(const uint8_t* rgb, int h, int w, int quality,
                     uint8_t* out, long capacity) {
  std::vector<uint8_t> buf;
  encode_jpeg(rgb, h, w, quality, buf);
  if (long(buf.size()) > capacity) return -1;
  std::memcpy(out, buf.data(), buf.size());
  return long(buf.size());
}

}  // extern "C"
