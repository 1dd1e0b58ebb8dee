// Native PNG decoder for the data-loading path of the PyTorch port (a copy
// of the JAX package's decoder, which the port does not import).
//
// The port decodes every sprite once at start-up; this decoder removes the
// Python/PIL overhead from that path and has a batched entry point that
// decodes a whole split in one C call.
//
// Supports non-interlaced 8-bit PNGs of color types 0 (gray), 2 (RGB),
// 3 (palette, with optional tRNS), 4 (gray+alpha), 6 (RGBA) — output is
// always RGBA8. Inflate via zlib.
//
// Built at first use by native/png_io.py with the host compiler
// (g++ -O2 -shared -fPIC -std=c++17 ... -lz) into build/native/.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  bool ok = true;

  uint32_t u32() {
    if (off + 4 > n) { ok = false; return 0; }
    uint32_t v = (uint32_t(p[off]) << 24) | (uint32_t(p[off + 1]) << 16) |
                 (uint32_t(p[off + 2]) << 8) | uint32_t(p[off + 3]);
    off += 4;
    return v;
  }
  const uint8_t* bytes(size_t k) {
    if (off + k > n) { ok = false; return nullptr; }
    const uint8_t* r = p + off;
    off += k;
    return r;
  }
};

inline int paeth(int a, int b, int c) {
  int pp = a + b - c;
  int pa = pp > a ? pp - a : a - pp;
  int pb = pp > b ? pp - b : b - pp;
  int pc = pp > c ? pp - c : c - pp;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

bool inflate_all(const std::vector<uint8_t>& in, std::vector<uint8_t>& out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(in.data());
  zs.avail_in = static_cast<uInt>(in.size());
  zs.next_out = out.data();
  zs.avail_out = static_cast<uInt>(out.size());
  int ret = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return ret == Z_STREAM_END && zs.avail_out == 0;
}

}  // namespace

extern "C" {

// Decode one PNG buffer into out (h*w*4 RGBA8). Returns 0 on success.
// Negative codes: -1 parse error, -2 unsupported format, -3 inflate error,
// -4 dimension mismatch (expected_w/h > 0 enforces exact size).
int phg_decode_png(const uint8_t* data, long size, uint8_t* out,
                   long expected_h, long expected_w) {
  static const uint8_t kMagic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (size < 8 || std::memcmp(data, kMagic, 8) != 0) return -1;

  Reader r{data, static_cast<size_t>(size), 8};
  uint32_t w = 0, h = 0;
  int depth = 0, ctype = 0, interlace = 0;
  std::vector<uint8_t> idat;
  uint8_t palette[256][3];
  uint8_t trns[256];
  int palette_n = 0;
  bool have_trns = false;
  std::memset(trns, 255, sizeof(trns));

  while (r.ok && r.off < r.n) {
    uint32_t len = r.u32();
    const uint8_t* type = r.bytes(4);
    if (!r.ok) return -1;
    const uint8_t* body = r.bytes(len);
    if (!r.ok) return -1;
    r.u32();  // crc (unchecked)

    if (!std::memcmp(type, "IHDR", 4)) {
      if (len != 13) return -1;
      w = (uint32_t(body[0]) << 24) | (body[1] << 16) | (body[2] << 8) | body[3];
      h = (uint32_t(body[4]) << 24) | (body[5] << 16) | (body[6] << 8) | body[7];
      depth = body[8];
      ctype = body[9];
      interlace = body[12];
      if (depth != 8 || interlace != 0) return -2;
      if (ctype != 0 && ctype != 2 && ctype != 3 && ctype != 4 && ctype != 6)
        return -2;
    } else if (!std::memcmp(type, "PLTE", 4)) {
      palette_n = static_cast<int>(len / 3);
      if (palette_n > 256) return -1;
      for (int i = 0; i < palette_n; ++i) {
        palette[i][0] = body[3 * i];
        palette[i][1] = body[3 * i + 1];
        palette[i][2] = body[3 * i + 2];
      }
    } else if (!std::memcmp(type, "tRNS", 4)) {
      have_trns = true;
      for (uint32_t i = 0; i < len && i < 256; ++i) trns[i] = body[i];
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      break;
    }
  }
  if (w == 0 || h == 0) return -1;
  if (expected_w > 0 && (long(w) != expected_w || long(h) != expected_h))
    return -4;

  const int channels = (ctype == 6) ? 4 : (ctype == 4) ? 2
                       : (ctype == 2) ? 3 : 1;
  const size_t stride = size_t(w) * channels;
  std::vector<uint8_t> raw((stride + 1) * h);
  if (!inflate_all(idat, raw)) return -3;

  std::vector<uint8_t> prev(stride, 0);
  std::vector<uint8_t> cur(stride, 0);
  for (uint32_t y = 0; y < h; ++y) {
    const uint8_t* line = raw.data() + y * (stride + 1);
    const int filter = line[0];
    const uint8_t* src = line + 1;
    for (size_t x = 0; x < stride; ++x) {
      const int a = x >= size_t(channels) ? cur[x - channels] : 0;
      const int b = prev[x];
      const int c = x >= size_t(channels) ? prev[x - channels] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return -1;
      }
      cur[x] = static_cast<uint8_t>(v);
    }
    // expand to RGBA
    uint8_t* dst = out + size_t(y) * w * 4;
    switch (ctype) {
      case 6:
        std::memcpy(dst, cur.data(), stride);
        break;
      case 2:
        for (uint32_t x = 0; x < w; ++x) {
          dst[4 * x] = cur[3 * x];
          dst[4 * x + 1] = cur[3 * x + 1];
          dst[4 * x + 2] = cur[3 * x + 2];
          dst[4 * x + 3] = 255;
        }
        break;
      case 0:
        for (uint32_t x = 0; x < w; ++x) {
          dst[4 * x] = dst[4 * x + 1] = dst[4 * x + 2] = cur[x];
          dst[4 * x + 3] = 255;
        }
        break;
      case 4:
        for (uint32_t x = 0; x < w; ++x) {
          dst[4 * x] = dst[4 * x + 1] = dst[4 * x + 2] = cur[2 * x];
          dst[4 * x + 3] = cur[2 * x + 1];
        }
        break;
      case 3:
        for (uint32_t x = 0; x < w; ++x) {
          const int idx = cur[x];
          if (idx >= palette_n) return -1;
          dst[4 * x] = palette[idx][0];
          dst[4 * x + 1] = palette[idx][1];
          dst[4 * x + 2] = palette[idx][2];
          dst[4 * x + 3] = have_trns ? trns[idx] : 255;
        }
        break;
    }
    std::swap(prev, cur);
  }
  return 0;
}

// Decode a file from disk. Returns 0 on success; -10 on IO error.
int phg_decode_png_file(const char* path, uint8_t* out, long expected_h,
                        long expected_w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -10;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(size);
  const size_t got = std::fread(buf.data(), 1, size, f);
  std::fclose(f);
  if (long(got) != size) return -10;
  return phg_decode_png(buf.data(), size, out, expected_h, expected_w);
}

// Decode n files "<folder>/<start+i>.png" into out (n, h, w, 4).
// Returns 0 on success or the first failing error code.
int phg_decode_folder(const char* folder, long start, long n, long h, long w,
                      uint8_t* out) {
  char path[4096];
  for (long i = 0; i < n; ++i) {
    std::snprintf(path, sizeof(path), "%s/%ld.png", folder, start + i);
    const int rc = phg_decode_png_file(path, out + i * h * w * 4, h, w);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // extern "C"
