// Native TIFF decode + fused normalize for the segland_tpu_torch data loader.
//
// The reference reads tiles with rasterio/GDAL (C++ under the hood,
// dataset/oem.py); this is the port's equivalent: a minimal,
// dependency-light (zlib only) baseline-TIFF reader covering what OEM
// GeoTIFF tiles actually use -- 8-bit samples, chunky planar layout,
// strip or tile organization, compression none/deflate/LZW/PackBits,
// horizontal-differencing predictor -- plus an OpenMP batch API that fuses
// decode with the BGR-flip + /255 + mean/std normalization so the host
// produces model-ready float32 (or raw uint8 for device-side normalize).
// Unsupported features return an error and the Python callers fall back
// to PIL (segland_tpu_torch/native/__init__.py).
//
// Build: g++ -O3 -fopenmp -shared -fPIC tiffdec.cpp -lz -o tiffdec.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <zlib.h>
#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Reader {
  const uint8_t* d;
  size_t n;
  bool swap;  // file endianness != host (host assumed little-endian)

  uint16_t u16(size_t off) const {
    if (off + 2 > n) return 0;
    uint16_t v;
    memcpy(&v, d + off, 2);
    if (swap) v = (uint16_t)((v >> 8) | (v << 8));
    return v;
  }
  uint32_t u32(size_t off) const {
    if (off + 4 > n) return 0;
    uint32_t v;
    memcpy(&v, d + off, 4);
    if (swap) v = __builtin_bswap32(v);
    return v;
  }
};

struct Tiff {
  uint32_t width = 0, height = 0;
  uint16_t spp = 1, compression = 1, photometric = 1, planar = 1, predictor = 1;
  uint16_t bps = 8;
  uint32_t rows_per_strip = 0xffffffffu;
  uint32_t tile_w = 0, tile_h = 0;
  std::vector<uint64_t> offsets, counts;  // strips or tiles
  bool tiled = false;
};

// IFD entry value reader: returns the i-th scalar of an entry (SHORT/LONG).
uint64_t entry_val(const Reader& r, size_t e, uint32_t i) {
  uint16_t type = r.u16(e + 2);
  uint32_t count = r.u32(e + 4);
  size_t sz = (type == 3) ? 2 : 4;  // SHORT=3, LONG=4 (others unused here)
  if (type != 3 && type != 4) return 0;
  size_t base = (count * sz <= 4) ? e + 8 : r.u32(e + 8);
  if (i >= count) return 0;
  return (type == 3) ? r.u16(base + i * 2) : r.u32(base + i * 4);
}

int parse(const Reader& r, Tiff& t) {
  size_t ifd = r.u32(4);
  if (ifd == 0 || ifd + 2 > r.n) return -2;
  uint16_t nent = r.u16(ifd);
  std::vector<uint64_t> strip_off, strip_cnt, tile_off, tile_cnt;
  for (uint16_t k = 0; k < nent; k++) {
    size_t e = ifd + 2 + (size_t)k * 12;
    uint16_t tag = r.u16(e);
    uint32_t count = r.u32(e + 4);
    auto vals = [&](std::vector<uint64_t>& out) {
      out.resize(count);
      for (uint32_t i = 0; i < count; i++) out[i] = entry_val(r, e, i);
    };
    switch (tag) {
      case 256: t.width = (uint32_t)entry_val(r, e, 0); break;
      case 257: t.height = (uint32_t)entry_val(r, e, 0); break;
      case 258: {  // all samples must be 8-bit
        for (uint32_t i = 0; i < count; i++)
          if (entry_val(r, e, i) != 8) return -3;
        t.bps = 8;
        break;
      }
      case 259: t.compression = (uint16_t)entry_val(r, e, 0); break;
      case 262: t.photometric = (uint16_t)entry_val(r, e, 0); break;
      case 273: vals(strip_off); break;
      case 277: t.spp = (uint16_t)entry_val(r, e, 0); break;
      case 278: t.rows_per_strip = (uint32_t)entry_val(r, e, 0); break;
      case 279: vals(strip_cnt); break;
      case 284: t.planar = (uint16_t)entry_val(r, e, 0); break;
      case 317: t.predictor = (uint16_t)entry_val(r, e, 0); break;
      case 322: t.tile_w = (uint32_t)entry_val(r, e, 0); break;
      case 323: t.tile_h = (uint32_t)entry_val(r, e, 0); break;
      case 324: vals(tile_off); break;
      case 325: vals(tile_cnt); break;
      case 339: if (entry_val(r, e, 0) != 1) return -4; break;  // uint only
      default: break;
    }
  }
  if (!t.width || !t.height) return -5;
  // sanity bounds: reject absurd dims so callers can size buffers from
  // tiff_info without overflow (w/h also cast to int on the API surface)
  if (t.width > (1u << 20) || t.height > (1u << 20) ||
      (uint64_t)t.width * t.height > (1ull << 31)) return -5;
  if (t.planar != 1) return -6;
  if (t.photometric > 3) return -7;  // minisblack/miniswhite/RGB/palette
  if (t.spp < 1 || t.spp > 4) return -8;
  if (!tile_off.empty()) {
    t.tiled = true;
    t.offsets = tile_off;
    t.counts = tile_cnt;
    if (!t.tile_w || !t.tile_h) return -9;
  } else {
    t.offsets = strip_off;
    t.counts = strip_cnt;
    if (t.offsets.empty()) return -10;
  }
  if (t.offsets.size() != t.counts.size()) return -11;
  return 0;
}

// ---- codecs: decompress one strip/tile payload into dst (exact size) ----

int inflate_zlib(const uint8_t* src, size_t sn, uint8_t* dst, size_t dn) {
  uLongf out = dn;
  int rc = uncompress(dst, &out, src, sn);
  return (rc == Z_OK && out == dn) ? 0 : -20;
}

int packbits(const uint8_t* src, size_t sn, uint8_t* dst, size_t dn) {
  size_t i = 0, o = 0;
  while (i < sn && o < dn) {
    int8_t h = (int8_t)src[i++];
    if (h >= 0) {
      size_t cnt = (size_t)h + 1;
      if (i + cnt > sn || o + cnt > dn) return -21;
      memcpy(dst + o, src + i, cnt);
      i += cnt;
      o += cnt;
    } else if (h != -128) {
      size_t cnt = (size_t)(-h) + 1;
      if (i >= sn || o + cnt > dn) return -21;
      memset(dst + o, src[i++], cnt);
      o += cnt;
    }
  }
  return o == dn ? 0 : -21;
}

// TIFF-variant LZW: MSB-first bit packing, 9->12 bit codes, early change.
int lzw(const uint8_t* src, size_t sn, uint8_t* dst, size_t dn) {
  struct Ent { int16_t prev; uint8_t ch; };
  std::vector<Ent> table(4096);
  std::vector<uint8_t> stack(4096);
  int next_code = 258, width = 9;
  uint32_t bitbuf = 0;
  int bits = 0;
  size_t i = 0, o = 0;
  int prev = -1;

  auto reset = [&]() { next_code = 258; width = 9; prev = -1; };
  auto first_char = [&](int code) {
    while (code >= 256) code = table[code].prev;
    return (uint8_t)code;
  };
  auto emit = [&](int code) -> int {
    size_t sp = 0;
    int c = code;
    while (c >= 256) {
      if (sp >= stack.size()) return -22;
      stack[sp++] = table[c].ch;
      c = table[c].prev;
    }
    stack[sp++] = (uint8_t)c;
    if (o + sp > dn) return -22;
    while (sp) dst[o++] = stack[--sp];
    return 0;
  };

  while (true) {
    while (bits < width) {
      if (i >= sn) return (o == dn) ? 0 : -22;
      bitbuf = (bitbuf << 8) | src[i++];
      bits += 8;
    }
    int code = (int)((bitbuf >> (bits - width)) & ((1u << width) - 1));
    bits -= width;
    if (code == 256) {  // clear
      reset();
      continue;
    }
    if (code == 257) break;  // EOI
    if (prev < 0) {
      if (code > 255) return -22;
      if (o >= dn) return -22;
      dst[o++] = (uint8_t)code;
      prev = code;
      continue;
    }
    if (code < next_code) {
      if (emit(code)) return -22;
      if (next_code < 4096) {
        table[next_code].prev = (int16_t)prev;
        table[next_code].ch = first_char(code);
        next_code++;
      }
    } else if (code == next_code && next_code < 4096) {
      table[next_code].prev = (int16_t)prev;
      table[next_code].ch = first_char(prev);
      next_code++;
      if (emit(code)) return -22;
    } else {
      return -22;
    }
    // TIFF early change: bump width when next_code == 2^width - 1
    if (next_code >= (1 << width) - 1 && width < 12) width++;
    prev = code;
  }
  return (o == dn) ? 0 : -22;
}

int decode_payload(const Tiff& t, const uint8_t* src, size_t sn,
                   uint8_t* dst, size_t dn) {
  switch (t.compression) {
    case 1:
      if (sn < dn) return -23;
      memcpy(dst, src, dn);
      return 0;
    case 8:
    case 32946:
      return inflate_zlib(src, sn, dst, dn);
    case 5:
      return lzw(src, sn, dst, dn);
    case 32773:
      return packbits(src, sn, dst, dn);
    default:
      return -24;
  }
}

void undo_predictor(const Tiff& t, uint8_t* rows, uint32_t nrows, uint32_t w) {
  if (t.predictor != 2) return;
  for (uint32_t r = 0; r < nrows; r++) {
    uint8_t* p = rows + (size_t)r * w * t.spp;
    for (size_t x = t.spp; x < (size_t)w * t.spp; x++) p[x] = (uint8_t)(p[x] + p[x - t.spp]);
  }
}

// Decode the full image into out, chunky row-major.  Before any write,
// validates the parsed dimensions: against an expected (exp_w, exp_h, exp_c)
// when exp_w > 0, else against the byte capacity `cap` — so a wrong-sized
// file can never overflow the caller's buffer.
int decode_image(const uint8_t* data, size_t n, Tiff& t, uint8_t* out,
                 long cap, int exp_w = 0, int exp_h = 0, int exp_c = 0) {
  Reader r{data, n, false};
  if (n < 8) return -1;
  if (data[0] == 'I' && data[1] == 'I') r.swap = false;
  else if (data[0] == 'M' && data[1] == 'M') r.swap = true;
  else return -1;
  if (r.u16(2) != 42) return -1;  // BigTIFF (43) -> fallback
  int rc = parse(r, t);
  if (rc) return rc;
  if (exp_w > 0) {
    if (t.width != (uint32_t)exp_w || t.height != (uint32_t)exp_h ||
        t.spp != (uint16_t)exp_c) return -42;
  } else if ((long)((uint64_t)t.width * t.height * t.spp) > cap) {
    return -41;
  }

  const uint32_t w = t.width, h = t.height;
  if (!t.tiled) {
    uint32_t rps = t.rows_per_strip ? t.rows_per_strip : h;
    if (rps > h) rps = h;
    std::vector<uint8_t> buf;
    for (size_t s = 0; s < t.offsets.size(); s++) {
      uint32_t y0 = (uint32_t)(s * rps);
      if (y0 >= h) break;
      uint32_t nrows = (y0 + rps <= h) ? rps : (h - y0);
      size_t dn = (size_t)nrows * w * t.spp;
      uint8_t* dst = out + (size_t)y0 * w * t.spp;
      if (t.offsets[s] + t.counts[s] > n) return -12;
      rc = decode_payload(t, data + t.offsets[s], t.counts[s], dst, dn);
      if (rc) return rc;
      undo_predictor(t, dst, nrows, w);
    }
  } else {
    uint32_t tw = t.tile_w, th = t.tile_h;
    uint32_t tx = (w + tw - 1) / tw, ty = (h + th - 1) / th;
    if ((size_t)tx * ty != t.offsets.size()) return -13;
    std::vector<uint8_t> buf((size_t)tw * th * t.spp);
    for (uint32_t j = 0; j < ty; j++) {
      for (uint32_t i2 = 0; i2 < tx; i2++) {
        size_t s = (size_t)j * tx + i2;
        if (t.offsets[s] + t.counts[s] > n) return -12;
        rc = decode_payload(t, data + t.offsets[s], t.counts[s], buf.data(), buf.size());
        if (rc) return rc;
        undo_predictor(t, buf.data(), th, tw);
        uint32_t copy_h = (j * th + th <= h) ? th : (h - j * th);
        uint32_t copy_w = (i2 * tw + tw <= w) ? tw : (w - i2 * tw);
        for (uint32_t y = 0; y < copy_h; y++) {
          memcpy(out + (((size_t)(j * th + y) * w + (size_t)i2 * tw) * t.spp),
                 buf.data() + (size_t)y * tw * t.spp, (size_t)copy_w * t.spp);
        }
      }
    }
  }
  // miniswhite -> invert to minisblack convention
  if (t.photometric == 0)
    for (size_t k = 0; k < (size_t)w * h * t.spp; k++) out[k] = (uint8_t)(255 - out[k]);
  return 0;
}

// Slurp a TIFF file; checks the 4-byte magic BEFORE reading the body so
// non-TIFF inputs (PNG labels etc.) fail fast without a full read.
int read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return -40;
  uint8_t hdr[4];
  if (fread(hdr, 1, 4, f) != 4 ||
      !((hdr[0] == 'I' && hdr[1] == 'I' && hdr[2] == 42 && hdr[3] == 0) ||
        (hdr[0] == 'M' && hdr[1] == 'M' && hdr[2] == 0 && hdr[3] == 42))) {
    fclose(f);
    return -1;
  }
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (sz <= 0) {
    fclose(f);
    return -40;
  }
  buf.resize((size_t)sz);
  size_t got = fread(buf.data(), 1, (size_t)sz, f);
  fclose(f);
  return got == (size_t)sz ? 0 : -40;
}

}  // namespace

extern "C" {

// Pin the OpenMP pool: libgomp probes online CPUs, which overcounts badly
// inside cgroup-limited containers (observed 16x slowdown from spin-wait
// oversubscription); the Python binding passes the affinity count instead.
void tiffdec_set_threads(int n);

// Query (w, h, channels). Returns 0 or a negative error code.
int tiff_info(const char* path, int* w, int* h, int* c) {
  std::vector<uint8_t> buf;
  int rc = read_file(path, buf);
  if (rc) return rc;
  Reader r{buf.data(), buf.size(), false};
  if (buf.size() < 8) return -1;
  if (buf[0] == 'M') r.swap = true;
  else if (buf[0] != 'I') return -1;
  if (r.u16(2) != 42) return -1;
  Tiff t;
  rc = parse(r, t);
  if (rc) return rc;
  *w = (int)t.width;
  *h = (int)t.height;
  *c = (int)t.spp;
  return 0;
}

// Decode into caller buffer of h*w*c uint8 (row-major chunky).
int tiff_decode(const char* path, uint8_t* out, long cap) {
  std::vector<uint8_t> buf;
  int rc = read_file(path, buf);
  if (rc) return rc;
  Tiff t;
  return decode_image(buf.data(), buf.size(), t, out, cap);
}

// Batch decode, OpenMP-parallel. All images must be hxwxc (checked); out is
// [n, h, w, c] uint8. errs[i] gets per-image status (0 ok).
int tiff_decode_batch(const char** paths, int n, int h, int w, int c,
                      uint8_t* out, int* errs) {
  const size_t tile = (size_t)h * w * c;
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < n; i++) {
    std::vector<uint8_t> buf;
    int rc = read_file(paths[i], buf);
    if (!rc) {
      Tiff t;
      // expected dims are validated BEFORE any write — a wrong-sized file
      // cannot overflow its slot
      rc = decode_image(buf.data(), buf.size(), t, out + (size_t)i * tile,
                        (long)tile, w, h, c);
    }
    errs[i] = rc;
  }
  for (int i = 0; i < n; i++)
    if (errs[i]) return errs[i];
  return 0;
}

// Batch decode 3-channel tiles fused with eval normalization:
//   out = ((channel-flipped x)/255 - mean) / std   as float32 [n, h, w, 3]
// bgr_flip=1 reproduces the reference's cv2-BGR convention
// (dataset/base_dataset.py:29-34: img[:,:,::-1]/255, then mean/std).
int tiff_decode_normalize_batch(const char** paths, int n, int h, int w,
                                const float* mean, const float* stdv,
                                int bgr_flip, float* out, int* errs) {
  const size_t tile = (size_t)h * w * 3;
  float inv_std[3], m[3];
  for (int k = 0; k < 3; k++) {
    inv_std[k] = 1.0f / stdv[k];
    m[k] = mean[k];
  }
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < n; i++) {
    std::vector<uint8_t> buf, px((size_t)h * w * 3);
    int rc = read_file(paths[i], buf);
    if (!rc) {
      Tiff t;
      rc = decode_image(buf.data(), buf.size(), t, px.data(),
                        (long)px.size(), w, h, 3);
    }
    errs[i] = rc;
    if (rc) continue;
    float* dst = out + (size_t)i * tile;
    const uint8_t* src = px.data();
    for (size_t p = 0; p < (size_t)h * w; p++) {
      for (int k = 0; k < 3; k++) {
        int sk = bgr_flip ? 2 - k : k;
        dst[p * 3 + k] = (src[p * 3 + sk] * (1.0f / 255.0f) - m[k]) * inv_std[k];
      }
    }
  }
  for (int i = 0; i < n; i++)
    if (errs[i]) return errs[i];
  return 0;
}

void tiffdec_set_threads(int n) {
#ifdef _OPENMP
  if (n > 0) omp_set_num_threads(n);
#else
  (void)n;
#endif
}

}  // extern "C"
