// Host-side C++ of the PyTorch port: CTC decoding for the OCR engine, the
// PNG row unfilter, and the serving path's frame ring, JSONL appender and
// pixel loops (BGRA->BGR, crop, odd-integer decimation, cv2's uint8 linear
// resize) and delta-codec encoders (nibble, tribit, per-segment), and the
// detector trainer's augmentation loops (cv2's HSV round trip with a
// per-channel table, and its bilinear warpAffine), and a baseline and
// progressive Huffman JPEG decoder (jpeg_decode) that gives the bytes
// libjpeg-turbo gives with its defaults, as cv2.imread decodes, and a
// baseline encoder (jpeg_encode) that writes the bytes cv2.imencode writes.
//
// Built by runtime/native.py with `g++ -O2 -shared -fPIC` at first use and
// bound with ctypes (plain C interface, no Python headers). Each function has
// a plain Python twin that the tests hold it against: ctc_score /
// ctc_score_multi / ctc_beam against ops/ctc.py (`score_candidates_plain`,
// `prefix_beam_decode_plain`), png_unfilter against runtime/png.py
// (`_unfilter`).
//
// The CTC functions, FrameRing, JsonLog, the pixel loops and the encoders are
// a copy of native/runtime.cpp (the JAX package's host runtime): the same
// algorithms, the same pruning rules and the same byte layouts. Their plain
// twins live in runtime/native.py (PlainFrameRing, PlainJsonLog,
// bgra_to_bgr_plain, crop_u8_plain, decimate_u8_plain, nibble_encode_plain,
// tribit_encode_plain, seg_encode_plain); resize_u8's is ops/image.py's
// cv_resize_u8; hsv_jitter_u8's and warp_affine_u8's are train/data.py's
// hsv_jitter_u8_plain and warp_affine_u8_plain, whose f32 operations they
// repeat in the same order (the build turns FMA contraction off). jpeg_decode
// and jpeg_encode have no plain twin: the tests hold them against cv2.imread
// and cv2.imencode byte for byte.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <new>
#include <string>
#include <unistd.h>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CTC

static inline double lse2(double a, double b) {
  if (a == -INFINITY) return b;
  if (b == -INFINITY) return a;
  double m = a > b ? a : b;
  return m + log1p(exp(-fabs(a - b)));
}

// CTC forward algorithm: log P(ids | logp) summed over alignments.
// logp: (T, C) row-major float32 log-probs; ids: L non-blank char ids
// (blank = 0). Returns the total log-probability.
float ctc_score(const float *logp, int32_t T, int32_t C, const int32_t *ids,
                int32_t L) {
  const int32_t E = 2 * L + 1;  // blank-extended label length
  std::vector<double> alpha((size_t)E, -INFINITY), next((size_t)E);
  alpha[0] = logp[0];  // blank
  if (L) alpha[1] = logp[ids[0]];
  for (int32_t t = 1; t < T; ++t) {
    const float *lp = logp + (size_t)t * C;
    for (int32_t e = 0; e < E; ++e) {
      double tot = alpha[e];
      if (e >= 1) tot = lse2(tot, alpha[e - 1]);
      // skip over the separating blank, unless the labels repeat
      if ((e & 1) && e >= 2 && ids[e / 2] != ids[(e - 2) / 2])
        tot = lse2(tot, alpha[e - 2]);
      int32_t sym = (e & 1) ? ids[e / 2] : 0;
      next[e] = tot + lp[sym];
    }
    alpha.swap(next);
  }
  double out = alpha[E - 1];
  if (L) out = lse2(out, alpha[E - 2]);
  return (float)out;
}

// Batched ctc_score: candidates packed in ids_flat with lengths lens[i];
// one call scores all n candidates against one (T, C) posterior.
void ctc_score_multi(const float *logp, int32_t T, int32_t C,
                     const int32_t *ids_flat, const int32_t *lens, int32_t n,
                     float *out) {
  const int32_t *p = ids_flat;
  for (int32_t i = 0; i < n; ++i) {
    out[i] = ctc_score(logp, T, C, p, lens[i]);
    p += lens[i];
  }
}

// CTC prefix beam search over one (T, C) masked log-softmax posterior.
// Writes up to beam_width prefixes into out_ids (beam_width x max_len,
// -1-padded), their lengths into out_lens, their log posteriors into
// out_scores; returns the number of beams emitted.
int32_t ctc_beam(const float *logp, int32_t T, int32_t C, int32_t beam_width,
                 int32_t topk, float prune_lp, int32_t *out_ids,
                 int32_t *out_lens, float *out_scores, int32_t max_len) {
  struct Beam {
    std::vector<int32_t> pfx;
    double pb, pnb;  // log mass ending in blank / in last char
  };
  std::vector<Beam> beams{{{}, 0.0, -INFINITY}};
  std::vector<int32_t> ord((size_t)C);
  std::vector<Beam> next;
  for (int32_t t = 0; t < T; ++t) {
    const float *lp = logp + (size_t)t * C;
    // top-k non-blank candidate chars above the prune threshold
    int32_t k = topk < C ? topk : C;
    int32_t kk = (k + 1) < C ? (k + 1) : C;  // +1 in case blank ranks top
    for (int32_t c = 0; c < C; ++c) ord[c] = c;
    std::partial_sort(ord.begin(), ord.begin() + kk, ord.end(),
                      [&](int32_t a, int32_t b) { return lp[a] > lp[b]; });
    int32_t cand[64], nc = 0;
    for (int32_t j = 0; j < kk && nc < k && nc < 64; ++j) {
      int32_t c = ord[j];
      if (c != 0 && lp[c] > prune_lp) cand[nc++] = c;
    }
    const double lpb = lp[0];
    next.clear();
    // candidate pool: stay (blank / repeat-frame) + extensions
    for (const Beam &b : beams) {
      double total = lse2(b.pb, b.pnb);
      // stay on the same prefix
      {
        double npb = total + lpb;
        double npnb = b.pfx.empty() ? -INFINITY : b.pnb + lp[b.pfx.back()];
        // merge into an existing identical prefix if present
        bool merged = false;
        for (Beam &nb : next)
          if (nb.pfx == b.pfx) {
            nb.pb = lse2(nb.pb, npb);
            nb.pnb = lse2(nb.pnb, npnb);
            merged = true;
            break;
          }
        if (!merged) next.push_back({b.pfx, npb, npnb});
      }
      int32_t last = b.pfx.empty() ? -1 : b.pfx.back();
      for (int32_t j = 0; j < nc; ++j) {
        int32_t c = cand[j];
        double mass = (c == last) ? b.pb + lp[c] : total + lp[c];
        std::vector<int32_t> npfx = b.pfx;
        npfx.push_back(c);
        bool merged = false;
        for (Beam &nb : next)
          if (nb.pfx == npfx) {
            nb.pnb = lse2(nb.pnb, mass);
            merged = true;
            break;
          }
        if (!merged) next.push_back({std::move(npfx), -INFINITY, mass});
      }
    }
    std::sort(next.begin(), next.end(), [](const Beam &a, const Beam &b) {
      return lse2(a.pb, a.pnb) > lse2(b.pb, b.pnb);
    });
    if ((int32_t)next.size() > beam_width) next.resize((size_t)beam_width);
    beams.swap(next);
  }
  int32_t n = 0;
  for (const Beam &b : beams) {
    if (n >= beam_width) break;
    int32_t L = (int32_t)b.pfx.size();
    if (L > max_len) continue;
    for (int32_t i = 0; i < max_len; ++i)
      out_ids[(size_t)n * max_len + i] = i < L ? b.pfx[i] : -1;
    out_lens[n] = L;
    out_scores[n] = (float)lse2(b.pb, b.pnb);
    ++n;
  }
  return n;
}

// ---------------------------------------------------------------------------
// PNG

static inline int32_t paeth(int32_t a, int32_t b, int32_t c) {
  int32_t p = a + b - c;
  int32_t pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undo the per-row filters of one PNG image (or one Adam7 pass):
// raw holds `height` rows of 1 filter-type byte + `stride` bytes; out gets
// height x stride bytes. `bpp` is the filter's byte distance (bytes per
// complete pixel, at least 1). Returns 0, or row + 1 of the first row whose
// filter type is not 0..4 (out is then incomplete).
int32_t png_unfilter(const uint8_t *raw, int32_t height, int32_t stride,
                     int32_t bpp, uint8_t *out) {
  const uint8_t *prev = nullptr;  // the row above, unfiltered; none for row 0
  for (int32_t y = 0; y < height; ++y) {
    const uint8_t ft = raw[(size_t)y * (stride + 1)];
    const uint8_t *in = raw + (size_t)y * (stride + 1) + 1;
    uint8_t *cur = out + (size_t)y * stride;
    switch (ft) {
      case 0:  // None
        for (int32_t i = 0; i < stride; ++i) cur[i] = in[i];
        break;
      case 1:  // Sub
        for (int32_t i = 0; i < stride; ++i)
          cur[i] = (uint8_t)(in[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int32_t i = 0; i < stride; ++i)
          cur[i] = (uint8_t)(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:  // Average
        for (int32_t i = 0; i < stride; ++i) {
          int32_t a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
          cur[i] = (uint8_t)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int32_t i = 0; i < stride; ++i) {
          int32_t a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
          int32_t c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          cur[i] = (uint8_t)(in[i] + paeth(a, b, c));
        }
        break;
      default:
        return y + 1;
    }
    prev = cur;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// FrameRing: single-producer single-consumer ring of fixed-size frames.
//
// Drop-oldest with SPSC safety: the producer never writes tail (each index
// has one writer). Every slot carries a seqlock word, 2*h+1 while item h is
// being written and 2*h+2 once stable, so when the producer wraps over an
// unread slot the consumer sees the overwrite (the word differs before and
// after its memcpy) and skips forward instead of reading a torn frame.

struct FrameRing {
  uint8_t *data;
  std::atomic<uint64_t> *seq;  // per-slot seqlock word
  int64_t slot_bytes;
  int32_t slots;
  std::atomic<uint64_t> head;     // next write sequence (producer-owned)
  std::atomic<uint64_t> tail;     // next read sequence (consumer-owned)
  std::atomic<uint64_t> dropped;  // approximate under wrap (stats only)
};

FrameRing *fr_create(int32_t slots, int64_t slot_bytes) {
  auto *r = new (std::nothrow) FrameRing();
  if (!r) return nullptr;
  r->data = new (std::nothrow) uint8_t[(size_t)slots * slot_bytes];
  r->seq = new (std::nothrow) std::atomic<uint64_t>[slots];
  if (!r->data || !r->seq) {
    delete[] r->data;
    delete[] r->seq;
    delete r;
    return nullptr;
  }
  r->slot_bytes = slot_bytes;
  r->slots = slots;
  for (int32_t i = 0; i < slots; ++i) r->seq[i].store(0);
  r->head.store(0);
  r->tail.store(0);
  r->dropped.store(0);
  return r;
}

void fr_destroy(FrameRing *r) {
  if (!r) return;
  delete[] r->data;
  delete[] r->seq;
  delete r;
}

// Push a frame; if the ring is full, overwrite the oldest (live-feed policy).
// Returns the sequence number assigned.
int64_t fr_push(FrameRing *r, const uint8_t *frame) {
  uint64_t h = r->head.load(std::memory_order_relaxed);
  uint64_t t = r->tail.load(std::memory_order_acquire);
  if (h - t >= (uint64_t)r->slots) {
    r->dropped.fetch_add(1, std::memory_order_relaxed);
  }
  uint64_t s = h % r->slots;
  r->seq[s].store(2 * h + 1, std::memory_order_relaxed);
  std::atomic_thread_fence(std::memory_order_release);
  std::memcpy(r->data + s * r->slot_bytes, frame, (size_t)r->slot_bytes);
  r->seq[s].store(2 * h + 2, std::memory_order_release);
  r->head.store(h + 1, std::memory_order_release);
  return (int64_t)h;
}

// Pop into out: the newest frame (skip_to_latest, which drops the older
// ones) or the oldest. Returns its sequence number, or -1 if empty.
int64_t fr_pop(FrameRing *r, uint8_t *out, int32_t skip_to_latest) {
  uint64_t t = r->tail.load(std::memory_order_relaxed);
  for (;;) {
    uint64_t h = r->head.load(std::memory_order_acquire);
    if (t >= h) {
      r->tail.store(t, std::memory_order_relaxed);
      return -1;
    }
    if (skip_to_latest && h - t > 1) {
      r->dropped.fetch_add(h - 1 - t, std::memory_order_relaxed);
      t = h - 1;
    }
    uint64_t s = t % r->slots;
    uint64_t s1 = r->seq[s].load(std::memory_order_acquire);
    if (s1 == 2 * t + 2) {
      std::memcpy(out, r->data + s * r->slot_bytes, (size_t)r->slot_bytes);
      std::atomic_thread_fence(std::memory_order_acquire);
      uint64_t s2 = r->seq[s].load(std::memory_order_relaxed);
      if (s1 == s2) {
        r->tail.store(t + 1, std::memory_order_release);
        return (int64_t)t;
      }
    }
    // item t was overwritten (or is mid-write by a wrapped producer): skip
    // it; the producer already counted the drop
    t += 1;
  }
}

int64_t fr_dropped(FrameRing *r) { return (int64_t)r->dropped.load(); }

int64_t fr_available(FrameRing *r) {
  uint64_t h = r->head.load(std::memory_order_acquire);
  uint64_t t = r->tail.load(std::memory_order_acquire);
  uint64_t n = h - t;
  if (n > (uint64_t)r->slots) n = (uint64_t)r->slots;
  return (int64_t)n;
}

// ---------------------------------------------------------------------------
// JsonLog: append-only JSONL, one write() per line so that each line lands
// whole for readers on the same filesystem.

struct JsonLog {
  int fd;
  std::mutex mu;
  uint64_t lines;
};

JsonLog *jl_open(const char *path) {
  int fd = ::open(path, O_WRONLY | O_CREAT | O_APPEND, 0644);
  if (fd < 0) return nullptr;
  auto *j = new (std::nothrow) JsonLog();
  if (!j) {
    ::close(fd);
    return nullptr;
  }
  j->fd = fd;
  j->lines = 0;
  return j;
}

// Appends one line and its '\n'. Returns the bytes written, or -1.
int64_t jl_append(JsonLog *j, const char *line, int64_t len) {
  std::lock_guard<std::mutex> g(j->mu);
  char stackbuf[8192];
  char *buf = stackbuf;
  bool heap = (len + 1) > (int64_t)sizeof(stackbuf);
  if (heap) buf = new (std::nothrow) char[len + 1];
  if (!buf) return -1;
  std::memcpy(buf, line, (size_t)len);
  buf[len] = '\n';
  ssize_t n = ::write(j->fd, buf, (size_t)len + 1);
  if (heap) delete[] buf;
  if (n > 0) j->lines++;
  return (int64_t)n;
}

int64_t jl_lines(JsonLog *j) { return (int64_t)j->lines; }

void jl_close(JsonLog *j) {
  if (!j) return;
  ::fsync(j->fd);
  ::close(j->fd);
  delete j;
}

// ---------------------------------------------------------------------------
// Pixel loops

void bgra_to_bgr(const uint8_t *src, uint8_t *dst, int64_t npix) {
  for (int64_t i = 0; i < npix; ++i) {
    dst[i * 3 + 0] = src[i * 4 + 0];
    dst[i * 3 + 1] = src[i * 4 + 1];
    dst[i * 3 + 2] = src[i * 4 + 2];
  }
}

// Crop [y1,y2) x [x1,x2) of an (h, w, 3) uint8 image into dst (contiguous).
// Bounds are clamped; returns the number of rows copied.
int32_t crop_u8(const uint8_t *src, int32_t h, int32_t w, int32_t y1,
                int32_t x1, int32_t y2, int32_t x2, uint8_t *dst) {
  if (y1 < 0) y1 = 0;
  if (x1 < 0) x1 = 0;
  if (y2 > h) y2 = h;
  if (x2 > w) x2 = w;
  if (y2 <= y1 || x2 <= x1) return 0;
  int32_t cw = x2 - x1;
  for (int32_t y = y1; y < y2; ++y) {
    std::memcpy(dst + (size_t)(y - y1) * cw * 3,
                src + ((size_t)y * w + x1) * 3, (size_t)cw * 3);
  }
  return y2 - y1;
}

// Odd-integer-stride point decimation of an (h, w, 3) uint8 image:
//   dst[y, x, c] = src[s*y + off, s*x + off, c],  off = (s - 1) / 2.
// For an odd integer downscale s, cv2's INTER_LINEAR sample position
// (x + 0.5) * s - 0.5 = s*x + (s-1)/2 is integral, so the bilinear weights
// fall on one source pixel: this gather is cv2's INTER_LINEAR, byte for byte
// (the serving letterbox of a 1920x1200 frame onto a 640 canvas is s = 3).
void decimate_u8(const uint8_t *src, int32_t w, int32_t s, int32_t off,
                 uint8_t *dst, int32_t oh, int32_t ow) {
  const size_t s3 = (size_t)s * 3;
  for (int32_t y = 0; y < oh; ++y) {
    const uint8_t *srow = src + ((size_t)(s * y + off) * w + off) * 3;
    uint8_t *drow = dst + (size_t)y * ow * 3;
    // overlapping 4-byte copies (one load and one store per pixel); the
    // ascending stores make the 1-byte overlap harmless, and the last pixel
    // is copied exactly so nothing is written past the row
    int32_t x = 0;
    for (; x < ow - 1; ++x) {
      uint32_t v;
      std::memcpy(&v, srow + (size_t)x * s3, 4);
      std::memcpy(drow + (size_t)x * 3, &v, 4);
    }
    const uint8_t *p = srow + (size_t)x * s3;
    drow[x * 3 + 0] = p[0];
    drow[x * 3 + 1] = p[1];
    drow[x * 3 + 2] = p[2];
  }
}

// cv2's uint8 INTER_LINEAR resize of an (h, w, c) image to (oh, ow, c),
// fixed point, from the tables of ops/image.py::cv_linear_tables: per output
// column the source columns x0/x1 and 11-bit weights xw0/xw1, per output row
// the (clamped) source rows y0/y1 and weights yw0/yw1. The horizontal pass
// runs once per source row the output reads and keeps 12 bits of each sum
// (>> 4); the vertical pass multiplies by the row weights, drops 16 bits,
// adds and rounds by 2 bits, as cv2's VResizeLinear does for uint8. The sums
// stay below 2^31 (255 * 2049 >> 4, times 2049). y0/y1 are nondecreasing.
void resize_u8(const uint8_t *src, int32_t w, int32_t c, const int32_t *x0,
               const int32_t *x1, const int32_t *xw0, const int32_t *xw1,
               const int32_t *y0, const int32_t *y1, const int32_t *yw0,
               const int32_t *yw1, uint8_t *dst, int32_t oh, int32_t ow) {
  const int32_t first = y0[0], last = y1[oh - 1];
  const size_t n = (size_t)ow * c;
  std::vector<int32_t> rows((size_t)(last - first + 1) * n);
  for (int32_t sy = first; sy <= last; ++sy) {
    const uint8_t *s = src + (size_t)sy * w * c;
    int32_t *r = rows.data() + (size_t)(sy - first) * n;
    for (int32_t x = 0; x < ow; ++x) {
      const uint8_t *pa = s + (size_t)x0[x] * c, *pb = s + (size_t)x1[x] * c;
      const int32_t wa = xw0[x], wb = xw1[x];
      for (int32_t k = 0; k < c; ++k) r[(size_t)x * c + k] = (pa[k] * wa + pb[k] * wb) >> 4;
    }
  }
  for (int32_t y = 0; y < oh; ++y) {
    const int32_t *r0 = rows.data() + (size_t)(y0[y] - first) * n;
    const int32_t *r1 = rows.data() + (size_t)(y1[y] - first) * n;
    const int32_t wy0 = yw0[y], wy1 = yw1[y];
    uint8_t *d = dst + (size_t)y * n;
    for (size_t i = 0; i < n; ++i) {
      const int32_t v = (((wy0 * r0[i]) >> 16) + ((wy1 * r1[i]) >> 16) + 2) >> 2;
      d[i] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

// ---------------------------------------------------------------------------
// Detector-trainer augmentation (train/data.py)

// n BGR pixels -> HSV (cv2's uint8 algorithm: 12-bit division tables, H in
// [0, 180)) -> each channel through its 256-entry table (luts: H, S, V) ->
// BGR (cv2's vectorised float path: s and v scaled by 1/255, the result
// times 255 truncated).
void hsv_jitter_u8(const uint8_t *src, int64_t n, const uint8_t *luts, uint8_t *dst) {
  int64_t sdiv[256] = {0}, hdiv[256] = {0};
  for (int i = 1; i < 256; ++i) {
    sdiv[i] = (int64_t)nearbyint((double)(255 << 12) / i);
    hdiv[i] = (int64_t)nearbyint((double)(180 << 12) / (6.0 * i));
  }
  static const int sectors[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                    {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
  const float hscale = (float)(6.0 / 180.0), inv255 = (float)(1.0 / 255.0);
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t *p = src + i * 3;
    const int64_t b = p[0], g = p[1], r = p[2];
    const int64_t v = std::max(std::max(b, g), r);
    const int64_t diff = v - std::min(std::min(b, g), r);
    const int64_t s = (diff * sdiv[v] + 2048) >> 12;
    int64_t h = v == r ? g - b : (v == g ? b - r + 2 * diff : r - g + 4 * diff);
    h = (h * hdiv[diff] + 2048) >> 12;
    if (h < 0) h += 180;
    float hf = (float)luts[h] * hscale;
    const float sf = (float)luts[256 + s] * inv255;
    const float vf = (float)luts[512 + v] * inv255;
    const int64_t sector = (int64_t)floorf(hf);
    hf = hf - (float)sector;
    // 1 - s*h with one rounding, as cv2's fused multiply-add: the double
    // product is exact
    const float t2 = (float)(1.0 - (double)sf * (double)hf);
    const float t3 = (float)(1.0 - (double)sf * (double)(1.0f - hf));
    const float tab[4] = {vf, vf * (1.0f - sf), vf * t2, vf * t3};
    const int *sec = sectors[((sector % 6) + 6) % 6];
    for (int c = 0; c < 3; ++c) {
      const float o = truncf(tab[sec[c]] * 255.0f);
      dst[i * 3 + c] = (uint8_t)(o < 0.0f ? 0.0f : (o > 255.0f ? 255.0f : o));
    }
  }
}

// f32 a * b + c with one rounding (cv2's fused multiply-adds): the double
// product of two floats is exact. train/data.py's _fma computes the same.
static inline float fma_f32(float a, float b, float c) {
  return (float)((double)a * (double)b + (double)c);
}

// Bilinear warp of an (h, w, 3) uint8 image onto a size x size canvas. a is
// the inverted 2x3 matrix in f32 (output pixel -> source point); neighbours
// outside the image read `border`; the f32 blend is rounded half to even.
void warp_affine_u8(const uint8_t *src, int32_t h, int32_t w, const float *a,
                    int32_t size, int32_t border, uint8_t *dst) {
  const float bv = (float)border;
  for (int32_t y = 0; y < size; ++y) {
    const float yf = (float)y;
    const float bx = a[1] * yf + a[2], by = a[4] * yf + a[5];
    for (int32_t x = 0; x < size; ++x) {
      const float xf = (float)x;
      const float sxf = fma_f32(a[0], xf, bx), syf = fma_f32(a[3], xf, by);
      const float flx = floorf(sxf), fly = floorf(syf);
      const int64_t sx = (int64_t)flx, sy = (int64_t)fly;
      const float fx = sxf - flx, fy = syf - fly;
      const bool x0in = sx >= 0 && sx < w, x1in = sx + 1 >= 0 && sx + 1 < w;
      const bool y0in = sy >= 0 && sy < h, y1in = sy + 1 >= 0 && sy + 1 < h;
      const uint8_t *r0 = src + (size_t)(y0in ? sy : 0) * w * 3;
      const uint8_t *r1 = src + (size_t)(y1in ? sy + 1 : 0) * w * 3;
      uint8_t *d = dst + ((size_t)y * size + x) * 3;
      for (int c = 0; c < 3; ++c) {
        const float p00 = y0in && x0in ? (float)r0[sx * 3 + c] : bv;
        const float p01 = y0in && x1in ? (float)r0[(sx + 1) * 3 + c] : bv;
        const float p10 = y1in && x0in ? (float)r1[sx * 3 + c] : bv;
        const float p11 = y1in && x1in ? (float)r1[(sx + 1) * 3 + c] : bv;
        const float top = fma_f32(fx, p01 - p00, p00);
        const float bot = fma_f32(fx, p11 - p10, p10);
        const float v = nearbyintf(fma_f32(fy, bot - top, top));
        d[c] = (uint8_t)(v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v));
      }
    }
  }
}


// ---------------------------------------------------------------------------
// Serving's delta-codec encoders (runtime/serving.py BatchStream): a copy of
// native/runtime.cpp's nibble_encode, tribit_encode and seg_encode, with the
// same byte layouts, cost-based class choice and tie-breaks. Their plain
// twins are runtime/native.py's nibble_encode_plain, tribit_encode_plain
// and seg_encode_plain.
// ---------------------------------------------------------------------------
// nibble_encode: the tri-mode delta streaming hot encoder (serving.py
// BatchStream). Semantics match the numpy reference implementation
// byte-for-byte:
//   d[i] = cur[i] - prev[i]                    (per byte, int16)
//   per (slot, channel): span = dmax - dmin; if span > 15 anywhere -> 0
//   bias = min(max(0, dmax - 7), dmin + 8)     (clipped toward 0)
//   v[i] = (uint8)(d[i] - bias + 8)            (mod 256, lands in [0, 15])
//   nib[k] = v[2k] | v[2k+1] << 4
//   out_bias[slot*3 + c] = (uint8)bias         (mod 256)
// The numpy version costs ~480 ms/batch (7 strided full-array passes); this
// fused two-pass loop runs at memory bandwidth (~20 ms/batch, batch 32 @
// 640x400 active rows). Single-threaded by design: the box has ONE core and
// ctypes releases the GIL, so the transfer pump thread still makes progress.
// ---------------------------------------------------------------------------
int32_t nibble_encode(const uint8_t *cur, const uint8_t *prev, int32_t nslots,
                      int64_t slot_bytes, int64_t slot_stride,
                      uint8_t *out_nib, uint8_t *out_bias) {
  for (int32_t s = 0; s < nslots; ++s) {
    const uint8_t *c = cur + (size_t)s * slot_stride;
    const uint8_t *p = prev + (size_t)s * slot_stride;
    uint8_t *nib = out_nib + (size_t)s * (slot_bytes / 2);
    // pass 1: per-channel delta min/max via 48 lane accumulators (48 = a
    // multiple of 3 wide enough for the autovectorizer; lane k tracks
    // channel k % 3)
    int16_t mn[48], mx[48];
    for (int k = 0; k < 48; ++k) {
      mn[k] = 32767;
      mx[k] = -32768;
    }
    int64_t i = 0;
    for (; i + 48 <= slot_bytes; i += 48) {
      for (int k = 0; k < 48; ++k) {
        int16_t d = (int16_t)c[i + k] - (int16_t)p[i + k];
        if (d < mn[k]) mn[k] = d;
        if (d > mx[k]) mx[k] = d;
      }
    }
    int16_t cmn[3] = {32767, 32767, 32767};
    int16_t cmx[3] = {-32768, -32768, -32768};
    for (int k = 0; k < 48; ++k) {
      int ch = k % 3;
      if (mn[k] < cmn[ch]) cmn[ch] = mn[k];
      if (mx[k] > cmx[ch]) cmx[ch] = mx[k];
    }
    for (; i < slot_bytes; ++i) {
      int ch = (int)(i % 3);
      int16_t d = (int16_t)c[i] - (int16_t)p[i];
      if (d < cmn[ch]) cmn[ch] = d;
      if (d > cmx[ch]) cmx[ch] = d;
    }
    uint8_t add[6];  // (8 - bias) per position, period lcm(3, 2) = 6
    for (int ch = 0; ch < 3; ++ch) {
      if (cmx[ch] - cmn[ch] > 15) return 0;
      int16_t b = (int16_t)(cmx[ch] - 7);
      if (b < 0) b = 0;
      if (b > cmn[ch] + 8) b = (int16_t)(cmn[ch] + 8);
      out_bias[s * 3 + ch] = (uint8_t)b;
      add[ch] = add[ch + 3] = (uint8_t)(8 - b);
    }
    // pass 2: residual + pack, 6 input bytes -> 3 nibble bytes per step
    int64_t j = 0;
    i = 0;
    for (; i + 6 <= slot_bytes; i += 6, j += 3) {
      uint8_t v0 = (uint8_t)(c[i + 0] - p[i + 0] + add[0]);
      uint8_t v1 = (uint8_t)(c[i + 1] - p[i + 1] + add[1]);
      uint8_t v2 = (uint8_t)(c[i + 2] - p[i + 2] + add[2]);
      uint8_t v3 = (uint8_t)(c[i + 3] - p[i + 3] + add[3]);
      uint8_t v4 = (uint8_t)(c[i + 4] - p[i + 4] + add[4]);
      uint8_t v5 = (uint8_t)(c[i + 5] - p[i + 5] + add[5]);
      nib[j + 0] = (uint8_t)((v0 & 0xF) | (uint8_t)(v1 << 4));
      nib[j + 1] = (uint8_t)((v2 & 0xF) | (uint8_t)(v3 << 4));
      nib[j + 2] = (uint8_t)((v4 & 0xF) | (uint8_t)(v5 << 4));
    }
    for (; i + 2 <= slot_bytes; i += 2, ++j) {
      uint8_t v0 = (uint8_t)(c[i] - p[i] + add[i % 3]);
      uint8_t v1 = (uint8_t)(c[i + 1] - p[i + 1] + add[(i + 1) % 3]);
      nib[j] = (uint8_t)((v0 & 0xF) | (uint8_t)(v1 << 4));
    }
  }
  return 1;
}

// ---------------------------------------------------------------------------
// tribit_encode: 3-bit residuals with PER-ROW biases — the tighter delta
// mode (3/8 the raw bytes vs the nibble mode's 1/2). Fits when every
// (slot, row, channel)'s delta span (max - min) <= 7; a per-row-channel
// bias in [dmax-3, dmin+4] (clipped toward 0) then puts every residual in
// [-4, 3], stored as v = d - bias + 4 in [0, 7]. Groups of 8 values pack
// little-endian into 3 bytes:
//   b0 = v0 | v1<<3 | (v2&3)<<6
//   b1 = v2>>2 | v3<<1 | v4<<4 | (v5&1)<<7
//   b2 = v5>>1 | v6<<2 | v7<<5
// out_bias holds nslots*nh*3 bytes (bias mod 256, row-major). Requires
// row_bytes = W*3 divisible by 8 (W % 8 == 0; canvas widths are /32).
// Returns 1, or 0 when any row's span exceeds 7 (caller tries nibble/raw).
// All arithmetic mod 256 -> bit-exact reconstruction.
// ---------------------------------------------------------------------------
int32_t tribit_encode(const uint8_t *cur, const uint8_t *prev, int32_t nslots,
                      int32_t nh, int32_t width, int64_t slot_stride,
                      uint8_t *out_bits, uint8_t *out_bias) {
  const int64_t row_bytes = (int64_t)width * 3;
  if (row_bytes % 8 != 0) return 0;
  const int64_t row_out = row_bytes * 3 / 8;
  for (int32_t s = 0; s < nslots; ++s) {
    for (int32_t r = 0; r < nh; ++r) {
      const uint8_t *c = cur + (size_t)s * slot_stride + (size_t)r * row_bytes;
      const uint8_t *p = prev + (size_t)s * slot_stride + (size_t)r * row_bytes;
      // row min/max per channel (24-lane accumulators)
      int16_t mn[24], mx[24];
      for (int k = 0; k < 24; ++k) {
        mn[k] = 32767;
        mx[k] = -32768;
      }
      int64_t i = 0;
      for (; i + 24 <= row_bytes; i += 24) {
        for (int k = 0; k < 24; ++k) {
          int16_t d = (int16_t)c[i + k] - (int16_t)p[i + k];
          if (d < mn[k]) mn[k] = d;
          if (d > mx[k]) mx[k] = d;
        }
      }
      int16_t cmn[3] = {32767, 32767, 32767};
      int16_t cmx[3] = {-32768, -32768, -32768};
      for (int k = 0; k < 24; ++k) {
        int ch = k % 3;
        if (mn[k] < cmn[ch]) cmn[ch] = mn[k];
        if (mx[k] > cmx[ch]) cmx[ch] = mx[k];
      }
      for (; i < row_bytes; ++i) {
        int ch = (int)(i % 3);
        int16_t d = (int16_t)c[i] - (int16_t)p[i];
        if (d < cmn[ch]) cmn[ch] = d;
        if (d > cmx[ch]) cmx[ch] = d;
      }
      uint8_t add[6];
      uint8_t *bias_row = out_bias + ((size_t)s * nh + r) * 3;
      for (int ch = 0; ch < 3; ++ch) {
        if (cmx[ch] - cmn[ch] > 7) return 0;
        int16_t b = (int16_t)(cmx[ch] - 3);
        if (b < 0) b = 0;
        if (b > cmn[ch] + 4) b = (int16_t)(cmn[ch] + 4);
        bias_row[ch] = (uint8_t)b;
        add[ch] = add[ch + 3] = (uint8_t)(4 - b);
      }
      uint8_t *o = out_bits + ((size_t)s * nh + r) * row_out;
      // 24-byte blocks (lcm(8, 3)): channel offsets k % 3 are compile-time
      // after unrolling, so the residual pass vectorizes; W % 8 == 0 and
      // rows are pixel-aligned, so a scalar 8-byte tail covers W % 24 != 0
      uint8_t v[24];
      for (i = 0; i + 24 <= row_bytes; i += 24, o += 9) {
        for (int k = 0; k < 24; ++k)
          v[k] = (uint8_t)((uint8_t)(c[i + k] - p[i + k] + add[k % 3]) & 7);
        for (int g = 0; g < 3; ++g) {
          const uint8_t *w = v + g * 8;
          o[g * 3 + 0] =
              (uint8_t)(w[0] | (uint8_t)(w[1] << 3) | (uint8_t)((w[2] & 3) << 6));
          o[g * 3 + 1] = (uint8_t)((w[2] >> 2) | (uint8_t)(w[3] << 1) |
                                   (uint8_t)(w[4] << 4) | (uint8_t)((w[5] & 1) << 7));
          o[g * 3 + 2] =
              (uint8_t)((w[5] >> 1) | (uint8_t)(w[6] << 2) | (uint8_t)(w[7] << 5));
        }
      }
      for (; i + 8 <= row_bytes; i += 8, o += 3) {
        for (int k = 0; k < 8; ++k)
          v[k] = (uint8_t)((uint8_t)(c[i + k] - p[i + k] + add[(i + k) % 3]) & 7);
        o[0] = (uint8_t)(v[0] | (uint8_t)(v[1] << 3) | (uint8_t)((v[2] & 3) << 6));
        o[1] = (uint8_t)((v[2] >> 2) | (uint8_t)(v[3] << 1) |
                         (uint8_t)(v[4] << 4) | (uint8_t)((v[5] & 1) << 7));
        o[2] = (uint8_t)((v[5] >> 1) | (uint8_t)(v[6] << 2) | (uint8_t)(v[7] << 5));
      }
    }
  }
  return 1;
}

// ---------------------------------------------------------------------------
// seg_encode: per-SEGMENT multi-class delta encoder (the "segs" streaming
// mode). Each row of the active region splits into width/segw segments of
// segb = segw*3 bytes; every segment is independently classified by its
// per-channel delta span and encoded in the cheapest class that fits:
//
//   class 0 (const): span == 0 on every channel -> bias IS the delta,
//                    zero payload bytes
//   class 1 (1-bit): span <= 1  -> v = d - bias in [0, 1],
//                    8 values/byte, segb/8 payload bytes
//   class 2 (2-bit): span <= 3  -> v = d - bias + 2 in [0, 3],
//                    4 values/byte, segb/4 payload bytes
//   class 3 (3-bit): span <= 7  -> v = d - bias + 4 in [0, 7],
//                    8 values per 3 bytes, segb*3/8 payload bytes
//   class 4 (raw):   anything   -> the segment's cur bytes verbatim
//   class 5 (clamp-shift): cur == clamp(prev + j, 0, 255) for the SLOT's
//                    per-channel shift candidate j -> zero payload bytes,
//                    bias = j mod 256 (decoder sign-extends). This is the
//                    brightness-change primitive: a global photometric
//                    shift with clipping makes every segment class 5, so
//                    the payload collapses to the class/flag arrays. j is
//                    detected from the slot's first unclippable pixel per
//                    channel (prev in [64, 191], |j| <= 63) and every
//                    segment is verified byte-exactly before classifying.
//   class 6/7 (shift + 2/3-bit residual): cur = clamp(prev + j) + e with a
//                    small ONE-SIDED per-channel residual e. This is the
//                    clip-boundary case class 5 cannot absorb: prev was
//                    itself clipped (information lost), so no pure shift
//                    reproduces cur — but the error is bounded by the
//                    previous frame's clip loss, |e| <= |j_prev|. bias
//                    byte = ((j + 64) & 0x7F) | (m << 7) where m selects
//                    the residual sign window: e in [0, lim] (m = 0) or
//                    [-lim, 0] (m = 1), lim = 3 (class 6, payload in the
//                    2-bit block) / 7 (class 7, 3-bit block). Before this
//                    class those segments fell to raw (120 B vs 30/45 B) —
//                    measured 13.5%% of a jittered bench stream's segments.
//   class 8 (sparse nibble, const base): cur = prev + bias + r where bias
//                    is the per-channel MODAL delta and r != 0 on few
//                    bytes, all |r| <= 7. Payload = a TWO-LEVEL deviation
//                    mask (one L byte whose bits flag dirty 24-byte
//                    sub-blocks, plus a 3-byte bitmask per dirty
//                    sub-block — deviations cluster on clip boundaries,
//                    so most sub-blocks are clean and the two-level form
//                    averages ~7 B vs the flat segb/8-byte mask's 15) +
//                    one signed nibble per deviating byte in a shared
//                    nibble stream. Round-5 measurement: payload
//                    segments' residuals are SPARSE (median 14 deviating
//                    of 120 bytes on the bench stream), so mask+nibbles
//                    beats the dense 2/3-bit classes on most of their
//                    mass. Requires segb/24 <= 8 (segw <= 64) so the L
//                    byte covers every sub-block.
//   class 9 (sparse nibble, shift base): cur = clamp(prev + j) + r, r as
//                    in class 8 but against the slot's clamp-shift
//                    prediction (two-sided |r| <= 7 — strictly more
//                    general than class 6/7's one-sided window). bias
//                    byte = (j + 64) & 0x7F.
//   class 10 (sparse byte, const base): as class 8 but r unbounded (mod
//                    256), one BYTE per deviating position in a shared
//                    byte stream — catches sparse repaints (sprite edges)
//                    that fell to raw.
//
// Every payload segment takes the BYTE-CHEAPEST class (computed exactly:
// sparse classes cost segb/8 + ceil(nz/2) or segb/8 + nz); ties prefer
// the dense classes in order 2,6,3,7,8,9,10,raw (numpy mirror matches
// bit-for-bit). Biases of the dense classes stay clipped toward 0
// (zero-delta regions remain maximally transit-compressible); all
// arithmetic is mod 256 -> bit-exact. Payloads append densely per class
// in scan order (the device recovers each segment's position from a
// cumsum over the class array — no offsets on the wire); nibble/byte
// exception streams pack contiguously ACROSS segments (the device derives
// each segment's stream offset from an exclusive cumsum of mask
// popcounts, and each dirty sub-block's 3-byte mask row from an
// exclusive cumsum of L-byte popcounts). Never fails; out_counts =
// {n_1bit, n_2bit, n_3bit, n_raw, n_mask4 (classes 8+9), n_mask8
// (class 10), nz_nibbles, nz_bytes, n_dirty4, n_dirty8}.
// Requires segw % 8 == 0 (so segb % 24 == 0: whole 24-lane blocks only)
// and segw <= 64 (two-level mask L byte covers <= 8 sub-blocks).
// ---------------------------------------------------------------------------
int32_t seg_encode(const uint8_t *cur, const uint8_t *prev, int32_t nslots,
                   int32_t nh, int32_t width, int64_t slot_stride,
                   int32_t segw, uint8_t *out_p1, uint8_t *out_p2,
                   uint8_t *out_p3, uint8_t *out_raw, uint8_t *out_m4,
                   uint8_t *out_m8, uint8_t *out_s4, uint8_t *out_s8,
                   uint8_t *out_nib, uint8_t *out_byte,
                   uint8_t *out_bias, uint8_t *out_cls,
                   int64_t *out_counts) {
  if (segw % 8 != 0 || width % segw != 0 || segw > 64) return 0;
  const int64_t row_bytes = (int64_t)width * 3;
  const int32_t nsegrow = width / segw;
  const int64_t segb = (int64_t)segw * 3;  // % 24 == 0
  int64_t k1 = 0, k2 = 0, k3 = 0, kr = 0, seg_i = 0;
  int64_t k4m = 0, k10m = 0, nz4 = 0, nz8 = 0, d4 = 0, d8 = 0;
  std::vector<uint8_t> xbuf((size_t)segb);  // recentered deltas scratch
  uint8_t lut[3][256];  // per-slot clamp-shift table: lut[ch][p]=clamp(p+j)
  for (int32_t s = 0; s < nslots; ++s) {
    // per-slot clamp-shift candidate: first safe pixel per channel
    int16_t jj[3] = {0, 0, 0};
    bool jvalid;
    {
      const uint8_t *pbase = prev + (size_t)s * slot_stride;
      const uint8_t *cbase = cur + (size_t)s * slot_stride;
      const int64_t n = (int64_t)nh * row_bytes;
      bool found[3] = {false, false, false};
      int remaining = 3;
      for (int64_t i = 0; i < n && remaining; ++i) {
        const int ch = (int)(i % 3);
        if (!found[ch] && pbase[i] >= 64 && pbase[i] <= 191) {
          found[ch] = true;
          --remaining;
          jj[ch] = (int16_t)cbase[i] - (int16_t)pbase[i];
        }
      }
      jvalid = remaining == 0 && jj[0] >= -63 && jj[0] <= 63 &&
               jj[1] >= -63 && jj[1] <= 63 && jj[2] >= -63 && jj[2] <= 63;
    }
    if (jvalid) {
      for (int ch = 0; ch < 3; ++ch)
        for (int v = 0; v < 256; ++v) {
          const int16_t x = (int16_t)(v + jj[ch]);
          lut[ch][v] = (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x));
        }
    }
    // whole-slot fast path: when EVERY byte of the slot verifies as
    // clamp(prev + j) (the global-photometric-jitter case), classify all
    // its segments 5 in one branchless pass — no per-segment min/max or
    // verify work. Row-wise early exit keeps repaint slots cheap.
    if (jvalid && (jj[0] != 0 || jj[1] != 0 || jj[2] != 0)) {
      bool slot_shift = true;
      for (int32_t r = 0; r < nh && slot_shift; ++r) {
        const uint8_t *crow =
            cur + (size_t)s * slot_stride + (size_t)r * row_bytes;
        const uint8_t *prow =
            prev + (size_t)s * slot_stride + (size_t)r * row_bytes;
        uint8_t acc = 0;
        int ch = 0;
        for (int64_t i = 0; i < row_bytes; ++i) {
          acc |= (uint8_t)(lut[ch][prow[i]] ^ crow[i]);
          ch = ch == 2 ? 0 : ch + 1;
        }
        slot_shift = acc == 0;
      }
      if (slot_shift) {
        const uint8_t b0 = (uint8_t)jj[0], b1 = (uint8_t)jj[1],
                      b2 = (uint8_t)jj[2];
        for (int32_t g2 = 0; g2 < nh * nsegrow; ++g2, ++seg_i) {
          out_cls[seg_i] = 5;
          uint8_t *bias = out_bias + (size_t)seg_i * 3;
          bias[0] = b0;
          bias[1] = b1;
          bias[2] = b2;
        }
        continue;
      }
    }
    for (int32_t r = 0; r < nh; ++r) {
      const uint8_t *crow = cur + (size_t)s * slot_stride + (size_t)r * row_bytes;
      const uint8_t *prow = prev + (size_t)s * slot_stride + (size_t)r * row_bytes;
      for (int32_t g = 0; g < nsegrow; ++g, ++seg_i) {
        const uint8_t *c = crow + (size_t)g * segb;
        const uint8_t *p = prow + (size_t)g * segb;
        // per-channel delta min/max over the RECENTERED mod-256 domain:
        // v = (c - p) ^ 0x80 maps delta d to d + 128 (mod 256), so byte
        // min/max classify the span without int16 widening (the pass
        // autovectorizes as uint8 lanes — it reads 2x the payload bytes
        // and dominates encode time). Downstream reconstruction is
        // mod-256 throughout, so a wrapped delta (|d| > 127) classifying
        // via its residue is still bit-exact.
        uint8_t mnv[24], mxv[24];
        uint8_t *xv = xbuf.data();  // recentered deltas, reused downstream
        for (int k = 0; k < 24; ++k) {
          mnv[k] = 255;
          mxv[k] = 0;
        }
        for (int64_t i = 0; i + 24 <= segb; i += 24) {
          for (int k = 0; k < 24; ++k) {
            uint8_t v = (uint8_t)((uint8_t)(c[i + k] - p[i + k]) ^ 0x80);
            xv[i + k] = v;
            if (v < mnv[k]) mnv[k] = v;
            if (v > mxv[k]) mxv[k] = v;
          }
        }
        int16_t cmn[3] = {32767, 32767, 32767};
        int16_t cmx[3] = {-32768, -32768, -32768};
        for (int k = 0; k < 24; ++k) {
          int ch = k % 3;
          int16_t lo = (int16_t)mnv[k] - 128;
          int16_t hi = (int16_t)mxv[k] - 128;
          if (lo < cmn[ch]) cmn[ch] = lo;
          if (hi > cmx[ch]) cmx[ch] = hi;
        }
        int16_t span = 0;
        for (int ch = 0; ch < 3; ++ch)
          if (cmx[ch] - cmn[ch] > span) span = (int16_t)(cmx[ch] - cmn[ch]);
        uint8_t *bias = out_bias + (size_t)seg_i * 3;
        bool shifted = false;
        if (span != 0 && jvalid) {
          // envelope pre-check (implied by a passing verify: clamp-shift
          // deltas lie in [min(j,0), max(j,0)] per channel), then exact
          // byte verification
          bool env = true;
          for (int ch = 0; ch < 3 && env; ++ch) {
            const int16_t lo = jj[ch] < 0 ? jj[ch] : (int16_t)0;
            const int16_t hi = jj[ch] > 0 ? jj[ch] : (int16_t)0;
            env = cmn[ch] >= lo && cmx[ch] <= hi;
          }
          if (env) {
            bool ok = true;
            int vch = 0;
            for (int64_t i = 0; i < segb && ok; ++i) {
              ok = c[i] == lut[vch][p[i]];
              vch = vch == 2 ? 0 : vch + 1;
            }
            if (ok) {
              shifted = true;
              out_cls[seg_i] = 5;
              for (int ch = 0; ch < 3; ++ch) bias[ch] = (uint8_t)jj[ch];
            }
          }
        }
        if (shifted) {
          // zero payload bytes
        } else if (span == 0) {
          out_cls[seg_i] = 0;
          for (int ch = 0; ch < 3; ++ch) bias[ch] = (uint8_t)cmn[ch];
        } else {
          // ---- exact byte-cost selection: dense 1/2/6/3/7 vs sparse
          // 8/9/10 vs raw (preference on cost ties: 1,2,6,3,7,8,9,10,raw
          // — the numpy mirror replicates this order bit-for-bit).
          // Sparse cost = 1 L byte + 3 B per dirty 24-byte sub-block +
          // the value stream (two-level mask).
          const int32_t q1b = (int32_t)(segb / 8);
          const int32_t q2b = (int32_t)(segb / 4);
          const int32_t q3b = (int32_t)(segb * 3 / 8);
          const int32_t INF = 1 << 30;
          // const-modal bias (ties -> smallest value) from the recentered
          // histogram; bx = the bias in the recentered-u8 domain
          int16_t biasc[3];
          uint8_t bx24[24];
          {
            int16_t hist[256];
            for (int ch = 0; ch < 3; ++ch) {
              const uint8_t base = (uint8_t)(cmn[ch] + 128);
              const int win = (int)(cmx[ch] - cmn[ch]) + 1;
              for (int k = 0; k < win; ++k) hist[k] = 0;
              for (int64_t i = ch; i < segb; i += 3)
                ++hist[(uint8_t)(xv[i] - base)];
              int bi = 0;
              for (int k = 1; k < win; ++k)
                if (hist[k] > hist[bi]) bi = k;
              biasc[ch] = (int16_t)(cmn[ch] + bi);
              for (int rep = ch; rep < 24; rep += 3)
                bx24[rep] = (uint8_t)(base + bi);
            }
          }
          // branchless const-residual stats in u8 lanes. Admission for the
          // nibble class is the mod-256 window r in [-8, 7] — exactly the
          // range a signed nibble decodes bit-exactly, so alias cases
          // (|true r| huge but congruent) are admitted AND correct.
          int32_t nz_c = 0, db_c = 0;
          uint8_t bad8 = 0;
          {
            uint8_t cnt24[24] = {0}, bad24[24] = {0};
            for (int64_t i = 0; i + 24 <= segb; i += 24) {
              uint8_t any24[24];
              for (int k = 0; k < 24; ++k) {
                const uint8_t u = (uint8_t)(xv[i + k] - bx24[k]);
                const uint8_t nzb = (uint8_t)(u != 0);
                cnt24[k] += nzb;
                any24[k] = nzb;
                bad24[k] |= (uint8_t)((uint8_t)(u + 8) > 15);
              }
              uint8_t any = 0;
              for (int k = 0; k < 24; ++k) any |= any24[k];
              db_c += (any != 0);
            }
            for (int k = 0; k < 24; ++k) {
              nz_c += cnt24[k];
              bad8 |= bad24[k];
            }
          }
          // shift-base residual stats (classes 6/7/9); the one/two-sided
          // windows are mod-256 (admission == decodability, as above).
          // When no byte of the segment can clamp under j (per-lane
          // threshold check on prev — the common mid-range case), e is
          // just (delta - j) mod 256 and the whole pass runs in u8 lanes;
          // only clip-danger segments take the scalar LUT walk.
          int32_t nz_s = 0, db_s = 0;
          bool fit6 = jvalid, fit7 = jvalid, fit9 = jvalid;
          int16_t off6[3] = {0, 0, 0}, off7[3] = {0, 0, 0};
          if (jvalid) {
            uint8_t jm24[24], dhi24[24], dlo24[24];
            for (int k = 0; k < 24; ++k) {
              const int ch = k % 3;
              jm24[k] = (uint8_t)jj[ch];
              dhi24[k] = jj[ch] > 0 ? (uint8_t)(255 - jj[ch]) : (uint8_t)255;
              dlo24[k] = jj[ch] < 0 ? (uint8_t)(-jj[ch]) : (uint8_t)0;
            }
            uint8_t danger24[24] = {0};
            for (int64_t i = 0; i + 24 <= segb; i += 24)
              for (int k = 0; k < 24; ++k) {
                const uint8_t pv = p[i + k];
                danger24[k] |=
                    (uint8_t)((pv > dhi24[k]) | (pv < dlo24[k]));
              }
            uint8_t danger = 0;
            for (int k = 0; k < 24; ++k) danger |= danger24[k];
            uint8_t cnt24[24] = {0}, bad24[24] = {0};
            uint8_t p6a[24] = {0}, n6a[24] = {0};
            uint8_t p7a[24] = {0}, n7a[24] = {0};
            if (!danger) {
              for (int64_t i = 0; i + 24 <= segb; i += 24) {
                uint8_t any = 0;
                for (int k = 0; k < 24; ++k) {
                  const uint8_t e =
                      (uint8_t)((uint8_t)(xv[i + k] ^ 0x80) - jm24[k]);
                  const uint8_t nzb = (uint8_t)(e != 0);
                  cnt24[k] += nzb;
                  any |= nzb;
                  bad24[k] |= (uint8_t)((uint8_t)(e + 8) > 15);
                  p6a[k] |= (uint8_t)(e > 3);
                  n6a[k] |= (uint8_t)((uint8_t)(e + 3) > 3);
                  p7a[k] |= (uint8_t)(e > 7);
                  n7a[k] |= (uint8_t)((uint8_t)(e + 7) > 7);
                }
                db_s += (any != 0);
              }
            } else {
              int ch = 0;
              uint8_t any = 0;
              for (int64_t i = 0; i < segb; ++i) {
                const uint8_t e = (uint8_t)(c[i] - lut[ch][p[i]]);
                const uint8_t nzb = (uint8_t)(e != 0);
                cnt24[ch] += nzb;
                any |= nzb;
                bad24[ch] |= (uint8_t)((uint8_t)(e + 8) > 15);
                p6a[ch] |= (uint8_t)(e > 3);
                n6a[ch] |= (uint8_t)((uint8_t)(e + 3) > 3);
                p7a[ch] |= (uint8_t)(e > 7);
                n7a[ch] |= (uint8_t)((uint8_t)(e + 7) > 7);
                ch = ch == 2 ? 0 : ch + 1;
                if ((i + 1) % 24 == 0) {
                  db_s += (any != 0);
                  any = 0;
                }
              }
            }
            uint8_t bad9 = 0;
            uint8_t pos6[3] = {0, 0, 0}, neg6[3] = {0, 0, 0};
            uint8_t pos7[3] = {0, 0, 0}, neg7[3] = {0, 0, 0};
            for (int k = 0; k < 24; ++k) {
              const int ch = k % 3;
              nz_s += cnt24[k];
              bad9 |= bad24[k];
              pos6[ch] |= p6a[k];
              neg6[ch] |= n6a[k];
              pos7[ch] |= p7a[k];
              neg7[ch] |= n7a[k];
            }
            fit9 = !bad9;
            for (int c3i = 0; c3i < 3; ++c3i) {
              if (!pos6[c3i]) off6[c3i] = 0;
              else if (!neg6[c3i]) off6[c3i] = 3;
              else fit6 = false;
              if (!pos7[c3i]) off7[c3i] = 0;
              else if (!neg7[c3i]) off7[c3i] = 7;
              else fit7 = false;
            }
          }
          const int32_t c1c = span <= 1 ? q1b : INF;
          const int32_t c2c = span <= 3 ? q2b : INF;
          const int32_t c6c = fit6 ? q2b : INF;
          const int32_t c3c = span <= 7 ? q3b : INF;
          const int32_t c7c = fit7 ? q3b : INF;
          // classes 8/10 carry a per-segment modal bias that almost never
          // matches the slot default -> +3 B bias-exception cost; class
          // 9's bias is the slot shift j in the class-5 byte convention,
          // which IS the slot default on a photometric tick -> free
          const int32_t c8c = !bad8 ? 4 + 3 * db_c + (nz_c + 1) / 2 : INF;
          const int32_t c9c = fit9 ? 1 + 3 * db_s + (nz_s + 1) / 2 : INF;
          const int32_t c10c = 4 + 3 * db_c + nz_c;
          int32_t best = (int32_t)segb;  // raw
          if (c1c < best) best = c1c;
          if (c2c < best) best = c2c;
          if (c6c < best) best = c6c;
          if (c3c < best) best = c3c;
          if (c7c < best) best = c7c;
          if (c8c < best) best = c8c;
          if (c9c < best) best = c9c;
          if (c10c < best) best = c10c;
          if (c1c == best) {
            out_cls[seg_i] = 1;
            uint8_t add24[24];  // (-bias) per lane
            for (int ch = 0; ch < 3; ++ch) {
              int16_t b = (int16_t)(cmx[ch] - 1);
              if (b < 0) b = 0;
              if (b > cmn[ch]) b = cmn[ch];
              bias[ch] = (uint8_t)b;
              for (int rep = ch; rep < 24; rep += 3)
                add24[rep] = (uint8_t)(-b);
            }
            uint8_t *o = out_p1 + (size_t)k1 * (segb / 8);
            for (int64_t i = 0; i + 24 <= segb; i += 24, o += 3) {
              uint8_t v[24];
              for (int k = 0; k < 24; ++k)
                v[k] =
                    (uint8_t)((uint8_t)(c[i + k] - p[i + k] + add24[k]) & 1);
              for (int gg = 0; gg < 3; ++gg) {
                const uint8_t *w = v + gg * 8;
                o[gg] = (uint8_t)(w[0] | (uint8_t)(w[1] << 1) |
                                  (uint8_t)(w[2] << 2) | (uint8_t)(w[3] << 3) |
                                  (uint8_t)(w[4] << 4) | (uint8_t)(w[5] << 5) |
                                  (uint8_t)(w[6] << 6) | (uint8_t)(w[7] << 7));
              }
            }
            ++k1;
          } else if (c2c == best) {
            out_cls[seg_i] = 2;
            uint8_t add12[12];  // (2 - bias) per position, period lcm(3, 4)
            for (int ch = 0; ch < 3; ++ch) {
              int16_t b = (int16_t)(cmx[ch] - 1);
              if (b < 0) b = 0;
              if (b > cmn[ch] + 2) b = (int16_t)(cmn[ch] + 2);
              bias[ch] = (uint8_t)b;
              for (int rep = ch; rep < 12; rep += 3)
                add12[rep] = (uint8_t)(2 - b);
            }
            uint8_t *o = out_p2 + (size_t)k2 * (segb / 4);
            for (int64_t i = 0; i + 12 <= segb; i += 12, o += 3) {
              uint8_t v[12];
              for (int k = 0; k < 12; ++k)
                v[k] = (uint8_t)((uint8_t)(c[i + k] - p[i + k] + add12[k]) & 3);
              o[0] = (uint8_t)(v[0] | (uint8_t)(v[1] << 2) |
                               (uint8_t)(v[2] << 4) | (uint8_t)(v[3] << 6));
              o[1] = (uint8_t)(v[4] | (uint8_t)(v[5] << 2) |
                               (uint8_t)(v[6] << 4) | (uint8_t)(v[7] << 6));
              o[2] = (uint8_t)(v[8] | (uint8_t)(v[9] << 2) |
                               (uint8_t)(v[10] << 4) | (uint8_t)(v[11] << 6));
            }
            ++k2;
          } else if (c6c == best) {
            out_cls[seg_i] = 6;
            for (int ch = 0; ch < 3; ++ch)
              bias[ch] = (uint8_t)(((jj[ch] + 64) & 0x7F) |
                                   (off6[ch] ? 0x80 : 0));
            uint8_t *o = out_p2 + (size_t)k2 * (segb / 4);
            for (int64_t i = 0; i + 4 <= segb; i += 4, ++o) {
              uint8_t v4[4];
              for (int k = 0; k < 4; ++k) {
                const int ch = (int)((i + k) % 3);
                v4[k] = (uint8_t)(
                    (uint8_t)((uint8_t)(c[i + k] - lut[ch][p[i + k]]) +
                              off6[ch]) & 3);
              }
              *o = (uint8_t)(v4[0] | (uint8_t)(v4[1] << 2) |
                             (uint8_t)(v4[2] << 4) | (uint8_t)(v4[3] << 6));
            }
            ++k2;
          } else if (c3c == best) {
            out_cls[seg_i] = 3;
            uint8_t add[6];
            for (int ch = 0; ch < 3; ++ch) {
              int16_t b = (int16_t)(cmx[ch] - 3);
              if (b < 0) b = 0;
              if (b > cmn[ch] + 4) b = (int16_t)(cmn[ch] + 4);
              bias[ch] = (uint8_t)b;
              add[ch] = add[ch + 3] = (uint8_t)(4 - b);
            }
            uint8_t *o = out_p3 + (size_t)k3 * (segb * 3 / 8);
            uint8_t v[24];
            for (int64_t i = 0; i + 24 <= segb; i += 24, o += 9) {
              for (int k = 0; k < 24; ++k)
                v[k] =
                    (uint8_t)((uint8_t)(c[i + k] - p[i + k] + add[k % 3]) & 7);
              for (int gg = 0; gg < 3; ++gg) {
                const uint8_t *w = v + gg * 8;
                o[gg * 3 + 0] = (uint8_t)(w[0] | (uint8_t)(w[1] << 3) |
                                          (uint8_t)((w[2] & 3) << 6));
                o[gg * 3 + 1] =
                    (uint8_t)((w[2] >> 2) | (uint8_t)(w[3] << 1) |
                              (uint8_t)(w[4] << 4) | (uint8_t)((w[5] & 1) << 7));
                o[gg * 3 + 2] = (uint8_t)((w[5] >> 1) | (uint8_t)(w[6] << 2) |
                                          (uint8_t)(w[7] << 5));
              }
            }
            ++k3;
          } else if (c7c == best) {
            out_cls[seg_i] = 7;
            for (int ch = 0; ch < 3; ++ch)
              bias[ch] = (uint8_t)(((jj[ch] + 64) & 0x7F) |
                                   (off7[ch] ? 0x80 : 0));
            uint8_t *o = out_p3 + (size_t)k3 * (segb * 3 / 8);
            uint8_t w[24];
            for (int64_t i = 0; i + 24 <= segb; i += 24, o += 9) {
              for (int k = 0; k < 24; ++k) {
                const int ch = k % 3;
                w[k] = (uint8_t)(
                    (uint8_t)((uint8_t)(c[i + k] - lut[ch][p[i + k]]) +
                              off7[ch]) & 7);
              }
              for (int gg = 0; gg < 3; ++gg) {
                const uint8_t *v = w + gg * 8;
                o[gg * 3 + 0] = (uint8_t)(v[0] | (uint8_t)(v[1] << 3) |
                                          (uint8_t)((v[2] & 3) << 6));
                o[gg * 3 + 1] =
                    (uint8_t)((v[2] >> 2) | (uint8_t)(v[3] << 1) |
                              (uint8_t)(v[4] << 4) | (uint8_t)((v[5] & 1) << 7));
                o[gg * 3 + 2] = (uint8_t)((v[5] >> 1) | (uint8_t)(v[6] << 2) |
                                          (uint8_t)(v[7] << 5));
              }
            }
            ++k3;
          } else if (c8c == best) {
            out_cls[seg_i] = 8;
            for (int ch = 0; ch < 3; ++ch) bias[ch] = (uint8_t)biasc[ch];
            uint8_t L = 0;
            uint8_t sm[8][3] = {};
            int ch = 0;
            for (int64_t i = 0; i < segb; ++i) {
              const uint8_t u = (uint8_t)(xv[i] - bx24[ch]);
              if (u) {
                const int sb = (int)(i / 24), bp = (int)(i % 24);
                L |= (uint8_t)(1u << sb);
                sm[sb][bp >> 3] |= (uint8_t)(1u << (bp & 7));
                const uint8_t v = (uint8_t)((uint8_t)(u + 8) & 0xF);
                if (nz4 & 1) out_nib[nz4 >> 1] |= (uint8_t)(v << 4);
                else out_nib[nz4 >> 1] = v;
                ++nz4;
              }
              ch = ch == 2 ? 0 : ch + 1;
            }
            out_m4[k4m] = L;
            for (int sb = 0; sb < (int)(segb / 24); ++sb)
              if (L & (1u << sb)) {
                out_s4[d4 * 3] = sm[sb][0];
                out_s4[d4 * 3 + 1] = sm[sb][1];
                out_s4[d4 * 3 + 2] = sm[sb][2];
                ++d4;
              }
            ++k4m;
          } else if (c9c == best) {
            out_cls[seg_i] = 9;
            for (int ch = 0; ch < 3; ++ch)
              bias[ch] = (uint8_t)jj[ch];  // class-5 convention
            uint8_t L = 0;
            uint8_t sm[8][3] = {};
            int ch = 0;
            for (int64_t i = 0; i < segb; ++i) {
              const uint8_t e = (uint8_t)(c[i] - lut[ch][p[i]]);
              if (e) {
                const int sb = (int)(i / 24), bp = (int)(i % 24);
                L |= (uint8_t)(1u << sb);
                sm[sb][bp >> 3] |= (uint8_t)(1u << (bp & 7));
                const uint8_t v = (uint8_t)((uint8_t)(e + 8) & 0xF);
                if (nz4 & 1) out_nib[nz4 >> 1] |= (uint8_t)(v << 4);
                else out_nib[nz4 >> 1] = v;
                ++nz4;
              }
              ch = ch == 2 ? 0 : ch + 1;
            }
            out_m4[k4m] = L;
            for (int sb = 0; sb < (int)(segb / 24); ++sb)
              if (L & (1u << sb)) {
                out_s4[d4 * 3] = sm[sb][0];
                out_s4[d4 * 3 + 1] = sm[sb][1];
                out_s4[d4 * 3 + 2] = sm[sb][2];
                ++d4;
              }
            ++k4m;
          } else if (c10c == best) {
            out_cls[seg_i] = 10;
            for (int ch = 0; ch < 3; ++ch) bias[ch] = (uint8_t)biasc[ch];
            uint8_t L = 0;
            uint8_t sm[8][3] = {};
            int ch = 0;
            for (int64_t i = 0; i < segb; ++i) {
              const uint8_t u = (uint8_t)(xv[i] - bx24[ch]);
              if (u) {
                const int sb = (int)(i / 24), bp = (int)(i % 24);
                L |= (uint8_t)(1u << sb);
                sm[sb][bp >> 3] |= (uint8_t)(1u << (bp & 7));
                out_byte[nz8++] = u;
              }
              ch = ch == 2 ? 0 : ch + 1;
            }
            out_m8[k10m] = L;
            for (int sb = 0; sb < (int)(segb / 24); ++sb)
              if (L & (1u << sb)) {
                out_s8[d8 * 3] = sm[sb][0];
                out_s8[d8 * 3 + 1] = sm[sb][1];
                out_s8[d8 * 3 + 2] = sm[sb][2];
                ++d8;
              }
            ++k10m;
          } else {
            out_cls[seg_i] = 4;
            bias[0] = bias[1] = bias[2] = 0;
            std::memcpy(out_raw + (size_t)kr * segb, c, (size_t)segb);
            ++kr;
          }
        }
      }
    }
  }
  out_counts[0] = k1;
  out_counts[1] = k2;
  out_counts[2] = k3;
  out_counts[3] = kr;
  out_counts[4] = k4m;
  out_counts[5] = k10m;
  out_counts[6] = nz4;
  out_counts[7] = nz8;
  out_counts[8] = d4;
  out_counts[9] = d8;
  return 1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JPEG decoder
//
// Baseline (SOF0), extended 8-bit (SOF1) and progressive (SOF2) Huffman JPEG
// with 1 or 3 components, integral sampling factors and restart intervals.
// Each stage repeats libjpeg-turbo's default decompression, so the output is
// the bytes cv2.imread gives:
//   * the islow integer IDCT of jidctint.c (13-bit constants, CONST_BITS and
//     PASS1_BITS descaling, its zero-AC shortcuts and range-limit table);
//   * the fancy upsamplers of jdsample.c: the triangle filters of h2v1, h1v2
//     and h2v2 with their +1/+2 and +8/+7 biases and edge columns, the first
//     and last sample rows repeated above and below; plain replication for
//     other integral factors and for h2 planes at most 2 samples wide;
//   * the fixed-point YCbCr->RGB tables of jdcolor.c; RGB files (Adobe
//     transform 0, or component ids 'R','G','B') are copied; grayscale gives
//     three equal channels.
// Coefficients of every scan are kept until the end, so baseline and
// progressive files share the IDCT and output stages. A complete progressive
// file needs no block smoothing (libjpeg-turbo smooths only while bits of the
// first 10 coefficients are missing); an incomplete one raises. So do the
// streams libjpeg only warns about: data that ends early, a bad Huffman
// code, a missing restart marker, a bogus progression.

namespace jpeg {

struct Error {
  std::string msg;
};

[[noreturn]] static void fail(const std::string& msg) { throw Error{msg}; }

// zigzag position -> natural (row-major) position
static const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// The tables of Annex K.3, which libjpeg-turbo loads into DC/AC slots 0 and
// 1 when a file defines none there (motion-JPEG frames leave them out).
static const uint8_t kStdDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
static const uint8_t kStdDcChrBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
static const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t kStdAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
static const uint8_t kStdAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
static const uint8_t kStdAcChrBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
static const uint8_t kStdAcChrVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

constexpr int kLookBits = 9;

// A Huffman table as jdhuff.c's jpeg_make_d_derived_tbl derives it: codes up
// to kLookBits long from one lookup, longer ones through maxcode.
struct Huff {
  bool defined = false;
  uint8_t vals[256] = {0};
  int32_t maxcode[18] = {0};
  int32_t valoffset[18] = {0};
  uint16_t look[1 << kLookBits] = {0};  // (length << 8) | symbol; 0: longer

  void build(const uint8_t* bits, const uint8_t* symbols, int count, bool is_dc) {
    int sizes[257];
    uint32_t codes[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < bits[l]; ++i) sizes[p++] = l;
    sizes[p] = 0;
    uint32_t code = 0;
    int si = sizes[0];
    p = 0;
    while (sizes[p]) {
      while (sizes[p] == si) codes[p++] = code++;
      if (code >= (1u << si)) fail("bad Huffman table");
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - (int32_t)codes[p];
        p += bits[l];
        maxcode[l] = (int32_t)codes[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0xFFFFF;
    std::memset(look, 0, sizeof(look));
    for (int i = 0; i < count; ++i) {
      vals[i] = symbols[i];
      if (is_dc && symbols[i] > 15) fail("bad Huffman table (a DC symbol above 15)");
      if (sizes[i] <= kLookBits) {
        int shift = kLookBits - sizes[i];
        uint32_t first = codes[i] << shift;
        for (uint32_t j = 0; j < (1u << shift); ++j)
          look[first + j] = (uint16_t)((sizes[i] << 8) | symbols[i]);
      }
    }
    defined = true;
  }
};

// Entropy-coded data: 0xFF 0x00 is a data byte 0xFF, a marker ends the data.
// Past a marker or the end of the file the reader feeds zero bits, as libjpeg
// does; taking any of them marks the stream as cut short (`overrun`).
struct Bits {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t acc = 0;
  int n = 0;     // bits in acc, from the top
  int fake = 0;  // of which the last ones are zero fill
  bool marker = false;
  bool overrun = false;

  void reset(const uint8_t* begin, const uint8_t* stop) {
    p = begin;
    end = stop;
    acc = 0;
    n = fake = 0;
    marker = overrun = false;
  }

  void fill() {
    while (n <= 56) {
      uint64_t b = 0;
      bool real = false;
      if (!marker && p < end) {
        if (*p != 0xFF) {
          b = *p++;
          real = true;
        } else {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;  // fill bytes
          if (q < end && *q == 0x00) {
            b = 0xFF;
            p = q + 1;
            real = true;
          } else {
            marker = true;  // p stays on the marker's first 0xFF
          }
        }
      }
      if (!real) fake += 8;
      acc |= b << (56 - n);
      n += 8;
    }
  }

  inline void skip(int k) {
    if (k > n - fake) overrun = true;
    acc <<= k;
    n -= k;
    if (fake > n) fake = n;
  }

  inline int get(int k) {  // k in 0..16
    if (k == 0) return 0;
    if (n < k) fill();
    int v = (int)(acc >> (64 - k));
    skip(k);
    return v;
  }

  inline int decode(const Huff& t) {
    if (n < 16) fill();
    int v = t.look[acc >> (64 - kLookBits)];
    if (v) {
      skip(v >> 8);
      return v & 0xFF;
    }
    int l = kLookBits + 1;
    int32_t code = (int32_t)(acc >> (64 - l));
    while (l <= 16 && code > t.maxcode[l]) {
      ++l;
      code = (int32_t)(acc >> (64 - l));
    }
    if (l > 16) fail("corrupt entropy-coded data (a bad Huffman code)");
    skip(l);
    return t.vals[code + t.valoffset[l]];
  }

  // Where reading may resume: the marker that ended the data, or the first
  // byte not yet taken into the bit buffer.
  const uint8_t* resume() const { return p; }
};

static inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r; }

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc = 0, ac = 0;    // table slots of the current scan
  int wib = 0, hib = 0;  // blocks that hold image samples
  int bw = 0, bh = 0;    // blocks in the MCU-padded buffer
  int dw = 0, dh = 0;    // image samples of the component
  bool latched = false;
  bool scanned = false;
  uint16_t q[64] = {0};  // natural order, latched at the component's first scan
  int coef_bits[64];
  int32_t pred = 0;
  std::vector<int16_t> coef;  // bh * bw blocks of 64 coefficients, natural order
};

// jdmaster.c's post-IDCT range-limit table, indexed by (value & 1023): -128..127
// map to 0..255, larger values to 255, smaller to 0 (wrapping past +-512).
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int x = 0; x < 1024; ++x)
      t[x] = (uint8_t)(x < 128 ? 128 + x : x < 512 ? 255 : x < 896 ? 0 : x - 896);
  }
};

static const uint8_t* idct_range() {
  static const RangeLimit table;  // initialised once, thread-safe
  return table.t;
}

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

static inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// jidctint.c's jpeg_idct_islow: dequantize, columns then rows.
static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride,
                       const uint8_t* range) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* col = in + c;
    const uint16_t* qc = q + c;
    int* w = ws + c;
    if (col[8] == 0 && col[16] == 0 && col[24] == 0 && col[32] == 0 && col[40] == 0 &&
        col[48] == 0 && col[56] == 0) {
      int dc = (int)((int64_t)col[0] * qc[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) w[r * 8] = dc;
      continue;
    }
    int64_t z2 = (int64_t)col[16] * qc[16], z3 = (int64_t)col[48] * qc[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)col[0] * qc[0];
    z3 = (int64_t)col[32] * qc[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)col[56] * qc[56];
    tmp1 = (int64_t)col[40] * qc[40];
    tmp2 = (int64_t)col[24] * qc[24];
    tmp3 = (int64_t)col[8] * qc[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    w[0] = (int)descale(tmp10 + tmp3, sh);
    w[56] = (int)descale(tmp10 - tmp3, sh);
    w[8] = (int)descale(tmp11 + tmp2, sh);
    w[48] = (int)descale(tmp11 - tmp2, sh);
    w[16] = (int)descale(tmp12 + tmp1, sh);
    w[40] = (int)descale(tmp12 - tmp1, sh);
    w[24] = (int)descale(tmp13 + tmp0, sh);
    w[32] = (int)descale(tmp13 - tmp0, sh);
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + (size_t)r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 && w[7] == 0) {
      uint8_t dc = range[(int)descale(w[0], kPass1Bits + 3) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << kConstBits);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = range[(int)descale(tmp10 + tmp3, sh) & 1023];
    o[7] = range[(int)descale(tmp10 - tmp3, sh) & 1023];
    o[1] = range[(int)descale(tmp11 + tmp2, sh) & 1023];
    o[6] = range[(int)descale(tmp11 - tmp2, sh) & 1023];
    o[2] = range[(int)descale(tmp12 + tmp1, sh) & 1023];
    o[5] = range[(int)descale(tmp12 - tmp1, sh) & 1023];
    o[3] = range[(int)descale(tmp13 + tmp0, sh) & 1023];
    o[4] = range[(int)descale(tmp13 - tmp0, sh) & 1023];
  }
}

struct Decoder {
  const uint8_t* data;
  size_t len;
  size_t pos = 0;
  uint16_t qt[4][64] = {{0}};
  bool qt_defined[4] = {false, false, false, false};
  Huff dc_tab[4], ac_tab[4];
  bool have_frame = false, progressive = false;
  int width = 0, height = 0, ncomp = 0;
  Comp comp[3];
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  int scans = 0;
  int64_t app1_pos = -1, app1_len = 0;  // the first APP1 segment's body

  Decoder(const uint8_t* d, size_t n) : data(d), len(n) {
    dc_tab[0].build(kStdDcLumBits, kStdDcVals, 12, true);
    dc_tab[1].build(kStdDcChrBits, kStdDcVals, 12, true);
    ac_tab[0].build(kStdAcLumBits, kStdAcLumVals, 162, false);
    ac_tab[1].build(kStdAcChrBits, kStdAcChrVals, 162, false);
  }

  int u8(size_t end) {
    if (pos >= end) fail("truncated marker segment");
    return data[pos++];
  }
  int u16(size_t end) {
    int a = u8(end);
    return (a << 8) | u8(end);
  }

  // The next marker code at or after pos (skipping stray bytes, as libjpeg
  // does), or -1 at the end of the data.
  int next_marker() {
    for (;;) {
      while (pos < len && data[pos] != 0xFF) ++pos;
      while (pos < len && data[pos] == 0xFF) ++pos;
      if (pos >= len) return -1;
      int m = data[pos++];
      if (m != 0) return m;
    }
  }

  void read_sof(int m, size_t end) {
    if (have_frame) fail("a second frame header");
    int precision = u8(end);
    height = u16(end);
    width = u16(end);
    ncomp = u8(end);
    if (precision != 8)
      fail(std::to_string(precision) + "-bit samples (only 8-bit JPEG is read)");
    if (height == 0) fail("image height 0 (a DNL marker is not supported)");
    if (width == 0) fail("image width 0");
    if (ncomp == 4) fail("4 components (CMYK or YCCK)");
    if (ncomp != 1 && ncomp != 3) fail(std::to_string(ncomp) + " components");
    for (int i = 0; i < ncomp; ++i) {
      Comp& c = comp[i];
      c.id = u8(end);
      int hv = u8(end);
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8(end);
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("bad sampling factors");
      if (c.tq > 3) fail("bad quantization table index");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    progressive = m == 0xC2;
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Comp& c = comp[i];
      if (hmax % c.h || vmax % c.v) fail("fractional sampling factors");
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.wib = (c.dw + 7) / 8;
      c.hib = (c.dh + 7) / 8;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    }
    have_frame = true;
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      int pq_tq = u8(end);
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("bad quantization table");
      for (int i = 0; i < 64; ++i) qt[tq][kNatural[i]] = (uint16_t)(pq ? u16(end) : u8(end));
      qt_defined[tq] = true;
    }
  }

  void read_dht(size_t end) {
    while (pos < end) {
      int tc_th = u8(end);
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad Huffman table index");
      uint8_t bits[17] = {0};
      int count = 0;
      for (int l = 1; l <= 16; ++l) count += bits[l] = (uint8_t)u8(end);
      if (count > 256) fail("bad Huffman table (more than 256 codes)");
      uint8_t symbols[256];
      for (int i = 0; i < count; ++i) symbols[i] = (uint8_t)u8(end);
      (tc ? ac_tab : dc_tab)[th].build(bits, symbols, count, tc == 0);
    }
  }

  void read_sos(size_t end) {
    if (!have_frame) fail("a scan before the frame header");
    int ns = u8(end);
    if (ns < 1 || ns > ncomp) fail("bad component count in a scan");
    Comp* sc[3];
    for (int i = 0; i < ns; ++i) {
      int id = u8(end), tables = u8(end);
      Comp* c = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) c = &comp[j];
      if (c == nullptr) fail("a scan names an unknown component");
      for (int j = 0; j < i; ++j)
        if (sc[j] == c) fail("a scan names a component twice");
      c->dc = tables >> 4;
      c->ac = tables & 15;
      if (c->dc > 3 || c->ac > 3) fail("bad Huffman table index in a scan");
      sc[i] = c;
    }
    int ss = u8(end), se = u8(end), a = u8(end);
    int ah = a >> 4, al = a & 15;
    pos = end;
    if (progressive) {
      bool bad = ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      for (int i = 0; i < ns && !bad; ++i) {
        int* bits = sc[i]->coef_bits;
        if (ss > 0 && bits[0] < 0) bad = true;  // AC before DC
        for (int k = ss; k <= se; ++k) {
          if (ah != (bits[k] < 0 ? 0 : bits[k])) bad = true;
          bits[k] = al;
        }
      }
      if (bad) fail("bad progressive scan parameters");
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
      fail("bad sequential scan parameters");
    }
    int blocks = 0;
    for (int i = 0; i < ns; ++i) {
      Comp& c = *sc[i];
      blocks += c.h * c.v;
      if (!c.latched) {
        if (!qt_defined[c.tq]) fail("a quantization table is missing");
        std::memcpy(c.q, qt[c.tq], sizeof(c.q));
        c.latched = true;
      }
      bool need_dc = !progressive || (ss == 0 && ah == 0);
      bool need_ac = !progressive || ss > 0;
      if ((need_dc && !dc_tab[c.dc].defined) || (need_ac && !ac_tab[c.ac].defined))
        fail("a Huffman table is missing");
      c.scanned = true;
    }
    if (ns > 1 && blocks > 10) fail("too many blocks in an MCU");
    decode_scan(sc, ns, ss, se, ah, al);
    ++scans;
  }

  void block_seq(Bits& br, Comp& c, int16_t* blk) {
    int s = br.decode(dc_tab[c.dc]);
    c.pred += s ? extend(br.get(s), s) : 0;
    blk[0] = (int16_t)c.pred;
    const Huff& act = ac_tab[c.ac];
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt entropy-coded data (a coefficient past 63)");
        blk[kNatural[k]] = (int16_t)extend(br.get(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void block_dc_first(Bits& br, Comp& c, int16_t* blk, int al) {
    int s = br.decode(dc_tab[c.dc]);
    c.pred += s ? extend(br.get(s), s) : 0;
    blk[0] = (int16_t)((uint32_t)c.pred << al);
  }

  void block_ac_first(Bits& br, Comp& c, int16_t* blk, int ss, int se, int al, int& eobrun) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const Huff& act = ac_tab[c.ac];
    for (int k = ss; k <= se; ++k) {
      int rs = br.decode(act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > se) fail("corrupt entropy-coded data (a coefficient past the band)");
        blk[kNatural[k]] = (int16_t)((uint32_t)extend(br.get(s), s) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        --eobrun;
        break;
      }
    }
  }

  void block_ac_refine(Bits& br, Comp& c, int16_t* blk, int ss, int se, int al, int& eobrun) {
    const int p1 = 1 << al, m1 = -p1;
    int k = ss;
    if (eobrun == 0) {
      const Huff& act = ac_tab[c.ac];
      for (; k <= se; ++k) {
        int rs = br.decode(act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) fail("corrupt entropy-coded data (a bad refinement code)");
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        // skip r zero coefficients, appending a correction bit to each
        // nonzero one passed on the way
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.get(1) && (*coef & p1) == 0) *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) {
          if (k > se) fail("corrupt entropy-coded data (a coefficient past the band)");
          blk[kNatural[k]] = (int16_t)s;
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && br.get(1) && (*coef & p1) == 0)
          *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
      }
      --eobrun;
    }
  }

  void decode_scan(Comp** sc, int ns, int ss, int se, int ah, int al) {
    Bits br;
    br.reset(data + pos, data + len);
    for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
    int eobrun = 0, next_rst = 0;
    int64_t cols = ns == 1 ? sc[0]->wib : mcux;
    int64_t rows = ns == 1 ? sc[0]->hib : mcuy;
    int64_t total = cols * rows;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        pos = (size_t)(br.resume() - data);
        if (next_marker() != 0xD0 + next_rst)
          fail("a restart marker is missing or out of order");
        next_rst = (next_rst + 1) & 7;
        br.reset(data + pos, data + len);
        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
        eobrun = 0;
      }
      int64_t mx = m % cols, my = m / cols;
      for (int i = 0; i < ns; ++i) {
        Comp& c = *sc[i];
        int nv = ns == 1 ? 1 : c.v, nh = ns == 1 ? 1 : c.h;
        for (int v = 0; v < nv; ++v) {
          for (int h = 0; h < nh; ++h) {
            int64_t by = my * nv + v, bx = mx * nh + h;
            int16_t* blk = c.coef.data() + (by * c.bw + bx) * 64;
            if (!progressive) {
              block_seq(br, c, blk);
            } else if (ss == 0) {
              if (ah == 0)
                block_dc_first(br, c, blk, al);
              else if (br.get(1))
                blk[0] = (int16_t)(blk[0] | (1 << al));
            } else if (ah == 0) {
              block_ac_first(br, c, blk, ss, se, al, eobrun);
            } else {
              block_ac_refine(br, c, blk, ss, se, al, eobrun);
            }
          }
        }
      }
      if (br.overrun) fail("the entropy-coded data ends early (truncated or corrupt file)");
    }
    pos = (size_t)(br.resume() - data);
  }

  // Read the markers and decode every scan; with header_only, stop at the
  // first scan (the frame size and APP1 are known by then).
  void parse(bool header_only = false) {
    if (len < 3 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m < 0 || m == 0xD9) break;  // the end of the data, or EOI
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // RSTn, TEM: no length
      if (m == 0xD8) fail("a second SOI marker");
      size_t seg = pos;
      pos = seg + 2;
      if (seg + 2 > len) fail("truncated marker segment");
      size_t length = ((size_t)data[seg] << 8) | data[seg + 1];
      if (length < 2 || seg + length > len) fail("truncated marker segment");
      size_t end = seg + length;
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          read_sof(m, end);
          break;
        case 0xC3:
        case 0xC7:
          fail("lossless JPEG (SOF" + std::to_string(m - 0xC0) + ")");
        case 0xC5:
        case 0xC6:
        case 0xDE:
        case 0xDF:
          fail("hierarchical JPEG");
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
        case 0xCC:
          fail("arithmetic coding");
        case 0xC4:
          read_dht(end);
          break;
        case 0xDB:
          read_dqt(end);
          break;
        case 0xDD:
          restart_interval = u16(end);
          break;
        case 0xDC:
          fail("a DNL marker is not supported");
        case 0xDA:
          if (header_only) {
            if (!have_frame) fail("no frame header before the first scan");
            return;
          }
          read_sos(end);
          continue;  // pos is past the scan's data
        case 0xE0:
          if (length >= 16 && std::memcmp(data + seg + 2, "JFIF\0", 5) == 0) jfif = true;
          break;
        case 0xE1:
          if (app1_pos < 0) {
            app1_pos = (int64_t)seg + 2;
            app1_len = (int64_t)length - 2;
          }
          break;
        case 0xEE:
          if (length >= 14 && std::memcmp(data + seg + 2, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = data[seg + 2 + 11];
          }
          break;
        default:
          if (!((m >= 0xE0 && m <= 0xEF) || m == 0xFE))
          {
            char hex[8];
            std::snprintf(hex, sizeof(hex), "%02X", m);
            fail(std::string("an unknown marker 0xFF") + hex);
          }
      }
      pos = end;
    }
    if (!have_frame) fail("no frame header");
    if (header_only) return;
    if (scans == 0) fail("no scan");
    for (int i = 0; i < ncomp; ++i) {
      if (!comp[i].scanned) fail("a component has no scan");
      if (progressive)
        for (int k = 0; k < 10; ++k)
          if (comp[i].coef_bits[k] != 0)
            fail("an incomplete progressive JPEG (coefficient bits are missing)");
    }
  }

  // jdcolor.c's YCbCr->RGB colour space choice for three components
  bool rgb_file() const {
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;  // 'R', 'G', 'B'
  }

  // The IDCT of every block that holds image samples, into a plane of
  // wib*8 x hib*8 samples.
  std::vector<uint8_t> plane(const Comp& c) const {
    const uint8_t* range = idct_range();
    size_t stride = (size_t)c.wib * 8;
    std::vector<uint8_t> out(stride * c.hib * 8);
    for (int by = 0; by < c.hib; ++by)
      for (int bx = 0; bx < c.wib; ++bx)
        idct_islow(c.coef.data() + ((size_t)by * c.bw + bx) * 64, c.q,
                   out.data() + (size_t)by * 8 * stride + (size_t)bx * 8, (int)stride, range);
    return out;
  }

  // One full-resolution output row of a component (jdsample.c).
  void upsample_row(const Comp& c, const std::vector<uint8_t>& pl, int y, uint8_t* out,
                    std::vector<int>& colsum, std::vector<uint8_t>& tmp) const {
    const int fh = hmax / c.h, fv = vmax / c.v;
    const size_t stride = (size_t)c.wib * 8;
    const int w = width, dw = c.dw;
    if (fh == 1 && fv == 1) {
      std::memcpy(out, pl.data() + (size_t)y * stride, (size_t)w);
      return;
    }
    const bool fancy = (fh == 2 && (fv == 1 || fv == 2) && dw > 2) || (fh == 1 && fv == 2);
    if (!fancy) {
      const uint8_t* in = pl.data() + (size_t)(y / fv) * stride;
      for (int x = 0; x < w; ++x) out[x] = in[x / fh];
      return;
    }
    if (fv == 1) {  // h2v1: 3/4 nearer + 1/4 further sample
      const uint8_t* in = pl.data() + (size_t)y * stride;
      tmp.resize((size_t)dw * 2);
      tmp[0] = in[0];
      tmp[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; ++i) {
        int v = in[i] * 3;
        tmp[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
        tmp[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
      }
      tmp[2 * dw - 2] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
      tmp[2 * dw - 1] = in[dw - 1];
      std::memcpy(out, tmp.data(), (size_t)w);
      return;
    }
    // vertical pair: the nearer input row and the one above (even output
    // rows) or below (odd ones), the edge rows repeated
    const int iy = y / 2;
    const int fy = (y & 1) ? std::min(iy + 1, c.dh - 1) : std::max(iy - 1, 0);
    const uint8_t* in0 = pl.data() + (size_t)iy * stride;
    const uint8_t* in1 = pl.data() + (size_t)fy * stride;
    if (fh == 1) {  // h1v2
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < w; ++x) out[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
      return;
    }
    colsum.resize((size_t)dw);  // h2v2
    for (int i = 0; i < dw; ++i) colsum[i] = in0[i] * 3 + in1[i];
    tmp.resize((size_t)dw * 2);
    tmp[0] = (uint8_t)((colsum[0] * 4 + 8) >> 4);
    tmp[1] = (uint8_t)((colsum[0] * 3 + colsum[1] + 7) >> 4);
    for (int i = 1; i < dw - 1; ++i) {
      tmp[2 * i] = (uint8_t)((colsum[i] * 3 + colsum[i - 1] + 8) >> 4);
      tmp[2 * i + 1] = (uint8_t)((colsum[i] * 3 + colsum[i + 1] + 7) >> 4);
    }
    tmp[2 * dw - 2] = (uint8_t)((colsum[dw - 1] * 3 + colsum[dw - 2] + 8) >> 4);
    tmp[2 * dw - 1] = (uint8_t)((colsum[dw - 1] * 4 + 7) >> 4);
    std::memcpy(out, tmp.data(), (size_t)w);
  }

  void output(uint8_t* bgr) const {
    std::vector<uint8_t> planes[3];
    for (int i = 0; i < ncomp; ++i) planes[i] = plane(comp[i]);
    std::vector<uint8_t> rows((size_t)ncomp * width);
    std::vector<int> colsum;
    std::vector<uint8_t> tmp;
    const bool rgb = ncomp == 3 && rgb_file();
    // jdcolor.c's build_ycc_rgb_table: SCALEBITS 16, FIX(x) rounded
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    const int64_t half = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (int y = 0; y < height; ++y) {
      for (int i = 0; i < ncomp; ++i)
        upsample_row(comp[i], planes[i], y, rows.data() + (size_t)i * width, colsum, tmp);
      uint8_t* o = bgr + (size_t)y * width * 3;
      const uint8_t* c0 = rows.data();
      if (ncomp == 1) {
        for (int x = 0; x < width; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = c0[x];
        continue;
      }
      const uint8_t* c1 = c0 + width;
      const uint8_t* c2 = c1 + width;
      for (int x = 0; x < width; ++x) {
        if (rgb) {
          o[3 * x] = c2[x];
          o[3 * x + 1] = c1[x];
          o[3 * x + 2] = c0[x];
          continue;
        }
        int yy = c0[x], cb = c1[x], cr = c2[x];
        o[3 * x] = clamp(yy + cb_b[cb]);
        o[3 * x + 1] = clamp(yy + (int)((cb_g[cb] + cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp(yy + cr_r[cr]);
      }
    }
  }
};

}  // namespace jpeg

// ---------------------------------------------------------------------------
// JPEG encoder
//
// libjpeg-turbo's default compression, as cv2.imencode(".jpg", img,
// [IMWRITE_JPEG_QUALITY, q]) runs it, so the output is cv2's bytes: SOI, a
// JFIF 1.1 APP0 (no density, no thumbnail), one DQT per table, SOF0, the
// Annex K Huffman tables as they are first used (DC then AC of each table
// slot), SOS, the entropy-coded data, EOI; no restart markers, no
// optimisation. BGR input gives 4:2:0 YCbCr (component ids 1, 2, 3; Y 2x2,
// Cb and Cr 1x1), gray input one component. The stages:
//   * jcparam.c's quality scaling of the Annex K.1 tables, limited to 255;
//   * jccolor.c's 16-bit fixed-point RGB->YCbCr tables (Cb and Cr rounded
//     by 0.5 - epsilon);
//   * edge replication to whole blocks (jcprepct.c, jcsample.c), and
//     jcsample.c's h2v2 downsampling with its 1, 2, 1, 2 bias;
//   * jfdctint.c's islow forward DCT (13-bit constants, PASS1_BITS 2);
//   * jcdctmgr.c's quantisation by a reciprocal multiply (compute_reciprocal);
//   * jccoefct.c's dummy blocks at the right and bottom of the last MCUs
//     (zero AC, the DC of the block before);
//   * jchuff.c's sequential Huffman coding, 0xFF bytes stuffed, the last
//     byte padded with ones.

namespace jpeg {

// jcparam.c's std_luminance_quant_tbl and std_chrominance_quant_tbl
// (Annex K.1), in natural order.
static const uint8_t kStdLumQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
static const uint8_t kStdChrQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jpeg_quality_scaling + jpeg_add_quant_table with force_baseline.
static void scale_quant(const uint8_t* basic, int quality, uint16_t* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = ((long)basic[i] * scale + 50L) / 100L;
    out[i] = (uint16_t)std::min(std::max(t, 1L), 255L);
  }
}

// compute_reciprocal for the 16-bit DCTELEM of a SIMD build: the quotient
// of (|x| + corr) * recip >> shift rounds |x| / divisor as libjpeg-turbo does.
struct Divisor {
  uint32_t recip, corr, shift;
};

static Divisor reciprocal(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  uint64_t fq = ((uint64_t)1 << r) / divisor, fr = ((uint64_t)1 << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {  // a power of two: fq needs one bit too many
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2) {
    c++;
  } else {
    fq++;
  }
  return Divisor{(uint32_t)fq, c, (uint32_t)r};
}

// jfdctint.c's jpeg_fdct_islow: rows, then columns; the output is scaled up by 8.
static void fdct_islow(int32_t* d) {
  constexpr int kConst = 13, kPass1 = 2;
  auto descale = [](int64_t x, int n) { return (int32_t)((x + ((int64_t)1 << (n - 1))) >> n); };
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass ? 8 : 1, next = pass ? 1 : 8;
    const int shift_odd = pass ? kConst + kPass1 : kConst - kPass1;
    for (int ctr = 0; ctr < 8; ++ctr) {
      int32_t* p = d + ctr * next;
      int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass) {
        p[0] = descale(tmp10 + tmp11, kPass1);
        p[4 * step] = descale(tmp10 - tmp11, kPass1);
      } else {
        p[0] = (int32_t)((tmp10 + tmp11) * (1 << kPass1));
        p[4 * step] = (int32_t)((tmp10 - tmp11) * (1 << kPass1));
      }
      int64_t z1 = (tmp12 + tmp13) * 4433;
      p[2 * step] = descale(z1 + tmp13 * 6270, shift_odd);
      p[6 * step] = descale(z1 + tmp12 * -15137, shift_odd);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * 9633;
      tmp4 *= 2446;
      tmp5 *= 16819;
      tmp6 *= 25172;
      tmp7 *= 12299;
      z1 *= -7373;
      z2 *= -20995;
      z3 *= -16069;
      z4 *= -3196;
      z3 += z5;
      z4 += z5;
      p[7 * step] = descale(tmp4 + z1 + z3, shift_odd);
      p[5 * step] = descale(tmp5 + z2 + z4, shift_odd);
      p[3 * step] = descale(tmp6 + z2 + z3, shift_odd);
      p[step] = descale(tmp7 + z1 + z4, shift_odd);
    }
  }
}

// jchuff.c's jpeg_make_c_derived_tbl: canonical codes from an Annex K table.
struct HuffCode {
  uint16_t code[256] = {0};
  uint8_t size[256] = {0};
};

static HuffCode derive(const uint8_t* bits) {
  const uint8_t* vals = bits + 17;
  HuffCode t;
  uint32_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len]; ++i, ++k) {
      t.code[vals[k]] = (uint16_t)code++;
      t.size[vals[k]] = (uint8_t)len;
    }
    code <<= 1;
  }
  return t;
}

struct Plane {
  int w = 0, h = 0;  // padded to whole blocks
  std::vector<uint8_t> px;
  uint8_t at(int y, int x) const { return px[(size_t)y * w + x]; }
};

class Encoder {
 public:
  Encoder(const uint8_t* img, int height, int width, int channels, int quality)
      : img_(img), h_(height), w_(width), nc_(channels) {
    scale_quant(kStdLumQuant, quality, q_[0]);
    scale_quant(kStdChrQuant, quality, q_[1]);
    for (int t = 0; t < 2; ++t)
      for (int i = 0; i < 64; ++i) div_[t][i] = reciprocal((uint32_t)q_[t][i] << 3);
    uint8_t table[17 + 256];
    auto load = [&](const uint8_t* bits, const uint8_t* vals, int n) {
      std::memcpy(table, bits, 17);
      std::memcpy(table + 17, vals, n);
      return derive(table);
    };
    dc_[0] = load(kStdDcLumBits, kStdDcVals, 12);
    dc_[1] = load(kStdDcChrBits, kStdDcVals, 12);
    ac_[0] = load(kStdAcLumBits, kStdAcLumVals, 162);
    ac_[1] = load(kStdAcChrBits, kStdAcChrVals, 162);
  }

  std::vector<uint8_t> run() {
    out_.reserve((size_t)h_ * w_ * nc_ / 4 + 1024);
    headers();
    if (nc_ == 1) {
      gray_scan();
    } else {
      color_scan();
    }
    flush();
    put16(0xFFD9);
    return std::move(out_);
  }

 private:
  const uint8_t* img_;
  int h_, w_, nc_;
  uint16_t q_[2][64];
  Divisor div_[2][64];
  HuffCode dc_[2], ac_[2];
  std::vector<uint8_t> out_;
  uint64_t bitbuf_ = 0;
  int nbits_ = 0;
  int last_dc_[3] = {0, 0, 0};

  void put16(int v) {
    out_.push_back((uint8_t)(v >> 8));
    out_.push_back((uint8_t)v);
  }

  void headers() {
    static const uint8_t kApp0[] = {0xFF, 0xD8, 0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0,
                                    1, 1, 0, 0, 1, 0, 1, 0, 0};
    out_.insert(out_.end(), kApp0, kApp0 + sizeof(kApp0));
    const int ntables = nc_ == 1 ? 1 : 2;
    for (int t = 0; t < ntables; ++t) {
      put16(0xFFDB);
      put16(67);
      out_.push_back((uint8_t)t);
      for (int i = 0; i < 64; ++i) out_.push_back((uint8_t)q_[t][kNatural[i]]);
    }
    put16(0xFFC0);
    put16(8 + 3 * nc_);
    out_.push_back(8);
    put16(h_);
    put16(w_);
    out_.push_back((uint8_t)nc_);
    for (int c = 0; c < nc_; ++c) {
      out_.push_back((uint8_t)(c + 1));
      out_.push_back(nc_ == 1 ? 0x11 : (c == 0 ? 0x22 : 0x11));
      out_.push_back(c == 0 ? 0 : 1);
    }
    for (int t = 0; t < ntables; ++t) {
      dht(t, t ? kStdDcChrBits : kStdDcLumBits, kStdDcVals);
      dht(0x10 | t, t ? kStdAcChrBits : kStdAcLumBits, t ? kStdAcChrVals : kStdAcLumVals);
    }
    put16(0xFFDA);
    put16(6 + 2 * nc_);
    out_.push_back((uint8_t)nc_);
    for (int c = 0; c < nc_; ++c) {
      out_.push_back((uint8_t)(c + 1));
      out_.push_back(c == 0 ? 0x00 : 0x11);
    }
    out_.push_back(0);
    out_.push_back(63);
    out_.push_back(0);
  }

  void dht(int index, const uint8_t* bits, const uint8_t* vals) {
    int n = 0;
    for (int i = 1; i <= 16; ++i) n += bits[i];
    put16(0xFFC4);
    put16(2 + 1 + 16 + n);
    out_.push_back((uint8_t)index);
    out_.insert(out_.end(), bits + 1, bits + 17);
    out_.insert(out_.end(), vals, vals + n);
  }

  void emit(uint32_t code, int size) {
    bitbuf_ = (bitbuf_ << size) | (code & ((1u << size) - 1));
    nbits_ += size;
    while (nbits_ >= 8) {
      nbits_ -= 8;
      uint8_t b = (uint8_t)(bitbuf_ >> nbits_);
      out_.push_back(b);
      if (b == 0xFF) out_.push_back(0);
    }
    bitbuf_ &= ((uint64_t)1 << nbits_) - 1;
  }

  void flush() {
    if (nbits_) emit(0x7F, 8 - nbits_);  // the partial byte filled with ones
  }

  // Edge-replicated copy of the (rows, cols) plane `src` (stride src_w) grown to (h, w).
  static Plane padded(const std::vector<uint8_t>& src, int rows, int cols, int h, int w) {
    Plane p;
    p.h = h;
    p.w = w;
    p.px.resize((size_t)h * w);
    for (int y = 0; y < h; ++y) {
      const uint8_t* s = src.data() + (size_t)std::min(y, rows - 1) * cols;
      uint8_t* d = p.px.data() + (size_t)y * w;
      std::memcpy(d, s, cols);
      std::memset(d + cols, s[cols - 1], w - cols);
    }
    return p;
  }

  // forward_DCT of the block at block row by, column bx, then quantize.
  void block(const Plane& p, int by, int bx, int table, int16_t* coef) const {
    int32_t ws[64];
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x) ws[y * 8 + x] = (int32_t)p.at(by * 8 + y, bx * 8 + x) - 128;
    fdct_islow(ws);
    for (int i = 0; i < 64; ++i) {
      const Divisor& dv = div_[table][i];
      int32_t v = ws[i];
      uint32_t a = (uint32_t)(v < 0 ? -v : v);
      int32_t q = (int32_t)(((uint64_t)(a + dv.corr) * dv.recip) >> dv.shift);
      coef[i] = (int16_t)(v < 0 ? -q : q);
    }
  }

  // jchuff.c's encode_one_block.
  void encode(const int16_t* coef, int comp, int table) {
    int temp = coef[0] - last_dc_[comp], temp2 = temp;
    last_dc_[comp] = coef[0];
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    int nbits = 0;
    while (temp) {
      nbits++;
      temp >>= 1;
    }
    emit(dc_[table].code[nbits], dc_[table].size[nbits]);
    if (nbits) emit((uint32_t)temp2, nbits);
    int r = 0;
    for (int k = 1; k < 64; ++k) {
      temp = coef[kNatural[k]];
      if (temp == 0) {
        r++;
        continue;
      }
      while (r > 15) {
        emit(ac_[table].code[0xF0], ac_[table].size[0xF0]);
        r -= 16;
      }
      temp2 = temp;
      if (temp < 0) {
        temp = -temp;
        temp2--;
      }
      nbits = 1;
      while ((temp >>= 1)) nbits++;
      const int sym = (r << 4) + nbits;
      emit(ac_[table].code[sym], ac_[table].size[sym]);
      emit((uint32_t)temp2, nbits);
      r = 0;
    }
    if (r > 0) emit(ac_[table].code[0], ac_[table].size[0]);
  }

  void gray_scan() {
    const int bw = (w_ + 7) / 8, bh = (h_ + 7) / 8;
    std::vector<uint8_t> src(img_, img_ + (size_t)h_ * w_);
    Plane p = padded(src, h_, w_, bh * 8, bw * 8);
    int16_t coef[64];
    for (int by = 0; by < bh; ++by)
      for (int bx = 0; bx < bw; ++bx) {
        block(p, by, bx, 0, coef);
        encode(coef, 0, 0);
      }
  }

  void color_scan() {
    // jccolor.c's rgb_ycc tables (SCALEBITS 16); the input is BGR.
    constexpr int32_t kHalf = 1 << 15, kCbCrOff = 128 << 16;
    auto fix = [](double x) { return (int32_t)(x * 65536.0 + 0.5); };
    int32_t ry[256], gy[256], by_[256], rcb[256], gcb[256], bcb[256], gcr[256], bcr[256];
    for (int i = 0; i < 256; ++i) {
      ry[i] = fix(0.29900) * i;
      gy[i] = fix(0.58700) * i;
      by_[i] = fix(0.11400) * i + kHalf;
      rcb[i] = -fix(0.16874) * i;
      gcb[i] = -fix(0.33126) * i;
      bcb[i] = fix(0.50000) * i + kCbCrOff + kHalf - 1;  // also R -> Cr
      gcr[i] = -fix(0.41869) * i;
      bcr[i] = -fix(0.08131) * i;
    }
    const size_t n = (size_t)h_ * w_;
    std::vector<uint8_t> yp(n), cb(n), cr(n);
    for (size_t i = 0; i < n; ++i) {
      const int b = img_[3 * i], g = img_[3 * i + 1], r = img_[3 * i + 2];
      yp[i] = (uint8_t)((ry[r] + gy[g] + by_[b]) >> 16);
      cb[i] = (uint8_t)((rcb[r] + gcb[g] + bcb[b]) >> 16);
      cr[i] = (uint8_t)((bcb[r] + gcr[g] + bcr[b]) >> 16);
    }
    const int ybw = (w_ + 7) / 8, ybh = (h_ + 7) / 8;  // Y blocks with samples
    const int mcux = (w_ + 15) / 16, mcuy = (h_ + 15) / 16;
    Plane y = padded(yp, h_, w_, ybh * 8, ybw * 8);
    // chroma: replicate to even rows and whole MCU columns, h2v2 average with
    // the alternating bias, then replicate the last row to whole blocks
    Plane c[2];
    const int cw = mcux * 8, ch = (h_ + 1) / 2;
    for (int k = 0; k < 2; ++k) {
      Plane full = padded(k ? cr : cb, h_, w_, ch * 2, cw * 2);
      std::vector<uint8_t> half((size_t)ch * cw);
      for (int yy = 0; yy < ch; ++yy) {
        const uint8_t* r0 = full.px.data() + (size_t)(2 * yy) * full.w;
        const uint8_t* r1 = r0 + full.w;
        int bias = 1;
        for (int xx = 0; xx < cw; ++xx) {
          half[(size_t)yy * cw + xx] =
              (uint8_t)((r0[2 * xx] + r0[2 * xx + 1] + r1[2 * xx] + r1[2 * xx + 1] + bias) >> 2);
          bias ^= 3;
        }
      }
      c[k] = padded(half, ch, cw, mcuy * 8, cw);
    }
    int16_t coef[4][64], cc[64];
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx) {
        // Y: up to 2x2 blocks; those past the samples are jccoefct.c's dummies
        for (int yi = 0; yi < 2; ++yi) {
          const int by = my * 2 + yi;
          for (int xi = 0; xi < 2; ++xi) {
            const int bx = mx * 2 + xi;
            int16_t* blk = coef[yi * 2 + xi];
            if (by < ybh && bx < ybw) {
              block(y, by, bx, 0, blk);
            } else {
              std::memset(blk, 0, sizeof(coef[0]));
              // right edge: the DC of the block to the left; a bottom row:
              // the DC of the row above's last block
              blk[0] = by < ybh ? coef[yi * 2 + xi - 1][0] : coef[1][0];
            }
          }
        }
        for (int k = 0; k < 4; ++k) encode(coef[k], 0, 0);
        for (int k = 0; k < 2; ++k) {
          block(c[k], my, mx, 1, cc);
          encode(cc, 1 + k, 1);
        }
      }
  }
};

}  // namespace jpeg

extern "C" {

// The JPEG calls return 0, or 1 with a message of at most err_len - 1 bytes
// in err (also for a file this decoder does not take).
static int32_t jpeg_error(const std::string& msg, char* err, int32_t err_len) {
  if (err_len > 0) {
    size_t n = std::min(msg.size(), (size_t)err_len - 1);
    std::memcpy(err, msg.data(), n);
    err[n] = '\0';
  }
  return 1;
}

// Read a JPEG file's markers up to its first scan: info gets the frame's
// height and width and the offset and length of the first APP1 segment's
// body (-1 and 0 without one).
int32_t jpeg_header(const uint8_t* data, int64_t len, int64_t* info, char* err,
                    int32_t err_len) {
  try {
    jpeg::Decoder d(data, (size_t)len);
    d.parse(true);
    info[0] = d.height;
    info[1] = d.width;
    info[2] = d.app1_pos;
    info[3] = d.app1_len;
    return 0;
  } catch (const jpeg::Error& e) {
    return jpeg_error(e.msg, err, err_len);
  }
}

// Decode a JPEG file held in memory into (height, width, 3) uint8 BGR;
// height and width are jpeg_header's, and the call checks them again.
int32_t jpeg_decode(const uint8_t* data, int64_t len, uint8_t* out_bgr, int32_t height,
                    int32_t width, char* err, int32_t err_len) {
  try {
    jpeg::Decoder d(data, (size_t)len);
    d.parse();
    if (d.height != height || d.width != width)
      jpeg::fail("the frame is " + std::to_string(d.width) + "x" + std::to_string(d.height) +
                 ", not " + std::to_string(width) + "x" + std::to_string(height));
    d.output(out_bgr);
    return 0;
  } catch (const jpeg::Error& e) {
    return jpeg_error(e.msg, err, err_len);
  } catch (const std::bad_alloc&) {
    return jpeg_error("out of memory", err, err_len);
  }
}

// Encode a (height, width, channels) uint8 image, BGR (channels 3) or gray
// (1), at quality 0..100 as cv2.imencode(".jpg") does; *out gets a malloc'd
// buffer of *out_len bytes, which the caller frees with jpeg_free.
int32_t jpeg_encode(const uint8_t* img, int32_t height, int32_t width, int32_t channels,
                    int32_t quality, uint8_t** out, int64_t* out_len, char* err,
                    int32_t err_len) {
  try {
    if (height < 1 || width < 1 || height > 65500 || width > 65500)
      jpeg::fail("a JPEG frame is 1 to 65500 pixels a side, not " + std::to_string(width) +
                 "x" + std::to_string(height));
    if (channels != 1 && channels != 3)
      jpeg::fail("the encoder takes 1 or 3 channels, not " + std::to_string(channels));
    if (quality < 0 || quality > 100)
      jpeg::fail("quality is 0 to 100, not " + std::to_string(quality));
    std::vector<uint8_t> bytes = jpeg::Encoder(img, height, width, channels, quality).run();
    uint8_t* buf = (uint8_t*)std::malloc(bytes.size());
    if (buf == nullptr) throw std::bad_alloc();
    std::memcpy(buf, bytes.data(), bytes.size());
    *out = buf;
    *out_len = (int64_t)bytes.size();
    return 0;
  } catch (const jpeg::Error& e) {
    return jpeg_error(e.msg, err, err_len);
  } catch (const std::bad_alloc&) {
    return jpeg_error("out of memory", err, err_len);
  }
}

void jpeg_free(uint8_t* p) { std::free(p); }

}  // extern "C"
