// Host-side C++ of the PyTorch port: CTC decoding for the OCR engine, the
// PNG row unfilter, and the serving path's frame ring, JSONL appender and
// pixel loops (BGRA->BGR, crop, odd-integer decimation, cv2's uint8 linear
// resize), and the detector trainer's augmentation loops (cv2's HSV round
// trip with a per-channel table, and its bilinear warpAffine).
//
// Built by runtime/native.py with `g++ -O2 -shared -fPIC` at first use and
// bound with ctypes (plain C interface, no Python headers). Each function has
// a plain Python twin that the tests hold it against: ctc_score /
// ctc_score_multi / ctc_beam against ops/ctc.py (`score_candidates_plain`,
// `prefix_beam_decode_plain`), png_unfilter against runtime/png.py
// (`_unfilter`).
//
// The CTC functions, FrameRing, JsonLog and the pixel loops are a copy of
// native/runtime.cpp (the JAX package's host runtime): the same algorithms,
// the same pruning rules and the same byte layouts. Their plain twins live in
// runtime/native.py (PlainFrameRing, PlainJsonLog, bgra_to_bgr_plain,
// crop_u8_plain, decimate_u8_plain); resize_u8's is ops/image.py's
// cv_resize_u8; hsv_jitter_u8's and warp_affine_u8's are train/data.py's
// hsv_jitter_u8_plain and warp_affine_u8_plain, whose f32 operations they
// repeat in the same order (the build turns FMA contraction off).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <new>
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

}  // extern "C"
