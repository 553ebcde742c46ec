// Host-side C++ of the PyTorch port: CTC decoding for the OCR engine, the
// PNG row unfilter, and the serving path's frame ring, JSONL appender and
// pixel loops (BGRA->BGR, crop, odd-integer decimation, cv2's uint8 linear
// resize) and delta-codec encoders (nibble, tribit, per-segment), and the
// detector trainer's augmentation loops (cv2's HSV round trip with a
// per-channel table, and its bilinear warpAffine).
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
