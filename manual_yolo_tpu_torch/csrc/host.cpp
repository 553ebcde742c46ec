// Host-side C++ of the PyTorch port: CTC decoding for the OCR engine and the
// PNG row unfilter.
//
// Built by runtime/native.py with `g++ -O2 -shared -fPIC` at first use and
// bound with ctypes (plain C interface, no Python headers). Each function has
// a plain Python twin that the tests hold it against: ctc_score /
// ctc_score_multi / ctc_beam against ops/ctc.py (`score_candidates_plain`,
// `prefix_beam_decode_plain`), png_unfilter against runtime/png.py
// (`_unfilter`).
//
// The CTC functions are a copy of native/runtime.cpp (the JAX package's host
// runtime): the same algorithms and the same pruning rules.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
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

}  // extern "C"
