// gasr_native — native runtime components for gasr_tpu.
//
// TPU-native framework counterparts of the reference's C++/CUDA runtime
// pieces (built for the host side of a TPU deployment):
//   - current_seconds(): monotonic wall clock (reference: cycleTimer.h
//     rdtsc + /proc/cpuinfo frequency scan; we use clock_gettime).
//   - logmel(): audio -> log-mel feature frontend (framing, Hann window,
//     iterative radix-2 FFT, mel filterbank, log). The reference has no
//     feature pipeline at all; a production ASR stack needs one, and it
//     belongs on the host CPU feeding the TPU.
//   - beam_decode_batch(): multithreaded CPU CTC prefix beam search —
//     the stand-in for ctcdecode.CTCBeamDecoder (baseline/main.py:28)
//     used by the benchmark baseline, and a host-side fallback decoder.
//     Prefixes are arena trie nodes (parent, char); per-frame candidate
//     merging via hash map keyed by node id; log-space (p_b, p_nb).
//
// Exposed with plain C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- timer

double gasr_current_seconds() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

// ----------------------------------------------------------------- fft

static void fft_radix2(float* re, float* im, int n) {
  // iterative in-place radix-2 Cooley-Tukey; n must be a power of two
  for (int i = 1, j = 0; i < n; i++) {
    int bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) {
      std::swap(re[i], re[j]);
      std::swap(im[i], im[j]);
    }
  }
  for (int len = 2; len <= n; len <<= 1) {
    double ang = -2.0 * M_PI / len;
    float wr = (float)cos(ang), wi = (float)sin(ang);
    for (int i = 0; i < n; i += len) {
      float cr = 1.0f, ci = 0.0f;
      for (int k = 0; k < len / 2; k++) {
        float ur = re[i + k], ui = im[i + k];
        float vr = re[i + k + len / 2] * cr - im[i + k + len / 2] * ci;
        float vi = re[i + k + len / 2] * ci + im[i + k + len / 2] * cr;
        re[i + k] = ur + vr;
        im[i + k] = ui + vi;
        re[i + k + len / 2] = ur - vr;
        im[i + k + len / 2] = ui - vi;
        float ncr = cr * wr - ci * wi;
        ci = cr * wi + ci * wr;
        cr = ncr;
      }
    }
  }
}

static double hz_to_mel(double hz) { return 2595.0 * log10(1.0 + hz / 700.0); }
static double mel_to_hz(double mel) {
  return 700.0 * (pow(10.0, mel / 2595.0) - 1.0);
}

// audio [n] -> out [n_frames, n_mels]; returns n_frames (or -1 on error).
// center=false framing: frame t covers samples [t*hop, t*hop + n_fft).
int gasr_logmel(const float* audio, int n, int sample_rate, int n_fft,
                int hop, int n_mels, float fmin, float fmax, float* out) {
  if (n_fft <= 0 || (n_fft & (n_fft - 1)) != 0) return -1;  // power of two
  if (fmax <= 0.0f) fmax = sample_rate / 2.0f;
  int n_frames = (n < n_fft) ? 0 : 1 + (n - n_fft) / hop;
  int n_bins = n_fft / 2 + 1;

  // mel filterbank (triangular, HTK-style mel scale)
  std::vector<double> mel_pts(n_mels + 2);
  double m0 = hz_to_mel(fmin), m1 = hz_to_mel(fmax);
  for (int i = 0; i < n_mels + 2; i++)
    mel_pts[i] = mel_to_hz(m0 + (m1 - m0) * i / (n_mels + 1));
  std::vector<int> bin_pts(n_mels + 2);
  for (int i = 0; i < n_mels + 2; i++)
    bin_pts[i] = (int)floor((n_fft + 1) * mel_pts[i] / sample_rate);

  std::vector<float> window(n_fft);
  for (int i = 0; i < n_fft; i++)
    window[i] = 0.5f - 0.5f * (float)cos(2.0 * M_PI * i / n_fft);

  std::vector<float> re(n_fft), im(n_fft), power(n_bins);
  for (int t = 0; t < n_frames; t++) {
    const float* frame = audio + (size_t)t * hop;
    for (int i = 0; i < n_fft; i++) {
      re[i] = frame[i] * window[i];
      im[i] = 0.0f;
    }
    fft_radix2(re.data(), im.data(), n_fft);
    for (int b = 0; b < n_bins; b++)
      power[b] = re[b] * re[b] + im[b] * im[b];
    for (int m = 0; m < n_mels; m++) {
      int lo = bin_pts[m], c = bin_pts[m + 1], hi = bin_pts[m + 2];
      float acc = 0.0f;
      for (int b = lo; b < c; b++)
        if (c > lo) acc += power[b] * (float)(b - lo) / (float)(c - lo);
      for (int b = c; b < hi && b < n_bins; b++)
        if (hi > c) acc += power[b] * (float)(hi - b) / (float)(hi - c);
      out[(size_t)t * n_mels + m] = logf(acc + 1e-10f);
    }
  }
  return n_frames;
}

// -------------------------------------------------- CTC beam decoder

namespace {

constexpr float kNegInf = -1.0e30f;

inline float lse(float a, float b) {
  if (a <= kNegInf) return b;
  if (b <= kNegInf) return a;
  float m = a > b ? a : b;
  return m + log1pf(expf((a > b ? b : a) - m));
}

struct TrieNode {
  int32_t parent;  // -1 for root
  int32_t ch;
  std::unordered_map<int32_t, int32_t> children;
};

struct Beam {
  int32_t node;
  float pb, pnb;
  float score() const { return lse(pb, pnb); }
};

void decode_one(const float* lp, int T, int V, int beam_width, int blank,
                int max_len, int32_t* out_tokens, int32_t* out_len,
                float* out_score) {
  std::vector<TrieNode> arena;
  arena.push_back({-1, -1, {}});
  std::vector<Beam> beams{{0, 0.0f, kNegInf}};
  std::unordered_map<int64_t, int32_t> cand_idx;  // key: node*2+is_stay?? no: node
  std::vector<Beam> cands;
  std::vector<int> order;

  for (int t = 0; t < T; t++) {
    const float* f = lp + (size_t)t * V;
    cand_idx.clear();
    cands.clear();

    auto acc = [&](int32_t node, float dpb, float dpnb) {
      auto it = cand_idx.find(node);
      int32_t i;
      if (it == cand_idx.end()) {
        i = (int32_t)cands.size();
        cand_idx.emplace(node, i);
        cands.push_back({node, kNegInf, kNegInf});
      } else {
        i = it->second;
      }
      if (dpb > kNegInf) cands[i].pb = lse(cands[i].pb, dpb);
      if (dpnb > kNegInf) cands[i].pnb = lse(cands[i].pnb, dpnb);
    };

    for (const Beam& b : beams) {
      float total = lse(b.pb, b.pnb);
      int last = arena[b.node].ch;  // -1 at root
      // stay: blank transition + repeat collapse
      float stay_pnb = (last >= 0) ? b.pnb + f[last] : kNegInf;
      acc(b.node, total + f[blank], stay_pnb);
      for (int v = 0; v < V; v++) {
        if (v == blank) continue;
        float base = (v == last) ? b.pb : total;
        if (base <= kNegInf) continue;
        // child node (lazy)
        auto& ch = arena[b.node].children;
        auto it = ch.find(v);
        int32_t child;
        if (it == ch.end()) {
          child = (int32_t)arena.size();
          ch.emplace(v, child);
          arena.push_back({b.node, v, {}});
        } else {
          child = it->second;
        }
        acc(child, kNegInf, base + f[v]);
      }
    }
    // top beam_width by score, stable
    order.resize(cands.size());
    for (size_t i = 0; i < order.size(); i++) order[i] = (int)i;
    int keep = std::min((int)cands.size(), beam_width);
    std::partial_sort(order.begin(), order.begin() + keep, order.end(),
                      [&](int a, int b2) {
                        float sa = cands[a].score(), sb = cands[b2].score();
                        if (sa != sb) return sa > sb;
                        return a < b2;
                      });
    beams.assign(keep, Beam{});
    for (int i = 0; i < keep; i++) beams[i] = cands[order[i]];
  }

  // best beam
  const Beam* best = &beams[0];
  for (const Beam& b : beams)
    if (b.score() > best->score()) best = &b;
  // walk trie to recover tokens (reversed)
  std::vector<int32_t> rev;
  for (int32_t n = best->node; n > 0; n = arena[n].parent)
    rev.push_back(arena[n].ch);
  int L = (int)rev.size();
  int outL = std::min(L, max_len);
  // keep the HEAD on overflow (matches gasr_tpu.decoder semantics)
  for (int i = 0; i < outL; i++) out_tokens[i] = rev[L - 1 - i];
  *out_len = outL;
  *out_score = best->score();
}

}  // namespace

// log_probs [T, B, V] time-major. Outputs: tokens [B, max_len],
// lens [B], scores [B].
void gasr_beam_decode_batch(const float* log_probs, int T, int B, int V,
                            int beam_width, int blank, int max_len,
                            int num_threads, int32_t* out_tokens,
                            int32_t* out_lens, float* out_scores) {
  // repack to per-utterance [T, V] views lazily inside workers
  auto worker = [&](int b0, int b1) {
    std::vector<float> lp((size_t)T * V);
    for (int b = b0; b < b1; b++) {
      for (int t = 0; t < T; t++)
        memcpy(lp.data() + (size_t)t * V,
               log_probs + ((size_t)t * B + b) * V, V * sizeof(float));
      decode_one(lp.data(), T, V, beam_width, blank, max_len,
                 out_tokens + (size_t)b * max_len, out_lens + b,
                 out_scores + b);
    }
  };
  num_threads = std::max(1, std::min(num_threads, B));
  std::vector<std::thread> threads;
  int per = (B + num_threads - 1) / num_threads;
  for (int i = 0; i < num_threads; i++) {
    int b0 = i * per, b1 = std::min(B, b0 + per);
    if (b0 >= b1) break;
    threads.emplace_back(worker, b0, b1);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
