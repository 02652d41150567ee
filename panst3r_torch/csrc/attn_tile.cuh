// Block engine of the f32 K2-int8 (tower_cross_int8.cu); the bf16 K5
// (flash_bwd.cu) takes its constants and rope_at, the Hopper engines
// (attn_sm90.cuh, attn_f32_sm90.cuh) its semantics.
//
// One thread block owns a 64-row query tile of one (batch, head) and walks
// the key tiles (64 keys each) with an online softmax in f32.  Four warps;
// warp w owns query rows [16w, 16w + 16) of the tile for the softmax and
// the value product, so within a key tile only the K/V loads need a block
// barrier.  The value product is a plain f32 FMA product (no TF32); O
// lives in registers (lane owns columns lane + 32j of its warp's 16 rows).
//
// Semantics shared by the kernels (the plain versions in
// panst3r_torch/ops/*.py follow them):
// - masked logits are finfo(f32).min (NEG), never -inf; a probability whose
//   logit is <= NEG/2 is exactly 0, and the running max is replaced by 0
//   while a row has seen no live key ("safe_m"), so NEG never makes a NaN;
// - p is rounded to the value dtype before it enters the numerator; K1-K3
//   sum the rounded p into the row sum too, K4 sums the unrounded f32 p;
// - a row that saw no live key writes 0.
#pragma once

#include "attn_common.cuh"  // NEG, to_f, from_f, prepare, P3_ERROR_STRING_FN

namespace p3 {

constexpr int BQ = 64;                          // query rows per block
constexpr int BK = 64;                          // keys per tile
constexpr int NTHREADS = 128;                   // 4 warps x 16 rows

constexpr int round128(int b) { return (b + 127) / 128 * 128; }

// x[d] of a row of any head dim D rotated in f32 with tables cs/sn (or
// x[d] when cs is null): x*cos + rot(x)*sin, rot(x)[d] = -x[d + D/4] in the
// first quarter of each half and x[d - D/4] in its second (K4, K5).
template <int D, typename T>
__device__ __forceinline__ float rope_at(const T* __restrict__ row,
                                         const float* __restrict__ cs,
                                         const float* __restrict__ sn,
                                         int d) {
  const float x = to_f(row[d]);
  if (cs == nullptr) return x;
  constexpr int Q = D / 4;
  const bool first = (d % (D / 2)) < Q;
  const float xp = to_f(row[first ? d + Q : d - Q]);
  return x * cs[d] + (first ? -xp : xp) * sn[d];
}

template <int D>
struct Tile {
  static_assert(D % 32 == 0 && D <= 128, "head dim");
  static constexpr int LD = D + 1;         // q/k/v row stride
  static constexpr int LDS = BK + 4;       // scores
  static constexpr int LDP = LDS;          // probabilities (alias s)
  static constexpr int kQ = round128(BQ * LD * 4);
  static constexpr int kKV = round128(BK * LD * 4);
  static constexpr int kS = round128(BQ * LDS * 4);
  static constexpr int kMisc = round128((3 * BQ + BK) * 4);
  static constexpr int kBytes = kQ + 2 * kKV + kS + kMisc;
  static constexpr int DJ = D / 32;

  float* q;
  float* k;
  float* v;
  float* s;
  float* p;       // aliases s
  float* alpha;   // [BQ] rescale of the last step
  float* lsum;    // [BQ] final row sums
  float* crow;    // [BQ] a per-row value of the kernel's (K2-int8: c)
  float* kbias;   // [BK] per-key bias of the current tile

  int w, lane;
  float m, l;            // running max / sum of row (w*16 + lane/2)
  float oreg[16][DJ];    // the accumulator O

  __device__ void init(unsigned char* smem) {
    unsigned char* ptr = smem;
    q = reinterpret_cast<float*>(ptr); ptr += kQ;
    k = reinterpret_cast<float*>(ptr); ptr += kKV;
    v = reinterpret_cast<float*>(ptr); ptr += kKV;
    s = reinterpret_cast<float*>(ptr); ptr += kS;
    p = s;
    alpha = reinterpret_cast<float*>(ptr);
    lsum = alpha + BQ;
    crow = lsum + BQ;
    kbias = crow + BQ;
    w = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    m = NEG;
    l = 0.f;
#pragma unroll
    for (int rr = 0; rr < 16; ++rr)
#pragma unroll
      for (int j = 0; j < DJ; ++j) oreg[rr][j] = 0.f;
  }

  // O = alpha * O + P V for this warp's rows.
  __device__ void accumulate() {
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const float a = alpha[w * 16 + rr];
#pragma unroll
      for (int j = 0; j < DJ; ++j) oreg[rr][j] *= a;
    }
    for (int c = 0; c < BK; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = v[c * LD + lane + 32 * j];
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) {
        const float pp = p[(w * 16 + rr) * LDP + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) oreg[rr][j] = fmaf(pp, vv[j], oreg[rr][j]);
      }
    }
  }

  // out = O / l (rows without a live key: l = 0 -> output 0).
  template <class Store>
  __device__ void finish(Store store) {
    if ((lane & 1) == 0) lsum[w * 16 + (lane >> 1)] = (l == 0.f) ? 1.f : l;
    __syncwarp();
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int r = w * 16 + rr;
#pragma unroll
      for (int j = 0; j < DJ; ++j) store(r, lane + 32 * j, oreg[rr][j] / lsum[r]);
    }
  }
};

}  // namespace p3
