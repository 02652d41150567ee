// Shared block engine of the attention forward kernels of the f32 K1
// (tower_self), K2-int8 (tower_cross_int8), K4 (flash_fwd) and the f32 K6
// (packed_flash, which runs two tiles in one block); K5 (flash_bwd.cu)
// takes its constants, conversions and rope_at, the Hopper engines
// (attn_sm90.cuh, attn_f32_sm90.cuh) its semantics and constants.
//
// One thread block owns a 64-row query tile of one (batch, head) and walks
// the key tiles (64 keys each) with an online softmax in f32.  Four warps;
// warp w owns query rows [16w, 16w + 16) of the tile for the score product,
// the softmax and the value product, so within a key tile only the K/V
// loads need a block barrier.
//
// bf16: both products run on the tensor cores through WMMA (16x16x16,
// f32 accumulate); the f32 accumulator O lives in shared memory and is
// rescaled there.  f32: plain FMA products (full f32, no TF32); O lives in
// registers (lane owns columns lane + 32j of its warp's 16 rows).
//
// Semantics shared by the kernels (the plain versions in
// panst3r_torch/ops/*.py follow them):
// - masked logits are finfo(f32).min (NEG), never -inf; a probability whose
//   logit is <= NEG/2 is exactly 0, and the running max is replaced by 0
//   while a row has seen no live key ("safe_m"), so NEG never makes a NaN;
// - p is rounded to the value dtype before it enters the numerator; K1-K3
//   sum the rounded p into the row sum too, K4 sums the unrounded f32 p
//   (softmax<false>), as its Pallas kernel does;
// - a row that saw no live key writes 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace p3 {

constexpr float NEG = -3.4028234663852886e38f;  // finfo(float32).min
constexpr int BQ = 64;                          // query rows per block
constexpr int BK = 64;                          // keys per tile
constexpr int NTHREADS = 128;                   // 4 warps x 16 rows

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

constexpr int round128(int b) { return (b + 127) / 128 * 128; }

// 2D-RoPE (rotate-half within each 32-wide half of a d=64 head) applied in
// f32 at load: x*cos + rot(x)*sin, rot(x)[d] = d&16 ? x[d-16] : -x[d+16].
template <typename T>
__device__ __forceinline__ float load_rope(const T* __restrict__ row,
                                           const float* __restrict__ cs,
                                           const float* __restrict__ sn,
                                           int d) {
  float x = to_f(row[d]);
  if (cs == nullptr) return x;
  float xp = to_f(row[d ^ 16]);
  return x * cs[d] + ((d & 16) ? xp : -xp) * sn[d];
}

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

template <typename T, int D>
struct Tile {
  static constexpr bool kBF16 = sizeof(T) == 2;
  static_assert(D % 32 == 0 && D <= 128, "head dim");
  static constexpr int LD = kBF16 ? D + 8 : D + 1;     // q/k/v row stride
  static constexpr int LDS = BK + 4;                    // scores (f32)
  static constexpr int LDP = kBF16 ? BK + 8 : LDS;      // probabilities
  static constexpr int LDO = D + 4;                     // O (bf16 path)
  static constexpr int kQ = round128(BQ * LD * (int)sizeof(T));
  static constexpr int kKV = round128(BK * LD * (int)sizeof(T));
  static constexpr int kS = round128(BQ * LDS * 4);
  static constexpr int kP = kBF16 ? round128(BQ * LDP * 2) : 0;
  static constexpr int kO = kBF16 ? round128(BQ * LDO * 4) : 0;
  static constexpr int kMisc = round128((3 * BQ + 2 * D + BK) * 4);
  static constexpr int kBytes = kQ + 2 * kKV + kS + kP + kO + kMisc;
  static constexpr int DJ = D / 32;

  T* q;
  T* k;
  T* v;
  float* s;
  T* p;           // bf16: own buffer; f32: aliases s
  float* o;       // bf16 only
  float* alpha;   // [BQ] rescale of the last step
  float* lsum;    // [BQ] final row sums
  float* sc;      // [BQ] cls logits (K1)
  float* kc;      // [D]  cls key (K1)
  float* vc;      // [D]  cls value (K1)
  float* kbias;   // [BK] per-key bias of the current tile (K2-int8, K4)

  int w, lane;
  float m, l;            // running max / sum of row (w*16 + lane/2)
  float oreg[16][DJ];    // f32 path accumulator

  __device__ void init(unsigned char* smem) { init(smem, threadIdx.x >> 5); }

  // ``warp``: this warp's index among the tile's four (a block may hold
  // more than one tile, K6).
  __device__ void init(unsigned char* smem, int warp) {
    unsigned char* ptr = smem;
    q = reinterpret_cast<T*>(ptr); ptr += kQ;
    k = reinterpret_cast<T*>(ptr); ptr += kKV;
    v = reinterpret_cast<T*>(ptr); ptr += kKV;
    s = reinterpret_cast<float*>(ptr); ptr += kS;
    if constexpr (kBF16) {
      p = reinterpret_cast<T*>(ptr); ptr += kP;
      o = reinterpret_cast<float*>(ptr); ptr += kO;
    } else {
      p = reinterpret_cast<T*>(s);
      o = nullptr;
    }
    alpha = reinterpret_cast<float*>(ptr);
    lsum = alpha + BQ;
    sc = lsum + BQ;
    kc = sc + BQ;
    vc = kc + D;
    kbias = vc + D;
    w = warp;
    lane = threadIdx.x & 31;
    m = NEG;
    l = 0.f;
    if constexpr (kBF16) {
      for (int e = lane; e < 16 * D; e += 32)
        o[(w * 16 + e / D) * LDO + e % D] = 0.f;
      __syncwarp();
    } else {
#pragma unroll
      for (int rr = 0; rr < 16; ++rr)
#pragma unroll
        for (int j = 0; j < DJ; ++j) oreg[rr][j] = 0.f;
    }
  }

  // cls key/value as one extra column every query sees (K1): after q, kc
  // and vc are in shared memory.  m = scale*q.kc, l = 1, O = vc.
  __device__ void init_cls(float scale) {
    const int r = w * 16 + (lane >> 1);
    const int half = lane & 1;
    float part = 0.f;
    for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d)
      part += to_f(q[r * LD + d]) * kc[d];
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    m = part * scale;
    l = 1.f;
    if constexpr (kBF16) {
      for (int e = lane; e < 16 * D; e += 32)
        o[(w * 16 + e / D) * LDO + e % D] = vc[e % D];
      __syncwarp();
    } else {
#pragma unroll
      for (int rr = 0; rr < 16; ++rr)
#pragma unroll
        for (int j = 0; j < DJ; ++j) oreg[rr][j] = vc[lane + 32 * j];
    }
  }

  // s[r][c] = q[r] . k[c] (raw, f32) for this warp's 16 rows.
  __device__ void scores() {
    if constexpr (kBF16) {
      using namespace nvcuda;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> b;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        wmma::fill_fragment(c, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::load_matrix_sync(a, q + (w * 16) * LD + kk * 16, LD);
          wmma::load_matrix_sync(b, k + (n * 16) * LD + kk * 16, LD);
          wmma::mma_sync(c, a, b, c);
        }
        wmma::store_matrix_sync(s + (w * 16) * LDS + n * 16, c, LDS,
                                wmma::mem_row_major);
      }
    } else {
      float acc[16][2];
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) acc[rr][0] = acc[rr][1] = 0.f;
      const int c0 = lane, c1 = lane + 32;
      for (int d = 0; d < D; ++d) {
        const float k0 = to_f(k[c0 * LD + d]);
        const float k1 = to_f(k[c1 * LD + d]);
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) {
          const float qq = to_f(q[(w * 16 + rr) * LD + d]);
          acc[rr][0] = fmaf(qq, k0, acc[rr][0]);
          acc[rr][1] = fmaf(qq, k1, acc[rr][1]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) {
        s[(w * 16 + rr) * LDS + c0] = acc[rr][0];
        s[(w * 16 + rr) * LDS + c1] = acc[rr][1];
      }
    }
    __syncwarp();
  }

  // Online-softmax step.  logit(r, c, raw) maps a raw score to the logit
  // (scale, bias, mask -> NEG).  Two lanes per row, 32 keys each.
  // kRoundedSum: the row sum takes p rounded to T (K1-K3) or the f32 p (K4).
  template <bool kRoundedSum = true, class Logit>
  __device__ void softmax(Logit logit) {
    const int r = w * 16 + (lane >> 1);
    const int c0 = (lane & 1) * 32;
    float* srow = s + r * LDS;
    float mx = NEG;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const float x = logit(r, c0 + j, srow[c0 + j]);
      srow[c0 + j] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float safe = (m_new <= 0.5f * NEG) ? 0.f : m_new;
    T* prow = p + r * LDP;
    float sum = 0.f;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const float x = srow[c0 + j];
      const float pf = (x <= 0.5f * NEG) ? 0.f : expf(x - safe);
      const T pt = from_f<T>(pf);
      prow[c0 + j] = pt;
      sum += kRoundedSum ? to_f(pt) : pf;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float a = (m <= 0.5f * NEG) ? 0.f : expf(m - safe);
    l = l * a + sum;
    m = m_new;
    if ((lane & 1) == 0) alpha[r] = a;
    __syncwarp();
  }

  // O = alpha * O + P V for this warp's rows.
  __device__ void accumulate() {
    if constexpr (kBF16) {
      using namespace nvcuda;
      for (int e = lane; e < 16 * D; e += 32) {
        const int r = w * 16 + e / D;
        o[r * LDO + e % D] *= alpha[r];
      }
      __syncwarp();
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        wmma::load_matrix_sync(c, o + (w * 16) * LDO + dn * 16, LDO,
                               wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::load_matrix_sync(a, p + (w * 16) * LDP + kk * 16, LDP);
          wmma::load_matrix_sync(b, v + (kk * 16) * LD + dn * 16, LD);
          wmma::mma_sync(c, a, b, c);
        }
        wmma::store_matrix_sync(o + (w * 16) * LDO + dn * 16, c, LDO,
                                wmma::mem_row_major);
      }
      __syncwarp();
    } else {
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) {
        const float a = alpha[w * 16 + rr];
#pragma unroll
        for (int j = 0; j < DJ; ++j) oreg[rr][j] *= a;
      }
      for (int c = 0; c < BK; ++c) {
        float vv[DJ];
#pragma unroll
        for (int j = 0; j < DJ; ++j) vv[j] = to_f(v[c * LD + lane + 32 * j]);
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) {
          const float pp = to_f(p[(w * 16 + rr) * LDP + c]);
#pragma unroll
          for (int j = 0; j < DJ; ++j) oreg[rr][j] = fmaf(pp, vv[j], oreg[rr][j]);
        }
      }
    }
  }

  // out = O / l (rows without a live key: l = 0 -> output 0).
  template <class Store>
  __device__ void finish(Store store) {
    if ((lane & 1) == 0) lsum[w * 16 + (lane >> 1)] = (l == 0.f) ? 1.f : l;
    __syncwarp();
    if constexpr (kBF16) {
      for (int e = lane; e < 16 * D; e += 32) {
        const int r = w * 16 + e / D, d = e % D;
        store(r, d, o[r * LDO + d] / lsum[r]);
      }
    } else {
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) {
        const int r = w * 16 + rr;
#pragma unroll
        for (int j = 0; j < DJ; ++j) store(r, lane + 32 * j, oreg[rr][j] / lsum[r]);
      }
    }
  }
};

template <typename Kern>
inline cudaError_t prepare(Kern kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace p3

#define P3_ERROR_STRING_FN                                      \
  extern "C" const char* p3_error_string(int e) {               \
    return cudaGetErrorString(static_cast<cudaError_t>(e));     \
  }
