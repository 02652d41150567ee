// K5, bf16 — flash-attention backward (FlashAttention-2) over (B, H, N, D)
// streams.  The f32 K5, the dtype of every launch on the main paths, is
// flash_bwd_sm90.cu (the Hopper f32 engine).
//
// Replaces panst3r_tpu/ops/pallas/flash_attention_bwd.py::flash_bwd in bf16
// and its two kernels: _dq_kernel (one block per query tile, accumulating
// over the key tiles) and _dkv_kernel (one block per key tile, accumulating
// over the query tiles).  Both recompute p = exp(s - lse) tile by tile from
// q, k and the LSE that K4 saved, so the (Nq, Nk) scores never reach global
// memory:
//   s  = q.k^T * scale + per-key bias row + dense bias (as K4 takes them)
//   p  = exp(s - lse), 0 where s <= finfo.min/2 or the row's LSE is
//        <= finfo.min/2 (no live key) or >= -finfo.min/2 (padding)
//   dp = do.v^T;  ds = p * (dp - Dvec) * scale,  Dvec = rowsum(do*o) from
//        the wrapper (torch, f32)
//   dq = ds.k;  dk = ds^T.q;  dv = p^T.do
// ds is rounded to k's dtype before ds.k and to q's before ds^T.q, p to
// do's before p^T.do; q and k are rotated by the RoPE tables in f32 and
// rounded to their dtype, as in the Pallas kernels (the wrapper applies the
// rotation's adjoint to dq and dk).  The gradients leave in f32 (B, H, N, D).
//
// Bound on the H100: seven products of 2*B*H*Nq*Nk*D FLOPs (s and dp in
// both kernels, dq, dk, dv) against q, k, v, do and the three gradients
// moved once.  At the LoftUp training shape (B*V = 10, H = 4, Nq = 49152,
// Nk = 768, D = 96) that is 2.0 TFLOP per call, 2.1 ms at the 989 TFLOP/s
// bf16 rate: bound by operations.  Design, simple first: one 128-thread
// block per 64-row tile, four warps owning 16 rows each; products on WMMA
// (f32 accumulate) into fragments; s and dp pass through shared memory
// for the element-wise step.  A key tile whose bias row is all dead adds
// nothing: the dq kernel skips it and the dkdv kernel writes zeros for it.
// No path launches it: it runs in the kernels phase of chip_smoke.py and
// the CUDA tests.
#include <mma.h>

#include <type_traits>

#include "attn_tile.cuh"

using namespace p3;
using namespace nvcuda;

// Element strides: q, k, v, do by (batch, head, token); the dense bias by
// (batch, head, query, key), 0 where it is broadcast.
struct Strides {
  long long qb, qh, qn, kb, kh, kn, vb, vh, vn, gb, gh, gn, bb, bh, bq, bk;
};

// Shared-memory layout of both kernels: four 64-row tiles (a, b: the rows
// the block owns; c, d: the rows it streams), s and dp in f32, p and ds in
// T, an f32 staging tile for the WMMA accumulators, and per-row LSE, Dvec
// and per-key bias.
template <typename T, int D>
struct Smem {
  static_assert(sizeof(T) == 2, "bf16 only: the f32 K5 is flash_bwd_sm90.cu");
  static constexpr int LD = D + 8;                     // T rows
  static constexpr int LDS = BK + 4;                   // s, dp (f32)
  static constexpr int LDP = BK + 8;                   // p, ds
  static constexpr int LDO = D + 4;                    // staging (f32)
  static constexpr int kRow = round128(64 * LD * (int)sizeof(T));
  static constexpr int kS = round128(64 * LDS * 4);
  static constexpr int kP = round128(64 * LDP * 2);
  static constexpr int kO = round128(64 * LDO * 4);
  static constexpr int kBytes = 4 * kRow + 2 * kS + 2 * kP + kO
                                + round128(3 * 64 * 4);

  T *a, *b, *c, *d;
  float *s, *dp, *stage, *lse, *dvec, *kbias;
  T *p, *ds;

  __device__ void init(unsigned char* smem) {
    unsigned char* ptr = smem;
    a = reinterpret_cast<T*>(ptr); ptr += kRow;
    b = reinterpret_cast<T*>(ptr); ptr += kRow;
    c = reinterpret_cast<T*>(ptr); ptr += kRow;
    d = reinterpret_cast<T*>(ptr); ptr += kRow;
    s = reinterpret_cast<float*>(ptr); ptr += kS;
    dp = reinterpret_cast<float*>(ptr); ptr += kS;
    p = reinterpret_cast<T*>(ptr); ptr += kP;
    ds = reinterpret_cast<T*>(ptr); ptr += kP;
    stage = reinterpret_cast<float*>(ptr); ptr += kO;
    lse = reinterpret_cast<float*>(ptr);
    dvec = lse + 64;
    kbias = dvec + 64;
  }
};

// f32 accumulator of a warp's 16 rows x D in WMMA fragments.
template <typename T, int D>
struct Acc {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[D / 16];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < D / 16; ++i) wmma::fill_fragment(f[i], 0.f);
  }
};

// S[r][c] = sum_d A[r][d] * B[c][d] (f32) for this warp's 16 rows r and the
// 64 rows c of B.
template <typename T, int D>
__device__ void abt(const T* A, const T* B, float* S, int w, int lane) {
  using L = Smem<T, D>;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>
      fb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    wmma::fill_fragment(fc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::load_matrix_sync(fa, A + (w * 16) * L::LD + kk * 16, L::LD);
      wmma::load_matrix_sync(fb, B + (n * 16) * L::LD + kk * 16, L::LD);
      wmma::mma_sync(fc, fa, fb, fc);
    }
    wmma::store_matrix_sync(S + (w * 16) * L::LDS + n * 16, fc, L::LDS,
                            wmma::mem_row_major);
  }
  __syncwarp();
}

// acc[r] += sum_c P[r][c] * B[c] (kTrans = false: P's rows are this warp's
// rows) or acc[r] += sum_c P[c][r] * B[c] (kTrans = true: P's columns are),
// over the 64 rows c of B; P has row stride ldp.
template <bool kTrans, typename T, int D>
__device__ void acc_pb(Acc<T, D>& acc, const T* P, int ldp, const T* B, int w,
                       int lane) {
  using L = Smem<T, D>;
  using Layout = typename std::conditional<kTrans, wmma::col_major,
                                           wmma::row_major>::type;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, Layout> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      fb;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const T* pa = kTrans ? P + (kk * 16) * ldp + w * 16
                         : P + (w * 16) * ldp + kk * 16;
    wmma::load_matrix_sync(fa, pa, ldp);
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      wmma::load_matrix_sync(fb, B + (kk * 16) * L::LD + dn * 16, L::LD);
      wmma::mma_sync(acc.f[dn], fa, fb, acc.f[dn]);
    }
  }
}

// out[n0 + r] = acc[r] for this warp's rows below N; out is the (b, h)
// slice of an (N, D) f32 array.
template <typename T, int D>
__device__ void store_acc(Acc<T, D>& acc, float* stage, float* out, int n0,
                          int N, int w, int lane) {
  using L = Smem<T, D>;
#pragma unroll
  for (int dn = 0; dn < D / 16; ++dn)
    wmma::store_matrix_sync(stage + (w * 16) * L::LDO + dn * 16, acc.f[dn],
                            L::LDO, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 16 * D; e += 32) {
    const int r = e / D, d = e % D, n = n0 + w * 16 + r;
    if (n < N) out[(long long)n * D + d] = stage[(w * 16 + r) * L::LDO + d];
  }
  __syncwarp();
}

// Rows [n0, n0 + 64) of x (rotated by the tables when given, f32, rounded to
// T) into a tile; rows past N are 0.
template <typename T, int D>
__device__ void load_rows(T* dst, const T* x, long long sn, const float* cs,
                          const float* sn_tab, long long tab0, int n0, int N) {
  using L = Smem<T, D>;
  for (int e = threadIdx.x; e < 64 * D; e += NTHREADS) {
    const int r = e / D, d = e % D, n = n0 + r;
    float val = 0.f;
    if (n < N) {
      const long long t = (tab0 + n) * D;
      val = rope_at<D>(x + n * sn, cs ? cs + t : nullptr,
                       cs ? sn_tab + t : nullptr, d);
    }
    dst[r * L::LD + d] = from_f<T>(val);
  }
}

// LSE (padding rows: -finfo.min, so p = 0) and Dvec of query rows
// [i0, i0 + 64).
template <typename T, int D>
__device__ void load_row_stats(Smem<T, D>& sm, const float* lse,
                               const float* dvec, int i0, int Nq) {
  for (int r = threadIdx.x; r < 64; r += NTHREADS) {
    const int i = i0 + r;
    sm.lse[r] = i < Nq ? lse[i] : -NEG;
    sm.dvec[r] = i < Nq ? dvec[i] : 0.f;
  }
}

// The per-key bias of keys [j0, j0 + 64) (finfo.min past Nk); returns
// whether any key of the tile is live, block-wide.
template <typename T, int D>
__device__ bool load_key_bias(Smem<T, D>& sm, const float* kb, int j0,
                              int Nk) {
  int live = 0;
  for (int c = threadIdx.x; c < BK; c += NTHREADS) {
    const int j = j0 + c;
    const float bj = (j < Nk) ? (kb ? kb[j] : 0.f) : NEG;
    sm.kbias[c] = bj;
    live |= bj > 0.5f * NEG;
  }
  return __syncthreads_or(live);
}

// p and ds of this warp's 16 query rows (first row i0) against the 64 keys
// (first key j0), from s and dp; the dense bias slice bh at (b, h) or null.
template <typename T, int D>
__device__ void probs(Smem<T, D>& sm, const float* bh, const Strides& st,
                      int i0, int j0, int Nq, int Nk, float scale, int w,
                      int lane) {
  using L = Smem<T, D>;
  for (int e = lane; e < 16 * BK; e += 32) {
    const int r = w * 16 + e / BK, c = e % BK;
    const int i = i0 + r, j = j0 + c;
    float x = sm.s[r * L::LDS + c] * scale + sm.kbias[c];
    if (bh != nullptr && i < Nq && j < Nk) x += bh[i * st.bq + j * st.bk];
    const float l = sm.lse[r];
    const float pf = (x <= 0.5f * NEG || l <= 0.5f * NEG || l >= -0.5f * NEG)
                         ? 0.f
                         : expf(x - l);
    const float dsf = pf * (sm.dp[r * L::LDS + c] - sm.dvec[r]) * scale;
    sm.p[r * L::LDP + c] = from_f<T>(pf);
    sm.ds[r * L::LDP + c] = from_f<T>(dsf);
  }
  __syncwarp();
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ dvec,
                    const float* __restrict__ bias,
                    const float* __restrict__ kbias,
                    const float* __restrict__ qcos,
                    const float* __restrict__ qsin,
                    const float* __restrict__ kcos,
                    const float* __restrict__ ksin, float* __restrict__ dq,
                    Strides st, int H, int Nq, int Nk, float scale) {
  using L = Smem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  L sm;
  sm.init(smem);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const long long bh_ = (long long)b * H + h;
  const float* bhp = bias ? bias + b * st.bb + h * st.bh : nullptr;
  const float* kb = kbias ? kbias + (long long)b * Nk : nullptr;
  const T* kh = k + b * st.kb + h * st.kh;
  const T* vh = v + b * st.vb + h * st.vh;

  // a: q (rotated), b: do; c: k (rotated), d: v per key tile
  load_rows<T, D>(sm.a, q + b * st.qb + h * st.qh, st.qn, qcos, qsin,
                  (long long)b * Nq, i0, Nq);
  load_rows<T, D>(sm.b, g + b * st.gb + h * st.gh, st.gn, nullptr, nullptr, 0,
                  i0, Nq);
  load_row_stats<T, D>(sm, lse + bh_ * Nq, dvec + bh_ * Nq, i0, Nq);
  Acc<T, D> acc;
  acc.zero();

  for (int j0 = 0; j0 < Nk; j0 += BK) {
    if (!load_key_bias<T, D>(sm, kb, j0, Nk)) continue;
    load_rows<T, D>(sm.c, kh, st.kn, kcos, ksin, (long long)b * Nk, j0, Nk);
    load_rows<T, D>(sm.d, vh, st.vn, nullptr, nullptr, 0, j0, Nk);
    __syncthreads();
    abt<T, D>(sm.a, sm.c, sm.s, w, lane);
    abt<T, D>(sm.b, sm.d, sm.dp, w, lane);
    probs<T, D>(sm, bhp, st, i0, j0, Nq, Nk, scale, w, lane);
    acc_pb<false, T, D>(acc, sm.ds, L::LDP, sm.c, w, lane);
    __syncthreads();
  }
  store_acc<T, D>(acc, sm.stage, dq + bh_ * Nq * D, i0, Nq, w, lane);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ g,
                      const float* __restrict__ lse,
                      const float* __restrict__ dvec,
                      const float* __restrict__ bias,
                      const float* __restrict__ kbias,
                      const float* __restrict__ qcos,
                      const float* __restrict__ qsin,
                      const float* __restrict__ kcos,
                      const float* __restrict__ ksin, float* __restrict__ dk,
                      float* __restrict__ dv, Strides st, int H, int Nq,
                      int Nk, float scale) {
  using L = Smem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  L sm;
  sm.init(smem);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const long long bh_ = (long long)b * H + h;
  const float* bhp = bias ? bias + b * st.bb + h * st.bh : nullptr;
  const float* kb = kbias ? kbias + (long long)b * Nk : nullptr;
  const T* qh = q + b * st.qb + h * st.qh;
  const T* gh = g + b * st.gb + h * st.gh;

  // a: k (rotated), b: v of this key tile; c: q (rotated), d: do per query
  // tile
  load_rows<T, D>(sm.a, k + b * st.kb + h * st.kh, st.kn, kcos, ksin,
                  (long long)b * Nk, j0, Nk);
  load_rows<T, D>(sm.b, v + b * st.vb + h * st.vh, st.vn, nullptr, nullptr, 0,
                  j0, Nk);
  Acc<T, D> acc_k, acc_v;
  acc_k.zero();
  acc_v.zero();
  if (load_key_bias<T, D>(sm, kb, j0, Nk)) {
    for (int i0 = 0; i0 < Nq; i0 += BQ) {
      load_rows<T, D>(sm.c, qh, st.qn, qcos, qsin, (long long)b * Nq, i0, Nq);
      load_rows<T, D>(sm.d, gh, st.gn, nullptr, nullptr, 0, i0, Nq);
      load_row_stats<T, D>(sm, lse + bh_ * Nq, dvec + bh_ * Nq, i0, Nq);
      __syncthreads();
      abt<T, D>(sm.c, sm.a, sm.s, w, lane);
      abt<T, D>(sm.d, sm.b, sm.dp, w, lane);
      probs<T, D>(sm, bhp, st, i0, j0, Nq, Nk, scale, w, lane);
      __syncthreads();
      acc_pb<true, T, D>(acc_v, sm.p, L::LDP, sm.d, w, lane);
      acc_pb<true, T, D>(acc_k, sm.ds, L::LDP, sm.c, w, lane);
      __syncthreads();
    }
  }
  store_acc<T, D>(acc_k, sm.stage, dk + bh_ * Nk * D, j0, Nk, w, lane);
  store_acc<T, D>(acc_v, sm.stage, dv + bh_ * Nk * D, j0, Nk, w, lane);
}

// The arguments both entries share.
struct Args {
  const void *q, *k, *v, *g, *lse, *dvec, *bias, *kbias, *qcos, *qsin, *kcos,
      *ksin;
  Strides st;
  int B, H, Nq, Nk;
  float scale;
  cudaStream_t stream;
};

static Args make_args(const void* q, const void* k, const void* v,
                      const void* g, const void* lse, const void* dvec,
                      const void* bias, const void* kbias, const void* qcos,
                      const void* qsin, const void* kcos, const void* ksin,
                      const long long* s, int B, int H, int Nq, int Nk,
                      float scale, void* stream) {
  return Args{q, k, v, g, lse, dvec, bias, kbias, qcos, qsin, kcos, ksin,
              Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
                      s[9], s[10], s[11], s[12], s[13], s[14], s[15]},
              B, H, Nq, Nk, scale, static_cast<cudaStream_t>(stream)};
}

#define P3_BWD_PTRS(T)                                                      \
  static_cast<const T*>(a.q), static_cast<const T*>(a.k),                   \
      static_cast<const T*>(a.v), static_cast<const T*>(a.g),               \
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dvec),  \
      static_cast<const float*>(a.bias), static_cast<const float*>(a.kbias), \
      static_cast<const float*>(a.qcos), static_cast<const float*>(a.qsin), \
      static_cast<const float*>(a.kcos), static_cast<const float*>(a.ksin)

template <typename T, int D>
static cudaError_t launch_dq(const Args& a, float* dq) {
  auto kern = flash_bwd_dq_kernel<T, D>;
  const int bytes = Smem<T, D>::kBytes;
  cudaError_t err = prepare(kern, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Nq + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, NTHREADS, bytes, a.stream>>>(P3_BWD_PTRS(T), dq, a.st, a.H,
                                            a.Nq, a.Nk, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
static cudaError_t launch_dkdv(const Args& a, float* dk, float* dv) {
  auto kern = flash_bwd_dkdv_kernel<T, D>;
  const int bytes = Smem<T, D>::kBytes;
  cudaError_t err = prepare(kern, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Nk + BK - 1) / BK, a.H, a.B);
  kern<<<grid, NTHREADS, bytes, a.stream>>>(P3_BWD_PTRS(T), dk, dv, a.st, a.H,
                                            a.Nq, a.Nk, a.scale);
  return cudaGetLastError();
}

P3_ERROR_STRING_FN

#define P3_BWD_ARGS                                                          \
  const void *q, const void *k, const void *v, const void *g,                \
      const void *lse, const void *dvec, const void *bias, const void *kbias, \
      const void *qcos, const void *qsin, const void *kcos, const void *ksin
#define P3_BWD_MAKE                                                          \
  make_args(q, k, v, g, lse, dvec, bias, kbias, qcos, qsin, kcos, ksin,      \
            strides, B, H, Nq, Nk, scale, stream)

// bf16 q (B, H, Nq, D), k/v (B, H, Nk, D) and do (B, H, Nq, D) through
// the element strides in strides[0..11] (q, k, v, do: batch, head,
// token); lse and dvec (B, H, Nq) f32; bias: dense f32 bias through
// strides[12..15] (batch, head, query, key) or null; kbias (B, Nk) f32 or
// null; tables (B, N, D) f32, all four or none.  dq (B, H, Nq, D) f32.
// Built for D = 64 and 96.
extern "C" int p3_flash_bwd_dq(P3_BWD_ARGS, void* dq, const long long* strides,
                               int B, int H, int Nq, int Nk, int D,
                               float scale, void* stream) {
  const Args a = P3_BWD_MAKE;
  float* out = static_cast<float*>(dq);
  if (D == 64) return launch_dq<__nv_bfloat16, 64>(a, out);
  if (D == 96) return launch_dq<__nv_bfloat16, 96>(a, out);
  return cudaErrorInvalidValue;
}

// As p3_flash_bwd_dq; dk and dv (B, H, Nk, D) f32.
extern "C" int p3_flash_bwd_dkdv(P3_BWD_ARGS, void* dk, void* dv,
                                 const long long* strides, int B, int H,
                                 int Nq, int Nk, int D, float scale,
                                 void* stream) {
  const Args a = P3_BWD_MAKE;
  float* ok = static_cast<float*>(dk);
  float* ov = static_cast<float*>(dv);
  if (D == 64) return launch_dkdv<__nv_bfloat16, 64>(a, ok, ov);
  if (D == 96) return launch_dkdv<__nv_bfloat16, 96>(a, ok, ov);
  return cudaErrorInvalidValue;
}
