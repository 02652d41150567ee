// K2 — memory cross-attention over projected (B, Nq, C) x (B, Nk, C).
//
// Replaces panst3r_tpu/ops/pallas/tower_attention.py::_cross_fwd (body
// _cross_kernel), bf16/f32 path: per d=64 head, q and k get their own 2D-RoPE
// (cos, sin) tables in f32, the softmax scale is applied to q after the
// rotation (q is rounded to its dtype once, rotated and scaled), a per-key
// additive bias (B, Nk) in f32 (the memory validity) joins the logits, and a
// key tile whose bias is all <= finfo.min/2 is skipped entirely (no loads,
// no products).  Rows that saw no live key write 0.  The opt-in int8 score
// path of the JAX package (PANST3R_KV_INT8) is not ported.
//
// Bound on the H100: at the render shape (Nq = 3072, Nk = 3072, H = 12,
// d=64) the work is 4*Nq*Nk*C = 29 GFLOP against ~19 MB of bf16 traffic,
// so it is bound by operations; tile skipping removes the dead memory slots
// of a partly filled memory from both.  Design as K1: 64x64 tiles, online
// softmax, WMMA bf16 products with f32 accumulation.
#include "attn_tile.cuh"

using namespace p3;

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
tower_cross_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ qcos,
                   const float* __restrict__ qsin,
                   const float* __restrict__ kcos,
                   const float* __restrict__ ksin,
                   const float* __restrict__ bias, T* __restrict__ out,
                   int Nq, int Nk, int C, float scale) {
  constexpr int D = 64;
  using TL = Tile<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  TL t;
  t.init(smem);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + (long)b * Nq * C + h * D;
  const T* kb = k + (long)b * Nk * C + h * D;
  const T* vb = v + (long)b * Nk * C + h * D;
  const float* bb = bias ? bias + (long)b * Nk : nullptr;
  const bool rope = qcos != nullptr;

  for (int e = threadIdx.x; e < BQ * D; e += NTHREADS) {
    const int r = e / D, d = e % D, i = q0 + r;
    float x = 0.f;
    if (i < Nq) {
      const long ti = ((long)b * Nq + i) * D;
      x = scale * load_rope(qb + (long)i * C, rope ? qcos + ti : nullptr,
                            rope ? qsin + ti : nullptr, d);
    }
    t.q[r * TL::LD + d] = from_f<T>(x);
  }

  for (int k0 = 0; k0 < Nk; k0 += BK) {
    // Tile liveness: any key in range whose bias is above finfo.min/2.
    int live = 0;
    for (int c = threadIdx.x; c < BK; c += NTHREADS) {
      const int j = k0 + c;
      const float bj = (j < Nk) ? (bb ? bb[j] : 0.f) : NEG;
      t.kbias[c] = bj;
      live |= bj > 0.5f * NEG;
    }
    if (!__syncthreads_or(live)) continue;

    for (int e = threadIdx.x; e < BK * D; e += NTHREADS) {
      const int r = e / D, d = e % D, j = k0 + r;
      float x = 0.f;
      T vv = from_f<T>(0.f);
      if (j < Nk) {
        const long tj = ((long)b * Nk + j) * D;
        x = load_rope(kb + (long)j * C, rope ? kcos + tj : nullptr,
                      rope ? ksin + tj : nullptr, d);
        vv = vb[(long)j * C + d];
      }
      t.k[r * TL::LD + d] = from_f<T>(x);
      t.v[r * TL::LD + d] = vv;
    }
    __syncthreads();
    t.scores();
    t.softmax([&](int, int c, float raw) { return raw + t.kbias[c]; });
    t.accumulate();
    __syncthreads();
  }

  t.finish([&](int r, int d, float val) {
    const int i = q0 + r;
    if (i < Nq) out[((long)b * Nq + i) * C + h * D + d] = from_f<T>(val);
  });
}

template <typename T>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          const void* qcos, const void* qsin, const void* kcos,
                          const void* ksin, const void* bias, void* out, int B,
                          int Nq, int Nk, int C, float scale,
                          cudaStream_t stream) {
  auto kern = tower_cross_kernel<T>;
  const int bytes = Tile<T, 64>::kBytes;
  cudaError_t err = prepare(kern, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + BQ - 1) / BQ, C / 64, B);
  kern<<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(qcos),
      static_cast<const float*>(qsin), static_cast<const float*>(kcos),
      static_cast<const float*>(ksin), static_cast<const float*>(bias),
      static_cast<T*>(out), Nq, Nk, C, scale);
  return cudaGetLastError();
}

P3_ERROR_STRING_FN

// q (B, Nq, C); k/v (B, Nk, C); q/k tables (B, N, 64) f32 or all null;
// bias (B, Nk) f32 or null; out (B, Nq, C).
extern "C" int p3_tower_cross(const void* q, const void* k, const void* v,
                              const void* qcos, const void* qsin,
                              const void* kcos, const void* ksin,
                              const void* bias, void* out, int B, int Nq,
                              int Nk, int C, float scale, int bf16,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, qcos, qsin, kcos, ksin, bias,
                                      out, B, Nq, Nk, C, scale, s)
              : launch<float>(q, k, v, qcos, qsin, kcos, ksin, bias, out, B,
                              Nq, Nk, C, scale, s);
}
