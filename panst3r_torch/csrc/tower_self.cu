// K1, f32 — tower self-attention straight from the fused qkv projection
// (the bf16 path is tower_self_sm90.cu).
//
// Replaces panst3r_tpu/ops/pallas/tower_attention.py::_tower_fwd (body
// _kernel): softmax(q k^T * scale) v per d=64 head, q/k/v read out of the
// (B, N, 3C) projection at column offsets h*64, C + h*64 and 2C + h*64
// (row stride 3C) and the output written to (B, N, C) at column h*64, so
// no (B, N, C) -> (B, H, N, 64) relayout exists on either side.
// Optional: 2D-RoPE from f32 (cos, sin) tables (B, N, 64) applied to q and
// k in f32 at load; a cls key/value (B, 1, C) that joins every query's
// softmax as one extra column (DINO split-cls).
//
// Bound on the H100: at the encoder shape (B=4, N=768, H=16, d=64) the
// work is 4*B*H*N^2*d = 9.7 GFLOP against 2*B*N*3C + ... ~25 MB of bf16
// traffic, so it is bound by operations (the tensor cores), not bytes.
// Design: tiles of 64 queries x 64 keys with an online softmax (a 768-key
// K+V block in shared memory would leave one block per SM), plain f32 FMA
// products (full f32: the tensor cores would need TF32, which the 1e-4
// f32 limits do not allow).
#include "attn_tile.cuh"

using namespace p3;

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
tower_self_kernel(const T* __restrict__ qkv, const float* __restrict__ cosb,
                  const float* __restrict__ sinb, const T* __restrict__ kc,
                  const T* __restrict__ vc, T* __restrict__ out, int N, int C,
                  float scale) {
  constexpr int D = 64;
  using TL = Tile<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  TL t;
  t.init(smem);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const long row3 = 3L * C;
  const T* base = qkv + (long)b * N * row3;
  const float* cb = cosb ? cosb + (long)b * N * D : nullptr;
  const float* sb = sinb ? sinb + (long)b * N * D : nullptr;

  for (int e = threadIdx.x; e < BQ * D; e += NTHREADS) {
    const int r = e / D, d = e % D, i = q0 + r;
    float x = 0.f;
    if (i < N)
      x = load_rope(base + i * row3 + h * D, cb ? cb + (long)i * D : nullptr,
                    sb ? sb + (long)i * D : nullptr, d);
    t.q[r * TL::LD + d] = from_f<T>(x);
  }
  if (kc != nullptr) {
    for (int d = threadIdx.x; d < D; d += NTHREADS) {
      t.kc[d] = to_f(kc[(long)b * C + h * D + d]);
      t.vc[d] = to_f(vc[(long)b * C + h * D + d]);
    }
  }
  __syncthreads();
  if (kc != nullptr) t.init_cls(scale);

  for (int k0 = 0; k0 < N; k0 += BK) {
    for (int e = threadIdx.x; e < BK * D; e += NTHREADS) {
      const int r = e / D, d = e % D, j = k0 + r;
      float x = 0.f;
      T vv = from_f<T>(0.f);
      if (j < N) {
        const T* row = base + j * row3;
        x = load_rope(row + C + h * D, cb ? cb + (long)j * D : nullptr,
                      sb ? sb + (long)j * D : nullptr, d);
        vv = row[2 * C + h * D + d];
      }
      t.k[r * TL::LD + d] = from_f<T>(x);
      t.v[r * TL::LD + d] = vv;
    }
    __syncthreads();
    t.scores();
    t.softmax([&](int, int c, float raw) {
      return (k0 + c < N) ? raw * scale : NEG;
    });
    t.accumulate();
    __syncthreads();
  }

  t.finish([&](int r, int d, float val) {
    const int i = q0 + r;
    if (i < N) out[((long)b * N + i) * C + h * D + d] = from_f<T>(val);
  });
}

template <typename T>
static cudaError_t launch(const void* qkv, const void* cosb, const void* sinb,
                          const void* kc, const void* vc, void* out, int B,
                          int N, int C, float scale, cudaStream_t stream) {
  auto kern = tower_self_kernel<T>;
  const int bytes = Tile<T, 64>::kBytes;
  cudaError_t err = prepare(kern, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, C / 64, B);
  kern<<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(cosb),
      static_cast<const float*>(sinb), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<T*>(out), N, C, scale);
  return cudaGetLastError();
}

P3_ERROR_STRING_FN

// qkv (B, N, 3C) f32; cos/sin (B, N, 64) f32 or null; kc/vc (B, 1, C) or
// null; out (B, N, C).
extern "C" int p3_tower_self(const void* qkv, const void* cosb,
                             const void* sinb, const void* kc, const void* vc,
                             void* out, int B, int N, int C, float scale,
                             void* stream) {
  return launch<float>(qkv, cosb, sinb, kc, vc, out, B, N, C, scale,
                       static_cast<cudaStream_t>(stream));
}
