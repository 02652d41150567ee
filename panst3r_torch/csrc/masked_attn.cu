// K3, f32 — block-sparse masked attention of the mask transformer.
//
// Replaces panst3r_tpu/ops/pallas/masked_attention.py::_sparse_fwd (body
// _kernel), f32: q (B, H, Nq, D), k/v (B, H, Nk, D) and a (B, Nq, Nk)
// blocked mask (1 = may not attend) shared across heads.  The wrapper
// builds the visit plan on the device (plan_blocks: per (batch, 64-query
// block) the live 64-key blocks first, ascending, and their count); each
// thread block reads its own list, loads only the live key tiles, applies
// the fine mask inside each tile and runs an online softmax.  Rows with no
// live key write 0.  The bf16 path runs on the Hopper engine
// (masked_attn_sm90.cu); this file is the f32 path, which the f32 limit of
// 1e-4 keeps off TF32 products.
//
// Bound on the H100: at the main-path shape (B=1, H=8, Nq=200, Nk=3072,
// D=96) the live work is 4*H*tiles*64*64*96 = 2.4 GFLOP against ~26 MB:
// 0.036 ms by operations at 67 TFLOP/s f32.  Only 4 q-tiles x 8 heads = 32
// blocks run per batch element: the grid cannot fill 132 SMs at this shape
// (the bf16 kernel splits over key tiles instead).
#include "attn_tile.cuh"

using namespace p3;

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
masked_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const uint8_t* __restrict__ mask,
                   const int* __restrict__ kv_idx,
                   const int* __restrict__ count, T* __restrict__ out, int H,
                   int Nq, int Nk, int nkb, float scale) {
  using TL = Tile<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  TL t;
  t.init(smem);
  const int qblk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qblk * BQ;
  const long bh = (long)b * H + h;
  const T* qh = q + bh * Nq * D;
  const T* kh = k + bh * Nk * D;
  const T* vh = v + bh * Nk * D;
  const uint8_t* mb = mask + (long)b * Nq * Nk;
  const long plan = (long)b * gridDim.x + qblk;
  const int cnt = count[plan];
  const int* list = kv_idx + plan * nkb;

  for (int e = threadIdx.x; e < BQ * D; e += NTHREADS) {
    const int r = e / D, d = e % D, i = q0 + r;
    t.q[r * TL::LD + d] = (i < Nq) ? qh[(long)i * D + d] : from_f<T>(0.f);
  }

  for (int it = 0; it < cnt; ++it) {
    const int k0 = list[it] * BK;
    for (int e = threadIdx.x; e < BK * D; e += NTHREADS) {
      const int r = e / D, d = e % D, j = k0 + r;
      const bool in = j < Nk;
      t.k[r * TL::LD + d] = in ? kh[(long)j * D + d] : from_f<T>(0.f);
      t.v[r * TL::LD + d] = in ? vh[(long)j * D + d] : from_f<T>(0.f);
    }
    for (int e = threadIdx.x; e < BQ * BK; e += NTHREADS) {
      const int r = e / BK, c = e % BK, i = q0 + r, j = k0 + c;
      t.mask[e] = (i < Nq && j < Nk) ? mb[(long)i * Nk + j] : 1;
    }
    __syncthreads();
    t.scores();
    t.softmax([&](int r, int c, float raw) {
      return t.mask[r * BK + c] ? NEG : raw * scale;
    });
    t.accumulate();
    __syncthreads();
  }

  t.finish([&](int r, int d, float val) {
    const int i = q0 + r;
    if (i < Nq) out[(bh * Nq + i) * D + d] = from_f<T>(val);
  });
}

template <typename T, int D>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          const void* mask, const void* kv_idx,
                          const void* count, void* out, int B, int H, int Nq,
                          int Nk, float scale, cudaStream_t stream) {
  auto kern = masked_attn_kernel<T, D>;
  const int bytes = Tile<T, D>::kBytes;
  cudaError_t err = prepare(kern, bytes);
  if (err != cudaSuccess) return err;
  const int nqb = (Nq + BQ - 1) / BQ, nkb = (Nk + BK - 1) / BK;
  dim3 grid(nqb, H, B);
  kern<<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const int*>(kv_idx), static_cast<const int*>(count),
      static_cast<T*>(out), H, Nq, Nk, nkb, scale);
  return cudaGetLastError();
}

P3_ERROR_STRING_FN

// q (B, H, Nq, D); k/v (B, H, Nk, D) f32; mask (B, Nq, Nk) uint8, 1 =
// blocked; kv_idx (B, ceil(Nq/64), ceil(Nk/64)) int32 live key blocks
// first; count (B, ceil(Nq/64)) int32; out (B, H, Nq, D).  Built for D = 96
// only, the head dim of the v1 mask transformer (the one caller).
extern "C" int p3_masked_attn(const void* q, const void* k, const void* v,
                              const void* mask, const void* kv_idx,
                              const void* count, void* out, int B, int H,
                              int Nq, int Nk, int D, float scale,
                              void* stream) {
  if (D != 96) return cudaErrorInvalidValue;
  return launch<float, 96>(q, k, v, mask, kv_idx, count, out, B, H, Nq, Nk,
                           scale, static_cast<cudaStream_t>(stream));
}
