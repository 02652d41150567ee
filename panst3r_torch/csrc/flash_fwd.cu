// K4, bf16 — generic flash attention forward over (B, H, N, D) streams.
// The f32 K4, the dtype of every launch on the main paths, is
// flash_fwd_sm90.cu (the Hopper f32 engine).
//
// Replaces panst3r_tpu/ops/pallas/flash_attention.py::_flash_fwd (body
// _kernel) in bf16: online-softmax attention with, each optional,
// - a dense additive bias, read through its own strides (a head- or
//   batch-broadcast bias is never materialized);
// - a per-key additive bias row (B, Nk) in f32: the (B|1, 1, 1, Nk) bias and
//   the key-validity mask both arrive folded into it (0 / finfo.min), and a
//   key tile whose row is all <= finfo.min/2 is skipped block-wide;
// - 2D-RoPE (cos, sin) tables (B, N, D) in f32 shared by the heads of a
//   batch: q is rotated once in f32 and rounded to its dtype, each k tile
//   likewise as it is loaded (rotate-half within each D/2-wide half);
// - the natural-log LSE per row (finfo.min for a row with no live key).
// The softmax scale multiplies the f32 score (q is not pre-scaled), the
// bias is added after it, the row sum takes the unrounded f32 p and only
// the value product takes p rounded to v's dtype, as in the Pallas kernel.
// Rows with no live key write 0.
//
// q/k/v/out are addressed through (batch, head, token) strides with a unit
// stride over D, so the split-heads views of a (B, N, H*D) projection are
// read in place and the output lands in (B, Nq, H, D) order, which makes
// the caller's merge of the heads a free reshape.
//
// Bound on the H100: at the v2 LoftUp shape (B=4, H=4, Nq=49152, Nk=768,
// D=96) the work is 4*B*H*Nq*Nk*D = 232 GFLOP against ~0.15 GB of bf16 q
// and out traffic, so it is bound by operations: 0.23 ms at the 989
// TFLOP/s bf16 rate.  The products run on WMMA through the shared
// 64x64-tile engine (attn_tile.cuh); 768 query tiles per (batch, head)
// fill the card.  No path launches it: it runs in the kernels phase of
// chip_smoke.py and the CUDA tests.
#include "attn_tile.cuh"

using namespace p3;

// Element strides: q, k, v, out by (batch, head, token); the dense bias by
// (batch, head, query, key), 0 where it is broadcast.
struct Strides {
  long long qb, qh, qn, kb, kh, kn, vb, vh, vn, ob, oh, on, bb, bh, bq, bk;
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 const float* __restrict__ kbias,
                 const float* __restrict__ qcos, const float* __restrict__ qsin,
                 const float* __restrict__ kcos, const float* __restrict__ ksin,
                 T* __restrict__ out, float* __restrict__ lse, Strides st,
                 int H, int Nq, int Nk, float scale) {
  using TL = Tile<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  TL t;
  t.init(smem);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const T* qh = q + b * st.qb + h * st.qh;
  const T* kh = k + b * st.kb + h * st.kh;
  const T* vh = v + b * st.vb + h * st.vh;
  const float* bh = bias ? bias + b * st.bb + h * st.bh : nullptr;
  const float* kb = kbias ? kbias + (long long)b * Nk : nullptr;
  const bool rope = qcos != nullptr;

  for (int e = threadIdx.x; e < BQ * D; e += NTHREADS) {
    const int r = e / D, d = e % D, i = q0 + r;
    float x = 0.f;
    if (i < Nq) {
      const long long ti = ((long long)b * Nq + i) * D;
      x = rope_at<D>(qh + i * st.qn, rope ? qcos + ti : nullptr,
                     rope ? qsin + ti : nullptr, d);
    }
    t.q[r * TL::LD + d] = from_f<T>(x);
  }

  for (int k0 = 0; k0 < Nk; k0 += BK) {
    // Per-key bias of the tile (finfo.min past Nk) and its liveness.
    int live = 0;
    for (int c = threadIdx.x; c < BK; c += NTHREADS) {
      const int j = k0 + c;
      const float bj = (j < Nk) ? (kb ? kb[j] : 0.f) : NEG;
      t.kbias[c] = bj;
      live |= bj > 0.5f * NEG;
    }
    if (!__syncthreads_or(live)) continue;

    for (int e = threadIdx.x; e < BK * D; e += NTHREADS) {
      const int r = e / D, d = e % D, j = k0 + r;
      float x = 0.f;
      T vv = from_f<T>(0.f);
      if (j < Nk) {
        const long long tj = ((long long)b * Nk + j) * D;
        x = rope_at<D>(kh + j * st.kn, rope ? kcos + tj : nullptr,
                       rope ? ksin + tj : nullptr, d);
        vv = vh[j * st.vn + d];
      }
      t.k[r * TL::LD + d] = from_f<T>(x);
      t.v[r * TL::LD + d] = vv;
    }
    __syncthreads();
    t.scores();
    // Logits of this warp's 16 rows, in place: score * scale + per-key bias
    // (+ dense bias, read along the keys so a warp's loads coalesce).
    for (int e = t.lane; e < 16 * BK; e += 32) {
      const int r = t.w * 16 + e / BK, c = e % BK;
      const int i = q0 + r, j = k0 + c;
      float x = t.s[r * TL::LDS + c] * scale + t.kbias[c];
      if (bh != nullptr && i < Nq && j < Nk) x += bh[i * st.bq + j * st.bk];
      t.s[r * TL::LDS + c] = x;
    }
    __syncwarp();
    t.template softmax<false>([](int, int, float x) { return x; });
    t.accumulate();
    __syncthreads();
  }

  t.finish([&](int r, int d, float val) {
    const int i = q0 + r;
    if (i < Nq) out[b * st.ob + h * st.oh + i * st.on + d] = from_f<T>(val);
  });
  if (lse != nullptr && (t.lane & 1) == 0) {
    const int i = q0 + t.w * 16 + (t.lane >> 1);
    if (i < Nq)
      lse[((long long)b * H + h) * Nq + i] =
          (t.m <= 0.5f * NEG) ? NEG : t.m + logf(t.l);
  }
}

template <typename T, int D>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          const void* bias, const void* kbias,
                          const void* qcos, const void* qsin, const void* kcos,
                          const void* ksin, void* out, void* lse,
                          const Strides& st, int B, int H, int Nq, int Nk,
                          float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D>;
  const int bytes = Tile<T, D>::kBytes;
  cudaError_t err = prepare(kern, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + BQ - 1) / BQ, H, B);
  kern<<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(kbias), static_cast<const float*>(qcos),
      static_cast<const float*>(qsin), static_cast<const float*>(kcos),
      static_cast<const float*>(ksin), static_cast<T*>(out),
      static_cast<float*>(lse), st, H, Nq, Nk, scale);
  return cudaGetLastError();
}

P3_ERROR_STRING_FN

// bf16 q (B, H, Nq, D), k/v (B, H, Nk, D) and out (B, H, Nq, D) through
// the element strides in strides[0..11] (q, k, v, out: batch, head, token);
// bias: dense f32 bias through strides[12..15] (batch, head, query, key) or
// null; kbias (B, Nk) f32 or null; tables (B, N, D) f32, all four or none;
// lse (B, H, Nq) f32 or null.  Built for D = 64 and 96.
extern "C" int p3_flash_fwd(const void* q, const void* k, const void* v,
                            const void* bias, const void* kbias,
                            const void* qcos, const void* qsin,
                            const void* kcos, const void* ksin, void* out,
                            void* lse, const long long* strides, int B, int H,
                            int Nq, int Nk, int D, float scale,
                            void* stream) {
  const long long* s = strides;
  const Strides st{s[0], s[1], s[2],  s[3],  s[4],  s[5],  s[6],  s[7],
                   s[8], s[9], s[10], s[11], s[12], s[13], s[14], s[15]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
#define P3_FLASH_ARGS \
  q, k, v, bias, kbias, qcos, qsin, kcos, ksin, out, lse, st, B, H, Nq, Nk, \
      scale, cs
  if (D == 64) return launch<__nv_bfloat16, 64>(P3_FLASH_ARGS);
  if (D == 96) return launch<__nv_bfloat16, 96>(P3_FLASH_ARGS);
#undef P3_FLASH_ARGS
  return cudaErrorInvalidValue;
}
