// K2-int8, f32 — memory cross-attention with int8 x int8 -> int32 scores
// on the tile engine (attn_tile.cuh).  The bf16 branch, the one the serving
// path runs, is tower_cross_int8_sm90.cu (the Hopper engine).
//
// Replaces the kv_int8 branch of
// panst3r_tpu/ops/pallas/tower_attention.py::_cross_fwd (body _cross_kernel,
// the `int8` paths) in f32: the opt-in serving precision (PANST3R_KV_INT8=1)
// that the JAX package engages for render-scale query counts (Nq >= 16384).
//
// The caller (ops/tower_attention.py::int8_prepare, plain torch on the
// device, as the JAX package prepares it outside pallas_call) hands in:
// - k8 (B, Nk, C) int8: k rotated in f32 with its 2D-RoPE tables and
//   quantized per tensor, k8 = round_half_even(k_rot / sk),
//   sk = max(max|k_rot|, 1e-20) / 127 over batch, heads and keys;
// - q tables (B, Nq, 64) f32 pre-multiplied by scale * log2(e) * sk;
// - kb (B, Nk) f32 = kv_bias * log2(e) (ops/tower_attention.py::
//   int8_log2_bias), or null.
//
// Here, per query row: q is rotated in f32 with those tables over the
// 128 lanes of its head pair, amax = max(max|q_rot|, 1e-20) over the PAIR
// (the Pallas lane-block layout, which decides q8), q8 = rint(q_rot *
// (127 / amax)) and c = amax * (1 / 127).  For each live 64-key tile the
// int8 products run on the tensor cores (WMMA 16x16x16 signed char, int32
// accumulate); the stabilizer is m = max(m_prev, rowmax_int32(s) * c) (the
// bias left out: any m >= the row max of the logits is valid because
// kb <= 0), p = exp2(s * c + kb - m) (f32: no rounding) into both the row
// sum and p.v (the shared engine's rescale and FMA p.v), and rows that saw
// no live key write 0.  A key tile whose kb is all <= finfo.min/2 is
// skipped.  The f32 operations that decide q8 and the logits are written
// with the _rn intrinsics so that nvcc contracts none of them into an FMA:
// q8 equals the Pallas branch's bit for bit.
//
// Bound on the H100 at the long render shape (Nq = 38400, Nk = 12288,
// C = 768): 7.25e11 int8 operations for the scores (0.37 ms at 1979
// TOP/s) and 7.25e11 f32 FLOPs for p.v against ~0.3 GB of traffic: bound
// by the f32 p.v.  Design: the tile engine's 64x64 tiles and block loop,
// one block per (query tile, head, batch); the int8 operands live in the
// engine's unused q/k buffers as four 16-byte-wide column planes, so every
// WMMA fragment pointer is 256-bit aligned.  No path runs it in f32.
#include <mma.h>

#include <climits>

#include "attn_tile.cuh"

using namespace p3;

namespace {

constexpr int D = 64;

// q8/k8 element (row, d) of a 64-wide head slice in the plane layout
// [d / 16][row][d % 16].
__device__ __forceinline__ int plane_at(int row, int d, int rows) {
  return ((d >> 4) * rows + row) * 16 + (d & 15);
}

// s[r][c] = q8[r] . k8[c] (int32) for this warp's 16 rows.
__device__ __forceinline__ void int8_scores(const int8_t* q8,
                                            const int8_t* k8, int* s,
                                            int lds, int w) {
  using namespace nvcuda;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> c;
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    wmma::fill_fragment(c, 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::load_matrix_sync(
          a, reinterpret_cast<const signed char*>(q8) + (kk * BQ + w * 16) * 16,
          16);
      wmma::load_matrix_sync(
          b, reinterpret_cast<const signed char*>(k8) + (kk * BK + n * 16) * 16,
          16);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(s + (w * 16) * lds + n * 16, c, lds,
                            wmma::mem_row_major);
  }
  __syncwarp();
}

// Online-softmax step of the int8 path (two lanes per row, 32 keys each):
// the stabilizer tracks rowmax(s) * c, the logit is s * c + kb, exp2.
__device__ __forceinline__ void int8_softmax(Tile<D>& t, const float* crow) {
  using TL = Tile<D>;
  const int r = t.w * 16 + (t.lane >> 1);
  const int c0 = (t.lane & 1) * 32;
  const int* srow = reinterpret_cast<const int*>(t.s) + r * TL::LDS;
  int mx = INT_MIN;
#pragma unroll 8
  for (int j = 0; j < 32; ++j) mx = max(mx, srow[c0 + j]);
  mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  const float c = crow[r];
  const float m_new = fmaxf(t.m, __fmul_rn(static_cast<float>(mx), c));
  const float safe = (m_new <= 0.5f * NEG) ? 0.f : m_new;
  float* prow = t.p + r * TL::LDP;  // the same words as srow
  float sum = 0.f;
#pragma unroll 8
  for (int j = 0; j < 32; ++j) {
    const float sf = __fadd_rn(__fmul_rn(static_cast<float>(srow[c0 + j]), c),
                               t.kbias[c0 + j]);
    const float pt = exp2f(__fsub_rn(sf, safe));
    prow[c0 + j] = pt;
    sum += pt;
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  const float a = (t.m <= 0.5f * NEG) ? 0.f : exp2f(__fsub_rn(t.m, safe));
  t.l = t.l * a + sum;
  t.m = m_new;
  if ((t.lane & 1) == 0) t.alpha[r] = a;
  __syncwarp();
}

}  // namespace

__global__ void __launch_bounds__(NTHREADS)
tower_cross_int8_kernel(const float* __restrict__ q,
                        const int8_t* __restrict__ k8,
                        const float* __restrict__ v,
                        const float* __restrict__ qcos,
                        const float* __restrict__ qsin,
                        const float* __restrict__ kb,
                        float* __restrict__ out,
                        int Nq, int Nk, int C) {
  using TL = Tile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  TL t;
  t.init(smem);
  // The engine's q and k buffers hold the int8 planes here, its per-row
  // buffer the dequantization scale c.
  int8_t* q8 = reinterpret_cast<int8_t*>(t.q);
  int8_t* k8s = reinterpret_cast<int8_t*>(t.k);
  float* crow = t.crow;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int pair = h >> 1, own = h & 1;

  // q: rotate the pair's 128 lanes in f32, amax over the pair, quantize.
  for (int rr = 0; rr < 16; ++rr) {
    const int r = t.w * 16 + rr, i = q0 + r;
    float x[4];
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = 0.f;
    if (i < Nq) {
      const long ri = (long)b * Nq + i;
      const float* row = q + ri * C + pair * 128;
      const float* cs = qcos + ri * D;
      const float* sn = qsin + ri * D;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l = t.lane + 32 * j, d = l & 63;
        const float xq = row[l];
        const float xp = row[(l & ~63) | (d ^ 16)];
        const float rot = (d & 16) ? xp : -xp;
        x[j] = __fadd_rn(__fmul_rn(xq, cs[d]), __fmul_rn(rot, sn[d]));
        amax = fmaxf(amax, fabsf(x[j]));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    amax = fmaxf(amax, 1e-20f);
    const float inv = __fdiv_rn(127.0f, amax);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = t.lane + 32 * j;
      if ((l >> 6) == own)
        q8[plane_at(r, l & 63, BQ)] =
            static_cast<int8_t>(__float2int_rn(__fmul_rn(x[j], inv)));
    }
    if (t.lane == 0) crow[r] = __fmul_rn(amax, (float)(1.0 / 127.0));
  }
  __syncthreads();

  const float* kbb = kb ? kb + (long)b * Nk : nullptr;
  for (int k0 = 0; k0 < Nk; k0 += BK) {
    int live = 0;
    for (int c = threadIdx.x; c < BK; c += NTHREADS) {
      const int j = k0 + c;
      const float bj = (j < Nk) ? (kbb ? kbb[j] : 0.f) : NEG;
      t.kbias[c] = bj;
      live |= bj > 0.5f * NEG;
    }
    if (!__syncthreads_or(live)) continue;

    for (int e = threadIdx.x; e < BK * D; e += NTHREADS) {
      const int c = e / D, d = e % D, j = k0 + c;
      int8_t kk = 0;
      float vv = 0.f;
      if (j < Nk) {
        const long off = ((long)b * Nk + j) * C + h * D + d;
        kk = k8[off];
        vv = v[off];
      }
      k8s[plane_at(c, d, BK)] = kk;
      t.v[c * TL::LD + d] = vv;
    }
    __syncthreads();
    int8_scores(q8, k8s, reinterpret_cast<int*>(t.s), TL::LDS, t.w);
    int8_softmax(t, crow);
    t.accumulate();
    __syncthreads();
  }

  t.finish([&](int r, int d, float val) {
    const int i = q0 + r;
    if (i < Nq) out[((long)b * Nq + i) * C + h * D + d] = val;
  });
}

static cudaError_t launch(const void* q, const void* k8, const void* v,
                          const void* qcos, const void* qsin, const void* kb,
                          void* out, int B, int Nq, int Nk, int C,
                          cudaStream_t stream) {
  const int bytes = Tile<D>::kBytes;
  cudaError_t err = prepare(tower_cross_int8_kernel, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + BQ - 1) / BQ, C / D, B);
  tower_cross_int8_kernel<<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k8),
      static_cast<const float*>(v), static_cast<const float*>(qcos),
      static_cast<const float*>(qsin), static_cast<const float*>(kb),
      static_cast<float*>(out), Nq, Nk, C);
  return cudaGetLastError();
}

P3_ERROR_STRING_FN

// q, v (B, Nq | Nk, C) f32; k8 (B, Nk, C) int8; qcos/qsin (B, Nq, 64) f32
// pre-scaled; kb (B, Nk) f32 or null; out like q.  C % 128 == 0 (head
// pairs of d=64).
extern "C" int p3_tower_cross_int8(const void* q, const void* k8,
                                   const void* v, const void* qcos,
                                   const void* qsin, const void* kb,
                                   void* out, int B, int Nq, int Nk, int C,
                                   void* stream) {
  return launch(q, k8, v, qcos, qsin, kb, out, B, Nq, Nk, C,
                static_cast<cudaStream_t>(stream));
}
