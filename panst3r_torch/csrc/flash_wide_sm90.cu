// K3, K4 and K5 at head dims above 128 — the wide-head engine, f32 and
// bf16.  The Hopper engines of flash_{fwd,bwd}{,_bf16}_sm90.cu and
// masked_attn_sm90.cu keep every head dim up to 128; this source takes
// the head dims they refuse, which the Pallas kernels take by padding D
// to their lane width:
//
// - K4, panst3r_tpu/ops/pallas/flash_attention.py::_flash_fwd (:171):
//   p3_wide_fwd without a mask.  A dense additive bias read through its
//   strides, a per-key bias row (B, Nk) (the (B|1, 1, 1, Nk) bias and the
//   key validity folded into it by the wrapper: 0 / finfo.min), 2D-RoPE
//   tables (B, N, P) and the natural-log LSE.  The scale multiplies the
//   f32 score and the biases are added after it; masked logits are
//   finfo(f32).min; the row sum takes the unrounded p and the value
//   product p rounded to v's dtype; a row with no live key writes 0 and
//   its LSE is finfo.min.
// - K3, panst3r_tpu/ops/pallas/masked_attention.py::_sparse_fwd (:119):
//   p3_wide_fwd with the (B, Nq, Nk) blocked mask (1 = blocked): blocked
//   logits are finfo.min, p is rounded to v's dtype in both sums (as the
//   port's other K3 kernels and their plain version), a key tile whose
//   whole 64 x 64 block is blocked is skipped, a fully blocked row writes
//   0.
// - K5, panst3r_tpu/ops/pallas/flash_attention_bwd.py::flash_bwd (:115):
//   p3_wide_bwd, dq over query tiles and dk, dv over key tiles from K4's
//   LSE, p = exp(s - LSE) recomputed, Dvec = rowsum(dO * O) by a pre-pass
//   (one warp a row, a fixed order), ds = p (dp - Dvec) scale rounded to
//   the inputs' dtype before its products, p rounded before dv's.  The
//   gradients are with respect to the rotated q and k: the wrapper applies
//   the rotation's adjoint (ops/flash_attention.py::_rope_adjoint).  No
//   atomics: each gradient element is summed by one thread in a fixed
//   order, so a call repeats bit for bit.
//
// The wrapper pads D to P = round_up(D, 64) with zero lanes (per RoPE
// quarter with tables; cos 1 and sin 0 on the pad lanes) and passes
// contiguous (B, H, N, P) tensors.  With tables a pre-pass rotates q and
// k once per call in f32 and rounds them to their dtype
// (ops/flash_attention.py's module note).
//
// Bound on the H100: at a wide LoftUp call (B = 4 views, one head of 384,
// 192 x 256 pixel queries against 768 tokens) the work is 4 B Nq Nk D =
// 232 GFLOP against ~0.6 GB of q and out: bound by operations (0.23 ms at
// the bf16 tensor-core rate, 3.46 ms at the 67 TFLOP/s of f32 FMA).
//
// Design.  Right before fast: every product is an f32 FMA from operands
// held in f32 in shared memory (bf16 operands widened, exactly), so shared
// memory never bounds D.  A CTA of 256 threads owns a 64-row tile and one
// 64-lane chunk of the output (grid: row tiles, B * H, P / 64 chunks).
// For each 64-column tile it forms the full scores by a loop over the D
// chunks, streaming one 64 x 64 chunk of each operand at a time (stored
// transposed, [lane][row], so that each thread reads four rows as one
// float4), keeps the online softmax (m, l) in registers, and adds only its
// own chunk of the output.  The scores are recomputed P / 64 times per
// tile: accepted here, making it fast is later work.  Each thread holds a
// 4 x 4 sub-tile; a row's 16 threads share a half-warp, so its max and sum
// are reduced by shuffles in a fixed order.  Shared memory: three tiles
// of 64 x 68 floats (52 KB; K3 4 KB more for its mask tile).
#include "attn_common.cuh"

using namespace p3;

namespace {

constexpr int TR = 64;        // rows per CTA: queries (keys in dk/dv)
constexpr int TC = 64;        // columns per tile: keys (queries in dk/dv)
constexpr int DC = 64;        // head-dim lanes per chunk
constexpr int LDS = 68;       // shared row stride in floats: float4-aligned,
                              // transposed stores free of bank conflicts
constexpr int NT = 256;       // 16 x 16 threads, a 4 x 4 sub-tile each
constexpr int TILE = DC * LDS;
constexpr int SMEM = 3 * TILE * 4;
constexpr int MASK_BYTES = TR * TC;

struct BiasStrides {
  long long b, h, q, k;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// A 64 x 64 chunk (rows r0.., lanes c0..) of a (n, P) matrix into s
// transposed, s[lane * LDS + row]; rows past n read 0.  Each half-warp
// takes 16 rows of 4 lanes: the stores of a warp hit 32 banks.
template <typename T>
__device__ __forceinline__ void load_t(float* s, const T* src, int r0, int n,
                                       int P, int c0) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r = (lane & 15) + 16 * (w & 3);
  const bool ok = r0 + r < n;
  const T* row = src + static_cast<size_t>(r0 + r) * P + c0;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int d = 4 * ((lane >> 4) + 2 * (w >> 2) + 4 * it);
    const float4 x = ok ? load4(row + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    s[(d + 0) * LDS + r] = x.x;
    s[(d + 1) * LDS + r] = x.y;
    s[(d + 2) * LDS + r] = x.z;
    s[(d + 3) * LDS + r] = x.w;
  }
}

// The same chunk as it lies, s[row * LDS + lane].
template <typename T>
__device__ __forceinline__ void load_n(float* s, const T* src, int r0, int n,
                                       int P, int c0) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int idx = it * NT + threadIdx.x;
    const int r = idx >> 4, d = (idx & 15) * 4;
    const float4 x = r0 + r < n
        ? load4(src + static_cast<size_t>(r0 + r) * P + c0 + d)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(s + r * LDS + d) = x;
  }
}

// acc[i][j] += sum_kk a[kk][4 ty + i] * b[kk][4 tx + j], kk in order.
__device__ __forceinline__ void mma(float (&acc)[4][4], const float* a,
                                    const float* b) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 8
  for (int kk = 0; kk < DC; ++kk) {
    const float4 x = *reinterpret_cast<const float4*>(a + kk * LDS + 4 * ty);
    const float4 y = *reinterpret_cast<const float4*>(b + kk * LDS + 4 * tx);
    const float xa[4] = {x.x, x.y, x.z, x.w};
    const float ya[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], ya[j], acc[i][j]);
  }
}

// s[(4 tx + j) * LDS + 4 ty + i] = p[i][j]: the sub-tile transposed, as
// the A operand of the next product.
__device__ __forceinline__ void store_t(float* s, const float (&p)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(s + (4 * tx + j) * LDS + 4 * ty) =
        make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
}

// Over the 16 threads of a row (a half-warp), in a fixed order.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// The logit of query qi and key kj from the product s: s * scale, then
// the dense bias, then the key row (K4), or finfo.min where blocked (K3);
// finfo.min past Nk.
template <bool MASKED>
__device__ __forceinline__ float logit(float s, float scale, int b, int h,
                                       int qi, int kj, int Nq, int Nk,
                                       const float* bias, BiasStrides bs,
                                       const float* row, bool blocked) {
  if (kj >= Nk) return NEG;
  if (MASKED) return blocked ? NEG : __fmul_rn(s, scale);
  float x = __fmul_rn(s, scale);
  if (bias != nullptr && qi < Nq)
    x = __fadd_rn(x, bias[b * bs.b + h * bs.h + qi * bs.q + kj * bs.k]);
  if (row != nullptr) x = __fadd_rn(x, row[static_cast<size_t>(b) * Nk + kj]);
  return x;
}

// K4 (mask null) or K3 (mask (B, Nq, ldm) uint8, 1 = blocked).
template <typename T, bool MASKED>
__global__ void __launch_bounds__(NT)
wide_fwd(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const float* __restrict__ bias,
         BiasStrides bs, const float* __restrict__ row,
         const unsigned char* __restrict__ mask, int ldm, T* __restrict__ out,
         float* __restrict__ lse, int H, int Nq, int Nk, int P, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;
  float* sb = smem + TILE;
  float* sp = smem + 2 * TILE;
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem + 3 * TILE);
  const int q0 = blockIdx.x * TR, bh = blockIdx.y, c0 = blockIdx.z * DC;
  const int b = bh / H, h = bh % H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qb = q + static_cast<size_t>(bh) * Nq * P;
  const T* kb = k + static_cast<size_t>(bh) * Nk * P;
  const T* vb = v + static_cast<size_t>(bh) * Nk * P;
  float m[4], l[4], o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }
  const int ntiles = (Nk + TC - 1) / TC;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * TC;
    if (MASKED) {
      __syncthreads();
      int live = 0;
      for (int idx = threadIdx.x; idx < TR * TC; idx += NT) {
        const int r = idx / TC, c = idx % TC;
        const unsigned char x =
            (q0 + r < Nq && k0 + c < Nk)
                ? mask[(static_cast<size_t>(b) * Nq + q0 + r) * ldm + k0 + c]
                : 1;
        sm[idx] = x;
        live |= !x;
      }
      if (!__syncthreads_or(live)) continue;   // the whole block blocked
    }
    float s[4][4] = {};
    for (int dc = 0; dc < P; dc += DC) {
      __syncthreads();
      load_t(sa, qb, q0, Nq, P, dc);
      load_t(sb, kb, k0, Nk, P, dc);
      __syncthreads();
      mma(s, sa, sb);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + 4 * tx + j;
        s[i][j] = logit<MASKED>(
            s[i][j], scale, b, h, qi, kj, Nq, Nk, bias, bs, row,
            MASKED && sm[(4 * ty + i) * TC + 4 * tx + j]);
      }
      const float mn = fmaxf(
          m[i], row_max(fmaxf(fmaxf(s[i][0], s[i][1]),
                              fmaxf(s[i][2], s[i][3]))));
      const float safe = mn <= NEG / 2 ? 0.f : mn;
      const float alpha = m[i] <= NEG / 2 ? 0.f : expf(m[i] - safe);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] <= NEG / 2 ? 0.f : expf(s[i][j] - safe);
        const float pr = round_to<T>(p);
        sum = __fadd_rn(sum, MASKED ? pr : p);
        s[i][j] = pr;
        o[i][j] = __fmul_rn(o[i][j], alpha);
      }
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha), sum);
      m[i] = mn;
    }
    __syncthreads();
    store_t(sp, s);
    load_n(sb, vb, k0, Nk, P, c0);
    __syncthreads();
    mma(o, sp, sb);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float L = row_sum(l[i]);
    const int qi = q0 + 4 * ty + i;
    if (qi >= Nq) continue;
    const float den = L == 0.f ? 1.f : L;
    T* dst = out + (static_cast<size_t>(bh) * Nq + qi) * P + c0 + 4 * tx;
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[j] = from_f<T>(o[i][j] / den);
    if (lse != nullptr && blockIdx.z == 0 && tx == 0)
      lse[static_cast<size_t>(bh) * Nq + qi] =
          m[i] <= NEG / 2 ? NEG : m[i] + logf(L);
  }
}

// K5's dq: rows are queries.
template <typename T>
__global__ void __launch_bounds__(NT)
wide_dq(const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ g,
        const float* __restrict__ lse, const float* __restrict__ dvec,
        const float* __restrict__ bias, BiasStrides bs,
        const float* __restrict__ row, float* __restrict__ dq, int H, int Nq,
        int Nk, int P, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;
  float* sb = smem + TILE;
  float* sp = smem + 2 * TILE;
  const int q0 = blockIdx.x * TR, bh = blockIdx.y, c0 = blockIdx.z * DC;
  const int b = bh / H, h = bh % H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t qo = static_cast<size_t>(bh) * Nq * P;
  const size_t ko = static_cast<size_t>(bh) * Nk * P;
  float ls[4], dv4[4];
  bool dead[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    ls[i] = qi < Nq ? lse[static_cast<size_t>(bh) * Nq + qi] : NEG;
    dv4[i] = qi < Nq ? dvec[static_cast<size_t>(bh) * Nq + qi] : 0.f;
    dead[i] = ls[i] <= NEG / 2 || ls[i] >= -NEG / 2;
  }
  float acc[4][4] = {};
  const int ntiles = (Nk + TC - 1) / TC;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * TC;
    float s[4][4] = {}, dp[4][4] = {};
    for (int dc = 0; dc < P; dc += DC) {
      __syncthreads();
      load_t(sa, q + qo, q0, Nq, P, dc);
      load_t(sb, k + ko, k0, Nk, P, dc);
      __syncthreads();
      mma(s, sa, sb);
    }
    for (int dc = 0; dc < P; dc += DC) {
      __syncthreads();
      load_t(sa, g + qo, q0, Nq, P, dc);
      load_t(sb, v + ko, k0, Nk, P, dc);
      __syncthreads();
      mma(dp, sa, sb);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = logit<false>(s[i][j], scale, b, h, qi,
                                     k0 + 4 * tx + j, Nq, Nk, bias, bs, row,
                                     false);
        const float p = (dead[i] || x <= NEG / 2) ? 0.f : expf(x - ls[i]);
        s[i][j] = round_to<T>(
            __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i][j], dv4[i])), scale));
      }
    }
    __syncthreads();
    store_t(sp, s);
    load_n(sb, k + ko, k0, Nk, P, c0);
    __syncthreads();
    mma(acc, sp, sb);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= Nq) continue;
    float* dst = dq + (static_cast<size_t>(bh) * Nq + qi) * P + c0 + 4 * tx;
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// K5's dk and dv: rows are keys, columns queries.
template <typename T>
__global__ void __launch_bounds__(NT)
wide_dkdv(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ g,
          const float* __restrict__ lse, const float* __restrict__ dvec,
          const float* __restrict__ bias, BiasStrides bs,
          const float* __restrict__ row, float* __restrict__ dk,
          float* __restrict__ dv, int H, int Nq, int Nk, int P, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;
  float* sb = smem + TILE;
  float* sp = smem + 2 * TILE;
  const int k0 = blockIdx.x * TR, bh = blockIdx.y, c0 = blockIdx.z * DC;
  const int b = bh / H, h = bh % H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t qo = static_cast<size_t>(bh) * Nq * P;
  const size_t ko = static_cast<size_t>(bh) * Nk * P;
  float ak[4][4] = {}, av[4][4] = {};
  const int ntiles = (Nq + TC - 1) / TC;
  for (int qt = 0; qt < ntiles; ++qt) {
    const int q0 = qt * TC;
    float ls[4], dv4[4];
    bool dead[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qj = q0 + 4 * tx + j;
      ls[j] = qj < Nq ? lse[static_cast<size_t>(bh) * Nq + qj] : NEG;
      dv4[j] = qj < Nq ? dvec[static_cast<size_t>(bh) * Nq + qj] : 0.f;
      dead[j] = ls[j] <= NEG / 2 || ls[j] >= -NEG / 2;
    }
    float s[4][4] = {}, dp[4][4] = {};
    for (int dc = 0; dc < P; dc += DC) {
      __syncthreads();
      load_t(sa, k + ko, k0, Nk, P, dc);
      load_t(sb, q + qo, q0, Nq, P, dc);
      __syncthreads();
      mma(s, sa, sb);
    }
    for (int dc = 0; dc < P; dc += DC) {
      __syncthreads();
      load_t(sa, v + ko, k0, Nk, P, dc);
      load_t(sb, g + qo, q0, Nq, P, dc);
      __syncthreads();
      mma(dp, sa, sb);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kj = k0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qj = q0 + 4 * tx + j;
        const float x = logit<false>(s[i][j], scale, b, h, qj, kj, Nq, Nk,
                                     bias, bs, row, false);
        const float p = (qj >= Nq || dead[j] || x <= NEG / 2)
                            ? 0.f : expf(x - ls[j]);
        s[i][j] = round_to<T>(
            __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i][j], dv4[j])), scale));
        dp[i][j] = round_to<T>(p);
      }
    }
    __syncthreads();
    store_t(sp, s);
    load_n(sb, q + qo, q0, Nq, P, c0);
    __syncthreads();
    mma(ak, sp, sb);
    __syncthreads();
    store_t(sp, dp);
    load_n(sb, g + qo, q0, Nq, P, c0);
    __syncthreads();
    mma(av, sp, sb);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + 4 * ty + i;
    if (kj >= Nk) continue;
    const size_t at = (static_cast<size_t>(bh) * Nk + kj) * P + c0 + 4 * tx;
    *reinterpret_cast<float4*>(dk + at) =
        make_float4(ak[i][0], ak[i][1], ak[i][2], ak[i][3]);
    *reinterpret_cast<float4*>(dv + at) =
        make_float4(av[i][0], av[i][1], av[i][2], av[i][3]);
  }
}

// y = x cos + R(x) sin in f32, rounded to T (R: rotate-half within each
// half of P, ops/rope.py::_rotate_half_2d); x, y (B, H, N, P), the tables
// (B, N, P).
template <typename T>
__global__ void wide_rope(const T* __restrict__ x, const float* __restrict__ c,
                          const float* __restrict__ sn, T* __restrict__ y,
                          int H, int N, int P, long long total) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i >= total) return;
  const int d = static_cast<int>(i % P);
  const long long tok = i / P;
  const long long n = tok % N, b = tok / (static_cast<long long>(N) * H);
  const int Q = P / 4;
  const bool odd = (d / Q) & 1;
  const float partner = to_f(x[odd ? i - Q : i + Q]);
  const size_t t = (static_cast<size_t>(b) * N + n) * P + d;
  y[i] = from_f<T>(__fadd_rn(__fmul_rn(to_f(x[i]), c[t]),
                             __fmul_rn(odd ? partner : -partner, sn[t])));
}

// Dvec = rowsum(dO * O) over (rows, P) f32: one warp a row, lane sums in
// order, then a fixed shuffle tree.
__global__ void wide_dvec(const float* __restrict__ o,
                          const float* __restrict__ g,
                          float* __restrict__ dvec, long long rows, int P) {
  const long long r = blockIdx.x * 8LL + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const float* a = o + r * P;
  const float* b = g + r * P;
  float s = 0.f;
  for (int d = lane; d < P; d += 32) s = __fadd_rn(s, __fmul_rn(a[d], b[d]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  if (lane == 0) dvec[r] = s;
}

template <typename T>
cudaError_t rope(const void* x, const float* c, const float* s, void* y,
                 int B, int H, int N, int P, cudaStream_t st) {
  const long long total = static_cast<long long>(B) * H * N * P;
  wide_rope<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      static_cast<const T*>(x), c, s, static_cast<T*>(y), H, N, P, total);
  return cudaGetLastError();
}

cudaError_t rope_any(int bf16, const void* x, const float* c, const float* s,
                     void* y, int B, int H, int N, int P, cudaStream_t st) {
  return bf16 ? rope<__nv_bfloat16>(x, c, s, y, B, H, N, P, st)
              : rope<float>(x, c, s, y, B, H, N, P, st);
}

BiasStrides strides_of(const long long* bstr) {
  return bstr == nullptr ? BiasStrides{0, 0, 0, 0}
                         : BiasStrides{bstr[0], bstr[1], bstr[2], bstr[3]};
}

template <typename T, bool MASKED>
cudaError_t fwd(const void* q, const void* k, const void* v,
                const float* bias, BiasStrides bs, const float* row,
                const unsigned char* mask, int ldm, void* out, float* lse,
                int B, int H, int Nq, int Nk, int P, float scale,
                cudaStream_t st) {
  auto kern = wide_fwd<T, MASKED>;
  const int bytes = SMEM + (MASKED ? MASK_BYTES : 0);
  cudaError_t e = prepare(kern, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((Nq + TR - 1) / TR, B * H, P / DC);
  kern<<<grid, NT, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, bs, row, mask, ldm,
      static_cast<T*>(out), lse, H, Nq, Nk, P, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* g,
                const float* lse, const float* dvec, const float* bias,
                BiasStrides bs, const float* row, float* dq, float* dk,
                float* dv, int B, int H, int Nq, int Nk, int P, float scale,
                cudaStream_t st) {
  cudaError_t e = prepare(wide_dq<T>, SMEM);
  if (e == cudaSuccess) e = prepare(wide_dkdv<T>, SMEM);
  if (e != cudaSuccess) return e;
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *tg = static_cast<const T*>(g);
  wide_dq<T><<<dim3((Nq + TR - 1) / TR, B * H, P / DC), NT, SMEM, st>>>(
      tq, tk, tv, tg, lse, dvec, bias, bs, row, dq, H, Nq, Nk, P, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wide_dkdv<T><<<dim3((Nk + TR - 1) / TR, B * H, P / DC), NT, SMEM, st>>>(
      tq, tk, tv, tg, lse, dvec, bias, bs, row, dk, dv, H, Nq, Nk, P, scale);
  return cudaGetLastError();
}

}  // namespace

P3_ERROR_STRING_FN

// K4 (mask null) or K3 (mask (B, Nq, ldm) uint8).  q, k, v, out (B, H, N,
// P) contiguous, P a multiple of 64; with tables (qcos null: none) q and
// k are rotated into qr and kr (B, H, N, P) first.  bias (B, H, Nq, Nk)
// f32 through bstr (4 element strides), row (B, Nk) f32, lse (B, H, Nq)
// f32: each may be null.
extern "C" int p3_wide_fwd(const void* q, const void* k, const void* v,
                           const float* qcos, const float* qsin,
                           const float* kcos, const float* ksin, void* qr,
                           void* kr, const float* bias, const long long* bstr,
                           const float* row, const unsigned char* mask,
                           int ldm, void* out, float* lse, int B, int H,
                           int Nq, int Nk, int P, float scale, int bf16,
                           void* stream) {
  if (P % DC != 0 || B * H > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qcos != nullptr) {
    cudaError_t e = rope_any(bf16, q, qcos, qsin, qr, B, H, Nq, P, st);
    if (e == cudaSuccess) e = rope_any(bf16, k, kcos, ksin, kr, B, H, Nk, P,
                                       st);
    if (e != cudaSuccess) return e;
    q = qr;
    k = kr;
  }
  const BiasStrides bs = strides_of(bstr);
  if (mask != nullptr)
    return bf16 ? fwd<__nv_bfloat16, true>(q, k, v, bias, bs, row, mask, ldm,
                                           out, lse, B, H, Nq, Nk, P, scale,
                                           st)
                : fwd<float, true>(q, k, v, bias, bs, row, mask, ldm, out,
                                   lse, B, H, Nq, Nk, P, scale, st);
  return bf16 ? fwd<__nv_bfloat16, false>(q, k, v, bias, bs, row, nullptr, 0,
                                          out, lse, B, H, Nq, Nk, P, scale,
                                          st)
              : fwd<float, false>(q, k, v, bias, bs, row, nullptr, 0, out, lse,
                                  B, H, Nq, Nk, P, scale, st);
}

// K5.  q, k, v and g (dO rounded to q's dtype) (B, H, N, P) contiguous;
// o32 and do32 (B, H, Nq, P) f32 for Dvec; lse (B, H, Nq) f32; tables,
// qr, kr, bias and row as p3_wide_fwd takes them; dvec (B, H, Nq) f32
// scratch; dq, dk, dv (B, H, N, P) f32 with respect to the rotated q, k.
extern "C" int p3_wide_bwd(const void* q, const void* k, const void* v,
                           const void* g, const float* o32,
                           const float* do32, const float* lse,
                           const float* qcos, const float* qsin,
                           const float* kcos, const float* ksin, void* qr,
                           void* kr, float* dvec, const float* bias,
                           const long long* bstr, const float* row, float* dq,
                           float* dk, float* dv, int B, int H, int Nq, int Nk,
                           int P, float scale, int bf16, void* stream) {
  if (P % DC != 0 || B * H > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  if (qcos != nullptr) {
    e = rope_any(bf16, q, qcos, qsin, qr, B, H, Nq, P, st);
    if (e == cudaSuccess) e = rope_any(bf16, k, kcos, ksin, kr, B, H, Nk, P,
                                       st);
    if (e != cudaSuccess) return e;
    q = qr;
    k = kr;
  }
  const long long rows = static_cast<long long>(B) * H * Nq;
  wide_dvec<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(
      o32, do32, dvec, rows, P);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const BiasStrides bs = strides_of(bstr);
  return bf16 ? bwd<__nv_bfloat16>(q, k, v, g, lse, dvec, bias, bs, row, dq,
                                   dk, dv, B, H, Nq, Nk, P, scale, st)
              : bwd<float>(q, k, v, g, lse, dvec, bias, bs, row, dq, dk, dv,
                           B, H, Nq, Nk, P, scale, st);
}
