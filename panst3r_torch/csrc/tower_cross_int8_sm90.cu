// K2-int8, bf16 and f32 — memory cross-attention with int8 x int8 ->
// int32 scores on the Hopper engines (attn_sm90.cuh for bf16,
// attn_f32_sm90.cuh for f32).
//
// Replaces the kv_int8 branch of
// panst3r_tpu/ops/pallas/tower_attention.py::_cross_fwd (body _cross_kernel,
// the `int8` paths: q8 in the kernel's init :285-293, int32 scores and the
// stabilizer :328-356, k8 and the tables outside the kernel :483-497), the
// opt-in serving precision (PANST3R_KV_INT8=1) that the JAX package engages
// for render-scale query counts (Nq >= 16384).
//
// The caller (ops/tower_attention.py::int8_prepare, plain torch on the
// device, as the JAX package prepares it outside pallas_call) hands in k8
// (B, Nk, C) int8 (k rotated in f32 and quantized per tensor) and the q
// tables (B, Nq, 64) f32 pre-multiplied by scale * log2(e) * sk; the key
// bias (B, Nk) f32 comes raw.
//
// Bound on the H100 at the long render shape (B=1, Nq=38400, Nk=12288,
// C=768): 7.25e11 int8 operations for the scores (0.37 ms at 1979 TOP/s)
// and 7.25e11 bf16 FLOPs for p.v (0.73 ms at 989 TFLOP/s) against ~0.2 GB
// of traffic: bound by operations, 1.0988 ms.  Below that sits a floor the
// bound does not count: one exp2 per score, 38400 * 12288 * 12 = 5.66e9 on
// the special-function units, at 16 results per clock per SM (compute
// capability 9.0), 132 SMs and 1.98 GHz 1.35 ms.  In f32 the p.v half runs
// at the 494.7 / 3 TFLOP/s of 3xTF32 products: 4.4 ms (10.8 at 67 TFLOP/s
// of f32 FMA).
//
// Design, three launches per call:
// (1) int8_qprep, the pre-pass of q: per query row and head pair, q
//     rotated in f32 with the pre-scaled tables over the pair's 128 lanes
//     (lane d's partner is d ^ 16 within its head), amax =
//     max(max|q_rot|, 1e-20) over the PAIR (the Pallas lane-block layout,
//     which decides q8), q8 = rint(q_rot * (127 / amax)) and c = amax *
//     (1 / 127): q8 (B, Nq, C) int8 and c (B, Nq, C / 128) f32.  Every f32
//     operation that decides q8 is written with the _rn intrinsics, so
//     that nvcc contracts none of them into an FMA: q8 equals the Pallas
//     branch's bit for bit.
// (2) cross_tiles (attn_sm90.cuh, as K2): the key bias in log2 units padded
//     to whole key tiles (bf16: 128 keys, f32: 64; NEG where dead or past
//     Nk) and each batch's live tiles.
// (3) bf16, int8_main: one CTA per (128 query rows, head, batch), two
//     consumer warpgroups of 64 rows and the producer warpgroup.  The gate
//     (Nq >= 16384) gives at least 128 query tiles per head, so no
//     split-KV.  A head's q8 and k8 rows are 64 bytes: TMA boxes of 64
//     bytes with 64B swizzle (wgmma layout type 2, K-major, SBO 512 B),
//     which the s8 wgmma needs K-major on both sides (it takes no
//     transpose for 8-bit types); V is K2's bf16 tile (128 keys x 64 lanes,
//     128B swizzle).  Per live tile: S = q8 k8^T by two wgmma
//     m64n128k32.s32.s8.s8 steps into 64 s32 registers; the stabilizer m =
//     max(m, rowmax_int32(S) * c), the int32 max taken before any
//     conversion (the bias left out: any m >= the row max of the logits is
//     valid because the bias is <= 0; the zeros that TMA fills past Nk
//     count, as in the plain version); the logit s * c + kb, s converted
//     by the magic-number add (exact for |s| < 2^22; here |s| <= 64 * 127 *
//     127) instead of cvt.rn.f32.s32, which issues at a fraction of the
//     FP32 rate; p = exp2(logit - m) rounded to bf16 before both the row
//     sum and p.v (``RoundedSum``), p.v the engine's issue_pv.  Rows that
//     saw no live key write 0.
// (3) f32, int8_main_f32: the f32 K2's layout (attn_f32_sm90.cuh): one CTA
//     per (128 query rows, head, batch), four consumer warps of two 16-row
//     tiles and a producer warp, whose ring entries hold a live 64-key
//     tile's k8 (64 bytes a key, 64B swizzle), f32 V (two 32-lane boxes,
//     128B swizzle) and key biases.  A warp's q8 fragments stay in
//     registers for the whole walk (16 rows x 64 bytes: 8 a row tile); k8
//     fragments come by ldmatrix; the scores by mma.sync m16n8k32 s8 (exact
//     int32, in the m16n8 accumulator layout the engine's row state reads).
//     The stabilizer is the int32 row max over the 64-key tile times c, as
//     above; p = exp2(s * c + kb - m) stays f32 (each operation _rn, as the
//     plain version rounds it) and enters the row sum, and P.V runs on
//     3xTF32, each 8-key step added to O in f32 round-to-nearest (f32e::pv).
//     The tile (64 keys, ops/tower_attention.py::INT8_F32_TILE) decides
//     which padding zeros enter the stabilizer; no split-KV: the long
//     render gives 300 row tiles x 12 heads.

#include "attn_f32_sm90.cuh"

using namespace p3;
using namespace p3::sm90;

typedef __nv_bfloat16 bf16;

namespace {

// consumer warpgroups; ops/tower_attention.py::INT8_WARPGROUPS names it
// to the caller, and the launcher refuses any other value
constexpr int NWG = 2;
constexpr int I8_STAGES = 4;                   // ring slots
constexpr uint32_t kQ8Bytes = BQW * D;         // 64 rows x 64 B = 4 KB
constexpr uint32_t kK8Bytes = BKT * D;         // 128 keys x 64 B = 8 KB

// Dynamic shared memory: the warpgroups' q8 tiles, then per ring slot the
// k8 tile, the V tile and the tile's key biases; every tile on a 1024-byte
// boundary of the aligned base.
struct I8Smem {
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + NWG * kQ8Bytes;
  static constexpr uint32_t kV = kK + I8_STAGES * kK8Bytes;
  static constexpr uint32_t kBias = kV + I8_STAGES * kKVBytes;
  static constexpr uint32_t kBar = kBias + I8_STAGES * kBiasBytes;
  static constexpr uint32_t kEnd = kBar + (1 + 2 * I8_STAGES) * 8;
  static constexpr int kBytes = kEnd + 1024;    // room to align the base

  unsigned char* base;
  __device__ explicit I8Smem(unsigned char* raw)
      : base(reinterpret_cast<unsigned char*>(
            (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023))) {}
  __device__ unsigned char* q(int g) const { return base + kQ + g * kQ8Bytes; }
  __device__ unsigned char* k(int s) const { return base + kK + s * kK8Bytes; }
  __device__ unsigned char* v(int s) const { return base + kV + s * kKVBytes; }
  __device__ const float* bias(int s) const {
    return reinterpret_cast<const float*>(base + kBias + s * kBiasBytes);
  }
  __device__ float* bias_dst(int s) const {
    return reinterpret_cast<float*>(base + kBias + s * kBiasBytes);
  }
  __device__ uint64_t* q_full() const {
    return reinterpret_cast<uint64_t*>(base + kBar);
  }
  __device__ uint64_t* full(int s) const { return q_full() + 1 + s; }
  __device__ uint64_t* empty(int s) const {
    return q_full() + 1 + I8_STAGES + s;
  }
};

// D (64 x 128, s32 in registers) += A (64 x 32, s8, smem) . B (128 x 32,
// s8, smem)^T, both operands K-major behind 64B-swizzle descriptors.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// K-major int8 operand of 64-byte rows (64 lanes of one head): 8-row groups
// 512 B apart (SBO); step kk of 32 lanes starts 32 bytes further.
__device__ __forceinline__ uint64_t desc_i8(const void* tile, int kk) {
  return desc_sw<2>(tile, 1, 32) + static_cast<uint64_t>(2 * kk);
}

// Issues S = q8 k8^T for one key tile (one commit group).
__device__ __forceinline__ void issue_scores_s8(int (&s)[64],
                                                const unsigned char* q,
                                                const unsigned char* k) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk)
    wgmma_s8_n128(s, desc_i8(q, kk), desc_i8(k, kk), kk > 0);
  wg_commit();
}

// float(s) for |s| < 2^22: the bits of 1.5 * 2^23 + s, less 1.5 * 2^23.
__device__ __forceinline__ float i2f_exact(int s) {
  return __fsub_rn(__int_as_float(s + 0x4B400000), 12582912.0f);
}

// The online-softmax step on the int32 scores of one tile: the stabilizer
// from the int32 row max times the row's c, the logits s * c + kb (log2
// units), p = exp2(logit - m) rounded to bf16 and packed in pairs, the row
// sum of the rounded p.  Returns in ``alpha`` the factor O is scaled by.
__device__ __forceinline__ void int8_step(RowState& st, const Rows& rw,
                                          const int (&s)[64],
                                          const float (&c)[2],
                                          const float* __restrict__ kb,
                                          uint32_t (&p)[32],
                                          float (&alpha)[2]) {
  int mx[2] = {INT_MIN, INT_MIN};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[Rows::hi(i)] = max(mx[Rows::hi(i)], s[i]);
  float safe[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int x = max(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    x = max(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float m_new = fmaxf(st.m[h], __fmul_rn(static_cast<float>(x), c[h]));
    safe[h] = (m_new <= 0.5f * NEG) ? 0.f : m_new;
    alpha[h] = (st.m[h] <= 0.5f * NEG) ? 0.f : exp2_approx(st.m[h] - safe[h]);
    st.m[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int h = Rows::hi(i);
    const float2 b2 =
        *reinterpret_cast<const float2*>(kb + Rows::col(i) + rw.cq);
    // a dead or padding key has kb = NEG: its exp2 is 0
    const float x0 = fmaf(i2f_exact(s[i]), c[h], b2.x) - safe[h];
    const float x1 = fmaf(i2f_exact(s[i + 1]), c[h], b2.y) - safe[h];
    const __nv_bfloat16 p0 = __float2bfloat16_rn(exp2_approx(x0));
    const __nv_bfloat16 p1 = __float2bfloat16_rn(exp2_approx(x1));
    sum[h] += __bfloat162float(p0) + __bfloat162float(p1);
    p[i / 2] = pack_bf16(p0, p1);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) st.l[h] = st.l[h] * alpha[h] + quad_sum(sum[h]);
}

}  // namespace

// Eight consecutive values of q as f32.
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = __bfloat162float(h[j]);
}
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

// One warp per two (row, head pair) items, 16 lanes an item, 8 lanes of q
// a thread: q (bf16 or f32) rotated in f32 over the pair, amax over the
// pair (a half-warp reduction), q8 and c.
template <typename T>
__global__ void int8_qprep(const T* __restrict__ q,
                           const float* __restrict__ qcos,
                           const float* __restrict__ qsin,
                           int8_t* __restrict__ q8, float* __restrict__ cs,
                           long items, int C) {
  const int lane = threadIdx.x & 31, sub = lane & 15;
  const int P = C / 128;
  const long warps = (long)gridDim.x * blockDim.x / 32;
  for (long it = (blockIdx.x * (long)blockDim.x + threadIdx.x) / 32 * 2;
       it < items; it += warps * 2) {
    const long item = it + (lane >> 4);        // (row, pair), row-major
    const bool valid = item < items;
    const long row = valid ? item / P : 0;
    const int pair = valid ? static_cast<int>(item % P) : 0;
    const int l0 = sub * 8, d0 = l0 & 63;      // this thread's 8 lanes
    const T* head = q + row * C + pair * 128 + (l0 - d0);
    float x[8], xp[8];
    load8(head + d0, x);
    load8(head + (d0 ^ 16), xp);
    const float* cr = qcos + row * 64 + d0;
    const float* sr = qsin + row * 64 + d0;
    float r[8], amax = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float rot = (d0 & 16) ? xp[j] : -xp[j];
      r[j] = __fadd_rn(__fmul_rn(x[j], cr[j]), __fmul_rn(rot, sr[j]));
      amax = fmaxf(amax, fabsf(r[j]));
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    amax = fmaxf(amax, 1e-20f);
    const float inv = __fdiv_rn(127.0f, amax);
    if (!valid) continue;
    __align__(8) int8_t o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j] = static_cast<int8_t>(__float2int_rn(__fmul_rn(r[j], inv)));
    *reinterpret_cast<uint2*>(q8 + row * C + pair * 128 + l0) =
        *reinterpret_cast<const uint2*>(o);
    if (sub == 0) cs[item] = __fmul_rn(amax, (float)(1.0 / 127.0));
  }
}

// grid (ceil(Nq / 128), heads, B).  ``mq``, ``mk``: (C, N, B) int8 maps,
// boxes of 64 bytes x 64 / 128 rows, 64B swizzle; ``mv``: K2's bf16 map.
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
int8_main(const __grid_constant__ CUtensorMap mq,
          const __grid_constant__ CUtensorMap mk,
          const __grid_constant__ CUtensorMap mv,
          const float* __restrict__ cs, const float* __restrict__ bl,
          const int* __restrict__ list, const int* __restrict__ count,
          bf16* __restrict__ out, int Nq, int C, int nt) {
  extern __shared__ unsigned char smem_raw[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * NWG * BQW;
  const int n = count[b];
  const int* tiles = list + b * nt;
  const I8Smem sm(smem_raw);
  if (threadIdx.x == 0) {
    mbar_init(sm.q_full(), 1);
    for (int s = 0; s < I8_STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == NWG) {  // producer warpgroup
    regs_dec<Regs<NWG>::kProducer>();
    if (threadIdx.x == NWG * 128) {
      mbar_expect_tx(sm.q_full(), NWG * kQ8Bytes);
#pragma unroll
      for (int g = 0; g < NWG; ++g)
        tma_load_3d(sm.q(g), &mq, sm.q_full(), h * D, q0 + g * BQW, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % I8_STAGES, t = tiles[i];
        mbar_wait(sm.empty(s), ((i / I8_STAGES) & 1) ^ 1);
        mbar_expect_tx(sm.full(s), kK8Bytes + kKVBytes + kBiasBytes);
        tma_load_3d(sm.k(s), &mk, sm.full(s), h * D, t * BKT, b);
        tma_load_3d(sm.v(s), &mv, sm.full(s), h * D, t * BKT, b);
        bulk_load(sm.bias_dst(s), bl + ((long)b * nt + t) * BKT, kBiasBytes,
                  sm.full(s));
      }
    }
    return;
  }
  // consumer warpgroup wg: query rows q0 + 64 wg + [0, 64)
  regs_inc<Regs<NWG>::kConsumer>();
  const Rows rw;
  RowState st;
  st.zero();
  const int row0 = q0 + wg * BQW, P = C / 128;
  float c[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = row0 + (hh ? rw.r1 : rw.r0);
    c[hh] = i < Nq ? cs[((long)b * Nq + i) * P + (h >> 1)] : 0.f;
  }
  int s[64];
  uint32_t p[32];
  float alpha[2];
  mbar_wait(sm.q_full(), 0);
  for (int i = 0; i < n; ++i) {
    const int cur = i % I8_STAGES;
    mbar_wait(sm.full(cur), (i / I8_STAGES) & 1);
    issue_scores_s8(s, sm.q(wg), sm.k(cur));
    wg_wait<0>();
    fence_regs(s);
    int8_step(st, rw, s, c, sm.bias(cur), p, alpha);
    rescale(st, alpha);
    issue_pv(st.o, p, sm.v(cur));
    wg_wait<0>();
    fence_regs(st.o);
    fence_regs(p);  // the product reads p until it completes
    mbar_arrive(sm.empty(cur));
  }
  store_normalized(st, rw, [&](int r) -> bf16* {
    const int i = row0 + r;
    return i < Nq ? out + ((long)b * Nq + i) * C + h * D : nullptr;
  });
}

// ------------------------------------------------------------- f32 ----

namespace {

constexpr int F_NW = 4;                        // consumer warps
constexpr int F_MT = 2;                        // 16-row tiles per warp
constexpr int F_R = 16 * F_MT * F_NW;          // 128 query rows per CTA
constexpr int F_ST = 4;                        // ring slots
constexpr int FKT = f32e::KT;                  // 64 keys per live tile
constexpr uint32_t kFK8 = FKT * D;             // k8: 64 keys x 64 B, 4 KB
constexpr uint32_t kFV = FKT * D * 4;          // V: 64 keys x 64 f32, 16 KB
constexpr uint32_t kFBias = FKT * 4;           // the tile's key biases

// Dynamic shared memory of the f32 CTA: per ring slot the k8 tile, the f32
// V tile (two 32-lane boxes of 128-byte rows) and the key biases; every
// tile on a 1024-byte boundary of the aligned base.
struct F32Smem {
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kK + F_ST * kFK8;
  static constexpr uint32_t kBias = kV + F_ST * kFV;
  static constexpr uint32_t kBar = kBias + F_ST * kFBias;
  static constexpr uint32_t kEnd = kBar + 2 * F_ST * 8;
  static constexpr int kBytes = kEnd + 1024;    // room to align the base

  unsigned char* base;
  __device__ explicit F32Smem(unsigned char* raw)
      : base(reinterpret_cast<unsigned char*>(
            (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023))) {}
  __device__ unsigned char* k(int s) const { return base + kK + s * kFK8; }
  __device__ unsigned char* v(int s) const { return base + kV + s * kFV; }
  __device__ float* bias(int s) const {
    return reinterpret_cast<float*>(base + kBias + s * kFBias);
  }
  __device__ uint64_t* full(int s) const {
    return reinterpret_cast<uint64_t*>(base + kBar) + s;
  }
  __device__ uint64_t* empty(int s) const { return full(F_ST + s); }
};

// d (16 x 8, s32) += a (16 x 32, s8, row) . b (32 x 8, s8, col): exact.
__device__ __forceinline__ void mma_s8(int* d, const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk ``c`` of key row ``r`` of a k8 tile written
// by TMA with 64B swizzle (chunk c of row r sits at c ^ ((r / 2) % 4)):
// ldmatrix's eight row addresses then fall in distinct bank groups.
__device__ __forceinline__ uint32_t k8_off(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// The online-softmax step on the int32 scores of one 64-key tile of one
// row tile, f32: the stabilizer from the int32 row max times the row's c,
// p = exp2(s * c + kb - m) in place of nothing rounded (each operation
// _rn, as the plain version's), the row sum of p.  Returns in ``alpha``
// the factor O is scaled by.
__device__ __forceinline__ void int8_step_f32(RowState& st, int cq,
                                              const int (&s)[32],
                                              const float (&c)[2],
                                              const float* __restrict__ kb,
                                              float (&p)[32],
                                              float (&alpha)[2]) {
  int mx[2] = {INT_MIN, INT_MIN};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[Rows::hi(i)] = max(mx[Rows::hi(i)], s[i]);
  float safe[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int x = max(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    x = max(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float m_new = fmaxf(st.m[h], __fmul_rn(static_cast<float>(x), c[h]));
    safe[h] = (m_new <= 0.5f * NEG) ? 0.f : m_new;
    alpha[h] = (st.m[h] <= 0.5f * NEG) ? 0.f : exp2_approx(st.m[h] - safe[h]);
    st.m[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = Rows::hi(i);
    // a dead or padding key has kb = NEG: its exp2 is 0
    const float x = __fsub_rn(
        __fadd_rn(__fmul_rn(i2f_exact(s[i]), c[h]), kb[Rows::col(i) + cq]),
        safe[h]);
    p[i] = exp2_approx(x);
    sum[h] += p[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) st.l[h] = st.l[h] * alpha[h] + quad_sum(sum[h]);
}

}  // namespace

// grid (ceil(Nq / 128), heads, B).  ``mk``: the (C, Nk, B) int8 map, boxes
// of 64 bytes x 64 keys, 64B swizzle; ``mv``: the f32 engine's map of v
// (32-lane boxes of 64 keys).
__global__ void __launch_bounds__((F_NW + 1) * 32, 1)
int8_main_f32(const __grid_constant__ CUtensorMap mk,
              const __grid_constant__ CUtensorMap mv,
              const int8_t* __restrict__ q8, const float* __restrict__ cs,
              const float* __restrict__ bl, const int* __restrict__ list,
              const int* __restrict__ count, float* __restrict__ out, int Nq,
              int C, int nt) {
  extern __shared__ unsigned char smem_raw[];
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * F_R;
  const int n = count[b];
  const int* tiles = list + b * nt;
  const F32Smem sm(smem_raw);
  if (threadIdx.x == 0) {
    for (int s = 0; s < F_ST; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), F_NW * 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (w == F_NW) {  // producer warp
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        const int s = i % F_ST, t = tiles[i];
        mbar_wait(sm.empty(s), ((i / F_ST) & 1) ^ 1);
        mbar_expect_tx(sm.full(s), kFK8 + kFV + kFBias);
        tma_load_3d(sm.k(s), &mk, sm.full(s), h * D, t * FKT, b);
        for (int j = 0; j < 2; ++j)
          tma_load_3d(sm.v(s) + j * FKT * 128, &mv, sm.full(s),
                      h * D + 32 * j, t * FKT, b);
        bulk_load(sm.bias(s), bl + ((long)b * nt + t) * FKT, kFBias,
                  sm.full(s));
      }
    }
    return;
  }
  // consumer warp w: row tiles 2w and 2w + 1, query rows q0 + 32 w + [0, 32)
  const int g = lane >> 2, t4 = lane & 3, P = C / 128;
  uint32_t a[F_MT][2][4];   // q8 fragments: [row tile][32-byte step][reg]
  float c[F_MT][2];
  RowState st[F_MT];
#pragma unroll
  for (int mt = 0; mt < F_MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = q0 + 16 * (F_MT * w + mt) + g + 8 * hh;
      const bool in = i < Nq;
      const int8_t* row = q8 + ((long)b * Nq + (in ? i : 0)) * C + h * D;
      c[mt][hh] = in ? cs[((long)b * Nq + i) * P + (h >> 1)] : 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t* r32 =
            reinterpret_cast<const uint32_t*>(row + 32 * kk + 4 * t4);
        a[mt][kk][hh] = in ? r32[0] : 0u;        // bytes 4t .. 4t + 3
        a[mt][kk][2 + hh] = in ? r32[4] : 0u;    // bytes 16 + 4t ..
      }
    }
    st[mt].zero();
  }
  // ldmatrix: matrix mi = lane / 8 holds keys 8j + 8 (mi / 2) + [0, 8) at
  // 16-byte chunk 2 kk + mi % 2: b0, b1 of n-tile j, then of j + 1
  const int mi = lane >> 3, rr = lane & 7;
  const int krow = rr + 8 * (mi >> 1), kch = mi & 1;
  const int cq = 2 * t4;
  int s[F_MT][32];
  float p[F_MT][32], alpha[2];
  for (int i = 0; i < n; ++i) {
    const int slot = i % F_ST;
    mbar_wait(sm.full(slot), (i / F_ST) & 1);
    const uint32_t kb = smem_u32(sm.k(slot));
#pragma unroll
    for (int mt = 0; mt < F_MT; ++mt)
#pragma unroll
      for (int e = 0; e < 32; ++e) s[mt][e] = 0;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int j = 0; j < FKT / 8; j += 2) {
        uint32_t bb[4];
        f32e::ldsm_x4(bb, kb + k8_off(8 * j + krow, 2 * kk + kch));
#pragma unroll
        for (int mt = 0; mt < F_MT; ++mt) {
          mma_s8(s[mt] + 4 * j, a[mt][kk], bb[0], bb[1]);
          mma_s8(s[mt] + 4 * j + 4, a[mt][kk], bb[2], bb[3]);
        }
      }
#pragma unroll
    for (int mt = 0; mt < F_MT; ++mt) {
      int8_step_f32(st[mt], cq, s[mt], c[mt], sm.bias(slot), p[mt], alpha);
      rescale(st[mt], alpha);
    }
    f32e::pv<D>(sm.v(slot), p, st);
    mbar_arrive(sm.empty(slot));
  }
#pragma unroll
  for (int mt = 0; mt < F_MT; ++mt) {
    const Rows rw = f32e::tile_rows(F_MT * w + mt);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = q0 + (hh ? rw.r1 : rw.r0);
      if (i >= Nq) continue;
      const float l = st[mt].l[hh];
      f32e::store_row(st[mt], rw, hh, 1.f / (l == 0.f ? 1.f : l),
                      out + ((long)b * Nq + i) * C + h * D);
    }
  }
}

// A (B, N, C) int8 tensor as a 3-D map (C, N, B), boxes of 64 bytes x
// ``rows`` rows of one batch, 64B swizzle, zeros outside.
static cudaError_t make_map_i8(CUtensorMap* map, const void* base, int B,
                               int N, int C, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C, (cuuint64_t)N * C};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, base, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_64B);
}

P3_ERROR_STRING_FN

// The pre-passes: q8 and c, then the key tiles of BT keys.
template <int BT, typename T>
static cudaError_t prepass(const void* q, const void* qcos, const void* qsin,
                           const void* bias, void* q8, void* c, void* bl,
                           void* list, void* count, int B, int Nq, int Nk,
                           int C, cudaStream_t st) {
  const long items = (long)B * Nq * (C / 128);
  int8_qprep<<<blocks_for(items * 16), 256, 0, st>>>(
      static_cast<const T*>(q), static_cast<const float*>(qcos),
      static_cast<const float*>(qsin), static_cast<int8_t*>(q8),
      static_cast<float*>(c), items, C);
  const int nt = (Nk + BT - 1) / BT;
  cross_tiles<BT><<<B, 1024, nt * sizeof(int), st>>>(
      static_cast<const float*>(bias), static_cast<float*>(bl),
      static_cast<int*>(list), static_cast<int*>(count), Nk, nt);
  return cudaGetLastError();
}

// q, v (B, Nq | Nk, C) bf16; k8 (B, Nk, C) int8; qcos/qsin (B, Nq, 64) f32
// pre-scaled; bias (B, Nk) f32 (raw: the pre-pass takes log2 units) or
// null; out (B, Nq, C) bf16.  C % 128 == 0 (head pairs of d=64).  Scratch
// from the caller, with nt = ceil(Nk / 128): q8 (B, Nq, C) int8, c (B, Nq,
// C / 128) f32, bl (B, nt * 128) f32, list (B, nt) and count (B) int32.
// nwg: the caller's consumer warpgroups per CTA, which must be NWG.
extern "C" int p3_tower_cross_int8_sm90(
    const void* q, const void* k8, const void* v, const void* qcos,
    const void* qsin, const void* bias, void* out, void* q8, void* c,
    void* bl, void* list, void* count, int B, int Nq, int Nk, int C,
    int nwg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = (Nk + BKT - 1) / BKT;
  if (B < 1 || Nq < 1 || Nk < 1 || C % 128 != 0 || nt * 4L > 48 * 1024 ||
      nwg != NWG)
    return cudaErrorInvalidValue;
  cudaError_t err = prepass<BKT, bf16>(q, qcos, qsin, bias, q8, c, bl, list,
                                       count, B, Nq, Nk, C, st);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv;
  if ((err = make_map_i8(&mq, q8, B, Nq, C, BQW)) != cudaSuccess ||
      (err = make_map_i8(&mk, k8, B, Nk, C, BKT)) != cudaSuccess ||
      (err = make_map(&mv, v, B, Nk, C, BKT)) != cudaSuccess)
    return err;
  const int bytes = I8Smem::kBytes;
  if ((err = prepare(int8_main, bytes)) != cudaSuccess) return err;
  const dim3 grid((Nq + NWG * BQW - 1) / (NWG * BQW), C / D, B);
  int8_main<<<grid, (NWG + 1) * 128, bytes, st>>>(
      mq, mk, mv, static_cast<const float*>(c),
      static_cast<const float*>(bl), static_cast<const int*>(list),
      static_cast<const int*>(count), static_cast<bf16*>(out), Nq, C, nt);
  return cudaGetLastError();
}

// As p3_tower_cross_int8_sm90 in f32: q, v and out f32, and key tiles of
// 64 keys (nt = ceil(Nk / 64) in the scratch's shapes).
extern "C" int p3_tower_cross_int8_f32_sm90(
    const void* q, const void* k8, const void* v, const void* qcos,
    const void* qsin, const void* bias, void* out, void* q8, void* c,
    void* bl, void* list, void* count, int B, int Nq, int Nk, int C,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = (Nk + FKT - 1) / FKT;
  if (B < 1 || Nq < 1 || Nk < 1 || C % 128 != 0 || nt * 4L > 48 * 1024)
    return cudaErrorInvalidValue;
  cudaError_t err = prepass<FKT, float>(q, qcos, qsin, bias, q8, c, bl, list,
                                        count, B, Nq, Nk, C, st);
  if (err != cudaSuccess) return err;
  CUtensorMap mk, mv;
  if ((err = make_map_i8(&mk, k8, B, Nk, C, FKT)) != cudaSuccess ||
      (err = f32e::make_map(&mv, v, B, Nk, C, FKT)) != cudaSuccess)
    return err;
  const int bytes = F32Smem::kBytes;
  if ((err = prepare(int8_main_f32, bytes)) != cudaSuccess) return err;
  const dim3 grid((Nq + F_R - 1) / F_R, C / D, B);
  int8_main_f32<<<grid, (F_NW + 1) * 32, bytes, st>>>(
      mk, mv, static_cast<const int8_t*>(q8), static_cast<const float*>(c),
      static_cast<const float*>(bl), static_cast<const int*>(list),
      static_cast<const int*>(count), static_cast<float*>(out), Nq, C, nt);
  return cudaGetLastError();
}
