// Hopper engine of the bf16 forwards of K1 (tower_self_sm90.cu), K2
// (tower_cross_sm90.cu) and K6 (packed_flash_sm90.cu): d=64 heads, keys in
// tiles of 128.  K3 (masked_attn_sm90.cu, d=96, 64-key tiles) reuses its
// barriers, TMA and wgmma wrappers, its softmax step and its row state
// with a layout of its own (32-lane sub-tiles of 64-byte rows, 64B
// swizzle: desc_k_sub, desc_mn_sub); so do K2-int8 (tower_cross_int8_sm90.cu:
// int8 scores from wgmma s8), K4 (flash_fwd_bf16_sm90.cu: d=64 in this
// layout, d=96 in K3's) and the bf16 K5 (flash_bwd_bf16_sm90.cu: K3's
// layout at d=64 and d=96), which also take the key pre-pass cross_tiles
// and, K4 and K5, the rotation rope_bf16.  The K5 pieces both dtypes share
// (logit, row_stats, dkv_merge) sit here too.
//
// A CTA holds NWG (1 or 2) consumer warpgroups and one producer
// warpgroup, in that order.  Consumer warpgroup g owns query rows
// [64g, 64g + 64) of the CTA's tile of one (batch, head).  One thread of
// the producer issues every load through the Tensor Memory Accelerator:
// the Q tile once, then K and V tiles of 128 keys x 64 lanes (and, for
// K2, the tile's 128 key biases as a bulk copy) into a ring of STAGES
// slots, each slot with a "full" mbarrier (completed by the copies'
// byte count) and an "empty" mbarrier (one arrival per consumer thread).
// The producer lowers its registers with setmaxnreg and the consumers
// raise theirs.
//
// Global tensors are 3-D maps (lanes, tokens, batch) with 128-byte
// swizzle: a bf16 row of 64 lanes is exactly 128 bytes.  A box at the
// ragged end of a batch reads zeros, never the next batch's rows.
//
// Per key tile a consumer warpgroup computes S = Q K^T with wgmma
// m64n128k16 (both operands from shared memory, f32 accumulators in
// registers), runs the online softmax on those registers (a row lives
// on the four lanes of a quad: shuffles 1 and 2), rounds P to bf16 in
// registers and feeds it as the register A operand of wgmma m64n64k16
// against V (an MN-major B operand), into O (64 x 64 f32 per warpgroup),
// which stays in registers for the whole key walk.
//
// Semantics (attn_common.cuh's NEG, and the plain versions in
// panst3r_torch/ops/*_attention.py): logits live in log2 units
// (log2 e folded into the scale, so exp2 replaces exp); a masked logit is
// NEG and a logit <= NEG/2 gives p = 0 exactly; the running max is
// replaced by 0 while a row has seen no live key; p is rounded to bf16
// before it enters the numerator and the rounded p goes into the row sum
// (K6 sums the unrounded p: ``RoundedSum`` false); a row with no live key
// writes 0.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace p3 {
namespace sm90 {

constexpr int D = 64;           // head dim
constexpr int BKT = 128;        // keys per tile
constexpr int BQW = 64;         // query rows per consumer warpgroup
constexpr int STAGES = 3;       // K/V ring slots
constexpr float L2E = 1.4426950408889634f;
constexpr uint32_t kQBytes = BQW * D * 2;     // 8 KB
constexpr uint32_t kKVBytes = BKT * D * 2;    // 16 KB
constexpr uint32_t kBiasBytes = BKT * 4;      // 512 B

// Dynamic shared memory of a CTA with NWG consumer warpgroups; every
// swizzled tile starts on a 1024-byte boundary of the aligned base.
template <int NWG>
struct Smem {
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + NWG * kQBytes;
  static constexpr uint32_t kV = kK + STAGES * kKVBytes;
  static constexpr uint32_t kBias = kV + STAGES * kKVBytes;
  static constexpr uint32_t kBar = kBias + STAGES * kBiasBytes;
  static constexpr uint32_t kEnd = kBar + (1 + 2 * STAGES) * 8;
  static constexpr int kBytes = kEnd + 1024;    // room to align the base

  unsigned char* base;
  __device__ explicit Smem(unsigned char* raw)
      : base(reinterpret_cast<unsigned char*>(
            (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023))) {}
  __device__ unsigned char* q(int g) const { return base + kQ + g * kQBytes; }
  __device__ unsigned char* k(int s) const { return base + kK + s * kKVBytes; }
  __device__ unsigned char* v(int s) const { return base + kV + s * kKVBytes; }
  __device__ float* bias(int s) const {
    return reinterpret_cast<float*>(base + kBias + s * kBiasBytes);
  }
  __device__ uint64_t* q_full() const {
    return reinterpret_cast<uint64_t*>(base + kBar);
  }
  __device__ uint64_t* full(int s) const { return q_full() + 1 + s; }
  __device__ uint64_t* empty(int s) const {
    return q_full() + 1 + STAGES + s;
  }
};

// Element strides of a (B, H, N, D) operand with a unit stride over D.
struct Strides3 {
  long long b, h, n;
};
// Element strides of a dense bias (batch, head, query, key), 0 where it is
// broadcast.
struct BiasStrides {
  long long b, h, q, k;
};
// Where the token, head and batch coordinates of a box go among a 4-D
// map's dims 1..3 (make_map4).
struct Perm {
  int tok, head, batch;
};

__device__ __forceinline__ int pick(int slot, const Perm& p, int tok, int h,
                                    int b) {
  return p.tok == slot ? tok : (p.head == slot ? h : b);
}

// ---------------------------------------------------------------- PTX ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the barrier's current phase differs from ``parity``.  A wait
// past ~2^35 cycles (seconds) can only be a fault: trap, so that the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1LL << 35)) __trap();
  } while (!done);
}

// One box of a 3-D tensor map at (lane, token, batch) into shared memory.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// One box of a 2-D tensor map at (c0, c1).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// One box of a 4-D tensor map at (c0, c1, c2, c3).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ``bytes`` contiguous bytes (a multiple of 16, 16-byte aligned).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma (its results land at wg_wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <uint32_t RegCount>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(RegCount));
}
template <uint32_t RegCount>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(RegCount));
}

// wgmma shared-memory descriptor of a 128B-swizzled tile whose base is
// 1024-byte aligned: start address, leading and stride byte offsets in
// 16-byte units, layout type 1 (128B swizzle), base offset 0.
// Layout type 2 is the 64B swizzle (K3's 32-lane sub-tiles).
template <uint64_t Layout = 1>
__device__ __forceinline__ uint64_t desc_sw(const void* p, uint32_t lbo,
                                           uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo & 0x3FFF) << 16) |
         (static_cast<uint64_t>(sbo & 0x3FFF) << 32) | (Layout << 62);
}
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return desc_sw<1>(p, lbo, sbo);
}
// K-major operand (Q, K: 64 lanes = 128 B per row): 8-row groups 1024 B
// apart (SBO); LBO is unused for a swizzled K-major operand.  Step kk of
// 16 lanes starts 32 bytes further.
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile, int kk) {
  return desc_sw128(tile, 1, 64) + static_cast<uint64_t>(2 * kk);
}
// MN-major operand (V: a key per 128-byte row of 64 lanes): step kk covers
// keys [16kk, 16kk + 16), two 8-key groups 1024 B apart.  N = 64 lanes is
// one swizzle atom, so the MN repeat offset is unused; both offsets are
// set to the 8-key stride.
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile, int kk) {
  return desc_sw128(tile, 64, 64) + static_cast<uint64_t>(128 * kk);
}

// K3's layout (64B swizzle): a tile of R rows as D/32 sub-tiles of 32
// lanes, each R rows of 64 bytes (R * 64 bytes).  K-major operand: step kk
// of 16 lanes is in sub-tile kk / 2, 32 bytes in for odd kk; 8-row groups
// 512 B apart (SBO).
template <int R>
__device__ __forceinline__ uint64_t desc_k_sub(const unsigned char* tile,
                                               int kk) {
  return desc_sw<2>(tile + (kk >> 1) * (R * 64), 1, 32) +
         static_cast<uint64_t>(2 * (kk & 1));
}
// MN-major operand (a row per 64-byte row of each 32-lane sub-tile): step
// kk covers rows [16kk, 16kk + 16), two 8-row groups 512 B apart (SBO);
// the 32-lane atoms along N are the sub-tiles, R * 64 bytes apart (LBO).
template <int R>
__device__ __forceinline__ uint64_t desc_mn_sub(const unsigned char* tile,
                                                int kk) {
  return desc_sw<2>(tile, (R * 64) >> 4, 32) + static_cast<uint64_t>(64 * kk);
}

// ------------------------------------------------------------ wgmma ----

// D (64 x 128, f32 in registers) += A (64 x 16, smem) . B (128 x 16, smem)^T,
// both operands K-major behind 128B-swizzle descriptors.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32 in registers) += A (64 x 16, bf16 in registers) .
// B (16 x 64, smem, MN-major behind a 128B-swizzle descriptor).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


// D (64 x 64, f32 in registers) += A (64 x 16, smem) . B (64 x 16, smem)^T,
// both operands K-major behind swizzle descriptors (K3's scores).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 32, f32 in registers) += A (64 x 16, smem) . B (32 x 16, smem)^T,
// both operands K-major behind swizzle descriptors (the bf16 K5's S^T).
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 96, f32 in registers) += A (64 x 16, bf16 in registers) .
// B (16 x 96, smem, MN-major behind a swizzle descriptor) (K3's P V).
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


// D (64 x 128, f32 in registers) += A (64 x 16, bf16 in registers) .
// B (16 x 128, smem, MN-major behind a swizzle descriptor) (the d=128 P V
// of K4 and K5 in K3's layout).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


// Lanes [d0, d0 + 8) of one d=64 head row (``head`` points at lane 0)
// rotated in f32 lane by lane, x*cos + rot(x)*sin with rot(x)[d] = d&16 ?
// x[d-16] : -x[d+16] (so the chunk's partner is the chunk at d0 ^ 16), times
// ``mul`` (1 leaves them exact), rounded to bf16 and stored as one 16-byte
// vector.  Without tables the lanes are only multiplied.
__device__ __forceinline__ void rope8(const __nv_bfloat16* __restrict__ head,
                                      const float* __restrict__ cs,
                                      const float* __restrict__ sn, int d0,
                                      float mul,
                                      __nv_bfloat16* __restrict__ dst) {
  const uint4 xv = *reinterpret_cast<const uint4*>(head + d0);
  const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&xv);
  __align__(16) __nv_bfloat16 o[8];
  if (cs == nullptr) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j] = __float2bfloat16_rn(mul * __bfloat162float(x[j]));
    }
  } else {
    const uint4 pv = *reinterpret_cast<const uint4*>(head + (d0 ^ 16));
    const __nv_bfloat16* xp = reinterpret_cast<const __nv_bfloat16*>(&pv);
    const float4 c0 = *reinterpret_cast<const float4*>(cs + d0);
    const float4 c1 = *reinterpret_cast<const float4*>(cs + d0 + 4);
    const float4 s0 = *reinterpret_cast<const float4*>(sn + d0);
    const float4 s1 = *reinterpret_cast<const float4*>(sn + d0 + 4);
    const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float xf = __bfloat162float(x[j]), pf = __bfloat162float(xp[j]);
      const float r = xf * c[j] + ((d0 & 16) ? pf : -pf) * s[j];
      o[j] = __float2bfloat16_rn(mul * r);
    }
  }
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Reads element (r, d) of a 64-lane bf16 tile written by TMA with 128B
// swizzle (16-byte chunk c of row r sits at chunk c ^ (r % 8)).
__device__ __forceinline__ float swz_at(const unsigned char* tile, int r,
                                        int d) {
  const int off = r * 128 + ((((d >> 3) ^ (r & 7))) << 4) + (d & 7) * 2;
  return __bfloat162float(
      *reinterpret_cast<const __nv_bfloat16*>(tile + off));
}

// ------------------------------------------------- a consumer's state ----
//
// Thread t of a warpgroup (warp w, lane ln) holds rows r0 = 16w + ln/4 and
// r1 = r0 + 8 of the warpgroup's 64.  Accumulator register i of an
// m64nN tile sits at row (i/2 % 2 ? r1 : r0), column 8(i/4) + 2(ln%4) +
// i%2: S has 64 registers (128 keys), O 32 (64 lanes).
struct Rows {
  int r0, r1, cq;
  __device__ Rows() {
    const int t = threadIdx.x & 127, w = t >> 5, ln = t & 31;
    r0 = 16 * w + (ln >> 2);
    r1 = r0 + 8;
    cq = 2 * (ln & 3);
  }
  __device__ static int col(int i) { return 8 * (i >> 2) + (i & 1); }
  __device__ static int hi(int i) { return (i >> 1) & 1; }
};

// O has NO registers: 32 for 64 lanes, 48 for K3's 96.
template <int NO>
struct RowStateN {
  float o[NO];
  float m[2], l[2];  // running max (log2 units) and row sum, rows r0/r1
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    m[0] = m[1] = NEG;
    l[0] = l[1] = 0.f;
  }
};
using RowState = RowStateN<32>;

// 2^x on the special-function unit (relative error 2^-22, subnormal
// results flushed to 0): every value it gives is rounded to bf16 or
// scales an f32 sum.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
// s32 accumulators (K2-int8's scores)
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Issues S = Q K^T for one key tile (one commit group).
__device__ __forceinline__ void issue_scores(float (&s)[64],
                                             const unsigned char* q,
                                             const unsigned char* k) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n128(s, desc_kmajor(q, kk), desc_kmajor(k, kk), kk > 0);
  wg_commit();
}

// Issues O += P V for one key tile (one commit group).  P's accumulator
// layout is the A-operand layout of this product: keys [16kk, 16kk + 16)
// are P registers 4kk .. 4kk + 3 (S registers 8kk .. 8kk + 7).
__device__ __forceinline__ void issue_pv(float (&o)[32],
                                         const uint32_t (&p)[32],
                                         const unsigned char* v) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BKT / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3]};
    wgmma_rs_n64(o, a, desc_mnmajor(v, kk), 1);
  }
  wg_commit();
}

// The online-softmax step on a finished S of NS registers (64: 128 keys,
// 32: 64 keys): logits (``logit(raw, key)``, key in the tile, log2 units,
// NEG where masked), the new row max, P rounded to bf16 and packed in
// pairs, the row sum of the rounded P (of the unrounded f32 p without
// ``RoundedSum``).  Leaves O alone: returns the factor ``alpha`` O must be
// scaled by.
template <bool RoundedSum = true, int NO, int NS, class Logit>
__device__ __forceinline__ void softmax_step(RowStateN<NO>& st, const Rows& rw,
                                             float (&s)[NS],
                                             uint32_t (&p)[NS / 2],
                                             float (&alpha)[2], Logit logit) {
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    s[i] = logit(s[i], Rows::col(i) + rw.cq);
    mx[Rows::hi(i)] = fmaxf(mx[Rows::hi(i)], s[i]);
  }
  float safe[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(st.m[h], quad_max(mx[h]));
    safe[h] = (m_new <= 0.5f * NEG) ? 0.f : m_new;
    alpha[h] = (st.m[h] <= 0.5f * NEG) ? 0.f : exp2_approx(st.m[h] - safe[h]);
    st.m[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < NS; i += 2) {
    const int h = Rows::hi(i);
    const float x0 = s[i], x1 = s[i + 1];
    const float f0 = (x0 <= 0.5f * NEG) ? 0.f : exp2_approx(x0 - safe[h]);
    const float f1 = (x1 <= 0.5f * NEG) ? 0.f : exp2_approx(x1 - safe[h]);
    const __nv_bfloat16 b0 = __float2bfloat16_rn(f0);
    const __nv_bfloat16 b1 = __float2bfloat16_rn(f1);
    sum[h] += RoundedSum ? __bfloat162float(b0) + __bfloat162float(b1)
                         : f0 + f1;
    p[i / 2] = pack_bf16(b0, b1);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) st.l[h] = st.l[h] * alpha[h] + quad_sum(sum[h]);
}

template <int NO>
__device__ __forceinline__ void rescale(RowStateN<NO>& st,
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < NO; ++i) st.o[i] *= alpha[Rows::hi(i)];
}

// A consumer warpgroup's walk over the ``n`` key tiles of its CTA: per
// tile, S, the softmax step, O = alpha O + P V, then the tile's ring slot
// is released.  ``logit(raw, key, i, stage)`` maps a raw score of key
// ``key`` of the i-th tile (in ring slot ``stage``) to its logit.
template <bool RoundedSum = true, int NWG, class Logit>
__device__ __forceinline__ void consume(const Smem<NWG>& sm, int wg, int n,
                                        RowState& st, const Rows& rw,
                                        Logit logit) {
  const unsigned char* q = sm.q(wg);
  float s[64], alpha[2];
  uint32_t p[32];
  for (int i = 0; i < n; ++i) {
    const int cur = i % STAGES;
    mbar_wait(sm.full(cur), (i / STAGES) & 1);
    issue_scores(s, q, sm.k(cur));
    wg_wait<0>();
    fence_regs(s);
    softmax_step<RoundedSum>(
        st, rw, s, p, alpha,
        [&](float raw, int c) { return logit(raw, c, i, cur); });
    rescale(st, alpha);
    issue_pv(st.o, p, sm.v(cur));
    wg_wait<0>();
    fence_regs(st.o);
    fence_regs(p);  // the product reads p until it completes
    mbar_arrive(sm.empty(cur));
  }
}

// The producer's load loop, run by one thread: the Q tiles once, then the
// key tiles ``tile(0) .. tile(n - 1)`` through the ring.
// ``load_q(g, dst, bar)`` loads warpgroup g's Q tile; ``load_kv(tile, k,
// v, bias, bar)`` a key tile (``kv_bytes`` bytes in all).
template <int NWG, class LoadQ, class TileAt, class LoadKV>
__device__ __forceinline__ void produce(const Smem<NWG>& sm, int n,
                                        uint32_t kv_bytes, LoadQ load_q,
                                        TileAt tile, LoadKV load_kv) {
  mbar_expect_tx(sm.q_full(), NWG * kQBytes);
#pragma unroll
  for (int g = 0; g < NWG; ++g) load_q(g, sm.q(g), sm.q_full());
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    mbar_wait(sm.empty(s), ((i / STAGES) & 1) ^ 1);
    mbar_expect_tx(sm.full(s), kv_bytes);
    load_kv(tile(i), sm.k(s), sm.v(s), sm.bias(s), sm.full(s));
  }
}

// Barrier set-up by thread 0, visible to the CTA after the __syncthreads
// that follows.
template <int NWG>
__device__ __forceinline__ void init_barriers(const Smem<NWG>& sm) {
  if (threadIdx.x == 0) {
    mbar_init(sm.q_full(), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Registers after setmaxnreg: the producer warpgroup drops to kProducer
// and the consumers rise to kConsumer; the CTA's pool, (NWG + 1) * 128
// threads at the launch bound's count, is unchanged.
template <int NWG>
struct Regs;
template <>
struct Regs<1> {  // two CTAs per SM: 128 registers a thread at launch
  static constexpr int kMinBlocks = 2;
  static constexpr uint32_t kProducer = 40;
  static constexpr uint32_t kConsumer = 216;
};
template <>
struct Regs<2> {  // one CTA per SM: 168 registers a thread at launch
  static constexpr int kMinBlocks = 1;
  static constexpr uint32_t kProducer = 24;
  static constexpr uint32_t kConsumer = 240;
};

// Stores rows r0/r1 of O / l as bf16 pairs: ``row_ptr(r)`` is the output
// row of warpgroup row r (null past the last query).
template <int NO, class RowPtr>
__device__ __forceinline__ void store_normalized(const RowStateN<NO>& st,
                                                 const Rows& rw,
                                                 RowPtr row_ptr) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    __nv_bfloat16* out = row_ptr(h ? rw.r1 : rw.r0);
    if (out == nullptr) continue;
    const float inv = 1.f / (st.l[h] == 0.f ? 1.f : st.l[h]);
#pragma unroll
    for (int i = 0; i < NO; i += 2) {
      if (Rows::hi(i) != h) continue;
      const int c = Rows::col(i) + rw.cq;
      *reinterpret_cast<__nv_bfloat162*>(out + c) =
          __floats2bfloat162_rn(st.o[i] * inv, st.o[i + 1] * inv);
    }
  }
}

// The key pre-pass of K2, K2-int8 and K4: one block of 1024 threads per
// batch.  Warp w takes tiles w, w + 32, ... of BT keys: the bias in log2
// units padded to ``nt`` whole tiles (NEG where dead or past Nk) and the
// tile's liveness (a key with a bias above finfo.min/2; no bias: every key
// below Nk is live); then warp 0 writes the live tiles in order and their
// count.
template <int BT>
__global__ void cross_tiles(const float* __restrict__ bias,
                            float* __restrict__ bl, int* __restrict__ list,
                            int* __restrict__ count, int Nk, int nt) {
  extern __shared__ int live_tile[];
  const int b = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < nt; t += 32) {
    bool any = false;
#pragma unroll
    for (int c = lane; c < BT; c += 32) {
      const int j = t * BT + c;
      const float x = (j < Nk) ? (bias ? bias[(long)b * Nk + j] : 0.f) : NEG;
      const bool live = x > 0.5f * NEG;
      bl[((long)b * nt + t) * BT + c] = live ? x * L2E : NEG;
      any |= live;
    }
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) live_tile[t] = any;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int t0 = 0; t0 < nt; t0 += 32) {
      const int t = t0 + lane;
      const bool f = t < nt && live_tile[t];
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) list[b * nt + n + __popc(m & ((1u << lane) - 1))] = t;
      n += __popc(m);
    }
    if (lane == 0) count[b] = n;
  }
}

// x (B, H, N, D) through its strides, rotated in f32 by (B, N, D) tables
// (rotate-half within each D/2 half: lane d's partner is d + D/4 in the
// first quarter of a half and d - D/4 in its second), each product and the
// sum rounded as the plain version's, then rounded to bf16, into (B, H, N,
// D) contiguous: one thread per 8 lanes (16-byte accesses; the partner
// lanes, D/4 = 16 or 24 away, are as aligned).  The bf16 K4's and K5's
// pre-pass.
template <int D>
__global__ void rope_bf16(const __nv_bfloat16* __restrict__ x, Strides3 st,
                          const float* __restrict__ cs,
                          const float* __restrict__ sn,
                          __nv_bfloat16* __restrict__ y, int H, int N,
                          long long chunks) {
  constexpr int Q = D / 4, PER = D / 8;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < chunks; e += (long long)gridDim.x * blockDim.x) {
    const int d0 = static_cast<int>(e % PER) * 8;
    const long long row = e / PER;
    const int n = static_cast<int>(row % N);
    const long long bh = row / N;
    const int h = static_cast<int>(bh % H);
    const long long b = bh / H;
    const bool first = (d0 % (D / 2)) < Q;
    const __nv_bfloat16* r = x + b * st.b + h * st.h + n * st.n;
    const uint4 xv = *reinterpret_cast<const uint4*>(r + d0);
    const uint4 pv = *reinterpret_cast<const uint4*>(r + (first ? d0 + Q
                                                               : d0 - Q));
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(&xv);
    const __nv_bfloat16* ps = reinterpret_cast<const __nv_bfloat16*>(&pv);
    const float* c = cs + (b * N + n) * D + d0;
    const float* s = sn + (b * N + n) * D + d0;
    __align__(16) __nv_bfloat16 o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float pf = __bfloat162float(ps[j]);
      o[j] = __float2bfloat16_rn(
          __fadd_rn(__fmul_rn(__bfloat162float(xs[j]), c[j]),
                    __fmul_rn(first ? -pf : pf, s[j])));
    }
    *reinterpret_cast<uint4*>(y + row * D + d0) =
        *reinterpret_cast<const uint4*>(o);
  }
}

// ----------------------------------------------- K5, both dtypes ----
//
// The flash backward (flash_bwd_sm90.cu in f32, flash_bwd_bf16_sm90.cu in
// bf16) recomputes p = exp2(x - LSE log2 e) from K4's LSE.

// A padding or dead row's LSE in log2 units: p = 0 against it.
constexpr float DEAD = -NEG;

// The logit (log2 units, NEG where masked) of a raw score: raw * sl (sl =
// scale * log2 e) plus the key's bias in log2 units, plus the dense bias
// ``db`` when there is one (masked where either is <= finfo.min / 2).
__device__ __forceinline__ float logit(float raw, float sl, float kb,
                                       const float* db) {
  float x = fmaf(raw, sl, kb);
  if (db != nullptr) {
    const float v = *db;
    x = (v <= 0.5f * NEG) ? NEG : __fmaf_rn(v, L2E, x);
  }
  return (x <= 0.5f * NEG) ? NEG : x;
}

// p of one score: ``x`` the logit (log2 units, NEG where masked), ``l``
// the row's LSE in log2 units (DEAD: p = 0).
__device__ __forceinline__ float prob(float x, float l) {
  return (x <= 0.5f * NEG || l >= 0.5f * DEAD) ? 0.f : exp2_approx(x - l);
}

// ds = p (dp - Dvec) scale.
__device__ __forceinline__ float dscore(float p, float dp, float dv,
                                        float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, dv)), scale);
}

// One warp per row of (B*H, Nqp): the LSE (natural log, (B, H, Nq)) in
// log2 units, DEAD (p = 0) for a row with no live key, for padding and
// past Nq; Dvec = sum_d do * o in f32 (0 past Nq), each lane's lanes d,
// d + 32, ... by fmaf, then a butterfly over the warp: an order that
// depends on D alone (torch's reduction order follows the row count, so a
// query range's Dvec could differ from the whole call's in its last bit).
// do and o are read in their own types (f32 or bf16), unrounded.
template <int D, typename TG, typename TO = TG>
__global__ void row_stats(const float* __restrict__ lse,
                          const TG* __restrict__ g, Strides3 gs,
                          const TO* __restrict__ o, Strides3 os,
                          float* __restrict__ lse2, float* __restrict__ dv2,
                          int H, int Nq, int Nqp, long long rows) {
  const int lane = threadIdx.x & 31;
  const long long stride = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long r = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
       r < rows; r += stride) {
    const int i = static_cast<int>(r % Nqp);
    const long long bh = r / Nqp, b = bh / H;
    const int h = static_cast<int>(bh % H);
    float l = DEAD, acc = 0.f;
    if (i < Nq) {
      const TG* gr = g + b * gs.b + h * gs.h + i * gs.n;
      const TO* orow = o + b * os.b + h * os.h + i * os.n;
#pragma unroll
      for (int d = lane; d < D; d += 32)
        acc = fmaf(to_f(gr[d]), to_f(orow[d]), acc);
      l = lse[bh * Nq + i];
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, m));
    if (lane == 0) {
      lse2[r] = (l <= 0.5f * NEG || l >= 0.5f * DEAD) ? DEAD : l * L2E;
      dv2[r] = acc;
    }
  }
}

// dk = sum_s part_k[s], dv likewise, added in split order.
__global__ void dkv_merge(const float* __restrict__ pk,
                          const float* __restrict__ pv_,
                          float* __restrict__ dk, float* __restrict__ dv,
                          long long total, int ns) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    float a = pk[e], c = pv_[e];
    for (int s = 1; s < ns; ++s) {
      a = __fadd_rn(a, pk[s * total + e]);
      c = __fadd_rn(c, pv_[s * total + e]);
    }
    dk[e] = a;
    dv[e] = c;
  }
}

// Grid of a grid-stride pass over ``total`` elements.
inline int blocks_for(long long total) {
  const long long b = (total + 255) / 256;
  return static_cast<int>(b < 132LL * 32 ? b : 132LL * 32);
}

// ------------------------------------------------------------- host ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the CUDA runtime, so the
// library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err != cudaSuccess || res != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tiled map of ``rank`` dims (dims[0] contiguous; ``strides`` in bytes
// for dims 1..rank-1, multiples of 16), zeros outside.
inline cudaError_t encode_map(CUtensorMap* map, CUtensorMapDataType type,
                              int rank, const void* base,
                              const cuuint64_t* dims, const cuuint64_t* strides,
                              const cuuint32_t* box,
                              CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = enc(map, type, rank, const_cast<void*>(base), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A (B, N, W) bf16 tensor as a 3-D map (W, N, B), boxes of ``rows`` tokens x
// 64 lanes of one batch, 128-byte swizzle, zeros outside.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int B, int N,
                            int W, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 2, (cuuint64_t)N * W * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// rope_bf16 over the bf16 x (B, H, N, D) with element strides s[0..2]
// into y (B, H, N, D) contiguous.
template <int D>
inline cudaError_t rotate_bf16(const __nv_bfloat16* x, const long long* s,
                               const float* cs, const float* sn,
                               __nv_bfloat16* y, int B, int H, int N,
                               cudaStream_t st) {
  const long long chunks = (long long)B * H * N * (D / 8);
  rope_bf16<D><<<blocks_for(chunks), 256, 0, st>>>(
      x, Strides3{s[0], s[1], s[2]}, cs, sn, y, H, N, chunks);
  return cudaGetLastError();
}

// A (B, H, N, D) tensor of ``elem``-byte values with element strides (sb,
// sh, sn), each a positive multiple of 16 bytes, and a unit lane stride as
// a 4-D map: lanes, then token, head and batch in ascending order of
// stride (a dim of size 1 last), boxes of ``box`` lanes x ``rows`` tokens,
// zeros outside.  ``perm`` receives where each coordinate goes.
inline cudaError_t make_map4(CUtensorMap* map, CUtensorMapDataType type,
                             int elem, const void* base, int B, int H, int N,
                             int D, long long sb, long long sh, long long sn,
                             int box, int rows, CUtensorMapSwizzle swizzle,
                             Perm* perm) {
  struct Dim {
    long long size, stride;
    int id;  // 0 token, 1 head, 2 batch
  };
  Dim d[3] = {{N, sn, 0}, {H, sh, 1}, {B, sb, 2}};
  long long widest = D;
  for (const Dim& x : d) {
    if (x.size > 1 && (x.stride <= 0 || (x.stride * elem) % 16 != 0))
      return cudaErrorInvalidValue;
    if (x.size > 1 && x.stride > widest) widest = x.stride;
  }
  auto key = [](const Dim& x) {
    return x.size > 1 ? x.stride : (1LL << 62);
  };
  for (int i = 0; i < 3; ++i)  // three entries: insertion sort
    for (int j = i; j > 0 && key(d[j]) < key(d[j - 1]); --j) {
      const Dim t = d[j];
      d[j] = d[j - 1];
      d[j - 1] = t;
    }
  cuuint64_t dims[4] = {(cuuint64_t)D, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t boxes[4] = {(cuuint32_t)box, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<cuuint64_t>(d[i].size);
    // a dim of size 1 is never stepped: any valid stride does
    strides[i] =
        static_cast<cuuint64_t>(d[i].size > 1 ? d[i].stride : widest) * elem;
    if (d[i].id == 0) boxes[i + 1] = static_cast<cuuint32_t>(rows);
    (d[i].id == 0 ? perm->tok : d[i].id == 1 ? perm->head : perm->batch) = i;
  }
  return encode_map(map, type, 4, base, dims, strides, boxes, swizzle);
}

}  // namespace sm90
}  // namespace p3
