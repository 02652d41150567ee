// Hopper engine of the f32 forwards of K2 (tower_cross_sm90.cu, f32
// branch: d=64, 128-row CTAs), K2-int8 (tower_cross_int8_sm90.cu, f32
// branch: P.V only) and K3 (masked_attn_sm90.cu, f32: d=96, 64-row CTAs):
// 3xTF32 tensor-core products, a TMA ring, the online
// softmax in registers.  It reuses attn_sm90.cuh's mbarriers, TMA loads,
// tensor-map encoder, row state and quad reductions.
//
// What bounds it.  The f32 paths are held to 1e-4 of their plain versions,
// so a single TF32 product (about three decimal digits) will not do, and
// f32 FMA tops out at 67 TFLOP/s.  3xTF32 keeps f32 accuracy on the tensor
// cores: x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and a.b ~ hi.hi
// + hi.lo + lo.hi accumulated in f32 (the dropped lo.lo is ~2^-22 of the
// product), for a ceiling of 494.7 / 3 ~ 165 TFLOP/s of f32 work.  Below
// that ceiling the instruction issue bounds it: the splits (two cvt and a
// subtraction per operand value) and the operand loads cost more issue
// slots than the mma.sync products themselves (PERF.md, section 6).
//
// Design.
// - Products: mma.sync m16n8k8 tf32 with f32 accumulators, three per
//   product (lo.hi, hi.lo, hi.hi).  Not wgmma: for 32-bit types its B
//   operand must be K-major in shared memory, so P.V would need V
//   transposed and the lo planes of K and V would have to sit in shared
//   memory beside the hi planes (a pre-pass writing K hi/lo and V^T
//   hi/lo).  mma.sync takes both operands from registers, so each K and V
//   value is split in registers as it is loaded and shared memory holds
//   each f32 tile once.  S accumulates in the tensor core; each P.V step
//   is summed in a fresh accumulator and added to O in f32 (mma3_rn).
// - A consumer warp owns MT row tiles of 16 query rows (K2: two, so that
//   each K and V value it splits serves two products; K3: one).  Per row
//   tile, S (16 x 64 keys: 32 registers) and O (16 x d: 32 or 48
//   registers) stay in registers as m16n8 accumulators, which have the
//   layout of attn_sm90.cuh's wgmma accumulators (``Rows``): its row
//   state, softmax semantics and epilogues carry over.  P is fed back as
//   the A operand of P.V without a shuffle: the thread holds P at keys
//   (2t, 2t + 1) of each 8-key step, and the step's key order is permuted
//   to match (A column t <-> key 2t, t + 4 <-> key 2t + 1), so V is read
//   at rows 2t and 2t + 1.
// - Q is split once per CTA into hi (in place) and lo planes in shared
//   memory and re-read per key tile (ldmatrix), which keeps 64 / 96
//   registers of Q fragments per row tile out of the loop.  K fragments
//   come by ldmatrix, V values by 32-bit loads; the tiles are TMA boxes of
//   32 lanes with 128-byte swizzle, so both are free of bank conflicts.
// - Copies: one producer warp issues TMA loads of 64-key K/V tiles (and a
//   per-tile extra: K2's key bias, K3's mask tile) into a ring of ST
//   slots with full/empty mbarriers; consumers never meet at a block-wide
//   barrier after set-up.
//
// Semantics (attn_common.cuh's NEG, and the plain versions in
// panst3r_torch/ops/*_attention.py): logits in log2 units (exp2), a masked
// logit is NEG (finfo(f32).min) and gives p = 0, the running max is
// replaced by 0 while a row has seen no live key, p stays f32 (its
// rounding to the value dtype is exact), a row with no live key writes 0.
// The f32 K2-int8 (tower_cross_int8_sm90.cu) takes its products P.V and
// its row state, with int8 scores of its own (mma.sync s8).
#pragma once

#include "attn_sm90.cuh"

namespace p3 {
namespace f32e {

using sm90::Rows;
using sm90::RowStateN;

constexpr int KT = 64;   // keys per ring entry

// Byte offset of element (r, d) of an f32 tile of R rows written by TMA as
// 32-lane boxes of R rows with 128-byte swizzle: box d / 32 holds rows of
// 128 bytes, and 16-byte chunk c of row r sits at chunk c ^ (r % 8).
template <int R>
__device__ __forceinline__ uint32_t off(int r, int d) {
  return (d >> 5) * (R * 128) + r * 128 +
         ((((d >> 2) & 7) ^ (r & 7)) << 4) + ((d & 3) << 2);
}

// Shared memory of a CTA of NW consumer warps (MT m16 tiles of 16 query
// rows each) and one producer warp, for d = D heads and a ring of ST slots
// with XB extra bytes per slot.  Every tile starts on a 1024-byte
// boundary.
template <int D, int NW, int ST, uint32_t XB, int MT = 1>
struct Smem {
  static constexpr int R = 16 * MT * NW;
  static constexpr int kStages = ST;
  static constexpr int kD = D;
  static constexpr int kNW = NW;
  static constexpr int kMT = MT;
  static constexpr int kThreads = 32 * (NW + 1);
  static constexpr uint32_t kQBytes = R * D * 4;
  static constexpr uint32_t kKVBytes = KT * D * 4;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kQlo = kQ + kQBytes;
  static constexpr uint32_t kK = kQlo + kQBytes;
  static constexpr uint32_t kV = kK + ST * kKVBytes;
  static constexpr uint32_t kX = kV + ST * kKVBytes;
  static constexpr uint32_t kBar = kX + ST * XB;
  static constexpr uint32_t kEnd = kBar + (1 + 2 * ST) * 8;
  static constexpr int kBytes = kEnd + 1024;   // room to align the base
  static_assert(XB % 16 == 0 && kBytes <= 232448, "shared memory");

  unsigned char* base;
  __device__ explicit Smem(unsigned char* raw)
      : base(reinterpret_cast<unsigned char*>(
            (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023))) {}
  __device__ unsigned char* q() const { return base + kQ; }
  __device__ unsigned char* qlo() const { return base + kQlo; }
  __device__ unsigned char* k(int s) const { return base + kK + s * kKVBytes; }
  __device__ unsigned char* v(int s) const { return base + kV + s * kKVBytes; }
  __device__ unsigned char* x(int s) const { return base + kX + s * XB; }
  __device__ uint64_t* q_full() const {
    return reinterpret_cast<uint64_t*>(base + kBar);
  }
  __device__ uint64_t* full(int s) const { return q_full() + 1 + s; }
  __device__ uint64_t* empty(int s) const { return q_full() + 1 + ST + s; }

  // Barrier set-up by thread 0, visible to the CTA after the __syncthreads.
  __device__ void init() const {
    if (threadIdx.x == 0) {
      sm90::mbar_init(q_full(), 1);
      for (int s = 0; s < ST; ++s) {
        sm90::mbar_init(full(s), 1);
        sm90::mbar_init(empty(s), NW * 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
};

// ---------------------------------------------------------------- PTX ----

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo, both TF32 (round to nearest, ties away, as cvt.rna does).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// One f32 from shared memory (volatile: a ring slot's contents change
// between walks over it).
__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// d (16 x 8, f32) += a (16 x 8, tf32, row) . b (8 x 8, tf32, col).
__device__ __forceinline__ void mma(float* d, const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b (a zero accumulator input).
__device__ __forceinline__ void mma0(float* d, const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

// The 3xTF32 product: d += lo.hi + hi.lo + hi.hi (small terms first),
// each added into d by the tensor core (S: 24 or 36 additions per key).
__device__ __forceinline__ void mma3(float* d, const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

// The same product summed in a fresh accumulator and added to d in f32
// round-to-nearest (O).  The tensor core truncates where it adds into its
// accumulator, so O, which takes such an addition per 8 keys over the
// whole key walk, drifts by ~1e-5 at a few thousand keys; added here it
// keeps the accuracy of an f32 FMA kernel (PERF.md, section 6).  __fadd_rn
// keeps the compiler from fusing the add with O's rescale for some
// registers and not others, which would make a row's result depend on
// its place in the tile.
__device__ __forceinline__ void mma3_rn(float* d, const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], uint32_t bh0,
                                        uint32_t bh1, uint32_t bl0,
                                        uint32_t bl1) {
  float t[4];
  mma0(t, al, bh0, bh1);
  mma(t, ah, bl0, bl1);
  mma(t, ah, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], t[i]);
}

// ------------------------------------------------------- a warp's work ----

// Splits warp w's 16 MT rows of the Q tile: hi stays in place, lo goes to
// the lo plane at the same offset.
template <class SM>
__device__ __forceinline__ void split_q(const SM& sm, int w) {
  float* qh = reinterpret_cast<float*>(sm.q());
  float* ql = reinterpret_cast<float*>(sm.qlo());
  constexpr int D = SM::kD, RW = 16 * SM::kMT;
  for (int e = threadIdx.x & 31; e < RW * D; e += 32) {
    const uint32_t o = off<SM::R>(RW * w + e / D, e % D) >> 2;
    uint32_t hi, lo;
    split(qh[o], hi, lo);
    qh[o] = __uint_as_float(hi);
    ql[o] = __uint_as_float(lo);
  }
  __syncwarp();
}

// S (16 rows x 64 keys of the entry in ``kt``, raw) = Q K^T for each of
// warp w's MT row tiles; each K fragment is split once for all of them.
template <class SM>
__device__ __forceinline__ void scores(const SM& sm, int w,
                                       const unsigned char* kt,
                                       float (&s)[SM::kMT][32]) {
  constexpr int D = SM::kD, R = SM::R, MT = SM::kMT;
  const int lane = threadIdx.x & 31, mi = lane >> 3, rr = lane & 7;
  // ldmatrix rows: Q's four 8x4 matrices are (rows +0 / +8) x (lanes +0 /
  // +4), K's are (keys +0, lanes +0 / +4) of n-tile j, then of j + 1
  const int qrow = 16 * MT * w + rr + ((mi & 1) << 3), qd = (mi >> 1) << 2;
  const int krow = rr + ((mi >> 1) << 3), kd = (mi & 1) << 2;
  const uint32_t qh = sm90::smem_u32(sm.q()), ql = sm90::smem_u32(sm.qlo());
  const uint32_t kb = sm90::smem_u32(kt);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) s[mt][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      ldsm_x4(ah[mt], qh + off<R>(qrow + 16 * mt, 8 * kk + qd));
      ldsm_x4(al[mt], ql + off<R>(qrow + 16 * mt, 8 * kk + qd));
    }
#pragma unroll
    for (int j = 0; j < KT / 8; j += 2) {
      uint32_t b[4], bh[4], bl[4];
      ldsm_x4(b, kb + off<KT>(8 * j + krow, 8 * kk + kd));
#pragma unroll
      for (int e = 0; e < 4; ++e) split(__uint_as_float(b[e]), bh[e], bl[e]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma3(s[mt] + 4 * j, ah[mt], al[mt], bh[0], bh[1], bl[0], bl[1]);
        mma3(s[mt] + 4 * j + 4, ah[mt], al[mt], bh[2], bh[3], bl[2], bl[3]);
      }
    }
  }
}

// O += P V for each of warp w's MT row tiles: P (the softmax step's p, in
// S's registers) over the 64 keys of the entry in ``vt``, with each 8-key
// step's keys in the order (0, 2, 4, 6, 1, 3, 5, 7) on both sides; each V
// value is split once for all row tiles.
template <int D, int MT, int NO>
__device__ __forceinline__ void pv(const unsigned char* vt,
                                   const float (&p)[MT][32],
                                   RowStateN<NO> (&st)[MT]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t vb = sm90::smem_u32(vt);
#pragma unroll
  for (int kk = 0; kk < KT / 8; ++kk) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float a[4] = {p[mt][4 * kk], p[mt][4 * kk + 2],
                          p[mt][4 * kk + 1], p[mt][4 * kk + 3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) split(a[e], ah[mt][e], al[mt][e]);
    }
    const int r = 8 * kk + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      uint32_t h0, l0, h1, l1;
      split(lds(vb + off<KT>(r, 8 * j + g)), h0, l0);
      split(lds(vb + off<KT>(r + 1, 8 * j + g)), h1, l1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma3_rn(st[mt].o + 4 * j, ah[mt], al[mt], h0, h1, l0, l1);
    }
  }
}

// The online-softmax step on finished logits (log2 units, NEG where
// masked) of NS / 2 keys (32 registers: a 64-key entry): the new row max,
// p = exp2(x - max) in place of the logits, the row sum; returns in
// ``alpha`` the factor O must be scaled by.
template <int NO, int NS>
__device__ __forceinline__ void softmax_step(RowStateN<NO>& st,
                                             float (&s)[NS],
                                             float (&alpha)[2]) {
  float mx[2] = {NEG, NEG}, safe[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NS; ++i) mx[Rows::hi(i)] = fmaxf(mx[Rows::hi(i)], s[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(st.m[h], sm90::quad_max(mx[h]));
    safe[h] = (m_new <= 0.5f * NEG) ? 0.f : m_new;
    alpha[h] =
        (st.m[h] <= 0.5f * NEG) ? 0.f : sm90::exp2_approx(st.m[h] - safe[h]);
    st.m[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int h = Rows::hi(i);
    s[i] = (s[i] <= 0.5f * NEG) ? 0.f : sm90::exp2_approx(s[i] - safe[h]);
    sum[h] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) st.l[h] = st.l[h] * alpha[h] + sm90::quad_sum(sum[h]);
}

// Consumer warp w's walk over ``n`` ring entries: per entry, S, the
// logits (``logits(s, mt, entry, slot)`` turns the raw scores of row tile
// mt in S's registers into log2-unit logits), the softmax step, O = alpha
// O + P V, then the slot is released.  Q must be split first (split_q).
template <class SM, int NO, class Logits>
__device__ __forceinline__ void consume(const SM& sm, int w, int n,
                                        RowStateN<NO> (&st)[SM::kMT],
                                        Logits logits) {
  constexpr int ST = SM::kStages, MT = SM::kMT;
  float s[MT][32], alpha[2];
  for (int e = 0; e < n; ++e) {
    const int slot = e % ST;
    sm90::mbar_wait(sm.full(slot), (e / ST) & 1);
    scores(sm, w, sm.k(slot), s);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      logits(s[mt], mt, e, slot);
      softmax_step(st[mt], s[mt], alpha);
      sm90::rescale(st[mt], alpha);
    }
    pv<SM::kD>(sm.v(slot), s, st);
    sm90::mbar_arrive(sm.empty(slot));
  }
}

// The producer's load loop, run by one thread: the Q tile once
// (``load_q(dst, bar)``), then entries 0 .. n - 1 through the ring
// (``load_kv(entry, k, v, extra, bar)``, ``bytes`` bytes in all).
template <class SM, class LoadQ, class LoadKV>
__device__ __forceinline__ void produce(const SM& sm, int n, uint32_t bytes,
                                        LoadQ load_q, LoadKV load_kv) {
  constexpr int ST = SM::kStages;
  sm90::mbar_expect_tx(sm.q_full(), SM::kQBytes);
  load_q(sm.q(), sm.q_full());
  for (int e = 0; e < n; ++e) {
    const int slot = e % ST;
    sm90::mbar_wait(sm.empty(slot), ((e / ST) & 1) ^ 1);
    sm90::mbar_expect_tx(sm.full(slot), bytes);
    load_kv(e, sm.k(slot), sm.v(slot), sm.x(slot), sm.full(slot));
  }
}

// The rows of row tile ``tile`` (warp w's tile mt is MT w + mt): r0 =
// 16 tile + lane / 4 and r1 = r0 + 8 of the CTA's tile (Rows numbers them
// within a 128-thread warpgroup).
__device__ __forceinline__ Rows tile_rows(int tile) {
  Rows rw;
  rw.r0 = 16 * tile + ((threadIdx.x & 31) >> 2);
  rw.r1 = rw.r0 + 8;
  return rw;
}

// Writes row half ``h`` of O: normalised f32 (``inv`` = 1 / l) or, for a
// split, unnormalised (``inv`` = 1).
template <int NO>
__device__ __forceinline__ void store_row(const RowStateN<NO>& st,
                                          const Rows& rw, int h, float inv,
                                          float* __restrict__ row) {
#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    if (Rows::hi(i) != h) continue;
    *reinterpret_cast<float2*>(row + Rows::col(i) + rw.cq) =
        make_float2(st.o[i] * inv, st.o[i + 1] * inv);
  }
}

// ------------------------------------------------------------- host ----

// A (B, N, W) f32 tensor as a 3-D map (W, N, B), boxes of 32 lanes x
// ``rows`` tokens of one batch, 128-byte swizzle, zeros outside.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int B, int N,
                            int W, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)N * W * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)rows, 1};
  return sm90::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, base, dims,
                          strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace f32e
}  // namespace p3
