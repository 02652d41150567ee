// The pieces the f32 K4 (flash_fwd_sm90.cu, which also serves the f32 K1
// and K6) and K5 (flash_bwd_sm90.cu) share on the 3xTF32 engine of attn_f32_sm90.cuh: the pre-pass kernels,
// the shared-memory layout of a CTA and the products on pre-split planes.
//
// Pre-split planes.  The engine splits every K and V value into TF32 hi
// and lo in registers as it loads it, and every warp repeats the splits of
// the same values: the probe of PERF.md, section 6, found those splits and
// their operand loads, not the tensor pipe, bound it.  Here a pre-pass
// writes each operand that a CTA streams (K and V; K5's dkdv kernel also
// streams Q and dO) as two f32 planes, hi = tf32(x) and lo = tf32(x - hi),
// (B*H, N, D) contiguous, rotated by the RoPE tables first where the
// operand has them.  The main loops then load hi and lo and split only
// what lives in registers (P, dS) or is resident once per CTA (Q in K4).
// LoftUp's K and V are 768 keys per (b, h): their planes are a few MB and
// stay in L2.
//
// Products.  mma.sync m16n8k8 TF32, three per product (lo.hi, hi.lo,
// hi.hi).  The tensor core truncates where it adds into its accumulator,
// so an error that only ever shrinks a sum builds up along it:
// - a product summed over keys or queries (O = P V, dQ = dS K, dV = P^T
//   dO, dK = dS^T Q) is taken per 8-row step in a fresh accumulator and
//   added in f32 round-to-nearest (pv, mma3_rn): dK and dV take one such
//   addition per 8 queries of a 49152-query walk;
// - the scores S = Q K^T (and S^T) take each 8-lane step's hi.hi product
//   in a fresh accumulator, added in f32 round-to-nearest, and the small
//   terms in the tensor core (qk_rn): summed wholly in the tensor core
//   (qk) they sat low by ~1e-6 of S, which the decoder's K4 calls passed
//   on until the `small` v2 train-step check of chip_smoke.py read 15
//   times its limit (PERF.md, section 6);
// - dP = dO V^T (and dP^T) sums in the tensor core (qk): K5's dS takes
//   dP - Dvec, not an exponential of it.
//
// Ring entries hold KE = 32 rows (keys, or queries in dkdv), so that four
// planes of an entry in each of two slots and a resident tile of 64 or
// 128 rows fit in shared memory at d = 96.
#pragma once

#include "attn_f32_sm90.cuh"

namespace p3 {
namespace flash32 {

using sm90::Rows;
using sm90::RowStateN;

constexpr int KE = 32;   // rows per ring entry (and per live-tile entry)
constexpr int QT = 64;   // queries per tile of dkdv's fixed split
constexpr float LN2 = 0.6931471805599453f;

using sm90::BiasStrides;
using sm90::blocks_for;
using sm90::DEAD;
using sm90::logit;
using sm90::Perm;
using sm90::pick;
using sm90::Strides3;

// ---------------------------------------------------------- pre-pass ----

// W (1 or 4) consecutive f32 values at p: one 16-byte access for W = 4.
template <int W>
__device__ __forceinline__ void ldw(const float* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = *p;
  }
}
template <int W>
__device__ __forceinline__ void stw(float* p, const float (&v)[W]) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

// x (B, H, N, D) through its strides, rotated by (B, N, D) tables when
// ``cs`` is given (rope_at's rotate-half within each D/2 half, in f32,
// each product and the sum rounded as the plain version's), into (B*H, NP,
// D) planes: hi = tf32(x), lo = tf32(x - hi); without ``lo``, hi = x.
// With ``tail`` (a (B, H, 1, D) row through the batch and head strides of
// ``ts``), NP = N + 1 and the planes' last row of each (b, h) is that row,
// never rotated (the f32 K1's cls key and value); else NP = N.  Each
// thread takes W consecutive lanes (W = 4: 16-byte accesses, where every
// base and stride allows them; the rotation's partner lanes, D/4 away,
// are as aligned); the arithmetic of a value does not depend on W.
template <int D, int W>
__global__ void split_planes(const float* __restrict__ x, Strides3 st,
                             const float* __restrict__ cs,
                             const float* __restrict__ sn,
                             float* __restrict__ hi, float* __restrict__ lo,
                             int H, int N, long long total,
                             const float* __restrict__ tail, Strides3 ts) {
  static_assert(D % (4 * W) == 0, "a rotation half holds whole groups");
  const int NP = N + (tail != nullptr);
  for (long long e = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * W;
       e < total; e += (long long)gridDim.x * blockDim.x * W) {
    const int d = static_cast<int>(e % D);
    const long long row = e / D;
    const int n = static_cast<int>(row % NP);
    const long long bh = row / NP;
    const int h = static_cast<int>(bh % H);
    const long long b = bh / H;
    float val[W];
    if (n == N) {
      ldw<W>(tail + b * ts.b + h * ts.h + d, val);
    } else {
      const float* r = x + b * st.b + h * st.h + n * st.n;
      ldw<W>(r + d, val);
      if (cs != nullptr) {
        constexpr int Q = D / 4;
        const bool first = (d % (D / 2)) < Q;
        const long long t = (b * N + n) * D + d;
        float xp[W], c[W], s_[W];
        ldw<W>(r + (first ? d + Q : d - Q), xp);
        ldw<W>(cs + t, c);
        ldw<W>(sn + t, s_);
#pragma unroll
        for (int i = 0; i < W; ++i)
          val[i] = __fadd_rn(__fmul_rn(val[i], c[i]),
                             __fmul_rn(first ? -xp[i] : xp[i], s_[i]));
      }
    }
    if (lo == nullptr) {
      stw<W>(hi + e, val);
    } else {
      float vh[W], vl[W];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        uint32_t h_, l_;
        f32e::split(val[i], h_, l_);
        vh[i] = __uint_as_float(h_);
        vl[i] = __uint_as_float(l_);
      }
      stw<W>(hi + e, vh);
      stw<W>(lo + e, vl);
    }
  }
}

// One block of 1024 threads per batch, as tower_cross_sm90.cu's
// cross_tiles with KE-key tiles: the key bias row ``kb`` (B, Nk) (or none:
// every key below Nk live) in log2 units padded to ``nt`` whole tiles (NEG
// where dead or past Nk), then the batch's live tiles in order and their
// count.
__global__ void key_tiles(const float* __restrict__ kb,
                          float* __restrict__ bl, int* __restrict__ list,
                          int* __restrict__ count, int Nk, int nt) {
  extern __shared__ int live_tile[];
  const int b = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < nt; t += 32) {
    const int j = t * KE + lane;
    const float x = (j < Nk) ? (kb ? kb[(long)b * Nk + j] : 0.f) : NEG;
    const bool live = x > 0.5f * NEG;
    bl[((long)b * nt + t) * KE + lane] = live ? x * sm90::L2E : NEG;
    const bool any = __any_sync(0xffffffffu, live);
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

// ------------------------------------------------------------- smem ----

// A CTA of NW warps in G groups: each group's warps own MT m16 tiles of
// 16 rows each, and the groups the same R rows.  Shared memory: NA
// resident planes of R rows, ST ring slots of NB planes of KE rows and XB
// extra bytes, then the barriers (the resident planes' and each slot's
// "full", completed by the TMA byte count).  Each plane is an f32 tile
// written by TMA as 32-lane boxes with 128-byte swizzle (f32e::off), on a
// 1024-byte boundary.  There is no producer warp: with G = ST, group g
// owns slot g, and its first thread issues an entry's loads once the
// group has released the slot (so that every warp may hold its
// accumulators in up to 255 registers).
template <int D, int NW, int MT, int NA, int NB, int ST, uint32_t XB, int G>
struct Smem {
  static_assert(G == ST, "one ring slot per group");
  static constexpr int kD = D;
  static constexpr int kNW = NW;
  static constexpr int kMT = MT;
  static constexpr int R = 16 * MT * NW / G;
  static constexpr int kThreads = 32 * NW;
  static constexpr uint32_t kA = R * D * 4;     // a resident plane
  static constexpr uint32_t kB = KE * D * 4;    // a ring plane
  static constexpr uint32_t kSlot = NB * kB;
  static constexpr uint32_t kRing = NA * kA;
  static constexpr uint32_t kX = kRing + ST * kSlot;
  static constexpr uint32_t kBar = kX + ST * XB;
  static constexpr uint32_t kEnd = kBar + (1 + ST) * 8;
  static constexpr int kBytes = kEnd + 1024;    // room to align the base
  static_assert(kA % 1024 == 0 && kB % 1024 == 0 && XB % 16 == 0 &&
                    kBytes <= 232448,
                "shared memory");

  unsigned char* base;
  __device__ explicit Smem(unsigned char* raw)
      : base(reinterpret_cast<unsigned char*>(
            (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023))) {}
  __device__ unsigned char* a(int i) const { return base + i * kA; }
  __device__ unsigned char* b(int s, int i) const {
    return base + kRing + s * kSlot + i * kB;
  }
  __device__ unsigned char* x(int s) const { return base + kX + s * XB; }
  // f32e::split_q's names: Q in resident plane 0 (hi in place), lo in 1
  __device__ unsigned char* q() const { return a(0); }
  __device__ unsigned char* qlo() const { return a(1); }
  __device__ uint64_t* q_full() const {
    return reinterpret_cast<uint64_t*>(base + kBar);
  }
  __device__ uint64_t* full(int s) const { return q_full() + 1 + s; }

  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s <= ST; ++s) sm90::mbar_init(q_full() + s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
};

// The ``threads`` threads (four warps by default) of group ``gr`` meet
// (named barrier 1 + gr).
__device__ __forceinline__ void group_sync(int gr, int threads = 128) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + gr), "r"(threads) : "memory");
}

// The ``rows`` rows from ``row0`` of batch-head ``bh`` of a (B*H, N, D)
// plane map, as D / 32 boxes of 32 lanes into a tile of ``rows`` rows.
__device__ __forceinline__ void load_plane(unsigned char* dst,
                                           const CUtensorMap* map,
                                           uint64_t* bar, int d, int rows,
                                           int row0, int bh) {
  for (int j = 0; j < d / 32; ++j)
    sm90::tma_load_3d(dst + j * rows * 128, map, bar, 32 * j, row0, bh);
}

// --------------------------------------------------------- products ----

// s[mt] (16 rows x 8 NT columns, raw) = A B^T over D lanes for each of
// MT row tiles (A rows ar0 + 16 mt + [0, 16)): A a hi/lo plane pair of RA
// rows, B one of RB rows from row 0; each B fragment serves MT products.
template <int D, int RA, int RB, int MT, int NT>
__device__ __forceinline__ void qk(float (&s)[MT][4 * NT], uint32_t ah,
                                   uint32_t al, int ar0, uint32_t bh,
                                   uint32_t bl) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, rr = lane & 7;
  // ldmatrix rows: A's four 8x4 matrices are (rows +0 / +8) x (lanes +0 /
  // +4), B's are (rows +0, lanes +0 / +4) of n-tile j, then of j + 1
  const int arow = ar0 + rr + ((mi & 1) << 3), ad = (mi >> 1) << 2;
  const int brow = rr + ((mi >> 1) << 3), bd = (mi & 1) << 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) s[mt][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t xh[MT][4], xl[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint32_t o = f32e::off<RA>(arow + 16 * mt, 8 * kk + ad);
      f32e::ldsm_x4(xh[mt], ah + o);
      f32e::ldsm_x4(xl[mt], al + o);
    }
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t yh[4], yl[4];
      const uint32_t o = f32e::off<RB>(8 * j + brow, 8 * kk + bd);
      f32e::ldsm_x4(yh, bh + o);
      f32e::ldsm_x4(yl, bl + o);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        f32e::mma3(s[mt] + 4 * j, xh[mt], xl[mt], yh[0], yh[1], yl[0],
                   yl[1]);
        f32e::mma3(s[mt] + 4 * j + 4, xh[mt], xl[mt], yh[2], yh[3], yl[2],
                   yl[3]);
      }
    }
  }
}

// As qk, with each 8-lane step's hi.hi product in a fresh accumulator
// added to s in f32 round-to-nearest; the small terms (lo.hi + hi.lo,
// ~2^-11 of s) sum in the tensor core and join s at the end.
template <int D, int RA, int RB, int MT, int NT>
__device__ __forceinline__ void qk_rn(float (&s)[MT][4 * NT], uint32_t ah,
                                      uint32_t al, int ar0, uint32_t bh,
                                      uint32_t bl) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, rr = lane & 7;
  const int arow = ar0 + rr + ((mi & 1) << 3), ad = (mi >> 1) << 2;
  const int brow = rr + ((mi >> 1) << 3), bd = (mi & 1) << 2;
  float lo[MT][4 * NT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) s[mt][i] = lo[mt][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t xh[MT][4], xl[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint32_t o = f32e::off<RA>(arow + 16 * mt, 8 * kk + ad);
      f32e::ldsm_x4(xh[mt], ah + o);
      f32e::ldsm_x4(xl[mt], al + o);
    }
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t yh[4], yl[4];
      const uint32_t o = f32e::off<RB>(8 * j + brow, 8 * kk + bd);
      f32e::ldsm_x4(yh, bh + o);
      f32e::ldsm_x4(yl, bl + o);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* sl = lo[mt] + 4 * (j + h);
          f32e::mma(sl, xl[mt], yh[2 * h], yh[2 * h + 1]);
          f32e::mma(sl, xh[mt], yl[2 * h], yl[2 * h + 1]);
          float t[4];
          f32e::mma0(t, xh[mt], yh[2 * h], yh[2 * h + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[mt][4 * (j + h) + e] = __fadd_rn(s[mt][4 * (j + h) + e], t[e]);
        }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) s[mt][i] = __fadd_rn(s[mt][i], lo[mt][i]);
}

// acc[mt].o (16 rows x D) += P[mt] (16 rows x 8 NT, in s's registers) B
// (8 NT rows of a hi/lo plane pair of RB rows, D lanes): each 8-row step
// in the order (0, 2, 4, 6, 1, 3, 5, 7) on both sides, so the thread's
// registers are its A fragment, summed in a fresh accumulator and added
// in f32 round-to-nearest; each B value serves MT products.
template <int D, int RB, int MT, int NT, int NO>
__device__ __forceinline__ void pv(const float (&p)[MT][4 * NT],
                                   RowStateN<NO> (&acc)[MT], uint32_t bh,
                                   uint32_t bl) {
  static_assert(NO == D / 2, "accumulator");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    uint32_t xh[MT][4], xl[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float a[4] = {p[mt][4 * kk], p[mt][4 * kk + 2],
                          p[mt][4 * kk + 1], p[mt][4 * kk + 3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) f32e::split(a[e], xh[mt][e], xl[mt][e]);
    }
    const int r = 8 * kk + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const uint32_t o0 = f32e::off<RB>(r, 8 * j + g);
      const uint32_t o1 = f32e::off<RB>(r + 1, 8 * j + g);
      const uint32_t h0 = __float_as_uint(f32e::lds(bh + o0));
      const uint32_t l0 = __float_as_uint(f32e::lds(bl + o0));
      const uint32_t h1 = __float_as_uint(f32e::lds(bh + o1));
      const uint32_t l1 = __float_as_uint(f32e::lds(bl + o1));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        f32e::mma3_rn(acc[mt].o + 4 * j, xh[mt], xl[mt], h0, h1, l0, l1);
    }
  }
}

// ------------------------------------------------------------- host ----

// The planes of x (B, H, N, D), rotated when ``cs`` is given, and with
// ``tail`` one more unrotated row per (b, h) (split_planes): four lanes a
// thread where every pointer is 16-byte aligned and every stride a
// multiple of 4, else one.
template <int D>
inline void launch_split(const float* x, const long long* s, const float* cs,
                         const float* sn, float* hi, float* lo, int B, int H,
                         int N, cudaStream_t st,
                         const float* tail = nullptr,
                         const long long* ts = nullptr) {
  const long long total = (long long)B * H * (N + (tail != nullptr)) * D;
  if (total == 0) return;
  auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const Strides3 xs{s[0], s[1], s[2]};
  const Strides3 tss = tail ? Strides3{ts[0], ts[1], 0} : Strides3{0, 0, 0};
  const bool v4 = a16(x) && a16(cs) && a16(sn) && a16(hi) && a16(lo) &&
                  a16(tail) && (xs.b | xs.h | xs.n | tss.b | tss.h) % 4 == 0;
  if (v4)
    split_planes<D, 4><<<blocks_for(total / 4), 256, 0, st>>>(
        x, xs, cs, sn, hi, lo, H, N, total, tail, tss);
  else
    split_planes<D, 1><<<blocks_for(total), 256, 0, st>>>(
        x, xs, cs, sn, hi, lo, H, N, total, tail, tss);
}

}  // namespace flash32
}  // namespace p3
