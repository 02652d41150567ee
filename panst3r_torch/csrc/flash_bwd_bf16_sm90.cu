// K5, bf16 — flash-attention backward on the bf16 Hopper engine
// (attn_sm90.cuh: TMA ring, wgmma, the element-wise step in registers).
// The f32 K5 is flash_bwd_sm90.cu (the 3xTF32 engine).
//
// Replaces panst3r_tpu/ops/pallas/flash_attention_bwd.py::flash_bwd in
// bf16 and its two kernels, _dq_kernel (query rows, walking the keys) and
// _dkv_kernel (key rows, walking the queries).  Both recompute the
// probabilities from q, k and the LSE that K4 saved, in log2 units:
//   x  = q.k^T * scale * log2 e + the key bias row and the dense bias in
//        log2 units (as K4 takes them; NEG where masked)
//   p  = exp2(x - lse * log2 e), 0 where x <= finfo.min/2 or the row's LSE
//        is <= finfo.min/2 (no live key) or >= -finfo.min/2 (padding)
//   dp = do.v^T;  ds = p * (dp - Dvec) * scale,  Dvec = rowsum(do*o) in
//        f32, summed by the pre-pass in an order fixed per row
//   dq = ds.k;  dk = ds^T.q;  dv = p^T.do
// As in the Pallas kernels: q and k are rotated by the RoPE tables in f32
// and rounded to bf16, s and dp are f32 sums of bf16 products, ds is
// rounded to bf16 before ds.k and ds^T.q and p before p^T.do.  The
// gradients leave in f32 (B, H, N, D); the wrapper applies the rotation's
// adjoint and the casts.  No atomics.
//
// Bound on the H100: seven products of 2 B H Nq Nk D FLOPs (s and dp in
// both kernels, dq, dk, dv).  At LoftUp's training shape for two views (B
// = 2, H = 4, Nq = 49152, Nk = 768, D = 96) 4.06e11 FLOP against ~0.2 GB
// of q, k, v, do and gradients: bound by operations, 0.41 ms at 989
// TFLOP/s.
//
// Design, three pre-passes and two main kernels, every tile in K3's layout
// (D / 32 sub-tiles of 32 lanes, 64-byte rows, 64B swizzle) at d = 64, 96
// and 128 (the wrapper pads any smaller head dim with zeros), read by 4-D tensor maps (so strided views are read in place):
// (1) p3_flash_bwd_dq_bf16_sm90: with tables, rope_bf16 writes q~ and k~
//     (contiguous, rotated and rounded once per call); cross_tiles<64> the
//     key row in log2 units padded to whole 64-key tiles and each batch's
//     live tiles; row_stats the LSE in log2 units and Dvec, padded to
//     whole 64-query tiles (padding rows: p = 0).
// (2) dq_main: one CTA per (128 query rows, head, batch): two consumer
//     warpgroups of 64 rows and a producer warpgroup, which loads each
//     warpgroup's Q and dO tiles once and each live key tile's K, V and
//     key biases into a ring of DQ_ST slots.  Per tile S = Q K^T and dP =
//     dO V^T by wgmma m64n64k16 (both operands in shared memory); P and dS
//     in registers; dS rounded to bf16 is the register A operand of dQ +=
//     dS K (wgmma m64nDk16, K an MN-major B operand).
// (3) p3_flash_bwd_dkdv_bf16_sm90 / dkv_main: one CTA per (128 keys, query
//     split, batch-head), K and V resident (64 keys per consumer
//     warpgroup), the queries of a fixed split (``split_tiles`` tiles of
//     64) through a ring of KV_ST slots of 32 queries (Q, dO, log2 LSE and
//     Dvec).  S^T = K Q^T and dP^T = V dO^T by wgmma m64n32k16; P^T and
//     dS^T in bf16 registers are the A operands of dV += P^T dO and dK +=
//     dS^T Q.  32-query entries keep S^T and dP^T at 16 registers a
//     thread beside dK and dV (2 x 48 at d = 96) under the 168 registers
//     of a 384-thread CTA.  With more than one split each CTA writes its
//     partial dK and dV and dkv_merge adds them in split order: LoftUp's
//     6 key CTAs x B H = 8 would be 48 CTAs, under one wave.  A CTA whose
//     keys are all dead writes zeros.
// The products accumulate in the tensor core: dQ over a row's live keys,
// dK and dV over a split's queries.
#include "attn_sm90.cuh"

using namespace p3;
using namespace p3::sm90;

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BWG = 2;     // consumer warpgroups per CTA (both kernels)
constexpr int KT = 64;     // keys per live tile and dq ring entry
constexpr int QE = 32;     // queries per dkdv ring entry
constexpr int QT = 64;     // queries per tile of the dkdv split
                           // (ops/flash_attention.py::QUERY_TILE)
constexpr int DQ_ST = 3;   // dq ring slots
constexpr int KV_ST = 4;   // dkdv ring slots

// Bytes of an R-row tile of D lanes in K3's layout.
template <int D, int R>
constexpr uint32_t tile_bytes() {
  return R * D * 2;
}

// Dynamic shared memory of a CTA: two resident operands (dq: Q, dO; dkdv:
// K, V), each the BWG warpgroups' 64-row tiles; ST ring slots of two R-row
// tiles (dq: K, V; dkdv: Q, dO) and XB extra bytes each (dq: the key
// biases; dkdv: the LSE and Dvec); the barriers.  Every tile starts on a
// 1024-byte boundary of the aligned base.
template <int D, int R, int ST, uint32_t XB>
struct BSmem {
  static constexpr uint32_t kTile = tile_bytes<D, 64>();
  static constexpr uint32_t kRes = BWG * kTile;
  static constexpr uint32_t kE = tile_bytes<D, R>();
  static constexpr uint32_t kRing = 2 * kRes;
  static constexpr uint32_t kX = kRing + ST * 2 * kE;
  static constexpr uint32_t kBar = kX + ST * XB;
  static constexpr uint32_t kEnd = kBar + (1 + 2 * ST) * 8;
  static constexpr int kBytes = kEnd + 1024;   // room to align the base
  static_assert(kE % 1024 == 0 && XB % 16 == 0 && kBytes <= 232448,
                "shared memory");

  unsigned char* base;
  __device__ explicit BSmem(unsigned char* raw)
      : base(reinterpret_cast<unsigned char*>(
            (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023))) {}
  // resident operand i, warpgroup g's tile
  __device__ unsigned char* res(int i, int g) const {
    return base + i * kRes + g * kTile;
  }
  // ring slot s, tile i
  __device__ unsigned char* ent(int s, int i) const {
    return base + kRing + (2 * s + i) * kE;
  }
  __device__ float* x(int s) const {
    return reinterpret_cast<float*>(base + kX + s * XB);
  }
  __device__ uint64_t* res_full() const {
    return reinterpret_cast<uint64_t*>(base + kBar);
  }
  __device__ uint64_t* full(int s) const { return res_full() + 1 + s; }
  __device__ uint64_t* empty(int s) const { return res_full() + 1 + ST + s; }

  // Barrier set-up by thread 0, visible to the CTA after the __syncthreads.
  __device__ void init() const {
    if (threadIdx.x == 0) {
      mbar_init(res_full(), 1);
      for (int s = 0; s < ST; ++s) {
        mbar_init(full(s), 1);
        mbar_init(empty(s), BWG * 128);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
};
template <int D>
using DqSmem = BSmem<D, KT, DQ_ST, KT * 4>;
template <int D>
using DkvSmem = BSmem<D, QE, KV_ST, 2 * QE * 4>;

// Rows [tok, tok + R) of (batch b, head h) of a 4-D map as D / 32 boxes of
// 32 lanes into an R-row tile.
template <int D, int R>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap* map,
                                          const Perm& pm, uint64_t* bar,
                                          int tok, int h, int b) {
#pragma unroll
  for (int j = 0; j < D / 32; ++j)
    tma_load_4d(dst + j * R * 64, map, bar, 32 * j, pick(0, pm, tok, h, b),
                pick(1, pm, tok, h, b), pick(2, pm, tok, h, b));
}

// Issues S (64 x R, f32) = A B^T over D lanes: A a 64-row tile, B an R-row
// tile (R = 64: m64n64k16; R = 32: m64n32k16), both K-major (one commit
// group).
template <int D, int R>
__device__ __forceinline__ void issue_ss(float (&s)[R / 2],
                                         const unsigned char* a,
                                         const unsigned char* b) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    if constexpr (R == 64)
      wgmma_ss_n64(s, desc_k_sub<64>(a, kk), desc_k_sub<64>(b, kk), kk > 0);
    else
      wgmma_ss_n32(s, desc_k_sub<64>(a, kk), desc_k_sub<32>(b, kk), kk > 0);
  }
  wg_commit();
}

// Issues acc (64 x D, f32) += A (64 x R, bf16 in registers, packed pairs
// in the accumulator layout of S) . B (R rows x D lanes, MN-major); the
// caller fences and commits.
template <int D, int R>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2],
                                         const uint32_t (&a)[R / 4],
                                         const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk) {
    const uint32_t f[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                           a[4 * kk + 3]};
    if constexpr (D == 64)
      wgmma_rs_n64(acc, f, desc_mn_sub<R>(b, kk), 1);
    else if constexpr (D == 96)
      wgmma_rs_n96(acc, f, desc_mn_sub<R>(b, kk), 1);
    else
      wgmma_rs_n128(acc, f, desc_mn_sub<R>(b, kk), 1);
  }
}

// Stores rows r0 / r1 (``row_ptr(half)``, null to skip) of a 64 x D f32
// accumulator.
template <int NO, class RowPtr>
__device__ __forceinline__ void store_acc(const float (&acc)[NO],
                                          const Rows& rw, RowPtr row_ptr) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float* out = row_ptr(hh);
    if (out == nullptr) continue;
#pragma unroll
    for (int j = 0; j < NO; j += 2)
      if (Rows::hi(j) == hh)
        *reinterpret_cast<float2*>(out + Rows::col(j) + rw.cq) =
            make_float2(acc[j], acc[j + 1]);
  }
}

// grid (ceil(Nq / 128), H, B).
template <int D>
__global__ void __launch_bounds__((BWG + 1) * 128, 1)
dq_main(const __grid_constant__ CUtensorMap mq,
        const __grid_constant__ CUtensorMap mg,
        const __grid_constant__ CUtensorMap mk,
        const __grid_constant__ CUtensorMap mv, const Perm pq,
        const Perm pg, const Perm pk, const Perm pv,
        const float* __restrict__ bl, const int* __restrict__ list,
        const int* __restrict__ count, const float* __restrict__ bias,
        BiasStrides bs, const float* __restrict__ lse2,
        const float* __restrict__ dvec, float* __restrict__ dq, int H,
        int Nq, int Nk, int nt, int Nqp, float sl, float scale) {
  using SM = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BWG * 64;
  const long bh = (long)b * H + h;
  const int n = count[b];
  const int* tiles = list + b * nt;
  const SM sm(smem_raw);
  sm.init();
  const int wg = threadIdx.x / 128;

  if (wg == BWG) {  // producer warpgroup
    regs_dec<Regs<BWG>::kProducer>();
    if (threadIdx.x == BWG * 128) {
      mbar_expect_tx(sm.res_full(), 2 * SM::kRes);
#pragma unroll
      for (int g = 0; g < BWG; ++g) {
        load_tile<D, 64>(sm.res(0, g), &mq, pq, sm.res_full(), q0 + 64 * g,
                         h, b);
        load_tile<D, 64>(sm.res(1, g), &mg, pg, sm.res_full(), q0 + 64 * g,
                         h, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % DQ_ST, tok = tiles[i] * KT;
        mbar_wait(sm.empty(s), ((i / DQ_ST) & 1) ^ 1);
        mbar_expect_tx(sm.full(s), 2 * SM::kE + KT * 4);
        load_tile<D, KT>(sm.ent(s, 0), &mk, pk, sm.full(s), tok, h, b);
        load_tile<D, KT>(sm.ent(s, 1), &mv, pv, sm.full(s), tok, h, b);
        bulk_load(sm.x(s), bl + (long)b * nt * KT + tok, KT * 4, sm.full(s));
      }
    }
    return;
  }
  // consumer warpgroup wg: query rows q0 + 64 wg + [0, 64)
  regs_inc<Regs<BWG>::kConsumer>();
  const Rows rw;
  const int row0 = q0 + 64 * wg;
  const int rows[2] = {row0 + rw.r0, row0 + rw.r1};
  float l2[2], dv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const bool in = rows[hh] < Nq;
    l2[hh] = in ? lse2[bh * Nqp + rows[hh]] : DEAD;
    dv[hh] = in ? dvec[bh * Nqp + rows[hh]] : 0.f;
  }
  const float* bhp = bias ? bias + b * bs.b + h * bs.h : nullptr;
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
  float s[KT / 2], dp[KT / 2];
  uint32_t ds[KT / 4];
  mbar_wait(sm.res_full(), 0);
  for (int i = 0; i < n; ++i) {
    const int cur = i % DQ_ST;
    const int key0 = __ldg(tiles + i) * KT;
    mbar_wait(sm.full(cur), (i / DQ_ST) & 1);
    issue_ss<D, KT>(s, sm.res(0, wg), sm.ent(cur, 0));    // S = Q K^T
    issue_ss<D, KT>(dp, sm.res(1, wg), sm.ent(cur, 1));   // dP = dO V^T
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    const float* kb = sm.x(cur);
#pragma unroll
    for (int j = 0; j < KT / 2; j += 2) {
      const int hh = Rows::hi(j);
      float d[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = Rows::col(j + u) + rw.cq, key = key0 + c;
        const float* db = (bhp != nullptr && rows[hh] < Nq && key < Nk)
                              ? bhp + rows[hh] * bs.q + key * bs.k
                              : nullptr;
        d[u] = dscore(prob(logit(s[j + u], sl, kb[c], db), l2[hh]),
                      dp[j + u], dv[hh], scale);
      }
      ds[j / 2] = pack_bf16(__float2bfloat16_rn(d[0]),
                            __float2bfloat16_rn(d[1]));
    }
    wg_fence();
    issue_rs<D, KT>(acc, ds, sm.ent(cur, 0));             // dQ += dS K
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(ds);  // the product reads ds until it completes
    mbar_arrive(sm.empty(cur));
  }
  store_acc(acc, rw, [&](int hh) -> float* {
    return rows[hh] < Nq ? dq + (bh * Nq + rows[hh]) * D : nullptr;
  });
}

// grid (ceil(Nk / 128), splits, B * H).  With one split the CTA writes dk
// and dv; with more, its split's partial sums (split-major) for dkv_merge.
template <int D>
__global__ void __launch_bounds__((BWG + 1) * 128, 1)
dkv_main(const __grid_constant__ CUtensorMap mk,
         const __grid_constant__ CUtensorMap mv,
         const __grid_constant__ CUtensorMap mq,
         const __grid_constant__ CUtensorMap mg, const Perm pk,
         const Perm pv, const Perm pq, const Perm pg,
         const float* __restrict__ bl, const float* __restrict__ bias,
         BiasStrides bs, const float* __restrict__ lse2,
         const float* __restrict__ dvec, float* __restrict__ dk,
         float* __restrict__ dv, int H, int Nq, int Nk, int nt, int Nqp,
         int split_tiles, float sl, float scale) {
  using SM = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const int j0 = blockIdx.x * BWG * 64, split = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int nqe = (Nq + QE - 1) / QE, per = split_tiles * (QT / QE);
  const int e0 = split * per, e1 = min(e0 + per, nqe);
  // this split's partial (or, with one split, the gradients themselves)
  const long off = ((long)split * gridDim.z + bh) * Nk * D;
  const float* kbr = bl + (long)b * nt * KT;
  const SM sm(smem_raw);
  sm.init();
  int live = 0;
  for (int c = threadIdx.x; c < BWG * 64; c += blockDim.x)
    live |= (j0 + c < Nk) && kbr[j0 + c] > 0.5f * NEG;
  const int ne = __syncthreads_or(live) ? e1 - e0 : 0;
  const int wg = threadIdx.x / 128;

  if (wg == BWG) {  // producer warpgroup
    regs_dec<Regs<BWG>::kProducer>();
    if (threadIdx.x == BWG * 128 && ne > 0) {
      mbar_expect_tx(sm.res_full(), 2 * SM::kRes);
#pragma unroll
      for (int g = 0; g < BWG; ++g) {
        load_tile<D, 64>(sm.res(0, g), &mk, pk, sm.res_full(), j0 + 64 * g,
                         h, b);
        load_tile<D, 64>(sm.res(1, g), &mv, pv, sm.res_full(), j0 + 64 * g,
                         h, b);
      }
      for (int i = 0; i < ne; ++i) {
        const int s = i % KV_ST, tok = (e0 + i) * QE;
        mbar_wait(sm.empty(s), ((i / KV_ST) & 1) ^ 1);
        mbar_expect_tx(sm.full(s), 2 * SM::kE + 2 * QE * 4);
        load_tile<D, QE>(sm.ent(s, 0), &mq, pq, sm.full(s), tok, h, b);
        load_tile<D, QE>(sm.ent(s, 1), &mg, pg, sm.full(s), tok, h, b);
        const long r = (long)bh * Nqp + tok;
        bulk_load(sm.x(s), lse2 + r, QE * 4, sm.full(s));
        bulk_load(sm.x(s) + QE, dvec + r, QE * 4, sm.full(s));
      }
    }
    return;
  }
  // consumer warpgroup wg: key rows j0 + 64 wg + [0, 64)
  regs_inc<Regs<BWG>::kConsumer>();
  const Rows rw;
  const int key0 = j0 + 64 * wg;
  const int keys[2] = {key0 + rw.r0, key0 + rw.r1};
  const float kb2[2] = {keys[0] < Nk ? kbr[keys[0]] : NEG,
                        keys[1] < Nk ? kbr[keys[1]] : NEG};
  const float* bhp = bias ? bias + b * bs.b + h * bs.h : nullptr;
  float ak[D / 2], av[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) ak[j] = av[j] = 0.f;
  if (ne > 0) {
    float s[QE / 2], dp[QE / 2];
    uint32_t pp[QE / 4], dd[QE / 4];
    mbar_wait(sm.res_full(), 0);
    for (int i = 0; i < ne; ++i) {
      const int cur = i % KV_ST, qr0 = (e0 + i) * QE;
      mbar_wait(sm.full(cur), (i / KV_ST) & 1);
      issue_ss<D, QE>(s, sm.res(0, wg), sm.ent(cur, 0));    // S^T = K Q^T
      issue_ss<D, QE>(dp, sm.res(1, wg), sm.ent(cur, 1));   // dP^T = V dO^T
      wg_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      const float* xl = sm.x(cur);   // [0, QE): log2 LSE; [QE, 2 QE): Dvec
#pragma unroll
      for (int j = 0; j < QE / 2; j += 2) {
        const int hh = Rows::hi(j);
        float p[2], d[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = Rows::col(j + u) + rw.cq, query = qr0 + c;
          const float* db = (bhp != nullptr && keys[hh] < Nk && query < Nq)
                                ? bhp + query * bs.q + keys[hh] * bs.k
                                : nullptr;
          p[u] = prob(logit(s[j + u], sl, kb2[hh], db), xl[c]);
          d[u] = dscore(p[u], dp[j + u], xl[QE + c], scale);
        }
        pp[j / 2] = pack_bf16(__float2bfloat16_rn(p[0]),
                              __float2bfloat16_rn(p[1]));
        dd[j / 2] = pack_bf16(__float2bfloat16_rn(d[0]),
                              __float2bfloat16_rn(d[1]));
      }
      wg_fence();
      issue_rs<D, QE>(av, pp, sm.ent(cur, 1));   // dV += P^T dO
      issue_rs<D, QE>(ak, dd, sm.ent(cur, 0));   // dK += dS^T Q
      wg_commit();
      wg_wait<0>();
      fence_regs(ak);
      fence_regs(av);
      fence_regs(pp);  // the products read pp and dd until they complete
      fence_regs(dd);
      mbar_arrive(sm.empty(cur));
    }
  }
  store_acc(ak, rw, [&](int hh) -> float* {
    return keys[hh] < Nk ? dk + off + (long)keys[hh] * D : nullptr;
  });
  store_acc(av, rw, [&](int hh) -> float* {
    return keys[hh] < Nk ? dv + off + (long)keys[hh] * D : nullptr;
  });
}

struct Args {
  const bf16 *q, *k, *v, *g;
  const void* o;        // bf16 or f32 (run_dq's raw_f32)
  const float *lse, *bias, *kbias, *qcos, *qsin, *kcos, *ksin;
  const long long* s;   // q, k, v, do (batch, head, token), bias (4), o
  bf16 *qr, *kr;
  float *bl, *lse2, *dv2;
  int *list, *count;
  int B, H, Nq, Nk;
  float scale;
  cudaStream_t st;
};

inline int padded(int Nq) { return (Nq + QT - 1) / QT * QT; }

// The bf16 (B, H, N, D) tensor ``x`` with element strides s[0..2] as a 4-D
// map of 32-lane boxes of ``rows`` tokens, 64B swizzle.
template <int D>
cudaError_t map_of(CUtensorMap* m, Perm* p, const bf16* x, const long long* s,
                   int B, int H, int N, int rows) {
  return make_map4(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, B, H, N, D,
                   s[0], s[1], s[2], 32, rows, CU_TENSOR_MAP_SWIZZLE_64B, p);
}

// The maps of the operands a main kernel reads: q~ and k~ (the pre-pass's,
// contiguous) with tables, else q and k through their strides; do and v
// through theirs.  q and do in boxes of ``qrows`` tokens, k and v of
// ``krows``.
template <int D>
cudaError_t operand_maps(const Args& a, int qrows, int krows, CUtensorMap* m,
                         Perm* p) {
  const long long* s = a.s;
  const long long qs[3] = {(long long)a.H * a.Nq * D, (long long)a.Nq * D, D};
  const long long ks[3] = {(long long)a.H * a.Nk * D, (long long)a.Nk * D, D};
  const bool rot = a.qcos != nullptr;
  cudaError_t err;
  if ((err = map_of<D>(&m[0], &p[0], rot ? a.qr : a.q, rot ? qs : s, a.B,
                       a.H, a.Nq, qrows)) != cudaSuccess ||
      (err = map_of<D>(&m[1], &p[1], a.g, s + 9, a.B, a.H, a.Nq, qrows)) !=
          cudaSuccess ||
      (err = map_of<D>(&m[2], &p[2], rot ? a.kr : a.k, rot ? ks : s + 3, a.B,
                       a.H, a.Nk, krows)) != cudaSuccess ||
      (err = map_of<D>(&m[3], &p[3], a.v, s + 6, a.B, a.H, a.Nk, krows)) !=
          cudaSuccess)
    return err;
  return cudaSuccess;
}

// Dvec from the unrounded do (``graw``, element strides s[19..21]) and o,
// each read in its own type: TG and TO, bf16 or f32.
template <int D, typename TG, typename TO>
cudaError_t stats_as(const Args& a, const void* graw, int Nqp) {
  const long long* s = a.s;
  const long long rows = (long long)a.B * a.H * Nqp;
  row_stats<D, TG, TO><<<blocks_for(rows * 32), 256, 0, a.st>>>(
      a.lse, static_cast<const TG*>(graw), Strides3{s[19], s[20], s[21]},
      static_cast<const TO*>(a.o), Strides3{s[16], s[17], s[18]}, a.lse2,
      a.dv2, a.H, a.Nq, Nqp, rows);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_dq(const Args& a, const void* graw, int raw_f32, float* dq) {
  const int nt = (a.Nk + KT - 1) / KT, Nqp = padded(a.Nq);
  const long long* s = a.s;
  cudaError_t err;
  if (a.qcos != nullptr &&
      ((err = rotate_bf16<D>(a.q, s, a.qcos, a.qsin, a.qr, a.B, a.H, a.Nq,
                             a.st)) != cudaSuccess ||
       (err = rotate_bf16<D>(a.k, s + 3, a.kcos, a.ksin, a.kr, a.B, a.H,
                             a.Nk, a.st)) != cudaSuccess))
    return err;
  cross_tiles<KT><<<a.B, 1024, nt * sizeof(int), a.st>>>(
      a.kbias, a.bl, a.list, a.count, a.Nk, nt);
  err = raw_f32 == 0   ? stats_as<D, bf16, bf16>(a, graw, Nqp)
        : raw_f32 == 1 ? stats_as<D, float, bf16>(a, graw, Nqp)
        : raw_f32 == 2 ? stats_as<D, bf16, float>(a, graw, Nqp)
                       : stats_as<D, float, float>(a, graw, Nqp);
  if (err != cudaSuccess) return err;
  CUtensorMap m[4];
  Perm p[4];
  if ((err = operand_maps<D>(a, 64, KT, m, p)) != cudaSuccess) return err;
  using SM = DqSmem<D>;
  auto kern = dq_main<D>;
  if ((err = prepare(kern, SM::kBytes)) != cudaSuccess) return err;
  const dim3 grid((a.Nq + BWG * 64 - 1) / (BWG * 64), a.H, a.B);
  kern<<<grid, (BWG + 1) * 128, SM::kBytes, a.st>>>(
      m[0], m[1], m[2], m[3], p[0], p[1], p[2], p[3], a.bl, a.list, a.count,
      a.bias, BiasStrides{s[12], s[13], s[14], s[15]}, a.lse2, a.dv2, dq,
      a.H, a.Nq, a.Nk, nt, Nqp, a.scale * L2E, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_dkdv(const Args& a, float* dk, float* dv, float* part,
                     int split_tiles) {
  const int nt = (a.Nk + KT - 1) / KT, Nqp = padded(a.Nq);
  const int ns = (Nqp / QT + split_tiles - 1) / split_tiles;
  const long long* s = a.s;
  CUtensorMap m[4];
  Perm p[4];
  cudaError_t err;
  if ((err = operand_maps<D>(a, QE, 64, m, p)) != cudaSuccess) return err;
  using SM = DkvSmem<D>;
  auto kern = dkv_main<D>;
  if ((err = prepare(kern, SM::kBytes)) != cudaSuccess) return err;
  const long long total = (long long)a.B * a.H * a.Nk * D;
  float* ok = ns > 1 ? part : dk;
  float* ov = ns > 1 ? part + ns * total : dv;
  const dim3 grid((a.Nk + BWG * 64 - 1) / (BWG * 64), ns, a.B * a.H);
  kern<<<grid, (BWG + 1) * 128, SM::kBytes, a.st>>>(
      m[2], m[3], m[0], m[1], p[2], p[3], p[0], p[1], a.bl, a.bias,
      BiasStrides{s[12], s[13], s[14], s[15]}, a.lse2, a.dv2, ok, ov, a.H,
      a.Nq, a.Nk, nt, Nqp, split_tiles, a.scale * L2E, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess || ns == 1) return err;
  dkv_merge<<<blocks_for(total), 256, 0, a.st>>>(ok, ov, dk, dv, total, ns);
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* g,
               const void* lse, const void* o, const void* bias,
               const void* kbias, const void* qcos, const void* qsin,
               const void* kcos, const void* ksin, const long long* strides,
               void* const* work, int B, int H, int Nq, int Nk, float scale,
               void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  return Args{h(q), h(k), h(v), h(g), o, f(lse), f(bias), f(kbias),
              f(qcos), f(qsin), f(kcos), f(ksin), strides,
              static_cast<bf16*>(work[0]), static_cast<bf16*>(work[1]),
              m(work[2]), m(work[3]), m(work[4]),
              static_cast<int*>(work[5]), static_cast<int*>(work[6]), B, H,
              Nq, Nk, scale, static_cast<cudaStream_t>(stream)};
}

bool bad_shape(int B, int H, int Nq, int Nk, const void* qcos,
               const void* kcos, void* const* work) {
  const int nt = (Nk + KT - 1) / KT;
  return B < 1 || H < 1 || Nq < 1 || Nk < 1 || nt * 4L > 48 * 1024 ||
         (qcos == nullptr) != (kcos == nullptr) ||
         (qcos == nullptr) != (work[0] == nullptr) ||
         (qcos == nullptr) != (work[1] == nullptr);
}

}  // namespace

P3_ERROR_STRING_FN

#define P3_BWD_ARGS                                                          \
  const void *q, const void *k, const void *v, const void *g,                \
      const void *lse, const void *o, const void *bias, const void *kbias,    \
      const void *qcos, const void *qsin, const void *kcos, const void *ksin, \
      const long long *strides, void *const *work, int B, int H, int Nq,     \
      int Nk, int D, float scale
#define P3_BWD_MAKE                                                          \
  make_args(q, k, v, g, lse, o, bias, kbias, qcos, qsin, kcos, ksin,         \
            strides, work, B, H, Nq, Nk, scale, stream)

// bf16 q (B, H, Nq, D), k/v (B, H, Nk, D), do rounded to bf16 and K4's
// output o (B, H, Nq, D) through the element strides in strides[0..11]
// (q, k, v, do: batch, head, token; those of q, k, v and do multiples of 8
// with 16-byte aligned bases: tensor maps read them) and strides[16..18]
// (o); ``graw`` the output gradient before that rounding (do itself when
// it is bf16) through strides[19..21]: the pre-pass forms Dvec from graw
// and o unrounded, graw f32 if bit 0 of ``raw_f32`` is set (else bf16), o
// f32 if bit 1 is (else bf16); lse (B, H, Nq) f32; bias: dense f32 bias through strides[12..15] (batch, head, query,
// key) or null; kbias (B, Nk) f32 or null; tables (B, N, D) f32, all four
// or none.  ``work``: 7 scratch buffers from the caller, with nt = ceil(Nk
// / 64) and Nqp = Nq rounded up to 64: with tables q~ (B, H, Nq, D) and k~
// (B, H, Nk, D) bf16, else null; key biases (B, nt * 64) f32; LSE and Dvec
// rows (B, H, Nqp) f32; live tiles (B, nt) and counts (B) int32.  This
// call runs the pre-pass (filling ``work``) and writes dq (B, H, Nq, D)
// f32.  Built for D = 64, 96 and 128.
extern "C" int p3_flash_bwd_dq_bf16_sm90(P3_BWD_ARGS, const void* graw,
                                         int raw_f32, void* dq,
                                         void* stream) {
  if (bad_shape(B, H, Nq, Nk, qcos, kcos, work) || raw_f32 < 0 ||
      raw_f32 > 3)
    return cudaErrorInvalidValue;
  const Args a = P3_BWD_MAKE;
  float* out = static_cast<float*>(dq);
  if (D == 64) return run_dq<64>(a, graw, raw_f32, out);
  if (D == 96) return run_dq<96>(a, graw, raw_f32, out);
  if (D == 128) return run_dq<128>(a, graw, raw_f32, out);
  return cudaErrorInvalidValue;
}

// As p3_flash_bwd_dq_bf16_sm90, after it on the same stream and with the
// same ``work``: dk and dv (B, H, Nk, D) f32.  The queries are walked in S
// = ceil(ceil(Nq / 64) / split_tiles) fixed splits; with S > 1 ``part`` is
// f32 scratch of 2 * S * B * H * Nk * D (else null).
extern "C" int p3_flash_bwd_dkdv_bf16_sm90(P3_BWD_ARGS, void* dk, void* dv,
                                           void* part, int split_tiles,
                                           void* stream) {
  if (bad_shape(B, H, Nq, Nk, qcos, kcos, work) || split_tiles < 1)
    return cudaErrorInvalidValue;
  const int ns = (padded(Nq) / QT + split_tiles - 1) / split_tiles;
  if ((ns > 1) != (part != nullptr)) return cudaErrorInvalidValue;
  const Args a = P3_BWD_MAKE;
  float* ok = static_cast<float*>(dk);
  float* ov = static_cast<float*>(dv);
  float* op = static_cast<float*>(part);
  if (D == 64) return run_dkdv<64>(a, ok, ov, op, split_tiles);
  if (D == 96) return run_dkdv<96>(a, ok, ov, op, split_tiles);
  if (D == 128) return run_dkdv<128>(a, ok, ov, op, split_tiles);
  return cudaErrorInvalidValue;
}
