// K3, bf16 and f32 — block-sparse masked attention on the Hopper engines
// (bf16: attn_sm90.cuh's barriers, TMA, wgmma, softmax step and row state,
// with a d=96 layout of its own; f32: attn_f32_sm90.cuh).
//
// Replaces panst3r_tpu/ops/pallas/masked_attention.py::_sparse_fwd (body
// _kernel), bf16 and f32: q (B, H, Nq, MD), k/v (B, H, Nk, MD), MD = 96
// or 128 (the wrapper pads any smaller head dim with zeros), and a (B,
// Nq, Nk) uint8 mask (1 = may not attend) shared across heads; softmax(q
// k^T * scale) v over the keys a row may attend; rows with no such key
// write 0; p rounded to the value dtype before both sums (the port's K3;
// the Pallas kernel sums the unrounded p into its denominator).
//
// Bound on the H100: at the main-path shape (B=1, H=8, Nq=200, Nk=3072)
// the live work (every 64x64 tile the plan visits) is 4*H*tiles*64*64*96
// = 2.4 GFLOP against 10.7 MB (q, out, the live k and v, the mask): 0.0024
// ms by operations at 989 TFLOP/s, 0.0032 ms by bytes at 3.35 TB/s; the
// long shape (Nk=12288) four times that.  In f32 the bytes double and the
// products bound it: 0.015 ms at 494.7 / 3 TFLOP/s of 3xTF32 work.
//
// Design, three launches per call:
// (a) masked_plan, one block per (batch, 64-query block): each warp tests
//     whole 64x64 mask tiles (16-byte loads), then warp 0 writes the live
//     64-key blocks in ascending order and their count (the first
//     ``count`` entries of plan_blocks' kv_idx).
// (b) the main kernel, 64-row CTAs, grid (query block, head, batch x
//     split).  Split-KV: a (batch, query block)'s live list is cut into
//     runs of ``split_tiles`` (the caller's constant:
//     ops/masked_attention.py::SPLIT_TILES), one CTA per run.  The
//     producer loads per live block, by TMA into a ring, K and V (64 keys
//     x 96 lanes as three 32-lane boxes) and the 64x64 byte tile of the
//     mask (a 2-D map over (Nk, B*Nq)).  The consumers compute S = Q K^T,
//     set blocked logits (mask, keys >= Nk, rows >= Nq: TMA fills what
//     lies outside with 0, which would mean "may attend") to NEG on the S
//     registers, run the softmax step and O += P V.  bf16 (masked_main):
//     one consumer warpgroup and the producer warpgroup, 64-byte swizzle,
//     S as six wgmma m64n64k16 steps, P V as four wgmma m64n96k16 with P
//     from registers and V an MN-major operand.  f32 (masked_main_f32):
//     four consumer warps and a producer warp, 128-byte swizzle, 3xTF32
//     mma.sync products (attn_f32_sm90.cuh).  With one split the CTA
//     writes rows of ``out``; with more it writes O, m and l in f32.
// (c) masked_combine merges the splits of a (batch, query block) in split
//     order (no atomics).  The split count depends on that block's live
//     count alone, so a row's result never depends on B, Nq or the grid.
#include <algorithm>

#include "attn_f32_sm90.cuh"

using namespace p3;
using namespace p3::sm90;

typedef __nv_bfloat16 bf16;

namespace {

// The head dim MD (96 or 128) is each kernel's template argument.
constexpr int BR = 64;                   // query rows per CTA
constexpr int BKK = 64;                  // keys per tile (the plan's block)
constexpr int SUB = 32;                  // lanes per 64B-swizzled sub-tile
constexpr int MSTAGES = 3;               // ring slots
constexpr uint32_t kSubBytes = BR * SUB * 2;          // 4 KB
constexpr uint32_t kMaskBytes = BR * BKK;             // 4 KB

template <int MD>
struct MSmem {
  static constexpr int NSUB = MD / SUB;                     // 3 or 4
  static constexpr uint32_t kTileBytes = NSUB * kSubBytes;  // 12 or 16 KB
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kTileBytes;
  static constexpr uint32_t kV = kK + MSTAGES * kTileBytes;
  static constexpr uint32_t kM = kV + MSTAGES * kTileBytes;
  static constexpr uint32_t kBar = kM + MSTAGES * kMaskBytes;
  static constexpr uint32_t kEnd = kBar + (1 + 2 * MSTAGES) * 8;
  static constexpr int kBytes = kEnd + 1024;  // room to align the base

  unsigned char* base;
  __device__ explicit MSmem(unsigned char* raw)
      : base(reinterpret_cast<unsigned char*>(
            (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023))) {}
  __device__ unsigned char* q() const { return base + kQ; }
  __device__ unsigned char* k(int s) const { return base + kK + s * kTileBytes; }
  __device__ unsigned char* v(int s) const { return base + kV + s * kTileBytes; }
  __device__ unsigned char* mask(int s) const {
    return base + kM + s * kMaskBytes;
  }
  __device__ uint64_t* q_full() const {
    return reinterpret_cast<uint64_t*>(base + kBar);
  }
  __device__ uint64_t* full(int s) const { return q_full() + 1 + s; }
  __device__ uint64_t* empty(int s) const {
    return q_full() + 1 + MSTAGES + s;
  }
};

__host__ __device__ __forceinline__ int n_splits(int live, int split_tiles) {
  return live > split_tiles ? (live + split_tiles - 1) / split_tiles : 1;
}

// True when the 16 mask bytes of ``v`` hold a 0 (bytes are 0 or 1).
__device__ __forceinline__ bool any_open(uint4 v) {
  return (v.x & v.y & v.z & v.w) != 0x01010101u;
}

// grid (ceil(Nq / 64), B), 1024 threads.  Warp w tests key blocks w, w +
// 32, ...: lane l reads rows 2l and 2l + 1 of the block (past Nq or Nk
// counts as blocked); then warp 0 writes the live blocks in order.
__global__ void __launch_bounds__(1024)
masked_plan(const uint8_t* __restrict__ mask, int* __restrict__ list,
            int* __restrict__ count, int Nq, int Nk, int ld, int nkb) {
  extern __shared__ int live_blk[];
  const int qb = blockIdx.x, b = blockIdx.y, nqb = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int kb = warp; kb < nkb; kb += 32) {
    const int c0 = kb * BKK;
    const int width = min(BKK, Nk - c0);
    bool open = false;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = qb * BR + 2 * lane + rr;
      if (i >= Nq) continue;
      const uint8_t* row = mask + ((long)b * Nq + i) * ld + c0;
      if (width == BKK) {  // rows of ld bytes, ld a multiple of 16
        const uint4* r4 = reinterpret_cast<const uint4*>(row);
#pragma unroll
        for (int c = 0; c < BKK / 16; ++c) open |= any_open(__ldg(r4 + c));
      } else {
        for (int c = 0; c < width; ++c) open |= row[c] == 0;
      }
    }
    open = __any_sync(0xffffffffu, open);
    if (lane == 0) live_blk[kb] = open;
  }
  __syncthreads();
  if (warp == 0) {
    const long plan = (long)b * nqb + qb;
    int n = 0;
    for (int t0 = 0; t0 < nkb; t0 += 32) {
      const int t = t0 + lane;
      const bool f = t < nkb && live_blk[t];
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) list[plan * nkb + n + __popc(m & ((1u << lane) - 1))] = t;
      n += __popc(m);
    }
    if (lane == 0) count[plan] = n;
  }
}

// grid (ceil(Nq / 64), H, B * max_splits).  ``mq``, ``mk``, ``mv``: (MD,
// N, B*H) maps, boxes 32 lanes x 64 rows, 64-byte swizzle; ``mm``: the
// (Nk, B*Nq) mask map, boxes 64 x 64 bytes.  With one split the CTA writes
// bf16 rows of ``out``; with more O (f32, (S, B, H, Nq, MD)) and (m, l)
// ((S, B, H, Nq, 2)) for masked_combine.
template <int MD>
__global__ void __launch_bounds__(256, 2)
masked_main(const __grid_constant__ CUtensorMap mq,
            const __grid_constant__ CUtensorMap mk,
            const __grid_constant__ CUtensorMap mv,
            const __grid_constant__ CUtensorMap mm,
            const int* __restrict__ list, const int* __restrict__ count,
            bf16* __restrict__ out, float* __restrict__ opart,
            float* __restrict__ ml, int B, int H, int Nq, int Nk, int nkb,
            int split_tiles, int max_splits, float sl) {
  extern __shared__ unsigned char smem_raw[];
  const int qb = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / max_splits, split = blockIdx.z % max_splits;
  const long plan = (long)b * gridDim.x + qb;
  const int live = count[plan];
  const int ns = n_splits(live, split_tiles);
  if (split >= ns) return;
  const int first = split * split_tiles;
  const int n = max(0, min(split_tiles, live - first));
  const int* tiles = list + plan * nkb + first;
  const int bh = b * H + h, q0 = qb * BR;
  using SM = MSmem<MD>;
  constexpr int NSUB = SM::NSUB;
  constexpr uint32_t kTileBytes = SM::kTileBytes;
  const SM sm(smem_raw);
  if (threadIdx.x == 0) {
    mbar_init(sm.q_full(), 1);
    for (int s = 0; s < MSTAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warpgroup
    regs_dec<Regs<1>::kProducer>();
    if (threadIdx.x == 128) {
      mbar_expect_tx(sm.q_full(), kTileBytes);
#pragma unroll
      for (int j = 0; j < NSUB; ++j)
        tma_load_3d(sm.q() + j * kSubBytes, &mq, sm.q_full(), j * SUB, q0, bh);
      for (int i = 0; i < n; ++i) {
        const int s = i % MSTAGES, c0 = tiles[i] * BKK;
        mbar_wait(sm.empty(s), ((i / MSTAGES) & 1) ^ 1);
        mbar_expect_tx(sm.full(s), 2 * kTileBytes + kMaskBytes);
#pragma unroll
        for (int j = 0; j < NSUB; ++j) {
          tma_load_3d(sm.k(s) + j * kSubBytes, &mk, sm.full(s), j * SUB, c0,
                      bh);
          tma_load_3d(sm.v(s) + j * kSubBytes, &mv, sm.full(s), j * SUB, c0,
                      bh);
        }
        tma_load_2d(sm.mask(s), &mm, sm.full(s), c0, b * Nq + q0);
      }
    }
    return;
  }

  // the consumer warpgroup: query rows q0 + [0, 64)
  regs_inc<Regs<1>::kConsumer>();
  const Rows rw;
  RowStateN<MD / 2> st;
  st.zero();
  const bool row_in[2] = {q0 + rw.r0 < Nq, q0 + rw.r1 < Nq};
  float s[32], alpha[2];
  uint32_t p[16];
  mbar_wait(sm.q_full(), 0);
  for (int i = 0; i < n; ++i) {
    const int cur = i % MSTAGES;
    const int keys = Nk - __ldg(tiles + i) * BKK;  // live keys: c < keys
    mbar_wait(sm.full(cur), (i / MSTAGES) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < MD / 16; ++kk)
      wgmma_ss_n64(s, desc_k_sub<BR>(sm.q(), kk),
                   desc_k_sub<BR>(sm.k(cur), kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    const unsigned char* mt = sm.mask(cur);
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int hh = Rows::hi(j), c = Rows::col(j) + rw.cq;
      const uint16_t m2 = *reinterpret_cast<const uint16_t*>(
          mt + (hh ? rw.r1 : rw.r0) * BKK + c);
      const bool open0 = row_in[hh] && c < keys && (m2 & 0xFF) == 0;
      const bool open1 = row_in[hh] && c + 1 < keys && (m2 >> 8) == 0;
      s[j] = open0 ? s[j] * sl : NEG;
      s[j + 1] = open1 ? s[j + 1] * sl : NEG;
    }
    softmax_step(st, rw, s, p, alpha, [](float x, int) { return x; });
    rescale(st, alpha);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BKK / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                             p[4 * kk + 3]};
      if constexpr (MD == 96)
        wgmma_rs_n96(st.o, a, desc_mn_sub<BKK>(sm.v(cur), kk), 1);
      else
        wgmma_rs_n128(st.o, a, desc_mn_sub<BKK>(sm.v(cur), kk), 1);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(st.o);
    fence_regs(p);  // the product reads p until it completes
    mbar_arrive(sm.empty(cur));
  }

  if (ns == 1) {
    store_normalized(st, rw, [&](int r) -> bf16* {
      const int i = q0 + r;
      return i < Nq ? out + ((long)bh * Nq + i) * MD : nullptr;
    });
    return;
  }
  const bool lead = (threadIdx.x & 3) == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = q0 + (hh ? rw.r1 : rw.r0);
    if (i >= Nq) continue;
    const long row = ((long)split * B * H + bh) * Nq + i;
    float* orow = opart + row * MD;
#pragma unroll
    for (int j = 0; j < MD / 2; j += 2) {
      if (Rows::hi(j) != hh) continue;
      *reinterpret_cast<float2*>(orow + Rows::col(j) + rw.cq) =
          make_float2(st.o[j], st.o[j + 1]);
    }
    if (lead) {
      ml[row * 2] = st.m[hh];
      ml[row * 2 + 1] = st.l[hh];
    }
  }
}

// f32: as masked_main, with four consumer warps and a producer warp on
// the f32 engine (``mq``, ``mk``, ``mv``: f32 maps, boxes 32 lanes x 64
// rows, 128-byte swizzle); the ring extra is the mask tile.  At MD = 128
// two ring slots fit in shared memory, at 96 three.
template <int MD>
using F32Smem = f32e::Smem<MD, 4, MD == 128 ? 2 : 3, kMaskBytes>;

template <int MD>
__global__ void __launch_bounds__(F32Smem<MD>::kThreads, 1)
masked_main_f32(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv,
                const __grid_constant__ CUtensorMap mm,
                const int* __restrict__ list, const int* __restrict__ count,
                float* __restrict__ out, float* __restrict__ opart,
                float* __restrict__ ml, int B, int H, int Nq, int Nk,
                int nkb, int split_tiles, int max_splits, float sl) {
  extern __shared__ unsigned char smem_raw[];
  using SM = F32Smem<MD>;
  constexpr int NSUB = MD / SUB;
  const int qb = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / max_splits, split = blockIdx.z % max_splits;
  const long plan = (long)b * gridDim.x + qb;
  const int live = count[plan];
  const int ns = n_splits(live, split_tiles);
  if (split >= ns) return;
  const int first = split * split_tiles;
  const int n = max(0, min(split_tiles, live - first));
  const int* tiles = list + plan * nkb + first;
  const int bh = b * H + h, q0 = qb * BR;
  const SM sm(smem_raw);
  sm.init();
  const int w = threadIdx.x >> 5;

  if (w == SM::kNW) {  // producer warp
    if (threadIdx.x == SM::kNW * 32) {
      f32e::produce(
          sm, n, 2 * SM::kKVBytes + kMaskBytes,
          [&](unsigned char* dst, uint64_t* bar) {
            for (int j = 0; j < NSUB; ++j)
              tma_load_3d(dst + j * BR * 128, &mq, bar, j * SUB, q0, bh);
          },
          [&](int e, unsigned char* kd, unsigned char* vd, unsigned char* xd,
              uint64_t* bar) {
            const int c0 = tiles[e] * BKK;
            for (int j = 0; j < NSUB; ++j) {
              tma_load_3d(kd + j * BKK * 128, &mk, bar, j * SUB, c0, bh);
              tma_load_3d(vd + j * BKK * 128, &mv, bar, j * SUB, c0, bh);
            }
            tma_load_2d(xd, &mm, bar, c0, b * Nq + q0);
          });
    }
    return;
  }
  // consumer warp w: query rows q0 + 16 w + [0, 16)
  mbar_wait(sm.q_full(), 0);
  f32e::split_q(sm, w);
  const Rows rw = f32e::tile_rows(w);
  const bool row_in[2] = {q0 + rw.r0 < Nq, q0 + rw.r1 < Nq};
  RowStateN<MD / 2> sts[1];
  RowStateN<MD / 2>& st = sts[0];
  st.zero();
  f32e::consume(sm, w, n, sts, [&](float (&s)[32], int, int e, int slot) {
    const int keys = Nk - __ldg(tiles + e) * BKK;  // live keys: c < keys
    const unsigned char* mt = sm.x(slot);
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int hh = Rows::hi(j), c = Rows::col(j) + rw.cq;
      const uint16_t m2 = *reinterpret_cast<const uint16_t*>(
          mt + (hh ? rw.r1 : rw.r0) * BKK + c);
      const bool open0 = row_in[hh] && c < keys && (m2 & 0xFF) == 0;
      const bool open1 = row_in[hh] && c + 1 < keys && (m2 >> 8) == 0;
      s[j] = open0 ? s[j] * sl : NEG;
      s[j + 1] = open1 ? s[j + 1] * sl : NEG;
    }
  });
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = q0 + (hh ? rw.r1 : rw.r0);
    if (i >= Nq) continue;
    if (ns == 1) {
      const float inv = 1.f / (st.l[hh] == 0.f ? 1.f : st.l[hh]);
      f32e::store_row(st, rw, hh, inv, out + ((long)bh * Nq + i) * MD);
      continue;
    }
    const long row = ((long)split * B * H + bh) * Nq + i;
    f32e::store_row(st, rw, hh, 1.f, opart + row * MD);
    if ((threadIdx.x & 3) == 0) {
      ml[row * 2] = st.m[hh];
      ml[row * 2 + 1] = st.l[hh];
    }
  }
}

// Merges the splits of rows whose (batch, query block) has more than one,
// in split order: out = sum_s w_s O_s / sum_s w_s l_s, w_s = exp2(m_s -
// max_s m_s), with the max replaced by 0 and w_s by 0 for splits that saw
// no live key.
template <int MD, typename T>
__global__ void masked_combine(const float* __restrict__ opart,
                               const float* __restrict__ ml,
                               const int* __restrict__ count,
                               T* __restrict__ out, int B, int H, int Nq,
                               int nqb, int split_tiles) {
  const long rows = (long)B * H * Nq, total = rows * MD;
  for (long e = blockIdx.x * (long)blockDim.x + threadIdx.x; e < total;
       e += (long)gridDim.x * blockDim.x) {
    const long row = e / MD;                    // (b * H + h) * Nq + i
    const int i = static_cast<int>(row % Nq);
    const int b = static_cast<int>(row / ((long)H * Nq));
    const int ns = n_splits(count[(long)b * nqb + i / BR], split_tiles);
    if (ns == 1) continue;
    float mx = NEG;
    for (int s = 0; s < ns; ++s) mx = fmaxf(mx, ml[(s * rows + row) * 2]);
    const float safe = (mx <= 0.5f * NEG) ? 0.f : mx;
    float num = 0.f, den = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float* mrow = ml + (s * rows + row) * 2;
      const float w = (mrow[0] <= 0.5f * NEG) ? 0.f : exp2f(mrow[0] - safe);
      num += w * opart[s * total + e];
      den += w * mrow[1];
    }
    out[e] = from_f<T>(num / (den == 0.f ? 1.f : den));
  }
}

// A (BH, N, MD) bf16 tensor as a 3-D map (MD, N, BH), boxes of 32 lanes x
// 64 rows, 64-byte swizzle.
template <int MD>
cudaError_t make_map_bf16(CUtensorMap* map, const void* base, int BH,
                          int N) {
  const cuuint64_t dims[3] = {MD, (cuuint64_t)N, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {MD * 2, (cuuint64_t)N * MD * 2};
  const cuuint32_t box[3] = {SUB, BR, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_64B);
}

// The plan pre-pass, then the main kernel and the split merge at head dim
// MD (p3_masked_attn_sm90's arguments).
template <int MD>
cudaError_t run(const void* q, const void* k, const void* v,
                const void* mask, void* out, int* lst, int* cnt, void* part,
                int B, int H, int Nq, int Nk, int ld, float scale,
                int split_tiles, int f32, int nqb, int nkb, int max_splits,
                cudaStream_t st) {
  masked_plan<<<dim3(nqb, B), 1024, nkb * sizeof(int), st>>>(
      static_cast<const uint8_t*>(mask), lst, cnt, Nq, Nk, ld, nkb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap mq, mk, mv, mm;
  if (f32) {
    if ((err = f32e::make_map(&mq, q, B * H, Nq, MD, BR)) != cudaSuccess ||
        (err = f32e::make_map(&mk, k, B * H, Nk, MD, BKK)) != cudaSuccess ||
        (err = f32e::make_map(&mv, v, B * H, Nk, MD, BKK)) != cudaSuccess)
      return err;
  } else {
    if ((err = make_map_bf16<MD>(&mq, q, B * H, Nq)) != cudaSuccess ||
        (err = make_map_bf16<MD>(&mk, k, B * H, Nk)) != cudaSuccess ||
        (err = make_map_bf16<MD>(&mv, v, B * H, Nk)) != cudaSuccess)
      return err;
  }
  {
    const cuuint64_t dims[2] = {(cuuint64_t)Nk, (cuuint64_t)B * Nq};
    const cuuint64_t strides[1] = {(cuuint64_t)ld};
    const cuuint32_t box[2] = {BKK, BR};
    if ((err = encode_map(&mm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, mask, dims,
                          strides, box, CU_TENSOR_MAP_SWIZZLE_NONE)) !=
        cudaSuccess)
      return err;
  }
  float* op = static_cast<float*>(part);
  float* mlp = op ? op + (long)max_splits * B * H * Nq * MD : nullptr;
  const dim3 grid(nqb, H, B * max_splits);
  if (f32) {
    using SM = F32Smem<MD>;
    auto kern = masked_main_f32<MD>;
    if ((err = prepare(kern, SM::kBytes)) != cudaSuccess) return err;
    kern<<<grid, SM::kThreads, SM::kBytes, st>>>(
        mq, mk, mv, mm, lst, cnt, static_cast<float*>(out), op, mlp, B, H, Nq,
        Nk, nkb, split_tiles, max_splits, scale * L2E);
  } else {
    const int bytes = MSmem<MD>::kBytes;
    auto kern = masked_main<MD>;
    if ((err = prepare(kern, bytes)) != cudaSuccess) return err;
    kern<<<grid, 256, bytes, st>>>(
        mq, mk, mv, mm, lst, cnt, static_cast<bf16*>(out), op, mlp, B, H, Nq,
        Nk, nkb, split_tiles, max_splits, scale * L2E);
  }
  if ((err = cudaGetLastError()) != cudaSuccess || max_splits == 1) return err;
  const long total = (long)B * H * Nq * MD;
  const int cblocks =
      static_cast<int>(std::min<long>((total + 255) / 256, 132L * 16));
  if (f32)
    masked_combine<MD><<<cblocks, 256, 0, st>>>(op, mlp, cnt,
                                                static_cast<float*>(out), B,
                                                H, Nq, nqb, split_tiles);
  else
    masked_combine<MD><<<cblocks, 256, 0, st>>>(op, mlp, cnt,
                                                static_cast<bf16*>(out), B,
                                                H, Nq, nqb, split_tiles);
  return cudaGetLastError();
}

}  // namespace

P3_ERROR_STRING_FN

// q (B, H, Nq, D), k/v (B, H, Nk, D), D = 96 or 128, bf16, or f32 with
// ``f32``; mask (B, Nq, ld) uint8 (1 = blocked; columns >= Nk are never
// read as open), ld >= Nk a multiple of 16; out (B, H, Nq, D) in the
// inputs' dtype.  Scratch from the caller, with nqb = ceil(Nq / 64), nkb
// = ceil(Nk / 64) and S = ceil(nkb / split_tiles) splits: ``plan`` int32
// of B * nqb * (nkb + 1) (the lists (B, nqb, nkb), then the counts (B,
// nqb)); with S > 1 ``part`` f32 of S * B * H * Nq * (D + 2) (O (S, B, H,
// Nq, D), then (m, l) (S, B, H, Nq, 2)), else null.
extern "C" int p3_masked_attn_sm90(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   void* out, void* plan, void* part, int B,
                                   int H, int Nq, int Nk, int ld, float scale,
                                   int split_tiles, int f32, int D,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nqb = (Nq + BR - 1) / BR, nkb = (Nk + BKK - 1) / BKK;
  if (split_tiles < 1 || ld < Nk || ld % 16 != 0 || Nq < 1 || Nk < 1 ||
      nkb * 4L > 48 * 1024)
    return cudaErrorInvalidValue;
  const int max_splits = n_splits(nkb, split_tiles);
  if ((max_splits > 1) != (part != nullptr)) return cudaErrorInvalidValue;
  int* lst = static_cast<int*>(plan);
  int* cnt = lst + (long)B * nqb * nkb;
  if (D == 96)
    return run<96>(q, k, v, mask, out, lst, cnt, part, B, H, Nq, Nk, ld,
                   scale, split_tiles, f32, nqb, nkb, max_splits, st);
  if (D == 128)
    return run<128>(q, k, v, mask, out, lst, cnt, part, B, H, Nq, Nk, ld,
                    scale, split_tiles, f32, nqb, nkb, max_splits, st);
  return cudaErrorInvalidValue;
}
