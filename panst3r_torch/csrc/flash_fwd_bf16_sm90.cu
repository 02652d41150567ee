// K4, bf16 — generic flash attention forward on the Hopper engine
// (attn_sm90.cuh: TMA ring, wgmma, the softmax in registers).  The f32 K4
// is flash_fwd_sm90.cu (the 3xTF32 engine).
//
// Replaces panst3r_tpu/ops/pallas/flash_attention.py::_flash_fwd (body
// _kernel) in bf16: online-softmax attention over (B, H, N, D) streams, D =
// 64, 96 or 128 (the wrapper pads any smaller head dim with zeros), with, each optional, a dense additive bias read through its
// strides (0 where it is broadcast), a per-key bias row (B, Nk) (the (B|1,
// 1, 1, Nk) bias and the key validity folded into it by the wrapper: 0 /
// finfo.min), 2D-RoPE tables (B, N, D) shared by the heads, and the
// natural-log LSE per row.  As in the Pallas kernel: q and k are rotated
// by the tables in f32 and rounded to bf16 (q is not pre-scaled), the f32
// score is multiplied by scale * log2(e) and the biases, in log2 units, are
// added after it; the row sum takes the unrounded f32 p and p.v takes p
// rounded to bf16 (the engine's softmax step without ``RoundedSum``); a
// row with no live key writes 0 and the LSE finfo.min; the LSE is (m +
// log2 l) * ln 2, which the bf16 K5 (flash_bwd_bf16_sm90.cu) reads.
//
// Bound on the H100: at the v2 LoftUp shape (B=4, H=4, Nq=49152, Nk=768,
// D=96) 232 GFLOP against ~0.15 GB of q and out: bound by operations,
// 0.2344 ms at 989 TFLOP/s.  One exp2 per score (6.0e8) is 0.14 ms on the
// special-function units.
//
// Design, two or three launches per call:
// (1) with tables, rope_bf16 (attn_sm90.cuh) writes q~ and k~ =
//     bf16(rope(x)) (B, H, N, D) contiguous (one thread per 8 lanes, read
//     through the strides);
// (2) cross_tiles (attn_sm90.cuh) writes the key row in log2 units padded
//     to whole key tiles (NEG where dead or past Nk) and each batch's live
//     tiles (every tile below Nk without a row);
// (3) fwd_main: one CTA per (64 * NWG query rows, head, batch), NWG
//     consumer warpgroups and the producer warpgroup, which loads the Q
//     tiles once and each live key tile's K, V and key biases into a ring
//     of STAGES slots.  q, k, v are 4-D tensor maps (lanes, then token,
//     head and batch in ascending order of stride: K6's maps), so the
//     split-heads views of a (B, N, H*D) projection are read in place, and
//     out is written through its strides into the (B, Nq, H, D) storage
//     the wrapper allocates.  D = 64: the K1/K2 layout (128-key tiles,
//     64-lane rows of 128 bytes, 128B swizzle, wgmma m64n128k16 and
//     m64n64k16).  D = 96 and 128: K3's layout (64-key tiles as three or
//     four 32-lane boxes of 64-byte rows, 64B swizzle, wgmma m64n64k16 and
//     m64n96k16 or m64n128k16), 64-row CTAs.  TMA cannot step a 0 stride, so the consumers read a
//     dense bias from global memory at their accumulators' positions.
// A row's arithmetic depends only on its own q, its batch's k, v and
// biases and Nk: never on B, Nq or the grid.
#include "attn_sm90.cuh"

using namespace p3;
using namespace p3::sm90;

typedef __nv_bfloat16 bf16;

namespace {

constexpr float LN2 = 0.6931471805599453f;

// d = 96 and 128 (K3's layout): a tile of 64 rows x d lanes as d / 32
// sub-tiles of 32 lanes and 64-byte rows, 4 KB each (desc_k_sub,
// desc_mn_sub).
constexpr uint32_t kSub32 = 64 * 32 * 2;

// The two layouts: keys per tile, S and O registers, the TMA boxes (BOX
// lanes, NBOX of them per row) and the products.
template <int D>
struct Lay;
template <>
struct Lay<64> {
  static constexpr int BT = BKT, NS = 64, NO = 32, BOX = 64, NBOX = 1;
  static constexpr uint32_t kQ = BQW * 64 * 2, kKV = BT * 64 * 2;
  static constexpr uint32_t kBoxQ = kQ, kBoxKV = kKV;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  __device__ static void scores(float (&s)[NS], const unsigned char* q,
                                const unsigned char* k) {
    issue_scores(s, q, k);
  }
  __device__ static void pv(float (&o)[NO], const uint32_t (&p)[NS / 2],
                            const unsigned char* v) {
    issue_pv(o, p, v);
  }
};
template <>
struct Lay<96> {
  static constexpr int BT = 64, NS = 32, NO = 48, BOX = 32, NBOX = 3;
  static constexpr uint32_t kQ = 3 * kSub32, kKV = 3 * kSub32;
  static constexpr uint32_t kBoxQ = kSub32, kBoxKV = kSub32;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_64B;
  __device__ static void scores(float (&s)[NS], const unsigned char* q,
                                const unsigned char* k) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 96 / 16; ++kk)
      wgmma_ss_n64(s, desc_k_sub<64>(q, kk), desc_k_sub<64>(k, kk),
                   kk > 0);
    wg_commit();
  }
  __device__ static void pv(float (&o)[NO], const uint32_t (&p)[NS / 2],
                            const unsigned char* v) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                             p[4 * kk + 3]};
      wgmma_rs_n96(o, a, desc_mn_sub<64>(v, kk), 1);
    }
    wg_commit();
  }
};
template <>
struct Lay<128> {
  static constexpr int BT = 64, NS = 32, NO = 64, BOX = 32, NBOX = 4;
  static constexpr uint32_t kQ = 4 * kSub32, kKV = 4 * kSub32;
  static constexpr uint32_t kBoxQ = kSub32, kBoxKV = kSub32;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_64B;
  __device__ static void scores(float (&s)[NS], const unsigned char* q,
                                const unsigned char* k) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 128 / 16; ++kk)
      wgmma_ss_n64(s, desc_k_sub<64>(q, kk), desc_k_sub<64>(k, kk),
                   kk > 0);
    wg_commit();
  }
  __device__ static void pv(float (&o)[NO], const uint32_t (&p)[NS / 2],
                            const unsigned char* v) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                             p[4 * kk + 3]};
      wgmma_rs_n128(o, a, desc_mn_sub<64>(v, kk), 1);
    }
    wg_commit();
  }
};

// Dynamic shared memory of a CTA: the warpgroups' Q tiles, then per ring
// slot the K tile, the V tile and the tile's key biases; every tile on a
// 1024-byte boundary of the aligned base.
template <int D, int NWG>
struct FSmem {
  using L = Lay<D>;
  static constexpr uint32_t kBiasB = L::BT * 4;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + NWG * L::kQ;
  static constexpr uint32_t kV = kK + STAGES * L::kKV;
  static constexpr uint32_t kBias = kV + STAGES * L::kKV;
  static constexpr uint32_t kBar = kBias + STAGES * kBiasB;
  static constexpr uint32_t kEnd = kBar + (1 + 2 * STAGES) * 8;
  static constexpr int kBytes = kEnd + 1024;    // room to align the base

  unsigned char* base;
  __device__ explicit FSmem(unsigned char* raw)
      : base(reinterpret_cast<unsigned char*>(
            (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023))) {}
  __device__ unsigned char* q(int g) const { return base + kQ + g * L::kQ; }
  __device__ unsigned char* k(int s) const { return base + kK + s * L::kKV; }
  __device__ unsigned char* v(int s) const { return base + kV + s * L::kKV; }
  __device__ float* bias(int s) const {
    return reinterpret_cast<float*>(base + kBias + s * kBiasB);
  }
  __device__ uint64_t* q_full() const {
    return reinterpret_cast<uint64_t*>(base + kBar);
  }
  __device__ uint64_t* full(int s) const { return q_full() + 1 + s; }
  __device__ uint64_t* empty(int s) const {
    return q_full() + 1 + STAGES + s;
  }
};

// grid (ceil(Nq / (64 NWG)), H, B).
template <int D, int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, Regs<NWG>::kMinBlocks)
fwd_main(const __grid_constant__ CUtensorMap mq,
         const __grid_constant__ CUtensorMap mk,
         const __grid_constant__ CUtensorMap mv, const Perm pq,
         const Perm pk, const Perm pv, const float* __restrict__ bl,
         const int* __restrict__ list, const int* __restrict__ count,
         const float* __restrict__ bias, BiasStrides bs,
         bf16* __restrict__ out, Strides3 os, float* __restrict__ lse, int H,
         int Nq, int Nk, int nt, float sl) {
  using L = Lay<D>;
  using SM = FSmem<D, NWG>;
  constexpr int BT = L::BT;
  extern __shared__ unsigned char smem_raw[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * NWG * BQW;
  const int n = count[b];
  const int* tiles = list + b * nt;
  const SM sm(smem_raw);
  if (threadIdx.x == 0) {
    mbar_init(sm.q_full(), 1);
    for (int s = 0; s < STAGES; ++s) {
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
      mbar_expect_tx(sm.q_full(), NWG * L::kQ);
#pragma unroll
      for (int g = 0; g < NWG; ++g) {
        const int tok = q0 + g * BQW;
#pragma unroll
        for (int j = 0; j < L::NBOX; ++j)
          tma_load_4d(sm.q(g) + j * L::kBoxQ, &mq, sm.q_full(), j * L::BOX,
                      pick(0, pq, tok, h, b), pick(1, pq, tok, h, b),
                      pick(2, pq, tok, h, b));
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES, tok = tiles[i] * BT;
        mbar_wait(sm.empty(s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(sm.full(s), 2 * L::kKV + SM::kBiasB);
#pragma unroll
        for (int j = 0; j < L::NBOX; ++j) {
          tma_load_4d(sm.k(s) + j * L::kBoxKV, &mk, sm.full(s), j * L::BOX,
                      pick(0, pk, tok, h, b), pick(1, pk, tok, h, b),
                      pick(2, pk, tok, h, b));
          tma_load_4d(sm.v(s) + j * L::kBoxKV, &mv, sm.full(s), j * L::BOX,
                      pick(0, pv, tok, h, b), pick(1, pv, tok, h, b),
                      pick(2, pv, tok, h, b));
        }
        bulk_load(sm.bias(s), bl + (long)b * nt * BT + tok, SM::kBiasB,
                  sm.full(s));
      }
    }
    return;
  }
  // consumer warpgroup wg: query rows q0 + 64 wg + [0, 64)
  regs_inc<Regs<NWG>::kConsumer>();
  const Rows rw;
  RowStateN<L::NO> st;
  st.zero();
  const int row0 = q0 + wg * BQW;
  const int rows[2] = {row0 + rw.r0, row0 + rw.r1};
  const float* bh = bias ? bias + b * bs.b + h * bs.h : nullptr;
  float s[L::NS], alpha[2];
  uint32_t p[L::NS / 2];
  mbar_wait(sm.q_full(), 0);
  for (int i = 0; i < n; ++i) {
    const int cur = i % STAGES;
    const int key0 = __ldg(tiles + i) * BT;
    mbar_wait(sm.full(cur), (i / STAGES) & 1);
    L::scores(s, sm.q(wg), sm.k(cur));
    wg_wait<0>();
    fence_regs(s);
    // logits in log2 units in place: score * scale * log2 e + key bias (+
    // dense bias * log2 e), NEG where masked
    const float* kb = sm.bias(cur);
#pragma unroll
    for (int j = 0; j < L::NS; ++j) {
      const int hh = Rows::hi(j), c = Rows::col(j) + rw.cq;
      float x = fmaf(s[j], sl, kb[c]);
      if (bh != nullptr && rows[hh] < Nq && key0 + c < Nk) {
        const float v = bh[rows[hh] * bs.q + (key0 + c) * bs.k];
        x = (v <= 0.5f * NEG) ? NEG : fmaf(v, L2E, x);
      }
      s[j] = (x <= 0.5f * NEG) ? NEG : x;
    }
    softmax_step<false>(st, rw, s, p, alpha, [](float x, int) { return x; });
    rescale(st, alpha);
    L::pv(st.o, p, sm.v(cur));
    wg_wait<0>();
    fence_regs(st.o);
    fence_regs(p);  // the product reads p until it completes
    mbar_arrive(sm.empty(cur));
  }
  store_normalized(st, rw, [&](int r) -> bf16* {
    const int i = row0 + r;
    return i < Nq ? out + b * os.b + h * os.h + i * os.n : nullptr;
  });
  if (lse != nullptr && (threadIdx.x & 3) == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (rows[hh] >= Nq) continue;
      const float m = st.m[hh];
      lse[((long)b * H + h) * Nq + rows[hh]] =
          (m <= 0.5f * NEG) ? NEG : (m + log2f(st.l[hh])) * LN2;
    }
  }
}

struct Args {
  const bf16 *q, *k, *v;
  const float *bias, *kbias, *qcos, *qsin, *kcos, *ksin;
  bf16* out;
  float* lse;
  const long long* s;  // q, k, v, out (batch, head, token), bias (4)
  int B, H, Nq, Nk;
  float scale;
  int nwg;
  bf16 *qr, *kr;
  float* bl;
  int *list, *count;
  cudaStream_t st;
};

template <int D, int NWG>
cudaError_t run_main(const Args& a, const bf16* q, const long long* qs,
                     const bf16* k, const long long* ks, int nt) {
  using L = Lay<D>;
  using SM = FSmem<D, NWG>;
  const long long* s = a.s;
  CUtensorMap mq, mk, mv;
  Perm pq, pk, pv;
  cudaError_t err;
  constexpr CUtensorMapDataType BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if ((err = make_map4(&mq, BF, 2, q, a.B, a.H, a.Nq, D, qs[0], qs[1], qs[2],
                       L::BOX, BQW, L::kSwizzle, &pq)) != cudaSuccess ||
      (err = make_map4(&mk, BF, 2, k, a.B, a.H, a.Nk, D, ks[0], ks[1], ks[2],
                       L::BOX, L::BT, L::kSwizzle, &pk)) != cudaSuccess ||
      (err = make_map4(&mv, BF, 2, a.v, a.B, a.H, a.Nk, D, s[6], s[7], s[8],
                       L::BOX, L::BT, L::kSwizzle, &pv)) != cudaSuccess)
    return err;
  auto kern = fwd_main<D, NWG>;
  if ((err = prepare(kern, SM::kBytes)) != cudaSuccess) return err;
  const dim3 grid((a.Nq + NWG * BQW - 1) / (NWG * BQW), a.H, a.B);
  kern<<<grid, (NWG + 1) * 128, SM::kBytes, a.st>>>(
      mq, mk, mv, pq, pk, pv, a.bl, a.list, a.count, a.bias,
      BiasStrides{s[12], s[13], s[14], s[15]}, a.out,
      Strides3{s[9], s[10], s[11]}, a.lse, a.H, a.Nq, a.Nk, nt,
      a.scale * L2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t run(const Args& a) {
  constexpr int BT = Lay<D>::BT;
  const int nt = (a.Nk + BT - 1) / BT;
  if (nt * 4L > 48 * 1024) return cudaErrorInvalidValue;
  const long long* s = a.s;
  const bf16 *q = a.q, *k = a.k;
  long long qs[3] = {s[0], s[1], s[2]}, ks[3] = {s[3], s[4], s[5]};
  cudaError_t err;
  if (a.qcos != nullptr) {   // q~, k~ contiguous
    if ((err = rotate_bf16<D>(a.q, s, a.qcos, a.qsin, a.qr, a.B, a.H, a.Nq,
                              a.st)) != cudaSuccess ||
        (err = rotate_bf16<D>(a.k, s + 3, a.kcos, a.ksin, a.kr, a.B, a.H,
                              a.Nk, a.st)) != cudaSuccess)
      return err;
    q = a.qr;
    k = a.kr;
    qs[0] = (long long)a.H * a.Nq * D, qs[1] = (long long)a.Nq * D, qs[2] = D;
    ks[0] = (long long)a.H * a.Nk * D, ks[1] = (long long)a.Nk * D, ks[2] = D;
  }
  cross_tiles<BT><<<a.B, 1024, nt * sizeof(int), a.st>>>(
      a.kbias, a.bl, a.list, a.count, a.Nk, nt);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if constexpr (D != 64)
    return run_main<D, 1>(a, q, qs, k, ks, nt);
  else
    return a.nwg == 1 ? run_main<D, 1>(a, q, qs, k, ks, nt)
                      : run_main<D, 2>(a, q, qs, k, ks, nt);
}

}  // namespace

P3_ERROR_STRING_FN

// bf16 q (B, H, Nq, D), k/v (B, H, Nk, D) and out (B, H, Nq, D) through
// the element strides in strides[0..11] (q, k, v, out: batch, head,
// token; those of q, k and v multiples of 8 with 16-byte aligned bases: a
// tensor map or a 16-byte load reads them); bias: dense f32 bias through
// strides[12..15] (batch, head, query, key) or null; kbias (B, Nk) f32 or
// null; tables (B, N, D) f32, all four or none; lse (B, H, Nq) f32 or
// null; ``nwg`` consumer warpgroups per CTA at D = 64 (1 or 2; D = 96
// and 128 take 1).  Scratch from the caller, with BT = 128 keys per tile
// at D = 64 and 64 at D = 96 and 128 and nt = ceil(Nk / BT): with tables
// qr (B, H, Nq, D) and kr (B, H, Nk, D) bf16, else null; bl (B, nt * BT)
// f32; list (B, nt) and count (B) int32.  Built for D = 64, 96 and 128.
extern "C" int p3_flash_fwd_bf16_sm90(
    const void* q, const void* k, const void* v, const void* bias,
    const void* kbias, const void* qcos, const void* qsin, const void* kcos,
    const void* ksin, void* out, void* lse, const long long* strides, int B,
    int H, int Nq, int Nk, int D, float scale, int nwg, void* qr, void* kr,
    void* bl, void* list, void* count, void* stream) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || (nwg != 1 && nwg != 2) ||
      (qcos != nullptr) != (qr != nullptr) ||
      (qcos != nullptr) != (kr != nullptr))
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  const Args a{h(q),     h(k),     h(v),     f(bias),
               f(kbias), f(qcos),  f(qsin),  f(kcos),
               f(ksin),  static_cast<bf16*>(out), static_cast<float*>(lse),
               strides,  B,        H,        Nq,
               Nk,       scale,    nwg,      static_cast<bf16*>(qr),
               static_cast<bf16*>(kr), static_cast<float*>(bl),
               static_cast<int*>(list), static_cast<int*>(count),
               static_cast<cudaStream_t>(stream)};
  if (D == 64) return run<64>(a);
  if (D == 96) return run<96>(a);
  if (D == 128) return run<128>(a);
  return cudaErrorInvalidValue;
}
