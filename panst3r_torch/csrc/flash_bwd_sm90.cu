// K5, f32 — flash-attention backward on the Hopper f32 engine
// (attn_f32_sm90.cuh, 3xTF32; the shared pieces in flash_sm90.cuh, and
// the pre-pass row_stats, the split merge and the formulas of p and ds in
// attn_sm90.cuh, which the bf16 K5, flash_bwd_bf16_sm90.cu, shares).
//
// Replaces panst3r_tpu/ops/pallas/flash_attention_bwd.py::flash_bwd in
// f32 and its two kernels, _dq_kernel (query rows, walking the keys) and
// _dkv_kernel (key rows, walking the queries).  Both recompute the
// probabilities from q, k and the LSE that K4 saved:
//   s  = q.k^T * scale + per-key bias row + dense bias (as K4 takes them)
//   p  = exp(s - lse), 0 where s <= finfo.min/2 or the row's LSE is
//        <= finfo.min/2 (no live key) or >= -finfo.min/2 (padding)
//   dp = do.v^T;  ds = p * (dp - Dvec) * scale,  Dvec = rowsum(do*o) in
//        f32, summed by the pre-pass in an order fixed per row
//   dq = ds.k;  dk = ds^T.q;  dv = p^T.do
// with q and k rotated by the RoPE tables (the wrapper applies the
// rotation's adjoint to dq and dk).  The gradients leave in f32 (B, H, N,
// D).  No atomics: two calls, and a batch and its slices, give the same
// bits (dq also for a query range and the whole).
//
// Bound on the H100: seven products of 2 B H Nq Nk D FLOPs (s and dp in
// both kernels, dq, dk, dv).  At the LoftUp training shape (B*V = 10, H
// = 4, Nq = 49152, Nk = 768, D = 96) that is 2.03 TFLOP per call against
// ~4 GB of q, k, v, do and gradients: bound by operations, 12.3 ms at the
// 494.7 / 3 TFLOP/s of 3xTF32 products.
//
// Design.  (1) Pre-pass (p3_flash_bwd_dq_sm90): q and k rotated by their
// tables, and q, do, k, v written as TF32 hi/lo planes (B*H, N, D); the
// key biases in log2 units padded to 32-key tiles and each batch's live
// tiles; the LSE in log2 units and Dvec, padded to whole 64-query tiles
// (padding rows: p = 0).  Dvec is summed here and not by torch, whose
// reduction picks its thread layout from the number of rows: a query
// range's Dvec could then differ from the whole call's in its last bit.
// (2) dq: 64-row CTAs of eight warps in two groups (below), Q and dO
// resident (TMA from their planes), the live 32-key entries of K and V
// through the groups' ring slots; S (qk_rn) and dP (in the tensor core),
// dS in registers fed back as the A operand of dS.K (the key-order
// permutation of flash_sm90.cuh, pv), dQ added per 8 keys in f32.  (3)
// dkdv: 64-key CTAs of eight warps in two groups, K and V resident, the
// queries of a fixed split (``split_tiles`` tiles of 64) through the
// groups' slots (Q and dO planes, LSE and Dvec); S^T = K Q^T (qk_rn) and
// dP^T = V dO^T, P^T and dS^T in registers as A operands of dV += P^T dO
// and dK += dS^T Q, each 8-query step added in f32 round-to-nearest.  With
// more than one split each CTA writes its partial dK, dV and dkv_merge
// adds them in split order.  The split makes LoftUp's 12 key tiles per
// (b, h) fill the card: 96 CTAs at B=2 would be under one wave.  A key
// tile whose biases are all dead writes zeros.  Pre-splitting Q and dO
// beats splitting each streamed tile once per dkdv CTA (PERF.md, section
// 6).
#include "flash_sm90.cuh"

using namespace p3;
using namespace p3::flash32;
using sm90::dkv_merge;
using sm90::dscore;
using sm90::prob;
using sm90::row_stats;

namespace {

// Both kernels run eight warps and no producer warp (so that each may
// hold its accumulators in up to 255 registers), in two groups of four
// over the same 64 rows, so that each SM sub-partition has two warps to
// hide the latency of the other's products (the shared memory holds one
// CTA).  Group g owns ring slot g and takes the entries g, g + 2, ...
// (dq: of the batch's live list; dkdv: of its split), its first thread
// issuing each entry's loads once the group has released the slot; the
// groups' partial sums are added in group order at the end.
// dq: resident Q hi, Q lo, dO hi, dO lo; ring: K hi, K lo, V hi, V lo and
// the entry's key biases.
template <int D>
using DqSmem = flash32::Smem<D, 8, 1, 4, 4, 2, KE * 4, 2>;
// dkdv: resident K hi, K lo, V hi, V lo; ring: Q hi, Q lo, dO hi, dO lo
// and the entry's LSE (log2 units) and Dvec.
template <int D>
using DkvSmem = flash32::Smem<D, 8, 1, 4, 4, 2, 2 * KE * 4, 2>;

template <int D>
__global__ void __launch_bounds__(DqSmem<D>::kThreads, 1)
dq_main(const __grid_constant__ CUtensorMap mqh,
        const __grid_constant__ CUtensorMap mql,
        const __grid_constant__ CUtensorMap mgh,
        const __grid_constant__ CUtensorMap mgl,
        const __grid_constant__ CUtensorMap mkh,
        const __grid_constant__ CUtensorMap mkl,
        const __grid_constant__ CUtensorMap mvh,
        const __grid_constant__ CUtensorMap mvl,
        const float* __restrict__ bl, const int* __restrict__ list,
        const int* __restrict__ count, const float* __restrict__ bias,
        BiasStrides bs, const float* __restrict__ lse2,
        const float* __restrict__ dvec, float* __restrict__ dq, int H,
        int Nq, int Nk, int nt, int Nqp, float sl, float scale) {
  extern __shared__ unsigned char smem_raw[];
  using SM = DqSmem<D>;
  constexpr int R = SM::R;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * R;
  const int bh = b * H + h;
  const int n = count[b];
  const int* tiles = list + b * nt;
  const SM sm(smem_raw);
  sm.init();
  if (threadIdx.x == 0) {
    uint64_t* qb = sm.q_full();
    sm90::mbar_expect_tx(qb, 4 * SM::kA);
    load_plane(sm.a(0), &mqh, qb, D, R, q0, bh);
    load_plane(sm.a(1), &mql, qb, D, R, q0, bh);
    load_plane(sm.a(2), &mgh, qb, D, R, q0, bh);
    load_plane(sm.a(3), &mgl, qb, D, R, q0, bh);
  }
  // warp w of group w / 4: query rows q0 + 16 (w % 4) + [0, 16)
  const int w = threadIdx.x >> 5, gr = w >> 2, wr = w & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, cq = 2 * (lane & 3);
  const int row0 = q0 + 16 * wr + g;
  const float l2[2] = {lse2[(long)bh * Nqp + row0],
                       lse2[(long)bh * Nqp + row0 + 8]};
  const float dv[2] = {dvec[(long)bh * Nqp + row0],
                       dvec[(long)bh * Nqp + row0 + 8]};
  const float* bhp = bias ? bias + b * bs.b + h * bs.h : nullptr;
  RowStateN<D / 2> acc[1];
  acc[0].zero();
  const uint32_t qh = sm90::smem_u32(sm.a(0)), ql = sm90::smem_u32(sm.a(1));
  const uint32_t gh = sm90::smem_u32(sm.a(2)), gl = sm90::smem_u32(sm.a(3));
  // the group's ring slot, and its loads
  const uint32_t kh = sm90::smem_u32(sm.b(gr, 0));
  const uint32_t kl = sm90::smem_u32(sm.b(gr, 1));
  const uint32_t vh = sm90::smem_u32(sm.b(gr, 2));
  const uint32_t vl = sm90::smem_u32(sm.b(gr, 3));
  const float* kb = reinterpret_cast<const float*>(sm.x(gr));
  uint64_t* bar = sm.full(gr);
  sm90::mbar_wait(sm.q_full(), 0);
  float s[1][16], dp[1][16];
  for (int e = gr, k = 0; e < n; e += 2, ++k) {
    const int key0 = __ldg(tiles + e) * KE;
    if ((threadIdx.x & 127) == 0) {   // the group's first thread
      sm90::mbar_expect_tx(bar, 4 * SM::kB + KE * 4);
      load_plane(sm.b(gr, 0), &mkh, bar, D, KE, key0, bh);
      load_plane(sm.b(gr, 1), &mkl, bar, D, KE, key0, bh);
      load_plane(sm.b(gr, 2), &mvh, bar, D, KE, key0, bh);
      load_plane(sm.b(gr, 3), &mvl, bar, D, KE, key0, bh);
      sm90::bulk_load(sm.x(gr), bl + (long)b * nt * KE + key0, KE * 4, bar);
    }
    sm90::mbar_wait(bar, k & 1);
    qk_rn<D, R, KE, 1, 4>(s, qh, ql, 16 * wr, kh, kl);
    qk<D, R, KE, 1, 4>(dp, gh, gl, 16 * wr, vh, vl);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = Rows::col(i) + cq, hh = Rows::hi(i);
      const int row = row0 + 8 * hh, key = key0 + c;
      const float* db = (bhp != nullptr && row < Nq && key < Nk)
                            ? bhp + row * bs.q + key * bs.k
                            : nullptr;
      const float p = prob(logit(s[0][i], sl, kb[c], db), l2[hh]);
      s[0][i] = dscore(p, dp[0][i], dv[hh], scale);
    }
    pv<D, KE, 1, 4>(s, acc, kh, kl);   // dQ += dS K
    group_sync(gr);                    // the slot may be refilled
  }
  // group 1's partial dQ through the (now idle) ring, added to group 0's
  float* part =
      reinterpret_cast<float*>(sm.b(0, 0)) + (wr * 32 + lane) * (D / 2);
  __syncthreads();
  if (gr == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) part[i] = acc[0].o[i];
  }
  __syncthreads();
  if (gr == 1) return;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[0].o[i] = __fadd_rn(acc[0].o[i], part[i]);
  const Rows rw = f32e::tile_rows(wr);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = q0 + (hh ? rw.r1 : rw.r0);
    if (i < Nq)
      f32e::store_row(acc[0], rw, hh, 1.f, dq + ((long)bh * Nq + i) * D);
  }
}

template <int D>
__global__ void __launch_bounds__(DkvSmem<D>::kThreads, 1)
dkv_main(const __grid_constant__ CUtensorMap mkh,
         const __grid_constant__ CUtensorMap mkl,
         const __grid_constant__ CUtensorMap mvh,
         const __grid_constant__ CUtensorMap mvl,
         const __grid_constant__ CUtensorMap mqh,
         const __grid_constant__ CUtensorMap mql,
         const __grid_constant__ CUtensorMap mgh,
         const __grid_constant__ CUtensorMap mgl,
         const float* __restrict__ bl, const float* __restrict__ bias,
         BiasStrides bs, const float* __restrict__ lse2,
         const float* __restrict__ dvec, float* __restrict__ dk,
         float* __restrict__ dv, int H, int Nq, int Nk, int nt, int Nqp,
         int split_tiles, float sl, float scale) {
  extern __shared__ unsigned char smem_raw[];
  using SM = DkvSmem<D>;
  constexpr int R = SM::R;
  const int j0 = blockIdx.x * R, split = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int nqe = (Nq + KE - 1) / KE, per = split_tiles * (QT / KE);
  const int e0 = split * per, e1 = min(e0 + per, nqe);
  // this split's partial (or, with one split, the gradients themselves)
  const long off = ((long)split * gridDim.z + bh) * Nk * D;
  const float* kbr = bl + (long)b * nt * KE;
  const SM sm(smem_raw);
  sm.init();
  int live = 0;
  for (int c = threadIdx.x; c < R; c += blockDim.x)
    live |= (j0 + c < Nk) && kbr[j0 + c] > 0.5f * NEG;
  live = __syncthreads_or(live);
  // warp w of group w / 4: key rows j0 + 16 (w % 4) + [0, 16)
  const int w = threadIdx.x >> 5, gr = w >> 2, wr = w & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, cq = 2 * (lane & 3);
  const int key0 = j0 + 16 * wr + g;
  const float kb2[2] = {key0 < Nk ? kbr[key0] : NEG,
                        key0 + 8 < Nk ? kbr[key0 + 8] : NEG};
  const float* bhp = bias ? bias + b * bs.b + h * bs.h : nullptr;
  RowStateN<D / 2> ak[1], av[1];
  ak[0].zero();
  av[0].zero();
  if (live) {
    if (threadIdx.x == 0) {
      uint64_t* kb = sm.q_full();
      sm90::mbar_expect_tx(kb, 4 * SM::kA);
      load_plane(sm.a(0), &mkh, kb, D, R, j0, bh);
      load_plane(sm.a(1), &mkl, kb, D, R, j0, bh);
      load_plane(sm.a(2), &mvh, kb, D, R, j0, bh);
      load_plane(sm.a(3), &mvl, kb, D, R, j0, bh);
    }
    const uint32_t kh = sm90::smem_u32(sm.a(0)), kl = sm90::smem_u32(sm.a(1));
    const uint32_t vh = sm90::smem_u32(sm.a(2)), vl = sm90::smem_u32(sm.a(3));
    // the group's ring slot, and its loads
    const uint32_t qh = sm90::smem_u32(sm.b(gr, 0));
    const uint32_t ql = sm90::smem_u32(sm.b(gr, 1));
    const uint32_t gh = sm90::smem_u32(sm.b(gr, 2));
    const uint32_t gl = sm90::smem_u32(sm.b(gr, 3));
    const float* xl = reinterpret_cast<const float*>(sm.x(gr));
    uint64_t* bar = sm.full(gr);
    sm90::mbar_wait(sm.q_full(), 0);
    float s[1][16], dp[1][16];
    for (int e = e0 + gr, k = 0; e < e1; e += 2, ++k) {
      if ((threadIdx.x & 127) == 0) {   // the group's first thread
        sm90::mbar_expect_tx(bar, 4 * SM::kB + 2 * KE * 4);
        load_plane(sm.b(gr, 0), &mqh, bar, D, KE, e * KE, bh);
        load_plane(sm.b(gr, 1), &mql, bar, D, KE, e * KE, bh);
        load_plane(sm.b(gr, 2), &mgh, bar, D, KE, e * KE, bh);
        load_plane(sm.b(gr, 3), &mgl, bar, D, KE, e * KE, bh);
        const long r = (long)bh * Nqp + e * KE;
        sm90::bulk_load(sm.x(gr), lse2 + r, KE * 4, bar);
        sm90::bulk_load(sm.x(gr) + KE * 4, dvec + r, KE * 4, bar);
      }
      sm90::mbar_wait(bar, k & 1);
      qk_rn<D, R, KE, 1, 4>(s, kh, kl, 16 * wr, qh, ql);  // S^T = K Q^T
      qk<D, R, KE, 1, 4>(dp, vh, vl, 16 * wr, gh, gl);   // dP^T = V dO^T
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = Rows::col(i) + cq, hh = Rows::hi(i);
        const int key = key0 + 8 * hh, query = e * KE + c;
        const float* db = (bhp != nullptr && key < Nk && query < Nq)
                              ? bhp + query * bs.q + key * bs.k
                              : nullptr;
        s[0][i] = prob(logit(s[0][i], sl, kb2[hh], db), xl[c]);
        dp[0][i] = dscore(s[0][i], dp[0][i], xl[KE + c], scale);
      }
      pv<D, KE, 1, 4>(s, av, gh, gl);    // dV += P^T dO
      pv<D, KE, 1, 4>(dp, ak, qh, ql);   // dK += dS^T Q
      group_sync(gr);                    // the slot may be refilled
    }
  }
  // group 1's partial dK and dV through the (now idle) ring, added to
  // group 0's
  float* part =
      reinterpret_cast<float*>(sm.b(0, 0)) + (wr * 32 + lane) * D;
  __syncthreads();
  if (gr == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      part[i] = ak[0].o[i];
      part[D / 2 + i] = av[0].o[i];
    }
  }
  __syncthreads();
  if (gr == 1) return;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    ak[0].o[i] = __fadd_rn(ak[0].o[i], part[i]);
    av[0].o[i] = __fadd_rn(av[0].o[i], part[D / 2 + i]);
  }
  const Rows rw = f32e::tile_rows(wr);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j = j0 + (hh ? rw.r1 : rw.r0);
    if (j >= Nk) continue;
    f32e::store_row(ak[0], rw, hh, 1.f, dk + off + (long)j * D);
    f32e::store_row(av[0], rw, hh, 1.f, dv + off + (long)j * D);
  }
}

struct Args {
  const float *q, *k, *v, *g, *lse, *o, *bias, *kbias, *qcos, *qsin, *kcos,
      *ksin;
  const long long* s;   // q, k, v, do (batch, head, token), bias (4), o
  float *qh, *ql, *gh, *gl, *kh, *kl, *vh, *vl, *bl, *lse2, *dv2;
  int *list, *count;
  int B, H, Nq, Nk;
  float scale;
  cudaStream_t st;
};

inline int padded(int Nq) { return (Nq + QT - 1) / QT * QT; }

template <int D>
cudaError_t run_dq(const Args& a, float* dq) {
  const int nt = (a.Nk + KE - 1) / KE, Nqp = padded(a.Nq);
  const int BH = a.B * a.H;
  const long long* s = a.s;
  launch_split<D>(a.q, s, a.qcos, a.qsin, a.qh, a.ql, a.B, a.H, a.Nq, a.st);
  launch_split<D>(a.g, s + 9, nullptr, nullptr, a.gh, a.gl, a.B, a.H, a.Nq,
                  a.st);
  launch_split<D>(a.k, s + 3, a.kcos, a.ksin, a.kh, a.kl, a.B, a.H, a.Nk,
                  a.st);
  launch_split<D>(a.v, s + 6, nullptr, nullptr, a.vh, a.vl, a.B, a.H, a.Nk,
                  a.st);
  key_tiles<<<a.B, 1024, nt * sizeof(int), a.st>>>(a.kbias, a.bl, a.list,
                                                   a.count, a.Nk, nt);
  const long long rows = (long long)BH * Nqp;
  row_stats<D, float><<<blocks_for(rows * 32), 256, 0, a.st>>>(
      a.lse, a.g, Strides3{s[9], s[10], s[11]}, a.o,
      Strides3{s[16], s[17], s[18]}, a.lse2, a.dv2, a.H, a.Nq, Nqp, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  using SM = DqSmem<D>;
  CUtensorMap m[8];
  const float* planes[8] = {a.qh, a.ql, a.gh, a.gl, a.kh, a.kl, a.vh, a.vl};
  for (int i = 0; i < 8; ++i)
    if ((err = f32e::make_map(&m[i], planes[i], BH, i < 4 ? a.Nq : a.Nk, D,
                              i < 4 ? SM::R : KE)) != cudaSuccess)
      return err;
  auto kern = dq_main<D>;
  if ((err = prepare(kern, SM::kBytes)) != cudaSuccess) return err;
  const dim3 grid((a.Nq + SM::R - 1) / SM::R, a.H, a.B);
  kern<<<grid, SM::kThreads, SM::kBytes, a.st>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], a.bl, a.list, a.count,
      a.bias, BiasStrides{s[12], s[13], s[14], s[15]}, a.lse2, a.dv2, dq,
      a.H, a.Nq, a.Nk, nt, Nqp, a.scale * sm90::L2E, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_dkdv(const Args& a, float* dk, float* dv, float* part,
                     int split_tiles) {
  const int nt = (a.Nk + KE - 1) / KE, Nqp = padded(a.Nq);
  const int BH = a.B * a.H;
  const int ns = (Nqp / QT + split_tiles - 1) / split_tiles;
  const long long* s = a.s;
  using SM = DkvSmem<D>;
  CUtensorMap m[8];
  const float* planes[8] = {a.kh, a.kl, a.vh, a.vl, a.qh, a.ql, a.gh, a.gl};
  cudaError_t err;
  for (int i = 0; i < 8; ++i)
    if ((err = f32e::make_map(&m[i], planes[i], BH, i < 4 ? a.Nk : a.Nq, D,
                              i < 4 ? SM::R : KE)) != cudaSuccess)
      return err;
  auto kern = dkv_main<D>;
  if ((err = prepare(kern, SM::kBytes)) != cudaSuccess) return err;
  const long long total = (long long)BH * a.Nk * D;
  float* ok = ns > 1 ? part : dk;
  float* ov = ns > 1 ? part + ns * total : dv;
  const dim3 grid((a.Nk + SM::R - 1) / SM::R, ns, BH);
  kern<<<grid, SM::kThreads, SM::kBytes, a.st>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], a.bl, a.bias,
      BiasStrides{s[12], s[13], s[14], s[15]}, a.lse2, a.dv2, ok, ov, a.H,
      a.Nq, a.Nk, nt, Nqp, split_tiles, a.scale * sm90::L2E, a.scale);
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
  auto m = [](void* p) { return static_cast<float*>(p); };
  return Args{f(q), f(k), f(v), f(g), f(lse), f(o), f(bias), f(kbias),
              f(qcos), f(qsin), f(kcos), f(ksin), strides,
              m(work[0]), m(work[1]), m(work[2]), m(work[3]), m(work[4]),
              m(work[5]), m(work[6]), m(work[7]), m(work[8]), m(work[9]),
              m(work[10]), static_cast<int*>(work[11]),
              static_cast<int*>(work[12]), B, H, Nq, Nk, scale,
              static_cast<cudaStream_t>(stream)};
}

bool bad_shape(int B, int H, int Nq, int Nk, const void* qcos,
               const void* kcos) {
  const int nt = (Nk + KE - 1) / KE;
  return B < 1 || H < 1 || Nq < 1 || Nk < 1 || nt * 4L > 48 * 1024 ||
         (qcos == nullptr) != (kcos == nullptr);
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

// f32 q (B, H, Nq, D), k/v (B, H, Nk, D), do and K4's output o (B, H, Nq, D)
// through the element strides in strides[0..11] (q, k, v, do: batch, head,
// token) and strides[16..18] (o); lse (B, H, Nq) f32; bias: dense f32 bias
// through strides[12..15] (batch, head, query, key) or null; kbias (B, Nk) f32
// or null; tables (B, N, D) f32, all four or none. ``work``: 13 scratch buffers
// from the caller, with nt = ceil(Nk / 32) and Nqp = Nq rounded up to 64: q hi,
// q lo, do hi, do lo (B, H, Nq, D) f32; k hi, k lo, v hi, v lo (B, H, Nk, D)
// f32; key biases (B, nt * 32) f32; LSE and Dvec rows (B, H, Nqp) f32; live
// tiles (B, nt) and counts (B) int32.  This call runs the pre-pass (filling
// ``work``) and writes dq (B, H, Nq, D) f32.  Built for D = 64 and 96.
extern "C" int p3_flash_bwd_dq_sm90(P3_BWD_ARGS, void* dq, void* stream) {
  if (bad_shape(B, H, Nq, Nk, qcos, kcos)) return cudaErrorInvalidValue;
  const Args a = P3_BWD_MAKE;
  float* out = static_cast<float*>(dq);
  if (D == 64) return run_dq<64>(a, out);
  if (D == 96) return run_dq<96>(a, out);
  return cudaErrorInvalidValue;
}

// As p3_flash_bwd_dq_sm90, after it on the same stream and with the same
// ``work``: dk and dv (B, H, Nk, D) f32.  The queries are walked in S =
// ceil(ceil(Nq / 64) / split_tiles) fixed splits; with S > 1 ``part`` is f32
// scratch of 2 * S * B * H * Nk * D (else null).
extern "C" int p3_flash_bwd_dkdv_sm90(P3_BWD_ARGS, void* dk, void* dv,
                                      void* part, int split_tiles,
                                      void* stream) {
  if (bad_shape(B, H, Nq, Nk, qcos, kcos) || split_tiles < 1)
    return cudaErrorInvalidValue;
  const int ns = ((Nq + QT - 1) / QT + split_tiles - 1) / split_tiles;
  if ((ns > 1) != (part != nullptr)) return cudaErrorInvalidValue;
  const Args a = P3_BWD_MAKE;
  float* ok = static_cast<float*>(dk);
  float* ov = static_cast<float*>(dv);
  float* op = static_cast<float*>(part);
  if (D == 64) return run_dkdv<64>(a, ok, ov, op, split_tiles);
  if (D == 96) return run_dkdv<96>(a, ok, ov, op, split_tiles);
  return cudaErrorInvalidValue;
}
