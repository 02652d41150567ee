// K4, f32 — generic flash attention forward on the Hopper f32 engine
// (attn_f32_sm90.cuh, 3xTF32; the shared pieces in flash_sm90.cuh).  The
// bf16 K4 is flash_fwd_bf16_sm90.cu (the bf16 Hopper engine).  The same
// main kernel also serves the f32 K1 (p3_tower_self_f32_sm90, below) and,
// through p3_flash_fwd_sm90, the f32 K6 (ops/packed_attention.py).
//
// Replaces panst3r_tpu/ops/pallas/flash_attention.py::_flash_fwd (body
// _kernel) in f32: online-softmax attention over (B, H, N, D) streams, D =
// 64 or 96, with, each optional, a dense additive bias read through its
// strides, a per-key bias row (B, Nk) (the (B|1, 1, 1, Nk) bias and the key
// validity folded into it by the wrapper: 0 / finfo.min), 2D-RoPE tables
// (B, N, D) shared by the heads, and the natural-log LSE per row.  The
// scale multiplies the f32 score and the biases are added after it; the
// row sum takes the f32 p; a row with no live key writes 0 and the LSE
// finfo.min.  q, k, v and out are read and written through (batch, head,
// token) strides with a unit stride over D.
//
// Bound on the H100: at the v2 LoftUp shape (B=4, H=4, Nq=49152, Nk=768,
// D=96) the work is 4 B H Nq Nk D = 232 GFLOP against ~0.6 GB of q and out:
// bound by operations, 1.41 ms at the 494.7 / 3 TFLOP/s of 3xTF32 products
// (3.46 ms at the 67 TFLOP/s of f32 FMA).  The f32 K1 at the encoder's
// shape (B=4, 16 heads, N=768, D=64) is 9.7 GFLOP against ~25 MB: 0.059
// ms by operations at the 3xTF32 rate.
//
// Design.  (1) Pre-pass: k rotated by its tables (when given) and k and v
// written as TF32 hi/lo planes (B*H, Nk, D), so that the main loop splits
// no K or V value; q rotated into a contiguous copy only when there are
// tables; the key bias in log2 units padded to 32-key tiles, and per
// batch the list of live tiles.  (2) The main kernel: 128-row CTAs (64-row
// at D = 64, two per SM) of eight warps in two groups (below); one thread
// loads the Q tile once
// through a 4-D tensor map over q's strides, each group's first thread
// the live 32-key entries (four planes and their key biases) into the
// group's ring slot by TMA.  Q is split once per CTA into shared memory
// (split_q); S (each 8-lane step's hi.hi product added in f32
// round-to-nearest: qk_rn) and O stay in registers; P is fed back as the
// A operand of P V without a shuffle (flash_sm90.cuh, pv); O is summed
// per 8 keys in a fresh accumulator and added in f32 round-to-nearest.
// 768 query tiles per (batch, head) at LoftUp fill the card, so there is
// no split-KV.  A row's arithmetic depends only on its own q, its batch's
// k, v and biases and Nk: never on B, Nq or the grid.
#include "flash_sm90.cuh"

using namespace p3;
using namespace p3::flash32;

namespace {

// Eight warps and no producer warp, in two groups of four over the same
// 64 MT rows (each warp MT m16 row tiles; with MT = 2 each K and V
// fragment serves two products), so that each SM sub-partition has two
// warps to hide the latency of the other's products.  Group g owns ring
// slot g (K hi, K lo, V hi, V lo and the entry's key biases) and takes the
// batch's live entries g, g + 2, ..., its first thread issuing each
// entry's loads once the group has released the slot; the groups' softmax
// states are merged in group order at the end.  MT = 2 (128 rows) holds
// one CTA per SM; MT = 1 (64 rows, at D = 64) two, each thread within 128
// registers, so four warps per sub-partition.  A row's arithmetic is the
// same for either.
template <int D, int MT>
using FwdSmem = flash32::Smem<D, 8, MT, 2, 4, 2, KE * 4, 2>;

template <int D, int MT>
__global__ void __launch_bounds__(FwdSmem<D, MT>::kThreads, 3 - MT)
fwd_main(const __grid_constant__ CUtensorMap mq,
         const __grid_constant__ CUtensorMap mkh,
         const __grid_constant__ CUtensorMap mkl,
         const __grid_constant__ CUtensorMap mvh,
         const __grid_constant__ CUtensorMap mvl, const Perm pq,
         const float* __restrict__ bl, const int* __restrict__ list,
         const int* __restrict__ count, const float* __restrict__ bias,
         BiasStrides bs, float* __restrict__ out, Strides3 os,
         float* __restrict__ lse, int H, int Nq, int Nk, int nt, float sl) {
  extern __shared__ unsigned char smem_raw[];
  using SM = FwdSmem<D, MT>;
  constexpr int R = SM::R, NO = D / 2;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * R;
  const int bh = b * H + h;
  const int n = count[b];
  const int* tiles = list + b * nt;
  const SM sm(smem_raw);
  sm.init();
  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(sm.q_full(), SM::kA);
    for (int j = 0; j < D / 32; ++j)
      sm90::tma_load_4d(sm.q() + j * R * 128, &mq, sm.q_full(), 32 * j,
                        pick(0, pq, q0, h, b), pick(1, pq, q0, h, b),
                        pick(2, pq, q0, h, b));
  }
  // warp w of group w / 4: query rows q0 + 32 (w % 4) + [0, 32), two row
  // tiles; group 0 splits them, once
  const int w = threadIdx.x >> 5, gr = w >> 2, wr = w & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, cq = 2 * (lane & 3);
  sm90::mbar_wait(sm.q_full(), 0);
  if (gr == 0) f32e::split_q(sm, wr);
  __syncthreads();
  const float* bhp = bias ? bias + b * bs.b + h * bs.h : nullptr;
  RowStateN<NO> st[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) st[mt].zero();
  const uint32_t qh = sm90::smem_u32(sm.a(0)), ql = sm90::smem_u32(sm.a(1));
  // the group's ring slot, and its loads
  const uint32_t kh = sm90::smem_u32(sm.b(gr, 0));
  const uint32_t kl = sm90::smem_u32(sm.b(gr, 1));
  const uint32_t vh = sm90::smem_u32(sm.b(gr, 2));
  const uint32_t vl = sm90::smem_u32(sm.b(gr, 3));
  const float* kb = reinterpret_cast<const float*>(sm.x(gr));
  uint64_t* bar = sm.full(gr);
  float s[MT][16], alpha[2];
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
    qk_rn<D, R, KE, MT, 4>(s, qh, ql, 16 * MT * wr, kh, kl);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int row0 = q0 + 16 * (MT * wr + mt) + g;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = Rows::col(i) + cq;
        const int row = row0 + 8 * Rows::hi(i), key = key0 + c;
        const float* db = (bhp != nullptr && row < Nq && key < Nk)
                              ? bhp + row * bs.q + key * bs.k
                              : nullptr;
        s[mt][i] = logit(s[mt][i], sl, kb[c], db);
      }
      f32e::softmax_step(st[mt], s[mt], alpha);
      sm90::rescale(st[mt], alpha);
    }
    pv<D, KE, MT, 4>(s, st, vh, vl);
    group_sync(gr);                    // the slot may be refilled
  }
  // group 1's state (O, m, l of each row tile) through the (now idle)
  // ring, merged into group 0's: w_g = exp2(m_g - max m), 0 for a group
  // that saw no live key
  float* part = reinterpret_cast<float*>(sm.b(0, 0)) +
                (wr * 32 + lane) * MT * (NO + 4);
  __syncthreads();
  if (gr == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float* pm = part + mt * (NO + 4);
#pragma unroll
      for (int i = 0; i < NO; ++i) pm[i] = st[mt].o[i];
      pm[NO] = st[mt].m[0];
      pm[NO + 1] = st[mt].m[1];
      pm[NO + 2] = st[mt].l[0];
      pm[NO + 3] = st[mt].l[1];
    }
  }
  __syncthreads();
  if (gr == 1) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float* pm = part + mt * (NO + 4);
    float w0[2], w1[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m0 = st[mt].m[hh], m1 = pm[NO + hh];
      const float mx = fmaxf(m0, m1);
      const float safe = (mx <= 0.5f * NEG) ? 0.f : mx;
      w0[hh] = (m0 <= 0.5f * NEG) ? 0.f : sm90::exp2_approx(m0 - safe);
      w1[hh] = (m1 <= 0.5f * NEG) ? 0.f : sm90::exp2_approx(m1 - safe);
      st[mt].m[hh] = mx;
      st[mt].l[hh] = __fadd_rn(__fmul_rn(st[mt].l[hh], w0[hh]),
                               __fmul_rn(pm[NO + 2 + hh], w1[hh]));
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int hh = Rows::hi(i);
      st[mt].o[i] = __fadd_rn(__fmul_rn(st[mt].o[i], w0[hh]),
                              __fmul_rn(pm[i], w1[hh]));
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const Rows rw = f32e::tile_rows(MT * wr + mt);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = q0 + (hh ? rw.r1 : rw.r0);
      if (i >= Nq) continue;
      const float l = st[mt].l[hh], m = st[mt].m[hh];
      f32e::store_row(st[mt], rw, hh, 1.f / (l == 0.f ? 1.f : l),
                      out + b * os.b + h * os.h + i * os.n);
      if (lse != nullptr && (lane & 3) == 0)
        lse[(long)bh * Nq + i] =
            (m <= 0.5f * NEG) ? NEG : (m + log2f(l)) * LN2;
    }
  }
}

struct Args {
  const float *q, *k, *v, *bias, *kbias, *qcos, *qsin, *kcos, *ksin;
  float *out, *lse, *qr, *kh, *kl, *vh, *vl, *bl;
  int *list, *count;
  const long long* s;  // q, k, v, out (batch, head, token), bias (4)
  int B, H, Nq, Nk;
  float scale;
  cudaStream_t st;
  // the f32 K1's cls key and value (B, H, 1, D) through the (batch, head)
  // strides ``cs``: the planes' last key row, Nk = N + 1
  const float* kc = nullptr;
  const float* vc = nullptr;
  const long long* cs = nullptr;
};

template <int D, int MT>
cudaError_t run_main(const Args& a, const float* q, const long long* qs,
                     int nt);

template <int D>
cudaError_t run(const Args& a) {
  const int nt = (a.Nk + KE - 1) / KE;
  const long long* s = a.s;
  // (1) pre-pass: k (rotated) and v as hi/lo planes (the cls row last),
  // q rotated with tables, the key biases and live tiles
  const int Nx = a.Nk - (a.kc != nullptr);   // keys read from k and v
  launch_split<D>(a.k, s + 3, a.kcos, a.ksin, a.kh, a.kl, a.B, a.H, Nx,
                  a.st, a.kc, a.cs);
  launch_split<D>(a.v, s + 6, nullptr, nullptr, a.vh, a.vl, a.B, a.H, Nx,
                  a.st, a.vc, a.cs);
  const float* q = a.q;
  long long qs[3] = {s[0], s[1], s[2]};
  if (a.qcos != nullptr) {
    launch_split<D>(a.q, s, a.qcos, a.qsin, a.qr, nullptr, a.B, a.H, a.Nq,
                    a.st);
    q = a.qr;
    qs[0] = (long long)a.H * a.Nq * D;
    qs[1] = (long long)a.Nq * D;
    qs[2] = D;
  }
  key_tiles<<<a.B, 1024, nt * sizeof(int), a.st>>>(a.kbias, a.bl, a.list,
                                                   a.count, a.Nk, nt);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // (2) the main kernel: 64-row CTAs at D = 64 (two per SM), else 128
  if constexpr (D == 64)
    return run_main<D, 1>(a, q, qs, nt);
  else
    return run_main<D, 2>(a, q, qs, nt);
}

template <int D, int MT>
cudaError_t run_main(const Args& a, const float* q, const long long* qs,
                     int nt) {
  using SM = FwdSmem<D, MT>;
  const long long* s = a.s;
  cudaError_t err;
  CUtensorMap mq, mkh, mkl, mvh, mvl;
  Perm pq;
  const int BH = a.B * a.H;
  if ((err = sm90::make_map4(&mq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, q, a.B,
                             a.H, a.Nq, D, qs[0], qs[1], qs[2], 32, SM::R,
                             CU_TENSOR_MAP_SWIZZLE_128B, &pq)) !=
          cudaSuccess ||
      (err = f32e::make_map(&mkh, a.kh, BH, a.Nk, D, KE)) != cudaSuccess ||
      (err = f32e::make_map(&mkl, a.kl, BH, a.Nk, D, KE)) != cudaSuccess ||
      (err = f32e::make_map(&mvh, a.vh, BH, a.Nk, D, KE)) != cudaSuccess ||
      (err = f32e::make_map(&mvl, a.vl, BH, a.Nk, D, KE)) != cudaSuccess)
    return err;
  auto kern = fwd_main<D, MT>;
  if ((err = prepare(kern, SM::kBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(
           kern, cudaFuncAttributePreferredSharedMemoryCarveout,
           cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
    return err;
  const dim3 grid((a.Nq + SM::R - 1) / SM::R, a.H, a.B);
  kern<<<grid, SM::kThreads, SM::kBytes, a.st>>>(
      mq, mkh, mkl, mvh, mvl, pq, a.bl, a.list, a.count, a.bias,
      BiasStrides{s[12], s[13], s[14], s[15]}, a.out,
      Strides3{s[9], s[10], s[11]}, a.lse, a.H, a.Nq, a.Nk, nt,
      a.scale * sm90::L2E);
  return cudaGetLastError();
}

}  // namespace

P3_ERROR_STRING_FN

// f32 q (B, H, Nq, D), k/v (B, H, Nk, D) and out (B, H, Nq, D) through
// the element strides in strides[0..11] (q, k, v, out: batch, head,
// token; q's multiples of 4 with a 16-byte aligned base: a tensor map
// reads it); bias: dense f32 bias through strides[12..15] (batch, head,
// query, key) or null; kbias (B, Nk) f32 or null; tables (B, N, D) f32,
// all four or none; lse (B, H, Nq) f32 or null.  Scratch from the caller,
// with nt = ceil(Nk / 32): qr (B, H, Nq, D) f32 with tables, else null;
// kh, kl, vh, vl (B, H, Nk, D) f32; bl (B, nt * 32) f32; list (B, nt) and
// count (B) int32.  Built for D = 64 and 96.
extern "C" int p3_flash_fwd_sm90(
    const void* q, const void* k, const void* v, const void* bias,
    const void* kbias, const void* qcos, const void* qsin, const void* kcos,
    const void* ksin, void* out, void* lse, const long long* strides,
    int B, int H, int Nq, int Nk, int D, float scale, void* qr, void* kh,
    void* kl, void* vh, void* vl, void* bl, void* list, void* count,
    void* stream) {
  const int nt = (Nk + KE - 1) / KE;
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || nt * 4L > 48 * 1024 ||
      (qcos != nullptr) != (qr != nullptr))
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  const Args a{f(q),   f(k),   f(v),    f(bias), f(kbias), f(qcos),
               f(qsin), f(kcos), f(ksin), m(out),  m(lse),   m(qr),
               m(kh),  m(kl),  m(vh),   m(vl),   m(bl),
               static_cast<int*>(list), static_cast<int*>(count), strides,
               B, H, Nq, Nk, scale, static_cast<cudaStream_t>(stream)};
  if (D == 64) return run<64>(a);
  if (D == 96) return run<96>(a);
  return cudaErrorInvalidValue;
}

// The f32 K1: tower self-attention, replacing
// panst3r_tpu/ops/pallas/tower_attention.py::_tower_fwd (body _kernel) in
// f32, on the main kernel above at D = 64.  q, k, v (B, H, N, 64) and out
// (B, H, N, 64) through the element strides in strides[0..11] (q, k, v,
// out: batch, head, token; ops/tower_attention.py::self_views: the fused
// (B, N, 3C) projection and out (B, N, C), so no relayout on either side);
// optional f32 RoPE tables cos, sin (B, N, 64) for q and k; an optional
// cls key and value kc, vc (B, H, 1, 64) through the (batch, head) strides
// strides[12..13] (DINO split-cls), which join every row's softmax as one
// more key after the N tokens, unrotated: the pre-pass writes them as the
// planes' last row, and the main loop walks Nk = N + 1 keys.  No bias and
// no LSE.  Scratch as p3_flash_fwd_sm90's, with Nk = N + (kc != null).
extern "C" int p3_tower_self_f32_sm90(
    const void* q, const void* k, const void* v, const void* kc,
    const void* vc, const void* cos, const void* sin, void* out,
    const long long* strides, int B, int H, int N, float scale, void* qr,
    void* kh, void* kl, void* vh, void* vl, void* bl, void* list,
    void* count, void* stream) {
  const int Nk = N + (kc != nullptr);
  const int nt = (Nk + KE - 1) / KE;
  if (B < 1 || H < 1 || N < 1 || nt * 4L > 48 * 1024 ||
      (kc != nullptr) != (vc != nullptr) ||
      (cos != nullptr) != (sin != nullptr) ||
      (cos != nullptr) != (qr != nullptr))
    return cudaErrorInvalidValue;
  long long s[16] = {0};
  for (int i = 0; i < 12; ++i) s[i] = strides[i];
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  Args a{f(q),    f(k),    f(v),   nullptr, nullptr, f(cos), f(sin),
         f(cos),  f(sin),  m(out), nullptr, m(qr),   m(kh),  m(kl),
         m(vh),   m(vl),   m(bl),  static_cast<int*>(list),
         static_cast<int*>(count), s, B, H, N, Nk, scale,
         static_cast<cudaStream_t>(stream)};
  a.kc = f(kc);
  a.vc = f(vc);
  a.cs = strides + 12;
  return run<64>(a);
}
