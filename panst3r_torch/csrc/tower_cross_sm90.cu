// K2, bf16 and f32 — memory cross-attention on the Hopper engines
// (attn_sm90.cuh for bf16, attn_f32_sm90.cuh for f32).
//
// Replaces panst3r_tpu/ops/pallas/tower_attention.py::_cross_fwd (body
// _cross_kernel), bf16 and f32 branches: per d=64 head, q and k rotated by
// their own 2D-RoPE (cos, sin) tables in f32, q scaled after the rotation
// and rounded to its dtype once (a no-op in f32), a per-key additive bias
// (B, Nk) f32 (the memory validity), key tiles whose bias is all <=
// finfo.min/2 skipped (no loads, no products), rows with no live key
// written as 0.  The int8 branch is tower_cross_int8_sm90.cu.
//
// Bound on the H100: 4*Nq*Nk_live*C operations against the bytes of q, the
// live k and v, the out and the tables.  At the render (3072 x 3072) 29
// GFLOP against ~19 MB (bf16) and at the long render (38400 x 12288) 1.45
// TFLOP against ~190 MB: bound by operations (0.029 and 1.465 ms at 989
// TFLOP/s).  The memory-build update (B=1, Nq=768 against Nk=13056, 96
// live tiles of 102, 12288 live keys) is 29 GFLOP over ~47 MB: 0.029 ms by
// operations, but its grid holds 72 CTAs of 128 rows for 132 SMs.  In f32
// the same work is bound by the 3xTF32 products: 29 GFLOP at 494.7 / 3
// TFLOP/s is 0.18 ms (0.43 ms at 67 TFLOP/s of f32 FMA).
//
// Design.  (1) Rotate once per call: cross_rotate writes q~ = bf16(scale *
// rope(q)) and k~ = bf16(rope(k)) to scratch shaped like the inputs (the
// same values the old engine built per query block; cross_rotate_f32 the
// same in f32); cross_tiles writes the key bias in log2 units padded to
// whole tiles (NEG past Nk) and, per batch, the list of live key tiles and
// their count (attn_sm90.cuh, shared with K2-int8 and K4).  (2) The main
// kernel walks a row's live tiles through the TMA ring, with the softmax
// in registers: bf16 with wgmma products
// (cross_main), f32 with 3xTF32 mma.sync products (cross_main_f32: 128-row
// CTAs of four consumer warps of 32 rows, each live 128-key tile as two
// 64-key ring entries, the last tile's second half skipped where it lies
// past Nk).
// (3) Split-KV: a batch's live tiles are cut into splits of
// ``split_tiles`` tiles (a fixed number, the caller's constant:
// ops/tower_attention.py::SPLIT_TILES), one CTA per split; with more than
// one split each writes its unnormalised O, m and l in f32 and
// cross_combine merges the splits in a fixed order (no atomics).  A row's
// arithmetic depends only on its batch's k, v and bias, Nk and the
// constants here: never on B, Nq, the grid or the SM count (the number of
// consumer warpgroups per CTA changes no row's arithmetic).
#include <algorithm>

#include "attn_f32_sm90.cuh"

using namespace p3;
using namespace p3::sm90;

typedef __nv_bfloat16 bf16;

// q~ = bf16(scale * rope(q)) (scale * q without tables), then, when ``ks``
// is given, k~ = bf16(rope(k)): one thread per 8 lanes of a row.
__global__ void cross_rotate(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const float* __restrict__ qcos,
                             const float* __restrict__ qsin,
                             const float* __restrict__ kcos,
                             const float* __restrict__ ksin,
                             bf16* __restrict__ qs, bf16* __restrict__ ks,
                             int nq_rows, int nk_rows, int C, float scale) {
  const int per_row = C / 8;
  const int nq = nq_rows * per_row, nk = ks ? nk_rows * per_row : 0;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < nq + nk;
       e += gridDim.x * blockDim.x) {
    const bool isq = e < nq;
    const int f = isq ? e : e - nq;
    const long row = f / per_row;
    const int c = (f % per_row) * 8, d0 = c & 63;
    const long at = row * C + (c - d0);
    const float* cs = isq ? qcos : kcos;
    const float* sn = isq ? qsin : ksin;
    rope8((isq ? q : k) + at, cs ? cs + row * 64 : nullptr,
          sn ? sn + row * 64 : nullptr, d0, isq ? scale : 1.f,
          (isq ? qs : ks) + at + d0);
  }
}

// f32: q~ = scale * rope(q) (scale * q without tables), then, when ``ks``
// is given, k~ = rope(k): one thread per 4 lanes of a row, rotated as
// rope8 does (lane d's partner is d ^ 16).
__global__ void cross_rotate_f32(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ qcos,
                                 const float* __restrict__ qsin,
                                 const float* __restrict__ kcos,
                                 const float* __restrict__ ksin,
                                 float* __restrict__ qs,
                                 float* __restrict__ ks, int nq_rows,
                                 int nk_rows, int C, float scale) {
  const int per_row = C / 4;
  const int nq = nq_rows * per_row, nk = ks ? nk_rows * per_row : 0;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < nq + nk;
       e += gridDim.x * blockDim.x) {
    const bool isq = e < nq;
    const int f = isq ? e : e - nq;
    const long row = f / per_row;
    const int c = (f % per_row) * 4, d0 = c & 63;
    const float* head = (isq ? q : k) + row * C + (c - d0);
    const float* cs = isq ? qcos : kcos;
    const float* sn = isq ? qsin : ksin;
    const float mul = isq ? scale : 1.f;
    const float4 x = *reinterpret_cast<const float4*>(head + d0);
    float4 o;
    if (cs == nullptr) {
      o = make_float4(mul * x.x, mul * x.y, mul * x.z, mul * x.w);
    } else {
      const float4 p = *reinterpret_cast<const float4*>(head + (d0 ^ 16));
      const float4 c4 = *reinterpret_cast<const float4*>(cs + row * 64 + d0);
      const float4 s4 = *reinterpret_cast<const float4*>(sn + row * 64 + d0);
      const float sg = (d0 & 16) ? 1.f : -1.f;
      o = make_float4(mul * (x.x * c4.x + sg * p.x * s4.x),
                      mul * (x.y * c4.y + sg * p.y * s4.y),
                      mul * (x.z * c4.z + sg * p.z * s4.z),
                      mul * (x.w * c4.w + sg * p.w * s4.w));
    }
    *reinterpret_cast<float4*>((isq ? qs : ks) + row * C + c) = o;
  }
}

__host__ __device__ __forceinline__ int n_splits(int live, int split_tiles) {
  return live > split_tiles ? (live + split_tiles - 1) / split_tiles : 1;
}

// grid (ceil(Nq / (64 NWG)), heads, B * max_splits).  With one split the
// CTA writes bf16 rows of ``out``; with more it writes O (f32, split-major
// (S, B, Nq, C)) and (m, l) ((S, B, H, Nq, 2)) for cross_combine.
template <int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, Regs<NWG>::kMinBlocks)
cross_main(const __grid_constant__ CUtensorMap mq,
           const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv,
           const float* __restrict__ bl, const int* __restrict__ list,
           const int* __restrict__ count, bf16* __restrict__ out,
           float* __restrict__ opart, float* __restrict__ ml, int B, int Nq,
           int C, int nt, int split_tiles, int max_splits) {
  extern __shared__ unsigned char smem_raw[];
  const int h = blockIdx.y, b = blockIdx.z / max_splits;
  const int split = blockIdx.z % max_splits;
  const int q0 = blockIdx.x * NWG * BQW;
  const int live = count[b];
  const int ns = n_splits(live, split_tiles);
  if (split >= ns) return;
  const int first = split * split_tiles;
  const int n = max(0, min(split_tiles, live - first));
  const int* tiles = list + b * nt + first;
  const Smem<NWG> sm(smem_raw);
  init_barriers(sm);
  const int wg = threadIdx.x / 128;

  if (wg == NWG) {  // producer warpgroup
    regs_dec<Regs<NWG>::kProducer>();
    if (threadIdx.x == NWG * 128) {
      produce(
          sm, n, 2 * kKVBytes + kBiasBytes,
          [&](int g, void* dst, uint64_t* bar) {
            tma_load_3d(dst, &mq, bar, h * D, q0 + g * BQW, b);
          },
          [&](int i) { return tiles[i]; },
          [&](int t, void* kd, void* vd, float* bd, uint64_t* bar) {
            tma_load_3d(kd, &mk, bar, h * D, t * BKT, b);
            tma_load_3d(vd, &mv, bar, h * D, t * BKT, b);
            bulk_load(bd, bl + ((long)b * nt + t) * BKT, kBiasBytes, bar);
          });
    }
  } else {  // consumer warpgroup wg: query rows q0 + 64 wg + [0, 64)
    regs_inc<Regs<NWG>::kConsumer>();
    const Rows rw;
    RowState st;
    st.zero();
    mbar_wait(sm.q_full(), 0);
    consume(sm, wg, n, st, rw, [&](float raw, int c, int, int stage) {
      return fmaf(raw, L2E, sm.bias(stage)[c]);
    });
    const int row0 = q0 + wg * BQW;
    if (ns == 1) {
      store_normalized(st, rw, [&](int r) -> bf16* {
        const int i = row0 + r;
        return i < Nq ? out + ((long)b * Nq + i) * C + h * D : nullptr;
      });
    } else {
      const int H = C / D;
      const bool lead = (threadIdx.x & 3) == 0;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = row0 + (hh ? rw.r1 : rw.r0);
        if (i >= Nq) continue;
        float* orow = opart + (((long)split * B + b) * Nq + i) * C + h * D;
#pragma unroll
        for (int j = 0; j < 32; j += 2) {
          if (Rows::hi(j) != hh) continue;
          *reinterpret_cast<float2*>(orow + Rows::col(j) + rw.cq) =
              make_float2(st.o[j], st.o[j + 1]);
        }
        if (lead) {
          float* mrow =
              ml + ((((long)split * B + b) * H + h) * Nq + i) * 2;
          mrow[0] = st.m[hh];
          mrow[1] = st.l[hh];
        }
      }
    }
  }
}

// f32: grid (ceil(Nq / 128), heads, B * max_splits), four consumer warps
// of 32 rows (two m16 tiles, so that each K and V value a warp splits
// serves two products) and a producer warp; the split's live tiles as
// 64-key entries.  With one split the CTA writes f32 rows of ``out``; with
// more, O and (m, l) as cross_main does.
using F32Smem = f32e::Smem<D, 4, 4, 64 * 4, 2>;  // ring extra: 64 key biases

__global__ void __launch_bounds__(F32Smem::kThreads, 1)
cross_main_f32(const __grid_constant__ CUtensorMap mq,
               const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv,
               const float* __restrict__ bl, const int* __restrict__ list,
               const int* __restrict__ count, float* __restrict__ out,
               float* __restrict__ opart, float* __restrict__ ml, int B,
               int Nq, int Nk, int C, int nt, int split_tiles,
               int max_splits) {
  extern __shared__ unsigned char smem_raw[];
  using SM = F32Smem;
  const int h = blockIdx.y, b = blockIdx.z / max_splits;
  const int split = blockIdx.z % max_splits;
  const int q0 = blockIdx.x * SM::R;
  const int live = count[b];
  const int ns = n_splits(live, split_tiles);
  if (split >= ns) return;
  const int first = split * split_tiles;
  const int n = max(0, min(split_tiles, live - first));
  const int* tiles = list + b * nt + first;
  // two 64-key entries per tile, one for a last tile that ends by key 64
  const int ne = 2 * n - (n > 0 && tiles[n - 1] * BKT + f32e::KT >= Nk);
  const SM sm(smem_raw);
  sm.init();
  const int w = threadIdx.x >> 5;

  if (w == SM::kNW) {  // producer warp
    if (threadIdx.x == SM::kNW * 32) {
      f32e::produce(
          sm, ne, 2 * SM::kKVBytes + f32e::KT * 4,
          [&](unsigned char* dst, uint64_t* bar) {
            for (int j = 0; j < 2; ++j)
              tma_load_3d(dst + j * SM::R * 128, &mq, bar, h * D + 32 * j, q0,
                          b);
          },
          [&](int e, unsigned char* kd, unsigned char* vd, unsigned char* xd,
              uint64_t* bar) {
            const int key0 = tiles[e >> 1] * BKT + (e & 1) * f32e::KT;
            for (int j = 0; j < 2; ++j) {
              tma_load_3d(kd + j * f32e::KT * 128, &mk, bar, h * D + 32 * j,
                          key0, b);
              tma_load_3d(vd + j * f32e::KT * 128, &mv, bar, h * D + 32 * j,
                          key0, b);
            }
            bulk_load(xd, bl + (long)b * nt * BKT + key0, f32e::KT * 4, bar);
          });
    }
    return;
  }
  // consumer warp w: query rows q0 + 32 w + [0, 32)
  constexpr int MT = SM::kMT;
  mbar_wait(sm.q_full(), 0);
  f32e::split_q(sm, w);
  const int cq = Rows().cq;
  RowState st[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) st[mt].zero();
  f32e::consume(sm, w, ne, st, [&](float (&s)[32], int, int, int slot) {
    const float* kb = reinterpret_cast<const float*>(sm.x(slot));
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = fmaf(s[i], L2E, kb[Rows::col(i) + cq]);
  });
  const int H = C / D;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const Rows rw = f32e::tile_rows(MT * w + mt);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = q0 + (hh ? rw.r1 : rw.r0);
      if (i >= Nq) continue;
      if (ns == 1) {
        const float l = st[mt].l[hh];
        f32e::store_row(st[mt], rw, hh, 1.f / (l == 0.f ? 1.f : l),
                        out + ((long)b * Nq + i) * C + h * D);
        continue;
      }
      f32e::store_row(st[mt], rw, hh, 1.f,
                      opart + (((long)split * B + b) * Nq + i) * C + h * D);
      if ((threadIdx.x & 3) == 0) {
        float* mrow = ml + ((((long)split * B + b) * H + h) * Nq + i) * 2;
        mrow[0] = st[mt].m[hh];
        mrow[1] = st[mt].l[hh];
      }
    }
  }
}

// Merges the splits of rows whose batch has more than one, in split order:
// out = sum_s w_s O_s / sum_s w_s l_s, w_s = exp2(m_s - max_s m_s), with the
// max replaced by 0 and w_s by 0 for splits that saw no live key.
template <typename T>
__global__ void cross_combine(const float* __restrict__ opart,
                              const float* __restrict__ ml,
                              const int* __restrict__ count,
                              T* __restrict__ out, int B, int Nq, int C,
                              int split_tiles) {
  const int H = C / D;
  const long total = (long)B * Nq * C;
  for (long e = blockIdx.x * (long)blockDim.x + threadIdx.x; e < total;
       e += (long)gridDim.x * blockDim.x) {
    const int b = static_cast<int>(e / ((long)Nq * C));
    const int ns = n_splits(count[b], split_tiles);
    if (ns == 1) continue;
    const int i = static_cast<int>((e / C) % Nq), c = static_cast<int>(e % C);
    const int h = c / D;
    float mx = NEG;
    for (int s = 0; s < ns; ++s)
      mx = fmaxf(mx, ml[((((long)s * B + b) * H + h) * Nq + i) * 2]);
    const float safe = (mx <= 0.5f * NEG) ? 0.f : mx;
    float num = 0.f, den = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float* mrow = ml + ((((long)s * B + b) * H + h) * Nq + i) * 2;
      const float w = (mrow[0] <= 0.5f * NEG) ? 0.f : exp2f(mrow[0] - safe);
      num += w * opart[(((long)s * B + b) * Nq + i) * C + c];
      den += w * mrow[1];
    }
    out[e] = from_f<T>(num / (den == 0.f ? 1.f : den));
  }
}

template <int NWG>
static cudaError_t launch_main(const CUtensorMap& mq, const CUtensorMap& mk,
                               const CUtensorMap& mv, const float* bl,
                               const int* list, const int* count, bf16* out,
                               float* opart, float* ml, int B, int Nq, int C,
                               int nt, int split_tiles, int max_splits,
                               cudaStream_t stream) {
  auto kern = cross_main<NWG>;
  const int bytes = Smem<NWG>::kBytes;
  cudaError_t err = prepare(kern, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + NWG * BQW - 1) / (NWG * BQW), C / D, B * max_splits);
  kern<<<grid, (NWG + 1) * 128, bytes, stream>>>(mq, mk, mv, bl, list, count,
                                                 out, opart, ml, B, Nq, C, nt,
                                                 split_tiles, max_splits);
  return cudaGetLastError();
}

// f32: the main kernel on the f32 engine, then the merge.
static cudaError_t launch_main_f32(const void* qs, const void* k,
                                   const void* v, const float* bl,
                                   const int* list, const int* count,
                                   float* out, float* opart, float* ml, int B,
                                   int Nq, int Nk, int C, int nt,
                                   int split_tiles, int max_splits,
                                   cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = f32e::make_map(&mq, qs, B, Nq, C, F32Smem::R)) != cudaSuccess ||
      (err = f32e::make_map(&mk, k, B, Nk, C, f32e::KT)) != cudaSuccess ||
      (err = f32e::make_map(&mv, v, B, Nk, C, f32e::KT)) != cudaSuccess)
    return err;
  const int bytes = F32Smem::kBytes;
  if ((err = prepare(cross_main_f32, bytes)) != cudaSuccess) return err;
  dim3 grid((Nq + F32Smem::R - 1) / F32Smem::R, C / D, B * max_splits);
  cross_main_f32<<<grid, F32Smem::kThreads, bytes, stream>>>(
      mq, mk, mv, bl, list, count, out, opart, ml, B, Nq, Nk, C, nt,
      split_tiles, max_splits);
  return cudaGetLastError();
}

P3_ERROR_STRING_FN

// q (B, Nq, C), k/v (B, Nk, C) bf16, or f32 with ``f32``; q/k tables (B,
// N, 64) f32 or all null; bias (B, Nk) f32 or null; out (B, Nq, C) in the
// inputs' dtype; ``nwg`` consumer warpgroups per bf16 CTA (the f32 CTAs
// have 128 rows); ``split_tiles`` key tiles per split.  Scratch from the
// caller, with nt = ceil(Nk / 128) key tiles and S = ceil(nt /
// split_tiles) splits: qs (B, Nq, C) and, with tables, ks (B, Nk, C) in
// the inputs' dtype (else null); bl (B, nt * 128) f32; list (B, nt) and
// count (B) int32; with S > 1 opart (S, B, Nq, C) f32 and ml (S, B, C/64,
// Nq, 2) f32.
extern "C" int p3_tower_cross_sm90(
    const void* q, const void* k, const void* v, const void* qcos,
    const void* qsin, const void* kcos, const void* ksin, const void* bias,
    void* out, void* qs, void* ks, void* bl, void* list, void* count,
    void* opart, void* ml, int B, int Nq, int Nk, int C, float scale,
    int nwg, int split_tiles, int f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = (Nk + BKT - 1) / BKT;
  if (split_tiles < 1) return cudaErrorInvalidValue;
  const int max_splits = n_splits(nt, split_tiles);
  if ((nwg != 1 && nwg != 2) || C % D != 0 ||
      (ks == nullptr) != (kcos == nullptr))
    return cudaErrorInvalidValue;
  const int lanes = f32 ? 4 : 8;     // lanes per thread of the rotation
  const long chunks = ((long)B * Nq + (ks ? (long)B * Nk : 0)) * (C / lanes);
  if (chunks >= (1L << 31) || nt * 4L > 48 * 1024) return cudaErrorInvalidValue;
  const int rot_blocks =
      static_cast<int>(std::min<long>((chunks + 255) / 256, 132L * 32));
  const float* qc = static_cast<const float*>(qcos);
  const float* qn = static_cast<const float*>(qsin);
  const float* kc = static_cast<const float*>(kcos);
  const float* kn = static_cast<const float*>(ksin);
  if (f32) {
    cross_rotate_f32<<<rot_blocks, 256, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), qc, qn,
        kc, kn, static_cast<float*>(qs), static_cast<float*>(ks), B * Nq,
        B * Nk, C, scale);
  } else {
    cross_rotate<<<rot_blocks, 256, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), qc, qn, kc,
        kn, static_cast<bf16*>(qs), static_cast<bf16*>(ks), B * Nq, B * Nk,
        C, scale);
  }
  cross_tiles<BKT><<<B, 1024, nt * sizeof(int), st>>>(
      static_cast<const float*>(bias), static_cast<float*>(bl),
      static_cast<int*>(list), static_cast<int*>(count), Nk, nt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const float* blf = static_cast<const float*>(bl);
  const int* lst = static_cast<const int*>(list);
  const int* cnt = static_cast<const int*>(count);
  float* op = static_cast<float*>(opart);
  float* mlp = static_cast<float*>(ml);
  const void* kk = ks ? ks : k;
  if (f32) {
    err = launch_main_f32(qs, kk, v, blf, lst, cnt, static_cast<float*>(out),
                          op, mlp, B, Nq, Nk, C, nt, split_tiles, max_splits,
                          st);
  } else {
    CUtensorMap mq, mk, mv;
    if ((err = make_map(&mq, qs, B, Nq, C, BQW)) != cudaSuccess) return err;
    if ((err = make_map(&mk, kk, B, Nk, C, BKT)) != cudaSuccess) return err;
    if ((err = make_map(&mv, v, B, Nk, C, BKT)) != cudaSuccess) return err;
    bf16* o = static_cast<bf16*>(out);
    err = nwg == 1 ? launch_main<1>(mq, mk, mv, blf, lst, cnt, o, op, mlp, B,
                                    Nq, C, nt, split_tiles, max_splits, st)
                   : launch_main<2>(mq, mk, mv, blf, lst, cnt, o, op, mlp, B,
                                    Nq, C, nt, split_tiles, max_splits, st);
  }
  if (err != cudaSuccess || max_splits == 1) return err;
  const long total = (long)B * Nq * C;
  const int cblocks =
      static_cast<int>(std::min<long>((total + 255) / 256, 132L * 16));
  if (f32)
    cross_combine<<<cblocks, 256, 0, st>>>(op, mlp, cnt,
                                           static_cast<float*>(out), B, Nq, C,
                                           split_tiles);
  else
    cross_combine<<<cblocks, 256, 0, st>>>(op, mlp, cnt,
                                           static_cast<bf16*>(out), B, Nq, C,
                                           split_tiles);
  return cudaGetLastError();
}
