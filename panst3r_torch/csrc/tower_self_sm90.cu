// K1, bf16 — tower self-attention on the Hopper engine (attn_sm90.cuh).
//
// Replaces panst3r_tpu/ops/pallas/tower_attention.py::_tower_fwd (body
// _kernel), bf16: softmax(q k^T * scale) v per d=64 head, q/k/v read out of
// the fused (B, N, 3C) projection at column offsets h*64, C + h*64 and
// 2C + h*64 through one 3-D tensor map each (no relayout), the output
// written to (B, N, C) at column h*64.  Optional 2D-RoPE (cos, sin) tables
// (B, N, 64) f32 for q and k; an optional cls key/value (B, 1, C) that
// joins every query's softmax as one extra column (DINO split-cls).  The
// f32 path runs the f32 K4's engine (flash_fwd_sm90.cu).
//
// Bound on the H100: at the encoder shape (B=4, N=768, H=16) 9.7 GFLOP
// against ~25 MB of bf16 and table traffic: 0.0098 ms by operations at
// 989 TFLOP/s.  The gate is N <= 1024, so a row walks at most 8 key tiles
// of 128; no key split.
//
// Design.  With tables, self_rotate first writes q~ = bf16(rope(q)) and
// k~ = bf16(rope(k)) (unscaled, the values the old engine built per query
// block) to scratch (B, N, 2C); v is always read from qkv, and without
// tables q and k are too.  The main kernel walks the key tiles through the
// TMA ring with wgmma products and the softmax in registers; the score is
// scaled in f32 (raw * scale, with log2 e folded in), keys >= N are NEG.
// The cls column seeds each row's state per consumer thread: m = scale *
// (q~ . kc) in f32, l = 1, O = vc.  64-row CTAs (one consumer warpgroup)
// where B*H*ceil(N/128) < 132 (the decoder's B=1 self-attention in the
// memory build); that choice changes no row's arithmetic.
#include <algorithm>

#include "attn_sm90.cuh"

using namespace p3;
using namespace p3::sm90;

typedef __nv_bfloat16 bf16;

// (B, N, 2C) scratch: [rope(q) | rope(k)] rounded to bf16, one thread per
// 8 lanes of a row.
__global__ void self_rotate(const bf16* __restrict__ qkv,
                            const float* __restrict__ cosb,
                            const float* __restrict__ sinb,
                            bf16* __restrict__ qk, int rows, int C) {
  const int per_row = 2 * C / 8;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < rows * per_row;
       e += gridDim.x * blockDim.x) {
    const long row = e / per_row;
    const int c = (e % per_row) * 8, d0 = c & 63;
    rope8(qkv + row * 3 * C + (c - d0), cosb + row * 64, sinb + row * 64,
          d0, 1.f, qk + row * 2 * C + c);
  }
}

// grid (ceil(N / (64 NWG)), heads, B).  ``mq`` (64-row boxes) and ``mk``
// (128-row boxes) map [q | k | ...] (the scratch or qkv itself), ``mv``
// qkv.
template <int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, Regs<NWG>::kMinBlocks)
self_main(const __grid_constant__ CUtensorMap mq,
          const __grid_constant__ CUtensorMap mk,
          const __grid_constant__ CUtensorMap mv,
          const bf16* __restrict__ kc, const bf16* __restrict__ vc,
          bf16* __restrict__ out, int N, int C, float sl) {
  extern __shared__ unsigned char smem_raw[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * NWG * BQW;
  const int n = (N + BKT - 1) / BKT;
  const Smem<NWG> sm(smem_raw);
  init_barriers(sm);
  const int wg = threadIdx.x / 128;

  if (wg == NWG) {  // producer warpgroup
    regs_dec<Regs<NWG>::kProducer>();
    if (threadIdx.x == NWG * 128) {
      produce(
          sm, n, 2 * kKVBytes,
          [&](int g, void* dst, uint64_t* bar) {
            tma_load_3d(dst, &mq, bar, h * D, q0 + g * BQW, b);
          },
          [&](int i) { return i; },
          [&](int t, void* kd, void* vd, float*, uint64_t* bar) {
            tma_load_3d(kd, &mk, bar, C + h * D, t * BKT, b);
            tma_load_3d(vd, &mv, bar, 2 * C + h * D, t * BKT, b);
          });
    }
  } else {  // consumer warpgroup wg: query rows q0 + 64 wg + [0, 64)
    regs_inc<Regs<NWG>::kConsumer>();
    const Rows rw;
    RowState st;
    st.zero();
    mbar_wait(sm.q_full(), 0);
    if (kc != nullptr) {
      const bf16* kch = kc + (long)b * C + h * D;
      const bf16* vch = vc + (long)b * C + h * D;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = hh ? rw.r1 : rw.r0;
        float part[2] = {0.f, 0.f};
#pragma unroll
        for (int d = 0; d < D; ++d)
          part[d >> 5] += swz_at(sm.q(wg), r, d) * __bfloat162float(kch[d]);
        st.m[hh] = (part[0] + part[1]) * sl;
        st.l[hh] = 1.f;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i)
        st.o[i] = __bfloat162float(vch[Rows::col(i) + rw.cq]);
    }
    consume(sm, wg, n, st, rw, [&](float raw, int c, int i, int) {
      return (i * BKT + c < N) ? raw * sl : NEG;
    });
    const int row0 = q0 + wg * BQW;
    store_normalized(st, rw, [&](int r) -> bf16* {
      const int i = row0 + r;
      return i < N ? out + ((long)b * N + i) * C + h * D : nullptr;
    });
  }
}

template <int NWG>
static cudaError_t launch_main(const CUtensorMap& mq, const CUtensorMap& mk,
                               const CUtensorMap& mv, const bf16* kc,
                               const bf16* vc, bf16* out, int B, int N, int C,
                               float sl, cudaStream_t stream) {
  auto kern = self_main<NWG>;
  const int bytes = Smem<NWG>::kBytes;
  cudaError_t err = prepare(kern, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((N + NWG * BQW - 1) / (NWG * BQW), C / D, B);
  kern<<<grid, (NWG + 1) * 128, bytes, stream>>>(mq, mk, mv, kc, vc, out, N,
                                                 C, sl);
  return cudaGetLastError();
}

P3_ERROR_STRING_FN

// qkv (B, N, 3C) bf16; cos/sin (B, N, 64) f32 or null; kc/vc (B, 1, C)
// bf16 or null; out (B, N, C).  Scratch from the caller: qk (B, N, 2C) bf16
// with tables, else null.  nwg: consumer warpgroups per CTA (1 or 2).
extern "C" int p3_tower_self_sm90(const void* qkv, const void* cosb,
                                  const void* sinb, const void* kc,
                                  const void* vc, void* out, void* qk, int B,
                                  int N, int C, float scale, int nwg,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((nwg != 1 && nwg != 2) || C % D != 0 ||
      (qk == nullptr) != (cosb == nullptr))
    return cudaErrorInvalidValue;
  const bf16* x = static_cast<const bf16*>(qkv);
  if (qk != nullptr) {
    const long chunks = (long)B * N * (2 * C / 8);
    if (chunks >= (1L << 31)) return cudaErrorInvalidValue;
    const int blocks =
        static_cast<int>(std::min<long>((chunks + 255) / 256, 132L * 32));
    self_rotate<<<blocks, 256, 0, st>>>(x, static_cast<const float*>(cosb),
                                        static_cast<const float*>(sinb),
                                        static_cast<bf16*>(qk), B * N, C);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // q at column h*64 and k at C + h*64 of [q | k] (scratch) or of qkv
  const void* qk_src = qk ? qk : qkv;
  const int wqk = qk ? 2 * C : 3 * C;
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = make_map(&mq, qk_src, B, N, wqk, BQW)) != cudaSuccess) return err;
  if ((err = make_map(&mk, qk_src, B, N, wqk, BKT)) != cudaSuccess) return err;
  if ((err = make_map(&mv, qkv, B, N, 3 * C, BKT)) != cudaSuccess) return err;
  const float sl = scale * L2E;
  const bf16* kcb = static_cast<const bf16*>(kc);
  const bf16* vcb = static_cast<const bf16*>(vc);
  bf16* o = static_cast<bf16*>(out);
  return nwg == 1
             ? launch_main<1>(mq, mk, mv, kcb, vcb, o, B, N, C, sl, st)
             : launch_main<2>(mq, mk, mv, kcb, vcb, o, B, N, C, sl, st);
}
