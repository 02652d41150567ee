// K6, bf16 — head-packed flash attention on the Hopper engine
// (attn_sm90.cuh).
//
// Replaces tools/ab_attention_packed.py::packed_mha (body _packed_kernel),
// bf16: q, k, v of shape (B, P, N, 128), P = H/2 head pairs, lanes 0:64 one
// head and 64:128 the next; per head softmax(q k^T * scale) v with its own
// online-softmax stream, no mask and no bias.  As in the Pallas kernel:
// f32 scores, the scale on the f32 score, p rounded to bf16 in the value
// product while the row sum takes the unrounded f32 p (the engine's
// softmax step without ``RoundedSum``), out = acc / l in bf16.  The f32
// path runs the f32 K4's engine (flash_fwd_sm90.cu).
//
// Bound on the H100: at the A/B tool's shape (B=8, H=16, N=768) 19.3 GFLOP
// (0.0195 ms at 989 TFLOP/s) against 50 MB of q, k, v and out (0.015 ms at
// 3.35 TB/s): bound by operations.
//
// Design.  One CTA owns one (batch, pair, head, 128-query tile): two
// consumer warpgroups of 64 rows and the producer warpgroup of the engine,
// which walks every key tile of 128 through the TMA ring (wgmma products,
// the softmax in registers).  The head is the lane offset (0 or 64) of
// every TMA box: q, k and v are 4-D maps over (lanes, tokens, pairs,
// batch) built from the strides the wrapper passes, with the three outer
// dims in ascending order of stride, so the head-pair view of a (B, N,
// H*64) projection is read in place; a 64-lane box at lane 64 of a
// 256-byte row lands in the 128B-swizzled canonical tile like one at lane
// 0.  N is a multiple of 64, so the last key tile may reach half past N:
// TMA fills that half with zeros and the consumer gives those keys NEG.
// The output goes to (B, N, P, 128) storage at lane offset 64 * head, so
// merging the heads is a free reshape.
#include "attn_sm90.cuh"

using namespace p3;
using namespace p3::sm90;

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NWG = 2;

// The ``rows`` tokens from ``tok`` of one head (lanes 64h .. 64h + 63).
__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* map,
                                          const Perm& pm, uint64_t* bar,
                                          int h, int tok, int pair, int b) {
  tma_load_4d(dst, map, bar, h * D, pick(0, pm, tok, pair, b),
              pick(1, pm, tok, pair, b), pick(2, pm, tok, pair, b));
}

// grid (ceil(N / 128), 2 heads, B * P).
__global__ void __launch_bounds__((NWG + 1) * 128, Regs<NWG>::kMinBlocks)
packed_main(const __grid_constant__ CUtensorMap mq,
            const __grid_constant__ CUtensorMap mk,
            const __grid_constant__ CUtensorMap mv, const Perm pq,
            const Perm pk, const Perm pv, bf16* __restrict__ out,
            long long ob, long long op, long long on, int P, int N,
            float sl) {
  extern __shared__ unsigned char smem_raw[];
  const int h = blockIdx.y, b = blockIdx.z / P, pr = blockIdx.z % P;
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
            load_rows(dst, &mq, pq, bar, h, q0 + g * BQW, pr, b);
          },
          [&](int i) { return i; },
          [&](int t, void* kd, void* vd, float*, uint64_t* bar) {
            load_rows(kd, &mk, pk, bar, h, t * BKT, pr, b);
            load_rows(vd, &mv, pv, bar, h, t * BKT, pr, b);
          });
    }
  } else {  // consumer warpgroup wg: query rows q0 + 64 wg + [0, 64)
    regs_inc<Regs<NWG>::kConsumer>();
    const Rows rw;
    RowState st;
    st.zero();
    mbar_wait(sm.q_full(), 0);
    consume<false>(sm, wg, n, st, rw, [&](float raw, int c, int i, int) {
      return (i * BKT + c < N) ? raw * sl : NEG;
    });
    const int row0 = q0 + wg * BQW;
    bf16* base = out + b * ob + pr * op + h * D;
    store_normalized(st, rw, [&](int r) -> bf16* {
      const int i = row0 + r;
      return i < N ? base + i * on : nullptr;
    });
  }
}

// A (B, P, N, 128) bf16 tensor with element strides (sb, sp, sn) as a 4-D
// map (the pairs in make_map4's head dim), boxes of 64 lanes x ``rows``
// tokens, 128-byte swizzle.
cudaError_t make_packed_map(CUtensorMap* map, const void* base, int B, int P,
                            int N, long long sb, long long sp, long long sn,
                            int rows, Perm* perm) {
  return make_map4(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, B, P, N,
                   128, sb, sp, sn, 64, rows, CU_TENSOR_MAP_SWIZZLE_128B,
                   perm);
}

}  // namespace

P3_ERROR_STRING_FN

// q, k, v, out (B, P, N, 128) bf16 through the element strides in
// strides[0..11] (q, k, v, out: batch, pair, token), unit lane stride,
// strides of q, k and v multiples of 8 elements and base addresses
// 16-byte aligned (the tensor maps' rule); N a multiple of 64.
extern "C" int p3_packed_flash_sm90(const void* q, const void* k,
                                    const void* v, void* out,
                                    const long long* strides, int B, int P,
                                    int N, float scale, void* stream) {
  if (N % BQW != 0 || N <= 0) return cudaErrorInvalidValue;
  const long long* s = strides;
  CUtensorMap mq, mk, mv;
  Perm pq, pk, pv;
  cudaError_t err;
  if ((err = make_packed_map(&mq, q, B, P, N, s[0], s[1], s[2], BQW, &pq)) !=
      cudaSuccess)
    return err;
  if ((err = make_packed_map(&mk, k, B, P, N, s[3], s[4], s[5], BKT, &pk)) !=
      cudaSuccess)
    return err;
  if ((err = make_packed_map(&mv, v, B, P, N, s[6], s[7], s[8], BKT, &pv)) !=
      cudaSuccess)
    return err;
  const int bytes = Smem<NWG>::kBytes;
  if ((err = prepare(packed_main, bytes)) != cudaSuccess) return err;
  dim3 grid((N + NWG * BQW - 1) / (NWG * BQW), 2, B * P);
  packed_main<<<grid, (NWG + 1) * 128, bytes,
                static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, pq, pk, pv, static_cast<bf16*>(out), s[9], s[10], s[11], P,
      N, scale * L2E);
  return cudaGetLastError();
}
