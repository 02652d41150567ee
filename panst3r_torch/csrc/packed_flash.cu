// K6, f32 — head-packed flash attention: two d=64 heads per 128-lane row.
//
// Replaces tools/ab_attention_packed.py::packed_mha (body _packed_kernel),
// f32: q, k, v of shape (B, P, N, 128), P = H/2 head pairs, lanes 0:64 one
// head and 64:128 the next; per head softmax(q k^T * scale) v with its own
// online-softmax stream (running max m, row sum l, accumulator), no mask
// and no bias.  As in the Pallas kernel: f32 scores, the scale on the f32
// score, the row sum over the unrounded p, out = acc / l.  (Pallas
// prescales by log2(e) and uses exp2; exp here is the same function up to
// rounding.)  The bf16 path runs on the Hopper engine
// (packed_flash_sm90.cu); this file is the f32 path, which the f32 limit
// of 1e-4 keeps off TF32 products.
//
// Design: one block owns one (batch, head pair, 64-query tile) and holds
// two engine tiles (attn_tile.cuh), one per head: warps 0-3 run the stream
// of lanes 0:64, warps 4-7 that of lanes 64:128.  Each 64-key K/V tile is
// read from device memory once, as 128-lane rows, by all eight warps, and
// split into the two tiles' buffers; then each warp group runs the WMMA
// score product, its softmax and the value product on its own head.  q, k,
// v and out are addressed through (batch, pair, token) strides with a unit
// lane stride, so the (B, N, H*64) projection is read in place (no
// relayout) and the output lands in (B, N, P, 128) order.
//
// Bound on the H100: at the A/B tool's shape (B=8, H=16, N=768) the work
// is 4*B*H*N^2*64 = 19.3 GFLOP (0.2885 ms at 67 TFLOP/s f32) against
// 101 MB of q, k, v and out: bound by operations.
#include "attn_tile.cuh"

using namespace p3;

constexpr int KD = 64;              // head dim of each packed head
constexpr int KLANES = 2 * KD;      // lanes of a packed row
constexpr int KTHREADS = 2 * NTHREADS;

// Element strides of q, k, v and out by (batch, pair, token).
struct PackedStrides {
  long long qb, qp, qn, kb, kp, kn, vb, vp, vn, ob, op, on;
};

template <typename T>
__global__ void __launch_bounds__(KTHREADS)
packed_flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out,
                    PackedStrides st, int P, int N, float scale) {
  using TL = Tile<T, KD>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int head = warp >> 2;                 // 0: lanes 0:64, 1: 64:128
  TL t;
  t.init(smem + head * TL::kBytes, warp & 3);
  // q, k, v buffers of both heads' tiles (the engine's layout: q, k, v
  // first), for the loads that all eight warps share
  auto buf = [&](int h, int which) {
    return reinterpret_cast<T*>(smem + h * TL::kBytes
                                + (which ? TL::kQ + (which - 1) * TL::kKV
                                         : 0));
  };
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / P, pr = blockIdx.y % P;
  const T* qp = q + b * st.qb + pr * st.qp;
  const T* kp = k + b * st.kb + pr * st.kp;
  const T* vp = v + b * st.vb + pr * st.vp;

  // N is a multiple of 64 (checked at the entry): no ragged tile.
  for (int e = threadIdx.x; e < BQ * KLANES; e += KTHREADS) {
    const int r = e / KLANES, c = e % KLANES;
    buf(c / KD, 0)[r * TL::LD + c % KD] = qp[(q0 + r) * st.qn + c];
  }
  for (int k0 = 0; k0 < N; k0 += BK) {
    for (int e = threadIdx.x; e < BK * KLANES; e += KTHREADS) {
      const int r = e / KLANES, c = e % KLANES, j = k0 + r;
      buf(c / KD, 1)[r * TL::LD + c % KD] = kp[j * st.kn + c];
      buf(c / KD, 2)[r * TL::LD + c % KD] = vp[j * st.vn + c];
    }
    __syncthreads();
    t.scores();
    t.template softmax<false>(
        [scale](int, int, float x) { return x * scale; });
    t.accumulate();
    __syncthreads();
  }
  T* op = out + b * st.ob + pr * st.op + head * KD;
  t.finish([&](int r, int d, float val) {
    op[(q0 + r) * st.on + d] = from_f<T>(val);
  });
}

template <typename T>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          void* out, const PackedStrides& st, int B, int P,
                          int N, float scale, cudaStream_t stream) {
  auto kern = packed_flash_kernel<T>;
  const int bytes = 2 * Tile<T, KD>::kBytes;
  cudaError_t err = prepare(kern, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(N / BQ, B * P);
  kern<<<grid, KTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), st, P, N, scale);
  return cudaGetLastError();
}

P3_ERROR_STRING_FN

// q, k, v, out (B, P, N, 128) f32 through the element strides in
// strides[0..11] (q, k, v, out: batch, pair, token), unit lane stride;
// N a multiple of 64.
extern "C" int p3_packed_flash(const void* q, const void* k, const void* v,
                               void* out, const long long* strides, int B,
                               int P, int N, float scale, void* stream) {
  if (N % BQ != 0 || N % BK != 0) return cudaErrorInvalidValue;
  const long long* s = strides;
  const PackedStrides st{s[0], s[1], s[2], s[3], s[4],  s[5],
                         s[6], s[7], s[8], s[9], s[10], s[11]};
  return launch<float>(q, k, v, out, st, B, P, N, scale,
                       static_cast<cudaStream_t>(stream));
}
