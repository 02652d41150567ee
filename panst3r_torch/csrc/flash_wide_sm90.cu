// K3, K4 and K5 at head dims above 128 — the wide-head engine, f32 and
// bf16.  The Hopper engines of flash_{fwd,bwd}{,_bf16}_sm90.cu and
// masked_attn_sm90.cu keep every head dim up to 128; this source takes
// the head dims they refuse, which the Pallas kernels take by padding D
// to their lane width:
//
// - K4, panst3r_tpu/ops/pallas/flash_attention.py::_flash_fwd (:171):
//   p3_wide_fwd without a mask.  A dense additive bias read through its
//   strides, a per-key bias row (B, Nk) (the (B|1, 1, 1, Nk) bias and the
//   key validity folded into it by the wrapper: 0 / finfo.min), 2D-RoPE
//   tables (B, N, P) and the natural-log LSE, (m + log2 l) ln 2, which K5
//   reads.  The scale multiplies the f32 score and the biases are added
//   after it (in log2 units: exp2 replaces exp); masked logits are
//   finfo(f32).min and give p = 0; the row sum takes the unrounded p and
//   the value product p rounded to v's dtype; a row with no live key
//   writes 0 and its LSE is finfo.min.
// - K3, panst3r_tpu/ops/pallas/masked_attention.py::_sparse_fwd (:119):
//   p3_wide_fwd with the (B, Nq, Nk) blocked mask (1 = blocked): blocked
//   logits are finfo.min, p is rounded to v's dtype in both sums (as the
//   port's other K3 kernels and their plain version), a key tile whose
//   whole block (the CTA's rows x 64 keys) is blocked is skipped (a
//   pre-pass lists each row tile's live key tiles), a fully blocked row
//   writes 0.
// - K5, panst3r_tpu/ops/pallas/flash_attention_bwd.py::flash_bwd (:115):
//   p3_wide_bwd, dq over query tiles and dk, dv over key tiles from K4's
//   LSE, p = exp(s - LSE) recomputed, Dvec = rowsum(dO * O) by a pre-pass
//   (one warp a row, a fixed order), ds = p (dp - Dvec) scale rounded to
//   the inputs' dtype before its products, p rounded before dv's.  The
//   gradients are with respect to the rotated q and k: the wrapper applies
//   the rotation's adjoint (ops/flash_attention.py::_rope_adjoint).  No
//   atomics: each gradient element is summed by one thread in a fixed
//   order, so a call repeats bit for bit.
//
// The wrapper pads D to P = round_up(D, 64) with zero lanes (per RoPE
// quarter with tables; cos 1 and sin 0 on the pad lanes) and passes
// contiguous (B, H, N, P) tensors.
//
// Bound on the H100: at a wide LoftUp call (B = 4 views, one head of 384,
// 192 x 256 pixel queries against 768 tokens) the work is 4 B Nq Nk D =
// 232 GFLOP against ~0.6 GB of q and out: bound by operations (0.23 ms at
// the bf16 tensor-core rate, 1.41 ms at the 494.7 / 3 TFLOP/s of 3xTF32
// products).
//
// The forward (fwd_bf16, fwd_f32).  What bounds it is registers: O is
// rows x P f32, and at P = 384 a 64-row tile's O is 96 KB.  So the output
// lanes are cut into slices, each held in registers by one warpgroup
// (bf16) or one warp per 16 rows (f32), and every slice of a CTA reads the
// same scores; shared memory holds no whole-P operand tile (q, k and v
// stream through a ring in lane boxes), so no P is refused.  The slice,
// CTA and split choice is the wrapper's (ops/flash_attention.py::
// wide_plan), passed in and checked here against this file's
// shared-memory formula.
// - No producer warp: a ninth warp would cap every thread at 168
//   registers.  Thread 0 issues every TMA load of its CTA: the first
//   ``stages`` entries at the start, then entry e + stages as soon as
//   every thread has released entry e (full / empty mbarriers per slot).
//   The consumers walk the same sequence of entries in the same order;
//   ring positions advance one slot at a time (a division per entry cost
//   a fifth of the kernel's time).
// - bf16: 64-row CTAs of one or two consumer warpgroups; a warpgroup holds
//   at most four 64-lane boxes of O (128 registers a thread), so the
//   slices number ceil(P / 256) and a CTA holds two.  S is formed once
//   per CTA (wgmma, Q and K boxes of 64 rows x 64 lanes, 128B swizzle,
//   accumulated over the P / 64 boxes): one warpgroup forms it over the
//   tile's 64 keys and feeds P from registers (attn_sm90.cuh's softmax
//   step, wgmma RS); two warpgroups each form 32 keys of it (m64n32),
//   exchange their rows' maxima through shared memory under a named
//   barrier, and write P (bf16) into a 64 x 64 tile there, which both
//   read as the A operand of P V (wgmma SS) under a second barrier.  That
//   halves the QK^T products and the exponentials against each
//   warpgroup forming all of S, for two barriers a key tile.  Q stays
//   resident when its boxes fit beside four ring slots (P <= 1344), else
//   it streams beside K.
// - f32: 3xTF32 mma.sync m16n8k8 (attn_f32_sm90.cuh: x = hi + lo, lo.hi +
//   hi.lo + hi.hi) from hi/lo planes of q, k and v written once per call
//   by a pre-pass (rotated first with tables); splitting each value in
//   registers as it is read halved the bytes streamed from L2 and was
//   slower.  A CTA of 16 RT rows and 4 RT warps (K4: RT = 3, 12 warps,
//   which hide more of the products' latency than 8 and read k and v
//   fewer times a query; K3: RT = 2, its grids are small; 16 warps at 128
//   registers spilled): for S, warp w takes row tile w % RT and keys
//   16 (w / RT) .. + 16 of each 64-key tile (each 8-lane step's hi.hi
//   product in a fresh accumulator added in f32 round-to-nearest, the
//   small terms in the tensor core in two chains: flash_sm90.cuh's
//   qk_rn), over ring entries of one 32-lane step (q and k hi/lo boxes);
//   the logits go to a shared tile (double-buffered: one block barrier
//   per key tile), so S is formed once per row tile and key tile.  For
//   P V, warp w takes row tile w % RT and lane slice w / RT: at most four
//   32-lane boxes, 64 registers of O; it reads its rows' logits, runs the
//   softmax step (the same bits in every slice), and adds P V per 8 keys
//   in a fresh accumulator in f32 round-to-nearest (mma3_rn) over the
//   slice's v hi/lo boxes, fed in rounds of one box per slice.  A CTA
//   holds four slices, 512 lanes; past that the lanes split across CTAs,
//   each forming S again (ceil(P / 512) times).
// - Split-KV: past WIDE_SPLIT_AFTER key tiles (ops/flash_attention.py) a
//   row tile's keys are cut into runs of WIDE_SPLIT_TILES, fixed in key
//   space, each walked by a CTA of its own, which writes its unnormalised
//   O, m and l; wide_merge adds the runs in order.  The mask
//   transformer's 200 queries against 3072 keys make 21 CTAs otherwise.
// A row's arithmetic depends only on its own q, its batch's k, v and
// biases (K3: its mask row), Nk and P: never on B, Nq or the grid.
#include "attn_f32_sm90.cuh"

using namespace p3;

namespace {

typedef __nv_bfloat16 bf16;
using sm90::BiasStrides;

constexpr float LN2 = 0.6931471805599453f;

// ------------------------------------------------------ the forward ----

constexpr int KT = 64;                      // keys per tile
constexpr int SMEM_LIMIT = 232448;          // a CTA's shared memory
constexpr int ALIGN = 1024;                 // room to align the base
constexpr int MAX_STAGES = 16;
constexpr uint32_t kBoxB = 64 * 64 * 2;     // bf16 box: 64 rows x 64 lanes
constexpr uint32_t kBoxF = 64 * 32 * 4;     // f32 box: 64 rows x 32 lanes
constexpr int LROW = KT + 8;                // the f32 logit tile's row stride
constexpr uint32_t kXchBytes = 2048;        // bf16 PAIR: row maxima, sums

// The wrapper's plan (ops/flash_attention.py::wide_plan).  Units are the
// engine's lane boxes: 64 lanes in bf16, 32 in f32.  Slices of ``nbw``
// boxes each (the last may be short or, in f32, empty), ``per_cta``
// slices a CTA (bf16: its warpgroups; f32: its four lane slices),
// ``groups`` CTAs along the lanes, ``rows`` query rows a CTA.
struct Plan {
  int nb, nbw, per_cta, groups, stages, qres, rows, smem, splits, split_tiles;
};

// Shared bytes of a CTA under a plan: bf16 the resident Q boxes, with two
// warpgroups two P tiles and their exchange, the ring of 8 KB slots and
// the barriers; f32 the two logit tiles, the ring of slots of one S entry
// (q hi/lo boxes of ``rows`` rows and k hi/lo boxes) and the barriers.
// The wrapper's formula is the same (wide_plan).
__host__ __device__ inline int smem_bytes(const Plan& p, bool f32) {
  const int bars = 8 * (1 + 2 * p.stages);
  if (!f32)
    return ALIGN + (p.qres ? p.nb : 0) * (int)kBoxB +
           (p.per_cta == 2 ? 2 * (int)kBoxB + (int)kXchBytes : 0) +
           p.stages * (int)kBoxB + bars;
  const int logits = 2 * p.rows * LROW * 4;
  const int slot = 2 * p.rows * 128 + 2 * (int)kBoxF;
  return ALIGN + logits + p.stages * slot + bars;
}

// A ring slot and the parity of its current use (no division on the
// per-entry path: positions advance one slot at a time).
struct Pos {
  int slot;
  uint32_t ph;
};

// The ring: slots of ``slot`` bytes from ``ring``, barriers after them.
struct Ring {
  unsigned char* ring;
  uint64_t* bars;      // [0] Q, [1 + s] full, [1 + stages + s] empty
  uint32_t slot;
  int stages;
  __device__ unsigned char* at(Pos p) const { return ring + p.slot * slot; }
  __device__ uint64_t* q_full() const { return bars; }
  __device__ uint64_t* full(Pos p) const { return bars + 1 + p.slot; }
  __device__ uint64_t* empty(Pos p) const {
    return bars + 1 + stages + p.slot;
  }
  __device__ void wait(Pos p) const { sm90::mbar_wait(full(p), p.ph); }
  __device__ Pos next(Pos p) const {
    return p.slot + 1 == stages ? Pos{0, p.ph ^ 1u} : Pos{p.slot + 1, p.ph};
  }
};

__device__ __forceinline__ unsigned char* aligned_base(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// A CTA's sequence of ring entries: per live key tile, ``ns`` S entries
// (bf16: the K boxes, each after its Q box when Q streams; f32: one per
// 32-lane step), then ``nv`` V entries (bf16: the CTA's V boxes in lane
// order; f32: rounds of one box of each of the four slices).
struct Seq {
  int ns, nv, per_tile;
  __device__ Seq(int ns_, int nv_) : ns(ns_), nv(nv_), per_tile(ns_ + nv_) {}
};

// The issuing thread's place in its CTA's sequence: the next entry to
// load (tile ``i``, entry ``r`` of the tile, into slot ``at``), the
// entries left, and the first keys of tile i and of the next one, read
// from global memory one tile ahead so that no TMA issue waits on a load.
struct Issuer {
  const int* tiles;
  int n, per_tile, i, r, key, next;
  uint32_t left;
  Pos at;
  __device__ Issuer(const int* t, int n_, int per_tile_)
      : tiles(t), n(n_), per_tile(per_tile_), i(0), r(0), key(0), next(0),
        left(static_cast<uint32_t>(n_) * per_tile_), at{0, 0} {
    if (n > 0) key = tiles[0] * KT;
    if (n > 1) next = tiles[1] * KT;
  }
  // after an entry is issued
  __device__ void advance(const Ring& rg) {
    at = rg.next(at);
    --left;
    if (++r == per_tile) {
      r = 0;
      ++i;
      key = next;
      if (i + 1 < n) next = tiles[i + 1] * KT;
    }
  }
};

// The split-KV run of a CTA of split ``sp``: the positions [x, y) in its
// list (ascending) of the live tiles in [sp * st, sp * st + st), so that
// the runs are fixed in key space and a row's sums do not depend on the
// other rows' masks.  Every thread of the CTA takes part.
__device__ __forceinline__ int2 split_run(const int* tiles, int n, int sp,
                                          int st) {
  const int lo = sp * st, hi = lo + st;
  int x = 0, y = 0;
  for (int k0 = 0; k0 < n; k0 += blockDim.x) {
    const int k = k0 + threadIdx.x;
    const int t = k < n ? tiles[k] : 0x7fffffff;
    x += __syncthreads_count(t < lo);
    y += __syncthreads_count(t < hi);
  }
  return make_int2(x, y);
}

// The logit (log2 units, NEG where masked) of a raw score of query row
// ``row`` and key ``key``: K4 raw * sl plus the key's bias ``kx`` (log2
// units, NEG past Nk) plus the dense bias; K3 raw * sl, or NEG where its
// mask byte ``kx`` is 1 (blocked, past Nk or past Nq).  ``kx`` is read
// ahead of the scores (key_extra).
template <bool MASKED>
__device__ __forceinline__ float wide_logit(float raw, float sl, int row,
                                            int key, int Nq, int Nk, float kx,
                                            const float* bh,
                                            const BiasStrides& bs) {
  if (MASKED) return kx == 0.f ? raw * sl : NEG;
  const float* db = (bh != nullptr && row < Nq && key < Nk)
                        ? bh + row * bs.q + key * bs.k
                        : nullptr;
  return sm90::logit(raw, sl, kx, db);
}

// The bias or mask byte of key ``key`` for query row ``row`` (wide_logit's
// ``kx``).
template <bool MASKED>
__device__ __forceinline__ float key_extra(int row, int key, int Nq, int Nk,
                                           const float* kb,
                                           const unsigned char* mrow0,
                                           int ldm) {
  if (!MASKED) return __ldg(kb + key);
  return (key < Nk && row < Nq)
             ? static_cast<float>(
                   __ldg(mrow0 + static_cast<size_t>(row) * ldm + key))
             : 1.f;
}

// ------------------------------------------------------------- bf16 ----

// D (64 x 64, f32 in registers) += A (64 x 16, smem, K-major) . B (16 x
// 64, smem, MN-major), both behind swizzle descriptors (P V with P in
// shared memory).
__device__ __forceinline__ void wgmma_ss_n64_mn(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The two warpgroups of a PAIR CTA meet (named barrier 1).
__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// grid (ceil(Nq / 64), B * H, groups * splits); per_cta warpgroups of 128
// threads.  Warpgroup w of CTA z holds O's boxes [(z per_cta + w) nbw, ...
// + nbw) (fewer at the end, or none).  One warpgroup (PAIR false) forms S
// over the tile's 64 keys; two (PAIR) each form S over 32 of them
// (m64n32), exchange their rows' maxima through shared memory, and write
// their P (bf16) into one 64 x 64 tile there, which both read as the A
// operand of P V: S is formed once per row tile and key tile.
template <bool MASKED, int NBW, bool PAIR>
__global__ void __launch_bounds__(256, 1)
fwd_bf16(const __grid_constant__ CUtensorMap mq,
         const __grid_constant__ CUtensorMap mk,
         const __grid_constant__ CUtensorMap mv, const float* __restrict__ bl,
         const int* __restrict__ list, const int* __restrict__ count,
         int lists_per_b, const float* __restrict__ bias, BiasStrides bs,
         const unsigned char* __restrict__ mask, int ldm,
         bf16* __restrict__ out, float* __restrict__ lse,
         float* __restrict__ opart, float* __restrict__ ml, int H, int Nq,
         int Nk, int P, int nt, float sl, Plan pl) {
  constexpr int NS = PAIR ? 16 : 32;        // S registers: 32 or 64 keys
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_base(smem_raw);
  const int q0 = blockIdx.x * KT, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int sp = blockIdx.z / pl.groups, zg = blockIdx.z - sp * pl.groups;
  const int lidx = b * lists_per_b + (lists_per_b > 1 ? blockIdx.x : 0);
  int n = count[lidx];
  const int* tiles = list + static_cast<size_t>(lidx) * nt;
  if (pl.splits > 1) {
    const int2 run = split_run(tiles, n, sp, pl.split_tiles);
    tiles += run.x;
    n = run.y - run.x;
  }
  const int nb = pl.nb, c0 = zg * pl.per_cta * pl.nbw;
  const int nbc = min(pl.per_cta * pl.nbw, nb - c0);
  const Seq seq(pl.qres ? nb : 2 * nb, nbc);
  unsigned char* qres = base;
  unsigned char* ptile = base + (pl.qres ? nb : 0) * kBoxB;   // PAIR: 2
  unsigned char* ring = ptile + (PAIR ? 2 * kBoxB : 0);
  float* xch = reinterpret_cast<float*>(ring + pl.stages * kBoxB);
  Ring rg{ring,
          reinterpret_cast<uint64_t*>(ring + pl.stages * kBoxB +
                                      (PAIR ? kXchBytes : 0)),
          kBoxB, pl.stages};
  if (threadIdx.x == 0) {
    sm90::mbar_init(rg.q_full(), 1);
    for (int s = 0; s < pl.stages; ++s) {
      sm90::mbar_init(rg.bars + 1 + s, 1);
      sm90::mbar_init(rg.bars + 1 + pl.stages + s, pl.per_cta * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  const int my0 = wg * pl.nbw, nbm = max(0, min(pl.nbw, nbc - my0));

  // the issuing thread loads each entry once the CTA has released the one
  // ``stages`` before it (the same slot)
  Issuer iss(tiles, n, seq.per_tile);
  auto issue = [&]() {
    const int r = iss.r;
    unsigned char* dst = rg.at(iss.at);
    uint64_t* bar = rg.full(iss.at);
    sm90::mbar_expect_tx(bar, kBoxB);
    if (r >= seq.ns)
      sm90::tma_load_3d(dst, &mv, bar, 64 * (c0 + r - seq.ns), iss.key, bh);
    else if (pl.qres || (r & 1))
      sm90::tma_load_3d(dst, &mk, bar, 64 * (pl.qres ? r : r >> 1), iss.key,
                        bh);
    else
      sm90::tma_load_3d(dst, &mq, bar, 64 * (r >> 1), q0, bh);
    iss.advance(rg);
  };
  const bool issuer = threadIdx.x == 0;
  auto release = [&](Pos e) {
    sm90::mbar_arrive(rg.empty(e));
    if (issuer && iss.left > 0) {
      sm90::mbar_wait(rg.empty(e), e.ph);
      issue();
    }
  };
  if (issuer) {
    if (pl.qres) {
      sm90::mbar_expect_tx(rg.q_full(), nb * kBoxB);
      for (int j = 0; j < nb; ++j)
        sm90::tma_load_3d(qres + j * kBoxB, &mq, rg.q_full(), 64 * j, q0, bh);
    }
    for (int k = 0; k < pl.stages && iss.left > 0; ++k) issue();
  }

  const sm90::Rows rw;
  sm90::RowStateN<NBW * 32> st;
  st.zero();
  const int rows[2] = {q0 + rw.r0, q0 + rw.r1};
  // PAIR: this warpgroup's 32 keys of each tile
  const int kw = PAIR ? 32 * wg : 0;
  const float* kb = MASKED ? nullptr : bl + static_cast<size_t>(b) * nt * KT;
  const float* bhp = bias ? bias + b * bs.b + h * bs.h : nullptr;
  const unsigned char* mrow0 =
      MASKED ? mask + static_cast<size_t>(b) * Nq * ldm : nullptr;
  float s[NS], alpha[2];
  uint32_t p[16];
  if (pl.qres) sm90::mbar_wait(rg.q_full(), 0);
  Pos e{0, 0};
  int knext = n > 0 ? __ldg(tiles) * KT : 0;
  for (int i = 0; i < n; ++i) {
    const int key0 = knext;
    if (i + 1 < n) knext = __ldg(tiles + i + 1) * KT;
    // the keys' biases or mask bytes, read while S forms
    float kx[NS];
#pragma unroll
    for (int jj = 0; jj < NS; ++jj)
      kx[jj] = key_extra<MASKED>(rows[sm90::Rows::hi(jj)],
                                 key0 + kw + sm90::Rows::col(jj) + rw.cq, Nq,
                                 Nk, kb, mrow0, ldm);
    // S = Q K^T over the P / 64 boxes, one commit group per box; a box's
    // slots are released once the next box's products are issued
    Pos pq{0, 0}, pk{0, 0};
    for (int j = 0; j < nb; ++j) {
      const unsigned char* qb = qres + j * kBoxB;
      Pos eq = e;
      if (!pl.qres) {
        rg.wait(e);
        qb = rg.at(e);
        e = rg.next(e);
      }
      rg.wait(e);
      const unsigned char* kt = rg.at(e);
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (PAIR)   // rows 32 wg .. of the K box: 4 KB in
          sm90::wgmma_ss_n32(s, sm90::desc_kmajor(qb, kk),
                             sm90::desc_kmajor(kt + 4096 * wg, kk),
                             (j | kk) != 0);
        else
          sm90::wgmma_ss_n64(s, sm90::desc_kmajor(qb, kk),
                             sm90::desc_kmajor(kt, kk), (j | kk) != 0);
      }
      sm90::wg_commit();
      if (j > 0) {
        sm90::wg_wait<1>();
        if (!pl.qres) release(pq);
        release(pk);
      }
      pq = eq;
      pk = e;
      e = rg.next(e);
    }
    sm90::wg_wait<0>();
    sm90::fence_regs(s);
    if (!pl.qres) release(pq);
    release(pk);
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
      const int c = kw + sm90::Rows::col(jj) + rw.cq;
      s[jj] = wide_logit<MASKED>(s[jj], sl, rows[sm90::Rows::hi(jj)],
                                 key0 + c, Nq, Nk, kx[jj], bhp, bs);
    }
    if constexpr (PAIR) {
      // the online softmax over both halves: the rows' maxima through
      // shared memory (in warpgroup order), then each half's p, its
      // partial row sum (l is summed per warpgroup, the halves added at
      // the end) and P in the shared tile
      float* xb = xch + (i & 1) * 128;
      float mx[2] = {NEG, NEG}, safe[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < NS; ++jj)
        mx[sm90::Rows::hi(jj)] = fmaxf(mx[sm90::Rows::hi(jj)], s[jj]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) mx[hh] = sm90::quad_max(mx[hh]);
      if ((threadIdx.x & 3) == 0) {
        xb[64 * wg + rw.r0] = mx[0];
        xb[64 * wg + rw.r1] = mx[1];
      }
      pair_sync();
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = hh ? rw.r1 : rw.r0;
        const float m_new = fmaxf(st.m[hh], fmaxf(xb[r], xb[64 + r]));
        safe[hh] = (m_new <= 0.5f * NEG) ? 0.f : m_new;
        alpha[hh] = (st.m[hh] <= 0.5f * NEG)
                        ? 0.f
                        : sm90::exp2_approx(st.m[hh] - safe[hh]);
        st.m[hh] = m_new;
      }
      unsigned char* pt = ptile + (i & 1) * kBoxB;
#pragma unroll
      for (int jj = 0; jj < NS; jj += 2) {
        const int hh = sm90::Rows::hi(jj);
        const float x0 = s[jj], x1 = s[jj + 1];
        const float f0 =
            (x0 <= 0.5f * NEG) ? 0.f : sm90::exp2_approx(x0 - safe[hh]);
        const float f1 =
            (x1 <= 0.5f * NEG) ? 0.f : sm90::exp2_approx(x1 - safe[hh]);
        const __nv_bfloat16 b0 = __float2bfloat16_rn(f0);
        const __nv_bfloat16 b1 = __float2bfloat16_rn(f1);
        sum[hh] += MASKED ? __bfloat162float(b0) + __bfloat162float(b1)
                          : f0 + f1;
        // element (r, k) of the 128B-swizzled 64 x 64 tile
        const int r = hh ? rw.r1 : rw.r0;
        const int k = kw + sm90::Rows::col(jj) + rw.cq;
        *reinterpret_cast<uint32_t*>(pt + r * 128 +
                                     ((((k >> 3) ^ (r & 7))) << 4) +
                                     (k & 7) * 2) = sm90::pack_bf16(b0, b1);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        st.l[hh] = st.l[hh] * alpha[hh] + sm90::quad_sum(sum[hh]);
      sm90::rescale(st, alpha);
      // the tile's P, written by both warpgroups, read by wgmma
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      pair_sync();
    } else {
      sm90::softmax_step<MASKED>(st, rw, s, p, alpha,
                                 [](float x, int) { return x; });
      sm90::rescale(st, alpha);
    }
    // O += P V over the CTA's V boxes: this warpgroup's own boxes by
    // wgmma, the others' only waited for and released
    for (int vb = 0; vb < min(my0, nbc); ++vb, e = rg.next(e)) {
      rg.wait(e);
      release(e);
    }
    Pos pv{0, 0};
    const unsigned char* pt = ptile + (i & 1) * kBoxB;
#pragma unroll
    for (int qq = 0; qq < NBW; ++qq) {
      if (qq < nbm) {
        rg.wait(e);
        float(&oq)[32] = *reinterpret_cast<float(*)[32]>(st.o + 32 * qq);
        sm90::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if constexpr (PAIR) {
            wgmma_ss_n64_mn(oq, sm90::desc_kmajor(pt, kk),
                            sm90::desc_mnmajor(rg.at(e), kk), 1);
          } else {
            const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                                   p[4 * kk + 3]};
            sm90::wgmma_rs_n64(oq, a, sm90::desc_mnmajor(rg.at(e), kk), 1);
          }
        }
        sm90::wg_commit();
        if (qq > 0) {
          sm90::wg_wait<1>();
          release(pv);
        }
        pv = e;
        e = rg.next(e);
      }
    }
    if (nbm > 0) {
      sm90::wg_wait<0>();
      sm90::fence_regs(st.o);
      sm90::fence_regs(p);  // the products read p until they complete
      release(pv);
    }
    for (int vb = my0 + nbm; vb < nbc; ++vb, e = rg.next(e)) {
      rg.wait(e);
      release(e);
    }
  }
  if constexpr (PAIR) {   // l = the halves' sums, in warpgroup order
    float* xb = xch + 256;
    if ((threadIdx.x & 3) == 0) {
      xb[64 * wg + rw.r0] = st.l[0];
      xb[64 * wg + rw.r1] = st.l[1];
    }
    pair_sync();
    st.l[0] = xb[rw.r0] + xb[64 + rw.r0];
    st.l[1] = xb[rw.r1] + xb[64 + rw.r1];
  }
  if (nbm <= 0) return;
  if (pl.splits > 1) {
    // a split's unnormalised O, and its m and l by the warpgroup that
    // holds lanes 0 (wide_merge adds the splits in order)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = rows[hh];
      if (row >= Nq) continue;
      const size_t r = (static_cast<size_t>(sp) * gridDim.y + bh) * Nq + row;
      float* dst = opart + r * P + 64 * (c0 + my0) + rw.cq;
#pragma unroll
      for (int qq = 0; qq < NBW; ++qq) {
        if (qq >= nbm) continue;
#pragma unroll
        for (int jj = 0; jj < 32; jj += 2) {
          if (sm90::Rows::hi(jj) != hh) continue;
          *reinterpret_cast<float2*>(dst + 64 * qq + sm90::Rows::col(jj)) =
              make_float2(st.o[32 * qq + jj], st.o[32 * qq + jj + 1]);
        }
      }
      if (c0 + my0 == 0 && (threadIdx.x & 3) == 0)
        *reinterpret_cast<float2*>(ml + 2 * r) =
            make_float2(st.m[hh], st.l[hh]);
    }
    return;
  }
  // O / l as bf16 pairs, the LSE by the CTA that holds lanes 0
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = rows[hh];
    if (row >= Nq) continue;
    const float inv = 1.f / (st.l[hh] == 0.f ? 1.f : st.l[hh]);
    bf16* dst = out + (static_cast<size_t>(bh) * Nq + row) * P +
                64 * (c0 + my0) + rw.cq;
#pragma unroll
    for (int qq = 0; qq < NBW; ++qq) {
      if (qq >= nbm) continue;
#pragma unroll
      for (int jj = 0; jj < 32; jj += 2) {
        if (sm90::Rows::hi(jj) != hh) continue;
        *reinterpret_cast<__nv_bfloat162*>(dst + 64 * qq +
                                           sm90::Rows::col(jj)) =
            __floats2bfloat162_rn(st.o[32 * qq + jj] * inv,
                                  st.o[32 * qq + jj + 1] * inv);
      }
    }
    if (lse != nullptr && c0 + my0 == 0 && (threadIdx.x & 3) == 0) {
      const float m = st.m[hh];
      lse[static_cast<size_t>(bh) * Nq + row] =
          (m <= 0.5f * NEG) ? NEG : (m + log2f(st.l[hh])) * LN2;
    }
  }
}

// -------------------------------------------------------------- f32 ----
//
// grid (ceil(Nq / rows), B * H, groups * splits); 4 RT warps, rows 16 RT.
// Lane slice ls of CTA z holds O's 32-lane boxes [(4 z + ls) nbw, ... +
// nbw) (fewer or none at the end).  Each warp splits P into hi and lo
// once per key tile, or per V box where that would not fit its registers
// (twelve warps: 168 a thread).
template <bool MASKED, int NBW, int RT>
__global__ void __launch_bounds__(128 * RT, 1)
fwd_f32(const __grid_constant__ CUtensorMap mqh,
        const __grid_constant__ CUtensorMap mql,
        const __grid_constant__ CUtensorMap mkh,
        const __grid_constant__ CUtensorMap mkl,
        const __grid_constant__ CUtensorMap mvh,
        const __grid_constant__ CUtensorMap mvl, const float* __restrict__ bl,
        const int* __restrict__ list, const int* __restrict__ count,
        int lists_per_b, const float* __restrict__ bias, BiasStrides bs,
        const unsigned char* __restrict__ mask, int ldm,
        float* __restrict__ out, float* __restrict__ lse,
        float* __restrict__ opart, float* __restrict__ ml, int H, int Nq,
        int Nk, int P, int nt, float sl, Plan pl) {
  constexpr int R = 16 * RT, NW = 4 * RT, NO = 16 * NBW;
  // P split once per key tile where the registers allow it (at twelve
  // warps with four boxes of O it spilled)
  constexpr bool HOIST = RT == 2 || NBW <= 3;
  constexpr int KU = HOIST ? 8 : 2;        // P V's unroll over 8-key steps
  constexpr uint32_t kQB = R * 128;        // a q plane box: R rows x 32
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_base(smem_raw);
  float* logits = reinterpret_cast<float*>(base);
  const uint32_t slot = 2 * kQB + 2 * kBoxF;
  unsigned char* ring = base + 2 * R * LROW * 4;
  Ring rg{ring, reinterpret_cast<uint64_t*>(ring + pl.stages * slot), slot,
          pl.stages};
  const int q0 = blockIdx.x * R, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int sp = blockIdx.z / pl.groups, zg = blockIdx.z - sp * pl.groups;
  const int lidx = b * lists_per_b + (lists_per_b > 1 ? blockIdx.x : 0);
  int n = count[lidx];
  const int* tiles = list + static_cast<size_t>(lidx) * nt;
  if (pl.splits > 1) {
    const int2 run = split_run(tiles, n, sp, pl.split_tiles);
    tiles += run.x;
    n = run.y - run.x;
  }
  const int nb = pl.nb, c0 = zg * 4 * pl.nbw;
  const int nbc = min(4 * pl.nbw, nb - c0);
  const Seq seq(nb, 4 * pl.nbw);
  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.stages; ++s) {
      sm90::mbar_init(rg.bars + 1 + s, 1);
      sm90::mbar_init(rg.bars + 1 + pl.stages + s, NW * 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the issuing thread loads each entry once the CTA has released the one
  // ``stages`` before it (the same slot)
  Issuer iss(tiles, n, seq.per_tile);
  auto issue = [&]() {
    const int r = iss.r, key0 = iss.key;
    uint64_t* bar = rg.full(iss.at);
    unsigned char* dst = rg.at(iss.at);
    if (r < seq.ns) {
      sm90::mbar_expect_tx(bar, 2 * kQB + 2 * kBoxF);
      sm90::tma_load_3d(dst, &mqh, bar, 32 * r, q0, bh);
      sm90::tma_load_3d(dst + kQB, &mql, bar, 32 * r, q0, bh);
      sm90::tma_load_3d(dst + 2 * kQB, &mkh, bar, 32 * r, key0, bh);
      sm90::tma_load_3d(dst + 2 * kQB + kBoxF, &mkl, bar, 32 * r, key0, bh);
    } else {   // round (r - ns) / 4 of slice (r - ns) % 4
      const int rv = r - seq.ns;
      const int box = (rv & 3) * pl.nbw + (rv >> 2);
      if (box >= nbc) {            // past a short slice: an empty entry
        sm90::mbar_expect_tx(bar, 0);
      } else {
        sm90::mbar_expect_tx(bar, 2 * kBoxF);
        sm90::tma_load_3d(dst, &mvh, bar, 32 * (c0 + box), key0, bh);
        sm90::tma_load_3d(dst + kBoxF, &mvl, bar, 32 * (c0 + box), key0,
                          bh);
      }
    }
    iss.advance(rg);
  };
  const bool issuer = threadIdx.x == 0;
  auto release = [&](Pos e) {
    sm90::mbar_arrive(rg.empty(e));
    if (issuer && iss.left > 0) {
      sm90::mbar_wait(rg.empty(e), e.ph);
      issue();
    }
  };
  if (issuer)
    for (int k = 0; k < pl.stages && iss.left > 0; ++k) issue();

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rt = w % RT, part = w / RT;     // key quarter (S), slice (P V)
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, rr = lane & 7;
  // ldmatrix rows (flash_sm90.cuh's qk): A's four 8x4 matrices are (rows
  // +0 / +8) x (lanes +0 / +4), B's (keys +0, lanes +0 / +4) of n-tile
  // 0, then of n-tile 1
  const int arow = 16 * rt + rr + ((mi & 1) << 3), ad = (mi >> 1) << 2;
  const int brow = 16 * part + rr + ((mi >> 1) << 3), bd = (mi & 1) << 2;
  const int my0 = part * pl.nbw, nbm = max(0, min(pl.nbw, nbc - my0));
  const float* kb = MASKED ? nullptr : bl + static_cast<size_t>(b) * nt * KT;
  const float* bhp = bias ? bias + b * bs.b + h * bs.h : nullptr;
  const unsigned char* mrow0 =
      MASKED ? mask + static_cast<size_t>(b) * Nq * ldm : nullptr;
  sm90::RowStateN<NO> st;
  st.zero();
  Pos e{0, 0};
  int knext = n > 0 ? __ldg(tiles) * KT : 0;
  for (int i = 0; i < n; ++i) {
    const int key0 = knext;
    if (i + 1 < n) knext = __ldg(tiles + i + 1) * KT;
    float* lt = logits + (i & 1) * R * LROW;
    {
      // the keys' biases or mask bytes, read while S forms
      float kx[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          kx[hh][q] = key_extra<MASKED>(
              q0 + 16 * rt + g + 4 * (q & 2),
              key0 + 16 * part + 8 * hh + 2 * t + (q & 1), Nq, Nk, kb, mrow0,
              ldm);
      // S of rows 16 rt .. + 16, keys 16 part .. + 16: hi.hi per 8-lane
      // step added in f32 round-to-nearest, lo.hi + hi.lo in the tensor
      // core (two accumulators, even and odd steps, for two chains of
      // products), joined at the end
      float s[2][4] = {}, lo[2][2][4] = {};
      for (int j = 0; j < nb; ++j, e = rg.next(e)) {
        rg.wait(e);
        const uint32_t qh = sm90::smem_u32(rg.at(e)), ql = qh + kQB;
        const uint32_t kh = qh + 2 * kQB, kl = kh + kBoxF;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t xh[4], xl[4], yh[4], yl[4];
          const uint32_t oa = f32e::off<R>(arow, 8 * kk + ad);
          const uint32_t ob = f32e::off<KT>(brow, 8 * kk + bd);
          f32e::ldsm_x4(xh, qh + oa);
          f32e::ldsm_x4(xl, ql + oa);
          f32e::ldsm_x4(yh, kh + ob);
          f32e::ldsm_x4(yl, kl + ob);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float* lc = lo[kk & 1][hh];
            f32e::mma(lc, xl, yh[2 * hh], yh[2 * hh + 1]);
            f32e::mma(lc, xh, yl[2 * hh], yl[2 * hh + 1]);
            float tt[4];
            f32e::mma0(tt, xh, yh[2 * hh], yh[2 * hh + 1]);
#pragma unroll
            for (int q = 0; q < 4; ++q) s[hh][q] = __fadd_rn(s[hh][q], tt[q]);
          }
        }
        release(e);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          s[hh][q] = __fadd_rn(s[hh][q],
                               __fadd_rn(lo[0][hh][q], lo[1][hh][q]));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int q = 0; q < 4; q += 2) {
          const int row = 16 * rt + g + 4 * q;    // q = 2: row + 8
          const int c = 16 * part + 8 * hh + 2 * t;
          const float x0 = wide_logit<MASKED>(s[hh][q], sl, q0 + row,
                                              key0 + c, Nq, Nk, kx[hh][q],
                                              bhp, bs);
          const float x1 = wide_logit<MASKED>(s[hh][q + 1], sl, q0 + row,
                                              key0 + c + 1, Nq, Nk,
                                              kx[hh][q + 1], bhp, bs);
          *reinterpret_cast<float2*>(lt + row * LROW + c) =
              make_float2(x0, x1);
        }
    }
    __syncthreads();   // the tile's logits are whole
    // the softmax step of rows 16 rt + g (+ 8) over the tile's 64 keys
    float x[32], alpha[2];
#pragma unroll
    for (int q = 0; q < 32; q += 2) {
      const int row = 16 * rt + g + 8 * sm90::Rows::hi(q);
      const float2 v2 = *reinterpret_cast<const float2*>(
          lt + row * LROW + sm90::Rows::col(q) + 2 * t);
      x[q] = v2.x;
      x[q + 1] = v2.y;
    }
    f32e::softmax_step(st, x, alpha);
    sm90::rescale(st, alpha);
    // P's A fragments (keys of each 8-key step in the order 0, 2, 4, 6,
    // 1, 3, 5, 7: the thread's registers as they are), hi and lo
    uint32_t ph[HOIST ? 8 : 1][4], pl2[HOIST ? 8 : 1][4];
    if constexpr (HOIST) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const float a[4] = {x[4 * kk], x[4 * kk + 2], x[4 * kk + 1],
                            x[4 * kk + 3]};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          f32e::split(a[q], ph[kk][q], pl2[kk][q]);
      }
    }
    // O += P V: the V boxes in rounds of one box of each slice (a short
    // slice's missing box an empty entry), so that the four slices work
    // at once
#pragma unroll
    for (int qq = 0; qq < NBW; ++qq) {
      for (int s4 = 0; s4 < 4; ++s4, e = rg.next(e)) {
        rg.wait(e);
        if (s4 == part && qq < nbm) {
          const uint32_t vh = sm90::smem_u32(rg.at(e)), vl = vh + kBoxF;
#pragma unroll KU
          for (int kk = 0; kk < 8; ++kk) {
            uint32_t ah[4], al[4];
            if constexpr (HOIST) {
#pragma unroll
              for (int q = 0; q < 4; ++q) ah[q] = ph[kk][q], al[q] = pl2[kk][q];
            } else {
              const float a[4] = {x[4 * kk], x[4 * kk + 2], x[4 * kk + 1],
                                  x[4 * kk + 3]};
#pragma unroll
              for (int q = 0; q < 4; ++q) f32e::split(a[q], ah[q], al[q]);
            }
            const int r = 8 * kk + 2 * t;
#pragma unroll
            for (int jn = 0; jn < 4; ++jn) {
              const uint32_t o0 = f32e::off<KT>(r, 8 * jn + g);
              const uint32_t o1 = f32e::off<KT>(r + 1, 8 * jn + g);
              const uint32_t h0 = __float_as_uint(f32e::lds(vh + o0));
              const uint32_t l0 = __float_as_uint(f32e::lds(vl + o0));
              const uint32_t h1 = __float_as_uint(f32e::lds(vh + o1));
              const uint32_t l1 = __float_as_uint(f32e::lds(vl + o1));
              f32e::mma3_rn(st.o + 16 * qq + 4 * jn, ah, al, h0, h1, l0, l1);
            }
          }
        }
        release(e);
      }
    }
  }
  if (pl.splits > 1) {
    // a split's unnormalised O, and its m and l by the warps that hold
    // lanes 0 (wide_merge adds the splits in order)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + 16 * rt + g + 8 * hh;
      if (row >= Nq) continue;
      const size_t r = (static_cast<size_t>(sp) * gridDim.y + bh) * Nq + row;
      float* dst = opart + r * P + 32 * (c0 + my0) + 2 * t;
#pragma unroll
      for (int qq = 0; qq < NBW; ++qq) {
        if (qq >= nbm) continue;
#pragma unroll
        for (int jj = 0; jj < 16; jj += 2) {
          if (sm90::Rows::hi(jj) != hh) continue;
          *reinterpret_cast<float2*>(dst + 32 * qq + sm90::Rows::col(jj)) =
              make_float2(st.o[16 * qq + jj], st.o[16 * qq + jj + 1]);
        }
      }
      if (c0 + my0 == 0 && t == 0)
        *reinterpret_cast<float2*>(ml + 2 * r) =
            make_float2(st.m[hh], st.l[hh]);
    }
    return;
  }
  // O / l, the LSE by the warps that hold lanes 0
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + 16 * rt + g + 8 * hh;
    if (row >= Nq) continue;
    const float inv = 1.f / (st.l[hh] == 0.f ? 1.f : st.l[hh]);
    float* dst = out + (static_cast<size_t>(bh) * Nq + row) * P +
                 32 * (c0 + my0) + 2 * t;
#pragma unroll
    for (int qq = 0; qq < NBW; ++qq) {
      if (qq >= nbm) continue;
#pragma unroll
      for (int jj = 0; jj < 16; jj += 2) {
        if (sm90::Rows::hi(jj) != hh) continue;
        *reinterpret_cast<float2*>(dst + 32 * qq + sm90::Rows::col(jj)) =
            make_float2(st.o[16 * qq + jj] * inv,
                        st.o[16 * qq + jj + 1] * inv);
      }
    }
    if (lse != nullptr && c0 + my0 == 0 && t == 0) {
      const float m = st.m[hh];
      lse[static_cast<size_t>(bh) * Nq + row] =
          (m <= 0.5f * NEG) ? NEG : (m + log2f(st.l[hh])) * LN2;
    }
  }
}

// ------------------------------------------------------------- K5 ----
//
// f32 FMA over 64-lane chunks (the backward is not yet redesigned): a CTA
// of 256 threads owns a 64-row tile and one 64-lane chunk of a gradient;
// each 64 x 64 chunk of an operand is streamed through shared memory
// (transposed, [lane][row], so that each thread reads four rows as one
// float4), and each thread holds a 4 x 4 sub-tile.

constexpr int TR = 64;        // rows per CTA: queries (keys in dk/dv)
constexpr int TC = 64;        // columns per tile: keys (queries in dk/dv)
constexpr int DC = 64;        // head-dim lanes per chunk
constexpr int LDS = 68;       // shared row stride in floats: float4-aligned,
                              // transposed stores free of bank conflicts
constexpr int NT = 256;       // 16 x 16 threads, a 4 x 4 sub-tile each
constexpr int TILE = DC * LDS;
constexpr int SMEM = 3 * TILE * 4;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// A 64 x 64 chunk (rows r0.., lanes c0..) of a (n, P) matrix into s
// transposed, s[lane * LDS + row]; rows past n read 0.  Each half-warp
// takes 16 rows of 4 lanes: the stores of a warp hit 32 banks.
template <typename T>
__device__ __forceinline__ void load_t(float* s, const T* src, int r0, int n,
                                       int P, int c0) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r = (lane & 15) + 16 * (w & 3);
  const bool ok = r0 + r < n;
  const T* row = src + static_cast<size_t>(r0 + r) * P + c0;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int d = 4 * ((lane >> 4) + 2 * (w >> 2) + 4 * it);
    const float4 x = ok ? load4(row + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    s[(d + 0) * LDS + r] = x.x;
    s[(d + 1) * LDS + r] = x.y;
    s[(d + 2) * LDS + r] = x.z;
    s[(d + 3) * LDS + r] = x.w;
  }
}

// The same chunk as it lies, s[row * LDS + lane].
template <typename T>
__device__ __forceinline__ void load_n(float* s, const T* src, int r0, int n,
                                       int P, int c0) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int idx = it * NT + threadIdx.x;
    const int r = idx >> 4, d = (idx & 15) * 4;
    const float4 x = r0 + r < n
        ? load4(src + static_cast<size_t>(r0 + r) * P + c0 + d)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(s + r * LDS + d) = x;
  }
}

// acc[i][j] += sum_kk a[kk][4 ty + i] * b[kk][4 tx + j], kk in order.
__device__ __forceinline__ void mma(float (&acc)[4][4], const float* a,
                                    const float* b) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 8
  for (int kk = 0; kk < DC; ++kk) {
    const float4 x = *reinterpret_cast<const float4*>(a + kk * LDS + 4 * ty);
    const float4 y = *reinterpret_cast<const float4*>(b + kk * LDS + 4 * tx);
    const float xa[4] = {x.x, x.y, x.z, x.w};
    const float ya[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], ya[j], acc[i][j]);
  }
}

// s[(4 tx + j) * LDS + 4 ty + i] = p[i][j]: the sub-tile transposed, as
// the A operand of the next product.
__device__ __forceinline__ void store_t(float* s, const float (&p)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(s + (4 * tx + j) * LDS + 4 * ty) =
        make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// K5's logit of query qi and key kj from the product s: s * scale, then
// the dense bias, then the key row; finfo.min past Nk.
__device__ __forceinline__ float k5_logit(float s, float scale, int b, int h,
                                          int qi, int kj, int Nq, int Nk,
                                          const float* bias, BiasStrides bs,
                                          const float* row) {
  if (kj >= Nk) return NEG;
  float x = __fmul_rn(s, scale);
  if (bias != nullptr && qi < Nq)
    x = __fadd_rn(x, bias[b * bs.b + h * bs.h + qi * bs.q + kj * bs.k]);
  if (row != nullptr) x = __fadd_rn(x, row[static_cast<size_t>(b) * Nk + kj]);
  return x;
}

// K5's dq: rows are queries.
template <typename T>
__global__ void __launch_bounds__(NT)
wide_dq(const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ g,
        const float* __restrict__ lse, const float* __restrict__ dvec,
        const float* __restrict__ bias, BiasStrides bs,
        const float* __restrict__ row, float* __restrict__ dq, int H, int Nq,
        int Nk, int P, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;
  float* sb = smem + TILE;
  float* sp = smem + 2 * TILE;
  const int q0 = blockIdx.x * TR, bh = blockIdx.y, c0 = blockIdx.z * DC;
  const int b = bh / H, h = bh % H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t qo = static_cast<size_t>(bh) * Nq * P;
  const size_t ko = static_cast<size_t>(bh) * Nk * P;
  float ls[4], dv4[4];
  bool dead[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    ls[i] = qi < Nq ? lse[static_cast<size_t>(bh) * Nq + qi] : NEG;
    dv4[i] = qi < Nq ? dvec[static_cast<size_t>(bh) * Nq + qi] : 0.f;
    dead[i] = ls[i] <= NEG / 2 || ls[i] >= -NEG / 2;
  }
  float acc[4][4] = {};
  const int ntiles = (Nk + TC - 1) / TC;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * TC;
    float s[4][4] = {}, dp[4][4] = {};
    for (int dc = 0; dc < P; dc += DC) {
      __syncthreads();
      load_t(sa, q + qo, q0, Nq, P, dc);
      load_t(sb, k + ko, k0, Nk, P, dc);
      __syncthreads();
      mma(s, sa, sb);
    }
    for (int dc = 0; dc < P; dc += DC) {
      __syncthreads();
      load_t(sa, g + qo, q0, Nq, P, dc);
      load_t(sb, v + ko, k0, Nk, P, dc);
      __syncthreads();
      mma(dp, sa, sb);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = k5_logit(s[i][j], scale, b, h, qi, k0 + 4 * tx + j,
                                 Nq, Nk, bias, bs, row);
        const float p = (dead[i] || x <= NEG / 2) ? 0.f : expf(x - ls[i]);
        s[i][j] = round_to<T>(
            __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i][j], dv4[i])), scale));
      }
    }
    __syncthreads();
    store_t(sp, s);
    load_n(sb, k + ko, k0, Nk, P, c0);
    __syncthreads();
    mma(acc, sp, sb);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= Nq) continue;
    float* dst = dq + (static_cast<size_t>(bh) * Nq + qi) * P + c0 + 4 * tx;
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// K5's dk and dv: rows are keys, columns queries.
template <typename T>
__global__ void __launch_bounds__(NT)
wide_dkdv(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ g,
          const float* __restrict__ lse, const float* __restrict__ dvec,
          const float* __restrict__ bias, BiasStrides bs,
          const float* __restrict__ row, float* __restrict__ dk,
          float* __restrict__ dv, int H, int Nq, int Nk, int P, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;
  float* sb = smem + TILE;
  float* sp = smem + 2 * TILE;
  const int k0 = blockIdx.x * TR, bh = blockIdx.y, c0 = blockIdx.z * DC;
  const int b = bh / H, h = bh % H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t qo = static_cast<size_t>(bh) * Nq * P;
  const size_t ko = static_cast<size_t>(bh) * Nk * P;
  float ak[4][4] = {}, av[4][4] = {};
  const int ntiles = (Nq + TC - 1) / TC;
  for (int qt = 0; qt < ntiles; ++qt) {
    const int q0 = qt * TC;
    float ls[4], dv4[4];
    bool dead[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qj = q0 + 4 * tx + j;
      ls[j] = qj < Nq ? lse[static_cast<size_t>(bh) * Nq + qj] : NEG;
      dv4[j] = qj < Nq ? dvec[static_cast<size_t>(bh) * Nq + qj] : 0.f;
      dead[j] = ls[j] <= NEG / 2 || ls[j] >= -NEG / 2;
    }
    float s[4][4] = {}, dp[4][4] = {};
    for (int dc = 0; dc < P; dc += DC) {
      __syncthreads();
      load_t(sa, k + ko, k0, Nk, P, dc);
      load_t(sb, q + qo, q0, Nq, P, dc);
      __syncthreads();
      mma(s, sa, sb);
    }
    for (int dc = 0; dc < P; dc += DC) {
      __syncthreads();
      load_t(sa, v + ko, k0, Nk, P, dc);
      load_t(sb, g + qo, q0, Nq, P, dc);
      __syncthreads();
      mma(dp, sa, sb);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kj = k0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qj = q0 + 4 * tx + j;
        const float x = k5_logit(s[i][j], scale, b, h, qj, kj, Nq, Nk, bias,
                                 bs, row);
        const float p = (qj >= Nq || dead[j] || x <= NEG / 2)
                            ? 0.f : expf(x - ls[j]);
        s[i][j] = round_to<T>(
            __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i][j], dv4[j])), scale));
        dp[i][j] = round_to<T>(p);
      }
    }
    __syncthreads();
    store_t(sp, s);
    load_n(sb, q + qo, q0, Nq, P, c0);
    __syncthreads();
    mma(ak, sp, sb);
    __syncthreads();
    store_t(sp, dp);
    load_n(sb, g + qo, q0, Nq, P, c0);
    __syncthreads();
    mma(av, sp, sb);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + 4 * ty + i;
    if (kj >= Nk) continue;
    const size_t at = (static_cast<size_t>(bh) * Nk + kj) * P + c0 + 4 * tx;
    *reinterpret_cast<float4*>(dk + at) =
        make_float4(ak[i][0], ak[i][1], ak[i][2], ak[i][3]);
    *reinterpret_cast<float4*>(dv + at) =
        make_float4(av[i][0], av[i][1], av[i][2], av[i][3]);
  }
}

// y = x cos + R(x) sin in f32, rounded to T (R: rotate-half within each
// half of P, ops/rope.py::_rotate_half_2d); x, y (B, H, N, P), the tables
// (B, N, P).
template <typename T>
__global__ void wide_rope(const T* __restrict__ x, const float* __restrict__ c,
                          const float* __restrict__ sn, T* __restrict__ y,
                          int H, int N, int P, long long total) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i >= total) return;
  const int d = static_cast<int>(i % P);
  const long long tok = i / P;
  const long long n = tok % N, b = tok / (static_cast<long long>(N) * H);
  const int Q = P / 4;
  const bool odd = (d / Q) & 1;
  const float partner = to_f(x[odd ? i - Q : i + Q]);
  const size_t t = (static_cast<size_t>(b) * N + n) * P + d;
  y[i] = from_f<T>(__fadd_rn(__fmul_rn(to_f(x[i]), c[t]),
                             __fmul_rn(odd ? partner : -partner, sn[t])));
}

// Dvec = rowsum(dO * O) over (rows, P) f32: one warp a row, lane sums in
// order, then a fixed shuffle tree.
__global__ void wide_dvec(const float* __restrict__ o,
                          const float* __restrict__ g,
                          float* __restrict__ dvec, long long rows, int P) {
  const long long r = blockIdx.x * 8LL + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const float* a = o + r * P;
  const float* b = g + r * P;
  float s = 0.f;
  for (int d = lane; d < P; d += 32) s = __fadd_rn(s, __fmul_rn(a[d], b[d]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  if (lane == 0) dvec[r] = s;
}

// ------------------------------------------------------- pre-passes ----

// x (B, H, N, P) f32 contiguous, rotated in f32 by (B, N, P) tables when
// ``c`` is given (wide_rope's arithmetic), into the TF32 planes hi =
// tf32(x) and lo = tf32(x - hi): the f32 forward's q, k and v.  Four
// lanes a thread (P and its quarter P / 4 are multiples of 16).
__global__ void wide_split(const float* __restrict__ x,
                           const float* __restrict__ c,
                           const float* __restrict__ sn,
                           float* __restrict__ hi, float* __restrict__ lo,
                           int H, int N, int P, long long total) {
  const long long i = 4 * (blockIdx.x * static_cast<long long>(blockDim.x)
                           + threadIdx.x);
  if (i >= total) return;
  const float4 xv = *reinterpret_cast<const float4*>(x + i);
  float val[4] = {xv.x, xv.y, xv.z, xv.w};
  if (c != nullptr) {
    const int d = static_cast<int>(i % P);
    const long long tok = i / P;
    const long long n = tok % N, b = tok / (static_cast<long long>(N) * H);
    const int Q = P / 4;
    const bool odd = (d / Q) & 1;
    const float4 pv = *reinterpret_cast<const float4*>(x + (odd ? i - Q
                                                                : i + Q));
    const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
    const size_t t = (static_cast<size_t>(b) * N + n) * P + d;
    const float4 cv = *reinterpret_cast<const float4*>(c + t);
    const float4 sv = *reinterpret_cast<const float4*>(sn + t);
    const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
    const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      val[j] = __fadd_rn(__fmul_rn(val[j], ca[j]),
                         __fmul_rn(odd ? pa[j] : -pa[j], sa[j]));
  }
  float h4[4], l4[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t h_, l_;
    f32e::split(val[j], h_, l_);
    h4[j] = __uint_as_float(h_);
    l4[j] = __uint_as_float(l_);
  }
  *reinterpret_cast<float4*>(hi + i) = make_float4(h4[0], h4[1], h4[2], h4[3]);
  *reinterpret_cast<float4*>(lo + i) = make_float4(l4[0], l4[1], l4[2], l4[3]);
}

// K3's plan: one block per (row tile of ``R`` rows, batch); each thread
// takes (row, key tile) pairs and marks the tile live where the row has an
// open (0) mask byte in it (whole tiles of 16-byte aligned rows as four
// 16-byte words: a word of four blocked bytes is 0x01010101), then warp 0
// writes the live tiles in order and their count (list (B, nrt, nt),
// count (B, nrt)).
__global__ void mask_tiles(const unsigned char* __restrict__ mask, int ldm,
                           int* __restrict__ list, int* __restrict__ count,
                           int Nq, int Nk, int R, int nt) {
  extern __shared__ int live_tile[];
  const int rt = blockIdx.x, b = blockIdx.y, nrt = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = rt * R, rows = min(R, Nq - r0);
  const unsigned char* m = mask + (static_cast<size_t>(b) * Nq + r0) * ldm;
  for (int t = threadIdx.x; t < nt; t += blockDim.x) live_tile[t] = 0;
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * nt; idx += blockDim.x) {
    const int t = idx / rows, r = idx - t * rows;
    const int k0 = t * KT, kn = min(KT, Nk - k0);
    const unsigned char* row = m + static_cast<size_t>(r) * ldm + k0;
    bool open = false;
    if (kn == KT && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint4 x = reinterpret_cast<const uint4*>(row)[w];
        open |= (x.x & x.y & x.z & x.w) != 0x01010101u;
      }
    } else {
      for (int c = 0; c < kn; ++c) open |= row[c] == 0;
    }
    if (open) atomicOr(live_tile + t, 1);   // commutative: order-free
  }
  __syncthreads();
  if (warp == 0) {
    int* out = list + (static_cast<size_t>(b) * nrt + rt) * nt;
    int n = 0;
    for (int t0 = 0; t0 < nt; t0 += 32) {
      const int t = t0 + lane;
      const bool f = t < nt && live_tile[t];
      const unsigned bits = __ballot_sync(0xffffffffu, f);
      if (f) out[n + __popc(bits & ((1u << lane) - 1))] = t;
      n += __popc(bits);
    }
    if (lane == 0) count[b * nrt + rt] = n;
  }
}

template <typename T>
cudaError_t rope(const void* x, const float* c, const float* s, void* y,
                 int B, int H, int N, int P, cudaStream_t st) {
  const long long total = static_cast<long long>(B) * H * N * P;
  wide_rope<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      static_cast<const T*>(x), c, s, static_cast<T*>(y), H, N, P, total);
  return cudaGetLastError();
}

cudaError_t rope_any(int bf16, const void* x, const float* c, const float* s,
                     void* y, int B, int H, int N, int P, cudaStream_t st) {
  return bf16 ? rope<__nv_bfloat16>(x, c, s, y, B, H, N, P, st)
              : rope<float>(x, c, s, y, B, H, N, P, st);
}

BiasStrides strides_of(const long long* bstr) {
  return bstr == nullptr ? BiasStrides{0, 0, 0, 0}
                         : BiasStrides{bstr[0], bstr[1], bstr[2], bstr[3]};
}

// The splits of a split-KV forward merged in order: one thread per four
// lanes of a row; m (log2 units) and l of split s in ml, its unnormalised
// O in part (splits, rows, P).  w_s = exp2(m_s - max m), 0 for a split
// with no live key; O = sum w_s O_s / sum w_s l_s (0 for a row with no
// live key), the LSE (max m + log2 l) ln 2 (finfo.min there).
template <typename T>
__global__ void wide_merge(const float* __restrict__ part,
                           const float* __restrict__ ml, T* __restrict__ out,
                           float* __restrict__ lse, long long rows, int P,
                           int splits) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
  const int per_row = P / 4;
  if (idx >= rows * per_row) return;
  const long long row = idx / per_row;
  const int c = static_cast<int>(idx % per_row) * 4;
  float M = NEG;
  for (int sp = 0; sp < splits; ++sp)
    M = fmaxf(M, ml[2 * (sp * rows + row)]);
  const float safe = M <= 0.5f * NEG ? 0.f : M;
  float L = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
  for (int sp = 0; sp < splits; ++sp) {
    const float m = ml[2 * (sp * rows + row)];
    const float w = m <= 0.5f * NEG ? 0.f : sm90::exp2_approx(m - safe);
    L = __fadd_rn(L, __fmul_rn(ml[2 * (sp * rows + row) + 1], w));
    const float4 x = *reinterpret_cast<const float4*>(
        part + (sp * rows + row) * P + c);
    o[0] = __fadd_rn(o[0], __fmul_rn(x.x, w));
    o[1] = __fadd_rn(o[1], __fmul_rn(x.y, w));
    o[2] = __fadd_rn(o[2], __fmul_rn(x.z, w));
    o[3] = __fadd_rn(o[3], __fmul_rn(x.w, w));
  }
  const float inv = 1.f / (L == 0.f ? 1.f : L);
#pragma unroll
  for (int k = 0; k < 4; ++k) out[row * P + c + k] = from_f<T>(o[k] * inv);
  if (lse != nullptr && c == 0)
    lse[row] = M <= 0.5f * NEG ? NEG : (M + log2f(L)) * LN2;
}

// ------------------------------------------------------------- host ----

struct Fwd {
  const void *q, *k, *v;
  const float *bias;
  BiasStrides bs;
  const float* bl;
  const unsigned char* mask;
  int ldm, lists_per_b;
  const int *list, *count;
  void* out;
  float *lse, *part, *ml;
  int B, H, Nq, Nk, P, nt;
  float sl;
  Plan pl;
  cudaStream_t st;
};

template <bool MASKED, int NBW, bool PAIR>
cudaError_t launch_bf16(const Fwd& a) {
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  const int BH = a.B * a.H;
  if ((err = sm90::make_map(&mq, a.q, BH, a.Nq, a.P, KT)) != cudaSuccess ||
      (err = sm90::make_map(&mk, a.k, BH, a.Nk, a.P, KT)) != cudaSuccess ||
      (err = sm90::make_map(&mv, a.v, BH, a.Nk, a.P, KT)) != cudaSuccess)
    return err;
  auto kern = fwd_bf16<MASKED, NBW, PAIR>;
  if ((err = prepare(kern, a.pl.smem)) != cudaSuccess) return err;
  const dim3 grid((a.Nq + KT - 1) / KT, BH, a.pl.groups * a.pl.splits);
  kern<<<grid, a.pl.per_cta * 128, a.pl.smem, a.st>>>(
      mq, mk, mv, a.bl, a.list, a.count, a.lists_per_b, a.bias, a.bs, a.mask,
      a.ldm, static_cast<bf16*>(a.out), a.lse, a.part, a.ml, a.H, a.Nq, a.Nk,
      a.P, a.nt, a.sl, a.pl);
  return cudaGetLastError();
}

template <bool MASKED, int NBW, int RT>
cudaError_t launch_f32(const Fwd& a, float* const* planes) {
  CUtensorMap m[6];
  cudaError_t err;
  const int BH = a.B * a.H;
  for (int i = 0; i < 6; ++i) {
    const int N = i < 2 ? a.Nq : a.Nk, rows = i < 2 ? 16 * RT : KT;
    if ((err = f32e::make_map(&m[i], planes[i], BH, N, a.P, rows)) !=
        cudaSuccess)
      return err;
  }
  auto kern = fwd_f32<MASKED, NBW, RT>;
  if ((err = prepare(kern, a.pl.smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(
           kern, cudaFuncAttributePreferredSharedMemoryCarveout,
           cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
    return err;
  const dim3 grid((a.Nq + a.pl.rows - 1) / a.pl.rows, BH,
                  a.pl.groups * a.pl.splits);
  kern<<<grid, 128 * RT, a.pl.smem, a.st>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], a.bl, a.list, a.count,
      a.lists_per_b, a.bias, a.bs, a.mask, a.ldm, static_cast<float*>(a.out),
      a.lse, a.part, a.ml, a.H, a.Nq, a.Nk, a.P, a.nt, a.sl, a.pl);
  return cudaGetLastError();
}

template <bool MASKED>
cudaError_t dispatch(const Fwd& a, bool f32, float* const* planes) {
  const bool pair = a.pl.per_cta == 2;
  constexpr int RT = MASKED ? 2 : 3;   // wide_plan's rows: K3 32, K4 48
  switch (a.pl.nbw + 10 * (f32 ? 0 : 1 + pair) + 100 * (a.pl.rows / 16)) {
    case 100 * RT + 2: return launch_f32<MASKED, 2, RT>(a, planes);
    case 100 * RT + 3: return launch_f32<MASKED, 3, RT>(a, planes);
    case 100 * RT + 4: return launch_f32<MASKED, 4, RT>(a, planes);
    case 413: return launch_bf16<MASKED, 3, false>(a);
    case 414: return launch_bf16<MASKED, 4, false>(a);
    case 423: return launch_bf16<MASKED, 3, true>(a);
    case 424: return launch_bf16<MASKED, 4, true>(a);
  }
  return cudaErrorInvalidValue;
}

// A plan this source can run: the wrapper's numbers against its own
// bounds and shared-memory formula.
bool plan_ok(const Plan& p, int P, bool f32) {
  const int box = f32 ? 32 : 64;
  const bool cta = f32 ? p.per_cta == 4 && p.nbw >= 2 &&
                             (p.rows == 32 || p.rows == 48)
                       : (p.per_cta == 1 || p.per_cta == 2) && p.rows == KT &&
                             p.nbw >= 3;
  return cta && p.nb * box == P && p.nbw <= 4 &&
         (p.groups - 1) * p.per_cta * p.nbw < p.nb &&
         p.groups * p.per_cta * p.nbw >= p.nb && p.splits >= 1 &&
         p.split_tiles >= 1 && p.groups * p.splits <= 65535 &&
         p.stages >= 2 && p.stages <= MAX_STAGES &&
         (!f32 || p.qres == 0) && p.smem == smem_bytes(p, f32) &&
         p.smem <= SMEM_LIMIT;
}

template <typename T>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* g,
                const float* lse, const float* dvec, const float* bias,
                BiasStrides bs, const float* row, float* dq, float* dk,
                float* dv, int B, int H, int Nq, int Nk, int P, float scale,
                cudaStream_t st) {
  cudaError_t e = prepare(wide_dq<T>, SMEM);
  if (e == cudaSuccess) e = prepare(wide_dkdv<T>, SMEM);
  if (e != cudaSuccess) return e;
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *tg = static_cast<const T*>(g);
  wide_dq<T><<<dim3((Nq + TR - 1) / TR, B * H, P / DC), NT, SMEM, st>>>(
      tq, tk, tv, tg, lse, dvec, bias, bs, row, dq, H, Nq, Nk, P, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wide_dkdv<T><<<dim3((Nk + TR - 1) / TR, B * H, P / DC), NT, SMEM, st>>>(
      tq, tk, tv, tg, lse, dvec, bias, bs, row, dk, dv, H, Nq, Nk, P, scale);
  return cudaGetLastError();
}

}  // namespace

P3_ERROR_STRING_FN

// K4 (mask null) or K3 (mask (B, Nq, ldm) uint8, 1 = blocked).  q, k, v,
// out (B, H, N, P) contiguous, P a multiple of 64; tables (B, N, P) f32,
// all four or none, and then qr and kr (B, H, N, P) in q's dtype for the
// rotated q and k (else null); bias (B, H, Nq, Nk) f32 through bstr (4
// element strides), row (B, Nk) f32, lse (B, H, Nq) f32: each may be
// null.  ``plan`` is ops/flash_attention.py::wide_plan's (nb, nbw,
// per_cta, groups, stages, qres, rows, smem, splits, split_tiles).
// Scratch from the caller, nt = ceil(Nk / 64): K4 bl (B, nt * 64) f32,
// list (B, nt), count (B); K3 list (B, nrt, nt), count (B, nrt) with nrt =
// ceil(Nq / rows) (bl unused); with splits > 1 part (splits, B, H, Nq, P)
// and ml (splits, B, H, Nq, 2) f32.
extern "C" int p3_wide_fwd(const void* q, const void* k, const void* v,
                           const float* qcos, const float* qsin,
                           const float* kcos, const float* ksin, void* s0,
                           void* s1, void* s2, void* s3, void* s4, void* s5,
                           const float* bias, const long long* bstr,
                           const float* row, const unsigned char* mask,
                           int ldm, float* bl, int* list, int* count,
                           float* part, float* ml, void* out, float* lse,
                           int B, int H, int Nq, int Nk, int P, float scale,
                           int bf16, const int* plan, void* stream) {
  const Plan pl{plan[0], plan[1], plan[2], plan[3], plan[4],
                plan[5], plan[6], plan[7], plan[8], plan[9]};
  const bool f32 = !bf16;
  const int nt = (Nk + KT - 1) / KT, nrt = (Nq + pl.rows - 1) / pl.rows;
  if (P % 64 != 0 || B * H > 65535 || B < 1 || H < 1 || Nq < 1 || Nk < 1 ||
      !plan_ok(pl, P, f32) || nt * 4L > 48 * 1024 ||
      (pl.splits > 1 &&
       pl.splits != (nt + pl.split_tiles - 1) / pl.split_tiles) ||
      (pl.splits > 1 && (part == nullptr || ml == nullptr)) ||
      (mask == nullptr && bl == nullptr) ||
      (f32 ? !(s0 && s1 && s2 && s3 && s4 && s5)
           : (qcos != nullptr) != (s0 != nullptr && s1 != nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  float* planes[6] = {static_cast<float*>(s0), static_cast<float*>(s1),
                      static_cast<float*>(s2), static_cast<float*>(s3),
                      static_cast<float*>(s4), static_cast<float*>(s5)};
  if (f32) {   // the TF32 planes of q and k (rotated) and v
    const void* src[3] = {q, k, v};
    const float* tc[3] = {qcos, kcos, nullptr};
    const float* ts[3] = {qsin, ksin, nullptr};
    for (int i = 0; i < 3 && e == cudaSuccess; ++i) {
      const int N = i == 0 ? Nq : Nk;
      const long long total = static_cast<long long>(B) * H * N * P;
      wide_split<<<static_cast<unsigned>((total / 4 + 255) / 256), 256, 0,
                   st>>>(static_cast<const float*>(src[i]), tc[i], ts[i],
                         planes[2 * i], planes[2 * i + 1], H, N, P, total);
      e = cudaGetLastError();
    }
  } else if (qcos != nullptr) {   // q and k rotated once per call
    e = rope<__nv_bfloat16>(q, qcos, qsin, s0, B, H, Nq, P, st);
    if (e == cudaSuccess)
      e = rope<__nv_bfloat16>(k, kcos, ksin, s1, B, H, Nk, P, st);
    q = s0;
    k = s1;
  }
  if (e != cudaSuccess) return e;
  if (mask != nullptr)
    mask_tiles<<<dim3(nrt, B), 256, nt * sizeof(int), st>>>(
        mask, ldm, list, count, Nq, Nk, pl.rows, nt);
  else
    sm90::cross_tiles<KT><<<B, 1024, nt * sizeof(int), st>>>(
        row, bl, list, count, Nk, nt);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const Fwd a{q,    k,     v,     bias,  strides_of(bstr),
              bl,   mask,  ldm,   mask != nullptr ? nrt : 1,
              list, count, out,   lse,   part,
              ml,   B,     H,     Nq,    Nk,
              P,    nt,    scale * sm90::L2E,  pl,    st};
  e = mask != nullptr ? dispatch<true>(a, f32, planes)
                      : dispatch<false>(a, f32, planes);
  if (e != cudaSuccess || pl.splits == 1) return e;
  const long long rows = static_cast<long long>(B) * H * Nq;
  const unsigned grid = static_cast<unsigned>((rows * (P / 4) + 255) / 256);
  if (f32)
    wide_merge<float><<<grid, 256, 0, st>>>(part, ml, static_cast<float*>(out),
                                            lse, rows, P, pl.splits);
  else
    wide_merge<__nv_bfloat16><<<grid, 256, 0, st>>>(
        part, ml, static_cast<__nv_bfloat16*>(out), lse, rows, P, pl.splits);
  return cudaGetLastError();
}

// K5.  q, k, v and g (dO rounded to q's dtype) (B, H, N, P) contiguous;
// o32 and do32 (B, H, Nq, P) f32 for Dvec; lse (B, H, Nq) f32; tables,
// bias and row as p3_wide_fwd takes them, with tables qr and kr (B, H, N,
// P) in q's dtype for the rotated q and k (else null); dvec (B, H, Nq) f32
// scratch; dq, dk, dv (B, H, N, P) f32 with respect to the rotated q, k.
extern "C" int p3_wide_bwd(const void* q, const void* k, const void* v,
                           const void* g, const float* o32,
                           const float* do32, const float* lse,
                           const float* qcos, const float* qsin,
                           const float* kcos, const float* ksin, void* qr,
                           void* kr, float* dvec, const float* bias,
                           const long long* bstr, const float* row, float* dq,
                           float* dk, float* dv, int B, int H, int Nq, int Nk,
                           int P, float scale, int bf16, void* stream) {
  if (P % DC != 0 || B * H > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  if (qcos != nullptr) {
    e = rope_any(bf16, q, qcos, qsin, qr, B, H, Nq, P, st);
    if (e == cudaSuccess) e = rope_any(bf16, k, kcos, ksin, kr, B, H, Nk, P,
                                       st);
    if (e != cudaSuccess) return e;
    q = qr;
    k = kr;
  }
  const long long rows = static_cast<long long>(B) * H * Nq;
  wide_dvec<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(
      o32, do32, dvec, rows, P);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const BiasStrides bs = strides_of(bstr);
  return bf16 ? bwd<__nv_bfloat16>(q, k, v, g, lse, dvec, bias, bs, row, dq,
                                   dk, dv, B, H, Nq, Nk, P, scale, st)
              : bwd<float>(q, k, v, g, lse, dvec, bias, bs, row, dq, dk, dv,
                           B, H, Nq, Nk, P, scale, st);
}
