// Causal / full GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (entry point `flash_attention`):
// out = softmax(q k^T / sqrt(D) + mask) v, q (B, H, S, D), k and v
// (B, KV, S, D) with H % KV == 0, out in q's dtype. The mask is
// `kpos <= qpos` when causal and `kpos > qpos - window` when window > 0 (the
// term `chunked_attention` adds, src/repro/models/layers.py:163-164).
//
// The online-softmax state keeps the reference's numerics: masked logits are
// -1e30 (never -inf: a row may meet a tile that is wholly masked for it
// before a live one; exp(s - m) is then exp(0) on those entries and the next
// correction exp(-1e30 - m) = 0 washes them out, where -inf would give NaN),
// m starts at -1e30, the correction is exp(m_prev - m_new), and the end
// divides by max(l, 1e-20). Key and value rows past S are read as zeros and
// masked, so S need not be a multiple of the tile. Given an `lse` pointer,
// the epilogue also stores each row's float32 log-sum-exp, m + log(l) in the
// natural base, from the m and l it already holds, for the backward pass
// (csrc/flash_attention_bwd.cu); the prefill passes null and stores nothing.
//
// The TPU kernel walks a sequential grid and carries (m, l, acc) in VMEM
// scratch across its kv axis. Here a block loops over the key tiles of its
// q tile itself, with the state in registers; tiles that the causal or
// window mask wholly covers for the block's rows are skipped, as `pl.when`
// skips them. No atomics and no split over keys: the result is the same,
// bit for bit, from run to run.
//
// Bound on the card: operations. The causal llama3.2-1b prefill shape
// (1, 32, 4096, 64) does 4 * S^2 / 2 * D * H = 68.7 GFLOP of useful products
// against 42 MB of q, k, v and out: 0.069 ms at the 989 TFLOP/s bf16 dense
// peak against 0.0125 ms of HBM time. Only `wgmma` reaches that rate, and
// only if its operands arrive without the math waiting for them. At D = 64
// the exponentials are the other wall: 2^27 of them a head at 16 a clock an
// SM take as long as the products.
//
// Two bodies:
//  * bf16 (the model's path), FlashAttention-3's forward shape. The grid is
//    persistent: one block an SM walks a static list of (q tile, head,
//    batch) items, longest first, so one item's epilogue overlaps the next
//    one's loads. A block is a producer warpgroup and kConsumers consumer
//    warpgroups of 64 q rows each (3 at D = 64, 2 at D = 128 and 192). The
//    producer gives up its registers (`setmaxnreg.dec`) and one of its
//    threads issues TMA loads: an item's q once (after the consumers' last
//    q k^T of the item before), then K and V tiles of BK keys into a ring
//    of `kStages` shared-memory stages, each guarded by a full and an empty
//    `mbarrier`. The consumers take the freed registers (`setmaxnreg.inc`):
//    s = q k^T is `wgmma` m64nBKk16 with both operands in shared memory
//    (K-major), the online softmax runs on the accumulator registers (the
//    4 lanes of a quad share a row), and o += p v is `wgmma` m64nDk16 with
//    p taken from those registers rounded to bf16 (column block j of s is
//    k-step j/2 of p v: no shuffle) and v read MN-major (transposed) from
//    shared memory. Two overlaps keep the tensor cores and the exponentials
//    busy together: inside a warpgroup, the next tile's q k^T and this
//    tile's p v are in flight while the softmax of the next tile runs; and
//    the consumers issue their `wgmma`s in turn (named barriers), so one
//    warpgroup's softmax runs under another's products. A consumer releases
//    a stage once the `wgmma` that reads its v has completed. Every tile is
//    128-byte swizzled by TMA, 64 columns (128 bytes) a box, so a row of
//    D = 128 or 192 is two or three boxes; the `wgmma` descriptors name the
//    same swizzle. q, k and v are read through 4-D tensor maps over (D, S,
//    heads, B) with the caller's strides, so the transpose of a
//    (B, S, H, D) activation is read without a copy. Logits are scaled in
//    f32 by log2(e) / sqrt(D) and exponentiated with `ex2`, which moves p by
//    a few ulps of f32 against exp(): far inside the bf16 tolerance. The
//    PTX building blocks (mbarriers, TMA, descriptors, `wgmma`, the tensor
//    maps) live in csrc/hopper.cuh, shared with the backward.
//  * f32: FP32 FMA on the CUDA cores, never TF32 (TF32 keeps ~3 digits and
//    cannot meet the reference's 2e-5). 256 threads as 16 x 16 over 64 q
//    rows and 64-key tiles; a thread owns 4 rows x 4 keys of the score tile
//    and 4 rows x D/16 columns of the accumulator; q is scaled by 1/sqrt(D)
//    in f32 before the product, as the reference scales it. One block a
//    (b, q-head, q tile), the longest q tiles first (blockIdx.x counts down
//    the sequence).
#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;  // f32 body: q rows per block
constexpr int kBK = 64;  // f32 body: keys per tile
constexpr float kMaskValue = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, S) float32 log-sum-exp of each row, or null
  int64_t q_sb, q_sh, q_ss;  // strides in elements; the D stride is 1
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int h, kv, s;
  int causal, window;
  float scale;
};

__device__ __forceinline__ bool masked(const Params& p, int qpos, int kpos) {
  if (kpos >= p.s) return true;
  if (p.causal && kpos > qpos) return true;
  if (p.window > 0 && kpos <= qpos - p.window) return true;
  return false;
}

// [first, last) key tiles of `bk` keys that hold a live key for some row in
// [q0, q0 + rows): tiles wholly masked for every one of those rows are
// skipped.
__device__ __forceinline__ void tile_range(const Params& p, int q0, int rows,
                                           int bk, int* first, int* last) {
  const int nk = (p.s + bk - 1) / bk;
  const int row_hi = min(q0 + rows, p.s) - 1;
  *last = p.causal ? min(nk, row_hi / bk + 1) : nk;
  const int key_lo = p.window > 0 ? q0 - p.window + 1 : 0;
  *first = key_lo > 0 ? key_lo / bk : 0;
}

__device__ __forceinline__ void tile_range(const Params& p, int q0, int* first,
                                           int* last) {
  tile_range(p, q0, kBQ, kBK, first, last);
}

// ----------------------------------------------------------------- bf16 body
template <int D>
struct Bf16Tiles {
  static constexpr int kBoxes = D / 64;  // 64-column (128-byte) boxes a row
  static constexpr int kConsumers = D == 64 ? 3 : 2;  // warpgroups of 64 rows
  static constexpr int kBQ = 64 * kConsumers;     // q rows per block
  static constexpr int kBK = D > 128 ? 64 : 128;  // keys per tile
  static constexpr int kStages = 3;
  // registers a thread, after setmaxnreg: 65,536 a block at most
  static constexpr int kProducerRegs = kConsumers == 3 ? 32 : 24;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 240;
  static constexpr int kQBytes = kBoxes * kBQ * 128;
  static constexpr int kKVBytes = kBoxes * kBK * 128;  // one of K, V
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  // the barriers (q full and empty, then full[kStages], empty[kStages]),
  // and 1 KB to align the base to the 1024-byte period of the 128-byte
  // swizzle
  static constexpr int kSmemBytes = kBarOffset + 16 * (1 + kStages) + 1024;
  static_assert(D % 64 == 0 && kSmemBytes <= 232448, "tile does not fit");
  static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= 65536,
                "registers do not fit");
};

// s = q k^T for one warpgroup's 64 rows and one key tile, issued, not
// waited for. A k-step of 16 values moves 32 bytes along a 128-byte row;
// every 4 k-steps the next 64-column box.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[Bf16Tiles<D>::kBK / 2],
                                         uint32_t q_wg, uint32_t k_s) {
  using T = Bf16Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss(s, sw128_desc(q_wg + (kk / 4) * T::kBQ * 128 + off, 16, 1024),
             sw128_desc(k_s + (kk / 4) * T::kBK * 128 + off, 16, 1024),
             kk > 0);
  }
  wgmma_commit();
}

// o += p v, issued, not waited for: k-step kk is keys 16 kk .. 16 kk + 15,
// 2048 bytes (16 rows of 128) into the v tile.
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&o)[D / 2], const uint32_t (&pa)[Bf16Tiles<D>::kBK / 16][4],
    uint32_t v_s) {
  constexpr int BK = Bf16Tiles<D>::kBK;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs(o, pa[kk], sw128_desc(v_s + kk * 16 * 128, BK * 128, 1024), 1);
  wgmma_commit();
}

// The online softmax of one tile on the accumulator registers: the new row
// max over the quad, p = 2^(s log2(e) / sqrt(D) - m) in place (one FFMA
// and one ex2 an entry), this thread's part of the row sums. A tile that
// crosses the diagonal, the window's edge or S is first scaled and masked
// to -1e30 entry by entry (then scaled by 1 below), so a masked entry never
// meets a rounded product of -1e30. The max and the sums run as 8
// independent chains. Returns the corrections for o in corr_lo / corr_hi.
template <int BK>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BK / 2], const Params& p, int k0, int rq0, int r_lo, int t,
    float scale_log2, float& m_lo, float& m_hi, float& l_lo, float& l_hi,
    float& corr_lo, float& corr_hi) {
  float mul = scale_log2;
  if (k0 + BK > p.s || (p.causal && k0 + BK - 1 > rq0) ||
      (p.window > 0 && k0 <= rq0 + 63 - p.window)) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + 2 * t + (e & 1);
        s[4 * j + e] = masked(p, e < 2 ? r_lo : r_lo + 8, kpos)
                           ? kMaskValue
                           : s[4 * j + e] * scale_log2;
      }
    mul = 1.f;
  }
  float mx[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) mx[e] = s[e];
#pragma unroll
  for (int j = 8; j < BK / 2; ++j) mx[j % 8] = fmaxf(mx[j % 8], s[j]);
  // entries 0, 1, 4, 5 of every 8 are the low row, 2, 3, 6, 7 the high one
  float mx_lo = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[4], mx[5]));
  float mx_hi = fmaxf(fmaxf(mx[2], mx[3]), fmaxf(mx[6], mx[7]));
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a row
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  const float mn_lo = fmaxf(m_lo, mx_lo * mul);
  const float mn_hi = fmaxf(m_hi, mx_hi * mul);
  corr_lo = ex2(m_lo - mn_lo);
  corr_hi = ex2(m_hi - mn_hi);
  m_lo = mn_lo;
  m_hi = mn_hi;
  float sum[8];
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) {
    s[j] = ex2(fmaf(s[j], mul, (j & 2) ? -mn_hi : -mn_lo));
    sum[j % 8] = j < 8 ? s[j] : sum[j % 8] + s[j];
  }
  l_lo = l_lo * corr_lo + ((sum[0] + sum[1]) + (sum[4] + sum[5]));
  l_hi = l_hi * corr_hi + ((sum[2] + sum[3]) + (sum[6] + sum[7]));
}

// o *= corr by row, then p rounded to bf16 into the A fragments of p v:
// column blocks 2 kk and 2 kk + 1 of s are k-step kk.
template <int D>
__device__ __forceinline__ void rescale_and_pack(
    float (&o)[D / 2], const float (&s)[Bf16Tiles<D>::kBK / 2],
    uint32_t (&pa)[Bf16Tiles<D>::kBK / 16][4], float corr_lo, float corr_hi) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= corr_lo;
    o[4 * j + 1] *= corr_lo;
    o[4 * j + 2] *= corr_hi;
    o[4 * j + 3] *= corr_hi;
  }
#pragma unroll
  for (int kk = 0; kk < Bf16Tiles<D>::kBK / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// The block's static work list: `w` counts the (q tile, head, batch) items
// longest first (the last q tiles, which meet the most keys, lead); a block
// takes every gridDim.x-th item, the order reversed on odd rounds so that
// each block's sum of lengths evens out.
__device__ __forceinline__ bool work_item(int round, int nq, int h, int b,
                                          int* qb, int* head, int* batch) {
  const int g = gridDim.x;
  const int w = round * g + ((round & 1) ? g - 1 - blockIdx.x : blockIdx.x);
  if (w >= nq * h * b) return false;
  const int rest = w % (h * b);
  *qb = nq - 1 - w / (h * b);
  *head = rest % h;
  *batch = rest / h;
  return true;
}

template <int D>
__global__ void __launch_bounds__(128 * (1 + Bf16Tiles<D>::kConsumers), 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const Params p, int batch_size) {
  using T = Bf16Tiles<D>;
  constexpr int BQ = T::kBQ, BK = T::kBK, NB = T::kBoxes, ST = T::kStages;
  constexpr int kConsumerWarps = 4 * T::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + T::kQBytes;  // stage i: K, then V
  const uint32_t q_full = q_s + T::kBarOffset, q_empty = q_full + 8;
  const uint32_t full_bar = q_empty + 8, empty_bar = full_bar + 8 * ST;
  const int nq = (p.s + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
    for (int i = 0; i < ST; ++i) {
      mbar_init(full_bar + 8 * i, 1);
      mbar_init(empty_bar + 8 * i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform to the compiler, so each role is one branch to the end
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {  // ------------------------------------------- producer
    setmaxnreg_dec<T::kProducerRegs>();
    if (threadIdx.x != 0) return;
    int qb, h, b, i = 0;
    for (int round = 0; work_item(round, nq, p.h, batch_size, &qb, &h, &b);
         ++round) {
      const int q0 = qb * BQ, kvh = h / (p.h / p.kv);
      int first, last;
      tile_range(p, q0, BQ, BK, &first, &last);
      mbar_wait(q_empty, (round & 1) ^ 1);  // the last item's s are done
      mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        tma_load(q_s + c * BQ * 128, &tq, q_full, c * 64, q0, h, b);
      for (int kt = first; kt < last; ++kt, ++i) {
        const int st = i % ST;
        const uint32_t k_s = kv_s + st * T::kStageBytes;
        const uint32_t v_s = k_s + T::kKVBytes;
        mbar_wait(empty_bar + 8 * st, ((i / ST) & 1) ^ 1);
        mbar_expect_tx(full_bar + 8 * st, T::kStageBytes);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load(k_s + c * BK * 128, &tk, full_bar + 8 * st, c * 64,
                   kt * BK, kvh, b);
          tma_load(v_s + c * BK * 128, &tv, full_bar + 8 * st, c * 64,
                   kt * BK, kvh, b);
        }
      }
    }
  } else {  // ------------------------------------------------ consumers
    setmaxnreg_inc<T::kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
    const float scale_log2 = p.scale * 1.4426950408889634f;
    const uint32_t q_wg = q_s + 64 * cw * 128;
    auto stage = [&](int i) { return kv_s + (i % ST) * T::kStageBytes; };
    auto wait_full = [&](int i) {
      mbar_wait(full_bar + 8 * (i % ST), (i / ST) & 1);
    };
    auto arrive = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    auto release = [&](int i) { arrive(empty_bar + 8 * (i % ST)); };
    // The consumers take turns, in order, to issue their `wgmma`s (named
    // barrier 1 + cw is this warpgroup's turn): one warpgroup's softmax then
    // runs while another's products hold the tensor cores.
    auto my_turn = [&] { bar_sync(1 + cw, 256); };
    auto next_turn = [&] { bar_arrive(1 + (cw + 1) % T::kConsumers, 256); };
    if (cw == T::kConsumers - 1) next_turn();  // consumer 0 goes first

    float o[D / 2], s[BK / 2], corr_lo, corr_hi;
    uint32_t pa[BK / 16][4];
    int qb, h, b, i = 0;
    for (int round = 0; work_item(round, nq, p.h, batch_size, &qb, &h, &b);
         ++round) {
      const int q0 = qb * BQ, rq0 = q0 + 64 * cw;  // this warpgroup's rows
      const int r_lo = rq0 + 16 * warp + (lane >> 2), r_hi = r_lo + 8;
      // every consumer walks all the block's tiles (a tile wholly masked
      // for its rows washes out: p = 0 after a live tile, or a correction of
      // 0 before the first), so all take the same number of turns
      int first, last;
      tile_range(p, q0, BQ, BK, &first, &last);
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
      // m in the log2 domain; l summed over this thread's columns only, the
      // quad's partial sums added at the end (every update scales them
      // alike)
      float m_lo = kMaskValue, m_hi = kMaskValue, l_lo = 0.f, l_hi = 0.f;

      // the first tile: s, softmax, p; its p v waits for the next s
      mbar_wait(q_full, round & 1);
      wait_full(i);
      my_turn();
      wgmma_fence();
      issue_qk<D>(s, q_wg, stage(i));
      next_turn();
      wgmma_wait<0>();
      fence_regs(s);
      if (first + 1 == last) arrive(q_empty);  // q is read for the last time
      softmax_tile<BK>(s, p, first * BK, rq0, r_lo, t, scale_log2, m_lo, m_hi,
                       l_lo, l_hi, corr_lo, corr_hi);
      rescale_and_pack<D>(o, s, pa, corr_lo, corr_hi);
      // each later tile: its s = q k^T and the previous tile's o += p v in
      // flight together; the softmax of s runs under p v
      for (int kt = first + 1; kt < last; ++kt, ++i) {
        wait_full(i + 1);
        my_turn();
        fence_regs(o);
        wgmma_fence();
        issue_qk<D>(s, q_wg, stage(i + 1));
        issue_pv<D>(o, pa, stage(i) + T::kKVBytes);
        next_turn();
        wgmma_wait<1>();
        fence_regs(s);
        if (kt + 1 == last) arrive(q_empty);
        softmax_tile<BK>(s, p, kt * BK, rq0, r_lo, t, scale_log2, m_lo, m_hi,
                         l_lo, l_hi, corr_lo, corr_hi);
        wgmma_wait<0>();
        fence_regs(o);
        release(i);
        rescale_and_pack<D>(o, s, pa, corr_lo, corr_hi);
      }
      my_turn();
      fence_regs(o);
      wgmma_fence();
      issue_pv<D>(o, pa, stage(i) + T::kKVBytes);
      next_turn();
      wgmma_wait<0>();
      fence_regs(o);
      release(i);
      ++i;

#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
      }
      __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                          h * p.o_sh;
      const float den_lo = fmaxf(l_lo, 1e-20f), den_hi = fmaxf(l_hi, 1e-20f);
      if (p.lse != nullptr && t == 0) {  // m is in the log2 domain
        float* lg = p.lse + (static_cast<long>(b) * p.h + h) * p.s;
        if (r_lo < p.s) lg[r_lo] = (m_lo + log2f(den_lo)) * kLn2;
        if (r_hi < p.s) lg[r_hi] = (m_hi + log2f(den_hi)) * kLn2;
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (r_lo < p.s)
          *reinterpret_cast<uint32_t*>(og + r_lo * p.o_ss + col) =
              pack_bf16(o[4 * j] / den_lo, o[4 * j + 1] / den_lo);
        if (r_hi < p.s)
          *reinterpret_cast<uint32_t*>(og + r_hi * p.o_ss + col) =
              pack_bf16(o[4 * j + 2] / den_hi, o[4 * j + 3] / den_hi);
      }
    }
    if (cw == 0) my_turn();  // the last turn the last consumer handed over
  }
}

// ------------------------------------------------------------------ f32 body
template <int D>
constexpr int f32_smem_bytes() {
  // q and k rows padded to D + 1 (conflict-free column walks), v unpadded,
  // p padded to kBK + 1
  return (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1)) *
         static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(256)
    flash_attention_f32_kernel(const Params p) {
  constexpr int QP = D + 1, KP = D + 1, PP = kBK + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * QP;
  float* vs = ks + kBK * KP;
  float* ps = vs + kBK * D;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.h / p.kv);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb +
                    kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb +
                    kvh * p.v_sh;

  for (int i = tid; i < kBQ * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    qs[r * QP + c] =
        q0 + r < p.s ? __fmul_rn(qg[(q0 + r) * p.q_ss + c], p.scale) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int first, last;
  tile_range(p, q0, &first, &last);
  for (int kt = first; kt < last; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // q is stored; the previous tile's p v is done
    for (int i = tid; i < kBK * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < p.s;
      ks[r * KP + c] = in ? kg[(k0 + r) * p.k_ss + c] : 0.f;
      vs[r * D + c] = in ? vg[(k0 + r) * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * KP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kMaskValue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (masked(p, qpos, k0 + tx + 16 * j)) s[i][j] = kMaskValue;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)  // the 16 lanes of a row
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float corr = expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - mn);
        ps[(ty * 4 + i) * PP + tx + 16 * j] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // p is stored

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.s) continue;
    const float den = fmaxf(l[i], 1e-20f);
    if (p.lse != nullptr && tx == 0)
      p.lse[(static_cast<long>(b) * p.h + h) * p.s + row] = m[i] + logf(den);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      og[row * p.o_ss + tx + 16 * c] = acc[i][c] / den;
  }
}

// --------------------------------------------------------------- launchers
Params make_params(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int64_t* strides, int h, int kv, int s,
                   int causal, int window, float scale) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.q_ss = strides[2];
  p.k_sb = strides[3];
  p.k_sh = strides[4];
  p.k_ss = strides[5];
  p.v_sb = strides[6];
  p.v_sh = strides[7];
  p.v_ss = strides[8];
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_ss = strides[11];
  p.h = h;
  p.kv = kv;
  p.s = s;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  return p;
}

template <int D>
int launch_bf16(const Params& p, int b, cudaStream_t stream) {
  using T = Bf16Tiles<D>;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, p.q, D, p.s, p.h, b, p.q_ss, p.q_sh, p.q_sb, T::kBQ) ||
      !encode_map(&tk, p.k, D, p.s, p.kv, b, p.k_ss, p.k_sh, p.k_sb,
                  T::kBK) ||
      !encode_map(&tv, p.v, D, p.s, p.kv, b, p.v_ss, p.v_sh, p.v_sb, T::kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms;  // one block an SM, each walking its work list
  const cudaError_t e = multiprocessors(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long items = static_cast<long>((p.s + T::kBQ - 1) / T::kBQ) * p.h * b;
  const int grid = static_cast<int>(items < sms ? items : sms);
  flash_attention_wgmma_kernel<D><<<grid, 128 * (1 + T::kConsumers),
                                    T::kSmemBytes, stream>>>(tq, tk, tv, p,
                                                             b);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const Params& p, int b, cudaStream_t stream) {
  constexpr int bytes = f32_smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.s + kBQ - 1) / kBQ, p.h, b);
  flash_attention_f32_kernel<D><<<grid, 256, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. `lse`, when not null, receives the
// float32 log-sum-exp of every row, (B, H, S) contiguous, for the backward
// (csrc/flash_attention_bwd.cu); null stores nothing. `strides` is a host
// array of 12 element strides: (batch, head, sequence) of q, k, v and out;
// the head_dim stride is 1, every base lies on 16 bytes and every stride of
// an extent above 1 is a positive multiple of 16 bytes (the wrapper checks
// all three: TMA's rules). Launches on `stream`, does not synchronise,
// returns the launch's cudaError_t (cudaErrorInvalidValue for a head_dim
// other than 64, 128 or 192, or a tensor map cuTensorMapEncodeTiled
// refuses).
extern "C" {

int repro_flash_attention_bf16(const void* q, const void* k, const void* v,
                               void* o, float* lse, const int64_t* strides,
                               int b, int h, int kv, int s, int d, int causal,
                               int window, float scale, void* stream) {
  const Params p = make_params(q, k, v, o, lse, strides, h, kv, s, causal,
                               window, scale);
  auto st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_bf16<64>(p, b, st);
  if (d == 128) return launch_bf16<128>(p, b, st);
  if (d == 192) return launch_bf16<192>(p, b, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int repro_flash_attention_f32(const void* q, const void* k, const void* v,
                              void* o, float* lse, const int64_t* strides,
                              int b, int h, int kv, int s, int d, int causal,
                              int window, float scale, void* stream) {
  const Params p = make_params(q, k, v, o, lse, strides, h, kv, s, causal,
                               window, scale);
  auto st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_f32<64>(p, b, st);
  if (d == 128) return launch_f32<128>(p, b, st);
  if (d == 192) return launch_f32<192>(p, b, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
