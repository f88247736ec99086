// The backward pass of causal / full GQA flash attention for Hopper (sm_90a).
//
// The Pallas TPU kernel `_flash_kernel` (src/repro/kernels/flash_attention.py)
// has no backward: the reference trains through `chunked_attention`
// (src/repro/models/layers.py:131), a jnp online-softmax recurrence that JAX
// differentiates. This file computes that gradient for the port's forward
// (csrc/flash_attention.cu), FlashAttention-2 style: the forward saves the
// float32 log-sum-exp of each row, lse = log(sum_j exp(s_j)), and the
// backward recomputes p = exp(s - lse) tile by tile, so no (S, S) tensor is
// ever stored. With s = q k^T * scale (scale = 1/sqrt(D)), the mask of the
// forward (kpos <= qpos when causal, kpos > qpos - window when window > 0,
// p = 0 where masked) and delta = rowsum(dO o):
//
//   dv = p^T dO,  dp = dO v^T,  ds = p (dp - delta),
//   dq = ds k * scale,  dk = ds^T q * scale,
//
// dk and dv summed over the H / KV query heads of each key head (GQA).
//
// Three launches, no atomics, so the result repeats bit for bit:
//  (i)   delta (B, H, S) float32: one warp a row;
//  (ii)  dk, dv: each block owns the keys of its items and walks every
//        query tile of every head of their group that the mask leaves live
//        for them, recomputing s^T and dp^T and summing dk and dv in
//        registers;
//  (iii) dq: each block owns the queries of its items and walks the key
//        tiles live for them, summing dq in registers.
// s and dp are computed in both (ii) and (iii): seven products where the
// bound counts five, so that dq needs no sum across blocks.
//
// Bound on the card: operations. Five products of 2 S^2 / 2 D H each (s,
// dp, dv, dk, dq; causal) = 2.5x the forward's: 687 GFLOP at the
// llama3.2-1b training shape (1, 32, 8192, 64), 0.695 ms at 989 TFLOP/s;
// the seven this design runs, 0.97 ms. Only `wgmma` reaches that rate, and
// only with its operands in shared memory before the math asks for them.
//
// The bf16 body (the model's path) is FlashAttention-3's backward shape cut
// into (ii) and (iii), each a persistent grid: one block an SM walks a
// static list of items, longest first (under the causal mask the first key
// tiles meet the most queries in (ii), the last query tiles the most keys
// in (iii)), so one item's epilogue overlaps the next one's loads. A block
// is a producer warpgroup and consumer warpgroups of 64 rows each. The
// producer gives up its registers (`setmaxnreg.dec`); one of its warps
// loads an item's own tiles once (after the consumers' last product that
// reads the item before's) and streams the other operand's tiles through a
// ring of `kStages` shared-memory stages, each guarded by a full and an
// empty `mbarrier`. The consumers take the freed registers
// (`setmaxnreg.inc`) and issue their `wgmma`s in turn (named barriers), so
// one warpgroup's exponentials run under another's products; inside a
// warpgroup the next tile's s and dp are in flight with this tile's
// accumulating products while the exponentials of the next tile run. A
// consumer releases a stage once the last `wgmma` that reads it has
// completed. Every tile is 128-byte swizzled by TMA, 64 columns a box, and
// q, k, v and dO are read through 4-D tensor maps over (D, S, heads, B)
// with the caller's strides (csrc/hopper.cuh), so the transposed
// (B, S, H, D) activations the model hands over are read without a copy;
// rows past S read as zeros and are masked.
//  (ii)  an item is (128 keys: 64 a consumer, KV head, block of kCols
//        output columns, batch); its k and v are loaded once, and the ring
//        carries q and dO tiles of kBQ queries with the stage's lse * log2(e)
//        and delta rows (float32 rows of (B, H, S), whose 4 S-byte stride
//        TMA cannot take for every S: the producer warp's lanes read them
//        with plain loads, store them into the stage and arrive on its full
//        barrier beside the TMA bytes). Per stage: s^T = k q^T and
//        dp^T = v dO^T, `wgmma` with both operands K-major in shared memory;
//        p^T = 2^(s^T scale log2(e) - lse log2(e)) and ds^T = p^T (dp^T -
//        delta) on the accumulator registers, the mask applied only on a
//        tile that crosses the diagonal, the window's edge or S; then
//        dv += p^T dO and dk += ds^T q, `wgmma` with A from those registers
//        rounded to bf16 and B (dO, q) read MN-major from shared memory.
//        The epilogue stores dk * scale and dv as bf16. Accumulators a
//        thread: dk and dv kCols / 2 floats each, s^T and dp^T kBQ / 2 each.
//        head_dim 64: kBQ = 64, kCols = 64 (128 floats); 128: narrower
//        query tiles, kBQ = 32 (`wgmma` m64n32), kCols = 128 (160 floats);
//        192: kBQ = 32 and three column blocks of kCols = 64 that each
//        recompute s^T and dp^T (96 floats; the descriptors of 12 k-steps
//        of k and v take registers too).
//  (iii) an item is (64 queries a consumer: 3 consumers at head_dim 64, 2
//        at 128 and 192, head, batch); its q and dO are loaded once, its
//        rows' lse and delta read into registers, and the ring carries k
//        and v tiles of 64 keys. Per stage: s = q k^T and dp = dO v^T, p
//        and ds on the registers, then dq += ds k (`wgmma`, k MN-major);
//        the epilogue stores dq * scale. The forward's skeleton with one
//        more product.
// Exponentials use `ex2`, which moves p by a few ulps of f32 against
// exp(): far inside the bf16 tolerance.
//
// float32 runs on FP32 FMA (TF32 would not meet the f32 tolerance): 32 x 32
// tiles, 256 threads, one block a tile.
#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  int64_t sb, sh, ss;  // in elements; the head_dim stride is 1
};

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, S), contiguous
  float* delta;      // (B, H, S), contiguous
  void* dq;
  void* dk;
  void* dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int h, kv, s;
  int causal, window;
  float scale;
};

__device__ __forceinline__ bool masked(const BwdParams& p, int qpos,
                                       int kpos) {
  if (qpos >= p.s || kpos >= p.s) return true;
  if (p.causal && kpos > qpos) return true;
  if (p.window > 0 && kpos <= qpos - p.window) return true;
  return false;
}

// [first, last) tiles of `t` rows along the other axis that hold a live
// (query, key) pair for the rows [a0, a0 + rows) of this axis.
// `keys_of_queries`: this axis is queries (dq), else keys (dk, dv).
__device__ __forceinline__ void live_tiles(const BwdParams& p, int a0,
                                           int rows, int t,
                                           bool keys_of_queries, int* first,
                                           int* last) {
  const int n = (p.s + t - 1) / t;
  const int a_hi = min(a0 + rows, p.s) - 1;
  if (keys_of_queries) {  // keys of queries [a0, a_hi]
    *last = p.causal ? min(n, a_hi / t + 1) : n;
    const int lo = p.window > 0 ? a0 - p.window + 1 : 0;
    *first = lo > 0 ? lo / t : 0;
  } else {  // queries of keys [a0, a_hi]
    *first = p.causal ? a0 / t : 0;
    *last = p.window > 0 ? min(n, (a_hi + p.window - 1) / t + 1) : n;
  }
}

// The same with tiles of `t` rows on both axes.
__device__ __forceinline__ void live_tiles(const BwdParams& p, int a0, int t,
                                           bool keys_of_queries, int* first,
                                           int* last) {
  live_tiles(p, a0, t, t, keys_of_queries, first, last);
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ------------------------------------------------------------ (i) delta
// delta[b, h, i] = sum_d f32(dO[b, h, i, d]) f32(o[b, h, i, d]): a warp a row.
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_delta_kernel(const BwdParams p, int d, long rows) {
  const long row = static_cast<long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int i = static_cast<int>(row % p.s);
  const int h = static_cast<int>((row / p.s) % p.h);
  const int b = static_cast<int>(row / (static_cast<long>(p.s) * p.h));
  const T* o = static_cast<const T*>(p.o) + b * p.so.sb + h * p.so.sh +
               i * p.so.ss;
  const T* g = static_cast<const T*>(p.dout) + b * p.sdo.sb + h * p.sdo.sh +
               i * p.sdo.ss;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32)
    acc = fmaf(to_f32(g[c]), to_f32(o[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

// -------------------------------------------------------------- bf16 body
// (ii): items of 128 keys, a ring of q and dO tiles (see the header).
template <int D>
struct DkdvTiles {
  static constexpr int kBoxes = D / 64;            // 64-column boxes a row
  static constexpr int kConsumers = 2;             // warpgroups, 64 keys each
  static constexpr int kBK = 64 * kConsumers;      // keys an item
  static constexpr int kBQ = D == 64 ? 64 : 32;    // queries a stage
  static constexpr int kCols = D == 192 ? 64 : D;  // dk, dv columns an item
  static constexpr int kColBlocks = D / kCols;
  static constexpr int kStages = 4;
  // registers a thread, after setmaxnreg: the block holds 384 x 168
  static constexpr int kProducerRegs = 32;
  static constexpr int kConsumerRegs = 232;
  static constexpr int kKVBytes = kBoxes * kBK * 128;    // one of k, v
  static constexpr int kTileBytes = kBoxes * kBQ * 128;  // one of q, dO
  static constexpr int kStageBytes = 2 * kTileBytes;
  // each stage's lse * log2(e) and delta rows, kBQ floats each
  static constexpr int kRowsOffset = 2 * kKVBytes + kStages * kStageBytes;
  static constexpr int kBarOffset = kRowsOffset + kStages * 2 * kBQ * 4;
  // the barriers (k, v full and empty, then full[kStages], empty[kStages]),
  // and 1 KB to align the base to the 1024-byte period of the swizzle
  static constexpr int kSmemBytes = kBarOffset + 16 * (1 + kStages) + 1024;
  static_assert(D % 64 == 0 && kSmemBytes <= 232448, "tile does not fit");
  static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <=
                    384 * 168,
                "registers do not fit");
};

// (iii): items of 64 queries a consumer, a ring of k and v tiles.
template <int D>
struct DqTiles {
  static constexpr int kBoxes = D / 64;
  static constexpr int kConsumers = D == 64 ? 3 : 2;  // warpgroups of 64 rows
  static constexpr int kBQ = 64 * kConsumers;         // queries an item
  static constexpr int kBK = 64;                      // keys a stage
  static constexpr int kStages = D == 192 ? 2 : 4;
  static constexpr int kProducerRegs = kConsumers == 3 ? 32 : 24;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 240;
  static constexpr int kQBytes = kBoxes * kBQ * 128;     // one of q, dO
  static constexpr int kTileBytes = kBoxes * kBK * 128;  // one of k, v
  static constexpr int kStageBytes = 2 * kTileBytes;
  // q, dO full and empty, then full[kStages], empty[kStages]
  static constexpr int kBarOffset = 2 * kQBytes + kStages * kStageBytes;
  static constexpr int kSmemBytes = kBarOffset + 16 * (1 + kStages) + 1024;
  static_assert(D % 64 == 0 && kSmemBytes <= 232448, "tile does not fit");
  static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= 65536,
                "registers do not fit");
};

// acc = A B^T over all D for one warpgroup: A its 64 rows at `a_s`, B the N
// rows at `b_s` (N = 2 x acc's size), both K-major 128-byte-swizzled tiles
// whose 64-column boxes are `a_box` and `b_box` bytes apart. Issued, not
// committed. A k-step of 16 values moves 32 bytes along a 128-byte row;
// every 4 k-steps the next box.
template <int D, int NACC>
__device__ __forceinline__ void issue_rows_by_rows(float (&acc)[NACC],
                                                   uint32_t a_s, int a_box,
                                                   uint32_t b_s, int b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss(acc, sw128_desc(a_s + (kk / 4) * a_box + off, 16, 1024),
             sw128_desc(b_s + (kk / 4) * b_box + off, 16, 1024), kk > 0);
  }
}

// acc += X B for one warpgroup: X (64 rows by 16 KS) in A fragments, B the
// 16 KS rows of a tile at `b_s` (64-column boxes `b_box` bytes apart) read
// MN-major, N = 2 x acc's size columns from `b_s` on. Issued, not committed:
// k-step kk is rows 16 kk .. 16 kk + 15, 2048 bytes into the tile.
template <int KS, int NACC>
__device__ __forceinline__ void issue_frags_by_tile(
    float (&acc)[NACC], const uint32_t (&x)[KS][4], uint32_t b_s, int b_box) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_rs(acc, x[kk], sw128_desc(b_s + kk * 16 * 128, b_box, 1024), 1);
}

// An accumulator rounded to bf16 into the A fragments of a product over its
// columns: column blocks 2 kk and 2 kk + 1 are k-step kk.
template <int KS>
__device__ __forceinline__ void pack_frags(uint32_t (&x)[KS][4],
                                           const float (&a)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    x[kk][0] = pack_bf16(a[8 * kk], a[8 * kk + 1]);
    x[kk][1] = pack_bf16(a[8 * kk + 2], a[8 * kk + 3]);
    x[kk][2] = pack_bf16(a[8 * kk + 4], a[8 * kk + 5]);
    x[kk][3] = pack_bf16(a[8 * kk + 6], a[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}

// One entry of the tile: s becomes p = 2^(s scale log2(e) - lse2), 0 where
// `dead` (masked), and dp becomes ds = p (dp - delta).
__device__ __forceinline__ void grad_entry(float& s, float& dp,
                                           float scale_log2, float lse2,
                                           float delta, bool dead) {
  const float x = dead ? 0.f : ex2(fmaf(s, scale_log2, -lse2));
  s = x;
  dp = x * (dp - delta);
}

// p^T and ds^T of one (ii) tile in place: rows are this thread's keys
// k_lo and k_lo + 8, columns the queries q0 + 8 j + 2 t + {0, 1}, whose
// lse * log2(e) and delta rows lie in shared memory. kMask: the tile crosses
// the diagonal, the window's edge or S.
template <bool kMask, int N>
__device__ __forceinline__ void grads_by_keys(float (&s)[N], float (&dp)[N],
                                              const BwdParams& p,
                                              const float* lse2,
                                              const float* delta, int q0,
                                              int k_lo, int t,
                                              float scale_log2) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 l = *reinterpret_cast<const float2*>(lse2 + c);
    const float2 d = *reinterpret_cast<const float2*>(delta + c);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      grad_entry(s[4 * j + e], dp[4 * j + e], scale_log2, e & 1 ? l.y : l.x,
                 e & 1 ? d.y : d.x,
                 kMask && masked(p, q0 + c + (e & 1), e < 2 ? k_lo : k_lo + 8));
  }
}

// p and ds of one (iii) tile in place: rows are this thread's queries q_lo
// and q_lo + 8 (their lse * log2(e) and delta in registers), columns the
// keys k0 + 8 j + 2 t + {0, 1}.
template <bool kMask, int N>
__device__ __forceinline__ void grads_by_queries(
    float (&s)[N], float (&dp)[N], const BwdParams& p, const float (&lse2)[2],
    const float (&delta)[2], int k0, int q_lo, int t, float scale_log2) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      grad_entry(s[4 * j + e], dp[4 * j + e], scale_log2, lse2[e >> 1],
                 delta[e >> 1],
                 kMask && masked(p, e < 2 ? q_lo : q_lo + 8,
                                 k0 + 8 * j + 2 * t + (e & 1)));
}

// The block's static work list: item w of `tiles` x `rest`, with `tile` =
// w / rest (the caller orders tiles so the longest lead) and `r` = w % rest;
// a block takes every gridDim.x-th item, the order reversed on odd rounds so
// that each block's sum of lengths evens out.
__device__ __forceinline__ bool work_item(int round, int tiles, int rest,
                                          int* tile, int* r) {
  const int g = gridDim.x;
  const int w = round * g + ((round & 1) ? g - 1 - blockIdx.x : blockIdx.x);
  if (w >= tiles * rest) return false;
  *tile = w / rest;
  *r = w % rest;
  return true;
}

// Writes this thread's two rows (`row`, `row` + 8; not past S) of a
// warpgroup's accumulator times `mul`, columns c0 + 8 j + 2 t + {0, 1}, as
// bf16 to `out` (row stride `ss`).
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N],
                                           __nv_bfloat16* out, int64_t ss,
                                           int row, int s, int c0, int t,
                                           float mul) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int col = c0 + 8 * j + 2 * t;
    if (row < s)
      *reinterpret_cast<uint32_t*>(out + row * ss + col) =
          pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (row + 8 < s)
      *reinterpret_cast<uint32_t*>(out + (row + 8) * ss + col) =
          pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// (ii) dk, dv: items (key tile of kBK, KV head, column block, batch), the
// first key tiles first.
template <int D>
__global__ void __launch_bounds__(128 * (1 + DkdvTiles<D>::kConsumers), 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tdo,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const BwdParams p, int batch_size) {
  using T = DkdvTiles<D>;
  constexpr int BK = T::kBK, BQ = T::kBQ, NB = T::kBoxes, ST = T::kStages;
  constexpr int NC = T::kCols;
  constexpr int kConsumerWarps = 4 * T::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t k_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t v_s = k_s + T::kKVBytes;
  const uint32_t ring = v_s + T::kKVBytes;  // stage i: q, then dO
  float* const rows = reinterpret_cast<float*>(
      smem_raw + (k_s - smem_u32(smem_raw)) + T::kRowsOffset);
  const uint32_t kv_full = k_s + T::kBarOffset, kv_empty = kv_full + 8;
  const uint32_t full_bar = kv_empty + 8, empty_bar = full_bar + 8 * ST;
  const int nk = (p.s + BK - 1) / BK, group = p.h / p.kv;
  const int rest = p.kv * T::kColBlocks * batch_size;
  auto item = [&](int round, int* kt, int* kvh, int* cb, int* b) {
    int r;
    if (!work_item(round, nk, rest, kt, &r)) return false;
    *kvh = r % p.kv;
    *cb = r / p.kv % T::kColBlocks;
    *b = r / (p.kv * T::kColBlocks);
    return true;
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kConsumerWarps);
    for (int i = 0; i < ST; ++i) {
      mbar_init(full_bar + 8 * i, 32);  // the producer warp's lanes
      mbar_init(empty_bar + 8 * i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform to the compiler, so each role is one branch to the end
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {  // ------------------------------------------- producer
    setmaxnreg_dec<T::kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int kt, kvh, cb, b, i = 0;
    for (int round = 0; item(round, &kt, &kvh, &cb, &b); ++round) {
      const int k0 = kt * BK;
      int first, last;
      live_tiles(p, k0, BK, BQ, false, &first, &last);
      const int nt = last - first, n = group * nt;
      if (lane == 0) {
        mbar_wait(kv_empty, (round & 1) ^ 1);  // the last item's s, dp done
        mbar_expect_tx(kv_full, 2 * T::kKVBytes);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load(k_s + c * BK * 128, &tk, kv_full, c * 64, k0, kvh, b);
          tma_load(v_s + c * BK * 128, &tv, kv_full, c * 64, k0, kvh, b);
        }
      }
      for (int idx = 0; idx < n; ++idx, ++i) {
        const int h = kvh * group + idx / nt, q0 = (first + idx % nt) * BQ;
        const float* lse = p.lse + (static_cast<long>(b) * p.h + h) * p.s;
        const float* dl = p.delta + (static_cast<long>(b) * p.h + h) * p.s;
        float l2[BQ / 32], d[BQ / 32];  // read before the stage is free
#pragma unroll
        for (int e = 0; e < BQ / 32; ++e) {
          const int pos = q0 + lane + 32 * e;
          l2[e] = pos < p.s ? lse[pos] * kLog2e : 0.f;
          d[e] = pos < p.s ? dl[pos] : 0.f;
        }
        const int st = i % ST;
        mbar_wait(empty_bar + 8 * st, ((i / ST) & 1) ^ 1);
#pragma unroll
        for (int e = 0; e < BQ / 32; ++e) {
          rows[st * 2 * BQ + lane + 32 * e] = l2[e];
          rows[st * 2 * BQ + BQ + lane + 32 * e] = d[e];
        }
        const uint32_t q_st = ring + st * T::kStageBytes;
        if (lane == 0) {  // the lane's arrival carries the TMA bytes
          mbar_expect_tx(full_bar + 8 * st, T::kStageBytes);
#pragma unroll
          for (int c = 0; c < NB; ++c) {
            tma_load(q_st + c * BQ * 128, &tq, full_bar + 8 * st, c * 64, q0,
                     h, b);
            tma_load(q_st + T::kTileBytes + c * BQ * 128, &tdo,
                     full_bar + 8 * st, c * 64, q0, h, b);
          }
        } else {
          mbar_arrive(full_bar + 8 * st);
        }
      }
    }
  } else {  // ------------------------------------------------ consumers
    setmaxnreg_inc<T::kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
    const float scale_log2 = p.scale * kLog2e;
    const uint32_t k_wg = k_s + 64 * cw * 128, v_wg = v_s + 64 * cw * 128;
    auto stage = [&](int i) { return ring + (i % ST) * T::kStageBytes; };
    auto wait_full = [&](int i) {
      mbar_wait(full_bar + 8 * (i % ST), (i / ST) & 1);
    };
    auto arrive = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    auto release = [&](int i) { arrive(empty_bar + 8 * (i % ST)); };
    // the consumers take turns, in order, to issue their `wgmma`s (named
    // barrier 1 + cw is this warpgroup's turn)
    auto my_turn = [&] { bar_sync(1 + cw, 256); };
    auto next_turn = [&] { bar_arrive(1 + (cw + 1) % T::kConsumers, 256); };
    if (cw == T::kConsumers - 1) next_turn();  // consumer 0 goes first

    float dk[NC / 2], dv[NC / 2], s[BQ / 2], dp[BQ / 2];
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    int kt, kvh, cb, b, i = 0;
    for (int round = 0; item(round, &kt, &kvh, &cb, &b); ++round) {
      const int k0 = kt * BK, kw0 = k0 + 64 * cw;  // this warpgroup's keys
      const int k_lo = kw0 + 16 * warp + (lane >> 2);
      int first, last;
      live_tiles(p, k0, BK, BQ, false, &first, &last);
      const int nt = last - first, n = group * nt;
      // s^T = k q^T and dp^T = v dO^T of ring slot i
      auto issue_sdp = [&](int i) {
        issue_rows_by_rows<D>(s, k_wg, BK * 128, stage(i), BQ * 128);
        issue_rows_by_rows<D>(dp, v_wg, BK * 128, stage(i) + T::kTileBytes,
                              BQ * 128);
        wgmma_commit();
      };
      // dv += p^T dO and dk += ds^T q on the item's columns
      auto issue_dkdv = [&](int i) {
        const uint32_t q_st = stage(i) + cb * BQ * 128;
        issue_frags_by_tile(dv, pa, q_st + T::kTileBytes, BQ * 128);
        issue_frags_by_tile(dk, da, q_st, BQ * 128);
        wgmma_commit();
      };
      // p^T and ds^T of the item's idx-th stage, ring slot i
      auto grads = [&](int idx, int i) {
        const int q0 = (first + idx % nt) * BQ;
        const float* r = rows + (i % ST) * 2 * BQ;
        if (q0 + BQ > p.s || kw0 + 64 > p.s || (p.causal && kw0 + 63 > q0) ||
            (p.window > 0 && q0 + BQ - 1 - p.window >= kw0))
          grads_by_keys<true>(s, dp, p, r, r + BQ, q0, k_lo, t, scale_log2);
        else
          grads_by_keys<false>(s, dp, p, r, r + BQ, q0, k_lo, t, scale_log2);
      };
      zero(dk);
      zero(dv);

      // the first stage: s^T, dp^T, then p^T, ds^T; its products wait for
      // the next stage's s^T, dp^T
      mbar_wait(kv_full, round & 1);
      wait_full(i);
      my_turn();
      wgmma_fence();
      issue_sdp(i);
      next_turn();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (n == 1) arrive(kv_empty);  // k and v are read for the last time
      grads(0, i);
      pack_frags(pa, s);
      pack_frags(da, dp);
      // each later stage: its s^T, dp^T and the previous stage's dv, dk in
      // flight together; its p^T, ds^T run under dv, dk
      for (int idx = 1; idx < n; ++idx, ++i) {
        wait_full(i + 1);
        my_turn();
        fence_regs(dk);
        fence_regs(dv);
        wgmma_fence();
        issue_sdp(i + 1);
        issue_dkdv(i);
        next_turn();
        wgmma_wait<1>();
        fence_regs(s);
        fence_regs(dp);
        if (idx + 1 == n) arrive(kv_empty);
        grads(idx, i + 1);
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
        release(i);
        pack_frags(pa, s);
        pack_frags(da, dp);
      }
      my_turn();
      fence_regs(dk);
      fence_regs(dv);
      wgmma_fence();
      issue_dkdv(i);
      next_turn();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      release(i);
      ++i;

      const int c0 = cb * NC;
      store_rows(dk, static_cast<__nv_bfloat16*>(p.dk) + b * p.sdk.sb +
                         kvh * p.sdk.sh, p.sdk.ss, k_lo, p.s, c0, t, p.scale);
      store_rows(dv, static_cast<__nv_bfloat16*>(p.dv) + b * p.sdv.sb +
                         kvh * p.sdv.sh, p.sdv.ss, k_lo, p.s, c0, t, 1.f);
    }
    if (cw == 0) my_turn();  // the last turn the last consumer handed over
  }
}

// (iii) dq: items (query tile of kBQ, head, batch), the last query tiles
// first.
template <int D>
__global__ void __launch_bounds__(128 * (1 + DqTiles<D>::kConsumers), 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const BwdParams p, int batch_size) {
  using T = DqTiles<D>;
  constexpr int BQ = T::kBQ, BK = T::kBK, NB = T::kBoxes, ST = T::kStages;
  constexpr int kConsumerWarps = 4 * T::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + T::kQBytes;
  const uint32_t ring = do_s + T::kQBytes;  // stage i: k, then v
  const uint32_t q_full = q_s + T::kBarOffset, q_empty = q_full + 8;
  const uint32_t full_bar = q_empty + 8, empty_bar = full_bar + 8 * ST;
  const int nq = (p.s + BQ - 1) / BQ, group = p.h / p.kv;
  auto item = [&](int round, int* qb, int* h, int* b) {
    int tile, r;
    if (!work_item(round, nq, p.h * batch_size, &tile, &r)) return false;
    *qb = nq - 1 - tile;
    *h = r % p.h;
    *b = r / p.h;
    return true;
  };

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

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {  // ------------------------------------------- producer
    setmaxnreg_dec<T::kProducerRegs>();
    if (threadIdx.x != 0) return;
    int qb, h, b, i = 0;
    for (int round = 0; item(round, &qb, &h, &b); ++round) {
      const int q0 = qb * BQ, kvh = h / group;
      int first, last;
      live_tiles(p, q0, BQ, BK, true, &first, &last);
      mbar_wait(q_empty, (round & 1) ^ 1);  // the last item's s, dp done
      mbar_expect_tx(q_full, 2 * T::kQBytes);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        tma_load(q_s + c * BQ * 128, &tq, q_full, c * 64, q0, h, b);
        tma_load(do_s + c * BQ * 128, &tdo, q_full, c * 64, q0, h, b);
      }
      for (int kt = first; kt < last; ++kt, ++i) {
        const int st = i % ST;
        const uint32_t k_st = ring + st * T::kStageBytes;
        mbar_wait(empty_bar + 8 * st, ((i / ST) & 1) ^ 1);
        mbar_expect_tx(full_bar + 8 * st, T::kStageBytes);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load(k_st + c * BK * 128, &tk, full_bar + 8 * st, c * 64,
                   kt * BK, kvh, b);
          tma_load(k_st + T::kTileBytes + c * BK * 128, &tv,
                   full_bar + 8 * st, c * 64, kt * BK, kvh, b);
        }
      }
    }
  } else {  // ------------------------------------------------ consumers
    setmaxnreg_inc<T::kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
    const float scale_log2 = p.scale * kLog2e;
    const uint32_t q_wg = q_s + 64 * cw * 128, do_wg = do_s + 64 * cw * 128;
    auto stage = [&](int i) { return ring + (i % ST) * T::kStageBytes; };
    auto wait_full = [&](int i) {
      mbar_wait(full_bar + 8 * (i % ST), (i / ST) & 1);
    };
    auto arrive = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    auto release = [&](int i) { arrive(empty_bar + 8 * (i % ST)); };
    auto my_turn = [&] { bar_sync(1 + cw, 256); };
    auto next_turn = [&] { bar_arrive(1 + (cw + 1) % T::kConsumers, 256); };
    if (cw == T::kConsumers - 1) next_turn();  // consumer 0 goes first

    float dq[D / 2], s[BK / 2], dp[BK / 2];
    uint32_t da[BK / 16][4];
    int qb, h, b, i = 0;
    for (int round = 0; item(round, &qb, &h, &b); ++round) {
      const int q0 = qb * BQ, rq0 = q0 + 64 * cw;  // this warpgroup's rows
      const int q_lo = rq0 + 16 * warp + (lane >> 2);
      int first, last;
      live_tiles(p, q0, BQ, BK, true, &first, &last);
      float lse2[2], delta[2];
      const long row0 = (static_cast<long>(b) * p.h + h) * p.s;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = q_lo + 8 * e;
        lse2[e] = r < p.s ? p.lse[row0 + r] * kLog2e : 0.f;
        delta[e] = r < p.s ? p.delta[row0 + r] : 0.f;
      }
      // s = q k^T and dp = dO v^T of ring slot i
      auto issue_sdp = [&](int i) {
        issue_rows_by_rows<D>(s, q_wg, BQ * 128, stage(i), BK * 128);
        issue_rows_by_rows<D>(dp, do_wg, BQ * 128, stage(i) + T::kTileBytes,
                              BK * 128);
        wgmma_commit();
      };
      auto issue_dq = [&](int i) {  // dq += ds k
        issue_frags_by_tile(dq, da, stage(i), BK * 128);
        wgmma_commit();
      };
      auto grads = [&](int kt) {  // p and ds of key tile kt
        const int k0 = kt * BK;
        if (k0 + BK > p.s || rq0 + 64 > p.s ||
            (p.causal && k0 + BK - 1 > rq0) ||
            (p.window > 0 && k0 <= rq0 + 63 - p.window))
          grads_by_queries<true>(s, dp, p, lse2, delta, k0, q_lo, t,
                                 scale_log2);
        else
          grads_by_queries<false>(s, dp, p, lse2, delta, k0, q_lo, t,
                                  scale_log2);
      };
      zero(dq);

      // every consumer walks all the block's key tiles (a tile wholly
      // masked for its rows gives ds = 0), so all take the same turns
      mbar_wait(q_full, round & 1);
      wait_full(i);
      my_turn();
      wgmma_fence();
      issue_sdp(i);
      next_turn();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (first + 1 == last) arrive(q_empty);  // q, dO read for the last time
      grads(first);
      pack_frags(da, dp);
      for (int kt = first + 1; kt < last; ++kt, ++i) {
        wait_full(i + 1);
        my_turn();
        fence_regs(dq);
        wgmma_fence();
        issue_sdp(i + 1);
        issue_dq(i);
        next_turn();
        wgmma_wait<1>();
        fence_regs(s);
        fence_regs(dp);
        if (kt + 1 == last) arrive(q_empty);
        grads(kt);
        wgmma_wait<0>();
        fence_regs(dq);
        release(i);
        pack_frags(da, dp);
      }
      my_turn();
      fence_regs(dq);
      wgmma_fence();
      issue_dq(i);
      next_turn();
      wgmma_wait<0>();
      fence_regs(dq);
      release(i);
      ++i;

      store_rows(dq, static_cast<__nv_bfloat16*>(p.dq) + b * p.sdq.sb +
                         h * p.sdq.sh, p.sdq.ss, q_lo, p.s, 0, t, p.scale);
    }
    if (cw == 0) my_turn();  // the last turn the last consumer handed over
  }
}

// --------------------------------------------------------------- f32 body
constexpr int kF32Tile = 32;

template <int D>
constexpr int f32_smem_bytes() {
  // four tiles of pitch D + 1, two 32 x 33 score tiles, lse and delta
  return (4 * kF32Tile * (D + 1) + 2 * kF32Tile * (kF32Tile + 1) +
          2 * kF32Tile) *
         static_cast<int>(sizeof(float));
}

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* base,
                                              int64_t ss, int r0, int s) {
  for (int i = threadIdx.x; i < kF32Tile * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = r0 + r < s ? base[(r0 + r) * ss + c] : 0.f;
  }
}

// (ii) in float32: a block a (key tile of 32, KV head, batch); thread
// (kr, lane8) owns key row kr = tid / 8 and, for the scores, query columns
// lane8 + 8 j, for the outputs, columns lane8 + 8 j of D.
template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_dkdv_f32_kernel(const BwdParams p) {
  constexpr int DP = D + 1, SP = kF32Tile + 1, NC = D / 8;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kF32Tile * DP;
  float* qs = vs + kF32Tile * DP;
  float* gs = qs + kF32Tile * DP;
  float* ps = gs + kF32Tile * DP;
  float* dss = ps + kF32Tile * SP;
  float* lse = dss + kF32Tile * SP;
  float* dl = lse + kF32Tile;

  const int k0 = blockIdx.x * kF32Tile, kvh = blockIdx.y, b = blockIdx.z;
  const int kr = threadIdx.x / 8, c8 = threadIdx.x % 8;
  const int group = p.h / p.kv;
  load_tile_f32<D>(ks, static_cast<const float*>(p.k) + b * p.sk.sb +
                           kvh * p.sk.sh, p.sk.ss, k0, p.s);
  load_tile_f32<D>(vs, static_cast<const float*>(p.v) + b * p.sv.sb +
                           kvh * p.sv.sh, p.sv.ss, k0, p.s);
  float dk[NC], dv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) dk[c] = dv[c] = 0.f;
  int first, last;
  live_tiles(p, k0, kF32Tile, false, &first, &last);
  for (int j = 0; j < group; ++j) {
    const int h = kvh * group + j;
    const long row0 = (static_cast<long>(b) * p.h + h) * p.s;
    for (int qt = first; qt < last; ++qt) {
      const int q0 = qt * kF32Tile;
      __syncthreads();
      load_tile_f32<D>(qs, static_cast<const float*>(p.q) + b * p.sq.sb +
                               h * p.sq.sh, p.sq.ss, q0, p.s);
      load_tile_f32<D>(gs, static_cast<const float*>(p.dout) + b * p.sdo.sb +
                               h * p.sdo.sh, p.sdo.ss, q0, p.s);
      if (threadIdx.x < kF32Tile) {
        const int i = q0 + threadIdx.x;
        lse[threadIdx.x] = i < p.s ? p.lse[row0 + i] : 0.f;
        dl[threadIdx.x] = i < p.s ? p.delta[row0 + i] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int qc = c8 + 8 * jj;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(ks[kr * DP + d], qs[qc * DP + d], s);
          dp = fmaf(vs[kr * DP + d], gs[qc * DP + d], dp);
        }
        const float pr =
            masked(p, q0 + qc, k0 + kr) ? 0.f : expf(s * p.scale - lse[qc]);
        ps[kr * SP + qc] = pr;
        dss[kr * SP + qc] = pr * (dp - dl[qc]);
      }
      __syncthreads();
      for (int q = 0; q < kF32Tile; ++q) {
        const float pr = ps[kr * SP + q], ds = dss[kr * SP + q];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv[c] = fmaf(pr, gs[q * DP + c8 + 8 * c], dv[c]);
          dk[c] = fmaf(ds, qs[q * DP + c8 + 8 * c], dk[c]);
        }
      }
    }
  }
  const int row = k0 + kr;
  if (row < p.s) {
    float* dkg = static_cast<float*>(p.dk) + b * p.sdk.sb + kvh * p.sdk.sh +
                 row * p.sdk.ss;
    float* dvg = static_cast<float*>(p.dv) + b * p.sdv.sb + kvh * p.sdv.sh +
                 row * p.sdv.ss;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkg[c8 + 8 * c] = dk[c] * p.scale;
      dvg[c8 + 8 * c] = dv[c];
    }
  }
}

// (iii) in float32: a block a (query tile of 32, longest first, head,
// batch); thread (qr, lane8) as in (ii) with query rows.
template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_dq_f32_kernel(const BwdParams p) {
  constexpr int DP = D + 1, SP = kF32Tile + 1, NC = D / 8;
  extern __shared__ float smem[];
  float* qs = smem;
  float* gs = qs + kF32Tile * DP;
  float* ks = gs + kF32Tile * DP;
  float* vs = ks + kF32Tile * DP;
  float* dss = vs + kF32Tile * DP;
  float* lse = dss + 2 * kF32Tile * SP;
  float* dl = lse + kF32Tile;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kF32Tile;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (p.h / p.kv);
  const int qr = threadIdx.x / 8, c8 = threadIdx.x % 8;
  const long row0 = (static_cast<long>(b) * p.h + h) * p.s;
  load_tile_f32<D>(qs, static_cast<const float*>(p.q) + b * p.sq.sb +
                           h * p.sq.sh, p.sq.ss, q0, p.s);
  load_tile_f32<D>(gs, static_cast<const float*>(p.dout) + b * p.sdo.sb +
                           h * p.sdo.sh, p.sdo.ss, q0, p.s);
  if (threadIdx.x < kF32Tile) {
    const int i = q0 + threadIdx.x;
    lse[threadIdx.x] = i < p.s ? p.lse[row0 + i] : 0.f;
    dl[threadIdx.x] = i < p.s ? p.delta[row0 + i] : 0.f;
  }
  float dq[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) dq[c] = 0.f;
  int first, last;
  live_tiles(p, q0, kF32Tile, true, &first, &last);
  for (int kt = first; kt < last; ++kt) {
    const int k0 = kt * kF32Tile;
    __syncthreads();
    load_tile_f32<D>(ks, static_cast<const float*>(p.k) + b * p.sk.sb +
                             kvh * p.sk.sh, p.sk.ss, k0, p.s);
    load_tile_f32<D>(vs, static_cast<const float*>(p.v) + b * p.sv.sb +
                             kvh * p.sv.sh, p.sv.ss, k0, p.s);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int kc = c8 + 8 * jj;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(qs[qr * DP + d], ks[kc * DP + d], s);
        dp = fmaf(gs[qr * DP + d], vs[kc * DP + d], dp);
      }
      const float pr =
          masked(p, q0 + qr, k0 + kc) ? 0.f : expf(s * p.scale - lse[qr]);
      dss[qr * SP + kc] = pr * (dp - dl[qr]);
    }
    __syncthreads();
    for (int k = 0; k < kF32Tile; ++k) {
      const float ds = dss[qr * SP + k];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        dq[c] = fmaf(ds, ks[k * DP + c8 + 8 * c], dq[c]);
    }
  }
  if (q0 + qr < p.s) {
    float* dqg = static_cast<float*>(p.dq) + b * p.sdq.sb + h * p.sdq.sh +
                 (q0 + qr) * p.sdq.ss;
#pragma unroll
    for (int c = 0; c < NC; ++c) dqg[c8 + 8 * c] = dq[c] * p.scale;
  }
}

// --------------------------------------------------------------- launchers
BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, void* dk, void* dv,
                      const int64_t* st, int h, int kv, int s, int causal,
                      int window, float scale) {
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  Strides* all[8] = {&p.sq, &p.sk, &p.sv, &p.so, &p.sdo, &p.sdq, &p.sdk,
                     &p.sdv};
  for (int i = 0; i < 8; ++i) *all[i] = Strides{st[3 * i], st[3 * i + 1],
                                                st[3 * i + 2]};
  p.h = h;
  p.kv = kv;
  p.s = s;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  return p;
}

template <typename T>
int launch_delta(const BwdParams& p, int b, int d, cudaStream_t stream) {
  const long rows = static_cast<long>(b) * p.h * p.s;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                              stream>>>(p, d, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_wgmma(const BwdParams& p, int b, cudaStream_t stream) {
  int err = launch_delta<__nv_bfloat16>(p, b, D, stream);
  if (err) return err;
  using K = DkdvTiles<D>;
  using Q = DqTiles<D>;
  // the tensor maps of (ii) (q, dO in stages of K::kBQ rows; k, v in items
  // of K::kBK) and of (iii) (q, dO in items of Q::kBQ; k, v in stages of
  // Q::kBK)
  CUtensorMap maps[8];
  const void* bases[4] = {p.q, p.dout, p.k, p.v};
  const Strides* st[4] = {&p.sq, &p.sdo, &p.sk, &p.sv};
  const int rows[8] = {K::kBQ, K::kBQ, K::kBK, K::kBK,
                       Q::kBQ, Q::kBQ, Q::kBK, Q::kBK};
  for (int i = 0; i < 8; ++i) {
    const int t = i % 4;
    if (!encode_map(&maps[i], bases[t], D, p.s, t < 2 ? p.h : p.kv, b,
                    st[t]->ss, st[t]->sh, st[t]->sb, rows[i]))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmemBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Q::kSmemBytes);
  int sms;  // one block an SM, each walking its work list
  if (e == cudaSuccess) e = multiprocessors(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long dkdv_items = static_cast<long>((p.s + K::kBK - 1) / K::kBK) *
                          p.kv * K::kColBlocks * b;
  flash_bwd_dkdv_wgmma_kernel<D>
      <<<static_cast<int>(dkdv_items < sms ? dkdv_items : sms),
         128 * (1 + K::kConsumers), K::kSmemBytes, stream>>>(
          maps[0], maps[1], maps[2], maps[3], p, b);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long dq_items = static_cast<long>((p.s + Q::kBQ - 1) / Q::kBQ) *
                        p.h * b;
  flash_bwd_dq_wgmma_kernel<D>
      <<<static_cast<int>(dq_items < sms ? dq_items : sms),
         128 * (1 + Q::kConsumers), Q::kSmemBytes, stream>>>(
          maps[4], maps[5], maps[6], maps[7], p, b);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const BwdParams& p, int b, cudaStream_t stream) {
  int err = launch_delta<float>(p, b, D, stream);
  if (err) return err;
  constexpr int bytes = f32_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_f32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (p.s + kF32Tile - 1) / kF32Tile;
  flash_bwd_dkdv_f32_kernel<D>
      <<<dim3(tiles, p.kv, b), 256, bytes, stream>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  flash_bwd_dq_f32_kernel<D><<<dim3(tiles, p.h, b), 256, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. `strides` is a host array of 24
// element strides: (batch, head, sequence) of q, k, v, out, dout, dq, dk and
// dv; the head_dim stride is 1, and for bf16 every base and every row
// stride is a multiple of 16 bytes (the wrapper checks). `lse` is the
// forward's (B, H, S) float32 log-sum-exp; `delta` is (B, H, S) float32
// scratch. Launches the three kernels on `stream` in order, does not
// synchronise, and returns the first launch's non-zero cudaError_t
// (cudaErrorInvalidValue for a head_dim other than 64, 128 or 192).
extern "C" {

int repro_flash_attention_bwd_bf16(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv,
                                   const int64_t* strides, int b, int h,
                                   int kv, int s, int d, int causal,
                                   int window, float scale, void* stream) {
  const BwdParams p = make_params(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                  strides, h, kv, s, causal, window, scale);
  auto st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_wgmma<64>(p, b, st);
  if (d == 128) return launch_wgmma<128>(p, b, st);
  if (d == 192) return launch_wgmma<192>(p, b, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int repro_flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const float* lse, float* delta, void* dq,
                                  void* dk, void* dv, const int64_t* strides,
                                  int b, int h, int kv, int s, int d,
                                  int causal, int window, float scale,
                                  void* stream) {
  const BwdParams p = make_params(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                  strides, h, kv, s, causal, window, scale);
  auto st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_f32<64>(p, b, st);
  if (d == 128) return launch_f32<128>(p, b, st);
  if (d == 192) return launch_f32<192>(p, b, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
