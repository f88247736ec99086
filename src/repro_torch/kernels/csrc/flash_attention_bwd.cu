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
//  (ii)  dk, dv: one block a (key tile of 64, KV head, 64-column block of
//        D, batch). It loads its keys and values once, then walks every
//        query tile of every head of its group that the mask leaves live
//        for its keys, recomputing s^T and dp^T and summing dk and dv in
//        registers;
//  (iii) dq: one block a (query tile of 64, head, 64-column block, batch),
//        walking the key tiles live for its rows, summing dq in registers.
// A 64-column block keeps each warp's accumulators at 32 floats a product;
// at D = 128 and 192 the blocks of one tile recompute s and dp (2x and 3x
// those two products), at D = 64, the training path's, nothing is repeated.
//
// Bound on the card: operations. Five products of 2 S^2 / 2 D H each (s,
// dp, dv, dk, dq; causal) = 2.5x the forward's: 687 GFLOP at the
// llama3.2-1b training shape (1, 32, 8192, 64), 0.695 ms at 989 TFLOP/s.
// This first version is the simple one: bf16 products on the tensor cores
// through `mma.sync` m16n8k16 (f32 accumulate) with operands read from
// padded shared memory (a row pitch of D + 8 values: conflict-free fragment
// loads, both for the row-major operands and for the transposed ones read
// 16 bits at a time); tiles are loaded with plain 16-byte loads between
// barriers, with no overlap of loads and math. `wgmma` fed by TMA is a later
// redesign. float32 runs on FP32 FMA (TF32 would not meet the f32
// tolerance): 32 x 32 tiles, 256 threads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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
// (query, key) pair for the tile [a0, a0 + t) of this axis. `keys_of_queries`:
// this axis is queries (dq), else keys (dk, dv).
__device__ __forceinline__ void live_tiles(const BwdParams& p, int a0, int t,
                                           bool keys_of_queries, int* first,
                                           int* last) {
  const int n = (p.s + t - 1) / t;
  const int a_hi = min(a0 + t, p.s) - 1;
  if (keys_of_queries) {  // keys of queries [a0, a_hi]
    *last = p.causal ? min(n, a_hi / t + 1) : n;
    const int lo = p.window > 0 ? a0 - p.window + 1 : 0;
    *first = lo > 0 ? lo / t : 0;
  } else {  // queries of keys [a0, a_hi]
    *first = p.causal ? a0 / t : 0;
    *last = p.window > 0 ? min(n, (a_hi + p.window - 1) / t + 1) : n;
  }
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
constexpr int kTile = 64;  // rows of a query or key tile; 16 a warp
constexpr int kCols = 64;  // output columns a block

template <int D>
struct MmaTiles {
  static constexpr int kPitch = D + 8;  // bf16 values a shared-memory row
  static constexpr int kTileBytes = kTile * kPitch * 2;
  // four tiles (two of this axis, two of the other) and lse, delta rows
  static constexpr int kSmemBytes = 4 * kTileBytes + 2 * kTile * 4;
  static_assert(D % 64 == 0 && kSmemBytes <= 232448, "tile does not fit");
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* s) {
  return *reinterpret_cast<const uint32_t*>(s);
}

// Two bf16 values of one column from consecutive rows, packed low first.
__device__ __forceinline__ uint32_t ld_col_pair(const __nv_bfloat16* s,
                                                int pitch) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(s);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(s + pitch);
  return lo | (hi << 16);
}

// Rows [r0, r0 + 64) of a (.., S, D) bf16 tensor at `base` (row stride
// `ss`) into a shared tile of pitch D + 8; rows past S read as zeros.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base,
                                          int64_t ss, int r0, int s) {
  constexpr int kVecs = D / 8;  // 16-byte vectors a row
  for (int i = threadIdx.x; i < kTile * kVecs; i += blockDim.x) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < s)
      val = *reinterpret_cast<const uint4*>(base + (r0 + r) * ss + c);
    *reinterpret_cast<uint4*>(dst + r * MmaTiles<D>::kPitch + c) = val;
  }
}

// acc[nb] += A (16 rows of `a`, from row `r`) x B^T for the 8 column blocks
// of 8 rows of `b`: the product over all D of two row-major tiles, as
// mma.m16n8k16's A (row-major) and B ("col": B[k][n] = b[n][k]) fragments.
template <int D>
__device__ __forceinline__ void rows_by_rows(float (&acc)[8][4],
                                             const __nv_bfloat16* a,
                                             const __nv_bfloat16* b, int r,
                                             int g, int t) {
  constexpr int P = MmaTiles<D>::kPitch;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    const uint32_t af[4] = {ld32(a + (r + g) * P + c),
                            ld32(a + (r + g + 8) * P + c),
                            ld32(a + (r + g) * P + c + 8),
                            ld32(a + (r + g + 8) * P + c + 8)};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
      mma_bf16(acc[nb], af, ld32(b + (nb * 8 + g) * P + c),
               ld32(b + (nb * 8 + g) * P + c + 8));
  }
}

// acc[nb] += X (16 x 64, in C fragments of 8 column blocks) x b[:, c0 + ..]
// for 8 column blocks of 8: column blocks 2 ks and 2 ks + 1 of X are the A
// fragment of k-step ks (rows 16 ks .. 16 ks + 15 of `b`), whose B fragment
// pairs two rows of one column of `b`.
template <int D>
__device__ __forceinline__ void frags_by_tile(float (&acc)[8][4],
                                              const float (&x)[8][4],
                                              const __nv_bfloat16* b, int c0,
                                              int g, int t) {
  constexpr int P = MmaTiles<D>::kPitch;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint32_t af[4] = {pack_bf16(x[2 * ks][0], x[2 * ks][1]),
                            pack_bf16(x[2 * ks][2], x[2 * ks][3]),
                            pack_bf16(x[2 * ks + 1][0], x[2 * ks + 1][1]),
                            pack_bf16(x[2 * ks + 1][2], x[2 * ks + 1][3])};
    const __nv_bfloat16* row = b + (16 * ks + 2 * t) * P + c0 + g;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
      mma_bf16(acc[nb], af, ld_col_pair(row + nb * 8, P),
               ld_col_pair(row + 8 * P + nb * 8, P));
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
}

// Writes 16 rows (from `r0` + the warp's row `r`) x 64 columns of acc * mul
// as bf16 to `out` (row stride `ss`), rows past S left alone.
__device__ __forceinline__ void store_rows(const float (&acc)[8][4],
                                           __nv_bfloat16* out, int64_t ss,
                                           int row, int s, int c0, int t,
                                           float mul) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const int col = c0 + nb * 8 + 2 * t;
    if (row < s)
      *reinterpret_cast<uint32_t*>(out + row * ss + col) =
          pack_bf16(acc[nb][0] * mul, acc[nb][1] * mul);
    if (row + 8 < s)
      *reinterpret_cast<uint32_t*>(out + (row + 8) * ss + col) =
          pack_bf16(acc[nb][2] * mul, acc[nb][3] * mul);
  }
}

// (ii) dk, dv. Grid: (key tiles, KV heads x column blocks, B); 4 warps, a
// warp's 16 keys. For each live (head, query tile): s^T = k q^T and
// dp^T = v dO^T over all D, p^T = exp(s^T scale - lse) (0 where masked),
// ds^T = p^T (dp^T - delta), then dv += p^T dO and dk += ds^T q on this
// block's 64 columns.
template <int D>
__global__ void __launch_bounds__(128)
    flash_bwd_dkdv_mma_kernel(const BwdParams p) {
  using T = MmaTiles<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kTile * T::kPitch;
  __nv_bfloat16* qs = vs + kTile * T::kPitch;
  __nv_bfloat16* gs = qs + kTile * T::kPitch;  // dO
  float* lse2 = reinterpret_cast<float*>(gs + kTile * T::kPitch);
  float* dl = lse2 + kTile;

  constexpr int kBlocks = D / kCols;
  const int k0 = blockIdx.x * kTile;
  const int kvh = blockIdx.y / kBlocks, c0 = (blockIdx.y % kBlocks) * kCols;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r = 16 * warp;
  const int group = p.h / p.kv;
  const float scale_log2 = p.scale * kLog2e;

  load_tile<D>(ks, static_cast<const __nv_bfloat16*>(p.k) + b * p.sk.sb +
                       kvh * p.sk.sh, p.sk.ss, k0, p.s);
  load_tile<D>(vs, static_cast<const __nv_bfloat16*>(p.v) + b * p.sv.sb +
                       kvh * p.sv.sh, p.sv.ss, k0, p.s);
  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  int first, last;
  live_tiles(p, k0, kTile, false, &first, &last);
  for (int j = 0; j < group; ++j) {
    const int h = kvh * group + j;
    const long row0 = (static_cast<long>(b) * p.h + h) * p.s;
    for (int qt = first; qt < last; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the last tile's q and dO are read
      load_tile<D>(qs, static_cast<const __nv_bfloat16*>(p.q) + b * p.sq.sb +
                           h * p.sq.sh, p.sq.ss, q0, p.s);
      load_tile<D>(gs, static_cast<const __nv_bfloat16*>(p.dout) +
                           b * p.sdo.sb + h * p.sdo.sh, p.sdo.ss, q0, p.s);
      if (threadIdx.x < kTile) {
        const int i = q0 + threadIdx.x;
        lse2[threadIdx.x] = i < p.s ? p.lse[row0 + i] * kLog2e : 0.f;
        dl[threadIdx.x] = i < p.s ? p.delta[row0 + i] : 0.f;
      }
      __syncthreads();
      float st[8][4], dpt[8][4];
      zero(st);
      zero(dpt);
      rows_by_rows<D>(st, ks, qs, r, g, t);
      rows_by_rows<D>(dpt, vs, gs, r, g, t);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + r + g + (e >= 2 ? 8 : 0);
          const int ql = nb * 8 + 2 * t + (e & 1);
          const float pr =
              masked(p, q0 + ql, kpos)
                  ? 0.f
                  : exp2f(fmaf(st[nb][e], scale_log2, -lse2[ql]));
          st[nb][e] = pr;
          dpt[nb][e] = pr * (dpt[nb][e] - dl[ql]);
        }
      frags_by_tile<D>(dv, st, gs, c0, g, t);
      frags_by_tile<D>(dk, dpt, qs, c0, g, t);
    }
  }
  store_rows(dk, static_cast<__nv_bfloat16*>(p.dk) + b * p.sdk.sb +
                     kvh * p.sdk.sh, p.sdk.ss, k0 + r + g, p.s, c0, t,
             p.scale);
  store_rows(dv, static_cast<__nv_bfloat16*>(p.dv) + b * p.sdv.sb +
                     kvh * p.sdv.sh, p.sdv.ss, k0 + r + g, p.s, c0, t, 1.f);
}

// (iii) dq. Grid: (query tiles, longest first, H x column blocks, B); 4
// warps, a warp's 16 queries. For each live key tile: s = q k^T and
// dp = dO v^T over all D, p, ds, then dq += ds k on this block's columns.
template <int D>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_mma_kernel(const BwdParams p) {
  using T = MmaTiles<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* gs = qs + kTile * T::kPitch;  // dO
  __nv_bfloat16* ks = gs + kTile * T::kPitch;
  __nv_bfloat16* vs = ks + kTile * T::kPitch;
  float* lse2 = reinterpret_cast<float*>(vs + kTile * T::kPitch);
  float* dl = lse2 + kTile;

  constexpr int kBlocks = D / kCols;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y / kBlocks, c0 = (blockIdx.y % kBlocks) * kCols;
  const int b = blockIdx.z, kvh = h / (p.h / p.kv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r = 16 * warp;
  const float scale_log2 = p.scale * kLog2e;
  const long row0 = (static_cast<long>(b) * p.h + h) * p.s;

  load_tile<D>(qs, static_cast<const __nv_bfloat16*>(p.q) + b * p.sq.sb +
                       h * p.sq.sh, p.sq.ss, q0, p.s);
  load_tile<D>(gs, static_cast<const __nv_bfloat16*>(p.dout) + b * p.sdo.sb +
                       h * p.sdo.sh, p.sdo.ss, q0, p.s);
  if (threadIdx.x < kTile) {
    const int i = q0 + threadIdx.x;
    lse2[threadIdx.x] = i < p.s ? p.lse[row0 + i] * kLog2e : 0.f;
    dl[threadIdx.x] = i < p.s ? p.delta[row0 + i] : 0.f;
  }
  float dq[8][4];
  zero(dq);
  int first, last;
  live_tiles(p, q0, kTile, true, &first, &last);
  for (int kt = first; kt < last; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's k and v are read
    load_tile<D>(ks, static_cast<const __nv_bfloat16*>(p.k) + b * p.sk.sb +
                         kvh * p.sk.sh, p.sk.ss, k0, p.s);
    load_tile<D>(vs, static_cast<const __nv_bfloat16*>(p.v) + b * p.sv.sb +
                         kvh * p.sv.sh, p.sv.ss, k0, p.s);
    __syncthreads();
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    rows_by_rows<D>(s, qs, ks, r, g, t);
    rows_by_rows<D>(dp, gs, vs, r, g, t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ql = r + g + (e >= 2 ? 8 : 0);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int kpos = k0 + nb * 8 + 2 * t + (e & 1);
        const float pr = masked(p, q0 + ql, kpos)
                             ? 0.f
                             : exp2f(fmaf(s[nb][e], scale_log2, -lse2[ql]));
        dp[nb][e] = pr * (dp[nb][e] - dl[ql]);
      }
    }
    frags_by_tile<D>(dq, dp, ks, c0, g, t);
  }
  store_rows(dq, static_cast<__nv_bfloat16*>(p.dq) + b * p.sdq.sb +
                     h * p.sdq.sh, p.sdq.ss, q0 + r + g, p.s, c0, t, p.scale);
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
int launch_mma(const BwdParams& p, int b, cudaStream_t stream) {
  int err = launch_delta<__nv_bfloat16>(p, b, D, stream);
  if (err) return err;
  constexpr int bytes = MmaTiles<D>::kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_mma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (p.s + kTile - 1) / kTile, blocks = D / kCols;
  flash_bwd_dkdv_mma_kernel<D>
      <<<dim3(tiles, p.kv * blocks, b), 128, bytes, stream>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  flash_bwd_dq_mma_kernel<D>
      <<<dim3(tiles, p.h * blocks, b), 128, bytes, stream>>>(p);
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
  if (d == 64) return launch_mma<64>(p, b, st);
  if (d == 128) return launch_mma<128>(p, b, st);
  if (d == 192) return launch_mma<192>(p, b, st);
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
