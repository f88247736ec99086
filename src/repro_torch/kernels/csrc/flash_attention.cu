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
// masked, so S need not be a multiple of the tile.
//
// The TPU kernel walks a sequential grid and carries (m, l, acc) in VMEM
// scratch across its kv axis. Here one block owns a (b, q-head, 64-row q
// tile) and loops over the 64-key tiles itself, with the state in registers;
// tiles that the causal or window mask wholly covers for the block's rows are
// skipped, as `pl.when` skips them. No atomics and no split over keys: the
// result is the same, bit for bit, from run to run. The longest q tiles are
// scheduled first (blockIdx.x counts down the sequence).
//
// Two bodies:
//  * bf16 (the model's path): FlashAttention-2's warp layout. Four warps, 16
//    q rows each; q k^T and p v are `mma.sync.m16n8k16` (bf16 in, f32
//    accumulate); p becomes the A operand of p v straight from the q k^T
//    accumulator registers, rounded to bf16; v's B fragments come from
//    `ldmatrix.trans`. Logits are scaled by 1/sqrt(D) in f32 after the
//    product (the f32 q the reference scales has no bf16 image; for D = 64
//    the scale is a power of two and both orders give the same bits).
//  * f32: FP32 FMA on the CUDA cores, never TF32 (TF32 keeps ~3 digits and
//    cannot meet the reference's 2e-5). 256 threads as 16 x 16; a thread
//    owns 4 rows x 4 keys of the score tile and 4 rows x D/16 columns of the
//    accumulator; q is scaled by 1/sqrt(D) in f32 before the product, as the
//    reference scales it.
//
// Bound on the card: operations. The causal llama3.2-1b prefill shape
// (1, 32, 4096, 64) does 2 * S^2 * D * H = 68.7 GFLOP of useful products
// against 42 MB of q, k, v and out: 0.069 ms at the 989 TFLOP/s bf16 dense
// peak against 0.0125 ms of HBM time. This design (synchronous tile loads,
// mma.sync rather than wgmma, no TMA, no producer warp) is the simple first
// form; the Hopper redesign is a later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;  // q rows per block
constexpr int kBK = 64;  // keys per tile
constexpr float kMaskValue = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
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

// [first, last) key tiles that hold a live key for some row in
// [q0, q0 + kBQ): tiles wholly masked for every row of the block are skipped.
__device__ __forceinline__ void tile_range(const Params& p, int q0, int* first,
                                           int* last) {
  const int nk = (p.s + kBK - 1) / kBK;
  const int row_hi = min(q0 + kBQ, p.s) - 1;
  *last = p.causal ? min(nk, row_hi / kBK + 1) : nk;
  const int key_lo = p.window > 0 ? q0 - p.window + 1 : 0;
  *first = key_lo > 0 ? key_lo / kBK : 0;
}

// ----------------------------------------------------------------- bf16 body
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layouts of mma.m16n8k16 (PTX ISA, "Matrix fragments"), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, rows x k): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g,
//     2t+8..), a3 = (g+8, 2t+8..);
//   B (16 x 8, k x n):      b0 = (2t..2t+1, g), b1 = (2t+8.., g);
//   C (16 x 8):             c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..).
template <int D>
__global__ void __launch_bounds__(128)
    flash_attention_bf16_kernel(const Params p) {
  constexpr int KP = D + 8;  // padded smem row: conflict-free fragment reads
  constexpr int NT = kBK / 8;  // n-tiles of q k^T
  constexpr int KS = D / 16;   // k-steps of q k^T
  constexpr int DN = D / 8;    // n-tiles of p v
  __shared__ __align__(16) __nv_bfloat16 ks[kBK * KP];
  __shared__ __align__(16) __nv_bfloat16 vs[kBK * KP];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.h / p.kv);
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) +
                            b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) +
                            b * p.v_sb + kvh * p.v_sh;
  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;

  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = (j & 1) ? r_hi : r_lo;
      const int col = kk * 16 + (j >> 1) * 8 + 2 * t;
      qa[kk][j] = row < p.s ? *reinterpret_cast<const uint32_t*>(
                                  qg + row * p.q_ss + col)
                            : 0u;
    }
  }

  float m_lo = kMaskValue, m_hi = kMaskValue, l_lo = 0.f, l_hi = 0.f;
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[dn][j] = 0.f;

  int first, last;
  tile_range(p, q0, &first, &last);
  for (int kt = first; kt < last; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kBK * D / 8; i += blockDim.x) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (k0 + r < p.s) {
        kv4 = *reinterpret_cast<const uint4*>(kg + (k0 + r) * p.k_ss + c);
        vv4 = *reinterpret_cast<const uint4*>(vg + (k0 + r) * p.v_ss + c);
      }
      *reinterpret_cast<uint4*>(&ks[r * KP + c]) = kv4;
      *reinterpret_cast<uint4*>(&vs[r * KP + c]) = vv4;
    }
    __syncthreads();

    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[nt][j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const __nv_bfloat16* kr = &ks[(nt * 8 + g) * KP + kk * 16 + 2 * t];
        mma_bf16(sc[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    float mx_lo = kMaskValue, mx_hi = kMaskValue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + nt * 8 + 2 * t + (j & 1);
        const int qpos = j < 2 ? r_lo : r_hi;
        sc[nt][j] = masked(p, qpos, kpos) ? kMaskValue : sc[nt][j] * p.scale;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(sc[nt][0], sc[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[nt][2], sc[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a row
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float corr_lo = expf(m_lo - mn_lo), corr_hi = expf(m_hi - mn_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sc[nt][0] = expf(sc[nt][0] - mn_lo);
      sc[nt][1] = expf(sc[nt][1] - mn_lo);
      sc[nt][2] = expf(sc[nt][2] - mn_hi);
      sc[nt][3] = expf(sc[nt][3] - mn_hi);
      sum_lo += sc[nt][0] + sc[nt][1];
      sum_hi += sc[nt][2] + sc[nt][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, off);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, off);
    }
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      acc[dn][0] *= corr_lo;
      acc[dn][1] *= corr_lo;
      acc[dn][2] *= corr_hi;
      acc[dn][3] *= corr_hi;
    }

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      // lanes 0-7 / 8-15 address keys kk*16 + 0..7 / 8..15 of columns
      // dn*8..; lanes 16-31 the same keys of columns (dn+1)*8..
#pragma unroll
      for (int dn = 0; dn < DN; dn += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(
            vb, &vs[(kk * 16 + (lane & 15)) * KP + (dn + (lane >> 4)) * 8]);
        mma_bf16(acc[dn], pa, vb[0], vb[1]);
        mma_bf16(acc[dn + 1], pa, vb[2], vb[3]);
      }
    }
  }

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                      h * p.o_sh;
  const float den_lo = fmaxf(l_lo, 1e-20f), den_hi = fmaxf(l_hi, 1e-20f);
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (r_lo < p.s)
      *reinterpret_cast<uint32_t*>(og + r_lo * p.o_ss + col) =
          pack_bf16(acc[dn][0] / den_lo, acc[dn][1] / den_lo);
    if (r_hi < p.s)
      *reinterpret_cast<uint32_t*>(og + r_hi * p.o_ss + col) =
          pack_bf16(acc[dn][2] / den_hi, acc[dn][3] / den_hi);
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
#pragma unroll
    for (int c = 0; c < DC; ++c)
      og[row * p.o_ss + tx + 16 * c] = acc[i][c] / den;
  }
}

// --------------------------------------------------------------- launchers
Params make_params(const void* q, const void* k, const void* v, void* o,
                   const int64_t* strides, int h, int kv, int s, int causal,
                   int window, float scale) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
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
  const dim3 grid((p.s + kBQ - 1) / kBQ, p.h, b);
  flash_attention_bf16_kernel<D><<<grid, 128, 0, stream>>>(p);
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

// Plain C interface, loaded with ctypes. `strides` is a host array of 12
// element strides: (batch, head, sequence) of q, k, v and out; the head_dim
// stride is 1 and every row starts on 16 bytes (the wrapper checks both).
// Launches on `stream`, does not synchronise, returns the launch's
// cudaError_t (cudaErrorInvalidValue for a head_dim other than 64 or 128).
extern "C" {

int repro_flash_attention_bf16(const void* q, const void* k, const void* v,
                               void* o, const int64_t* strides, int b, int h,
                               int kv, int s, int d, int causal, int window,
                               float scale, void* stream) {
  const Params p = make_params(q, k, v, o, strides, h, kv, s, causal, window,
                               scale);
  auto st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_bf16<64>(p, b, st);
  if (d == 128) return launch_bf16<128>(p, b, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int repro_flash_attention_f32(const void* q, const void* k, const void* v,
                              void* o, const int64_t* strides, int b, int h,
                              int kv, int s, int d, int causal, int window,
                              float scale, void* stream) {
  const Params p = make_params(q, k, v, o, strides, h, kv, s, causal, window,
                               scale);
  auto st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_f32<64>(p, b, st);
  if (d == 128) return launch_f32<128>(p, b, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
