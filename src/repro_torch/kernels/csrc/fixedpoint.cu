// Fixed-point quantize and dequantize for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_quant_kernel` and `_dequant_kernel` of
// src/repro/kernels/fixedpoint.py (entry points `quantize`, `dequantize`).
//
//   quantize:   q = int32(round_half_even(float32(x) * scale)),  x f32 or bf16
//   dequantize: y = float32(q) / scale                            (IEEE division)
//
// Bound on the card: bytes. Each element is read once and written once
// (f32: 4 B in + 4 B out; bf16: 2 B in + 4 B out) with one multiply or one
// division, far below the ~20 operations per byte at which an H100 stops
// being memory bound. The design therefore only has to stream: a grid-stride
// loop in which each thread moves 16 bytes of input per step (4 f32 or
// 8 bf16 values), neighbouring threads on neighbouring addresses. The
// scalar scale is read once per thread from a 1-element device buffer, so
// the host never waits for it.
//
// Bit-exactness with the reference: `__float2int_rn` rounds half to even
// like `jnp.round` (never `roundf`, which rounds half away from zero), the
// product is `__fmul_rn` (no contraction), and the division is `__fdiv_rn`,
// a correctly rounded division (never a reciprocal product). Build without
// --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 8192;

__device__ __forceinline__ int32_t quant1(float v, float s) {
  return __float2int_rn(__fmul_rn(v, s));
}

__device__ __forceinline__ float dequant1(int32_t v, float s) {
  return __fdiv_rn(__int2float_rn(v), s);
}

// The first `nvec` 16-byte groups go through vector loads; elements from
// nvec * 4 on (the ragged tail, or everything when a pointer is not 16-byte
// aligned) are done one by one.
__global__ void quantize_f32_kernel(const float* __restrict__ x,
                                    const float* __restrict__ scale,
                                    int32_t* __restrict__ q, int64_t n,
                                    int64_t nvec) {
  const float s = *scale;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  int4* q4 = reinterpret_cast<int4*>(q);
  for (int64_t i = tid; i < nvec; i += stride) {
    const float4 v = x4[i];
    q4[i] = make_int4(quant1(v.x, s), quant1(v.y, s), quant1(v.z, s),
                      quant1(v.w, s));
  }
  for (int64_t i = nvec * 4 + tid; i < n; i += stride) q[i] = quant1(x[i], s);
}

__global__ void quantize_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                     const float* __restrict__ scale,
                                     int32_t* __restrict__ q, int64_t n,
                                     int64_t nvec) {
  const float s = *scale;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint4* x8 = reinterpret_cast<const uint4*>(x);
  int4* q4 = reinterpret_cast<int4*>(q);
  for (int64_t i = tid; i < nvec; i += stride) {
    const uint4 raw = x8[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    const float2 c = __bfloat1622float2(h[2]);
    const float2 d = __bfloat1622float2(h[3]);
    q4[2 * i] = make_int4(quant1(a.x, s), quant1(a.y, s), quant1(b.x, s),
                          quant1(b.y, s));
    q4[2 * i + 1] = make_int4(quant1(c.x, s), quant1(c.y, s), quant1(d.x, s),
                              quant1(d.y, s));
  }
  for (int64_t i = nvec * 8 + tid; i < n; i += stride) {
    q[i] = quant1(__bfloat162float(x[i]), s);
  }
}

__global__ void dequantize_kernel(const int32_t* __restrict__ q,
                                  const float* __restrict__ scale,
                                  float* __restrict__ y, int64_t n,
                                  int64_t nvec) {
  const float s = *scale;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int4* q4 = reinterpret_cast<const int4*>(q);
  float4* y4 = reinterpret_cast<float4*>(y);
  for (int64_t i = tid; i < nvec; i += stride) {
    const int4 v = q4[i];
    y4[i] = make_float4(dequant1(v.x, s), dequant1(v.y, s), dequant1(v.z, s),
                        dequant1(v.w, s));
  }
  for (int64_t i = nvec * 4 + tid; i < n; i += stride) y[i] = dequant1(q[i], s);
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

// Blocks for a grid-stride loop over `nvec` vector steps plus a tail.
int blocks_for(int64_t n, int64_t nvec, int per_vec) {
  const int64_t tail = n - nvec * per_vec;
  const int64_t work = nvec > tail ? nvec : tail;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<int>(blocks);
}

}  // namespace

// Plain C interface, loaded with ctypes. Every function launches on the
// given stream, does not synchronise, and returns the launch's cudaError_t.
extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int repro_quantize_f32(const void* x, const void* scale, void* q, int64_t n,
                       void* stream) {
  const int64_t nvec = aligned16(x, q) ? n / 4 : 0;
  quantize_f32_kernel<<<blocks_for(n, nvec, 4), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<int32_t*>(q), n, nvec);
  return static_cast<int>(cudaGetLastError());
}

int repro_quantize_bf16(const void* x, const void* scale, void* q, int64_t n,
                        void* stream) {
  const int64_t nvec = aligned16(x, q) ? n / 8 : 0;
  quantize_bf16_kernel<<<blocks_for(n, nvec, 8), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
      static_cast<int32_t*>(q), n, nvec);
  return static_cast<int>(cudaGetLastError());
}

int repro_dequantize(const void* q, const void* scale, void* y, int64_t n,
                     void* stream) {
  const int64_t nvec = aligned16(q, y) ? n / 4 : 0;
  dequantize_kernel<<<blocks_for(n, nvec, 4), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q), static_cast<const float*>(scale),
      static_cast<float*>(y), n, nvec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
