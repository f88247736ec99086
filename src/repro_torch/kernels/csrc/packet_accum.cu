// Packet -> descriptor accumulation (switch aggregation) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_accum_kernel` of
// src/repro/kernels/packet_accum.py (entry point `packet_accumulate`): a
// segment-sum of (N, D) payload rows into (num_slots, D) slots by slot id.
// int32 payloads give an int32 result, f32 and bf16 payloads an f32 result.
//
// The TPU kernel is a one-hot matmul on the MXU. That does not carry over:
// Hopper's tensor cores have no int32 product, and an f32 product would go
// through TF32. This kernel is a deterministic segmented reduction instead,
// with no atomics and no matmul. The wrapper hands it a CSR view of the ids
// (`order`: row indices stably sorted by slot; `offsets`: num_slots + 1 row
// offsets into `order`, ids outside [0, num_slots) already left out). The
// grid is (num_slots, ceil(D / 256)); each thread owns one column of one
// slot and adds that slot's rows in row order, so the result is the same
// from run to run, for floats too. Neighbouring threads read neighbouring
// columns of a row, so each row is one coalesced read.
//
// int32 is added as uint32 and cast back: the sum wraps like XLA's int32
// add, without C++ signed-overflow undefined behaviour. bf16 is widened to
// f32 before it is added.
//
// Bound on the card: bytes, N * D * 4 read plus num_slots * D * 4 written
// (one add per element read). At the shapes of a replay round (N ~ 128,
// D = 256, a few slots) that is ~130 KiB, well under a microsecond of
// memory time, so a launch is bound by its launch overhead, not by this
// kernel's body.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t widen(int32_t v, uint32_t) {
  return static_cast<uint32_t>(v);
}
__device__ __forceinline__ float widen(float v, float) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v, float) {
  return __bfloat162float(v);
}

template <typename In, typename Acc, typename Out>
__global__ void packet_accumulate_kernel(const In* __restrict__ payload,
                                         const int32_t* __restrict__ order,
                                         const int32_t* __restrict__ offsets,
                                         Out* __restrict__ out, int d) {
  const int slot = blockIdx.x;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= d) return;
  const int begin = offsets[slot];
  const int end = offsets[slot + 1];
  Acc acc = 0;
  for (int j = begin; j < end; ++j) {
    acc += widen(payload[static_cast<int64_t>(order[j]) * d + col], Acc());
  }
  out[static_cast<int64_t>(slot) * d + col] = static_cast<Out>(acc);
}

template <typename In, typename Acc, typename Out>
int launch(const void* payload, const void* order, const void* offsets,
           void* out, int num_slots, int d, void* stream) {
  const dim3 grid(num_slots, (d + kThreads - 1) / kThreads);
  packet_accumulate_kernel<In, Acc, Out>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const In*>(payload), static_cast<const int32_t*>(order),
          static_cast<const int32_t*>(offsets), static_cast<Out*>(out), d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Launches on `stream`, does not
// synchronise, returns the launch's cudaError_t.
extern "C" {

int repro_packet_accumulate_i32(const void* payload, const void* order,
                                const void* offsets, void* out, int num_slots,
                                int d, void* stream) {
  return launch<int32_t, uint32_t, int32_t>(payload, order, offsets, out,
                                            num_slots, d, stream);
}

int repro_packet_accumulate_f32(const void* payload, const void* order,
                                const void* offsets, void* out, int num_slots,
                                int d, void* stream) {
  return launch<float, float, float>(payload, order, offsets, out, num_slots,
                                     d, stream);
}

int repro_packet_accumulate_bf16(const void* payload, const void* order,
                                 const void* offsets, void* out, int num_slots,
                                 int d, void* stream) {
  return launch<__nv_bfloat16, float, float>(payload, order, offsets, out,
                                             num_slots, d, stream);
}

}  // extern "C"
