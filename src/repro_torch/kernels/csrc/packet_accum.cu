// Packet -> descriptor accumulation (switch aggregation) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_accum_kernel` of
// src/repro/kernels/packet_accum.py (entry point `packet_accumulate`): a
// segment-sum of payload rows into slots. The TPU kernel is a one-hot matmul
// on the MXU. That does not carry over: Hopper's tensor cores have no int32
// product, and an f32 product would go through TF32. Both entry points here
// are deterministic segmented reductions instead, with no atomics and no
// matmul. int32 is added as uint32 and cast back: the sum wraps like XLA's
// int32 add, without C++ signed-overflow undefined behaviour. bf16 is
// widened to f32 before it is added. Neighbouring lanes read neighbouring
// 16-byte groups of a row (4 values; 8 bytes for bf16) where the width is a
// multiple of 4 and the pointers are aligned, else one value each.
//
// 1. `repro_packet_accumulate_{i32,f32,bf16}`: (N, D) rows by slot id into
//    (num_slots, D), one launch, no sort. A CTA of 8 warps owns a tile of
//    slots x columns: `tpr` lanes cover a row's columns (tpr = the fewest
//    lanes, a power of two up to 32, that do), so a warp holds 32 / tpr
//    lane groups and each group 2 slots of the tile; a narrow D (fig6's 32:
//    8 lanes a row, 8 slots a tile) leaves no lane idle. The CTA stages
//    the ids in shared memory, 4096 at a time, and each warp scans an
//    eighth of them: it ballots which fall in the tile, 256 ids at once so
//    the checks do not wait on each other, lists them in row order (up to
//    256, then adds them and lists on) and adds the listed rows with up to
//    16 row loads in flight, each lane group the rows of its own slots. The
//    eight warps' partial sums are added in warp order at the end. So a
//    slot's rows are added in a fixed order (each warp's eighths in row
//    order, then the warps in order) and f32 sums repeat bit for bit. Ids
//    outside [0, num_slots) match no tile. Bound on the card: bytes, N*D
//    payload read once plus num_slots*D written; at the repo's shapes a
//    launch is bound by latency instead: the id load, the scan and one or
//    two rounds of row loads. On top of the bound every CTA reads all N
//    ids, N * id_bytes * ceil(num_slots / slots_per_CTA) * ceil(D / (tpr *
//    vec)) bytes, mostly from L2: ROUND_SHAPE (128, 256, 8): 4 x 2 CTAs,
//    4 KiB; FIG6_SHAPE (4096, 32, 1024): 128 x 1 CTAs, 2 MiB. Small tiles
//    spread the scan over many SMs; a smaller tile would read the ids more
//    often.
//
// 2. `repro_packet_accumulate_gather_{i32,f32}`: one height level of a
//    replay plan (src/repro_torch/core/trace/plan.py) over every block:
//    out[dst[s]] = sum of rows src[seg_offsets[s] : seg_offsets[s + 1]].
//    A source row is a row of the (P, B, D) input (src >= 0) or of the
//    scratch table of switch nodes (src = -1 - row); a segment writes a
//    scratch row (dst >= 0) or, for block b's root (dst = -1 - b), row b of
//    every participant's output. One CTA a segment (x) and column tile (y):
//    its 8 warps take the segment's rows in turn (row j to warp j mod 8),
//    each warp adds its rows in order with 4 row loads in flight, and the 8
//    partial sums are added in warp order. That order depends only on the
//    plan, so f32 sums repeat bit for bit. The plan gives fan-in-1 copies
//    no segment, so every segment but a root's adds two rows or more; a
//    root's P copies are dealt to the 8 warps. Rows read in a launch were
//    written by earlier launches, never by this one. Bound on the card:
//    bytes, each source row read once, each switch-node row written once
//    and each root written P times.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kAll = 0xffffffffu;

// Load V consecutive values of a row, widened to the accumulator type.
template <int V>
__device__ __forceinline__ void load(const int32_t* p, uint32_t (&a)[V]) {
  if constexpr (V == 4) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
  } else {
    a[0] = static_cast<uint32_t>(*p);
  }
}
template <int V>
__device__ __forceinline__ void load(const float* p, float (&a)[V]) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
  } else {
    a[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&a)[V]) {
  if constexpr (V == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    a[0] = lo.x; a[1] = lo.y; a[2] = hi.x; a[3] = hi.y;
  } else {
    a[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void store(int32_t* p, const uint32_t (&a)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(a[0], a[1], a[2], a[3]);
  } else {
    *p = static_cast<int32_t>(a[0]);
  }
}
template <int V>
__device__ __forceinline__ void store(float* p, const float (&a)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  } else {
    *p = a[0];
  }
}

// acc += v[u] for each u with use[u], in u order. Every load of a batch is
// issued, from a valid row, before the first add, so the loads overlap: an
// add under the same branch as its load would wait for each in turn.
template <int U, typename Acc, int V>
__device__ __forceinline__ void add_used(Acc (&acc)[V], Acc (&v)[U][V],
                                         const bool (&use)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = use[u] ? acc[e] + v[u][e] : acc[e];
  }
}

// ---------------------------------------------------------------- by slot id

constexpr int kSlotThreads = 256;
constexpr int kSlotWarps = kSlotThreads / 32;
constexpr int kOwn = 2;                       // slots a lane group owns
constexpr int kChunk = 4096;                  // ids staged in shared memory
constexpr int kPerThread = kChunk / kSlotThreads;
constexpr int kScanUnroll = 8;                // groups of 32 a warp scans at once
constexpr int kList = 32 * kScanUnroll;       // a warp's staged matches
constexpr int kSlotUnroll = 16;               // row loads a warp keeps in flight

// One lane's share of a CTA's tile: the `kOwn` slots `group + q * groups`
// (counted from the CTA's first slot) at the V columns from `col`.
template <typename In, typename Acc, int V>
struct BySlot {
  const In* payload;
  int d;
  int groups;               // lane groups of a warp: 32 / tpr, a power of 2
  int gshift;               // log2(groups)
  int group;
  int col;
  int safe_col;             // col where it is inside the row, else 0
  bool col_live;
  Acc acc[kOwn][V];

  // Add the rows of `list[0:count]` (offsets into the chunk at row `base`;
  // `chunk` holds each id's slot counted from the CTA's first slot) that
  // fall in this lane's slots, in list order.
  __device__ __forceinline__ void add(const int32_t* chunk,
                                      const int32_t* list, int count,
                                      int64_t base) {
    __syncwarp();   // the warp's list entries are visible
    for (int i = 0; i < count; i += kSlotUnroll) {
      Acc v[kSlotUnroll][V];
      bool use[kSlotUnroll];
      int own[kSlotUnroll];
#pragma unroll
      for (int u = 0; u < kSlotUnroll; ++u) {
        const bool listed = i + u < count;
        const int e = list[listed ? i + u : i];
        const int sl = chunk[e];
        use[u] = listed && col_live && (sl & (groups - 1)) == group;
        own[u] = sl >> gshift;
        load<V>(payload + (base + e) * d + safe_col, v[u]);
      }
#pragma unroll
      for (int q = 0; q < kOwn; ++q) {
        bool mine[kSlotUnroll];
#pragma unroll
        for (int u = 0; u < kSlotUnroll; ++u) mine[u] = use[u] && own[u] == q;
        add_used<kSlotUnroll>(acc[q], v, mine);
      }
    }
    __syncwarp();   // done with the list before it is written again
  }
};

template <typename In, typename Acc, typename Out, typename Id, int V>
__global__ void __launch_bounds__(kSlotThreads)
    accumulate_kernel(const In* __restrict__ payload,
                      const Id* __restrict__ ids, int64_t n, int num_slots,
                      int d, int tpr, Out* __restrict__ out) {
  __shared__ int32_t chunk[kChunk];             // slot - lo of each id, or -1
  __shared__ int32_t lists[kSlotWarps][kList];  // chunk offsets, row order
  __shared__ Acc part[kSlotWarps][kOwn * 32 * V];  // a warp's partial tile
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = kOwn * (32 / tpr);           // slots of this CTA
  const int lo = blockIdx.x * tile;
  const int width = min(tile, num_slots - lo);
  BySlot<In, Acc, V> w;
  w.payload = payload;
  w.d = d;
  w.groups = 32 / tpr;
  w.gshift = __ffs(w.groups) - 1;
  w.group = lane / tpr;
  w.col = (blockIdx.y * tpr + lane % tpr) * V;
  w.col_live = w.col < d;
  w.safe_col = w.col_live ? w.col : 0;
#pragma unroll
  for (int q = 0; q < kOwn; ++q) {
#pragma unroll
    for (int e = 0; e < V; ++e) w.acc[q][e] = 0;
  }
  int32_t* list = lists[warp];
  const unsigned below = (1u << lane) - 1;

  for (int64_t base = 0; base < n; base += kChunk) {
    Id raw[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {   // independent loads, all issued
      const int64_t j = base + k * kSlotThreads + threadIdx.x;
      raw[k] = j < n ? ids[j] : Id(-1);
    }
    __syncthreads();   // every warp is done with the previous chunk
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      chunk[k * kSlotThreads + threadIdx.x] =
          raw[k] >= lo && raw[k] < lo + width ? static_cast<int32_t>(raw[k] - lo)
                                              : -1;
    }
    __syncthreads();
    // Warp w scans its share of the chunk, in a tight loop left only to add
    // a full list, so the adds' unrolled code stays out of the loop.
    const int m = n - base < kChunk ? static_cast<int>(n - base) : kChunk;
    const int share = ((m + kSlotWarps - 1) / kSlotWarps + 31) & ~31;
    const int stop = min((warp + 1) * share, m);
    for (int g = warp * share;;) {
      int count = 0;   // warp-uniform: matches staged in `list`
      for (; g < stop; g += 32 * kScanUnroll) {
        unsigned hit[kScanUnroll];
        int total = 0;
#pragma unroll
        for (int k = 0; k < kScanUnroll; ++k) {   // independent: no chain
          const int i = g + k * 32 + lane;
          hit[k] = __ballot_sync(kAll, i < stop && chunk[i] >= 0);
          total += __popc(hit[k]);
        }
        if (count + total > kList) break;
#pragma unroll
        for (int k = 0; k < kScanUnroll; ++k) {
          if (hit[k] >> lane & 1) {
            list[count + __popc(hit[k] & below)] = g + k * 32 + lane;
          }
          count += __popc(hit[k]);
        }
      }
      w.add(chunk, list, count, base);
      if (g >= stop) break;
    }
  }
  // The warps' partial sums, added in warp order.
  Acc* mine = part[warp];
#pragma unroll
  for (int q = 0; q < kOwn; ++q) {
    const int at = ((w.group + q * w.groups) * tpr + lane % tpr) * V;
#pragma unroll
    for (int e = 0; e < V; ++e) mine[at + e] = w.acc[q][e];
  }
  __syncthreads();
  const int sl = threadIdx.x / tpr;   // threads past kOwn * 32 have none
  const int col = (blockIdx.y * tpr + threadIdx.x % tpr) * V;
  if (threadIdx.x < kOwn * 32 && sl < width && col < d) {
    Acc sum[V];
#pragma unroll
    for (int e = 0; e < V; ++e) sum[e] = part[0][threadIdx.x * V + e];
#pragma unroll
    for (int q = 1; q < kSlotWarps; ++q) {
#pragma unroll
      for (int e = 0; e < V; ++e) sum[e] += part[q][threadIdx.x * V + e];
    }
    store<V>(out + static_cast<int64_t>(lo + sl) * d + col, sum);
  }
}

template <typename In, typename Acc, typename Out>
int launch_accumulate(const void* payload, const void* ids, int id_bytes,
                      int64_t n, int num_slots, int d, void* out,
                      void* stream) {
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(payload) % (4 * sizeof(In)) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int v = vec ? 4 : 1;
  const int groups = (d + v - 1) / v;   // column groups a slot needs
  int tpr = 1;
  while (tpr < 32 && tpr < groups) tpr *= 2;
  const int per_cta = kOwn * (32 / tpr);
  const dim3 grid((num_slots + per_cta - 1) / per_cta,
                  (groups + tpr - 1) / tpr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const In* p = static_cast<const In*>(payload);
  Out* o = static_cast<Out*>(out);
  const auto* i32 = static_cast<const int32_t*>(ids);
  const auto* i64 = static_cast<const int64_t*>(ids);
  if (vec && id_bytes == 8) {
    accumulate_kernel<In, Acc, Out, int64_t, 4><<<grid, kSlotThreads, 0, s>>>(
        p, i64, n, num_slots, d, tpr, o);
  } else if (vec) {
    accumulate_kernel<In, Acc, Out, int32_t, 4><<<grid, kSlotThreads, 0, s>>>(
        p, i32, n, num_slots, d, tpr, o);
  } else if (id_bytes == 8) {
    accumulate_kernel<In, Acc, Out, int64_t, 1><<<grid, kSlotThreads, 0, s>>>(
        p, i64, n, num_slots, d, tpr, o);
  } else {
    accumulate_kernel<In, Acc, Out, int32_t, 1><<<grid, kSlotThreads, 0, s>>>(
        p, i32, n, num_slots, d, tpr, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- by replay plan level

constexpr int kGatherThreads = 256;
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr int kGatherUnroll = 4;                    // row loads in flight

template <typename T, typename Acc, int V>
__global__ void __launch_bounds__(kGatherThreads)
    gather_kernel(const T* __restrict__ leaf,
                  T* scratch,   // read (earlier levels' rows), written (this one's)
                  T* __restrict__ out,
                  const int32_t* __restrict__ seg_offsets,
                  const int32_t* __restrict__ src,
                  const int32_t* __restrict__ dst, int d, int bcast,
                  int64_t bcast_stride) {
  __shared__ Acc part[kGatherWarps][32 * V];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = (blockIdx.y * 32 + lane) * V;
  const bool live = col < d;
  const int end = seg_offsets[blockIdx.x + 1];
  Acc acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0;
  for (int j = seg_offsets[blockIdx.x] + warp; j < end;
       j += kGatherWarps * kGatherUnroll) {
    Acc v[kGatherUnroll][V];
    bool use[kGatherUnroll];
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) {
      const int jj = j + u * kGatherWarps;
      use[u] = jj < end;
      const int r = src[use[u] ? jj : j];
      const T* row = r >= 0 ? leaf + static_cast<int64_t>(r) * d
                            : scratch + static_cast<int64_t>(-1 - r) * d;
      load<V>(row + (live ? col : 0), v[u]);
    }
    add_used<kGatherUnroll>(acc, v, use);
  }
#pragma unroll
  for (int e = 0; e < V; ++e) part[warp][lane * V + e] = acc[e];
  __syncthreads();
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = part[0][lane * V + e];
  for (int w = 1; w < kGatherWarps; ++w) {
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] += part[w][lane * V + e];
  }
  if (!live) return;
  const int code = dst[blockIdx.x];
  if (code >= 0) {
    if (warp == 0) store<V>(scratch + static_cast<int64_t>(code) * d + col, acc);
    return;
  }
  const int64_t b = -1 - code;
  for (int p = warp; p < bcast; p += kGatherWarps) {
    store<V>(out + (p * bcast_stride + b) * d + col, acc);
  }
}

template <typename T, typename Acc>
int launch_gather(const void* leaf, void* scratch, void* out,
                  const void* seg_offsets, const void* src, const void* dst,
                  int num_segments, int d, int bcast, int64_t bcast_stride,
                  void* stream) {
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(leaf) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(scratch) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* l = static_cast<const T*>(leaf);
  T* sc = static_cast<T*>(scratch);
  T* o = static_cast<T*>(out);
  const auto* seg = static_cast<const int32_t*>(seg_offsets);
  const auto* sr = static_cast<const int32_t*>(src);
  const auto* ds = static_cast<const int32_t*>(dst);
  if (vec) {
    const dim3 grid(num_segments, (d + 127) / 128);
    gather_kernel<T, Acc, 4><<<grid, kGatherThreads, 0, s>>>(
        l, sc, o, seg, sr, ds, d, bcast, bcast_stride);
  } else {
    const dim3 grid(num_segments, (d + 31) / 32);
    gather_kernel<T, Acc, 1><<<grid, kGatherThreads, 0, s>>>(
        l, sc, o, seg, sr, ds, d, bcast, bcast_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Launches on `stream`, does not
// synchronise, returns the launch's cudaError_t.
extern "C" {

int repro_packet_accumulate_i32(const void* payload, const void* ids,
                                int id_bytes, int64_t n, int num_slots, int d,
                                void* out, void* stream) {
  return launch_accumulate<int32_t, uint32_t, int32_t>(
      payload, ids, id_bytes, n, num_slots, d, out, stream);
}

int repro_packet_accumulate_f32(const void* payload, const void* ids,
                                int id_bytes, int64_t n, int num_slots, int d,
                                void* out, void* stream) {
  return launch_accumulate<float, float, float>(payload, ids, id_bytes, n,
                                                num_slots, d, out, stream);
}

int repro_packet_accumulate_bf16(const void* payload, const void* ids,
                                 int id_bytes, int64_t n, int num_slots, int d,
                                 void* out, void* stream) {
  return launch_accumulate<__nv_bfloat16, float, float>(
      payload, ids, id_bytes, n, num_slots, d, out, stream);
}

int repro_packet_accumulate_gather_i32(const void* leaf, void* scratch,
                                       void* out, const void* seg_offsets,
                                       const void* src, const void* dst,
                                       int num_segments, int d, int bcast,
                                       int64_t bcast_stride, void* stream) {
  return launch_gather<int32_t, uint32_t>(leaf, scratch, out, seg_offsets,
                                          src, dst, num_segments, d, bcast,
                                          bcast_stride, stream);
}

int repro_packet_accumulate_gather_f32(const void* leaf, void* scratch,
                                       void* out, const void* seg_offsets,
                                       const void* src, const void* dst,
                                       int num_segments, int d, int bcast,
                                       int64_t bcast_stride, void* stream) {
  return launch_gather<float, float>(leaf, scratch, out, seg_offsets, src,
                                     dst, num_segments, d, bcast,
                                     bcast_stride, stream);
}

}  // extern "C"
