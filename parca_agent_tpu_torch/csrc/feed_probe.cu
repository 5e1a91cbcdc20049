// Batch probe of the device-resident stack dictionary, and the feed's
// probe fused with its accumulate. CUDA C++ for sm_90a, plain C interface
// (loaded with ctypes by ops/kernels.py).
//
// Replaces parca_agent_tpu/aggregator/pallas_probe.py:make_batch_probe
// (the Pallas kernel at :78-131) and the accumulate half of
// parca_agent_tpu/aggregator/dict.py:make_feed (:123-129).
//
// What it computes, per query row i (one thread per row):
//   up to PROBES linear-probe steps at slot (h1 + k) & (cap - 1) of the
//   table u32[cap][4] = (h1, h2, h3, id + 1); the walk stops at the first
//   slot whose id word is 0 (empty) or whose (h1, h2, h3) equals the
//   row's. found[i] = id on a hit, else -1. A chain longer than PROBES
//   stays a miss; the host mirror absorbs it.
// feed_accumulate also adds, for each live row (cnt > 0 as int32) that
// hits: atomicAdd(acc[id], cnt) and touch[id / blk] = 1. Ids outside
// acc / touch are dropped, as the JAX scatter's mode="drop" drops them.
//
// What bounds it on an H100: memory, not arithmetic. Per row it reads
// ~16 B of packed row (h1, h2, h3, cnt), then 16 B per probe step as one
// uint4 load of a random slot, then one 4 B atomic; it writes 4 B of
// found id. The compares are a handful of integer ops per step. At the
// default capacity of 2^21 slots the table is 32 MB, which fits in the
// H100's 50 MB L2, so the random slot loads are served mostly from L2
// once the table is warm; the packed rows stream once from HBM.
//
// Design, kept simple on purpose: one thread per row, one 16-byte load
// per probe step (the table rows are 16-byte aligned), uint32_t
// arithmetic throughout, a launch on the caller's stream, outputs
// allocated by the caller, and cudaGetLastError() returned to the caller
// after every launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kProbes = 16;
constexpr int kThreads = 256;

__device__ __forceinline__ int32_t probe_one(const uint4* __restrict__ table,
                                             uint32_t mask, uint32_t h1,
                                             uint32_t h2, uint32_t h3) {
#pragma unroll 1
  for (uint32_t k = 0; k < kProbes; ++k) {
    const uint4 r = __ldg(&table[(h1 + k) & mask]);
    if (r.w == 0u) return -1;  // empty slot ends the chain
    if (r.x == h1 && r.y == h2 && r.z == h3) return (int32_t)(r.w - 1u);
  }
  return -1;  // past the probe bound: the host settles it
}

__global__ void batch_probe_kernel(const uint4* __restrict__ table,
                                   uint32_t mask,
                                   const uint32_t* __restrict__ h1,
                                   const uint32_t* __restrict__ h2,
                                   const uint32_t* __restrict__ h3,
                                   int32_t* __restrict__ found, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  found[i] = probe_one(table, mask, h1[i], h2[i], h3[i]);
}

__global__ void feed_accumulate_kernel(const uint4* __restrict__ table,
                                       uint32_t mask,
                                       int32_t* __restrict__ acc,
                                       int64_t id_cap,
                                       int32_t* __restrict__ touch,
                                       int64_t n_blocks, int64_t blk,
                                       const uint32_t* __restrict__ h1,
                                       const uint32_t* __restrict__ h2,
                                       const uint32_t* __restrict__ h3,
                                       const uint32_t* __restrict__ cnt,
                                       int32_t* __restrict__ found,
                                       int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t id = probe_one(table, mask, h1[i], h2[i], h3[i]);
  found[i] = id;
  const int32_t c = (int32_t)cnt[i];
  if (id < 0 || c <= 0) return;
  if (id < id_cap) atomicAdd(&acc[id], c);
  if (touch != nullptr && id / blk < n_blocks) touch[id / blk] = 1;
}

inline unsigned grid_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() right after its launch
// (0 = launched); the Python wrapper raises on anything else.

int pa_batch_probe(const void* table, int64_t cap, const void* h1,
                   const void* h2, const void* h3, void* found, int64_t n,
                   void* stream) {
  if (n > 0) {
    batch_probe_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)table, (uint32_t)(cap - 1), (const uint32_t*)h1,
        (const uint32_t*)h2, (const uint32_t*)h3, (int32_t*)found, n);
  }
  return (int)cudaGetLastError();
}

int pa_feed_accumulate(const void* table, int64_t cap, void* acc,
                       int64_t id_cap, void* touch, int64_t n_blocks,
                       int64_t blk, const void* h1, const void* h2,
                       const void* h3, const void* cnt, void* found,
                       int64_t n, void* stream) {
  if (n > 0) {
    feed_accumulate_kernel<<<grid_for(n), kThreads, 0,
                             (cudaStream_t)stream>>>(
        (const uint4*)table, (uint32_t)(cap - 1), (int32_t*)acc, id_cap,
        (int32_t*)touch, n_blocks, blk, (const uint32_t*)h1,
        (const uint32_t*)h2, (const uint32_t*)h3, (const uint32_t*)cnt,
        (int32_t*)found, n);
  }
  return (int)cudaGetLastError();
}

const char* pa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
