// Batch probe of the device-resident stack dictionary, and the feed's
// probe fused with its accumulate. CUDA C++ for sm_90a, plain C interface
// (loaded with ctypes by ops/kernels.py).
//
// Replaces parca_agent_tpu/aggregator/pallas_probe.py:make_batch_probe
// (the Pallas kernel at :78-131) and the accumulate half of
// parca_agent_tpu/aggregator/dict.py:make_feed (:123-129).
//
// What it computes, per query row i:
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
// 16 B of packed row (h1, h2, h3, cnt), the 16 B slots of its chain, and
// writes 4 B of found id plus, on a hit, one 4 B atomic and one flag. At
// the default capacity of 2^21 slots the table is 32 MB, which fits in the
// H100's 50 MB L2 and stays warm there between drains. The probe's slot
// loads are dependent within a row and random across rows: L2 round
// trips and L2 requests, not bytes, set the time; in the fused form the
// scatter (acc atomics, touch flags) weighs as much as the probe.
//
// Design: a group of G = 8 lanes serves G consecutive rows; lane j owns
// row j (its loads, its found store, its atomic). Round 0: each lane
// reads its own row's home slot (h1 & mask), one 16-byte read-only load,
// the request a lane-per-row probe makes; at the dictionary's load
// (<= 0.5) most rows stop there. Then a ballot over the group names the
// rows still walking, and the group walks them one after the other, G
// slots a round: in round r lane j loads slot (h1 + 1 + r G + j) & mask,
// so a round reads 128 contiguous bytes (the table is not written during
// the launch, the settle writes it in another). Each lane tests its slot
// for a stop (empty, or a full match); a ballot over the group and its
// lowest set bit give the first stop in k order, and its result comes
// from that lane by a shuffle. A chain's tail is at most
// ceil((PROBES - 1) / G) dependent round trips instead of PROBES - 1. A
// group that walks every row from step 0 in G-slot rounds was measured
// slower than a lane a row: it cuts the rows in flight by G and reads G
// slots where most rows need one. G = 4 was measured slower than G = 8
// at every shape (PERF.md).
// The touch flag is read before it is written: 128 ids share a flag, and
// a store to a flag already set would queue behind the others at one L2
// address. uint32_t arithmetic throughout, a launch on the caller's
// stream, outputs allocated by the caller, and cudaGetLastError()
// returned to the caller after every launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kProbes = 16;
constexpr int kThreads = 256;
constexpr int G = 8;  // lanes a group

// The first stop in k order of a walk that starts at step 1, by the whole
// group: the id there on a hit, else -1 (also past the probe bound). Every
// lane of the group gets it.
__device__ __forceinline__ int32_t walk_tail(const uint4* __restrict__ table,
                                             uint32_t mask, uint32_t q1,
                                             uint32_t q2, uint32_t q3, int j,
                                             unsigned gmask) {
#pragma unroll 1
  for (uint32_t k0 = 1; k0 < kProbes; k0 += G) {
    const uint32_t k = k0 + j;
    bool stop = false, hit = false;
    uint4 s = make_uint4(0u, 0u, 0u, 0u);
    if (k < kProbes) {
      s = __ldg(&table[(q1 + k) & mask]);
      hit = s.w != 0u && s.x == q1 && s.y == q2 && s.z == q3;
      stop = s.w == 0u || hit;
    }
    const unsigned stops = __ballot_sync(gmask, stop) & gmask;
    if (stops != 0u) {
      const int32_t mine = hit ? (int32_t)(s.w - 1u) : -1;
      return __shfl_sync(gmask, mine, __ffs(stops) - 1);
    }
  }
  return -1;  // past the probe bound: the host settles it
}

// G rows a group of G lanes. With cnt == nullptr it is the plain probe
// (batch_probe); else the feed's accumulate rides it.
__global__ void probe_kernel(const uint4* __restrict__ table, uint32_t mask,
                             const uint32_t* __restrict__ h1,
                             const uint32_t* __restrict__ h2,
                             const uint32_t* __restrict__ h3,
                             const uint32_t* __restrict__ cnt,
                             int32_t* __restrict__ acc, int64_t id_cap,
                             int32_t* __restrict__ touch, int64_t n_blocks,
                             int64_t blk, int32_t* __restrict__ found,
                             int64_t n) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int j = threadIdx.x % G;
  if (row - j >= n) return;  // the whole group is past the end
  const int lead = (threadIdx.x % 32) & ~(G - 1);
  const unsigned gmask = ((1u << G) - 1u) << lead;
  // Lanes past the end stay in the group's ballots, as done rows.
  const bool live = row < n;
  const uint32_t q1 = live ? h1[row] : 0u, q2 = live ? h2[row] : 0u,
                 q3 = live ? h3[row] : 0u;
  int32_t id = -1;
  bool done = !live;
  if (live) {
    const uint4 s = __ldg(&table[q1 & mask]);
    const bool hit = s.w != 0u && s.x == q1 && s.y == q2 && s.z == q3;
    done = s.w == 0u || hit;
    if (hit) id = (int32_t)(s.w - 1u);
  }
  unsigned walking = __ballot_sync(gmask, !done) & gmask;
  while (walking != 0u) {
    const int src = __ffs(walking) - 1;
    walking &= walking - 1u;
    const int32_t res = walk_tail(
        table, mask, __shfl_sync(gmask, q1, src),
        __shfl_sync(gmask, q2, src), __shfl_sync(gmask, q3, src), j, gmask);
    if ((int)(threadIdx.x % 32) == src) id = res;
  }
  if (!live) return;
  found[row] = id;
  if (cnt == nullptr || id < 0) return;
  const int32_t c = (int32_t)cnt[row];
  if (c <= 0) return;
  if (id < id_cap) atomicAdd(&acc[id], c);
  if (touch != nullptr && id / blk < n_blocks && touch[id / blk] != 1) {
    touch[id / blk] = 1;
  }
}

int launch(const void* table, int64_t cap, const void* h1,
           const void* h2, const void* h3, const void* cnt, void* acc,
           int64_t id_cap, void* touch, int64_t n_blocks, int64_t blk,
           void* found, int64_t n, void* stream) {
  if (n > 0) {
    // Whole groups: the last one may run past n.
    const int64_t threads = (n + G - 1) / G * G;
    const unsigned grid = (unsigned)((threads + kThreads - 1) / kThreads);
    probe_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)table, (uint32_t)(cap - 1), (const uint32_t*)h1,
        (const uint32_t*)h2, (const uint32_t*)h3, (const uint32_t*)cnt,
        (int32_t*)acc, id_cap, (int32_t*)touch, n_blocks, blk,
        (int32_t*)found, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() right after its launch
// (0 = launched); the Python wrapper raises on anything else.

int pa_batch_probe(const void* table, int64_t cap, const void* h1,
                   const void* h2, const void* h3, void* found, int64_t n,
                   void* stream) {
  return launch(table, cap, h1, h2, h3, nullptr, nullptr, 0, nullptr,
                0, 1, found, n, stream);
}

int pa_feed_accumulate(const void* table, int64_t cap, void* acc,
                       int64_t id_cap, void* touch, int64_t n_blocks,
                       int64_t blk, const void* h1, const void* h2,
                       const void* h3, const void* cnt, void* found,
                       int64_t n, void* stream) {
  return launch(table, cap, h1, h2, h3, cnt, acc, id_cap, touch,
                n_blocks, blk, found, n, stream);
}

const char* pa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
