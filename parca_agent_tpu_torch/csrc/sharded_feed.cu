// The sharded stack dictionary's feed (B7-feed): every shard's rows probed
// in that shard's home sub-table, hits accumulated into that shard's
// accumulator. CUDA C++ for sm_90a, plain C interface (loaded with ctypes
// by ops/kernels.py).
//
// Replaces parca_agent_tpu/aggregator/sharded.py:_sharded_feed_program
// (:74, jit + shard_map; its probe loop :92-111 and its scatter-add
// :113-115), a jnp program, not Pallas. The ordered miss compaction of
// that program (:116-123) stays torch ops on the card
// (aggregator/sharded.py:_compact_misses), as the single-table feed's
// does.
//
// What it computes. The host partitioned the drain by home shard
// (h2 % n_shards): part u32[S][5][n] holds shard s's rows in lanes
// 0 .. rows_s - 1 as (h1, h2, h3, count, original position), count 0 on
// the pad lanes. For each lane i of shard s with count > 0 (as int32):
//   up to PROBES linear-probe steps at slot (h1 + k) & (cap_s - 1) of the
//   sub-table table[s] u32[cap_s][4] = (h1, h2, h3, id + 1); the walk
//   stops at the first empty slot (id word 0) or the first full match.
//   found[s][i] = id on a hit, else -1 (also past the bound, and on every
//   dead lane), and a hit adds count to acc[s][id] (ids >= id_cap
//   dropped, as mode="drop"). The chains wrap within the sub-table, never
//   into the next shard's.
//
// What bounds it on an H100: memory, as the single-table feed
// (csrc/feed_probe.cu). Per live lane it reads 16 B of the partition
// (channel 4 is read by the compaction), the 16 B slots of its chain,
// and writes 4 B of found id and, on a hit, one 4 B atomic. At the
// default capacity the whole table, all shards, is 32 MB and stays in
// the 50 MB L2 between drains; dependent L2 round trips set the time.
//
// Design: feed_probe.cu's group of G = 8 lanes serving 8 rows, with the
// shard as the grid's second dimension (blockIdx.y), so every shard's
// lanes run at once on one card, as the mesh ran them on its devices.
// Each lane reads its row's home slot; the group then walks the rows
// still walking one after the other, G slots a round (128 contiguous
// bytes), and takes the first stop in k order by a ballot. Dead lanes
// (the pad, count 0) read nothing and stay in the ballots as done rows.
// The accumulator is the shard's own row of acc, so no two shards' adds
// meet. uint32_t arithmetic throughout; one launch on the caller's
// stream; outputs allocated by the caller; cudaGetLastError() returned.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kProbes = 16;
constexpr int kThreads = 256;
constexpr int G = 8;  // lanes a group

// The first stop in k order of a walk that starts at step 1, by the whole
// group: the id there on a hit, else -1 (also past the probe bound).
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

__global__ void sharded_feed_kernel(const uint4* __restrict__ table,
                                    int64_t cap_s, uint32_t mask,
                                    int32_t* __restrict__ acc, int64_t id_cap,
                                    const uint32_t* __restrict__ part,
                                    int64_t n, int32_t* __restrict__ found) {
  const int64_t s = blockIdx.y;
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int j = threadIdx.x % G;
  if (row - j >= n) return;  // the whole group is past the end
  const int lead = (threadIdx.x % 32) & ~(G - 1);
  const unsigned gmask = ((1u << G) - 1u) << lead;
  const uint32_t* p = part + s * 5 * n;
  const uint4* t = table + s * cap_s;
  const bool in = row < n;
  const int32_t c = in ? (int32_t)p[3 * n + row] : 0;
  const bool live = c > 0;
  const uint32_t q1 = live ? p[row] : 0u, q2 = live ? p[n + row] : 0u,
                 q3 = live ? p[2 * n + row] : 0u;
  int32_t id = -1;
  bool done = !live;
  if (live) {
    const uint4 e = __ldg(&t[q1 & mask]);
    const bool hit = e.w != 0u && e.x == q1 && e.y == q2 && e.z == q3;
    done = e.w == 0u || hit;
    if (hit) id = (int32_t)(e.w - 1u);
  }
  unsigned walking = __ballot_sync(gmask, !done) & gmask;
  while (walking != 0u) {
    const int src = __ffs(walking) - 1;
    walking &= walking - 1u;
    const int32_t res = walk_tail(
        t, mask, __shfl_sync(gmask, q1, src), __shfl_sync(gmask, q2, src),
        __shfl_sync(gmask, q3, src), j, gmask);
    if ((int)(threadIdx.x % 32) == src) id = res;
  }
  if (!in) return;
  found[s * n + row] = id;
  if (id >= 0 && id < id_cap) atomicAdd(&acc[s * id_cap + id], c);
}

}  // namespace

extern "C" {

// table u32[n_shards][cap_s][4], acc int32[n_shards][id_cap],
// part u32[n_shards][5][n], found int32[n_shards][n], all contiguous.
// Enqueues one kernel (none when there is nothing to probe) and returns
// cudaGetLastError() right after it (0 = launched); the Python wrapper
// raises on anything else. cap_s is a power of two (the wrapper checks).
int pa_sharded_feed(const void* table, int64_t n_shards, int64_t cap_s,
                    void* acc, int64_t id_cap, const void* part, int64_t n,
                    void* found, void* stream) {
  if (n > 0 && n_shards > 0) {
    // Whole groups: the last one may run past n.
    const int64_t threads = (n + G - 1) / G * G;
    const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads),
                    (unsigned)n_shards);
    sharded_feed_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)table, cap_s, (uint32_t)(cap_s - 1), (int32_t*)acc,
        id_cap, (const uint32_t*)part, n, (int32_t*)found);
  }
  return (int)cudaGetLastError();
}

const char* pa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
