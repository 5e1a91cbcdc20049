// The sharded stack dictionary's feed (B7-feed), whole, in one launch:
// every row routed to its home shard, probed in that shard's sub-table,
// hits accumulated into that shard's accumulator, and every shard's misses
// compacted in packed order. CUDA C++ for sm_90a, plain C interface
// (loaded with ctypes by ops/kernels.py).
//
// Replaces parca_agent_tpu/aggregator/sharded.py:_sharded_feed_program
// (:74, jit + shard_map, a jnp program, not Pallas): its probe loop
// (:92-111), its scatter-add (:113-115) and its ordered miss compaction
// (:116-123), together with the host partition that fed it one shard a
// device (:330 _partition_packed). On one card the shards are the leading
// dimension of one tensor, so the kernel reads the feed's packed buffer as
// it is and takes each row's home shard itself.
//
// What it computes. packed u32[4][n] = (h1, h2, h3, count) in packed
// order, count 0 on dead lanes. For each lane r with count > 0 (as int32)
// and s = h2 % S (S need not be a power of two):
//   up to PROBES linear-probe steps at slot (h1 + k) & (cap_s - 1) of the
//   sub-table table[s] u32[cap_s][4] = (h1, h2, h3, id + 1); the walk stops
//   at the first empty slot (id word 0) or the first full match, and the
//   chain wraps within the sub-table. A hit adds count to acc[s][id] (ids
//   >= id_cap dropped, as mode="drop"); a miss (no match within the bound)
//   writes r at rank j of shard s's list, miss_rows[s][j], j = the number
//   of earlier live misses of shard s in packed order, and n_miss[s] is the
//   length of that list. Packed order within a shard is the lane order of
//   the JAX package's stable partition, so each list equals its
//   miss_rows[s]. Entries of miss_rows past n_miss[s] are not written.
//
// What bounds it on an H100: memory and latency. Per live row it must read
// 16 B of packed and the 16 B slots of its chain, and write one 4 B atomic
// on a hit or one 4 B miss row on a miss; per dead lane its 4 B count;
// plus the status records. A steady drain (~10^5 rows) is ~3.5 MB, about
// 1 us at 3.35 TB/s, so the launch itself (~1.7 us) and the dependent L2
// round trips of the probe and the look-back set the time. At the default
// capacity the whole table, all shards, is 32 MB and stays in the 50 MB L2
// between drains.
//
// Design: one launch a feed, a single pass with decoupled look-back
// (Merrill and Garland, as csrc/close_pack.cu), the scanned value a vector
// of S per-shard miss counts. A tile is 1,024 consecutive lanes, one a
// thread, and a CTA takes its tile from an atomic ticket, so a tile only
// ever waits on tiles that are already running. A tile:
//   1. probes: feed_probe.cu's group of G = 8 lanes serving 8 rows. Each
//      lane reads its row's home slot; the group then walks the rows still
//      walking one after the other, G slots a round, and takes the first
//      stop in k order by a ballot. A group's rows may lie in different
//      sub-tables, so the walked row's shard travels with its key. Dead
//      lanes read only their count and stay in the ballots as done rows.
//   2. ranks its misses: within a warp, __match_any_sync on the shard
//      gives each miss its peers, its rank the popcount of the lower
//      peers; the peers' leader writes the warp's count for that shard to
//      shared memory; a scan over the 32 warps, a thread a shard, gives
//      each warp its offset in the tile and the tile's aggregate.
//   3. publishes its aggregate, one status record a shard, then looks back
//      one shard a warp: a shard's records lie in tile order, lane i reads
//      tile top - i's, one coalesced load a warp, and the warp sums the
//      records up to the nearest inclusive prefix, else the whole window
//      of 32 and the next. It publishes its inclusive prefix; the last
//      tile's are the shards' totals, n_miss. (Each of these was slower
//      when timed in turns on an H100: records laid out tile-major, whose
//      window is 32 scattered loads; windows of 64 to 512 tiles a round,
//      which read more records; tiles of 256 lanes, whose serial chain of
//      round trips, ticket, probe, look-back, four times as many tiles
//      pay.)
//   4. writes each miss row at its shard's exclusive prefix + the warp's
//      offset + its rank.
// A status record is one 8-byte word, (count << 32) | epoch << 1 | P,
// written and read in one access, so its status and its count are seen
// together and no fence orders them. Every record carries the call's
// epoch, kept in the scratch beside the ticket in one 64-bit word that a
// CTA's one atomic reads and bumps: the CTA with the last ticket resets
// the ticket and stores the epoch, and stream order makes the next call
// see both. Epochs start at 1, so the records of a freshly zeroed scratch
// read as stale, and the scratch is never cleared again. Only the hits'
// adds are atomic, and integer adds commute: the outputs are the same from
// run to run. uint32_t arithmetic on the keys; one launch on the caller's
// stream; outputs and scratch allocated by the caller; cudaGetLastError()
// returned.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kProbes = 16;
constexpr int kThreads = 1024;  // lanes a tile
constexpr int kWarps = kThreads / 32;
constexpr int G = 8;  // lanes a group
constexpr int64_t kMaxShards = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kEpochMask = 0x7fffffffu;

__device__ __forceinline__ unsigned long long ld_record(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_record(unsigned long long* p,
                                          unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long record(uint32_t count,
                                                     uint32_t epoch,
                                                     bool inclusive) {
  return (unsigned long long)count << 32 | epoch << 1 | (inclusive ? 1u : 0u);
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// The first stop in k order of a walk that starts at step 1, by the whole
// group, in the sub-table `t`: the id there on a hit, else -1 (also past
// the probe bound).
__device__ __forceinline__ int32_t walk_tail(const uint4* __restrict__ t,
                                             uint32_t mask, uint32_t q1,
                                             uint32_t q2, uint32_t q3, int j,
                                             unsigned gmask) {
#pragma unroll 1
  for (uint32_t k0 = 1; k0 < kProbes; k0 += G) {
    const uint32_t k = k0 + j;
    bool stop = false, hit = false;
    uint4 e = make_uint4(0u, 0u, 0u, 0u);
    if (k < kProbes) {
      e = __ldg(&t[(q1 + k) & mask]);
      hit = e.w != 0u && e.x == q1 && e.y == q2 && e.z == q3;
      stop = e.w == 0u || hit;
    }
    const unsigned stops = __ballot_sync(gmask, stop) & gmask;
    if (stops != 0u) {
      const int32_t mine = hit ? (int32_t)(e.w - 1u) : -1;
      return __shfl_sync(gmask, mine, __ffs(stops) - 1);
    }
  }
  return -1;  // past the probe bound: the host settles it
}

// Warp-wide: the exclusive prefix of shard s's misses before tile k > 0,
// from the predecessors' records of that shard (shard s's records are
// contiguous, rec[s * n_tiles + tile]), 32 at a time: lane i reads tile
// top - i, one coalesced 256-byte load a warp, and the warp sums the
// records up to the nearest inclusive prefix, else the whole window and
// the next.
__device__ uint32_t look_back(const unsigned long long* rec, int64_t k,
                              uint32_t epoch) {
  const int lane = threadIdx.x & 31;
  uint32_t ex = 0u;
  for (int64_t top = k - 1;; top -= 32) {
    const int64_t j = top - lane;
    // Before tile 0: an inclusive prefix of zero (never summed: tile 0's
    // own record is inclusive and comes first).
    unsigned long long r = record(0u, epoch, true);
    if (j >= 0) {
      do {
        r = ld_record(&rec[j]);
      } while (((uint32_t)r >> 1) != epoch);
    }
    const unsigned pm = __ballot_sync(kFull, (uint32_t)r & 1u);
    const int stop = pm ? __ffs(pm) - 1 : 32;
    ex += warp_sum(lane <= stop ? (uint32_t)(r >> 32) : 0u);
    if (pm) return ex;
  }
}

__global__ void __launch_bounds__(kThreads)
sharded_feed_kernel(const uint4* __restrict__ table, int64_t n_shards,
                    int64_t cap_s, uint32_t mask, int32_t* __restrict__ acc,
                    int64_t id_cap, const uint32_t* __restrict__ packed,
                    int64_t n, int64_t n_tiles, unsigned long long* hdr,
                    unsigned long long* rec, int32_t* __restrict__ n_miss,
                    int32_t* __restrict__ miss_rows) {
  // cnt[w * S + s]: warp w's misses of shard s, then its offset in the
  // tile; ex[s]: the tile's aggregate of shard s, then its exclusive
  // prefix.
  __shared__ uint32_t sh_cnt[kWarps * kMaxShards];
  __shared__ uint32_t sh_ex[kMaxShards];
  __shared__ uint32_t sh_ticket, sh_epoch;

  // The ticket and the epoch, in one atomic.
  if (threadIdx.x == 0) {
    const unsigned long long h = atomicAdd(hdr, 1ull);
    const uint32_t t = (uint32_t)h;
    uint32_t epoch = ((uint32_t)(h >> 32) + 1u) & kEpochMask;
    if (epoch == 0u) epoch = 1u;
    if (t == gridDim.x - 1) {  // every CTA has its ticket and epoch
      atomicExch(hdr, (unsigned long long)epoch << 32);
    }
    sh_ticket = t;
    sh_epoch = epoch;
  }
  for (int64_t i = threadIdx.x; i < kWarps * n_shards; i += kThreads) {
    sh_cnt[i] = 0u;
  }
  __syncthreads();
  const int64_t k = sh_ticket;
  const uint32_t epoch = sh_epoch;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // 1. Probe and accumulate.
  const int64_t row = k * kThreads + threadIdx.x;
  const int j = threadIdx.x % G;
  const int lead = lane & ~(G - 1);
  const unsigned gmask = ((1u << G) - 1u) << lead;
  const int32_t c = row < n ? (int32_t)packed[3 * n + row] : 0;
  const bool live = c > 0;
  const uint32_t q1 = live ? packed[row] : 0u,
                 q2 = live ? packed[n + row] : 0u,
                 q3 = live ? packed[2 * n + row] : 0u;
  const uint32_t s = live ? (uint32_t)(q2 % (uint32_t)n_shards) : 0u;
  int32_t id = -1;
  bool done = !live;
  if (live) {
    const uint4 e = __ldg(&table[s * cap_s + (q1 & mask)]);
    const bool hit = e.w != 0u && e.x == q1 && e.y == q2 && e.z == q3;
    done = e.w == 0u || hit;
    if (hit) id = (int32_t)(e.w - 1u);
  }
  unsigned walking = __ballot_sync(gmask, !done) & gmask;
  while (walking != 0u) {
    const int src = __ffs(walking) - 1;
    walking &= walking - 1u;
    const uint32_t ws = __shfl_sync(gmask, s, src);
    const int32_t res = walk_tail(
        table + ws * cap_s, mask, __shfl_sync(gmask, q1, src),
        __shfl_sync(gmask, q2, src), __shfl_sync(gmask, q3, src), j, gmask);
    if (lane == src) id = res;
  }
  if (live && id >= 0 && id < id_cap) atomicAdd(&acc[s * id_cap + id], c);

  // 2. Rank the misses within the warp, count them a shard.
  const bool miss = live && id < 0;
  const unsigned peers = __match_any_sync(kFull, miss ? s : 0xffffffffu);
  const uint32_t rank = __popc(peers & ((1u << lane) - 1u));
  if (miss && rank == 0u) sh_cnt[warp * n_shards + s] = __popc(peers);
  __syncthreads();
  // Each warp's offset in the tile, the tile's aggregate, published at
  // once (tile 0's is its inclusive prefix).
  for (int64_t q = threadIdx.x; q < n_shards; q += kThreads) {
    uint32_t run = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t x = sh_cnt[w * n_shards + q];
      sh_cnt[w * n_shards + q] = run;
      run += x;
    }
    sh_ex[q] = run;
    st_record(&rec[q * n_tiles + k], record(run, epoch, k == 0));
  }
  __syncthreads();

  // 3. Look back, a shard a warp; publish the inclusive prefix.
  for (int64_t q = warp; q < n_shards; q += kWarps) {
    const uint32_t agg = sh_ex[q];
    const uint32_t ex = k > 0 ? look_back(rec + q * n_tiles, k, epoch) : 0u;
    __syncwarp();
    if (lane == 0) {
      if (k > 0) st_record(&rec[q * n_tiles + k], record(ex + agg, epoch,
                                                          true));
      if (k == n_tiles - 1) n_miss[q] = (int32_t)(ex + agg);
      sh_ex[q] = ex;
    }
  }
  __syncthreads();

  // 4. The miss rows.
  if (miss) {
    miss_rows[s * n + sh_ex[s] + sh_cnt[warp * n_shards + s] + rank] =
        (int32_t)row;
  }
}

}  // namespace

extern "C" {

// Most shards the kernel takes (its shared-memory counts are sized by it).
int64_t pa_sharded_feed_max_shards() { return kMaxShards; }

// u64 words of scratch a feed of n lanes over n_shards needs: the ticket
// and epoch word, then one status record a (tile, shard). The caller
// zeroes it once, when it creates it, and keeps it for every later call on
// the same stream that fits in it: calls on one scratch must not overlap.
int64_t pa_sharded_feed_scratch_words(int64_t n, int64_t n_shards) {
  return 1 + (n + kThreads - 1) / kThreads * n_shards;
}

// table u32[n_shards][cap_s][4], acc int32[n_shards][id_cap],
// packed u32[4][n], n_miss int32[n_shards], miss_rows int32[n_shards][n],
// all contiguous; scratch of pa_sharded_feed_scratch_words(n, n_shards)
// u64 words or more. Enqueues one kernel and returns cudaGetLastError()
// right after it (0 = launched); the Python wrapper raises on anything
// else. The wrapper checks: cap_s a power of two, n >= 1,
// 1 <= n_shards <= pa_sharded_feed_max_shards().
int pa_sharded_feed(const void* table, int64_t n_shards, int64_t cap_s,
                    void* acc, int64_t id_cap, const void* packed, int64_t n,
                    void* scratch, void* n_miss, void* miss_rows,
                    void* stream) {
  if (n < 1 || n_shards < 1 || n_shards > kMaxShards) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t n_tiles = (n + kThreads - 1) / kThreads;
  unsigned long long* hdr = (unsigned long long*)scratch;
  sharded_feed_kernel<<<(unsigned)n_tiles, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const uint4*)table, n_shards, cap_s, (uint32_t)(cap_s - 1),
      (int32_t*)acc, id_cap, (const uint32_t*)packed, n, n_tiles, hdr,
      hdr + 1, (int32_t*)n_miss, (int32_t*)miss_rows);
  return (int)cudaGetLastError();
}

const char* pa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
