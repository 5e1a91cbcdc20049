// The sketch build (B6): a count-min table, HyperLogLog registers and each
// node's total of one (hash, count) stream of n_nodes x R rows. CUDA C++ for
// sm_90a, plain C interface (loaded with ctypes by ops/kernels.py).
//
// Replaces parca_agent_tpu/ops/sketch.py:cm_build (:79) and hll_build
// (:164), the jnp paths that the fleet's sketch merge runs on every node
// (parallel/fleet.py:_sketch_program, :71; not Pallas), and the chains of
// torch ops that stand for them on the CPU (ops/sketch.py:
// sketch_build_plain). Word for word their result:
//   cm[d, mix32(h, seed_d) & (width - 1)] += count        (every row)
//   regs[mix32(h, hll_seed) >> (32 - p)] = max(., rank)   (live rows)
//   totals[node] = sum of the node's counts               (int32, wraps)
// where rank = 1 + the leading zeros of the (32 - p)-bit suffix, 33 - p
// when it is all zero: with the suffix shifted to the top of the word,
// min(__clz(h << p), 32 - p) + 1 (__clz(0) is 32). A dead row (live mode
// 1: its flag is 0; mode 2: count <= 0) ranks 0, a no-op under max, and
// is skipped. Integer sums and maxima are exact in any order, so the
// atomics' order changes no word.
//
// What bounds it on an H100: memory, and the atomics. It must read each
// row's hash and count once (8 B a row: 71 MB at the fleet's 8 x 1.1M
// rows, 0.021 ms at 3.35 TB/s) and read and write each touched cell and
// register once. The count-min table takes depth adds a row: 35.6M at the
// fleet's stream into the 4 MB table of the default 4 x 2^18.
//
// Two kernels, chosen by shape (ops/sketch.py:sketch_build states the same
// rule): the cluster kernel when the call builds a table, its HLL registers
// (if any) fit shared memory (p <= 13), a CTA's eighth of a depth row and
// its registers fit one CTA's shared memory (width <= 2^18 at p = 12), and
// the stream has at least the wrapper's CLUSTER_MIN_ROWS rows; the global
// kernel otherwise (wider tables, HLL-only calls, small streams).
//
// The global kernel: a grid of (blocks a node, n_nodes); a block strides
// over its node's rows, so its total is one block reduction and one atomic
// add. Zero counts skip the table's atomics (padding costs no atomic). The
// HLL registers are the hot spot (8.9M rows into 4,096 registers at the
// default p = 12): with `shared_regs` a block keeps its own registers in
// shared memory (4 << p bytes, 16 KB at p = 12), takes its maxima there,
// and folds the nonzero ones into global memory once, at its end; past
// the wrapper's p (the registers no longer fit: 1 MB at p = 18) every
// live row takes a global atomic max. The table's adds are global atomics,
// one L2 atomic a row and depth row: the 35.6M L2 atomics at the fleet's
// stream are what bound it (0.426 ms there, 18x its byte bound).
//
// The cluster kernel takes the table's adds out of L2: thread-block
// clusters of 8 CTAs, one CTA an SM, each cluster holding one depth row of
// the table in the distributed shared memory (DSMEM) of its 8 CTAs (an
// eighth of the row a CTA: 2^15 int32, 128 KB at width 2^18; the bucket's
// top 3 bits name the CTA). A work item is (part, d): a part of the
// stream's rows (parts split the rows evenly) and a depth row; the
// clusters take the items in turn, as many clusters as fit the GPCs
// (cudaOccupancyMaxActiveClusters) and as many parts as make at most one
// item a cluster, so each row is read depth times, mostly from L2 (the
// items of one part run side by side). In an item the cluster zeroes its
// row (cluster.sync) and takes its rows in rounds. A DSMEM atomic add a
// row into the owning CTA (cluster.map_shared_rank) was the first design:
// the remote atomics' rate bound it, at 0.55 ms at the fleet's stream,
// slower than the global kernel. So a round routes instead: each CTA
// stores each row's add as a 4-byte entry in the owner's box for it, the
// lanes of a warp that share an owner in consecutive entries (DSMEM
// stores, coalesced), and after a cluster.sync each owner adds the
// round's entries with shared memory atomics; a second cluster.sync frees
// the boxes. Counts past 17 bits and full boxes (skew) fall back to the
// DSMEM atomic. After its last round each CTA folds its eighth into the
// table by global atomic adds of its nonzero cells (one add a cell and
// part; partial rows summed by a second pass were slower at the stream).
// The HLL registers stay in each CTA's shared memory, as in the global
// kernel; the rows' HLL maxima and totals are split among the depth items
// of their part (an item takes a depth-th of its part's rows), a node's
// total a block reduction and one atomic.
// The wrapper zeroes the outputs; the kernels allocate nothing.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDepth = 8;
constexpr int kBlocksPerSm = 4;

struct Seeds {
  uint32_t s[kMaxDepth];
};

__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t seed) {
  x ^= seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

template <bool kSharedRegs>
__global__ void __launch_bounds__(kThreads)
sketch_build_kernel(const uint32_t* __restrict__ hashes,
                    const int32_t* __restrict__ counts,
                    const uint8_t* __restrict__ live, int64_t r,
                    int live_mode, int32_t* __restrict__ cm, int depth,
                    uint32_t width, Seeds seeds, int32_t* __restrict__ regs,
                    int p, uint32_t hll_seed,
                    int32_t* __restrict__ totals) {
  extern __shared__ int32_t sh_regs[];
  __shared__ uint32_t sh_tot[kWarps];
  const int64_t node = blockIdx.y;
  const uint32_t m = regs != nullptr ? 1u << p : 0u;
  if (kSharedRegs) {
    for (uint32_t i = threadIdx.x; i < m; i += kThreads) sh_regs[i] = 0;
    __syncthreads();
  }
  const uint32_t mask = width - 1u;
  const int nbits = 32 - p;
  uint32_t tot = 0u;
  const uint32_t* h_node = hashes + node * r;
  const int32_t* c_node = counts != nullptr ? counts + node * r : nullptr;
  const uint8_t* l_node = live != nullptr ? live + node * r : nullptr;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < r;
       i += (int64_t)gridDim.x * kThreads) {
    const uint32_t h = __ldg(h_node + i);
    const int32_t c = c_node != nullptr ? __ldg(c_node + i) : 0;
    tot += (uint32_t)c;
    if (cm != nullptr && c != 0) {
#pragma unroll
      for (int d = 0; d < kMaxDepth; ++d) {
        if (d < depth) {
          atomicAdd(&cm[(int64_t)d * width + (mix32(h, seeds.s[d]) & mask)],
                    c);
        }
      }
    }
    if (m != 0u) {
      const bool alive = live_mode == 0 ||
                         (live_mode == 1 ? __ldg(l_node + i) != 0 : c > 0);
      if (alive) {
        const uint32_t x = mix32(h, hll_seed);
        const uint32_t idx = x >> nbits;
        const int lz = __clz((int)(x << p));
        const int32_t rank = (lz < nbits ? lz : nbits) + 1;
        if (kSharedRegs) {
          atomicMax(&sh_regs[idx], rank);
        } else {
          atomicMax(&regs[idx], rank);
        }
      }
    }
  }
  if (totals != nullptr) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, o);
    if (lane == 0) sh_tot[warp] = tot;
  }
  __syncthreads();
  if (totals != nullptr && threadIdx.x == 0) {
    uint32_t t = 0u;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) t += sh_tot[q];
    atomicAdd((uint32_t*)&totals[node], t);
  }
  if (kSharedRegs) {
    for (uint32_t i = threadIdx.x; i < m; i += kThreads) {
      const int32_t v = sh_regs[i];
      if (v != 0) atomicMax(&regs[i], v);
    }
  }
}

// -- the cluster kernel --------------------------------------------------

constexpr int kClusterCtas = 8;
constexpr int kClusterThreads = 1024;
constexpr int kClusterWarps = kClusterThreads / 32;
// A round: each CTA of a cluster takes kRound rows; a row's add is an
// entry (cell << kCountBits | count) in the owning CTA's box for this CTA,
// kBox entries (1.25x a uniform stream's 2,048 a round).
constexpr int kRoundPer = 16;
constexpr int64_t kRound = (int64_t)kClusterThreads * kRoundPer;
constexpr int kBox = 2560;
constexpr int kCountBits = 17;
constexpr uint32_t kMaxEntry = (1u << kCountBits) - 1u;
constexpr size_t kInboxBytes = (size_t)kClusterCtas * kBox * 4;

__device__ __forceinline__ bool row_alive(int live_mode,
                                          const uint8_t* __restrict__ live,
                                          int64_t i, int32_t c) {
  return live_mode == 0 || (live_mode == 1 ? __ldg(live + i) != 0 : c > 0);
}

// Grid: whole clusters of 8 CTAs, one CTA an SM. Item (part, d) for item =
// part * depth + d, parts of n_nodes * r rows split evenly; cluster c takes
// items c, c + n_clusters, ... Shared memory: the CTA's width / 8 int32 of
// the item's depth row, then 2^p registers, then the boxes (8 sources x
// kBox u32). In a round each CTA takes its kRound rows; the lanes of a
// warp that add into one owner take consecutive entries of its box (one
// local atomic an owner, by lane `owner`) and store them there (DSMEM
// stores, contiguous a warp and owner); a row whose count does not fit an
// entry, or past a full box, is a DSMEM atomic add instead. After a
// cluster.sync each owner adds the round's entries into its row with
// shared memory atomics, and a second cluster.sync frees the boxes. The
// item's row is folded into cm[d] by atomic adds of its nonzero cells.
__global__ void __launch_bounds__(kClusterThreads, 1)
sketch_cluster_kernel(const uint32_t* __restrict__ hashes,
                      const int32_t* __restrict__ counts,
                      const uint8_t* __restrict__ live, int64_t n_nodes,
                      int64_t r, int live_mode, int depth, uint32_t width,
                      Seeds seeds, int32_t* __restrict__ regs, int p,
                      uint32_t hll_seed, int32_t* __restrict__ totals,
                      int64_t n_parts, int32_t* __restrict__ cm) {
  extern __shared__ int32_t sh_row[];
  __shared__ uint32_t sh_fill[kClusterCtas];
  __shared__ uint32_t sh_cnt[kClusterCtas];
  __shared__ uint32_t sh_tot[kClusterWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t me = cluster.block_rank();
  const int64_t cl = blockIdx.x / kClusterCtas;
  const int64_t n_cl = gridDim.x / kClusterCtas;
  const uint32_t slice = width / kClusterCtas;
  const int sbits = __ffs((int)slice) - 1;
  const uint32_t m = regs != nullptr ? 1u << p : 0u;
  int32_t* sh_regs = sh_row + slice;
  uint32_t* inbox = (uint32_t*)(sh_regs + m);
  const int nbits = 32 - p;
  for (uint32_t i = threadIdx.x; i < m; i += kClusterThreads) sh_regs[i] = 0;
  const int64_t n = n_nodes * r;
  const int64_t n_items = n_parts * depth;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t span = (int64_t)kClusterCtas * kRound;
  for (int64_t item = cl; item < n_items; item += n_cl) {
    const int d = (int)(item % depth);
    const int64_t part = item / depth;
    const int64_t a = part * n / n_parts, b = (part + 1) * n / n_parts;
    const int64_t da = a + (b - a) * d / depth;
    const int64_t db = a + (b - a) * (d + 1) / depth;
    uint32_t seed = 0u;
#pragma unroll
    for (int q = 0; q < kMaxDepth; ++q) {
      if (q == d) seed = seeds.s[q];
    }
    for (uint32_t i = threadIdx.x; i < slice; i += kClusterThreads) {
      sh_row[i] = 0;
    }
    cluster.sync();
    for (int64_t node = a / r; node * r < b; ++node) {
      const int64_t s0 = node * r > a ? node * r : a;
      const int64_t e0 = (node + 1) * r < b ? (node + 1) * r : b;
      const int64_t rounds = (e0 - s0 + span - 1) / span;
      uint32_t tot = 0u;
      uint32_t hh[kRoundPer];
      int32_t cc[kRoundPer];
      auto load = [&](int64_t rd) {
        const int64_t i0 = s0 + rd * span + (int64_t)me * kRound + threadIdx.x;
#pragma unroll
        for (int q = 0; q < kRoundPer; ++q) {
          const int64_t i = i0 + (int64_t)q * kClusterThreads;
          hh[q] = i < e0 ? __ldg(hashes + i) : 0u;
          cc[q] = i < e0 ? __ldg(counts + i) : 0;
        }
      };
      if (rounds > 0) load(0);
      for (int64_t rd = 0; rd < rounds; ++rd) {
        if (threadIdx.x < kClusterCtas) sh_fill[threadIdx.x] = 0u;
        __syncthreads();
        const int64_t i0 = s0 + rd * span + (int64_t)me * kRound + threadIdx.x;
#pragma unroll
        for (int q = 0; q < kRoundPer; ++q) {
          const int64_t i = i0 + (int64_t)q * kClusterThreads;
          const uint32_t h = hh[q];
          const int32_t c = cc[q];
          const bool add = i < e0 && c != 0;
          const bool entry = add && (uint32_t)c <= kMaxEntry;
          const uint32_t bkt = mix32(h, seed) & (width - 1u);
          const uint32_t owner = bkt >> sbits;
          // The warp's entries for each owner: lane o < 8 reserves owner
          // o's, every lane takes its place among its owner's lanes.
          uint32_t mine = 0u, want = 0u;
#pragma unroll
          for (int o = 0; o < kClusterCtas; ++o) {
            const uint32_t mo = __ballot_sync(0xffffffffu, entry && owner == o);
            if (owner == (uint32_t)o) mine = mo;
            if (lane == o) want = __popc(mo);
          }
          uint32_t at = lane < kClusterCtas && want != 0u
                            ? atomicAdd(&sh_fill[lane], want) : 0u;
          at = __shfl_sync(0xffffffffu, at, (int)owner) +
               __popc(mine & ((1u << lane) - 1u));
          if (add) {
            const uint32_t cell = bkt & (slice - 1u);
            if (entry && at < (uint32_t)kBox) {
              uint32_t* box = cluster.map_shared_rank(inbox, owner) + me * kBox;
              box[at] = cell << kCountBits | (uint32_t)c;
            } else {
              atomicAdd(cluster.map_shared_rank(sh_row, owner) + cell, c);
            }
          }
          if (i < e0 && i >= da && i < db) {
            tot += (uint32_t)c;
            if (m != 0u && row_alive(live_mode, live, i, c)) {
              const uint32_t x = mix32(h, hll_seed);
              const int lz = __clz((int)(x << p));
              atomicMax(&sh_regs[x >> nbits], (lz < nbits ? lz : nbits) + 1);
            }
          }
        }
        __syncthreads();  // the round's entries are counted
        if (threadIdx.x < kClusterCtas) {
          const uint32_t k = sh_fill[threadIdx.x];
          *cluster.map_shared_rank(&sh_cnt[me], threadIdx.x) =
              k < (uint32_t)kBox ? k : (uint32_t)kBox;
        }
        if (rd + 1 < rounds) load(rd + 1);  // in flight over the barrier
        cluster.sync();  // every source's entries of the round are in
        for (uint32_t src = 0; src < kClusterCtas; ++src) {
          const uint32_t k = sh_cnt[src];
          const uint32_t* box = inbox + src * kBox;
          for (uint32_t e = threadIdx.x; e < k; e += kClusterThreads) {
            const uint32_t v = box[e];
            atomicAdd(&sh_row[v >> kCountBits], (int32_t)(v & kMaxEntry));
          }
        }
        cluster.sync();  // every box is read before the next round
      }
      const bool duty = (s0 > da ? s0 : da) < (e0 < db ? e0 : db);
      if (totals != nullptr && duty) {  // the same for every thread
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          tot += __shfl_xor_sync(0xffffffffu, tot, o);
        }
        if (lane == 0) sh_tot[warp] = tot;
        __syncthreads();
        if (threadIdx.x == 0) {
          uint32_t t = 0u;
#pragma unroll
          for (int q = 0; q < kClusterWarps; ++q) t += sh_tot[q];
          atomicAdd((uint32_t*)&totals[node], t);
        }
        __syncthreads();
      }
    }
    // The row is complete: every add of the item came before the last
    // cluster.sync.
    int32_t* out = cm + (int64_t)d * width + (int64_t)me * slice;
    for (uint32_t i = threadIdx.x; i < slice; i += kClusterThreads) {
      const int32_t v = sh_row[i];
      if (v != 0) atomicAdd(out + i, v);
    }
  }
  if (m != 0u) {
    __syncthreads();
    for (uint32_t i = threadIdx.x; i < m; i += kClusterThreads) {
      const int32_t v = sh_regs[i];
      if (v != 0) atomicMax(&regs[i], v);
    }
  }
}

// Rows a part takes at least: each part's fold adds a depth row's cells.
constexpr int64_t kMinPartRows = 1 << 18;

size_t cluster_smem(int64_t width, int64_t p, bool regs) {
  return (size_t)width / kClusterCtas * 4 + (regs ? (size_t)4 << p : 0) +
         kInboxBytes;
}

// Per-device caches (a process may drive several cards).
constexpr int kMaxDevices = 64;

int current_device(int* err) {
  int dev = 0;
  *err = (int)cudaGetDevice(&dev);
  if (*err == 0 && (dev < 0 || dev >= kMaxDevices)) {
    *err = (int)cudaErrorInvalidDevice;
  }
  return dev;
}

// The clusters that fit the current card at once for `smem` bytes a CTA
// (0 when none does, or on an error, which *err gets). The dynamic shared
// memory attribute and the occupancy are set and cached per device.
int max_clusters(size_t smem, int* err) {
  static size_t cached_smem[kMaxDevices];
  static int cached[kMaxDevices];
  const int dev = current_device(err);
  if (*err != 0) return 0;
  if (cached_smem[dev] == smem && cached[dev] > 0) return cached[dev];
  *err = (int)cudaFuncSetAttribute(
      (const void*)sketch_cluster_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (*err != 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClusterCtas, 1, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  *err = (int)cudaOccupancyMaxActiveClusters(
      &n, (const void*)sketch_cluster_kernel, &cfg);
  if (*err != 0) return 0;
  cached_smem[dev] = smem;
  cached[dev] = n;
  return n;
}

int64_t parts_of(int64_t rows, int64_t depth, int n_clusters) {
  int64_t parts = n_clusters / depth;
  const int64_t by_rows = (rows + kMinPartRows - 1) / kMinPartRows;
  if (parts > by_rows) parts = by_rows;
  return parts < 1 ? 1 : parts;
}

int sm_count() {
  static int count[kMaxDevices];
  int err = 0;
  const int dev = current_device(&err);
  if (err != 0) return 132;
  if (count[dev] <= 0 &&
      (cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                              dev) != cudaSuccess || count[dev] <= 0)) {
    count[dev] = 132;
  }
  return count[dev];
}

}  // namespace

extern "C" {

// One launch over hashes (u32) and counts (int32, nullable) of n_nodes x r
// rows, node-major. live_mode: 0 every row is live, 1 `live` (a byte a row)
// says, 2 count > 0. cm (depth x width int32, nullable), regs (2^p int32,
// nullable; shared_regs != 0 keeps a block's registers in 4 << p bytes of
// shared memory, which must fit 48 KB) and totals (n_nodes int32, nullable)
// must be zeroed by the caller. width is a power of two, depth <= 8 (the
// first depth seeds are used), 4 <= p <= 18, 1 <= n_nodes <= 65535.
// Returns cudaGetLastError() right after the launch (0 = launched).
int pa_sketch_build(const void* hashes, const void* counts, const void* live,
                    int64_t n_nodes, int64_t r, int64_t live_mode, void* cm,
                    int64_t depth, int64_t width, uint32_t s0, uint32_t s1,
                    uint32_t s2, uint32_t s3, uint32_t s4, uint32_t s5,
                    uint32_t s6, uint32_t s7, void* regs, int64_t p,
                    uint32_t hll_seed, int64_t shared_regs, void* totals,
                    void* stream) {
  if (n_nodes < 1 || n_nodes > 65535 || r < 1 || depth < 0 ||
      depth > kMaxDepth || (cm != nullptr && (depth < 1 || width < 1 ||
                                              (width & (width - 1)) != 0)) ||
      (regs != nullptr && (p < 4 || p > 18)) || live_mode < 0 ||
      live_mode > 2 || (live_mode == 1 && live == nullptr) ||
      (live_mode == 2 && counts == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Seeds seeds = {{s0, s1, s2, s3, s4, s5, s6, s7}};
  const int64_t per_row = (r + kThreads - 1) / kThreads;
  int64_t bx = ((int64_t)kBlocksPerSm * sm_count() + n_nodes - 1) / n_nodes;
  if (bx > per_row) bx = per_row;
  if (bx < 1) bx = 1;
  const dim3 grid((unsigned)bx, (unsigned)n_nodes);
  cudaStream_t st = (cudaStream_t)stream;
  const bool sh = regs != nullptr && shared_regs != 0;
  const size_t smem = sh ? ((size_t)4 << p) : 0;
  if (sh && smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const auto* h = (const uint32_t*)hashes;
  const auto* c = (const int32_t*)counts;
  const auto* l = (const uint8_t*)live;
  auto* t = (int32_t*)cm;
  auto* g = (int32_t*)regs;
  auto* tot = (int32_t*)totals;
  if (sh) {
    sketch_build_kernel<true><<<grid, kThreads, smem, st>>>(
        h, c, l, r, (int)live_mode, t, (int)depth, (uint32_t)width, seeds, g,
        (int)p, hll_seed, tot);
  } else {
    sketch_build_kernel<false><<<grid, kThreads, 0, st>>>(
        h, c, l, r, (int)live_mode, t, (int)depth, (uint32_t)width, seeds, g,
        (int)p, hll_seed, tot);
  }
  return (int)cudaGetLastError();
}

// The cluster kernel's plan for n_nodes x r rows into a depth x width table
// (with 2^p shared registers when regs != 0): its parts; negative: a CUDA
// error code, or -cudaErrorInvalidValue when the shape does not fit a
// cluster.
int64_t pa_sketch_cluster_parts(int64_t n_nodes, int64_t r, int64_t depth,
                                int64_t width, int64_t p, int64_t regs) {
  if (n_nodes < 1 || r < 1 || depth < 1 || depth > kMaxDepth ||
      width < kClusterCtas || (width & (width - 1)) != 0 ||
      (regs != 0 && (p < 4 || p > 13))) {
    return -(int64_t)cudaErrorInvalidValue;
  }
  const size_t smem = cluster_smem(width, p, regs != 0);
  if (smem > 227 * 1024) return -(int64_t)cudaErrorInvalidValue;
  int err = 0;
  const int n_cl = max_clusters(smem, &err);
  if (err != 0) return -(int64_t)err;
  if (n_cl < 1) return -(int64_t)cudaErrorInvalidConfiguration;
  return parts_of(n_nodes * r, depth, n_cl);
}

// The cluster kernel: as pa_sketch_build, with counts and cm required,
// regs nullable (4 <= p <= 13, kept in shared memory) and n_parts from
// pa_sketch_cluster_parts. cm, regs and totals must be zeroed. Returns
// cudaLaunchKernelEx's error, or cudaGetLastError() after it (0 =
// launched).
int pa_sketch_build_cluster(const void* hashes, const void* counts,
                            const void* live, int64_t n_nodes, int64_t r,
                            int64_t live_mode, void* cm, int64_t depth,
                            int64_t width, uint32_t s0, uint32_t s1,
                            uint32_t s2, uint32_t s3, uint32_t s4,
                            uint32_t s5, uint32_t s6, uint32_t s7,
                            void* regs, int64_t p, uint32_t hll_seed,
                            void* totals, int64_t n_parts, void* stream) {
  const int64_t want = pa_sketch_cluster_parts(n_nodes, r, depth, width, p,
                                               regs != nullptr);
  if (want < 0) return (int)-want;
  if (n_parts != want || counts == nullptr || cm == nullptr ||
      live_mode < 0 || live_mode > 2 || (live_mode == 1 && live == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = cluster_smem(width, p, regs != nullptr);
  int err = 0;
  const int n_cl = max_clusters(smem, &err);
  if (err != 0) return err;
  int64_t clusters = n_parts * depth;
  if (clusters > n_cl) clusters = n_cl;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * kClusterCtas), 1, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const Seeds seeds = {{s0, s1, s2, s3, s4, s5, s6, s7}};
  err = (int)cudaLaunchKernelEx(
      &cfg, sketch_cluster_kernel, (const uint32_t*)hashes,
      (const int32_t*)counts, (const uint8_t*)live, n_nodes, r,
      (int)live_mode, (int)depth, (uint32_t)width, seeds, (int32_t*)regs,
      (int)p, hll_seed, (int32_t*)totals, n_parts, (int32_t*)cm);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

const char* pa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
