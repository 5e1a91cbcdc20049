// The exact fleet merge (B8): over n unsorted rows of (int64 key, int32
// count), each group's key and count sum in key order, and the group count.
// CUDA C++ for sm_90a, plain C interface (loaded with ctypes by
// ops/kernels.py).
//
// Replaces parca_agent_tpu/parallel/fleet.py:_exact_program (:131) and
// _exact_program64 (:164), jit + shard_map programs (all_gather, lax.sort,
// segment_sum and segment_max; not Pallas), and the port's earlier route for
// them: torch.sort of every row, then a segment pass over the sorted rows.
// With the distinct keys of the rows in ascending order:
//   reps[g]   = key g (a group of zero-count rows is a group like any other)
//   sums[g]   = the int32 sum (wrapping) of the counts of key g's rows
//   n_groups  = the number of distinct keys
// reps and sums have n slots; only [:n_groups] is written. Keys come as one
// int64 a row whose signed order is the order JAX sorts by: the 32-bit
// merge's u32 key widened (in [0, 2^32)), or the 64-bit merge's (h1, h2) as
// (int32(h1 ^ 2^31) << 32) + h2. The kernels work on u = key ^ 2^63, whose
// unsigned order is that order; reps_lo gets u's low 32 bits, reps_hi (the
// 64-bit merge only) its high 32 bits, which are h1.
//
// What bounds it on an H100: memory. It must read 12 B a row (key and
// count) and write 12 B a group (both rep lanes and the sum; 8 B in the
// 32-bit merge): 125.8 MB at the fleet's 8,912,896 rows and 1,572,864
// groups, 0.0376 ms at 3.35 TB/s. A radix sort of 64-bit keys makes about
// eight passes over every row, and the segment pass after it one more; this
// route makes three: a read of the keys, a read and a write of every row,
// and a read of every row (~0.12 ms of traffic at 3.35 TB/s).
//
// Design: a partition by key, then a reduce of each bucket in shared memory.
//   1. hist: B bits of u name a row's bucket: the top B bits of a 64-bit
//      key, bits 31..32-B of a 32-bit one, B from n (parallel/fleet.py:
//      group_bits) so that a bucket holds about 8,192 rows (2^10 buckets
//      of ~8,704 rows at the fleet's stream; more buckets make the
//      scatter's runs shorter and cost more than they save). A CTA counts
//      32,768 rows' buckets in shared memory and adds its counts into a
//      global histogram; the last CTA to finish scans it into each bucket's
//      first row, sets each bucket's cursor and leaf (below) and zeroes the
//      histogram for the next call.
//   2. scatter: a CTA takes 12,288 rows, ranks them by bucket in shared
//      memory, reserves each bucket's run with one atomic add on the
//      bucket's cursor, and writes the rows out from shared memory in
//      bucket order, so that consecutive threads write each run (~12 rows
//      a bucket and tile at the stream). Bucket order is key order; the
//      order inside a bucket is any.
//   3. reduce: one CTA a leaf (here a bucket), taken from an atomic ticket.
//      The CTA streams the leaf's rows through a four-stage ring in shared
//      memory (cp.async, three chunks in flight), adds each row into a hash
//      table of 4,096 slots in shared memory (a 64-bit CAS claims a slot,
//      an add sums its count), packs the groups and sorts only them there:
//      a counting sort by the 12 key bits below those the leaf's keys share
//      (~1,540 groups a bucket at the stream into 4,096 bins), then a count
//      of smaller keys inside each bin that holds more than one. It writes
//      them at the leaf's group offset, which a decoupled look-back over
//      the leaves gives (close_pack.cu's ticket, epoch and status records).
//      The last leaf writes n_groups. Integer sums are exact in any order,
//      so the words are the same on every run.
//      A bucket whose groups pass 3,072 (3/4 of the table: the adds stop
//      at the claim past it) is the one thing the first level cannot see,
//      since it does not depend on the rows a group: nodes that share few
//      stacks (every key distinct: ~8,700 groups a bucket) make it. Its CTA
//      then partitions the bucket's rows into P = ceil(rows / 2,048) runs
//      by the 16 key bits below its shared ones scaled to [0, P) (run_of
//      keeps the key order), in a stage buffer at the bucket's own rows,
//      and takes a pass over each run whose sorted groups overwrite the
//      run's rows there; it publishes their sum for the look-back and then
//      copies them out. Its rows are read about four times and written
//      once more (the pass that overflowed stops early), with no host sync
//      and no split.
// Buckets that do not fit: one of more than 32,768 rows, or one whose
// run still has more than 3,072 groups, is not reduced: its leaf
// publishes no group and counts itself in info[1]. On hash-uniform keys
// none does up to ~2^13 x 32,768 rows. Skewed keys (small 32-bit keys,
// one key repeated) and fleets far larger than the stream make them, and
// the wrapper (parallel/fleet.py) then splits each such bucket again, level
// by level, with the same hist and scatter kernels over a list of
// segments: minmax gives a segment's least and greatest key, whose top
// differing bit t names its next buckets (bits t..t-10); a segment whose
// keys are all one is a leaf of one group, summed by minmax, and needs no
// sort. Consecutive small buckets are packed into leaves of at most 3,072
// rows, so that every leaf fits, and one reduce over every leaf, in key
// order, writes the groups (a packed leaf of at most 3,072 rows always
// takes one pass). Each level takes the 11 bits below the top
// differing bit, so the 64 bits allow at most 6 levels after the first (3
// for 32-bit keys); a level costs three passes over its segments' rows and
// two host syncs, and the first reduce's work is redone.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kEpochMask = 0x7fffffffu;
constexpr int kMaxBits = 13;
constexpr int kMaxBuckets = 1 << kMaxBits;

constexpr int kHistThreads = 512;
constexpr int kHistPer = 8;  // keys a thread has in flight
constexpr int64_t kHistRows = 32768;

constexpr int kScatThreads = 1024;
constexpr int kScatPer = 12;
constexpr int kScatTile = kScatThreads * kScatPer;

constexpr int kRedThreads = 512;
constexpr int kRedWarps = kRedThreads / 32;
constexpr int kSlots = 4096;
constexpr int kSlotsHalf = kSlots / 2 / kRedThreads;  // a thread's slots a round
constexpr uint32_t kMaxGroups = 3072;
constexpr int kGroupsPer = kMaxGroups / kRedThreads;
constexpr int64_t kPassRows = 2048;  // a run's rows, when a leaf has runs
constexpr int kMaxRuns = 16;         // kMaxLeafRows / kPassRows
constexpr uint32_t kOverflow = 0xffffffffu;  // a pass with too many groups
constexpr int kBins = 4096;
constexpr int kChunk = 1024;
constexpr int kStages = 4;
constexpr int kChunkPer = kChunk / kRedThreads;
constexpr int64_t kMaxLeafRows = 32768;
constexpr size_t kRedSmem = (size_t)kSlots * 12 + (size_t)kStages * kChunk * 12;
static_assert(kBins * 4 + kMaxGroups * 2 <= kStages * kChunk * 12,
              "the sort's bins and order fit the ring");

// Leaf flags.
constexpr uint32_t kLeafInB = 1u;     // its rows are in the second buffer
constexpr uint32_t kLeafSingle = 2u;  // one key: `key` and `sum` are its group
constexpr uint32_t kLeafOver = 4u;    // set by the reduce: it did not fit

// A leaf: a run of rows whose keys are greater than those of every earlier
// leaf. Without kLeafSingle, `key` is a key that none of its rows holds (the
// hash table's empty mark), and its rows' keys agree on every bit from
// `hbit` up, so that bits hbit-1.. hbit-12 order them (bin_of).
struct Leaf {
  long long start;
  int count;
  uint32_t flags;
  unsigned long long key;
  int sum;
  int hbit;
};
static_assert(sizeof(Leaf) == 32, "a leaf is 4 int64 words");

// The rows a hist, scatter or minmax CTA takes. The first level: tiles of
// one segment [0, n) with (shift, bits). A split level: chunks[i] = (begin,
// end, segment) and segs[s] = (shift, bits, first bucket).
struct Level {
  const long long* chunks;
  const long long* segs;
  int64_t n;
  uint32_t shift, bits;
};

struct Part {
  int64_t b, e, seg;
  uint32_t shift, nb, base;
};

__device__ __forceinline__ Part part_of(const Level& L, int64_t i,
                                        int64_t tile) {
  Part p;
  if (L.chunks == nullptr) {
    p.b = i * tile;
    p.e = p.b + tile < L.n ? p.b + tile : L.n;
    p.seg = 0;
    p.shift = L.shift;
    p.nb = 1u << L.bits;
    p.base = 0u;
  } else {
    p.b = L.chunks[3 * i];
    p.e = L.chunks[3 * i + 1];
    p.seg = L.chunks[3 * i + 2];
    p.shift = 0u;
    p.nb = 1u;
    p.base = 0u;
    if (L.segs != nullptr) {  // minmax has no buckets
      p.shift = (uint32_t)L.segs[3 * p.seg];
      p.nb = 1u << (uint32_t)L.segs[3 * p.seg + 1];
      p.base = (uint32_t)L.segs[3 * p.seg + 2];
    }
  }
  return p;
}

__device__ __forceinline__ uint32_t digit(unsigned long long u,
                                          const Part& p) {
  return (uint32_t)(u >> p.shift) & (p.nb - 1u);
}

// The exclusive prefix of x over a CTA of T threads, and (total) their sum.
template <int T>
__device__ __forceinline__ uint32_t block_excl_sum(uint32_t x,
                                                   uint32_t& total,
                                                   uint32_t* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  uint32_t before = 0u;
  total = 0u;
#pragma unroll
  for (int q = 0; q < T / 32; ++q) {
    const uint32_t w = sh[q];
    if (q < warp) before += w;
    total += w;
  }
  __syncthreads();
  return before + inc - x;
}

// a[0, n) in shared memory replaced by its exclusive prefix sums, by a CTA
// of T threads (each a run of consecutive entries). Ends synchronised.
template <int T>
__device__ void block_scan_inplace(uint32_t* a, uint32_t n, uint32_t* sh) {
  const uint32_t per = (n + T - 1) / T;
  const uint32_t lo = threadIdx.x * per < n ? threadIdx.x * per : n;
  const uint32_t hi = lo + per < n ? lo + per : n;
  uint32_t s = 0u;
  for (uint32_t i = lo; i < hi; ++i) s += a[i];
  uint32_t total;
  uint32_t ex = block_excl_sum<T>(s, total, sh);
  for (uint32_t i = lo; i < hi; ++i) {
    const uint32_t v = a[i];
    a[i] = ex;
    ex += v;
  }
  __syncthreads();
}

// 1. Each bucket's rows, added into hist[base + bucket]. With `done` (the
// first level), the last CTA sets cursor[b] and leaves[b] to bucket b's
// first row and leaf, zeroes hist and *done for the next call, and info[1].
__global__ void __launch_bounds__(kHistThreads)
hist_kernel(Level L, const unsigned long long* __restrict__ keys,
            unsigned long long flip, uint32_t* __restrict__ hist,
            uint32_t* __restrict__ done, uint32_t* __restrict__ cursor,
            Leaf* __restrict__ leaves, unsigned long long prefix,
            int32_t* __restrict__ info) {
  __shared__ uint32_t sh[kMaxBuckets];
  __shared__ uint32_t sh_w[kHistThreads / 32];
  __shared__ bool sh_last;
  const Part p = part_of(L, blockIdx.x, kHistRows);
  for (uint32_t i = threadIdx.x; i < p.nb; i += kHistThreads) sh[i] = 0u;
  __syncthreads();
  for (int64_t i0 = p.b + threadIdx.x; i0 < p.e;
       i0 += (int64_t)kHistThreads * kHistPer) {
    unsigned long long k[kHistPer];
#pragma unroll
    for (int q = 0; q < kHistPer; ++q) {
      const int64_t i = i0 + (int64_t)q * kHistThreads;
      k[q] = i < p.e ? __ldg(keys + i) : 0ull;
    }
#pragma unroll
    for (int q = 0; q < kHistPer; ++q) {
      if (i0 + (int64_t)q * kHistThreads < p.e) {
        atomicAdd(&sh[digit(k[q] ^ flip, p)], 1u);
      }
    }
  }
  __syncthreads();
  for (uint32_t i = threadIdx.x; i < p.nb; i += kHistThreads) {
    if (sh[i] != 0u) atomicAdd(&hist[p.base + i], sh[i]);
  }
  if (done == nullptr) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) sh_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!sh_last) return;
  __threadfence();
  const uint32_t nb = 1u << L.bits;
  for (uint32_t i = threadIdx.x; i < nb; i += kHistThreads) {
    sh[i] = __ldcg(hist + i);
    hist[i] = 0u;
  }
  __syncthreads();
  block_scan_inplace<kHistThreads>(sh, nb, sh_w);
  const unsigned long long span = (1ull << L.shift) - 1ull;
  for (uint32_t i = threadIdx.x; i < nb; i += kHistThreads) {
    const uint32_t first = sh[i];
    const uint32_t end = i + 1u < nb ? sh[i + 1u] : (uint32_t)L.n;
    cursor[i] = first;
    const unsigned long long lo = prefix | ((unsigned long long)i << L.shift);
    const unsigned long long hi = lo | span;
    Leaf f;
    f.start = first;
    f.count = (int)(end - first);
    f.flags = 0u;
    f.key = hi != ~0ull ? hi + 1ull : lo - 1ull;
    f.sum = 0;
    f.hbit = (int)L.shift;
    leaves[i] = f;
  }
  if (threadIdx.x == 0) {
    *done = 0u;
    info[1] = 0;
  }
}

// 2. Rows src -> dst in bucket order: bucket b of segment s gets the rows
// from cursor[base_s + b] on (the cursors advance). smem: the staged rows
// (kScatTile keys and counts), then two arrays of max_nb.
__global__ void __launch_bounds__(kScatThreads, 1)
scatter_kernel(Level L, const unsigned long long* __restrict__ src_keys,
               const int32_t* __restrict__ src_counts,
               unsigned long long flip, uint32_t* __restrict__ cursor,
               unsigned long long* __restrict__ dst_keys,
               int32_t* __restrict__ dst_counts, uint32_t max_nb) {
  extern __shared__ unsigned long long sm_scat[];
  unsigned long long* st_keys = sm_scat;
  int32_t* st_counts = (int32_t*)(st_keys + kScatTile);
  uint32_t* sh_first = (uint32_t*)(st_counts + kScatTile);  // count, then first
  uint32_t* sh_base = sh_first + max_nb;
  __shared__ uint32_t sh_w[kScatThreads / 32];
  const Part p = part_of(L, blockIdx.x, kScatTile);
  for (uint32_t i = threadIdx.x; i < p.nb; i += kScatThreads) sh_first[i] = 0u;
  __syncthreads();
  unsigned long long u[kScatPer];
  int32_t c[kScatPer];
  uint32_t rank[kScatPer];
#pragma unroll
  for (int q = 0; q < kScatPer; ++q) {
    const int64_t i = p.b + (int64_t)q * kScatThreads + threadIdx.x;
    if (i < p.e) {
      u[q] = __ldg(src_keys + i) ^ flip;
      c[q] = __ldg(src_counts + i);
    }
  }
#pragma unroll
  for (int q = 0; q < kScatPer; ++q) {
    const int64_t i = p.b + (int64_t)q * kScatThreads + threadIdx.x;
    if (i < p.e) rank[q] = atomicAdd(&sh_first[digit(u[q], p)], 1u);
  }
  __syncthreads();
  for (uint32_t i = threadIdx.x; i < p.nb; i += kScatThreads) {
    const uint32_t k = sh_first[i];
    sh_base[i] = k != 0u ? atomicAdd(&cursor[p.base + i], k) : 0u;
  }
  __syncthreads();
  block_scan_inplace<kScatThreads>(sh_first, p.nb, sh_w);
#pragma unroll
  for (int q = 0; q < kScatPer; ++q) {
    const int64_t i = p.b + (int64_t)q * kScatThreads + threadIdx.x;
    if (i < p.e) {
      const uint32_t at = sh_first[digit(u[q], p)] + rank[q];
      st_keys[at] = u[q];
      st_counts[at] = c[q];
    }
  }
  __syncthreads();
  const int rows = (int)(p.e - p.b);
  for (int j = threadIdx.x; j < rows; j += kScatThreads) {
    const unsigned long long k = st_keys[j];
    const uint32_t d = digit(k, p);
    const uint32_t at = sh_base[d] + (uint32_t)j - sh_first[d];
    dst_keys[at] = k;
    dst_counts[at] = st_counts[j];
  }
}

// A split level's segments: each one's least and greatest key and its
// count sum (wrapping), into mins, maxs, sums (preset to ~0, 0, 0).
__global__ void __launch_bounds__(kHistThreads)
minmax_kernel(Level L, const unsigned long long* __restrict__ keys,
              const int32_t* __restrict__ counts,
              unsigned long long* __restrict__ mins,
              unsigned long long* __restrict__ maxs,
              uint32_t* __restrict__ sums) {
  __shared__ unsigned long long sh_lo[kHistThreads / 32],
      sh_hi[kHistThreads / 32];
  __shared__ uint32_t sh_s[kHistThreads / 32];
  const Part p = part_of(L, blockIdx.x, 0);
  unsigned long long lo = ~0ull, hi = 0ull;
  uint32_t s = 0u;
  for (int64_t i = p.b + threadIdx.x; i < p.e; i += kHistThreads) {
    const unsigned long long k = __ldg(keys + i);
    lo = k < lo ? k : lo;
    hi = k > hi ? k : hi;
    s += (uint32_t)__ldg(counts + i);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long a = __shfl_xor_sync(kFull, lo, o);
    const unsigned long long b = __shfl_xor_sync(kFull, hi, o);
    lo = a < lo ? a : lo;
    hi = b > hi ? b : hi;
    s += __shfl_xor_sync(kFull, s, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh_lo[warp] = lo;
    sh_hi[warp] = hi;
    sh_s[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int q = 1; q < kHistThreads / 32; ++q) {
      lo = sh_lo[q] < lo ? sh_lo[q] : lo;
      hi = sh_hi[q] > hi ? sh_hi[q] : hi;
      s += sh_s[q];
    }
    atomicMin(&mins[p.seg], lo);
    atomicMax(&maxs[p.seg], hi);
    atomicAdd(&sums[p.seg], s);
  }
}

// 3. The reduce.

// Scratch (u32 words), zeroed once when it is created; the header first,
// so a scratch sized for more leaves serves fewer:
//   hdr    u64              reduce ticket | epoch of the last call << 32
//   done   u32, u32         hist CTAs finished (first level), unused
//   hist   u32[8192]        the first level's histogram, zero between calls
//   cursor u32[8192]        the first level's bucket cursors
//   scan   uint4[n_leaves]  epoch << 1 | P, groups, 0, 0: the leaf's own
//                           groups (P = 0) or its inclusive prefix (P = 1)
constexpr int64_t kHdrWords = 4 + 2 * (int64_t)kMaxBuckets;  // u32 words

struct Scratch {
  uint4* scan;
  unsigned long long* hdr;
};

__device__ __forceinline__ uint4 ld_record(const uint4* p) {
  uint4 v;
  asm volatile("ld.relaxed.gpu.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_record(uint4* p, uint4 v) {
  asm volatile("st.relaxed.gpu.global.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" :: "r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" :: "r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kStages - 1) : "memory");
}

__device__ __forceinline__ uint32_t slot_of(unsigned long long u) {
  u ^= u >> 33;
  u *= 0xff51afd7ed558ccdull;
  u ^= u >> 33;
  u *= 0xc4ceb9fe1a85ec53ull;
  u ^= u >> 33;
  return (uint32_t)u & (kSlots - 1);
}

// A pass's shared words: its groups' packing cursor, the slots it
// claimed, and its stop flag.
struct PassCtl {
  uint32_t pos, claimed, abort;
};

// One row into the table (linear probing; `empty` marks a free slot). The
// claim past kMaxGroups sets ctl->abort, and the adds stop at the next row,
// so that the table never fills (at most kMaxGroups + kRedThreads claims)
// and every probe ends; the bound on the steps only guards that.
__device__ __forceinline__ void insert(unsigned long long* t_key,
                                       int32_t* t_sum,
                                       unsigned long long empty,
                                       unsigned long long u, int32_t c,
                                       PassCtl* ctl) {
  uint32_t h = slot_of(u);
  for (int step = 0; step < kSlots; ++step) {
    unsigned long long cur = *(volatile unsigned long long*)&t_key[h];
    if (cur == empty) {
      cur = atomicCAS(&t_key[h], empty, u);
      if (cur == empty) {
        if (atomicAdd(&ctl->claimed, 1u) >= kMaxGroups) {
          *(volatile uint32_t*)&ctl->abort = 1u;
        }
        atomicAdd(&t_sum[h], c);
        return;
      }
    }
    if (cur == u) {
      atomicAdd(&t_sum[h], c);
      return;
    }
    h = (h + 1u) & (kSlots - 1);
  }
  *(volatile uint32_t*)&ctl->abort = 1u;
}

// The run of P a key belongs to: the 16 key bits below hbit scaled to
// [0, P), which keeps the key order (a run's keys are all below the next
// run's).
__device__ __forceinline__ uint32_t run_of(unsigned long long u, int hbit,
                                           uint32_t P) {
  const uint32_t t = (uint32_t)(hbit >= 16 ? u >> (hbit - 16)
                                           : u << (16 - hbit)) & 0xffffu;
  return (t * P) >> 16;
}

// One pass over m rows from `start`: the table emptied, the rows added,
// the groups packed to t_key / t_sum[0, g). Returns g, or kOverflow when
// the rows have more than kMaxGroups groups. The same rows give the same g
// on every call. Ends synchronised.
__device__ uint32_t pass_groups(const unsigned long long* keys,
                                const int32_t* counts, int64_t start,
                                int64_t m, unsigned long long empty,
                                unsigned long long* t_key, int32_t* t_sum,
                                unsigned long long* r_key, int32_t* r_cnt,
                                PassCtl* ctl) {
  __syncthreads();  // the last pass's words and groups are read
  for (int i = threadIdx.x; i < kSlots; i += kRedThreads) {
    t_key[i] = empty;
    t_sum[i] = 0;
  }
  if (threadIdx.x == 0) {
    ctl->pos = 0u;
    ctl->claimed = 0u;
    ctl->abort = 0u;
  }
  const int n_ch = (int)((m + kChunk - 1) / kChunk);
  auto issue = [&](int c) {
    const int st = (c % kStages) * kChunk;
#pragma unroll
    for (int q = 0; q < kChunkPer; ++q) {
      const int jj = q * kRedThreads + threadIdx.x;
      const int64_t row = (int64_t)c * kChunk + jj;
      if (row < m) {
        cp_async8(&r_key[st + jj], keys + start + row);
        cp_async4(&r_cnt[st + jj], counts + start + row);
      }
    }
    cp_async_commit();
  };
  // kStages - 1 chunks in flight ahead of the one being added.
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_ch) {
      issue(c);
    } else {
      cp_async_commit();
    }
  }
  __syncthreads();  // the table is empty
  for (int c = 0; c < n_ch; ++c) {
    if (c + kStages - 1 < n_ch) {
      issue(c + kStages - 1);
    } else {
      cp_async_commit();
    }
    cp_async_wait_ring();
    __syncthreads();  // chunk c is in the ring
    const int st = (c % kStages) * kChunk;
    const int64_t left = m - (int64_t)c * kChunk;
    const int rows = left < kChunk ? (int)left : kChunk;
    for (int r = threadIdx.x; r < rows; r += kRedThreads) {
      if (*(volatile uint32_t*)&ctl->abort) break;
      insert(t_key, t_sum, empty, r_key[st + r], r_cnt[st + r], ctl);
    }
    __syncthreads();  // the stage is read before it is filled again
    if (ctl->abort != 0u) {  // read by every thread after the adds stopped
      cp_async_wait_all();   // no copy lands in the ring after the return
      return kOverflow;
    }
  }
  // The groups to t_key / t_sum[0, g), in two rounds of half the slots: a
  // round reads its slots, then writes below its first slot.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    unsigned long long kk[kSlotsHalf];
    int32_t ss[kSlotsHalf];
    uint32_t valid = 0u;
#pragma unroll
    for (int q = 0; q < kSlotsHalf; ++q) {
      const int i = (half * kSlotsHalf + q) * kRedThreads + threadIdx.x;
      kk[q] = t_key[i];
      ss[q] = t_sum[i];
      if (kk[q] != empty) valid |= 1u << q;
    }
    __syncthreads();
    uint32_t at = valid != 0u ? atomicAdd(&ctl->pos, __popc(valid)) : 0u;
#pragma unroll
    for (int q = 0; q < kSlotsHalf; ++q) {
      if ((valid >> q) & 1u) {
        t_key[at] = kk[q];
        t_sum[at] = ss[q];
        ++at;
      }
    }
    __syncthreads();
  }
  return ctl->pos;
}

// A leaf's m rows from `start` copied to stage_keys / stage_counts at the
// same rows, in P <= kMaxRuns runs by run_of: run j from start + run[j]
// (run: P + 1 u32 of shared memory, run[P] = m; cur: P u32). Ends
// synchronised.
__device__ void partition(const unsigned long long* keys,
                          const int32_t* counts, int64_t start, int64_t m,
                          int hbit, uint32_t P,
                          unsigned long long* stage_keys,
                          int32_t* stage_counts, uint32_t* run,
                          uint32_t* cur) {
  if (threadIdx.x < P) cur[threadIdx.x] = 0u;
  __syncthreads();
  for (int64_t i = threadIdx.x; i < m; i += kRedThreads) {
    atomicAdd(&cur[run_of(keys[start + i], hbit, P)], 1u);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t at = 0u;
    for (uint32_t j = 0; j < P; ++j) {
      run[j] = at;
      at += cur[j];
      cur[j] = run[j];
    }
    run[P] = at;
  }
  __syncthreads();
  for (int64_t i = threadIdx.x; i < m; i += kRedThreads) {
    const unsigned long long u = keys[start + i];
    const uint32_t at = atomicAdd(&cur[run_of(u, hbit, P)], 1u);
    stage_keys[start + at] = u;
    stage_counts[start + at] = counts[start + i];
  }
  __syncthreads();  // the runs are written before a pass reads them
}

// A group's bin: bits hbit-1 .. hbit-12 of its key, which order the
// leaf's keys (they agree on every bit from hbit up).
__device__ __forceinline__ uint32_t bin_of(unsigned long long u, int hbit) {
  return (uint32_t)(hbit >= 12 ? u >> (hbit - 12) : u << (12 - hbit)) &
         (kBins - 1);
}

// key[0, g) ascending (distinct keys), val with them: a counting sort by
// bin (bins: kBins u32 of scratch, order: g u16), then each group of a bin
// that holds more than one counts the bin's smaller keys. Ends
// synchronised.
__device__ void bin_sort(unsigned long long* key, int32_t* val, uint32_t g,
                         int hbit, uint32_t* bins, uint16_t* order,
                         uint32_t* sh_w) {
  for (int i = threadIdx.x; i < kBins; i += kRedThreads) bins[i] = 0u;
  __syncthreads();
  unsigned long long kk[kGroupsPer];
  int32_t vv[kGroupsPer];
  uint32_t at[kGroupsPer];
#pragma unroll
  for (int q = 0; q < kGroupsPer; ++q) {
    const uint32_t j = q * kRedThreads + threadIdx.x;
    if (j < g) {
      kk[q] = key[j];
      vv[q] = val[j];
      at[q] = atomicAdd(&bins[bin_of(kk[q], hbit)], 1u);
    }
  }
  __syncthreads();
  block_scan_inplace<kRedThreads>(bins, kBins, sh_w);
#pragma unroll
  for (int q = 0; q < kGroupsPer; ++q) {
    const uint32_t j = q * kRedThreads + threadIdx.x;
    if (j < g) {
      at[q] += bins[bin_of(kk[q], hbit)];
      order[at[q]] = (uint16_t)j;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kGroupsPer; ++q) {
    const uint32_t j = q * kRedThreads + threadIdx.x;
    if (j < g) {
      const uint32_t b = bin_of(kk[q], hbit);
      const uint32_t first = bins[b];
      const uint32_t end = b + 1u < (uint32_t)kBins ? bins[b + 1u] : g;
      if (end - first > 1u) {
        uint32_t r = first;
        for (uint32_t x = first; x < end; ++x) r += key[order[x]] < kk[q];
        at[q] = r;
      }
    }
  }
  __syncthreads();  // every key is read before any is moved
#pragma unroll
  for (int q = 0; q < kGroupsPer; ++q) {
    const uint32_t j = q * kRedThreads + threadIdx.x;
    if (j < g) {
      key[at[q]] = kk[q];
      val[at[q]] = vv[q];
    }
  }
  __syncthreads();
}

// Every thread: the groups of the leaves before leaf k, from their
// records, kRedThreads at a time (thread i reads leaf top - i): the sum of
// the records up to the nearest inclusive prefix.
__device__ uint32_t look_back(const Scratch& s, int64_t k, uint32_t epoch,
                              uint32_t* sh_p, uint32_t* sh_w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t ex = 0u;
  for (int64_t top = k - 1;; top -= kRedThreads) {
    const int64_t j = top - threadIdx.x;
    uint4 r = make_uint4(epoch << 1 | 1u, 0u, 0u, 0u);
    if (j >= 0) {
      do {
        r = ld_record(&s.scan[j]);
      } while ((r.x >> 1) != epoch);
    }
    const uint32_t pm = __ballot_sync(kFull, (r.x & 1u) != 0u);
    if (lane == 0) sh_p[warp] = pm;
    __syncthreads();
    int stop = kRedThreads;
#pragma unroll
    for (int q = kRedWarps - 1; q >= 0; --q) {
      if (sh_p[q]) stop = q * 32 + __ffs(sh_p[q]) - 1;
    }
    uint32_t total;
    block_excl_sum<kRedThreads>((int)threadIdx.x <= stop ? r.y : 0u, total,
                                sh_w);
    ex += total;
    if (stop < kRedThreads) return ex;
  }
}

// One CTA a leaf, in ticket order; leaves[k].flags gets kLeafOver and
// info[1] one more when leaf k does not fit: more than max_rows rows, or a
// run with more than kMaxGroups groups. A leaf first takes one pass; when
// its groups overflow the table and stage_keys is given, its rows are
// partitioned into P = ceil(m / kPassRows) runs by the key bits below hbit
// (run_of) in stage_keys / stage_counts, at the leaf's own rows, and each
// run takes a pass whose sorted groups overwrite the run's rows there;
// after the look-back they are copied out. The last leaf writes info[0] =
// n_groups.
__global__ void __launch_bounds__(kRedThreads, 2)
reduce_kernel(Leaf* __restrict__ leaves, int64_t n_leaves,
              const unsigned long long* __restrict__ keys_a,
              const int32_t* __restrict__ counts_a,
              const unsigned long long* __restrict__ keys_b,
              const int32_t* __restrict__ counts_b,
              unsigned long long* __restrict__ stage_keys,
              int32_t* __restrict__ stage_counts, int64_t max_rows,
              Scratch s, uint32_t* __restrict__ reps_hi,
              uint32_t* __restrict__ reps_lo, int32_t* __restrict__ sums,
              int32_t* __restrict__ info) {
  extern __shared__ unsigned long long sm_red[];
  unsigned long long* t_key = sm_red;                     // [kSlots]
  unsigned long long* r_key = t_key + kSlots;             // [kStages][kChunk]
  int32_t* t_sum = (int32_t*)(r_key + kStages * kChunk);  // [kSlots]
  int32_t* r_cnt = t_sum + kSlots;                        // [kStages][kChunk]
  __shared__ uint32_t sh_ticket, sh_epoch;
  __shared__ PassCtl ctl;
  __shared__ uint32_t sh_run[kMaxRuns + 1], sh_cur[kMaxRuns];
  __shared__ uint32_t sh_p[kRedWarps], sh_w[kRedWarps];

  if (threadIdx.x == 0) {
    const unsigned long long h = atomicAdd(s.hdr, 1ull);
    const uint32_t t = (uint32_t)h;
    uint32_t epoch = ((uint32_t)(h >> 32) + 1u) & kEpochMask;
    if (epoch == 0u) epoch = 1u;
    if (t == gridDim.x - 1) {  // every CTA has its ticket and epoch
      atomicExch(s.hdr, (unsigned long long)epoch << 32);
    }
    sh_ticket = t;
    sh_epoch = epoch;
  }
  __syncthreads();
  const int64_t k = sh_ticket;
  const uint32_t epoch = sh_epoch;
  const Leaf leaf = leaves[k];
  const bool single = (leaf.flags & kLeafSingle) != 0u;
  const unsigned long long* keys = (leaf.flags & kLeafInB) ? keys_b : keys_a;
  const int32_t* counts = (leaf.flags & kLeafInB) ? counts_b : counts_a;
  const int64_t m = leaf.count;
  bool over = !single && m > max_rows;
  uint32_t g = single ? 1u : 0u;
  uint32_t runs = 0u;  // 0: the leaf's groups fit one pass
  uint32_t* bins = (uint32_t*)r_key;
  uint16_t* order = (uint16_t*)(bins + kBins);

  if (!single && !over && m > 0) {
    g = pass_groups(keys, counts, leaf.start, m, leaf.key, t_key, t_sum,
                    r_key, r_cnt, &ctl);
    if (g == kOverflow) {
      over = stage_keys == nullptr;
      if (!over) {
        runs = (uint32_t)((m + kPassRows - 1) / kPassRows);
        partition(keys, counts, leaf.start, m, leaf.hbit, runs, stage_keys,
                  stage_counts, sh_run, sh_cur);
        g = 0u;
        for (uint32_t j = 0; j < runs && !over; ++j) {
          const int64_t at = leaf.start + sh_run[j];
          const uint32_t gj = pass_groups(
              stage_keys, stage_counts, at, sh_run[j + 1] - sh_run[j],
              leaf.key, t_key, t_sum, r_key, r_cnt, &ctl);
          over = gj == kOverflow;
          if (!over) {
            if (gj > 1u) {
              bin_sort(t_key, t_sum, gj, leaf.hbit, bins, order, sh_w);
            }
            for (uint32_t i = threadIdx.x; i < gj; i += kRedThreads) {
              stage_keys[at + i] = t_key[i];
              stage_counts[at + i] = t_sum[i];
            }
            if (threadIdx.x == 0) sh_cur[j] = gj;
            g += gj;
          }
        }
      }
    }
  }
  if (over) g = 0u;
  __syncthreads();  // every thread has read leaves[k]
  if (threadIdx.x == 0) {
    st_record(&s.scan[k], make_uint4(epoch << 1 | (k == 0 ? 1u : 0u), g, 0u,
                                     0u));
    if (over) {
      atomicAdd(&info[1], 1);
      leaves[k].flags = leaf.flags | kLeafOver;
    }
  }
  if (!single && runs == 0u && g > 1u) {
    bin_sort(t_key, t_sum, g, leaf.hbit, bins, order, sh_w);
  }

  uint32_t ex = 0u;
  if (k > 0) {
    ex = look_back(s, k, epoch, sh_p, sh_w);
    if (threadIdx.x == 0) {
      st_record(&s.scan[k], make_uint4(epoch << 1 | 1u, ex + g, 0u, 0u));
    }
  }
  if (k == n_leaves - 1 && threadIdx.x == 0) info[0] = (int32_t)(ex + g);

  if (single) {
    if (threadIdx.x == 0) {
      reps_lo[ex] = (uint32_t)leaf.key;
      if (reps_hi != nullptr) reps_hi[ex] = (uint32_t)(leaf.key >> 32);
      sums[ex] = leaf.sum;
    }
    return;
  }
  if (over) return;
  if (runs == 0u) {
    for (uint32_t i = threadIdx.x; i < g; i += kRedThreads) {
      const unsigned long long u = t_key[i];
      reps_lo[ex + i] = (uint32_t)u;
      if (reps_hi != nullptr) reps_hi[ex + i] = (uint32_t)(u >> 32);
      sums[ex + i] = t_sum[i];
    }
    return;
  }
  for (uint32_t j = 0; j < runs; ++j) {  // each run's groups, staged
    const int64_t at = leaf.start + sh_run[j];
    for (uint32_t i = threadIdx.x; i < sh_cur[j]; i += kRedThreads) {
      const unsigned long long u = stage_keys[at + i];
      reps_lo[ex + i] = (uint32_t)u;
      if (reps_hi != nullptr) reps_hi[ex + i] = (uint32_t)(u >> 32);
      sums[ex + i] = stage_counts[at + i];
    }
    ex += sh_cur[j];
  }
}

size_t scatter_smem(uint32_t max_nb) {
  return (size_t)kScatTile * 12 + (size_t)2 * max_nb * 4;
}

int set_smem(const void* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

Level level_of(const void* chunks, const void* segs) {
  Level L{};
  L.chunks = (const long long*)chunks;
  L.segs = (const long long*)segs;
  return L;
}

int launch_reduce(void* leaves, int64_t n_leaves, const void* keys_a,
                  const void* counts_a, const void* keys_b,
                  const void* counts_b, void* stage_keys, void* stage_counts,
                  void* scratch, void* reps_hi, void* reps_lo, void* sums,
                  void* info, cudaStream_t st) {
  int err = set_smem((const void*)reduce_kernel, kRedSmem);
  if (err != 0) return err;
  uint32_t* w = (uint32_t*)scratch;
  const Scratch s{(uint4*)(w + kHdrWords), (unsigned long long*)w};
  reduce_kernel<<<(unsigned)n_leaves, kRedThreads, kRedSmem, st>>>(
      (Leaf*)leaves, n_leaves, (const unsigned long long*)keys_a,
      (const int32_t*)counts_a, (const unsigned long long*)keys_b,
      (const int32_t*)counts_b, (unsigned long long*)stage_keys,
      (int32_t*)stage_counts, kMaxLeafRows, s, (uint32_t*)reps_hi,
      (uint32_t*)reps_lo, (int32_t*)sums, (int32_t*)info);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The constants the wrapper's split levels follow: the rows of a chunk
// (a scatter CTA's tile), the rows of a packed leaf (a leaf that many rows
// long always fits: it has at most that many groups).
int64_t pa_fleet_group_tile() { return kScatTile; }
int64_t pa_fleet_group_leaf_rows() { return kMaxGroups; }

// int64 words of scratch for calls of at most n_leaves leaves. The caller
// zeroes it once, when it creates it, and keeps it for every later call on
// the same stream with at most as many leaves: calls on one scratch must
// not overlap.
int64_t pa_fleet_group_scratch_words(int64_t n_leaves) {
  return kHdrWords / 2 + 2 * n_leaves;
}

// The first level and its reduce, three launches over n >= 1 unsorted
// int64 keys and their int32 counts: `bits` (1..13) top bits of the key
// (of its low 32 bits when !two_lanes: keys in [0, 2^32)) name 2^bits
// buckets; the rows go to keys_a (u64, the keys ^ 2^63) / counts_a (n
// each) in bucket order; keys_b / counts_b (n each) stage the runs of a
// bucket whose groups overflow its table; leaves (2^bits x 32 B) get the
// buckets; reps_hi
// (nullable), reps_lo and sums (n each) the groups, info (2 int32)
// n_groups and the leaves that did not fit. Returns the first CUDA error
// of the launches (0 = launched).
int pa_fleet_group(const void* keys, const void* counts, int64_t n,
                   int64_t bits, int64_t two_lanes, void* scratch,
                   void* keys_a, void* counts_a, void* keys_b,
                   void* counts_b, void* leaves, void* reps_hi,
                   void* reps_lo, void* sums, void* info, void* stream) {
  if (n < 1 || n > 0x7fffffffll || bits < 1 || bits > kMaxBits) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  uint32_t* w = (uint32_t*)scratch;
  Level L{};
  L.n = n;
  L.bits = (uint32_t)bits;
  L.shift = (uint32_t)((two_lanes ? 64 : 32) - bits);
  const unsigned long long flip = 1ull << 63;
  const unsigned long long prefix = two_lanes ? 0ull : flip;
  const uint32_t nb = 1u << bits;
  hist_kernel<<<(unsigned)((n + kHistRows - 1) / kHistRows), kHistThreads, 0,
                st>>>(L, (const unsigned long long*)keys, flip, w + 4, w + 2,
                      w + 4 + kMaxBuckets, (Leaf*)leaves, prefix,
                      (int32_t*)info);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const size_t smem = scatter_smem(nb);
  err = set_smem((const void*)scatter_kernel, smem);
  if (err != 0) return err;
  scatter_kernel<<<(unsigned)((n + kScatTile - 1) / kScatTile), kScatThreads,
                   smem, st>>>(L, (const unsigned long long*)keys,
                               (const int32_t*)counts, flip,
                               w + 4 + kMaxBuckets,
                               (unsigned long long*)keys_a,
                               (int32_t*)counts_a, nb);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_reduce(leaves, nb, keys_a, counts_a, nullptr, nullptr,
                       keys_b, counts_b, scratch, reps_hi, reps_lo, sums,
                       info, st);
}

// A split level's segments (chunks [n_chunks, 3] of (begin, end, segment)
// of at most pa_fleet_group_tile() rows; keys u64): mins, maxs, sums
// [n_segs] preset to ~0, 0, 0.
int pa_fleet_minmax(const void* keys, const void* counts, const void* chunks,
                    int64_t n_chunks, void* mins, void* maxs, void* sums,
                    void* stream) {
  if (n_chunks < 1) return (int)cudaErrorInvalidValue;
  minmax_kernel<<<(unsigned)n_chunks, kHistThreads, 0,
                  (cudaStream_t)stream>>>(
      level_of(chunks, nullptr), (const unsigned long long*)keys,
      (const int32_t*)counts, (unsigned long long*)mins,
      (unsigned long long*)maxs, (uint32_t*)sums);
  return (int)cudaGetLastError();
}

// A split level's histogram: segs [n_segs, 3] of (shift, bits <= 13, first
// bucket); hist (zeroed) gets each segment's bucket counts.
int pa_fleet_hist(const void* keys, const void* chunks, const void* segs,
                  int64_t n_chunks, void* hist, void* stream) {
  if (n_chunks < 1) return (int)cudaErrorInvalidValue;
  hist_kernel<<<(unsigned)n_chunks, kHistThreads, 0, (cudaStream_t)stream>>>(
      level_of(chunks, segs), (const unsigned long long*)keys, 0ull,
      (uint32_t*)hist, nullptr, nullptr, nullptr, 0ull, nullptr);
  return (int)cudaGetLastError();
}

// A split level's scatter, src -> dst at the same rows: cursor (u32, one
// a bucket, each set to its bucket's first row) advances; max_bits is the
// segments' largest bits.
int pa_fleet_scatter(const void* src_keys, const void* src_counts,
                     const void* chunks, const void* segs, int64_t n_chunks,
                     int64_t max_bits, void* cursor, void* dst_keys,
                     void* dst_counts, void* stream) {
  if (n_chunks < 1 || max_bits < 1 || max_bits > kMaxBits) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = scatter_smem(1u << max_bits);
  int err = set_smem((const void*)scatter_kernel, smem);
  if (err != 0) return err;
  scatter_kernel<<<(unsigned)n_chunks, kScatThreads, smem,
                   (cudaStream_t)stream>>>(
      level_of(chunks, segs), (const unsigned long long*)src_keys,
      (const int32_t*)src_counts, 0ull, (uint32_t*)cursor,
      (unsigned long long*)dst_keys, (int32_t*)dst_counts,
      1u << max_bits);
  return (int)cudaGetLastError();
}

// The reduce over n_leaves leaves in key order (rows in keys_a / counts_a,
// or keys_b / counts_b with kLeafInB; leaves of at most
// pa_fleet_group_leaf_rows() rows, which take one pass); info[1] must be 0.
int pa_fleet_reduce(void* leaves, int64_t n_leaves, const void* keys_a,
                    const void* counts_a, const void* keys_b,
                    const void* counts_b, void* scratch, void* reps_hi,
                    void* reps_lo, void* sums, void* info, void* stream) {
  if (n_leaves < 1 || n_leaves > 0x7fffffffll) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_reduce(leaves, n_leaves, keys_a, counts_a, keys_b, counts_b,
                       nullptr, nullptr, scratch, reps_hi, reps_lo, sums,
                       info, (cudaStream_t)stream);
}

const char* pa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
