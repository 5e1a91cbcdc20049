// The exact fleet merge's segment pass (B8): over rows sorted by key,
// each group's key and count sum, and the group count, in one launch.
// CUDA C++ for sm_90a, plain C interface (loaded with ctypes by
// ops/kernels.py).
//
// Replaces the step after the sort of parca_agent_tpu/parallel/fleet.py:
// _exact_program (:131) and _exact_program64 (:164), jit + shard_map
// programs (not Pallas), and the chain of torch ops that stands for them
// on the CPU (parallel/fleet.py:fleet_segment_plain). With the sorted keys
// k[0, n):
//   first[i]  = i == 0 or k[i] != k[i - 1]
//   group[i]  = (number of firsts in [0, i]) - 1
//   sums[g]   = the int32 sum (wrapping) of the counts of group g's rows
//   reps[g]   = group g's key (JAX's segment_max of a lane that all the
//               group's rows share)
//   n_groups  = the number of firsts
// The JAX program's sums and reps have n slots and only [:n_groups] is
// read; the kernel writes only [:n_groups]. The JAX program's group of
// each row is read by no caller, so it is not written: group[i] only
// names the slot that row i's key and count go to. Keys come as one
// int64 a row: the 32-bit merge's u32 key widened, or the 64-bit merge's
// (h1, h2) as (int32(h1 ^ 2^31) << 32) + h2, whose signed order is the
// unsigned order of (h1, h2) that JAX sorts by. reps_lo gets the low 32
// bits, reps_hi (the 64-bit merge only) h1 back.
//
// What bounds it on an H100: memory, and at 8.9M rows the latency of one
// pass. It must read 12 B a row (key and count) and write 12 B a group
// (both rep lanes and the sum; 8 B in the 32-bit merge): 0.038 ms at the
// fleet's 8,912,896 rows and 1,572,864 groups at 3.35 TB/s.
//
// Design: a reduce-by-key in one pass with decoupled look-back (Merrill
// and Garland; the close's csrc/close_pack.cu is the model for the ticket,
// the epoch and the 16-byte status record). Rows in tiles of 4,096 (256
// threads, 16 consecutive rows each); a CTA takes its tile from an atomic
// ticket, so it only ever waits on tiles that are already running. The
// scanned value is a pair (f, s): f the firsts in a span, s the count sum
// of the span's last group's rows in it (the whole span's sum when f = 0),
// combined as (f_a + f_b, f_b > 0 ? s_b : s_a + s_b), which is
// associative. A tile:
//   1. loads its rows (16-byte loads where it can) and each thread's next
//      key, computes its firsts and its pair;
//   2. scans the pairs over its threads (warp shuffles, then the warps'
//      totals), publishes its aggregate (tile 0: its inclusive prefix);
//   3. looks back over up to 256 predecessors at a time, a thread each,
//      summing f to the nearest inclusive prefix and s to the nearest tile
//      that holds a first, and publishes its inclusive prefix;
//   4. walks its rows: the first row of a group writes the group's key,
//      the last row its sum (the sum of a group that straddles tiles is
//      carried in by the look-back, so no atomic and no memset is needed,
//      and the words are the same from run to run); the last tile writes
//      n_groups.
// Status records without a memset: a record carries its call's epoch,
// kept in the scratch beside the ticket; the scratch is zeroed once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;
constexpr int64_t kTile = (int64_t)kThreads * kPer;
constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kEpochMask = 0x7fffffffu;

// Scratch (u32 words), zeroed once when it is created; the header first,
// so a scratch sized for more rows serves fewer:
//   hdr   u64             ticket | epoch of the last call << 32
//         u32[2]          unused (alignment)
//   scan  uint4[n_tiles]  epoch << 1 | P, f, s, 0: the tile's aggregate
//                         (P = 0) or its inclusive prefix (P = 1)
struct Scratch {
  uint4* scan;
  unsigned long long* hdr;
};

int64_t n_tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

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

// (f, s) pairs: a then b.
__device__ __forceinline__ uint2 combine(uint2 a, uint2 b) {
  return make_uint2(a.x + b.x, b.x > 0u ? b.y : a.y + b.y);
}

// Every thread of a CTA: the exclusive prefix of its pair over the CTA's
// threads, and (tile) the CTA's aggregate.
__device__ __forceinline__ uint2 block_excl_scan(uint2 x, uint2& tile,
                                                 uint2 (&sh)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint2 inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    uint2 y;
    y.x = __shfl_up_sync(kFull, inc.x, o);
    y.y = __shfl_up_sync(kFull, inc.y, o);
    if (lane >= o) inc = combine(y, inc);
  }
  uint2 ex;
  ex.x = __shfl_up_sync(kFull, inc.x, 1);
  ex.y = __shfl_up_sync(kFull, inc.y, 1);
  if (lane == 0) ex = make_uint2(0u, 0u);
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  uint2 before = make_uint2(0u, 0u);
  tile = make_uint2(0u, 0u);
#pragma unroll
  for (int q = 0; q < kWarps; ++q) {
    if (q < warp) before = combine(before, sh[q]);
    tile = combine(tile, sh[q]);
  }
  __syncthreads();  // sh is written again
  return combine(before, ex);
}

__device__ __forceinline__ uint2 block_sum2(uint32_t x, uint32_t y,
                                            uint2 (&sh)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x += __shfl_xor_sync(kFull, x, o);
    y += __shfl_xor_sync(kFull, y, o);
  }
  if (lane == 0) sh[warp] = make_uint2(x, y);
  __syncthreads();
  uint2 t = make_uint2(0u, 0u);
#pragma unroll
  for (int q = 0; q < kWarps; ++q) {
    t.x += sh[q].x;
    t.y += sh[q].y;
  }
  __syncthreads();
  return t;
}

// Every thread of a CTA: the exclusive prefix pair of tile k > 0, from its
// predecessors' records, kThreads at a time (thread i reads tile top - i).
// f sums the records up to the nearest inclusive prefix; s sums them up
// to the nearest record with f > 0 (an inclusive prefix always has one:
// row 0 is a first), and stops there for good.
__device__ uint2 look_back(const Scratch& s, int64_t k, uint32_t epoch,
                           uint32_t (&sh_p)[kWarps], uint32_t (&sh_f)[kWarps],
                           uint2 (&sh)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint2 ex = make_uint2(0u, 0u);
  bool s_done = false;
  for (int64_t top = k - 1;; top -= kThreads) {
    const int64_t j = top - threadIdx.x;
    uint4 r = make_uint4(epoch << 1 | 1u, 0u, 0u, 0u);
    if (j >= 0) {
      do {
        r = ld_record(&s.scan[j]);
      } while ((r.x >> 1) != epoch);
    }
    const uint32_t pm = __ballot_sync(kFull, (r.x & 1u) != 0u);
    const uint32_t fm = __ballot_sync(kFull, r.y != 0u);
    if (lane == 0) {
      sh_p[warp] = pm;
      sh_f[warp] = fm;
    }
    __syncthreads();
    int stop = kThreads, first_f = kThreads;
#pragma unroll
    for (int q = kWarps - 1; q >= 0; --q) {
      if (sh_p[q]) stop = q * 32 + __ffs(sh_p[q]) - 1;
      if (sh_f[q]) first_f = q * 32 + __ffs(sh_f[q]) - 1;
    }
    const int lim = first_f < stop ? first_f : stop;
    const bool in_f = (int)threadIdx.x <= stop;
    const bool in_s = (int)threadIdx.x <= lim;
    const uint2 w = block_sum2(in_f ? r.y : 0u, in_s ? r.z : 0u, sh);
    ex.x += w.x;
    if (!s_done) ex.y += w.y;
    s_done = s_done || first_f < kThreads;
    if (stop < kThreads) return ex;
  }
}

__global__ void __launch_bounds__(kThreads)
fleet_segment_kernel(const long long* __restrict__ keys,
                     const int32_t* __restrict__ counts, int64_t n,
                     int64_t n_tiles, Scratch s,
                     uint32_t* __restrict__ reps_hi,
                     uint32_t* __restrict__ reps_lo,
                     int32_t* __restrict__ sums,
                     int32_t* __restrict__ n_groups) {
  __shared__ uint32_t sh_ticket, sh_epoch;
  __shared__ uint32_t sh_p[kWarps], sh_f[kWarps];
  __shared__ uint2 sh[kWarps];

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

  // 1. The thread's rows, its next key, its firsts and its pair.
  const int64_t base = k * kTile + (int64_t)threadIdx.x * kPer;
  long long key[kPer];
  int32_t cnt[kPer];
  if (base + kPer <= n) {
    const longlong2* kp = (const longlong2*)(keys + base);
#pragma unroll
    for (int q = 0; q < kPer / 2; ++q) {
      const longlong2 v = __ldg(kp + q);
      key[2 * q] = v.x;
      key[2 * q + 1] = v.y;
    }
    const int4* cp = (const int4*)(counts + base);
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const int4 v = __ldg(cp + q);
      cnt[4 * q] = v.x;
      cnt[4 * q + 1] = v.y;
      cnt[4 * q + 2] = v.z;
      cnt[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const bool ok = base + q < n;
      key[q] = ok ? __ldg(keys + base + q) : 0ll;
      cnt[q] = ok ? __ldg(counts + base + q) : 0;
    }
  }
  const long long prev = base > 0 && base <= n ? __ldg(keys + base - 1) : 0ll;
  const long long next = base + kPer < n ? __ldg(keys + base + kPer) : 0ll;
  uint32_t firsts = 0u;  // bit q: row base + q starts a group
  uint2 mine = make_uint2(0u, 0u);
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    if (base + q < n) {
      const bool f = base + q == 0 || key[q] != (q == 0 ? prev : key[q - 1]);
      if (f) {
        firsts |= 1u << q;
        mine.x += 1u;
        mine.y = (uint32_t)cnt[q];
      } else {
        mine.y += (uint32_t)cnt[q];
      }
    }
  }

  // 2. The tile's scan; its aggregate published (tile 0: its prefix).
  uint2 agg;
  const uint2 ex_in = block_excl_scan(mine, agg, sh);
  if (threadIdx.x == 0) {
    st_record(&s.scan[k], make_uint4(epoch << 1 | (k == 0 ? 1u : 0u), agg.x,
                                     agg.y, 0u));
  }

  // 3. Look back, publish the inclusive prefix.
  uint2 ex = make_uint2(0u, 0u);
  if (k > 0) {
    ex = look_back(s, k, epoch, sh_p, sh_f, sh);
    if (threadIdx.x == 0) {
      const uint2 inc = combine(ex, agg);
      st_record(&s.scan[k], make_uint4(epoch << 1 | 1u, inc.x, inc.y, 0u));
    }
  }
  if (k == n_tiles - 1 && threadIdx.x == 0) {
    n_groups[0] = (int32_t)(ex.x + agg.x);
  }

  // 4. Keys at the groups' first rows, sums at their last.
  uint2 run = combine(ex, ex_in);
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int64_t i = base + q;
    if (i < n) {
      const bool f = (firsts >> q) & 1u;
      if (f) {
        run.x += 1u;
        run.y = (uint32_t)cnt[q];
      } else {
        run.y += (uint32_t)cnt[q];
      }
      const int64_t g = (int64_t)run.x - 1;
      if (f) {
        reps_lo[g] = (uint32_t)key[q];
        if (reps_hi != nullptr) {
          reps_hi[g] = (uint32_t)((unsigned long long)key[q] >> 32) ^
                       0x80000000u;
        }
      }
      const bool last = i == n - 1 ||
                        (q + 1 < kPer ? key[q + 1] : next) != key[q];
      if (last) sums[g] = (int32_t)run.y;
    }
  }
}

}  // namespace

extern "C" {

// int64 words of scratch the segment pass needs for n rows. The caller
// zeroes it once, when it creates it, and keeps it for every later call
// on the same stream with at most as many rows: calls on one scratch
// must not overlap.
int64_t pa_fleet_segment_scratch_words(int64_t n) {
  return 2 * n_tiles_of(n) + 2;
}

// One launch over n >= 1 sorted int64 keys and their int32 counts, both
// 16-byte aligned. reps_hi is nullable; reps_lo and
// sums need n_groups slots (n is always enough), n_groups one int32.
// Returns cudaGetLastError() right after the launch (0 = launched).
int pa_fleet_segment(const void* keys, const void* counts, int64_t n,
                     void* scratch, void* reps_hi,
                     void* reps_lo, void* sums, void* n_groups,
                     void* stream) {
  if (n < 1 || ((uintptr_t)keys & 15u) != 0 ||
      ((uintptr_t)counts & 15u) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t n_tiles = n_tiles_of(n);
  if (n_tiles > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  uint32_t* w = (uint32_t*)scratch;
  const Scratch s{(uint4*)(w + 4), (unsigned long long*)w};
  fleet_segment_kernel<<<(unsigned)n_tiles, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const long long*)keys, (const int32_t*)counts, n, n_tiles, s,
      (uint32_t*)reps_hi, (uint32_t*)reps_lo,
      (int32_t*)sums, (int32_t*)n_groups);
  return (int)cudaGetLastError();
}

const char* pa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
