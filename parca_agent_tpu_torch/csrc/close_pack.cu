// The stack dictionary's window close: the accumulator packed at 4, 8 or
// 16 bits with an exact overflow sideband, in full form (B2) and in delta
// form (B3). CUDA C++ for sm_90a, plain C interface (loaded with ctypes by
// ops/kernels.py).
//
// Replaces parca_agent_tpu/aggregator/dict.py:make_close (:170) and
// make_close_delta (:232), two jit programs (not Pallas), and the chains
// of torch ops that stand for them on the CPU
// (aggregator/close.py:close_pack_plain, close_pack_delta_plain). The
// output is their buffer, bit for bit.
//
// What it computes. sentinel = 2^W - 1; a count v is "over" when
// v > sentinel - 1 (as int32) and packs as the sentinel, else as its own
// u32 bits; per32 = 32 / W counts share a u32 lane, the lowest id in the
// lowest bits, summed mod 2^32.
//   full:  [ lanes of acc[0, n_fetch) | over ids (n_fetch = none) |
//            over counts | n_over | tail ]                  u32 each
//   delta: [ lanes of the first n_blk_buf touched 128-id blocks, in
//            ascending block order (zero lanes past n_touched) |
//            their block ids (nb_prefix = none) | over GLOBAL ids |
//            over counts | n_touched | n_over | untouched | tail ]
// Over ids are written in ascending id order, the first n_over_buf of
// them. In the delta form n_over and the sideband cover only the fetched
// blocks. The guards (tail: the mass of acc[n_fetch, id_cap); untouched:
// the mass of the prefix blocks whose touch flag is 0) are u32 sums that
// wrap, equal to the JAX program's int32 sums cast to u32.
//
// What bounds it on an H100: memory, and at the dictionary's sizes the
// latency of one pass. It must read acc (4 MB at id_cap 2^20) and write
// the lanes and the sideband: a few MB, under 2 us at 3.35 TB/s.
//
// Design: one launch a call, one read of acc, a single-pass scan with
// decoupled look-back (Merrill and Garland, as CUB's). Ids in tiles of
// 4,096 (256 threads, 16 consecutive ids each, so 8 threads cover one
// 128-id block). A CTA takes its tile from an atomic ticket, so a tile
// only ever waits on tiles that are already running, however many waves
// the grid takes. A tile:
//   1. loads its ids once into registers;
//   2. reduces its aggregate (touched blocks and over ids, over ids in
//      touched blocks only in the delta form) and publishes it (A), and
//      its guard masses (untouched, tail) in a record of their own, which
//      only the counters read;
//   3. with every thread, looks back over up to 256 predecessors at a
//      time (a thread each), adding aggregates until it meets an
//      inclusive prefix (P), and publishes its own (at id_cap 2^20, 256
//      tiles: one round of loads a tile);
//   4. writes from the same registers: its lanes (the full form writes
//      them before the look-back, they depend on nothing else), its over
//      ids at the exclusive over prefix plus their rank in the tile (a
//      block scan in thread order); in the delta form a touched block is
//      fetched iff its exclusive touched rank is below n_blk_buf, and then
//      packs its lanes and id at that rank. The tile that holds the
//      touched block of rank n_blk_buf publishes the over prefix there:
//      n_over of the fetched blocks.
// The CTAs past the last tile (a few, so many that each fills at most
// 4,096 words) look back from past the last tile, for the totals, write
// the counters and spread the padding between them: the sideband past
// n_over, and in the delta form the lanes and block ids past n_touched.
// They hold the highest tickets, so every tile they wait on is running.
//
// Status records without a memset or a fence: a record is one 16-byte
// word, its status and values written and read in one access (CUB's tile
// status for 8-byte values relies on the same), which the two scanned
// counts allow; with the two guard masses the record would take five
// words, so they go to a record of their own, not scanned, summed only
// for the counters. Every record carries the call's epoch,
// kept in the scratch itself beside the ticket, in one 64-bit word that a
// CTA's one atomic reads and bumps: the CTA with the last ticket resets
// the ticket and stores the epoch, and stream order makes the next call
// see both. Epochs start at 1, so the records of a freshly zeroed scratch
// read as stale, and the scratch is never cleared again. No atomic
// decides where a value lands (the only atomics are on the ticket and
// epoch word): the buffer is the same from run to run.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                      // ids a thread
constexpr int kTile = kThreads * kPer;        // ids a tile
constexpr int kBlk = 128;                     // ids a touch flag
constexpr int kLanesPerBlk = kBlk / kPer;     // 8 threads a block
constexpr int kPadWords = kThreads * 16;      // padding words a CTA fills
constexpr int kMaxPadCtas = 64;
constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kEpochMask = 0x7fffffffu;

// Scratch (u32 words), zeroed once when it is created:
//   scan  uint4[n_tiles]  epoch << 1 | P, touched blocks, over ids, 0: the
//                         tile's aggregate (P = 0) or inclusive prefix
//   guard uint4[n_tiles]  epoch, untouched mass, tail mass, 0
//   hdr   u64             ticket | epoch of the last call << 32
//         u32[2]          unused (alignment)
//   cut   uint4           epoch, n_over of the fetched blocks, 0, 0
struct Scratch {
  uint4* scan;
  uint4* guard;
  unsigned long long* hdr;
  uint4* cut;
};

int64_t n_tiles_of(int64_t id_cap) { return (id_cap + kTile - 1) / kTile; }

Scratch carve(void* p, int64_t n_tiles) {
  uint32_t* w = (uint32_t*)p;
  uint32_t* h = w + 8 * n_tiles;
  return Scratch{(uint4*)w, (uint4*)(w + 4 * n_tiles),
                 (unsigned long long*)h, (uint4*)(h + 4)};
}

// A record is read and written as one 16-byte access, so its status and
// its values are seen together and no fence orders them (CUB's tile
// status for 8-byte values relies on the same).
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

__device__ __forceinline__ uint32_t warp_sum(uint32_t x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ uint32_t warp_incl_scan(uint32_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Every thread of a CTA: the sums of x and of y over the CTA's threads.
__device__ __forceinline__ uint2 block_sum2(uint32_t x, uint32_t y,
                                            uint2 (&sh)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  y = warp_sum(y);
  if (lane == 0) sh[warp] = make_uint2(x, y);
  __syncthreads();
  uint2 t = make_uint2(0u, 0u);
#pragma unroll
  for (int q = 0; q < kWarps; ++q) {
    t.x += sh[q].x;
    t.y += sh[q].y;
  }
  __syncthreads();  // sh is written again
  return t;
}

// Every thread of a CTA: the exclusive prefix (touched blocks, over ids)
// of tile k > 0 (for k = n_tiles: the totals), from its predecessors'
// records, a window of kThreads at a time (thread i reads tile top - i):
// the records up to the nearest inclusive prefix are summed, else the
// whole window and the next.
__device__ uint2 look_back(const Scratch& s, int64_t k, uint32_t epoch,
                           uint32_t (&sh_p)[kWarps], uint2 (&sh)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint2 ex = make_uint2(0u, 0u);
  for (int64_t top = k - 1;; top -= kThreads) {
    const int64_t j = top - threadIdx.x;
    // Before tile 0: an inclusive prefix of zero (never summed: tile 0's
    // own record is P and comes first).
    uint4 r = make_uint4(epoch << 1 | 1u, 0u, 0u, 0u);
    if (j >= 0) {
      do {
        r = ld_record(&s.scan[j]);
      } while ((r.x >> 1) != epoch);
    }
    const bool is_p = r.x & 1u;
    const uint32_t pm = __ballot_sync(kFull, is_p);
    if (lane == 0) sh_p[warp] = pm;
    __syncthreads();
    int stop = kThreads;
#pragma unroll
    for (int q = kWarps - 1; q >= 0; --q) {
      if (sh_p[q]) stop = q * 32 + __ffs(sh_p[q]) - 1;
    }
    const bool in = (int)threadIdx.x <= stop;
    const uint2 w = block_sum2(in ? r.y : 0u, in ? r.z : 0u, sh);
    ex.x += w.x;
    ex.y += w.y;
    if (stop < kThreads) return ex;
  }
}

// The kPer counts of one thread packed into kPer * W / 32 lanes at `dst`;
// with `valid` < kPer only the lanes of the first `valid` ids.
template <int W>
__device__ __forceinline__ void pack_lanes(const int32_t (&v)[kPer],
                                           uint32_t* __restrict__ dst,
                                           int valid = kPer) {
  constexpr int kPer32 = 32 / W;
  constexpr uint32_t kSentinel = (1u << W) - 1u;
#pragma unroll
  for (int w = 0; w < kPer / kPer32; ++w) {
    uint32_t lane = 0u;
#pragma unroll
    for (int q = 0; q < kPer32; ++q) {
      const int32_t x = v[w * kPer32 + q];
      const uint32_t u = x >= (int32_t)kSentinel ? kSentinel : (uint32_t)x;
      lane += u << (q * W);
    }
    if (w * kPer32 < valid) dst[w] = lane;
  }
}

// p[from, to) = value, the words spread over the padding CTAs.
__device__ __forceinline__ void fill(uint32_t* __restrict__ p, int64_t from,
                                     int64_t to, uint32_t value, int64_t q,
                                     int64_t n_q) {
  const int64_t stride = n_q * kThreads;
  for (int64_t i = from + q * kThreads + threadIdx.x; i < to; i += stride) {
    p[i] = value;
  }
}

template <int W, bool kDelta>
__global__ void __launch_bounds__(kThreads)
close_pack_kernel(const int32_t* __restrict__ acc,
                  const int32_t* __restrict__ touch, int64_t id_cap,
                  int64_t n_fetch, int64_t n_over_buf, int64_t n_blk_buf,
                  int64_t n_tiles, Scratch s, uint32_t* __restrict__ out) {
  constexpr int kPer32 = 32 / W;
  constexpr int32_t kOverMin = (int32_t)((1u << W) - 1u);  // sentinel
  const int64_t nb_prefix = n_fetch / kBlk;
  const int64_t lanes = kDelta ? n_blk_buf * kBlk / kPer32 : n_fetch / kPer32;
  uint32_t* blk_ids = out + lanes;  // delta only
  uint32_t* over_id = blk_ids + (kDelta ? n_blk_buf : 0);
  uint32_t* over_val = over_id + n_over_buf;
  uint32_t* counters = over_val + n_over_buf;

  __shared__ uint32_t sh_ticket, sh_epoch, sh_n_over;
  __shared__ uint32_t sh_scan[kWarps], sh_unt[kWarps], sh_tail[kWarps];
  __shared__ uint32_t sh_p[kWarps];
  __shared__ uint2 sh_2[kWarps];

  // The ticket and the epoch, in one atomic.
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

  if (k >= n_tiles) {
    // Padding and counters, once the totals (the prefix past the last
    // tile) and, when the touched blocks overrun n_blk_buf, the over
    // prefix at the cut are published.
    const uint2 tot = look_back(s, n_tiles, epoch, sh_p, sh_2);
    if (k == n_tiles) {
      // The guards: every tile's masses.
      uint32_t unt = 0u, tail = 0u;
      for (int64_t j = threadIdx.x; j < n_tiles; j += kThreads) {
        uint4 g;
        do {
          g = ld_record(&s.guard[j]);
        } while (g.x != epoch);
        unt += g.y;
        tail += g.z;
      }
      const uint2 gs = block_sum2(unt, tail, sh_2);
      if (threadIdx.x == 0) {
        if (kDelta) {
          counters[0] = tot.x;
          counters[2] = gs.x;
          counters[3] = gs.y;
        } else {
          counters[0] = tot.y;
          counters[1] = gs.y;
        }
      }
    }
    if (threadIdx.x == 0) {
      uint32_t n_over = tot.y;
      if (kDelta && (int64_t)tot.x > n_blk_buf) {
        uint4 c;
        do {
          c = ld_record(s.cut);
        } while (c.x != epoch);
        n_over = c.y;
      }
      if (kDelta && k == n_tiles) counters[1] = n_over;
      sh_n_over = n_over;
    }
    __syncthreads();
    const int64_t q = k - n_tiles, n_q = gridDim.x - n_tiles;
    const int64_t n_over = sh_n_over;
    const int64_t from = n_over < n_over_buf ? n_over : n_over_buf;
    fill(over_id, from, n_over_buf, (uint32_t)n_fetch, q, n_q);
    fill(over_val, from, n_over_buf, 0u, q, n_q);
    if (kDelta) {
      const int64_t n_touched = tot.x;
      const int64_t f = n_touched < n_blk_buf ? n_touched : n_blk_buf;
      fill(out, f * kBlk / kPer32, lanes, 0u, q, n_q);
      fill(blk_ids, f, n_blk_buf, (uint32_t)nb_prefix, q, n_q);
    }
    return;
  }

  // 1. The tile's ids, once, into registers.
  const int64_t base = k * kTile + (int64_t)threadIdx.x * kPer;
  const int64_t b = base / kBlk;
  const bool touched = !kDelta || (b < nb_prefix && __ldg(&touch[b]) > 0);
  int32_t v[kPer];
  if (base + kPer <= id_cap && ((uintptr_t)acc & 15u) == 0u) {
    const int4* p = (const int4*)(acc + base);
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const int4 x = __ldg(p + q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      v[q] = base + q < id_cap ? __ldg(&acc[base + q]) : 0;
    }
  }
  uint32_t c = 0u, untouched = 0u, tail = 0u;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    if (base + q >= n_fetch) {
      tail += (uint32_t)v[q];
    } else if (touched) {
      c += v[q] >= kOverMin ? 1u : 0u;
    } else {
      untouched += (uint32_t)v[q];
    }
  }

  // 2. The aggregate: touched blocks (counted by a block's last thread,
  // so the exclusive scan gives every thread of a block its rank) and
  // over ids scanned together in thread order (over ids of a tile
  // < 2^16), the guard masses summed. Published at once: the scan
  // record, and the guard record that only the counters read.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool lead =
      kDelta && touched && threadIdx.x % kLanesPerBlk == kLanesPerBlk - 1;
  const uint32_t x = (lead ? 1u << 16 : 0u) | c;
  const uint32_t inc = warp_incl_scan(x);
  const uint32_t w_unt = warp_sum(untouched), w_tail = warp_sum(tail);
  if (lane == 31) {
    sh_scan[warp] = inc;
    sh_unt[warp] = w_unt;
    sh_tail[warp] = w_tail;
  }
  __syncthreads();
  uint32_t excl = inc - x, total = 0u;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) {
    excl += q < warp ? sh_scan[q] : 0u;
    total += sh_scan[q];
  }
  const uint32_t agg_t = total >> 16, agg_o = total & 0xffffu;
  if (threadIdx.x == 0) {
    st_record(&s.scan[k], make_uint4(epoch << 1 | (k == 0 ? 1u : 0u), agg_t,
                                     agg_o, 0u));
  } else if (threadIdx.x == 32) {
    uint32_t gu = 0u, gt = 0u;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      gu += sh_unt[q];
      gt += sh_tail[q];
    }
    st_record(&s.guard[k], make_uint4(epoch, gu, gt, 0u));
  }
  // Full form: the lanes, which depend on nothing else.
  if (!kDelta && base < n_fetch) {
    const int64_t valid = n_fetch - base;
    pack_lanes<W>(v, out + base / kPer32, valid < kPer ? (int)valid : kPer);
  }

  // 3. Look back, publish the inclusive prefix.
  uint2 ex = make_uint2(0u, 0u);
  if (k > 0) {
    ex = look_back(s, k, epoch, sh_p, sh_2);
    if (threadIdx.x == 0) {
      st_record(&s.scan[k], make_uint4(epoch << 1 | 1u, ex.x + agg_t,
                                       ex.y + agg_o, 0u));
    }
  }

  // 4. Lanes (delta), block ids, the cut, over ids.
  bool fetched = !kDelta || touched;
  if (kDelta && touched) {
    const uint64_t r = (uint64_t)ex.x + (excl >> 16);
    fetched = r < (uint64_t)n_blk_buf;
    const int j = threadIdx.x % kLanesPerBlk;
    if (fetched) {
      pack_lanes<W>(v, out + ((int64_t)r * kBlk + j * kPer) / kPer32);
      if (j == 0) blk_ids[r] = (uint32_t)b;
    } else if (j == 0 && r == (uint64_t)n_blk_buf) {
      // The first block past the buffer: n_over of the fetched blocks.
      st_record(s.cut, make_uint4(epoch, ex.y + (excl & 0xffffu), 0u, 0u));
    }
  }
  if (fetched && c) {
    uint64_t rank = (uint64_t)ex.y + (excl & 0xffffu);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (base + q < n_fetch && v[q] >= kOverMin) {
        if (rank < (uint64_t)n_over_buf) {
          over_id[rank] = (uint32_t)(base + q);
          over_val[rank] = (uint32_t)v[q];
        }
        ++rank;
      }
    }
  }
}

template <int W>
int launch(const int32_t* acc, const int32_t* touch, int64_t id_cap,
           int64_t n_fetch, int64_t n_over_buf, int64_t n_blk_buf,
           void* scratch, uint32_t* out, cudaStream_t stream) {
  const int64_t n_tiles = n_tiles_of(id_cap);
  const Scratch s = carve(scratch, n_tiles);
  int64_t pad = 2 * n_over_buf;
  if (touch != nullptr) pad += n_blk_buf * kBlk / (32 / W) + n_blk_buf;
  int64_t n_pad = (pad + kPadWords - 1) / kPadWords;
  n_pad = n_pad < 1 ? 1 : (n_pad > kMaxPadCtas ? kMaxPadCtas : n_pad);
  const unsigned grid = (unsigned)(n_tiles + n_pad);
  if (touch == nullptr) {
    close_pack_kernel<W, false><<<grid, kThreads, 0, stream>>>(
        acc, nullptr, id_cap, n_fetch, n_over_buf, 0, n_tiles, s, out);
  } else {
    close_pack_kernel<W, true><<<grid, kThreads, 0, stream>>>(
        acc, touch, id_cap, n_fetch, n_over_buf, n_blk_buf, n_tiles, s, out);
  }
  return (int)cudaGetLastError();
}

int dispatch(const void* acc, const void* touch, int64_t id_cap,
             int64_t n_fetch, int64_t width, int64_t n_over_buf,
             int64_t n_blk_buf, void* scratch, void* out, void* stream) {
  const int32_t* a = (const int32_t*)acc;
  const int32_t* tf = (const int32_t*)touch;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (width) {
    case 4:
      return launch<4>(a, tf, id_cap, n_fetch, n_over_buf, n_blk_buf,
                       scratch, o, st);
    case 8:
      return launch<8>(a, tf, id_cap, n_fetch, n_over_buf, n_blk_buf,
                       scratch, o, st);
    case 16:
      return launch<16>(a, tf, id_cap, n_fetch, n_over_buf, n_blk_buf,
                        scratch, o, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// u32 words of scratch the close needs at this id_cap. The caller zeroes
// it once, when it creates it, and keeps it for every later call on the
// same stream at this id_cap (full and delta form alike): calls on one
// scratch must not overlap.
int64_t pa_close_scratch_words(int64_t id_cap) {
  return 8 * n_tiles_of(id_cap) + 8;
}

// Each entry point enqueues one kernel and returns cudaGetLastError()
// right after it (0 = launched); the Python wrapper raises on anything
// else. The wrapper checks the shapes: 0 < n_fetch <= id_cap,
// n_fetch % (32 / width) == 0, and in the delta form n_fetch % 128 == 0
// and touch of at least n_fetch / 128 flags.

int pa_close_pack(const void* acc, int64_t id_cap, int64_t n_fetch,
                  int64_t width, int64_t n_over_buf, void* scratch,
                  void* out, void* stream) {
  return dispatch(acc, nullptr, id_cap, n_fetch, width, n_over_buf, 0,
                  scratch, out, stream);
}

int pa_close_pack_delta(const void* acc, const void* touch, int64_t id_cap,
                        int64_t n_fetch, int64_t width, int64_t n_over_buf,
                        int64_t n_blk_buf, void* scratch, void* out,
                        void* stream) {
  return dispatch(acc, touch, id_cap, n_fetch, width, n_over_buf, n_blk_buf,
                  scratch, out, stream);
}

const char* pa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
