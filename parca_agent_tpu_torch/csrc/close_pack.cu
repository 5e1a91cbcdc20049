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
// launches. It must read acc (4 MB at id_cap 2^20; in the delta form only
// the fetched blocks, plus the touch flags) and write the lanes and the
// sideband: a few MB, a few microseconds at 3.35 TB/s.
//
// Design: ids in tiles of 4,096 (256 threads, 16 consecutive ids each,
// so 8 threads cover one 128-id block). Three launches on the caller's
// stream, no atomics, so the buffer is the same from run to run:
//   1. tile_sums: a block a tile counts its over ids (in the delta form:
//      in touched blocks only, and per block), its touched blocks, and
//      its partial guard sums;
//   2. tile_scan: one block scans the tile counts into exclusive prefixes
//      (a few hundred tiles at id_cap 2^20), and writes the counters and
//      guards; in the delta form n_over counts the fetched blocks only,
//      which needs the per-block counts of the one tile that straddles
//      the n_blk_buf-th touched block;
//   3. pack_full / pack_delta: a block a tile packs its lanes at their
//      place (full: by id; delta: by the block's rank among the touched
//      ones), scans its over counts in thread order and writes each over
//      id at its tile prefix plus its rank in the tile; then every block
//      fills its share of the padding (sideband past n_over, delta lanes
//      and block ids past n_touched).
// A single pass with decoupled look-back would save two launches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kPer = 16;                      // ids a thread
constexpr int kTile = kThreads * kPer;        // 4096 ids a tile
constexpr int kBlk = 128;                     // ids a touch flag
constexpr int kBlocksPerTile = kTile / kBlk;  // 32
constexpr int kLanesPerBlk = kBlk / kPer;     // 8 threads a block

// Per-tile counts and their exclusive prefixes, then a count per block.
struct Scratch {
  uint32_t* t_touched;    // touched blocks in the tile (delta)
  uint32_t* t_over;       // over ids in the tile (delta: touched blocks)
  uint32_t* t_untouched;  // mass of the tile's untouched prefix blocks
  uint32_t* t_tail;       // mass of the tile's ids >= n_fetch
  uint32_t* p_touched;    // exclusive prefix of t_touched
  uint32_t* p_over;       // exclusive prefix of t_over
  uint32_t* blk_over;     // over ids a touched block (delta)
};

int64_t n_tiles_of(int64_t id_cap) { return (id_cap + kTile - 1) / kTile; }
int64_t n_blocks_of(int64_t id_cap) { return (id_cap + kBlk - 1) / kBlk; }

Scratch carve(void* p, int64_t id_cap) {
  uint32_t* w = (uint32_t*)p;
  const int64_t nt = n_tiles_of(id_cap);
  return Scratch{w, w + nt, w + 2 * nt, w + 3 * nt, w + 4 * nt, w + 5 * nt,
                 w + 6 * nt};
}

__device__ __forceinline__ uint32_t warp_incl_scan(uint32_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Exclusive scan of x over the block in thread order (blockDim a multiple
// of 32); *total gets the block's sum (mod 2^32). Every thread calls it.
__device__ uint32_t block_excl_scan(uint32_t x, uint32_t* total) {
  __shared__ uint32_t warp_off[32];
  __shared__ uint32_t total_sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const uint32_t inc = warp_incl_scan(x);
  if (lane == 31) warp_off[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = lane < n_warps ? warp_off[lane] : 0u;
    const uint32_t wi = warp_incl_scan(w);
    if (lane < n_warps) warp_off[lane] = wi - w;
    if (lane == 31) total_sh = wi;
  }
  __syncthreads();
  const uint32_t out = warp_off[warp] + inc - x;
  *total = total_sh;
  __syncthreads();  // the next call may overwrite warp_off
  return out;
}

__device__ __forceinline__ uint32_t block_sum(uint32_t x) {
  uint32_t total;
  block_excl_scan(x, &total);
  return total;
}

// 1. A block a tile: its counts and partial guard sums. touch == nullptr
// is the full form: every id below n_fetch counts as touched.
template <int W>
__global__ void tile_sums(const int32_t* __restrict__ acc, int64_t id_cap,
                          int64_t n_fetch, const int32_t* __restrict__ touch,
                          int64_t nb_prefix, Scratch s) {
  constexpr int32_t kOverMin = (int32_t)((1u << W) - 1u);  // sentinel
  const int64_t t = blockIdx.x;
  const int64_t base = t * kTile + (int64_t)threadIdx.x * kPer;
  const int64_t b = base / kBlk;
  const bool touched =
      touch == nullptr || (b < nb_prefix && __ldg(&touch[b]) > 0);
  uint32_t over = 0u, untouched = 0u, tail = 0u;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t id = base + k;
    if (id < id_cap) {
      const int32_t v = __ldg(&acc[id]);
      if (id >= n_fetch) {
        tail += (uint32_t)v;
      } else if (touched) {
        over += v >= kOverMin ? 1u : 0u;
      } else {
        untouched += (uint32_t)v;
      }
    }
  }
  // The 8 threads of a block are 8 neighbouring lanes of one warp.
  uint32_t blk = over;
  blk += __shfl_xor_sync(0xffffffffu, blk, 1);
  blk += __shfl_xor_sync(0xffffffffu, blk, 2);
  blk += __shfl_xor_sync(0xffffffffu, blk, 4);
  const bool lead = threadIdx.x % kLanesPerBlk == 0;
  if (touch != nullptr && lead && base < id_cap) {
    s.blk_over[b] = touched ? blk : 0u;
  }
  const uint32_t n_touched = block_sum(
      touch != nullptr && lead && touched ? 1u : 0u);
  const uint32_t n_over = block_sum(over);
  const uint32_t n_untouched = block_sum(untouched);
  const uint32_t n_tail = block_sum(tail);
  if (threadIdx.x == 0) {
    s.t_touched[t] = n_touched;
    s.t_over[t] = n_over;
    s.t_untouched[t] = n_untouched;
    s.t_tail[t] = n_tail;
  }
}

// 2. One block: exclusive prefixes of the tile counts, then the counters.
// counters: full  [n_over, tail];
//           delta [n_touched, n_over (fetched blocks), untouched, tail].
__global__ void tile_scan(int64_t n_tiles, const int32_t* __restrict__ touch,
                          int64_t nb_prefix, int64_t n_blk_buf, Scratch s,
                          uint32_t* __restrict__ counters) {
  uint32_t carry_t = 0u, carry_o = 0u, untouched = 0u, tail = 0u;
  for (int64_t c0 = 0; c0 < n_tiles; c0 += blockDim.x) {
    const int64_t j = c0 + threadIdx.x;
    const bool in = j < n_tiles;
    const uint32_t a = in ? s.t_touched[j] : 0u;
    const uint32_t o = in ? s.t_over[j] : 0u;
    uint32_t ta, to;
    const uint32_t ea = block_excl_scan(a, &ta);
    const uint32_t eo = block_excl_scan(o, &to);
    if (in) {
      s.p_touched[j] = carry_t + ea;
      s.p_over[j] = carry_o + eo;
      untouched += s.t_untouched[j];
      tail += s.t_tail[j];
    }
    carry_t += ta;
    carry_o += to;
  }
  untouched = block_sum(untouched);
  tail = block_sum(tail);
  if (touch == nullptr) {
    if (threadIdx.x == 0) {
      counters[0] = carry_o;
      counters[1] = tail;
    }
    return;
  }
  // Over ids of the fetched blocks: the first F touched ones. Tiles wholly
  // below the F-th count whole; the one that straddles it counts its
  // first F - p touched blocks. (Each thread reads back only the prefixes
  // it wrote itself.)
  const uint64_t f = carry_t < (uint64_t)n_blk_buf ? carry_t
                                                   : (uint64_t)n_blk_buf;
  uint32_t fetched = 0u;
  for (int64_t j = threadIdx.x; j < n_tiles; j += blockDim.x) {
    const uint64_t p = s.p_touched[j];
    if (p + s.t_touched[j] <= f) {
      fetched += s.t_over[j];
    } else if (p < f) {
      uint64_t r = p;
      for (int lb = 0; lb < kBlocksPerTile && r < f; ++lb) {
        const int64_t b = j * kBlocksPerTile + lb;
        if (b >= nb_prefix) break;
        if (touch[b] > 0) {
          fetched += s.blk_over[b];
          ++r;
        }
      }
    }
  }
  fetched = block_sum(fetched);
  if (threadIdx.x == 0) {
    counters[0] = carry_t;
    counters[1] = fetched;
    counters[2] = untouched;
    counters[3] = tail;
  }
}

// The kPer counts of one thread packed into kPer * W / 32 lanes at `dst`.
template <int W>
__device__ __forceinline__ void pack_lanes(const int32_t (&v)[kPer],
                                           uint32_t* __restrict__ dst) {
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
    dst[w] = lane;
  }
}

// p[from, to) = value, the words spread over the whole grid (padding:
// the sideband past n_over, the delta lanes and block ids past n_touched).
__device__ __forceinline__ void fill_grid(uint32_t* __restrict__ p,
                                          int64_t from, int64_t to,
                                          uint32_t value) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t k = from + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       k < to; k += stride) {
    p[k] = value;
  }
}

// 3a. Full form: a block a tile of acc[0, n_fetch).
template <int W>
__global__ void pack_full(const int32_t* __restrict__ acc, int64_t n_fetch,
                          int64_t n_over_buf, Scratch s,
                          uint32_t* __restrict__ out) {
  constexpr int kPer32 = 32 / W;
  constexpr int32_t kOverMin = (int32_t)((1u << W) - 1u);
  const int64_t lanes = n_fetch / kPer32;
  uint32_t* over_id = out + lanes;
  uint32_t* over_val = over_id + n_over_buf;
  const uint32_t* counters = over_val + n_over_buf;
  const int64_t t = blockIdx.x;
  const int64_t base = t * kTile + (int64_t)threadIdx.x * kPer;
  int32_t v[kPer];
  uint32_t c = 0u;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    v[k] = base + k < n_fetch ? __ldg(&acc[base + k]) : 0;
    c += v[k] >= kOverMin ? 1u : 0u;
  }
  if (base + kPer <= n_fetch) {
    pack_lanes<W>(v, out + base / kPer32);
  } else if (base < n_fetch) {  // the last thread of a short prefix
    uint32_t tmp[kPer / kPer32];
    pack_lanes<W>(v, tmp);
    for (int w = 0; w < kPer / kPer32; ++w) {
      if (base + w * kPer32 < n_fetch) out[base / kPer32 + w] = tmp[w];
    }
  }
  uint32_t unused;
  uint64_t rank = (uint64_t)s.p_over[t] + block_excl_scan(c, &unused);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (v[k] >= kOverMin) {
      if (rank < (uint64_t)n_over_buf) {
        over_id[rank] = (uint32_t)(base + k);
        over_val[rank] = (uint32_t)v[k];
      }
      ++rank;
    }
  }
  const int64_t n_over = counters[0];
  const int64_t from = n_over < n_over_buf ? n_over : n_over_buf;
  fill_grid(over_id, from, n_over_buf, (uint32_t)n_fetch);
  fill_grid(over_val, from, n_over_buf, 0u);
}

// 3b. Delta form: a block a tile of 32 blocks of the prefix.
template <int W>
__global__ void pack_delta(const int32_t* __restrict__ acc,
                           const int32_t* __restrict__ touch,
                           int64_t n_fetch, int64_t nb_prefix,
                           int64_t n_over_buf, int64_t n_blk_buf, Scratch s,
                           uint32_t* __restrict__ out) {
  constexpr int kPer32 = 32 / W;
  constexpr int32_t kOverMin = (int32_t)((1u << W) - 1u);
  const int64_t lanes = n_blk_buf * kBlk / kPer32;
  uint32_t* blk_ids = out + lanes;
  uint32_t* over_id = blk_ids + n_blk_buf;
  uint32_t* over_val = over_id + n_over_buf;
  const uint32_t* counters = over_val + n_over_buf;
  __shared__ bool flag[kBlocksPerTile];
  const int64_t t = blockIdx.x;
  const int lb = threadIdx.x / kLanesPerBlk;
  const int j = threadIdx.x % kLanesPerBlk;
  const int64_t b = t * kBlocksPerTile + lb;
  const bool touched = b < nb_prefix && __ldg(&touch[b]) > 0;
  if (j == 0) flag[lb] = touched;
  __syncthreads();
  int rank_in_tile = 0;
  for (int q = 0; q < lb; ++q) rank_in_tile += flag[q] ? 1 : 0;
  const uint64_t r = (uint64_t)s.p_touched[t] + rank_in_tile;
  const bool fetched = touched && r < (uint64_t)n_blk_buf;
  const int64_t base = b * kBlk + j * kPer;
  int32_t v[kPer];
  uint32_t c = 0u;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    v[k] = fetched ? __ldg(&acc[base + k]) : 0;
    c += v[k] >= kOverMin ? 1u : 0u;
  }
  if (fetched) {
    pack_lanes<W>(v, out + ((int64_t)r * kBlk + j * kPer) / kPer32);
    if (j == 0) blk_ids[r] = (uint32_t)b;
  }
  uint32_t unused;
  uint64_t rank = (uint64_t)s.p_over[t] + block_excl_scan(c, &unused);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (v[k] >= kOverMin) {
      if (rank < (uint64_t)n_over_buf) {
        over_id[rank] = (uint32_t)(base + k);
        over_val[rank] = (uint32_t)v[k];
      }
      ++rank;
    }
  }
  const int64_t n_touched = counters[0], n_over = counters[1];
  const int64_t f = n_touched < n_blk_buf ? n_touched : n_blk_buf;
  fill_grid(out, f * kBlk / kPer32, lanes, 0u);
  fill_grid(blk_ids, f, n_blk_buf, (uint32_t)nb_prefix);
  const int64_t from = n_over < n_over_buf ? n_over : n_over_buf;
  fill_grid(over_id, from, n_over_buf, (uint32_t)n_fetch);
  fill_grid(over_val, from, n_over_buf, 0u);
}

template <int W>
int launch(const int32_t* acc, const int32_t* touch, int64_t id_cap,
           int64_t n_fetch, int64_t n_over_buf, int64_t n_blk_buf,
           void* scratch, uint32_t* out, cudaStream_t stream) {
  const Scratch s = carve(scratch, id_cap);
  const int64_t n_tiles = n_tiles_of(id_cap);
  tile_sums<W><<<(unsigned)n_tiles, kThreads, 0, stream>>>(
      acc, id_cap, n_fetch, touch, n_fetch / kBlk, s);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if (touch == nullptr) {
    uint32_t* counters = out + n_fetch / (32 / W) + 2 * n_over_buf;
    tile_scan<<<1, kScanThreads, 0, stream>>>(n_tiles, nullptr, 0, 0, s,
                                              counters);
    err = (int)cudaGetLastError();
    if (err) return err;
    const int64_t grid = (n_fetch + kTile - 1) / kTile;
    pack_full<W><<<(unsigned)grid, kThreads, 0, stream>>>(
        acc, n_fetch, n_over_buf, s, out);
    return (int)cudaGetLastError();
  }
  const int64_t nb_prefix = n_fetch / kBlk;
  uint32_t* counters = out + n_blk_buf * kBlk / (32 / W) + n_blk_buf
      + 2 * n_over_buf;
  tile_scan<<<1, kScanThreads, 0, stream>>>(n_tiles, touch, nb_prefix,
                                            n_blk_buf, s, counters);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int64_t grid = (nb_prefix + kBlocksPerTile - 1) / kBlocksPerTile;
  pack_delta<W><<<(unsigned)(grid > 0 ? grid : 1), kThreads, 0, stream>>>(
      acc, touch, n_fetch, nb_prefix, n_over_buf, n_blk_buf, s, out);
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

// u32 words of scratch the close launches need at this id_cap.
int64_t pa_close_scratch_words(int64_t id_cap) {
  return 6 * n_tiles_of(id_cap) + n_blocks_of(id_cap);
}

// Each entry point returns cudaGetLastError() right after its launches
// (0 = launched); the Python wrapper raises on anything else. The wrapper
// checks the shapes: 0 < n_fetch <= id_cap, n_fetch % (32 / width) == 0,
// and in the delta form n_fetch % 128 == 0 and touch of id_cap / 128.

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
