// The sketch build (B6): a count-min table, HyperLogLog registers and each
// node's total of one (hash, count) stream of n_nodes x R rows, in one
// launch. CUDA C++ for sm_90a, plain C interface (loaded with ctypes by
// ops/kernels.py).
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
// register once; it does depth atomic adds a row into the table (4 MB at
// the default 4 x 2^18, resident in the 50 MB L2) and one max a live row.
//
// Design: a grid of (blocks a node, n_nodes); a block strides over its
// node's rows, so its total is one block reduction and one atomic add.
// Zero counts skip the table's atomics (padding costs no atomic). The
// HLL registers are the hot spot (8.9M rows into 4,096 registers at the
// default p = 12): with `shared_regs` a block keeps its own registers in
// shared memory (4 << p bytes, 16 KB at p = 12), takes its maxima there,
// and folds the nonzero ones into global memory once, at its end; past
// the wrapper's p (the registers no longer fit: 1 MB at p = 18) every
// live row takes a global atomic max. The count-min rows take global
// atomics: a table of 4 MB does not fit a block.
// The wrapper zeroes the outputs; the kernel allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

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

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0) {
      n = 132;
    }
  }
  return n;
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

const char* pa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
