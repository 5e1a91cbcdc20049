// The one-shot window's row hash: hash families 0 and 1 of every padded
// stack row. CUDA C++ for sm_90a, plain C interface (loaded with ctypes by
// ops/kernels.py).
//
// Replaces step 1 of parca_agent_tpu/aggregator/tpu.py:_window_kernel
// (:109-113): fold_u64_rows over [hi x S | lo x S | pid | ulen | klen]
// and multilinear_hash_u32 with families 0 and 1. That step is jit code,
// not Pallas; it is a kernel here because its plain PyTorch version has
// to build the [n, 2S+3] lane matrix (2.2 GB as int64 at 2^20 rows, most
// of it zero padding) and torch has no u32 multiply-reduce to fuse it.
//
// What it computes, per row r (u32 arithmetic, wrapping):
//   acc_f = sum_j coef_f[j] * hi[r][j] + coef_f[S + j] * lo[r][j]
//           + coef_f[2S] * pid[r] + coef_f[2S+1] * ulen[r]
//           + coef_f[2S+2] * klen[r]
//   h_f[r] = fmix32(acc_f + bias_f)           for f in {0, 1}
// The sum runs over j < depth = ulen + klen (clamped to [0, S]) only: a
// zero lane adds nothing to a multilinear hash, so this equals the
// full-width hash for every row that is zero past its depth, which is the
// WindowSnapshot padding contract (the JAX package's native pa_row_hash
// relies on the same argument, parca_agent_tpu/ops/hashing.py:100-145).
//
// What bounds it on an H100: memory. It must read each row's live
// frames (8 B a frame) and 12 B of header, and write 8 B of hashes; the
// arithmetic is four 32-bit multiply-adds a frame. At the bench's window
// (2^20 rows, ~27M live frames, mean depth ~26) that is ~0.24 GB,
// ~0.07 ms at 3.35 TB/s.
//
// Design: a group of 8 lanes a row, 4 rows a warp, so that every warp
// keeps 4 rows' loads in flight at once. Lane l of a group reads frames
// [4l, 4l + 4) + 32k of its row's hi and of its lo half, one 16-byte load
// each through the read-only path: a step of the group covers one
// 128-byte line of each half. Each lane loads the header (pid, ulen,
// klen) of its row first, then only the 4-frame runs that hold a live
// frame, and masks its terms at j >= depth: a row fetches the 32-byte
// sectors of its live frames and no padding. (Loading frames 0-31 with
// the header, before the depth is known, saves that round trip but reads
// a whole line of each half for every row: 13% more bytes, and it was
// 6% slower on the H100 at the bench window, PERF.md.) Each group folds
// its 8 partial sums in 3 xor shuffles. The coefficient table
// (2 x (2S + 3) u32, ~2 KB at S = 128) is staged once a block in shared
// memory, and a persistent grid (the SMs times the blocks each holds at
// once) walks the rows in quads, so each block stages it once.
//
// Needs S % 4 == 0 and 16-byte-aligned hi/lo rows (ops/row_hash.py checks).

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kGroup = 8;                    // lanes a row
constexpr int kRowsPerWarp = kWarp / kGroup;  // 4
constexpr int kStep = kGroup * 4;            // frames a group step: 32

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Family f's coefficients start at f * stride words in shared memory;
// stride is 2S + 3 rounded up to 4, so every 4-frame run is 16-byte
// aligned in both families.
__host__ __device__ __forceinline__ int coef_stride(int slots) {
  return (2 * slots + 3 + 3) & ~3;
}

// Adds the terms of frames j0 .. j0 + 3 that lie below the depth
// (`live` of them, clamped to 0 .. 4) to both families' sums.
__device__ __forceinline__ void add_frames(uint4 x, uint4 y,
                                           const uint32_t* c, int stride,
                                           int slots, int j0, int live,
                                           uint32_t& a0, uint32_t& a1) {
  const uint4 c0h = *reinterpret_cast<const uint4*>(c + j0);
  const uint4 c0l = *reinterpret_cast<const uint4*>(c + slots + j0);
  const uint4 c1h = *reinterpret_cast<const uint4*>(c + stride + j0);
  const uint4 c1l = *reinterpret_cast<const uint4*>(c + stride + slots + j0);
  const uint32_t m0 = live > 0 ? ~0u : 0u, m1 = live > 1 ? ~0u : 0u,
                 m2 = live > 2 ? ~0u : 0u, m3 = live > 3 ? ~0u : 0u;
  x.x &= m0; x.y &= m1; x.z &= m2; x.w &= m3;
  y.x &= m0; y.y &= m1; y.z &= m2; y.w &= m3;
  a0 += x.x * c0h.x + x.y * c0h.y + x.z * c0h.z + x.w * c0h.w
      + y.x * c0l.x + y.y * c0l.y + y.z * c0l.z + y.w * c0l.w;
  a1 += x.x * c1h.x + x.y * c1h.y + x.z * c1h.z + x.w * c1h.w
      + y.x * c1l.x + y.y * c1l.y + y.z * c1l.z + y.w * c1l.w;
}

__global__ void __launch_bounds__(kThreads) row_hash_kernel(
    const uint32_t* __restrict__ shi, const uint32_t* __restrict__ slo,
    const uint32_t* __restrict__ pid, const int32_t* __restrict__ ulen,
    const int32_t* __restrict__ klen, int64_t n, int slots,
    const uint32_t* __restrict__ coefs, uint32_t bias0, uint32_t bias1,
    uint32_t* __restrict__ h1, uint32_t* __restrict__ h2) {
  extern __shared__ uint4 smem[];
  uint32_t* c = reinterpret_cast<uint32_t*>(smem);
  const int ncoef = 2 * slots + 3, stride = coef_stride(slots);
  for (int i = threadIdx.x; i < 2 * ncoef; i += blockDim.x) {
    const int f = i >= ncoef;
    c[f * stride + i - f * ncoef] = __ldg(&coefs[i]);
  }
  __syncthreads();

  const int lane = threadIdx.x % kWarp;
  const int sub = lane % kGroup;  // lane within the row's group
  const int64_t warps = (int64_t)gridDim.x * (kThreads / kWarp);
  for (int64_t quad = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / kWarp;
       quad * kRowsPerWarp < n; quad += warps) {
    const int64_t row = quad * kRowsPerWarp + lane / kGroup;
    const bool live = row < n;
    uint32_t p = 0u;
    int32_t u = 0, k = 0;
    if (live) {
      p = __ldg(&pid[row]);
      u = __ldg(&ulen[row]);
      k = __ldg(&klen[row]);
    }
    int depth = u + k;
    depth = depth < 0 ? 0 : (depth > slots ? slots : depth);
    const uint32_t* hi = shi + row * slots;
    const uint32_t* lo = slo + row * slots;
    uint32_t a0 = 0u, a1 = 0u;
    // Steps of 32 frames; a lane loads only when its 4 hold a live one.
    for (int j = 4 * sub; j - 4 * sub < depth; j += kStep) {
      if (j < depth) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(hi + j));
        const uint4 y = __ldg(reinterpret_cast<const uint4*>(lo + j));
        add_frames(x, y, c, stride, slots, j, depth - j, a0, a1);
      }
    }
#pragma unroll
    for (int off = kGroup / 2; off > 0; off /= 2) {
      a0 += __shfl_xor_sync(0xFFFFFFFFu, a0, off);
      a1 += __shfl_xor_sync(0xFFFFFFFFu, a1, off);
    }
    if (live && sub == 0) {
      const int s2 = 2 * slots;
      a0 += p * c[s2] + (uint32_t)u * c[s2 + 1] + (uint32_t)k * c[s2 + 2];
      a1 += p * c[stride + s2] + (uint32_t)u * c[stride + s2 + 1] +
            (uint32_t)k * c[stride + s2 + 2];
      h1[row] = fmix32(a0 + bias0);
      h2[row] = fmix32(a1 + bias1);
    }
  }
}

// The persistent grid's size for (device, slots): SMs x resident blocks,
// asked of the runtime once and kept.
std::mutex grid_lock;
int grid_device = -1, grid_slots = -1, grid_blocks = 0;

int resident_blocks(int slots, size_t smem, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> hold(grid_lock);
  if (dev != grid_device || slots != grid_slots) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, row_hash_kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    grid_device = dev;
    grid_slots = slots;
    grid_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  *blocks = grid_blocks;
  return 0;
}

}  // namespace

extern "C" {

// coefs is u32 [2, 2 * slots + 3] (families 0 and 1, contiguous).
// Returns cudaGetLastError() right after the launch (0 = launched), or
// the error of the occupancy query that sizes the grid.
int pa_row_hash(const void* shi, const void* slo, const void* pid,
                const void* ulen, const void* klen, int64_t n, int64_t slots,
                const void* coefs, uint32_t bias0, uint32_t bias1, void* h1,
                void* h2, void* stream) {
  if (n > 0) {
    const size_t smem = 2 * sizeof(uint32_t) * coef_stride((int)slots);
    int blocks = 0;
    const int err = resident_blocks((int)slots, smem, &blocks);
    if (err != 0) return err;
    const int64_t rows_per_block = kThreads / kWarp * kRowsPerWarp;
    const int64_t need = (n + rows_per_block - 1) / rows_per_block;
    const unsigned grid = (unsigned)(need < blocks ? need : blocks);
    row_hash_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)shi, (const uint32_t*)slo, (const uint32_t*)pid,
        (const int32_t*)ulen, (const int32_t*)klen, n, (int)slots,
        (const uint32_t*)coefs, bias0, bias1, (uint32_t*)h1, (uint32_t*)h2);
  }
  return (int)cudaGetLastError();
}

const char* pa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
