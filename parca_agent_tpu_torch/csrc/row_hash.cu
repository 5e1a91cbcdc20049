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
// The sum runs over j < depth = ulen + klen only: a zero lane adds
// nothing to a multilinear hash, so this equals the full-width hash for
// every row that is zero past its depth, which is the WindowSnapshot
// padding contract (the JAX package's native pa_row_hash relies on the
// same argument, parca_agent_tpu/ops/hashing.py:100-145).
//
// What bounds it on an H100: memory. It must read each row's live
// frames (8 B a frame) and 12 B of header, and write 8 B of hashes; the
// arithmetic is four 32-bit multiply-adds a frame. At the bench's window
// (2^20 rows, ~27M live frames) that is ~0.23 GB, ~0.07 ms at 3.35 TB/s.
//
// Design: one warp per row. Lane t reads frames t, t + 32, ... of the
// row's hi and lo halves, so each warp load is one contiguous 128-byte
// line, and reads stop at the row's depth, so the zero padding past it is
// never fetched. Both families are accumulated in the same pass; a
// shuffle reduction folds the 32 partial sums and lane 0 adds the header
// lanes and the bias, mixes, and writes. The 2 x (2S+3) coefficients are
// read through the read-only cache, where they stay resident.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 rows a block
constexpr int kWarp = 32;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__global__ void row_hash_kernel(const uint32_t* __restrict__ shi,
                                const uint32_t* __restrict__ slo,
                                const uint32_t* __restrict__ pid,
                                const int32_t* __restrict__ ulen,
                                const int32_t* __restrict__ klen,
                                int64_t n, int slots,
                                const uint32_t* __restrict__ coef0,
                                const uint32_t* __restrict__ coef1,
                                uint32_t bias0, uint32_t bias1,
                                uint32_t* __restrict__ h1,
                                uint32_t* __restrict__ h2) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) /
                      kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n) return;  // the whole warp shares the row
  const int32_t u = ulen[row], k = klen[row];
  int depth = u + k;
  depth = depth < 0 ? 0 : (depth > slots ? slots : depth);
  const uint32_t* hi = shi + row * slots;
  const uint32_t* lo = slo + row * slots;
  uint32_t a0 = 0u, a1 = 0u;
  for (int j = lane; j < depth; j += kWarp) {
    const uint32_t x = hi[j], y = lo[j];
    a0 += x * __ldg(&coef0[j]) + y * __ldg(&coef0[slots + j]);
    a1 += x * __ldg(&coef1[j]) + y * __ldg(&coef1[slots + j]);
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    a0 += __shfl_xor_sync(0xFFFFFFFFu, a0, off);
    a1 += __shfl_xor_sync(0xFFFFFFFFu, a1, off);
  }
  if (lane != 0) return;
  const uint32_t p = pid[row];
  const int s2 = 2 * slots;
  a0 += p * coef0[s2] + (uint32_t)u * coef0[s2 + 1] +
        (uint32_t)k * coef0[s2 + 2];
  a1 += p * coef1[s2] + (uint32_t)u * coef1[s2 + 1] +
        (uint32_t)k * coef1[s2 + 2];
  h1[row] = fmix32(a0 + bias0);
  h2[row] = fmix32(a1 + bias1);
}

}  // namespace

extern "C" {

// coefs is u32 [2, 2 * slots + 3] (families 0 and 1, contiguous).
// Returns cudaGetLastError() right after the launch (0 = launched).
int pa_row_hash(const void* shi, const void* slo, const void* pid,
                const void* ulen, const void* klen, int64_t n, int64_t slots,
                const void* coefs, uint32_t bias0, uint32_t bias1, void* h1,
                void* h2, void* stream) {
  if (n > 0) {
    const int64_t rows_per_block = kThreads / kWarp;
    const unsigned grid = (unsigned)((n + rows_per_block - 1) /
                                     rows_per_block);
    const uint32_t* c = (const uint32_t*)coefs;
    row_hash_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)shi, (const uint32_t*)slo, (const uint32_t*)pid,
        (const int32_t*)ulen, (const int32_t*)klen, n, (int)slots, c,
        c + (2 * slots + 3), bias0, bias1, (uint32_t*)h1, (uint32_t*)h2);
  }
  return (int)cudaGetLastError();
}

const char* pa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
