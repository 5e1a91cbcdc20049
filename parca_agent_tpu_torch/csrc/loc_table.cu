// Location dedup of the one-shot window: hash-table build plus probe.
// CUDA C++ for sm_90a, plain C interface (loaded with ctypes by
// ops/kernels.py).
//
// Replaces parca_agent_tpu/aggregator/pallas_probe.py:
// make_loc_table_builder (the Pallas kernel at :134-225), and the probe
// base that parca_agent_tpu/aggregator/tpu.py:_window_kernel hashes for it
// (family 3 of [pid, hi, lo]).
//
// What it computes: every live lane i (kpid[i] != U32_MAX) carries a
// 96-bit key (kpid, khi, klo). Its probe base is base[i], or, when no base
// is given, family 3 of the key: fmix32(c0 * pid + c1 * hi + c2 * lo +
// bias) in u32 arithmetic (ops/hashing.py:multilinear_hash_u32). Walking
// linearly from base & (cap - 1), the lane finds the slot of the
// open-addressing table that holds its key, or claims the first empty
// slot for it. slot[i] is that slot, or -1 for a dead lane and for a lane
// that visited all cap slots without placing (the table cannot hold every
// key: the caller retries with a doubled capacity). The lane that claims
// a slot appends (pid, hi, lo, slot) to a dense list of l_cap entries;
// *n_entries counts every claim, also those past l_cap, whose entries are
// dropped. Entries past the count read (U32_MAX, 0, 0, cap): cap is a
// dump index one past the table. table[eslot[e]] holds key e, so the list
// is the Pallas kernel's table with its empty slots left out.
//
// The Pallas kernel settles claim conflicts by min-lane arbitration, in
// lockstep iterations. This kernel computes the same function with
// another schedule: a slot is claimed by compare-and-swap, so WHICH slot
// a key lands in, and the order of the dense list, depend on the race.
// The caller sorts the list by key (aggregator/tpu.py:_hash_dedup) and
// every listed key is distinct, so its outputs depend only on what this
// kernel keeps: one slot per distinct key, each lane pointing at its key's
// slot, and a live -1 exactly when the table is too small. Uniqueness
// holds because a slot only ever goes from empty to holding a key, and
// every lane with one key starts at one base and walks one chain: it stops
// at the first slot that holds its key or is empty, and an empty slot is
// claimed by exactly one lane.
//
// What bounds it on an H100: memory. Each live lane reads its 12 B key
// and writes a 4 B slot, a dead lane reads its 4 B pid and writes -1, and
// each dense entry is 16 B written; the table is scratch. At the bench's
// window (2^25 lanes, 26.9M live, 26.5M keys, 2^26 slots) that is ~0.96
// GB, ~0.29 ms at 3.35 TB/s. The probes are random 16-byte accesses to a
// 1.07 GB table, far past the 50 MB L2, so their sector traffic and
// latency, not the listed bytes, set the pace.
//
// Design: one thread per lane, and one 16-byte record {pid, hi, lo, 0} a
// slot (EMPTY is {U32_MAX, 0, 0, 0}; a live pid is never U32_MAX, so a
// claimed record never equals EMPTY). Each probe step is ONE 128-bit
// compare-and-swap CAS(record, EMPTY, key) (atom.global.cas.b128, sm_90):
// the record it returns was EMPTY (the lane claimed the slot), holds the
// lane's key (found), or holds another key (advance). The CAS returns the
// record atomically, so no lane can see a half-written key, and there is
// no plain load of the table, no state word, no fence and no wait. (A
// 16-byte vector load before the CAS would not do: the memory model does
// not make it single-copy atomic, and a torn read could match a key or
// skip one.) Claims append to the dense list through a warp-aggregated
// atomicAdd on one counter: the claiming lanes of a warp take consecutive
// entries, so the list's four arrays are written in runs. Two more
// launches frame the build: one fills the table with EMPTY and zeroes the
// counter, one writes the padding past the count.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kDead = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// CAS(*addr, cmp, val) on 16 bytes; returns the record as it was.
__device__ __forceinline__ uint4 cas128(uint4* addr, uint4 cmp, uint4 val) {
#if __CUDACC_VER_MAJOR__ > 12 || \
    (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 9)
  // The toolkit's 16-byte overload (crt/sm_90_rt.h), which emits
  // atom.cas.b128.
  return atomicCAS(addr, cmp, val);
#else
  const unsigned long long clo = ((unsigned long long)cmp.y << 32) | cmp.x;
  const unsigned long long chi = ((unsigned long long)cmp.w << 32) | cmp.z;
  const unsigned long long vlo = ((unsigned long long)val.y << 32) | val.x;
  const unsigned long long vhi = ((unsigned long long)val.w << 32) | val.z;
  unsigned long long olo, ohi;
  asm volatile(
      "{\n\t.reg .b128 c, v, o;\n\t"
      "mov.b128 c, {%2, %3};\n\t"
      "mov.b128 v, {%4, %5};\n\t"
      "atom.global.cas.b128 o, [%6], c, v;\n\t"
      "mov.b128 {%0, %1}, o;\n\t}"
      : "=l"(olo), "=l"(ohi)
      : "l"(clo), "l"(chi), "l"(vlo), "l"(vhi), "l"(addr)
      : "memory");
  return make_uint4((uint32_t)olo, (uint32_t)(olo >> 32), (uint32_t)ohi,
                    (uint32_t)(ohi >> 32));
#endif
}

__global__ void init_kernel(uint4* __restrict__ table, int64_t cap,
                            uint32_t* __restrict__ counter) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) *counter = 0u;
  if (i < cap) table[i] = make_uint4(kDead, 0u, 0u, 0u);
}

__global__ void build_kernel(const uint32_t* __restrict__ kpid,
                             const uint32_t* __restrict__ khi,
                             const uint32_t* __restrict__ klo,
                             const uint32_t* __restrict__ base, uint32_t c0,
                             uint32_t c1, uint32_t c2, uint32_t bias,
                             int64_t n, uint32_t mask, uint4* table,
                             int32_t* __restrict__ slot,
                             uint32_t* __restrict__ counter, int64_t l_cap,
                             uint32_t* __restrict__ epid,
                             uint32_t* __restrict__ ehi,
                             uint32_t* __restrict__ elo,
                             int32_t* __restrict__ eslot) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t p = kpid[i];
  if (p == kDead) {
    slot[i] = -1;
    return;
  }
  const uint32_t h = khi[i], l = klo[i];
  const uint32_t b =
      base != nullptr ? base[i] : fmix32(c0 * p + c1 * h + c2 * l + bias);
  const uint4 empty = make_uint4(kDead, 0u, 0u, 0u);
  const uint4 key = make_uint4(p, h, l, 0u);
  uint32_t pos = b & mask;
  for (uint64_t visited = 0; visited <= (uint64_t)mask; ++visited) {
    const uint4 old = cas128(&table[pos], empty, key);
    if (old.x == kDead) {
      // Claimed (a record with pid U32_MAX is EMPTY). The lanes that claim
      // together take consecutive entries from one add by their leader.
      const unsigned active = __activemask();
      const int lane = threadIdx.x % 32;
      const int leader = __ffs(active) - 1;
      uint32_t first = 0u;
      if (lane == leader) first = atomicAdd(counter, __popc(active));
      first = __shfl_sync(active, first, leader);
      const uint32_t e = first + __popc(active & ((1u << lane) - 1u));
      if (e < (uint64_t)l_cap) {
        epid[e] = p;
        ehi[e] = h;
        elo[e] = l;
        eslot[e] = (int32_t)pos;
      }
      slot[i] = (int32_t)pos;
      return;
    }
    if (old.x == p && old.y == h && old.z == l) {
      slot[i] = (int32_t)pos;
      return;
    }
    pos = (pos + 1) & mask;
  }
  slot[i] = -1;  // every slot holds another key
}

__global__ void pad_kernel(const uint32_t* __restrict__ counter,
                           int64_t l_cap, int32_t dump,
                           uint32_t* __restrict__ epid,
                           uint32_t* __restrict__ ehi,
                           uint32_t* __restrict__ elo,
                           int32_t* __restrict__ eslot) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= l_cap || e < (int64_t)*counter) return;
  epid[e] = kDead;
  ehi[e] = 0u;
  elo[e] = 0u;
  eslot[e] = dump;
}

inline unsigned grid_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// cap is a power of two <= 2^31; table is 16-byte aligned u32 [cap, 4]
// scratch and counter one u32, both overwritten here. base may be null:
// the kernel then hashes the base from the key with (c0, c1, c2, bias).
// Three launches on `stream`: fill, build, pad. Returns cudaGetLastError()
// right after them (0 = launched).
int pa_loc_table(const void* kpid, const void* khi, const void* klo,
                 const void* base, uint32_t c0, uint32_t c1, uint32_t c2,
                 uint32_t bias, int64_t n, int64_t cap, void* table,
                 void* counter, void* slot, int64_t l_cap, void* epid,
                 void* ehi, void* elo, void* eslot, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  init_kernel<<<grid_for(cap), kThreads, 0, s>>>((uint4*)table, cap,
                                                 (uint32_t*)counter);
  if (n > 0) {
    build_kernel<<<grid_for(n), kThreads, 0, s>>>(
        (const uint32_t*)kpid, (const uint32_t*)khi, (const uint32_t*)klo,
        (const uint32_t*)base, c0, c1, c2, bias, n, (uint32_t)(cap - 1),
        (uint4*)table, (int32_t*)slot, (uint32_t*)counter, l_cap,
        (uint32_t*)epid, (uint32_t*)ehi, (uint32_t*)elo, (int32_t*)eslot);
  }
  if (l_cap > 0) {
    pad_kernel<<<grid_for(l_cap), kThreads, 0, s>>>(
        (const uint32_t*)counter, l_cap, (int32_t)cap, (uint32_t*)epid,
        (uint32_t*)ehi, (uint32_t*)elo, (int32_t*)eslot);
  }
  return (int)cudaGetLastError();
}

const char* pa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
