// Location dedup of the one-shot window: hash-table build plus probe.
// CUDA C++ for sm_90a, plain C interface (loaded with ctypes by
// ops/kernels.py).
//
// Replaces parca_agent_tpu/aggregator/pallas_probe.py:
// make_loc_table_builder (the Pallas kernel at :134-225).
//
// What it computes: every live lane i (kpid[i] != U32_MAX) carries a
// 96-bit key (kpid, khi, klo) and a probe base. Walking linearly from
// base & (cap - 1), it finds the slot of the open-addressing table that
// holds its key, or claims the first empty slot for it. slot[i] is that
// slot, or -1 for a dead lane and for a lane that visited all cap slots
// without placing (the table cannot hold every key: the caller retries
// with a doubled capacity). The table (tpid, thi, tlo) comes back with
// U32_MAX, 0, 0 in every empty slot.
//
// The Pallas kernel settles claim conflicts by min-lane arbitration, in
// lockstep iterations. This kernel computes the same function with
// another schedule: a slot is claimed by compare-and-swap, so WHICH slot
// a key lands in depends on the race. The caller re-sorts the table by
// key (parca_agent_tpu/aggregator/tpu.py:206-228), so its outputs depend
// only on what this kernel keeps: one slot per distinct key, each lane
// pointing at its key's slot, and a live -1 exactly when the table is
// too small. Uniqueness holds because a slot only ever goes from empty
// to holding a key, and every lane with one key starts at one base and
// walks one chain: it stops at the first slot that holds its key or is
// empty, and an empty slot is claimed by exactly one lane.
//
// What bounds it on an H100: memory. Each lane reads 16 B (key and base)
// and writes a 4 B slot; the table's three 4 B words per slot are
// written once. A probe step is a handful of integer ops. At the bench's
// window (2^25 lanes, 2^26 slots) that is ~1.5 GB, ~0.44 ms at
// 3.35 TB/s. The probe reads are random and dependent, so latency, not
// bandwidth, sets the pace; one thread per lane keeps ~2^25 chains in
// flight to hide it.
//
// Design: one thread per lane, and a scratch state word per slot
// (EMPTY, BUSY, READY). atomicCAS(state, EMPTY, BUSY) claims a slot; the
// winner writes the key, __threadfence(), then publishes READY. A lane
// that finds BUSY waits on that slot and does not advance (the winner
// may be writing its own key), which relies on the independent thread
// scheduling of Volta and later: a claimant in the same warp still makes
// progress. A lane that sees READY fences, then reads the key through
// volatile loads. The table is never read through the read-only path
// (no const __restrict__, no __ldg) in this kernel that writes it, which
// could serve stale lines.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kEmpty = 0;
constexpr int32_t kBusy = 1;
constexpr int32_t kReady = 2;
constexpr uint32_t kDead = 0xFFFFFFFFu;

__global__ void loc_table_kernel(const uint32_t* __restrict__ kpid,
                                 const uint32_t* __restrict__ khi,
                                 const uint32_t* __restrict__ klo,
                                 const uint32_t* __restrict__ base,
                                 int64_t n, uint32_t mask,
                                 int32_t* __restrict__ slot, uint32_t* tpid,
                                 uint32_t* thi, uint32_t* tlo,
                                 int32_t* state) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t p = kpid[i];
  if (p == kDead) {
    slot[i] = -1;
    return;
  }
  const uint32_t h = khi[i], l = klo[i];
  volatile int32_t* vstate = state;
  volatile uint32_t* vpid = tpid;
  volatile uint32_t* vhi = thi;
  volatile uint32_t* vlo = tlo;
  uint32_t pos = base[i] & mask;
  uint64_t visited = 0;
  while (visited <= (uint64_t)mask) {
    int32_t s = vstate[pos];
    if (s == kEmpty) {
      s = atomicCAS(&state[pos], kEmpty, kBusy);
      if (s == kEmpty) {
        tpid[pos] = p;
        thi[pos] = h;
        tlo[pos] = l;
        __threadfence();
        atomicExch(&state[pos], kReady);
        slot[i] = (int32_t)pos;
        return;
      }
    }
    if (s == kBusy) {
      __nanosleep(32);
      continue;  // re-read this slot: its claimant may hold our key
    }
    __threadfence();
    if (vpid[pos] == p && vhi[pos] == h && vlo[pos] == l) {
      slot[i] = (int32_t)pos;
      return;
    }
    pos = (pos + 1) & mask;
    ++visited;
  }
  slot[i] = -1;  // every slot holds another key
}

}  // namespace

extern "C" {

// cap is a power of two <= 2^31. The caller fills tpid with U32_MAX and
// thi, tlo and state with 0 before the launch. Returns cudaGetLastError()
// right after the launch (0 = launched).
int pa_loc_table(const void* kpid, const void* khi, const void* klo,
                 const void* base, int64_t n, int64_t cap, void* slot,
                 void* tpid, void* thi, void* tlo, void* state,
                 void* stream) {
  if (n > 0) {
    loc_table_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                       0, (cudaStream_t)stream>>>(
        (const uint32_t*)kpid, (const uint32_t*)khi, (const uint32_t*)klo,
        (const uint32_t*)base, n, (uint32_t)(cap - 1), (int32_t*)slot,
        (uint32_t*)tpid, (uint32_t*)thi, (uint32_t*)tlo, (int32_t*)state);
  }
  return (int)cudaGetLastError();
}

const char* pa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
