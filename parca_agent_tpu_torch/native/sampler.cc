// perf_event whole-machine stack sampler behind a C ABI.
//
// The native capture component of the framework (the role the eBPF C
// program plays in the reference, bpf/cpu/cpu.bpf.c: per-CPU 100 Hz
// sampling with kernel+user call chains). Where the reference's BPF
// program aggregates in kernel maps, this sampler ships raw records and
// the (much faster, batched) aggregation happens in the Aggregator --
// capture stays dumb, aggregation stays pluggable.
//
// One perf_event_open(PERF_COUNT_SW_CPU_CLOCK, freq) per online CPU with
// PERF_SAMPLE_TID | PERF_SAMPLE_CALLCHAIN (the perf-subsystem equivalent
// of the reference's kernel + frame-pointer unwind paths). In DWARF mode
// (pa_sampler_create2 with PA_CAPTURE_USER_STACK) the kernel also
// snapshots user registers and a slice of the user stack per sample
// (PERF_SAMPLE_REGS_USER | PERF_SAMPLE_STACK_USER -- how `perf record
// --call-graph dwarf` captures; the role of the reference's in-kernel
// DWARF walker inputs, bpf/cpu/cpu.bpf.c:464-674), and the drain-time
// batched unwinder applies the .eh_frame tables to recover frameless user
// stacks (the port's Python side does not drive this mode yet: its
// sampler runs FP mode only).
//
// Each CPU gets a mmap'd ring; drain() walks every ring and packs records
// into the caller's buffer.
//
// v1 record (no user-stack capture):
//   u32 pid | u32 tid | u32 n_kernel | u32 n_user
//   | u64 frames[n_kernel + n_user]                      (kernel first)
//
// v2 record (PA_CAPTURE_USER_STACK mode):
//   u32 pid | u32 tid | u32 n_kernel | u32 n_user
//   | u64 rip | u64 rsp | u64 rbp                        (0 if unavailable)
//   | u32 dyn_size | u32 _pad
//   | u64 frames[n_kernel + n_user]
//   | u8  stack[align8(dyn_size)]                        (memory at rsp)
//
// Drain contract: returns bytes written. A record that does not fit in the
// caller's buffer is LEFT IN ITS RING (that ring's tail is committed only
// up to the records already copied) and the truncation counter increments;
// the caller drains again to fetch the remainder. Records are never
// discarded once their ring tail has been committed.
//
// A copy of parca_agent_tpu/native/sampler.cc; built at first use by
// parca_agent_tpu_torch/native/__init__.py (g++ -O2 -fPIC -shared).

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <cstdlib>

#include <atomic>

#include <fcntl.h>
#include <linux/perf_event.h>
#include <sys/ioctl.h>
#include <sys/mman.h>
#include <sys/syscall.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMaxFrames = 127;  // reference depth cap (cpu.bpf.c:22-27)
constexpr size_t kRingPagesFp = 64;      // 256 KiB of ring per CPU
constexpr size_t kRingPagesStack = 512;  // 2 MiB per CPU when dumping stacks

// PERF_CONTEXT_* sentinels that delimit kernel vs user frames in callchains.
constexpr uint64_t kContextKernel = 0xffffffffffffff80ull;  // PERF_CONTEXT_KERNEL
constexpr uint64_t kContextUser = 0xfffffffffffffe00ull;    // PERF_CONTEXT_USER
constexpr uint64_t kContextMax = 0xfffffffffffff000ull;     // any marker >= this

// x86_64 perf_regs indices (arch/x86/include/uapi/asm/perf_regs.h).
constexpr int kRegBp = 6;
constexpr int kRegSp = 7;
constexpr int kRegIp = 8;
constexpr uint64_t kRegsMask = (1ull << kRegBp) | (1ull << kRegSp) | (1ull << kRegIp);

struct PerCpu {
  int fd = -1;
  void* ring = nullptr;
  size_t ring_size = 0;
  uint64_t tail = 0;  // our consumer position (data_tail mirror)
};

struct Sampler {
  PerCpu* cpus = nullptr;
  int n_cpus = 0;
  int freq = 0;
  bool capture_stack = false;
  uint32_t dump_bytes = 0;
  std::atomic<bool> running{false};
  uint64_t lost = 0;       // PERF_RECORD_LOST accounting
  uint64_t truncated = 0;  // drain calls that ran out of caller buffer
  uint8_t* scratch = nullptr;  // wrapped-record copy buffer
  size_t scratch_size = 0;
  // Dedup-drain hash table (lazily allocated; see pa_sampler_drain_dedup).
  uint64_t* dd_hash = nullptr;
  long* dd_off = nullptr;
  size_t dd_cap = 0;
  bool dd_dirty = false;    // previous dedup drain registered entries
  uint64_t dedup_hits = 0;  // records merged instead of re-emitted
  uint64_t dd_overflow = 0; // probe budget exhausted: emitted unregistered
  // Capture-side row-hash tables (pa_sampler_set_hash): Python owns the
  // seeded multilinear coefficients (ops/hashing.py _COEFS/_BIASES) and
  // installs contiguous copies here, so the hashes the dedup drain carries
  // are bit-identical to row_hash_np. n_fam == 0 means not installed and
  // pa_sampler_drain_dedup2 refuses (-3).
  uint32_t* hash_coefs = nullptr;  // [n_fam][stride]
  uint32_t hash_biases[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  long hash_stride = 0;
  long hash_slots = 0;
  int hash_nfam = 0;
};

// FNV-1a over the sample identity (pid, tid, nk, nu, frames).
uint64_t fnv1a(const uint8_t* p, size_t n, uint64_t h = 1469598103934665603ull) {
  for (size_t i = 0; i < n; i++) {
    h ^= p[i];
    h *= 1099511628211ull;
  }
  return h;
}

// fmix32 finalizer (murmur3-style) — the C twin of ops/hashing.py mix32.
inline uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Multilinear row hash over a split (kernel, user) frame pair — the
// drain-side twin of ops/hashing.py row_hash_np over the snapshot row the
// record decodes to. The snapshot row stores USER frames first then the
// kernel tail, zero-padded to `slots`; the lane matrix is
// [hi(slots) | lo(slots) | pid | user_len | kernel_len] with family
// coefficients c: zero pad lanes contribute c*0, so walking only the live
// depth is bit-identical to the full lane matrix (same argument the
// vecenc.cc pa_row_hash kernel rests on). Frames may not exceed `slots`
// (caller-guarded: kMaxFrames < STACK_SLOTS).
inline void stack_hash_mix(const uint64_t* kframes, uint32_t nk,
                           const uint64_t* uframes, uint32_t nu,
                           uint32_t pid, const uint32_t* coefs, long stride,
                           const uint32_t* biases, int n_fam, long slots,
                           uint32_t* out) {
  for (int f = 0; f < n_fam; f++) {
    const uint32_t* c = coefs + f * stride;
    uint32_t acc = 0;
    // User frames occupy row slots [0, nu); kernel tail [nu, nu + nk).
    for (uint32_t s = 0; s < nu; s++) {
      uint64_t fr = uframes[s];
      if (!fr) continue;
      acc += c[s] * static_cast<uint32_t>(fr >> 32)
           + c[slots + s] * static_cast<uint32_t>(fr);
    }
    for (uint32_t s = 0; s < nk; s++) {
      uint64_t fr = kframes[s];
      if (!fr) continue;
      acc += c[nu + s] * static_cast<uint32_t>(fr >> 32)
           + c[slots + nu + s] * static_cast<uint32_t>(fr);
    }
    acc += c[2 * slots] * pid + c[2 * slots + 1] * nu
         + c[2 * slots + 2] * nk;
    out[f] = fmix32(acc + biases[f]);
  }
}

long perf_open(int cpu, int freq, bool capture_stack, uint32_t dump_bytes) {
  perf_event_attr attr;
  std::memset(&attr, 0, sizeof(attr));
  attr.size = sizeof(attr);
  attr.type = PERF_TYPE_SOFTWARE;
  attr.config = PERF_COUNT_SW_CPU_CLOCK;
  attr.sample_freq = static_cast<uint64_t>(freq);
  attr.freq = 1;  // PerfBitFreq in the reference (cpu.go:236-243)
  attr.sample_type = PERF_SAMPLE_TID | PERF_SAMPLE_CALLCHAIN;
  if (capture_stack) {
    attr.sample_type |= PERF_SAMPLE_REGS_USER | PERF_SAMPLE_STACK_USER;
    attr.sample_regs_user = kRegsMask;
    attr.sample_stack_user = dump_bytes;
  }
  attr.disabled = 1;
  attr.inherit = 0;
  attr.exclude_hv = 1;
  attr.sample_max_stack = kMaxFrames;
  // pid = -1, cpu = N: whole-machine, per-CPU (needs perf_event_paranoid
  // <= 0 or CAP_PERFMON, like the reference needs CAP_BPF).
  return syscall(SYS_perf_event_open, &attr, -1, cpu, -1, PERF_FLAG_FD_CLOEXEC);
}

void destroy_partial(Sampler* s, int opened) {
  for (int j = 0; j < opened; j++) {
    munmap(s->cpus[j].ring, s->cpus[j].ring_size);
    close(s->cpus[j].fd);
  }
  delete[] s->cpus;
  delete[] s->scratch;
  delete[] s->dd_hash;
  delete[] s->dd_off;
  delete[] s->hash_coefs;
  delete s;
}


// Shared perf-ring record walk: wrap/scratch handling, LOST accounting,
// context-marker frame splitting, and the leave-in-ring tail-commit
// protocol live HERE, once, for every drain flavor. `emit` receives each
// parsed sample (payload/rec_end cover the bytes after the callchain for
// mode-specific parsing) and returns false when the caller's buffer is
// full — the record is then left in its ring for the next drain.
template <typename EmitFn>
void walk_rings(Sampler* s, EmitFn&& emit) {
  bool out_full = false;
  size_t page = static_cast<size_t>(sysconf(_SC_PAGESIZE));
  for (int i = 0; i < s->n_cpus && !out_full; i++) {
    PerCpu& pc = s->cpus[i];
    auto* meta = static_cast<perf_event_mmap_page*>(pc.ring);
    uint8_t* data = static_cast<uint8_t*>(pc.ring) + page;
    uint64_t data_size = pc.ring_size - page;
    uint64_t head = __atomic_load_n(&meta->data_head, __ATOMIC_ACQUIRE);
    uint64_t tail = meta->data_tail;
    while (tail < head) {
      auto* hdr = reinterpret_cast<perf_event_header*>(
          data + (tail % data_size));
      // Records can wrap the ring; copy out when they do.
      uint8_t* rec = reinterpret_cast<uint8_t*>(hdr);
      if ((tail % data_size) + hdr->size > data_size) {
        uint64_t first = data_size - (tail % data_size);
        if (hdr->size <= s->scratch_size) {
          std::memcpy(s->scratch, rec, first);
          std::memcpy(s->scratch + first, data, hdr->size - first);
          rec = s->scratch;
          hdr = reinterpret_cast<perf_event_header*>(rec);
        } else {  // oversized wrapped record: skip
          tail += hdr->size;
          continue;
        }
      }
      if (hdr->type == PERF_RECORD_LOST) {
        // { header; u64 id; u64 lost; }
        s->lost += *reinterpret_cast<uint64_t*>(rec + sizeof(*hdr) + 8);
      } else if (hdr->type == PERF_RECORD_SAMPLE) {
        // layout for our sample_type (in ABI order):
        //   u32 pid, tid; u64 nr; u64 ips[nr];
        //   [u64 regs_abi; u64 regs[3] if abi != NONE]
        //   [u64 stack_size; u8 stack[stack_size]; u64 dyn_size if size]
        uint8_t* p = rec + sizeof(*hdr);
        uint8_t* rec_end = rec + hdr->size;
        uint32_t pid, tid;
        std::memcpy(&pid, p, 4);
        std::memcpy(&tid, p + 4, 4);
        p += 8;
        uint64_t nr;
        std::memcpy(&nr, p, 8);
        p += 8;
        if (nr <= kMaxFrames + 8 && p + 8 * nr <= rec_end) {
          uint64_t kframes[kMaxFrames], uframes[kMaxFrames];
          uint32_t nk = 0, nu = 0;
          int mode = 0;  // 0 unknown, 1 kernel, 2 user
          for (uint64_t f = 0; f < nr; f++) {
            uint64_t ip;
            std::memcpy(&ip, p + 8 * f, 8);
            if (ip >= kContextMax) {
              if (ip == kContextKernel) mode = 1;
              else if (ip == kContextUser) mode = 2;
              else mode = 0;
              continue;
            }
            if (mode == 1 && nk < kMaxFrames) kframes[nk++] = ip;
            else if (mode == 2 && nu < kMaxFrames) uframes[nu++] = ip;
          }
          p += 8 * nr;
          if (!emit(pid, tid, kframes, nk, uframes, nu, p, rec_end)) {
            // Leave this record (and the rest of this ring) for the
            // next drain; commit only what we already consumed.
            s->truncated++;
            out_full = true;
            break;
          }
        }
      }
      tail += hdr->size;
    }
    __atomic_store_n(&meta->data_tail, tail, __ATOMIC_RELEASE);
    pc.tail = tail;
  }
}

}  // namespace

extern "C" {

// flags for pa_sampler_create2
enum { PA_CAPTURE_USER_STACK = 1 };

// Returns nullptr on failure; errno preserved from the first failing call.
// dump_bytes (user-stack slice per sample) must be a multiple of 8 and
// < 64 KiB per the perf ABI; 0 picks the 16 KiB default.
Sampler* pa_sampler_create2(int freq_hz, int flags, uint32_t dump_bytes) {
  long n = sysconf(_SC_NPROCESSORS_ONLN);
  if (n <= 0) return nullptr;
  bool capture_stack = (flags & PA_CAPTURE_USER_STACK) != 0;
  if (capture_stack) {
    if (dump_bytes == 0) dump_bytes = 16 * 1024;
    dump_bytes &= ~7u;
    if (dump_bytes > 63 * 1024) dump_bytes = 63 * 1024;
  } else {
    dump_bytes = 0;
  }
  Sampler* s = new Sampler();
  s->n_cpus = static_cast<int>(n);
  s->freq = freq_hz;
  s->capture_stack = capture_stack;
  s->dump_bytes = dump_bytes;
  s->cpus = new PerCpu[n];
  s->scratch_size = 128 * 1024;
  s->scratch = new uint8_t[s->scratch_size];
  size_t page = static_cast<size_t>(sysconf(_SC_PAGESIZE));
  size_t data_pages = capture_stack ? kRingPagesStack : kRingPagesFp;
  size_t ring_size = (data_pages + 1) * page;
  for (int i = 0; i < n; i++) {
    long fd = perf_open(i, freq_hz, capture_stack, dump_bytes);
    if (fd < 0) {
      int saved = errno;
      destroy_partial(s, i);
      errno = saved;
      return nullptr;
    }
    void* ring = mmap(nullptr, ring_size, PROT_READ | PROT_WRITE, MAP_SHARED,
                      static_cast<int>(fd), 0);
    if (ring == MAP_FAILED) {
      int saved = errno;
      close(static_cast<int>(fd));
      destroy_partial(s, i);
      errno = saved;
      return nullptr;
    }
    s->cpus[i].fd = static_cast<int>(fd);
    s->cpus[i].ring = ring;
    s->cpus[i].ring_size = ring_size;
  }
  return s;
}

Sampler* pa_sampler_create(int freq_hz) {
  return pa_sampler_create2(freq_hz, 0, 0);
}

int pa_sampler_n_cpus(Sampler* s) { return s ? s->n_cpus : 0; }
uint64_t pa_sampler_lost(Sampler* s) { return s ? s->lost : 0; }
uint64_t pa_sampler_truncated(Sampler* s) { return s ? s->truncated : 0; }
int pa_sampler_capture_stack(Sampler* s) {
  return s && s->capture_stack ? 1 : 0;
}

int pa_sampler_start(Sampler* s) {
  if (!s) return -1;
  for (int i = 0; i < s->n_cpus; i++) {
    if (ioctl(s->cpus[i].fd, PERF_EVENT_IOC_ENABLE, 0) != 0) return -1;
  }
  s->running.store(true);
  return 0;
}

int pa_sampler_stop(Sampler* s) {
  if (!s) return -1;
  for (int i = 0; i < s->n_cpus; i++) {
    ioctl(s->cpus[i].fd, PERF_EVENT_IOC_DISABLE, 0);
  }
  s->running.store(false);
  return 0;
}

// Drain all rings into out (capacity cap bytes). Returns bytes written;
// see the drain contract at the top of this file. Returns -1 only on
// invalid arguments.
long pa_sampler_drain(Sampler* s, uint8_t* out, long cap) {
  if (!s || !out || cap < 0) return -1;
  long written = 0;
  walk_rings(s, [&](uint32_t pid, uint32_t tid, uint64_t* kframes,
                    uint32_t nk, uint64_t* uframes, uint32_t nu,
                    uint8_t* p, uint8_t* rec_end) -> bool {
    uint64_t rip = 0, rsp = 0, rbp = 0;
    uint8_t* stack = nullptr;
    uint64_t dyn = 0;
    bool parse_ok = true;
    if (s->capture_stack) {
      // REGS_USER: abi word, then one u64 per set mask bit in
      // ascending bit order: BP(6), SP(7), IP(8).
      if (p + 8 <= rec_end) {
        uint64_t abi;
        std::memcpy(&abi, p, 8);
        p += 8;
        if (abi != 0 /* PERF_SAMPLE_REGS_ABI_NONE */) {
          if (p + 24 <= rec_end) {
            std::memcpy(&rbp, p, 8);
            std::memcpy(&rsp, p + 8, 8);
            std::memcpy(&rip, p + 16, 8);
            p += 24;
          } else {
            parse_ok = false;
          }
        }
      } else {
        parse_ok = false;
      }
      // STACK_USER: size word, raw bytes, dyn_size word.
      if (parse_ok && p + 8 <= rec_end) {
        uint64_t size;
        std::memcpy(&size, p, 8);
        p += 8;
        if (size) {
          if (p + size + 8 <= rec_end) {
            stack = p;
            p += size;
            std::memcpy(&dyn, p, 8);
            p += 8;
            if (dyn > size) dyn = size;
          } else {
            parse_ok = false;
          }
        }
      }
    }

    if (!(parse_ok && nk + nu + (rip ? 1 : 0) > 0 && nk + nu <= kMaxFrames))
      return true;  // unusable sample: consumed, nothing emitted
    uint64_t dyn_pad = (dyn + 7) & ~7ull;
    long need = 16 + 8l * (nk + nu);
    if (s->capture_stack) need += 32 + static_cast<long>(dyn_pad);
    if (written + need > cap) return false;
    uint8_t* o = out + written;
    std::memcpy(o, &pid, 4);
    std::memcpy(o + 4, &tid, 4);
    std::memcpy(o + 8, &nk, 4);
    std::memcpy(o + 12, &nu, 4);
    o += 16;
    if (s->capture_stack) {
      uint32_t dyn32 = static_cast<uint32_t>(dyn);
      uint32_t zero = 0;
      std::memcpy(o, &rip, 8);
      std::memcpy(o + 8, &rsp, 8);
      std::memcpy(o + 16, &rbp, 8);
      std::memcpy(o + 24, &dyn32, 4);
      std::memcpy(o + 28, &zero, 4);
      o += 32;
    }
    std::memcpy(o, kframes, 8l * nk);
    std::memcpy(o + 8l * nk, uframes, 8l * nu);
    o += 8l * (nk + nu);
    if (s->capture_stack && dyn_pad) {
      std::memcpy(o, stack, dyn);
      std::memset(o + dyn, 0, dyn_pad - dyn);
    }
    written += need;
    return true;
  });
  return written;
}

// ---- dedup drain: capture-side (pid, tid, stack) -> count -------------
//
// The envelope restorer: the reference aggregates (pid, stack) -> count
// IN KERNEL (bpf/cpu/cpu.bpf.c:110-116,457-461) so its userspace never
// sees per-sample records; the raw drain above ships every sample. At
// 100 Hz x many CPUs the stream is dominated by repeats of a small hot
// set, so this drain dedups AT THE DRAIN BOUNDARY in native code: an
// open-addressing (FNV-1a, memcmp-verified) table maps each record's
// identity to its already-written output record and bumps a count field
// instead of re-emitting. Python then decodes ~unique rows per drain.
//
// v1d record:
//   u32 pid | u32 tid | u32 n_kernel | u32 n_user | u32 count | u32 _pad
//   | u64 frames[n_kernel + n_user]                      (kernel first)
//
// FP/callchain mode only (-2 in DWARF mode: v2 records carry per-sample
// stack slices, which are never byte-identical). Dedup is best-effort
// within one drain pass — table overflow or cross-pass repeats emit
// separate records, which the aggregator merges anyway; counts are exact
// either way.

long pa_sampler_drain_dedup(Sampler* s, uint8_t* out, long cap) {
  if (!s || !out || cap < 0) return -1;
  if (s->capture_stack) return -2;
  if (!s->dd_hash) {
    s->dd_cap = 1 << 16;
    s->dd_hash = new uint64_t[s->dd_cap]();  // zeroed: first pass skips memset
    s->dd_off = new long[s->dd_cap];
  }
  // The 512 KB clear only matters if the previous pass registered
  // entries; idle drains (empty rings) skip it entirely.
  if (s->dd_dirty) {
    std::memset(s->dd_hash, 0, s->dd_cap * sizeof(uint64_t));
    s->dd_dirty = false;
  }
  const uint64_t dd_mask = s->dd_cap - 1;

  long written = 0;
  walk_rings(s, [&](uint32_t pid, uint32_t tid, uint64_t* kframes,
                    uint32_t nk, uint64_t* uframes, uint32_t nu,
                    uint8_t*, uint8_t*) -> bool {
    uint32_t nf = nk + nu;
    if (nf == 0 || nf > kMaxFrames) return true;  // consumed, not emitted
    uint32_t ident[4] = {pid, tid, nk, nu};
    uint64_t h = fnv1a(reinterpret_cast<uint8_t*>(ident), 16);
    h = fnv1a(reinterpret_cast<uint8_t*>(kframes), 8ul * nk, h);
    h = fnv1a(reinterpret_cast<uint8_t*>(uframes), 8ul * nu, h);
    if (h == 0) h = 1;
    uint64_t idx = h & dd_mask;
    for (int probes = 0; probes < 64; probes++) {
      if (s->dd_hash[idx] == 0) break;
      if (s->dd_hash[idx] == h) {
        // ident covers nk/nu, so the frame memcmp lengths below are
        // validated by the 16-byte header compare.
        uint8_t* o = out + s->dd_off[idx];
        if (std::memcmp(o, ident, 16) == 0 &&
            std::memcmp(o + 24, kframes, 8ul * nk) == 0 &&
            std::memcmp(o + 24 + 8ul * nk, uframes, 8ul * nu) == 0) {
          uint32_t c;
          std::memcpy(&c, o + 16, 4);
          c++;
          std::memcpy(o + 16, &c, 4);
          s->dedup_hits++;
          return true;
        }
      }
      idx = (idx + 1) & dd_mask;
    }
    long need = 24 + 8l * nf;
    if (written + need > cap) return false;
    uint8_t* o = out + written;
    uint32_t one = 1, zero = 0;
    std::memcpy(o, ident, 16);
    std::memcpy(o + 16, &one, 4);
    std::memcpy(o + 20, &zero, 4);
    std::memcpy(o + 24, kframes, 8l * nk);
    std::memcpy(o + 24 + 8l * nk, uframes, 8l * nu);
    if (s->dd_hash[idx] == 0) {  // probe budget not exhausted
      s->dd_hash[idx] = h;
      s->dd_off[idx] = written;
      s->dd_dirty = true;
    } else {
      // Table saturated along this probe chain: the record is emitted
      // unregistered, so later repeats in this pass emit separately too.
      // Counts stay exact; only the pre-aggregation envelope degrades.
      // This counter lets production tell overflow from true uniqueness.
      s->dd_overflow++;
    }
    written += need;
    return true;
  });
  return written;
}

uint64_t pa_sampler_dedup_hits(Sampler* s) { return s ? s->dedup_hits : 0; }

uint64_t pa_sampler_dedup_overflow(Sampler* s) {
  return s ? s->dd_overflow : 0;
}

// v1d decoders: like v1 below but with the 24-byte header carrying the
// drain-side count.
long pa_decode_v1d_count(const uint8_t* buf, long len, long stack_slots) {
  long pos = 0, n = 0;
  while (pos + 24 <= len) {
    uint32_t hdr[4];
    std::memcpy(hdr, buf + pos, 16);
    long nf = (long)hdr[2] + (long)hdr[3];
    if (nf > (long)kMaxFrames || nf > stack_slots ||
        pos + 24 + 8 * nf > len)
      break;
    pos += 24 + 8 * nf;
    n++;
  }
  return n;
}

long pa_decode_v1d(const uint8_t* buf, long len,
                   int32_t* pids, int32_t* tids,
                   int32_t* ulen, int32_t* klen, int64_t* counts,
                   uint64_t* stacks, long stack_slots, long cap) {
  long pos = 0, n = 0;
  while (pos + 24 <= len && n < cap) {
    uint32_t hdr[6];
    std::memcpy(hdr, buf + pos, 24);
    long nk = hdr[2], nu = hdr[3];
    long nf = nk + nu;
    if (nf > (long)kMaxFrames || nf > stack_slots ||
        pos + 24 + 8 * nf > len)
      break;
    pids[n] = (int32_t)hdr[0];
    tids[n] = (int32_t)hdr[1];
    klen[n] = (int32_t)nk;
    ulen[n] = (int32_t)nu;
    counts[n] = (int64_t)hdr[4];
    uint64_t* row = stacks + n * stack_slots;
    std::memcpy(row, buf + pos + 24 + 8 * nk, 8 * nu);
    std::memcpy(row + nu, buf + pos + 24, 8 * nk);
    pos += 24 + 8 * nf;
    n++;
  }
  return n;
}

// ---- v1h drain: dedup + capture-side hash carry -----------------------
//
// The hash half of the feed endgame (the streaming window's feed): the
// h1/h2/h3 triple the dictionary aggregator keys on is computed HERE,
// while the record's frames are hot in cache from the dedup memcmp,
// instead of re-walking every row on the Python side one drain later.
// The mix is the same multilinear family as ops/hashing.py (Python
// installs its seeded coefficient tables via pa_sampler_set_hash — the C
// side cannot regenerate numpy-seeded streams), so the carried triple is
// bit-identical to row_hash_np over the decoded snapshot row.
//
// v1h record:
//   u32 pid | u32 tid | u32 n_kernel | u32 n_user | u32 count
//   | u32 h1 | u32 h2 | u32 h3
//   | u64 frames[n_kernel + n_user]                      (kernel first)

// Install per-family hash constants. coefs is [n_fam][stride] row-major
// with stride >= 2*slots + 3 lanes; biases is [n_fam]. Returns 0, or -1
// on invalid arguments. slots is the snapshot row width (STACK_SLOTS) —
// the lane layout splits at it, so drain records and snapshot rows hash
// identically only when it matches the Python side's constant.
int pa_sampler_set_hash(Sampler* s, const uint32_t* coefs, long stride,
                        const uint32_t* biases, int n_fam, long slots) {
  if (!s || !coefs || !biases || n_fam < 1 || n_fam > 8 ||
      slots < (long)kMaxFrames || stride < 2 * slots + 3)
    return -1;
  delete[] s->hash_coefs;
  s->hash_coefs = new uint32_t[(size_t)n_fam * stride];
  std::memcpy(s->hash_coefs, coefs, (size_t)n_fam * stride * 4);
  std::memcpy(s->hash_biases, biases, (size_t)n_fam * 4);
  s->hash_stride = stride;
  s->hash_slots = slots;
  s->hash_nfam = n_fam;
  return 0;
}

// Like pa_sampler_drain_dedup, emitting v1h records with the hash triple
// computed once per UNIQUE record (dedup hits only bump the count — the
// hash depends on neither count nor the probe order). Returns -3 when no
// hash tables are installed.
long pa_sampler_drain_dedup2(Sampler* s, uint8_t* out, long cap) {
  if (!s || !out || cap < 0) return -1;
  if (s->capture_stack) return -2;
  if (s->hash_nfam < 3) return -3;
  if (!s->dd_hash) {
    s->dd_cap = 1 << 16;
    s->dd_hash = new uint64_t[s->dd_cap]();
    s->dd_off = new long[s->dd_cap];
  }
  if (s->dd_dirty) {
    std::memset(s->dd_hash, 0, s->dd_cap * sizeof(uint64_t));
    s->dd_dirty = false;
  }
  const uint64_t dd_mask = s->dd_cap - 1;

  long written = 0;
  walk_rings(s, [&](uint32_t pid, uint32_t tid, uint64_t* kframes,
                    uint32_t nk, uint64_t* uframes, uint32_t nu,
                    uint8_t*, uint8_t*) -> bool {
    uint32_t nf = nk + nu;
    if (nf == 0 || nf > kMaxFrames) return true;  // consumed, not emitted
    uint32_t ident[4] = {pid, tid, nk, nu};
    uint64_t h = fnv1a(reinterpret_cast<uint8_t*>(ident), 16);
    h = fnv1a(reinterpret_cast<uint8_t*>(kframes), 8ul * nk, h);
    h = fnv1a(reinterpret_cast<uint8_t*>(uframes), 8ul * nu, h);
    if (h == 0) h = 1;
    uint64_t idx = h & dd_mask;
    for (int probes = 0; probes < 64; probes++) {
      if (s->dd_hash[idx] == 0) break;
      if (s->dd_hash[idx] == h) {
        uint8_t* o = out + s->dd_off[idx];
        if (std::memcmp(o, ident, 16) == 0 &&
            std::memcmp(o + 32, kframes, 8ul * nk) == 0 &&
            std::memcmp(o + 32 + 8ul * nk, uframes, 8ul * nu) == 0) {
          uint32_t c;
          std::memcpy(&c, o + 16, 4);
          c++;
          std::memcpy(o + 16, &c, 4);
          s->dedup_hits++;
          return true;
        }
      }
      idx = (idx + 1) & dd_mask;
    }
    long need = 32 + 8l * nf;
    if (written + need > cap) return false;
    uint32_t triple[3];
    stack_hash_mix(kframes, nk, uframes, nu, pid, s->hash_coefs,
                   s->hash_stride, s->hash_biases, 3, s->hash_slots,
                   triple);
    uint8_t* o = out + written;
    uint32_t one = 1;
    std::memcpy(o, ident, 16);
    std::memcpy(o + 16, &one, 4);
    std::memcpy(o + 20, triple, 12);
    std::memcpy(o + 32, kframes, 8l * nk);
    std::memcpy(o + 32 + 8l * nk, uframes, 8l * nu);
    if (s->dd_hash[idx] == 0) {
      s->dd_hash[idx] = h;
      s->dd_off[idx] = written;
      s->dd_dirty = true;
    } else {
      s->dd_overflow++;
    }
    written += need;
    return true;
  });
  return written;
}

// v1h decoders: the v1d pair plus the carried hash triple.
long pa_decode_v1h_count(const uint8_t* buf, long len, long stack_slots) {
  long pos = 0, n = 0;
  while (pos + 32 <= len) {
    uint32_t hdr[4];
    std::memcpy(hdr, buf + pos, 16);
    long nf = (long)hdr[2] + (long)hdr[3];
    if (nf > (long)kMaxFrames || nf > stack_slots ||
        pos + 32 + 8 * nf > len)
      break;
    pos += 32 + 8 * nf;
    n++;
  }
  return n;
}

long pa_decode_v1h(const uint8_t* buf, long len,
                   int32_t* pids, int32_t* tids,
                   int32_t* ulen, int32_t* klen, int64_t* counts,
                   uint32_t* h1, uint32_t* h2, uint32_t* h3,
                   uint64_t* stacks, long stack_slots, long cap) {
  long pos = 0, n = 0;
  while (pos + 32 <= len && n < cap) {
    uint32_t hdr[8];
    std::memcpy(hdr, buf + pos, 32);
    long nk = hdr[2], nu = hdr[3];
    long nf = nk + nu;
    if (nf > (long)kMaxFrames || nf > stack_slots ||
        pos + 32 + 8 * nf > len)
      break;
    pids[n] = (int32_t)hdr[0];
    tids[n] = (int32_t)hdr[1];
    klen[n] = (int32_t)nk;
    ulen[n] = (int32_t)nu;
    counts[n] = (int64_t)hdr[4];
    h1[n] = hdr[5];
    h2[n] = hdr[6];
    h3[n] = hdr[7];
    uint64_t* row = stacks + n * stack_slots;
    std::memcpy(row, buf + pos + 32 + 8 * nk, 8 * nu);
    std::memcpy(row + nu, buf + pos + 32, 8 * nk);
    pos += 32 + 8 * nf;
    n++;
  }
  return n;
}

// Direct hash entry (no Sampler, no perf privileges): the bit-identity
// tests drive the SAME helper the dedup drain uses over arbitrary split
// (kernel, user) frame pairs and compare against row_hash_np. Returns 0,
// or -1 on invalid arguments.
int pa_stack_hash(const uint64_t* kframes, long nk,
                  const uint64_t* uframes, long nu, uint32_t pid,
                  const uint32_t* coefs, long stride,
                  const uint32_t* biases, long n_fam, long slots,
                  uint32_t* out) {
  if ((!kframes && nk > 0) || (!uframes && nu > 0) ||
      !coefs || !biases || !out ||
      nk < 0 || nu < 0 || n_fam < 1 || n_fam > 8 ||
      nk + nu > slots || stride < 2 * slots + 3)
    return -1;
  stack_hash_mix(kframes, (uint32_t)nk, uframes, (uint32_t)nu, pid,
                 coefs, stride, biases, (int)n_fam, slots, out);
  return 0;
}

// ---- v1 drain decode: packed records -> columnar arrays ---------------
// Per record: u32 pid, tid, nk, nu | (nk + nu) u64 frames, KERNEL first
// (the drain writer above). Decoding in native code replaces two Python
// per-record loops on the once-a-second capture path. Both functions
// stop at a corrupt/truncated tail exactly like the Python decoder, so
// the prefix parsed so far is kept.

// stack_slots is passed here too so count and decode apply the SAME
// acceptance rule and can never disagree on the record count.
long pa_decode_v1_count(const uint8_t* buf, long len, long stack_slots) {
  long pos = 0, n = 0;
  while (pos + 16 <= len) {
    uint32_t hdr[4];
    std::memcpy(hdr, buf + pos, 16);
    long nf = (long)hdr[2] + (long)hdr[3];
    if (nf > (long)kMaxFrames || nf > stack_slots ||
        pos + 16 + 8 * nf > len)
      break;
    pos += 16 + 8 * nf;
    n++;
  }
  return n;
}

// stacks: [cap][stack_slots] u64, written USER frames first then kernel
// tail (the WindowSnapshot row contract); rows must be pre-zeroed by the
// caller. Returns the number of records written.
long pa_decode_v1(const uint8_t* buf, long len,
                  int32_t* pids, int32_t* tids,
                  int32_t* ulen, int32_t* klen,
                  uint64_t* stacks, long stack_slots, long cap) {
  long pos = 0, n = 0;
  while (pos + 16 <= len && n < cap) {
    uint32_t hdr[4];
    std::memcpy(hdr, buf + pos, 16);
    long nk = hdr[2], nu = hdr[3];
    long nf = nk + nu;
    if (nf > (long)kMaxFrames || nf > stack_slots ||
        pos + 16 + 8 * nf > len)
      break;
    pids[n] = (int32_t)hdr[0];
    tids[n] = (int32_t)hdr[1];
    klen[n] = (int32_t)nk;
    ulen[n] = (int32_t)nu;
    uint64_t* row = stacks + n * stack_slots;
    std::memcpy(row, buf + pos + 16 + 8 * nk, 8 * nu);
    std::memcpy(row + nu, buf + pos + 16, 8 * nk);
    pos += 16 + 8 * nf;
    n++;
  }
  return n;
}

void pa_sampler_destroy(Sampler* s) {
  if (!s) return;
  pa_sampler_stop(s);
  for (int i = 0; i < s->n_cpus; i++) {
    if (s->cpus[i].ring) munmap(s->cpus[i].ring, s->cpus[i].ring_size);
    if (s->cpus[i].fd >= 0) close(s->cpus[i].fd);
  }
  delete[] s->cpus;
  delete[] s->scratch;
  delete[] s->dd_hash;
  delete[] s->dd_off;
  delete[] s->hash_coefs;
  delete s;
}

}  // extern "C"
