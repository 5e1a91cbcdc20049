// Host passes of the port: the varint emission and ragged copy behind
// pprof/vec.py (the window encoder's byte streams) and the batched row
// hash behind ops/hashing.py row_hash_np.
//
// The numpy byte-plane encoder is whole-array vectorized, but at the
// bench window's scale (~25M frame varints per window) its gather/scatter
// passes go memory-system-superlinear. One sequential C pass emits the
// same stream: positions arrive sorted ascending, so the write pattern is
// a forward walk with tiny holes (the per-id section headers).
//
// Same wire contract as proto.put_varint (unsigned LEB128; callers
// pre-mask negatives to two's-complement uint64). The numpy passes stay
// in pprof/vec.py as the plain versions these are held against; they run
// only when a caller asks for them.
//
// A copy of parca_agent_tpu/native/vecenc.cc; built by
// parca_agent_tpu_torch/native/__init__.py (g++ -O2 -fPIC -shared).

#include <cstddef>
#include <cstdint>

extern "C" {

// Byte length of each value's unsigned LEB128 varint (1..10), matching
// vec.varint_len: ceil(bit_length/7), with 0 -> 1 byte.
void pa_varint_lens(const uint64_t* vals, int64_t n, int32_t* out) {
  for (int64_t i = 0; i < n; i++) {
    int bits = 64 - __builtin_clzll(vals[i] | 1);
    out[i] = (bits + 6) / 7;
  }
}

// Emit vals[i]'s varint at out + pos[i]. Regions are caller-sized
// (pa_varint_lens / vec.varint_len) and non-overlapping; the minimal
// LEB128 encoding written here fills each region exactly. Returns -1, or
// the first index whose region would leave [0, out_len) — checked before
// writing (the numpy path raises IndexError on a bad caller; silent heap
// corruption here would be strictly worse).
int64_t pa_put_varints(uint8_t* out, int64_t out_len, const int64_t* pos,
                       const uint64_t* vals, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    uint64_t v = vals[i];
    int bits = 64 - __builtin_clzll(v | 1);
    int64_t len = (bits + 6) / 7;
    if (pos[i] < 0 || pos[i] + len > out_len) return i;
    uint8_t* p = out + pos[i];
    while (v >= 0x80) {
      *p++ = static_cast<uint8_t>(v) | 0x80;
      v >>= 7;
    }
    *p = static_cast<uint8_t>(v);
  }
  return -1;
}

// Fixed-width (non-minimal) varints for the template patch path
// (vec.put_varints_padded): continuation bit on all but the last of
// `width` bytes. Caller guarantees width >= varint_len(max value).
int64_t pa_put_varints_padded(uint8_t* out, int64_t out_len,
                              const int64_t* pos, const uint64_t* vals,
                              int64_t n, int32_t width) {
  if (width < 1 && n > 0) return 0;  // final byte write is unconditional
  for (int64_t i = 0; i < n; i++) {
    if (pos[i] < 0 || pos[i] + width > out_len) return i;
    uint8_t* p = out + pos[i];
    uint64_t v = vals[i];
    for (int32_t k = 0; k < width - 1; k++) {
      *p++ = static_cast<uint8_t>(v & 0x7F) | 0x80;
      v >>= 7;
    }
    *p = static_cast<uint8_t>(v & 0x7F);
  }
  return -1;
}

// Batched multilinear row hash for the dict aggregator's feed path
// (ops/hashing.py row_hash_np). The numpy twin materializes the full
// [N, 2*slots+3] uint32 lane matrix (hi | lo | pid | ulen | klen) and
// multiply-sums it — ~1 GB of transient traffic per 1M-row window at
// 128 slots, almost all of it zero padding. One native pass walks only
// each row's LIVE prefix (depth[i] = user_len + kernel_len; the
// WindowSnapshot contract zero-pads past it, and a zero lane
// contributes coef*0 == 0 to a multilinear hash), so per-row work is
// proportional to stack depth, not the 128-slot pad. All arithmetic is
// uint32 with natural wraparound — bit-identical to the numpy path's
// uint32 multiply/sum/mix for any contract-valid (zero-padded) row.
//
// Layout contract (validated by the Python wrapper): coefs is row-major
// [n_fam, coef_stride] with coef_stride >= 2*slots + 3; family f hashes
// hi-lane s with coefs[f*stride + s], lo-lane s with
// coefs[f*stride + slots + s], then pid/ulen/klen at 2*slots + {0,1,2}.
// out is row-major [n_fam, n]. n_fam is capped at 4 (the hash-family
// count baked into ops/hashing.py) — checked here because writing
// through a caller-undersized acc would corrupt the stack.
int64_t pa_row_hash(const uint64_t* stacks, int64_t n, int64_t slots,
                    const uint32_t* pids, const uint32_t* ulen,
                    const uint32_t* klen, const int32_t* depth,
                    const uint32_t* coefs, int64_t coef_stride,
                    const uint32_t* biases, int64_t n_fam, uint32_t* out) {
  if (n_fam < 1 || n_fam > 4 || coef_stride < 2 * slots + 3) return 0;
  for (int64_t i = 0; i < n; i++) {
    uint32_t acc[4] = {0, 0, 0, 0};
    const uint64_t* row = stacks + i * slots;
    int64_t d = depth[i];
    if (d < 0) d = 0;
    if (d > slots) d = slots;
    for (int64_t s = 0; s < d; s++) {
      uint64_t v = row[s];
      if (!v) continue;  // zero lane: coef*0 contributes nothing
      uint32_t hi = static_cast<uint32_t>(v >> 32);
      uint32_t lo = static_cast<uint32_t>(v);
      for (int64_t f = 0; f < n_fam; f++) {
        const uint32_t* c = coefs + f * coef_stride;
        acc[f] += c[s] * hi + c[slots + s] * lo;
      }
    }
    for (int64_t f = 0; f < n_fam; f++) {
      const uint32_t* c = coefs + f * coef_stride;
      uint32_t x = acc[f] + c[2 * slots] * pids[i] +
                   c[2 * slots + 1] * ulen[i] + c[2 * slots + 2] * klen[i] +
                   biases[f];
      // mix32 finalizer (ops/hashing.py mix32, seed 0).
      x ^= x >> 16;
      x *= 0x85EBCA6Bu;
      x ^= x >> 13;
      x *= 0xC2B2AE35u;
      x ^= x >> 16;
      out[f * n + i] = x;
    }
  }
  return -1;
}

// Ragged byte-run copy for vec.ragged_gather: run i is
// src[src_pos[i], src_pos[i]+lens[i]) -> dst[dst_pos[i], ...). The numpy
// plain version pays per-ELEMENT fancy indexing (repeat + arange + gather —
// ~3 int64 index ops per byte); the template layout's sample-prefix and
// statics splices move tens of MB per window, where a forward memcpy
// walk is ~20x cheaper. All positions/lengths are BYTE offsets (the
// Python wrapper scales by itemsize). Returns -1, or the first index
// whose run leaves either buffer — checked before any write.
int64_t pa_ragged_copy(uint8_t* dst, int64_t dst_len, const uint8_t* src,
                       int64_t src_len, const int64_t* src_pos,
                       const int64_t* dst_pos, const int64_t* lens,
                       int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    int64_t l = lens[i];
    if (l < 0 || src_pos[i] < 0 || src_pos[i] + l > src_len ||
        dst_pos[i] < 0 || dst_pos[i] + l > dst_len)
      return i;
    __builtin_memcpy(dst + dst_pos[i], src + src_pos[i],
                     static_cast<size_t>(l));
  }
  return -1;
}

}  // extern "C"
