// Shared helpers for the bitmap-row kernels: a row of the transposed
// visited bitmap is `kw` 32-bit words (one bit per seed). Threads move it
// as 16-byte vectors (uint4) when the row width and the base pointers allow
// it, else as single words; the helpers below are overloaded on both.
//
// Line-occupancy masks (ops/linemask.py): every row owns a field of
// `pbits` bits (a power of two, at most 32) at bit row*pbits of a packed
// array of 32-bit words; bit l of the field says "line l of the row may
// hold a set bit". A line is `line_words` words (32, one 128-byte line, for
// rows up to 1024 words). A mask is a superset of the nonzero lines, so a
// clear bit proves the line is zero and its load can be skipped. A null
// mask means every line is live.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hg {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void set_zero(uint32_t& a) { a = 0u; }
__device__ __forceinline__ void set_zero(uint4& a) { a = make_uint4(0u, 0u, 0u, 0u); }

__device__ __forceinline__ uint32_t load_ro(const uint32_t* p) { return __ldg(p); }
__device__ __forceinline__ uint4 load_ro(const uint4* p) { return __ldg(p); }

__device__ __forceinline__ void or_into(uint32_t& a, uint32_t b) { a |= b; }
__device__ __forceinline__ void or_into(uint4& a, const uint4& b) {
  a.x |= b.x;
  a.y |= b.y;
  a.z |= b.z;
  a.w |= b.w;
}

__device__ __forceinline__ bool all_ones(uint32_t a) { return a == kFull; }
__device__ __forceinline__ bool all_ones(const uint4& a) {
  return (a.x & a.y & a.z & a.w) == kFull;
}
__device__ __forceinline__ bool any_set(uint32_t a) { return a != 0u; }
__device__ __forceinline__ bool any_set(const uint4& a) {
  return (a.x | a.y | a.z | a.w) != 0u;
}

// OR into device memory that other warps may OR into at the same time.
// A zero word changes nothing, so it skips the atomic.
__device__ __forceinline__ void atomic_or(uint32_t* p, uint32_t v) {
  if (v) atomicOr(p, v);
}
__device__ __forceinline__ void atomic_or(uint4* p, const uint4& v) {
  uint32_t* q = reinterpret_cast<uint32_t*>(p);
  atomic_or(q + 0, v.x);
  atomic_or(q + 1, v.y);
  atomic_or(q + 2, v.z);
  atomic_or(q + 3, v.w);
}

// The line field of `row` (all ones without a mask).
__device__ __forceinline__ uint32_t mask_field(const uint32_t* mask, long long row,
                                               int pbits) {
  if (mask == nullptr) return kFull;
  const long long b = row * pbits;
  const uint32_t w = __ldg(mask + (b >> 5)) >> (b & 31);
  return pbits == 32 ? w : (w & ((1u << pbits) - 1u));
}

// OR `field` into row `row`'s field of a mask that other warps write too.
__device__ __forceinline__ void emit_field(uint32_t* mask, long long row, int pbits,
                                           uint32_t field) {
  if (mask == nullptr || field == 0u) return;
  const long long b = row * pbits;
  atomicOr(mask + (b >> 5), field << (b & 31));
}

// The warp's index scan: OR into each lane's `acc` (vector `v` of a row of
// `nvec` vectors, in line `line`) the rows idx[e0..e1) of `rows`.
//
// The 32 lanes load 32 index entries at once (one coalesced load) and the
// fields of those sources. An entry is dropped when it is `self` (its bits
// are already in acc) or its field is clear (a zero row, such as the pad
// row). A ballot lists the live entries; each is broadcast with shuffles
// and a lane loads its vector only when its line bit is set, kBatch rows in
// flight at once. A lane whose acc is all ones loads nothing more, and the
// scan ends when every lane is saturated (or inactive: v >= nvec), checked
// after every batch. All 32 lanes must call it together.
//
// kBatch trades loads in flight per warp against registers: a smaller
// batch checks saturation sooner and frees registers for more resident
// warps, which is what the sparse hops (latency of the index and mask
// reads) want; each kernel picks its own.
template <int kBatch, typename V>
__device__ __forceinline__ void gather_span(const V* rows, const int* __restrict__ idx,
                                            long long e0, long long e1, long long self,
                                            const uint32_t* mask, int pbits, int nvec,
                                            int v, bool active, int line, int lane,
                                            V& acc) {
  bool done = !active || all_ones(acc);
  if (__all_sync(kFull, done)) return;
  for (long long base = e0; base < e1; base += kWarp) {
    const long long e = base + lane;
    int src = 0;
    uint32_t field = 0u;
    if (e < e1) {
      src = __ldg(idx + e);
      if (src != self) field = mask_field(mask, src, pbits);
    }
    unsigned live = __ballot_sync(kFull, field != 0u);
    while (live) {
      V g[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        set_zero(g[j]);
        if (live) {
          const int l = __ffs(live) - 1;
          live &= live - 1;
          const long long s = __shfl_sync(kFull, src, l);
          const uint32_t f = __shfl_sync(kFull, field, l);
          if (!done && ((f >> line) & 1u)) g[j] = load_ro(rows + s * nvec + v);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) or_into(acc, g[j]);
      done = done || all_ones(acc);
      if (__all_sync(kFull, done)) return;
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u;
}

inline unsigned grid_for_warps(long long n_warps) {
  return static_cast<unsigned>((n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace hg
