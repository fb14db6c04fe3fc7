// Shared helpers for the bitmap-row kernels: a row of the transposed
// visited bitmap is `kw` 32-bit words (one bit per seed). Threads move it
// as 16-byte vectors (uint4) when the row width and the base pointers allow
// it, else as single words; the helpers below are overloaded on both.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hg {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;

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

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u;
}

inline unsigned grid_for_warps(long long n_warps) {
  return static_cast<unsigned>((n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace hg
