// K3, sorted-set membership over ragged rows: mask[i] = base[i] != SENTINEL
// and base[i] lies in every row j = flat[offsets[j], offsets[j + 1]).
//
// Replaces the Pallas kernel hypergraphdb_tpu/ops/pallas_kernels.py (_kernel
// :41, launched by _membership_call :85; membership_mask_pallas :107,
// intersect_sorted_pallas :135). The TPU version compared every base element
// with every element of (M, Lo) SENTINEL-padded rows in (8, 128) VMEM tiles,
// and its callers padded both sides to powers of two: one Mosaic compile per
// shape, a VMEM ceiling, the TPU's tiling. None of that holds on the H100, so
// this kernel takes the rows as they are. The padded (M, Lo) form is the
// special case offsets[j] = j * Lo: a SENTINEL pad never equals a live base
// value, and the windows below stop short of the pads.
//
// Bound on the card: bytes. Base, offsets and the rows' windows are read once
// and the mask written once: at the planner's h1 & h2 intersection (354,211
// base ids, one row of 758,572, of which 758,569 lie in the base's range)
// 4,805,347 bytes, 1.43 us at 3.35 TB/s, so in practice the launch latency. The earlier design gave each base element a
// thread and a binary search of about 21 dependent global loads per row: the
// loads of a search cannot overlap, so a thread waited 21 L2 round trips,
// about 1.3 waves over, whatever the bytes.
//
// Design. A block owns a tile of kTile consecutive base elements, kPer a
// thread, strided so that loads and stores coalesce; its per-element flags
// live in registers. For each row, in the order given (the caller puts the
// shortest first):
//   1. the block reduces the tile's live elements to (min, max, count); with
//      none live it stops: its remaining rows cannot set a flag;
//   2. warp 0 finds the lower bound of min and warp 1 the upper bound of max
//      in the row, by a 32-way search (a 758K row takes 4 rounds of loads);
//      the window between them holds every value the tile can match;
//   3. a window no longer than kSearchRatio times the live count (or one
//      chunk) streams through shared memory in chunks of kChunk ints, double
//      buffered with cp.async (16-byte copies where the row is aligned), and
//      each thread tests its live elements against a chunk by a binary search
//      in shared memory; a longer window (a short base against a hub row)
//      would be read for nothing, so the tile instead searches it in global
//      memory, each thread's kPer searches in lockstep so their loads
//      overlap.
//   4. each element's flag ANDs with "found in this row".
// The route of step 3 is taken per tile and per row, on the data.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;
constexpr int kTile = kThreads * kPer;
constexpr int kChunk = 2048;
constexpr int kSearchRatio = 16;
constexpr int kSentinel = INT_MAX;
constexpr unsigned kFull = 0xffffffffu;

// First index in row[a, b) whose value is >= v (kUpper: > v), or b if none.
// Called by a whole warp; every lane returns the same index.
template <bool kUpper>
__device__ long long warp_bound(const int* __restrict__ row, long long a,
                                long long b, int v, int lane) {
  while (b - a > 32) {
    const long long step = (b - a + 31) >> 5;
    const long long p = a + lane * step;
    bool before = false;
    if (p < b) {
      const int x = __ldg(row + p);
      before = kUpper ? x <= v : x < v;
    }
    const int cnt = __popc(__ballot_sync(kFull, before));
    if (cnt == 0) return a;
    const long long na = a + (cnt - 1) * step + 1;
    b = min(b, a + cnt * step);
    a = na;
  }
  const long long p = a + lane;
  bool before = false;
  if (p < b) {
    const int x = __ldg(row + p);
    before = kUpper ? x <= v : x < v;
  }
  return a + __popc(__ballot_sync(kFull, before));
}

__device__ __forceinline__ void copy16(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ int chunk_len(long long rest) {
  return rest < kChunk ? static_cast<int>(rest) : kChunk;
}

// Copy flat[g, g + n) into dst; g is a multiple of 4 where `vec`.
__device__ __forceinline__ void issue_chunk(int* dst,
                                           const int* __restrict__ flat,
                                           long long g, int n, bool vec) {
  const int nv = vec ? n >> 2 : 0;
  for (int t = threadIdx.x; t < nv; t += kThreads) {
    copy16(dst + 4 * t, flat + g + 4 * t);
  }
  for (int t = 4 * nv + threadIdx.x; t < n; t += kThreads) {
    copy4(dst + t, flat + g + t);
  }
}

__global__ void __launch_bounds__(kThreads)
membership_kernel(const int* __restrict__ base, const int* __restrict__ flat,
                  const long long* __restrict__ offsets,
                  uint8_t* __restrict__ mask, long long lb, int m) {
  __shared__ __align__(16) int buf[2][kChunk];
  __shared__ int s_min, s_max, s_live;
  __shared__ long long s_wlo, s_whi;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const bool vec = (reinterpret_cast<uintptr_t>(flat) & 15) == 0;

  int v[kPer];
  unsigned live = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long i = tile0 + k * kThreads + threadIdx.x;
    v[k] = i < lb ? __ldg(base + i) : kSentinel;
    if (v[k] != kSentinel) live |= 1u << k;
  }
  if (threadIdx.x == 0) {
    s_min = INT_MAX;
    s_max = INT_MIN;
    s_live = 0;
  }
  __syncthreads();

  for (int j = 0; j < m; ++j) {
    // 1. the live elements' range and count
    int tmin = INT_MAX, tmax = INT_MIN, tcnt = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (live >> k & 1) {
        tmin = min(tmin, v[k]);
        tmax = max(tmax, v[k]);
        ++tcnt;
      }
    }
    tmin = __reduce_min_sync(kFull, tmin);
    tmax = __reduce_max_sync(kFull, tmax);
    tcnt = __reduce_add_sync(kFull, tcnt);
    if (lane == 0 && tcnt > 0) {
      atomicMin(&s_min, tmin);
      atomicMax(&s_max, tmax);
      atomicAdd(&s_live, tcnt);
    }
    __syncthreads();
    const int lo_v = s_min, hi_v = s_max, n_live = s_live;
    if (n_live == 0) break;  // uniform: every flag of the tile is clear

    // 2. the tile's window in row j
    const long long r0 = offsets[j];
    const int* row = flat + r0;
    const long long len = offsets[j + 1] - r0;
    if (warp == 0) {
      const long long w = warp_bound<false>(row, 0, len, lo_v, lane);
      if (lane == 0) s_wlo = w;
    } else if (warp == 1) {
      const long long w = warp_bound<true>(row, 0, len, hi_v, lane);
      if (lane == 0) s_whi = w;
    }
    __syncthreads();
    const long long wlo = s_wlo, whi = s_whi;
    const long long wlen = whi - wlo;
    if (threadIdx.x == 0) {  // every thread has read the stats: reset them
      s_min = INT_MAX;
      s_max = INT_MIN;
      s_live = 0;
    }

    // 3. test the live elements against the window
    unsigned found = 0;
    if (wlen > kChunk &&
        wlen > static_cast<long long>(kSearchRatio) * n_live) {
      // long window: lockstep lower-bound searches in global memory
      long long at[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) at[k] = wlo;
      for (long long n = wlen; n > 1;) {
        const long long half = n >> 1;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          if ((live >> k & 1) && __ldg(row + at[k] + half) < v[k]) {
            at[k] += half;
          }
        }
        n -= half;
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (!(live >> k & 1)) continue;
        const long long p = at[k] + (__ldg(row + at[k]) < v[k]);
        if (p < whi && __ldg(row + p) == v[k]) found |= 1u << k;
      }
    } else if (wlen > 0) {
      // short window: stream it through shared memory
      const long long ga = r0 + wlo, gb = r0 + whi;  // flat indices
      const long long g0 = vec ? ga & ~3LL : ga;
      const int n_chunks = static_cast<int>((gb - g0 + kChunk - 1) / kChunk);
      issue_chunk(buf[0], flat, g0, chunk_len(gb - g0), vec);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      for (int c = 0; c < n_chunks; ++c) {
        if (c + 1 < n_chunks) {
          const long long g = g0 + static_cast<long long>(c + 1) * kChunk;
          issue_chunk(buf[(c + 1) & 1], flat, g, chunk_len(gb - g), vec);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        __syncthreads();
        const int* s = buf[c & 1];
        const long long g = g0 + static_cast<long long>(c) * kChunk;
        const int s_lo = ga > g ? static_cast<int>(ga - g) : 0;
        const int s_hi = chunk_len(gb - g);
        const int first = s[s_lo], last = s[s_hi - 1];
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          if (!((live & ~found) >> k & 1) || v[k] < first || v[k] > last) {
            continue;
          }
          int a = s_lo, n = s_hi - s_lo;  // lower bound of v[k] in s[a, a+n)
          while (n > 1) {
            const int half = n >> 1;
            if (s[a + half] < v[k]) a += half;
            n -= half;
          }
          const int p = a + (s[a] < v[k]);
          if (p < s_hi && s[p] == v[k]) found |= 1u << k;
        }
        __syncthreads();  // before the next issue overwrites this buffer
      }
    }
    live &= found;
    __syncthreads();  // the reset above is seen before the next row's stats
  }

#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long i = tile0 + k * kThreads + threadIdx.x;
    if (i < lb) mask[i] = (live >> k & 1) ? 1 : 0;
  }
}

}  // namespace

// base: (lb,) int32, sorted ascending (a SENTINEL tail never matches);
// flat: the m rows back to back, each sorted ascending; offsets: (m + 1,)
// int64, row j is flat[offsets[j], offsets[j + 1]); mask: (lb,) bytes of 0
// or 1 (a torch.bool tensor). Launches on `stream`, allocates nothing and
// returns cudaGetLastError().
extern "C" int hg_membership(const void* base, const void* flat,
                             const void* offsets, void* mask, long long lb,
                             int m, void* stream) {
  if (lb <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned grid = static_cast<unsigned>((lb + kTile - 1) / kTile);
  membership_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(base), static_cast<const int*>(flat),
      static_cast<const long long*>(offsets), static_cast<uint8_t*>(mask), lb,
      m);
  return static_cast<int>(cudaGetLastError());
}
