// K3, sorted-set membership: mask[i] = base[i] != SENTINEL and base[i] lies
// in every one of the M rows of `others`.
//
// Replaces the Pallas kernel hypergraphdb_tpu/ops/pallas_kernels.py (_kernel,
// launched by _membership_call; membership_mask_pallas,
// intersect_sorted_pallas). The TPU version compared every base element with
// every element of the other rows in (8, 128) VMEM tiles, O(Lb*M*Lo)
// compares, because a binary search is gather traffic its vector unit
// handles badly and the rows had to fit VMEM. Neither holds here. One thread
// owns one base element and runs a lower-bound binary search in each sorted,
// SENTINEL-padded row, O(Lb*M*log Lo), stopping at the first row that lacks
// the element.
//
// Bound on the card: bytes. Each base element is read once and each mask
// byte written once; a search reads log2(Lo) words of a row, and since the
// base is sorted, the threads of a warp hold neighbouring values and walk
// nearly the same path through a row, so most of those reads hit the L1/L2.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSentinel = INT_MAX;

__global__ void __launch_bounds__(kThreads)
membership_kernel(const int* __restrict__ base, const int* __restrict__ others,
                  uint8_t* __restrict__ mask, long long lb, int m,
                  long long lo) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= lb) return;
  const int v = __ldg(base + i);
  bool ok = v != kSentinel;
  for (int j = 0; j < m && ok; ++j) {
    const int* row = others + static_cast<long long>(j) * lo;
    long long a = 0, b = lo;  // lower bound of v in row[0, lo)
    while (a < b) {
      const long long mid = a + ((b - a) >> 1);
      if (__ldg(row + mid) < v) {
        a = mid + 1;
      } else {
        b = mid;
      }
    }
    ok = a < lo && __ldg(row + a) == v;
  }
  mask[i] = ok ? 1 : 0;
}

}  // namespace

// base: (lb,) int32; others: (m, lo) int32, each row sorted ascending and
// SENTINEL-padded; mask: (lb,) bytes of 0 or 1 (a torch.bool tensor).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int hg_membership(const void* base, const void* others, void* mask,
                             long long lb, int m, long long lo, void* stream) {
  if (lb <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned grid = static_cast<unsigned>((lb + kThreads - 1) / kThreads);
  membership_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(base), static_cast<const int*>(others),
      static_cast<uint8_t*>(mask), lb, m, lo);
  return static_cast<int>(cudaGetLastError());
}
