// K2, one fused pull-BFS hop over the host-composed atom->atom adjacency:
//   new[r] = old[r] | OR_{c in chunks(r)} OR_{j<w} old[idx[c*w + j]]
// over the (n_rows, kw) transposed visited bitmap.
//
// Replaces the Pallas kernel hypergraphdb_tpu/ops/pallas_bfs.py (_hop_kernel,
// launched by _hop_call and driven by _hop_fused / _bfs_fused). The TPU
// version walked B-row output blocks with the chunk plan in SMEM and
// declined graphs whose hub rows overflowed that window. Here the plan is a
// flat list of work items, each a span of at most a fixed number of chunks
// of one row (ops/fused_bfs.py builds it), and one warp owns one item. Each
// lane holds 16 bytes (one uint4) of the row, so a 512-byte row is one load
// per lane per gathered row, and the gathered rows of a span are
// independent loads, unrolled so several are in flight at once.
//
// Hub rows: a row with more chunks than one item holds is split over
// several items, so a zipf hub is spread over many warps instead of
// serialising one. The warps of a split row combine with atomicOr on `out`;
// a row that one item covers is stored with a plain write.
//
// Reads only `old`, writes only `out` (they must not overlap): a hop never
// sees a bit set in the same hop. For a split row the atomics OR into what
// `out` already holds, so `out` must start as a subset of the result: zeros,
// or an earlier bitmap of the same BFS (visited sets only grow, so the
// ping-pong buffer of the hop before last qualifies).
//
// Bound on the card: bytes. Every chunk entry is a random row read of kw*4
// bytes; the ORs are one per word.

#include "bitrow.cuh"

namespace {

template <typename V>
__global__ void __launch_bounds__(hg::kThreads)
fused_hop_kernel(const V* __restrict__ old, V* __restrict__ out,
                 const int* __restrict__ idx, const long long* __restrict__ item_off,
                 const int* __restrict__ item_row, long long n_items, int w, int nvec) {
  const long long item =
      static_cast<long long>(blockIdx.x) * hg::kWarpsPerBlock + (threadIdx.x / hg::kWarp);
  if (item >= n_items) return;
  const int lane = threadIdx.x % hg::kWarp;
  const long long row = __ldg(item_row + item);
  const long long e0 = __ldg(item_off + item) * w;
  const long long e1 = __ldg(item_off + item + 1) * w;
  const bool split = (item > 0 && __ldg(item_row + item - 1) == row) ||
                     (item + 1 < n_items && __ldg(item_row + item + 1) == row);
  for (int v = lane; v < nvec; v += hg::kWarp) {
    V acc = hg::load_ro(old + row * nvec + v);
#pragma unroll 8
    for (long long e = e0; e < e1; ++e) {
      const long long src = __ldg(idx + e);
      hg::or_into(acc, hg::load_ro(old + src * nvec + v));
    }
    V* dst = out + row * nvec + v;
    if (split) {
      hg::atomic_or(dst, acc);
    } else {
      *dst = acc;
    }
  }
}

}  // namespace

// old, out: (n_rows, kw) int32; idx: (n_chunks * w,) int32 rows of old;
// item_off: (n_items + 1,) int64 chunk bounds of each item; item_row:
// (n_items,) int32, non-decreasing, covering every row of out. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int hg_fused_hop(const void* old, void* out, const void* idx,
                            const void* item_off, const void* item_row,
                            long long n_items, int w, int kw, void* stream) {
  if (n_items <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned grid = hg::grid_for_warps(n_items);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const long long* off = static_cast<const long long*>(item_off);
  const int* rows = static_cast<const int*>(item_row);
  if (kw % 4 == 0 && hg::aligned16(old) && hg::aligned16(out)) {
    fused_hop_kernel<uint4><<<grid, hg::kThreads, 0, s>>>(
        static_cast<const uint4*>(old), static_cast<uint4*>(out), ix, off, rows,
        n_items, w, kw / 4);
  } else {
    fused_hop_kernel<uint32_t><<<grid, hg::kThreads, 0, s>>>(
        static_cast<const uint32_t*>(old), static_cast<uint32_t*>(out), ix, off,
        rows, n_items, w, kw);
  }
  return static_cast<int>(cudaGetLastError());
}
