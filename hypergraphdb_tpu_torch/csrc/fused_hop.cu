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
// per lane per gathered row.
//
// Most gathered bytes cannot add a bit: on a sparse hop nearly every
// source row is zero, on a dense hop most rows saturate early, and 14 % of
// the entries of a DBpedia-shaped graph are the row's own id. So the warp
// scans its span 32 entries at a time (one coalesced index load) and drops,
// before any row load (bitrow.cuh gather_span):
//   - self entries (src == row: old[r] is already in the accumulator);
//   - sources whose line-occupancy field is clear (zero rows, the pad row);
//   - per lane, lines whose bit is clear;
// and stops a lane whose accumulator is all ones, the warp when every lane
// is. old[r] itself is loaded only where its own line bit is set.
//
// What bounds it now: on a sparse hop, the index scan, that is the latency
// of an index load and a dependent L2 mask read per 32 entries over ~10M
// warps, so resident warps matter more than loads in flight: kBatch = 3
// rows in flight per lane keeps the kernel at 40 registers. On a dense hop,
// the bytes of the live rows read before each lane saturates.
//
// Hub rows: a row with more chunks than one item holds is split over
// several items, so a zipf hub is spread over many warps instead of
// serialising one. The warps of a split row combine with atomicOr on `out`;
// a row that one item covers is stored with a plain write.
//
// Reads only `old`, writes only `out` (they must not overlap): a hop never
// sees a bit set in the same hop. `out` must start as a subset of the
// result: zeros, or an earlier bitmap of the same BFS (visited sets only
// grow, so the ping-pong buffer of the hop before last qualifies). Split
// rows OR into it, and a row whose result is all zero is not stored at all
// (its `out` row is already zero). The row's line field is ORed into
// `out_mask` (zeroed by the caller before the launch) with atomicOr on
// 32-bit words, since several rows, and the warps of a split row, share a
// word.

#include "bitrow.cuh"

namespace {

// gathered rows a lane keeps in flight (bitrow.cuh gather_span)
constexpr int kBatch = 3;

template <typename V>
__global__ void __launch_bounds__(hg::kThreads)
fused_hop_kernel(const V* __restrict__ old, V* __restrict__ out,
                 const int* __restrict__ idx, const long long* __restrict__ item_off,
                 const int* __restrict__ item_row, long long n_items, int w, int nvec,
                 int vec_per_line, const uint32_t* __restrict__ mask,
                 uint32_t* __restrict__ out_mask, int pbits) {
  const long long item =
      static_cast<long long>(blockIdx.x) * hg::kWarpsPerBlock + (threadIdx.x / hg::kWarp);
  if (item >= n_items) return;  // whole warps: the item is per warp
  const int lane = threadIdx.x % hg::kWarp;
  const long long row = __ldg(item_row + item);
  const long long e0 = __ldg(item_off + item) * w;
  const long long e1 = __ldg(item_off + item + 1) * w;
  const bool split = (item > 0 && __ldg(item_row + item - 1) == row) ||
                     (item + 1 < n_items && __ldg(item_row + item + 1) == row);
  const uint32_t own = hg::mask_field(mask, row, pbits);
  uint32_t field = 0u;
  for (int v0 = 0; v0 < nvec; v0 += hg::kWarp) {
    const int v = v0 + lane;
    const bool active = v < nvec;
    const int line = v / vec_per_line;
    V acc;
    hg::set_zero(acc);
    if (active && ((own >> line) & 1u)) acc = hg::load_ro(old + row * nvec + v);
    hg::gather_span<kBatch>(old, idx, e0, e1, row, mask, pbits, nvec, v, active, line,
                            lane, acc);
    const bool nz = active && hg::any_set(acc);
    field |= __reduce_or_sync(hg::kFull, nz ? (1u << line) : 0u);
    if (nz) {
      V* dst = out + row * nvec + v;
      if (split) {
        hg::atomic_or(dst, acc);
      } else {
        *dst = acc;
      }
    }
  }
  if (lane == 0) hg::emit_field(out_mask, row, pbits, field);
}

}  // namespace

// old, out: (n_rows, kw) int32; idx: (n_chunks * w,) int32 rows of old;
// item_off: (n_items + 1,) int64 chunk bounds of each item; item_row:
// (n_items,) int32, non-decreasing, covering every row of out. mask: the
// line mask of old (null: every line live); out_mask: a zeroed line mask
// for out (null: none is written); line_words and pbits its geometry
// (ops/linemask.py). Launches on `stream` and returns cudaGetLastError().
extern "C" int hg_fused_hop(const void* old, void* out, const void* idx,
                            const void* item_off, const void* item_row,
                            long long n_items, int w, int kw, const void* mask,
                            void* out_mask, int line_words, int pbits, void* stream) {
  if (n_items <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned grid = hg::grid_for_warps(n_items);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const long long* off = static_cast<const long long*>(item_off);
  const int* rows = static_cast<const int*>(item_row);
  const uint32_t* m = static_cast<const uint32_t*>(mask);
  uint32_t* om = static_cast<uint32_t*>(out_mask);
  if (kw % 4 == 0 && line_words % 4 == 0 && hg::aligned16(old) && hg::aligned16(out)) {
    fused_hop_kernel<uint4><<<grid, hg::kThreads, 0, s>>>(
        static_cast<const uint4*>(old), static_cast<uint4*>(out), ix, off, rows,
        n_items, w, kw / 4, line_words / 4, m, om, pbits);
  } else {
    fused_hop_kernel<uint32_t><<<grid, hg::kThreads, 0, s>>>(
        static_cast<const uint32_t*>(old), static_cast<uint32_t*>(out), ix, off,
        rows, n_items, w, kw, line_words, m, om, pbits);
  }
  return static_cast<int>(cudaGetLastError());
}
