// K1, gather-OR: out[c] = OR_{j<w} values[idx[c*w + j]] over rows of kw
// 32-bit words.
//
// Replaces the Pallas kernel hypergraphdb_tpu/ops/pallas_gather.py (_kernel,
// launched by _call / gather_or). The TPU version streamed rows through D
// DMA slots and cut the index array into SMEM-sized segments; none of that
// carries over. Here one warp owns one output row: each lane holds 16 bytes
// (one uint4) of the row, so a 512-byte row (kw = 128, a 4096-seed block)
// is one load per lane per gathered row.
//
// Most gathered bytes cannot add a bit: on a sparse hop nearly every
// gathered row is zero. The warp loads its w <= 32 index entries in one
// coalesced load with the line-occupancy fields of their sources, drops the
// sources whose field is clear (zero rows, the pad row), and each lane
// loads only the live rows whose line bit it covers is set; a lane whose
// accumulator is all ones stops (bitrow.cuh gather_span). The row's line
// field is ORed into `out_mask` with atomicOr on 32-bit words (neighbouring
// rows share a word). `out` must already hold a subset of the result (it
// starts zeroed and the reduced values only grow from one BFS hop to the
// next), so a row whose result is all zero is not stored.
//
// What bounds it now: on a sparse level, the latency of the index load and
// the dependent L2 mask reads over one warp per output row; on a dense one,
// the bytes of the live rows. With w = 8 entries a row, one row in flight
// per lane (kBatch = 1) checks saturation after every row and keeps the
// kernel at 31 registers, so more warps are resident to hide that latency.

#include "bitrow.cuh"

namespace {

// gathered rows a lane keeps in flight (bitrow.cuh gather_span)
constexpr int kBatch = 1;

template <typename V>
__global__ void __launch_bounds__(hg::kThreads)
gather_or_kernel(const V* values, const int* __restrict__ idx, V* out, long long n_out,
                 int w, int nvec, int vec_per_line, const uint32_t* mask,
                 uint32_t* out_mask, long long mask_row0, int pbits) {
  const long long row =
      static_cast<long long>(blockIdx.x) * hg::kWarpsPerBlock + (threadIdx.x / hg::kWarp);
  if (row >= n_out) return;  // whole warps: the row is per warp
  const int lane = threadIdx.x % hg::kWarp;
  uint32_t field = 0u;
  for (int v0 = 0; v0 < nvec; v0 += hg::kWarp) {
    const int v = v0 + lane;
    const bool active = v < nvec;
    const int line = v / vec_per_line;
    V acc;
    hg::set_zero(acc);
    hg::gather_span<kBatch>(values, idx, row * w, row * w + w, -1, mask, pbits, nvec, v,
                            active, line, lane, acc);
    const bool nz = active && hg::any_set(acc);
    field |= __reduce_or_sync(hg::kFull, nz ? (1u << line) : 0u);
    if (nz) out[row * nvec + v] = acc;
  }
  if (lane == 0) hg::emit_field(out_mask, mask_row0 + row, pbits, field);
}

}  // namespace

// values: (S, kw) int32 rows; idx: (n_out * w,) int32; out: (n_out, kw)
// int32, holding a subset of the result. `values` and `out` may be sections
// of one buffer (the upper levels of a reduction pyramid read the level
// below and write the next section) as long as no gathered row lies in the
// output section. mask: the line
// mask of values (null: every line live); out_mask: the line mask of the
// buffer out lies in, with out's row c at mask row mask_row0 + c (null:
// none is written); line_words and pbits its geometry (ops/linemask.py).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int hg_gather_or(const void* values, const void* idx, void* out,
                            long long n_out, int w, int kw, const void* mask,
                            void* out_mask, long long mask_row0, int line_words,
                            int pbits, void* stream) {
  if (n_out <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned grid = hg::grid_for_warps(n_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const uint32_t* m = static_cast<const uint32_t*>(mask);
  uint32_t* om = static_cast<uint32_t*>(out_mask);
  if (kw % 4 == 0 && line_words % 4 == 0 && hg::aligned16(values) && hg::aligned16(out)) {
    gather_or_kernel<uint4><<<grid, hg::kThreads, 0, s>>>(
        static_cast<const uint4*>(values), ix, static_cast<uint4*>(out), n_out, w,
        kw / 4, line_words / 4, m, om, mask_row0, pbits);
  } else {
    gather_or_kernel<uint32_t><<<grid, hg::kThreads, 0, s>>>(
        static_cast<const uint32_t*>(values), ix, static_cast<uint32_t*>(out), n_out,
        w, kw, line_words, m, om, mask_row0, pbits);
  }
  return static_cast<int>(cudaGetLastError());
}
