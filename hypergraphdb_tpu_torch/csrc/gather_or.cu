// K1, gather-OR: out[c] = OR_{j<w} values[idx[c*w + j]] over rows of kw
// 32-bit words.
//
// Replaces the Pallas kernel hypergraphdb_tpu/ops/pallas_gather.py (_kernel,
// launched by _call / gather_or). The TPU version streamed rows through D
// DMA slots and cut the index array into SMEM-sized segments; none of that
// carries over. Here one warp owns one output row: each lane holds 16 bytes
// (one uint4) of the row, so a 512-byte row (kw = 128, a 4096-seed block)
// is one load per lane per gathered row. The w gathered rows are
// independent loads, unrolled so they are in flight together, and the row
// is stored once.
//
// Bound on the card: bytes. Every gathered row is a random 16-byte-per-lane
// read of kw*4 bytes; there is one OR per word and no reuse to exploit
// beyond what the L2 catches of repeated rows.

#include "bitrow.cuh"

namespace {

template <typename V>
__global__ void __launch_bounds__(hg::kThreads)
gather_or_kernel(const V* values, const int* __restrict__ idx, V* out,
                 long long n_out, int w, int nvec) {
  const long long row =
      static_cast<long long>(blockIdx.x) * hg::kWarpsPerBlock + (threadIdx.x / hg::kWarp);
  if (row >= n_out) return;
  const int lane = threadIdx.x % hg::kWarp;
  const int* ix = idx + row * w;
  for (int v = lane; v < nvec; v += hg::kWarp) {
    V acc;
    hg::set_zero(acc);
#pragma unroll 8
    for (int j = 0; j < w; ++j) {
      const long long src = __ldg(ix + j);
      hg::or_into(acc, hg::load_ro(values + src * nvec + v));
    }
    out[row * nvec + v] = acc;
  }
}

}  // namespace

// values: (S, kw) int32 rows; idx: (n_out * w,) int32; out: (n_out, kw)
// int32. `values` and `out` may be sections of one buffer (the upper levels
// of a reduction pyramid read the level below and write the next section)
// as long as no gathered row lies in the output section. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int hg_gather_or(const void* values, const void* idx, void* out,
                            long long n_out, int w, int kw, void* stream) {
  if (n_out <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned grid = hg::grid_for_warps(n_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kw % 4 == 0 && hg::aligned16(values) && hg::aligned16(out)) {
    gather_or_kernel<uint4><<<grid, hg::kThreads, 0, s>>>(
        static_cast<const uint4*>(values), static_cast<const int*>(idx),
        static_cast<uint4*>(out), n_out, w, kw / 4);
  } else {
    gather_or_kernel<uint32_t><<<grid, hg::kThreads, 0, s>>>(
        static_cast<const uint32_t*>(values), static_cast<const int*>(idx),
        static_cast<uint32_t*>(out), n_out, w, kw);
  }
  return static_cast<int>(cudaGetLastError());
}
