// merge_splits.cuh: the merge of a key range split into parts, shared by
// flash_prefill_paged.cu and paged_decode.cu (flash-decoding's second pass).
//
// Each part of a split writes, per output row, its unnormalised fp32 output
// (the sum of exp(s - m) v over the keys it saw), its running max m (-1e30
// where it saw no key) and its denominator l. The merge rounds
//   out[row] = sum_p w_p o_p / sum_p w_p l_p,  w_p = exp(m_p - max_p m_p)
// to bf16 once, and writes 0 where the denominator is 0 (a row that saw no
// key in any part). kernels/ref.py:ref_merge_splits is its plain version.
//
// Layout: part_o (nsplit, n_rows, D), part_ml (2, nsplit, n_rows) (maxima,
// then denominators), out (n_rows, D), all contiguous; one warp per row.
//
// The kernel is a template on a tag type that names its caller, so a
// profiler trace tells the two instantiations apart by name
// (launch/profile.py:_kernel_class); the tag changes nothing else.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace merge_splits {

constexpr int MAX_SPLITS = 16;      // parts of a split key range

template <typename Caller>
__global__ void __launch_bounds__(128) merge_splits_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    __nv_bfloat16* __restrict__ out, int nsplit, long long n_rows, int D) {
  const long long row = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const float* pm = part_ml;
  const float* pl = part_ml + (long long)nsplit * n_rows;
  float mx = -1e30f;
  for (int p = 0; p < nsplit; ++p) mx = fmaxf(mx, pm[p * n_rows + row]);
  float w[MAX_SPLITS];
  float den = 0.f;
#pragma unroll
  for (int p = 0; p < MAX_SPLITS; ++p) {
    w[p] = p < nsplit ? expf(pm[p * n_rows + row] - mx) : 0.f;
    if (p < nsplit) den += w[p] * pl[p * n_rows + row];
  }
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
#pragma unroll
    for (int p = 0; p < MAX_SPLITS; ++p)
      if (p < nsplit) acc += w[p] * part_o[(p * n_rows + row) * D + d];
    out[row * D + d] = __float2bfloat16(den > 0.f ? acc / den : 0.f);
  }
}

// launches the merge of n_rows rows on stream st; returns the launch error
template <typename Caller>
cudaError_t launch(cudaStream_t st, const float* part_o, const float* part_ml,
                   __nv_bfloat16* out, int nsplit, long long n_rows, int D) {
  merge_splits_kernel<Caller><<<(unsigned)((n_rows + 3) / 4), 128, 0, st>>>(
      part_o, part_ml, out, nsplit, n_rows, D);
  return cudaGetLastError();
}

}  // namespace merge_splits
