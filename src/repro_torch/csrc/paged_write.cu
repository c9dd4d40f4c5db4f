// paged_write: scatter freshly prefilled K/V rows into their pool pages.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_write.py:paged_write
// (kernel body `_kernel`). The Pallas grid walked (batch, page) with the
// block table in scalar prefetch and kept the page axis sequential in case
// two grid points aliased one pool page. Here every (b, j < n_valid[b])
// page is one thread block, and blocks run in parallel in no order; the
// Python wrapper checks on the host that the valid target pages are unique,
// so no two blocks ever write one page.
//
// Bound: bytes. The kernel reads each new row once and writes it once; it
// does no arithmetic. The design copies 16-byte vectors (uint4), neighbouring
// threads on neighbouring addresses, so every warp moves 512 contiguous
// bytes per instruction. The copy is bit-exact and dtype-agnostic.
//
// Layout: new_k/new_v are (B, npages * page, Hkv, D) contiguous, so page j
// of request b starts (b * npages + j) * page_bytes bytes in; pool page p
// starts p * page_bytes bytes into k_pages/v_pages. Offsets are 64-bit: the
// caller folds a stacked layer axis into the pool (n_full * P pages), which
// exceeds 2^31 bytes at full model width.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void paged_write_kernel(const uint4* __restrict__ new_k,
                                   const uint4* __restrict__ new_v,
                                   uint4* __restrict__ k_pages,
                                   uint4* __restrict__ v_pages,
                                   const int* __restrict__ block_tables,
                                   const int* __restrict__ n_valid,
                                   int npages, long long vecs_per_page) {
  const int b = blockIdx.y;
  const int j = blockIdx.x;
  if (j >= n_valid[b]) return;           // page not owned: keep pool contents
  const long long dst = (long long)block_tables[(long long)b * npages + j]
                        * vecs_per_page;
  const long long src = ((long long)b * npages + j) * vecs_per_page;
  for (long long i = threadIdx.x; i < vecs_per_page; i += blockDim.x) {
    k_pages[dst + i] = new_k[src + i];
    v_pages[dst + i] = new_v[src + i];
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int paged_write_launch(const void* new_k, const void* new_v,
                                  void* k_pages, void* v_pages,
                                  const void* block_tables,
                                  const void* n_valid, int B, int npages,
                                  long long page_bytes, void* stream) {
  if (B <= 0 || npages <= 0) return 0;
  const long long vecs = page_bytes / 16;
  dim3 grid(npages, B);
  paged_write_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint4*)new_k, (const uint4*)new_v, (uint4*)k_pages,
      (uint4*)v_pages, (const int*)block_tables, (const int*)n_valid, npages,
      vecs);
  return (int)cudaGetLastError();
}
