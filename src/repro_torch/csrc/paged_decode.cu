// paged_decode: single-token GQA attention over the paged KV pool.
//
// Replaces the Pallas TPU kernel
// repro/kernels/paged_decode.py:paged_decode_attention (kernel body
// `_kernel`). Contract: q (B, Hq, D); k/v pages (P, page, Hkv, D); block
// tables (B, npages) int32; lengths (B,) int32. Keys at positions
// >= lengths[b] are masked; an optional tanh softcap applies to the scores;
// the softmax is online with fp32 accumulators. Output (B, Hq, D) in q's
// dtype.
//
// Layout: one thread block of 128 threads per (b, kv_head). The block
// loads its own block-table entries and length (the Pallas version had them
// in scalar prefetch) and packs the whole query group (G = Hq / Hkv rows)
// together, so every K/V row is read from device memory once per group, as
// on the TPU. A loop over tiles of 128 tokens replaces the sequential
// Pallas grid axis over pages; the loop ends at the sequence's length, so
// pages past it (padded block-table columns point at sentinel page 0) are
// never touched. One token's row for one head sits at stride Hkv * D inside
// a page; a tile may span several pages.
//
// Per tile: (1) each thread scores one token: it looks up the token's page,
// reads the K row with 16-byte loads and takes the G dot products against
// the query group held in shared memory (every thread reads the same query
// element at once: a broadcast); (2) one warp per query row updates the
// running max and denominator and turns the scores into probabilities;
// (3) p @ V: D / EPV threads cover one V row with 16-byte loads (EPV = 8
// bf16 or 4 fp32 elements each), so 128 threads read 128 * EPV / D rows at
// once; each thread keeps G x EPV partial sums over its rows, and the row
// slots are summed in a fixed order after the last tile.
//
// Bound: bytes. Per call the kernel must read the live K/V,
// B * L * Hkv * D * 2 * itemsize, plus q and o; its arithmetic is about
// 4 * Hq * D flops per key, far below the card's ridge. The design reads
// each K/V row once per query group, keeps scores and accumulators on chip,
// and issues a whole tile's K loads at once. Left for later: split-KV
// (flash-decoding) across blocks, since B * Hkv blocks underfill the 132
// SMs at small batch, and TMA/wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;          // threads per block = tokens per tile
constexpr int NW = NT / 32;      // warps per block
constexpr int MAXG = 8;          // query heads per kv head
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// 16 bytes of a row -> floats (4 fp32 or 8 bf16 elements)
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ lengths, T* __restrict__ out, int Hkv, int G,
    int page, int npages, float scale, float softcap) {
  constexpr int EPV = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int TPR = D / EPV;          // threads per V row in p @ V
  constexpr int RPI = NT / TPR;         // V rows read at once (row slots)
  __shared__ float q_s[MAXG][D];
  __shared__ float p_s[MAXG][NT];
  __shared__ long long off_s[NT];       // row offset of each tile token
  __shared__ float m_s[MAXG], l_s[MAXG], c_s[MAXG];
  __shared__ float acc_s[MAXG][D];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Hq = Hkv * G;
  const long long row = (long long)Hkv * D;

  // the query group (heads h*G .. h*G+G-1 are contiguous), scaled in fp32
  // (the reference's q.float() * scale)
  const T* qg = q + ((long long)b * Hq + (long long)h * G) * D;
  for (int i = tid; i < G * D; i += NT) q_s[i / D][i % D] = to_f(qg[i]) * scale;
  if (tid < G) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  for (int i = tid; i < MAXG * D; i += NT) acc_s[i / D][i % D] = 0.f;
  float acc[MAXG][EPV];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < EPV; ++e) acc[g][e] = 0.f;
  __syncthreads();

  int len = lengths[b];
  if (len > npages * page) len = npages * page;
  const int slot = tid / TPR;           // row slot in p @ V
  const int col = (tid % TPR) * EPV;     // first of this thread's columns
  const int* bt = block_tables + (long long)b * npages;

  for (int t0 = 0; t0 < len; t0 += NT) {
    // (1) scores: one token per thread
    const int t = t0 + tid;
    float s[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
    if (t < len) {
      const int j = t / page;
      const long long off =
          ((long long)bt[j] * page + (t - j * page)) * row + (long long)h * D;
      off_s[tid] = off;
      const T* kr = k_pages + off;
#pragma unroll
      for (int e = 0; e < D; e += EPV) {
        float f[EPV];
        load16(kr + e, f);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
#pragma unroll
            for (int i = 0; i < EPV; ++i) s[g] += q_s[g][e + i] * f[i];
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        float v = s[g];
        if (softcap > 0.f) v = tanhf(v / softcap) * softcap;
        p_s[g][tid] = (t < len) ? v : NEG;
      }
    }
    __syncthreads();

    // (2) online softmax, one warp per query row
    for (int g = warp; g < G; g += NW) {
      float v[NT / 32];
      float mx = NEG;
#pragma unroll
      for (int k = 0; k < NT / 32; ++k) {
        v[k] = p_s[g][lane + 32 * k];
        mx = fmaxf(mx, v[k]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < NT / 32; ++k) {
        const int idx = lane + 32 * k;
        const float e = (t0 + idx < len) ? expf(v[k] - m_new) : 0.f;
        p_s[g][idx] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        l_s[g] = l_s[g] * c + sum;
        m_s[g] = m_new;
        c_s[g] = c;
      }
    }
    __syncthreads();

    // (3) p @ V: rows slot, slot + RPI, ...; columns col .. col + EPV
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const float c = c_s[g];
#pragma unroll
        for (int e = 0; e < EPV; ++e) acc[g][e] *= c;
      }
    }
    const int n = min(NT, len - t0);
#pragma unroll 4
    for (int i = slot; i < n; i += RPI) {
      float f[EPV];
      load16(v_pages + off_s[i] + col, f);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float p = p_s[g][i];
#pragma unroll
          for (int e = 0; e < EPV; ++e) acc[g][e] += p * f[e];
        }
      }
    }
    __syncthreads();  // p_s and off_s are rewritten by the next tile
  }

  // sum the row slots in a fixed order, then normalize
  for (int r = 0; r < RPI; ++r) {
    if (slot == r) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g)  // unrolled: acc stays in registers
        if (g < G)
#pragma unroll
          for (int e = 0; e < EPV; ++e) acc_s[g][col + e] += acc[g][e];
    }
    __syncthreads();
  }
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D;
    out[((long long)b * Hq + (long long)h * G + g) * D + (i % D)] =
        from_f<T>(acc_s[g][i % D] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T>
void launch(int D, dim3 grid, cudaStream_t st, const void* q,
            const void* kp, const void* vp, const void* bt, const void* ln,
            void* out, int Hkv, int G, int page, int npages, float scale,
            float softcap) {
  const T* qq = (const T*)q;
  const T* kk = (const T*)kp;
  const T* vv = (const T*)vp;
  const int* bb = (const int*)bt;
  const int* ll = (const int*)ln;
  T* oo = (T*)out;
  if (D == 32)
    paged_decode_kernel<T, 32><<<grid, NT, 0, st>>>(
        qq, kk, vv, bb, ll, oo, Hkv, G, page, npages, scale, softcap);
  else if (D == 64)
    paged_decode_kernel<T, 64><<<grid, NT, 0, st>>>(
        qq, kk, vv, bb, ll, oo, Hkv, G, page, npages, scale, softcap);
  else
    paged_decode_kernel<T, 128><<<grid, NT, 0, st>>>(
        qq, kk, vv, bb, ll, oo, Hkv, G, page, npages, scale, softcap);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernel was not instantiated for.
extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages,
                                   const void* block_tables,
                                   const void* lengths, void* out, int B,
                                   int Hq, int Hkv, int D, int page,
                                   int npages, float scale, float softcap,
                                   int is_bf16, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > MAXG || page <= 0 ||
      (D != 32 && D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int G = Hq / Hkv;
  dim3 grid(B, Hkv);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    launch<__nv_bfloat16>(D, grid, st, q, k_pages, v_pages, block_tables,
                          lengths, out, Hkv, G, page, npages, scale, softcap);
  else
    launch<float>(D, grid, st, q, k_pages, v_pages, block_tables, lengths,
                  out, Hkv, G, page, npages, scale, softcap);
  return (int)cudaGetLastError();
}
