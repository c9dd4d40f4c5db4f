// attn_tile.cuh: the tensor-core attention tile shared by flash_prefill.cu
// and flash_prefill_paged.cu (bf16, head_dim 64, 128 or 256, sm_90a).
//
// One warpgroup (128 threads) owns a tile of 64 query rows, the M of
// Hopper's `wgmma`. Per tile of 64 keys it
//   (1) computes S = Q K^T with `wgmma.mma_async m64n64k16` from shared
//       memory (Q and the K tile in bf16, 128-byte swizzled, K-major),
//       accumulating in fp32 registers, and multiplies by `scale` (q stays
//       bf16 unscaled: the product of two bf16 values is exact in fp32);
//   (2) applies the softcap, then the mask, then the online softmax, all in
//       registers: a row's max is reduced across the four threads of a quad
//       that hold it (shuffles), the denominator is kept per thread and
//       reduced once at the end;
//   (3) accumulates O += P V with the accumulator fragment of (1) reused as
//       the register A operand of a second `wgmma` (V is the shared-memory
//       B operand, MN-major, transposed by its descriptor). P is split into
//       a bf16 high part and a bf16 low part (P - hi rounded), each given
//       its own `wgmma`: rounding P to bf16 alone moves results past the
//       main-shape tolerances (tests/test_torch_kernels.py shows it on the
//       CPU), the pair keeps P to about 2^-17.
// The fragment layouts are PTX's for m64nNk16: thread t of the warpgroup
// (warp w = t / 32, lane l) holds rows 16 w + l / 4 and 16 w + l / 4 + 8;
// accumulator register i sits in column 8 (i / 4) + 2 (l % 4) + (i % 2) of
// row (i / 2) % 2; the A fragment of k-step j (keys 16 j .. 16 j + 15) is
// registers 8 j .. 8 j + 7 of the accumulator, packed in pairs.
//
// Shared-memory operand layout: a 64-row bf16 tile of D columns is D / 64
// chunks of [64 rows][128 bytes], each 1024-byte aligned, with the 128-byte
// swizzle of TMA's CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte vector v of row r
// sits at r * 128 + ((v ^ (r % 8)) * 16). The `wgmma` descriptors describe
// exactly that layout (K-major: stride 1024 bytes between 8-row groups, a
// k-step of 16 columns advances the start by 32 bytes inside the swizzled
// row; MN-major V: stride 1024 bytes between groups of 8 keys, a k-step of
// 16 keys advances by 2048 bytes).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_tile {

constexpr int ROWS = 64;            // query rows per warpgroup (wgmma M)
constexpr int KEYS = 64;            // keys per tile
constexpr int CHUNK = ROWS * 128;   // bytes of one [64][64] bf16 chunk
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// bytes of a 64-row bf16 tile of D columns
template <int D>
struct Tile {
  static_assert(D % 64 == 0, "the tensor-core tile takes D = 64, 128, 256");
  static constexpr int bytes = D * 128;
};

// ring depth: two tiles in flight behind the one computing where the
// shared memory allows it
template <int D>
struct Stages {
  static constexpr int value = D <= 128 ? 3 : 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// byte offset of 16-byte vector `vec` (of D / 8) of row `row` in a tile
__device__ __forceinline__ uint32_t swizzled(int row, int vec) {
  return (uint32_t)((vec >> 3) * CHUNK + row * 128 +
                    (((vec & 7) ^ (row & 7)) << 4));
}

// --- wgmma ----------------------------------------------------------------

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) |
         ((uint64_t)1 << 62);       // 128-byte swizzle
}

// K-major operand (Q or K): k-step kk of 16 columns
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return desc(tile + (kk >> 2) * CHUNK + (kk & 3) * 32, 16, 1024);
}

// MN-major operand (V): 64 columns of chunk c, keys 16 j .. 16 j + 15. The
// stride between groups of 8 keys is 1024 bytes; with N = 64 the operand is
// one swizzle atom wide, so the stride between atoms along N is never used
// and is given the same value.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int c, int j) {
  return desc(tile + c * CHUNK + j * 2048, 1024, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator registers across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64, fp32) (+)= A (shared, K-major) * B (shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) += A (registers, 64 x 16 bf16) * B (shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// --- copies and barriers --------------------------------------------------

// make generic-proxy writes to shared memory (st.shared, cp.async) visible
// to the async proxy (wgmma operand reads); each writing thread, before the
// barrier that publishes the data
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes global -> shared, zero-filled when `bytes` is 0 (nothing read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one TMA box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// --- the tile ---------------------------------------------------------------

// 64 query rows of bf16 (row_ptr(r): row r's first element, or nullptr for a
// row past the end, stored as zeros) into a swizzled tile, by the 128 threads
// of one warpgroup (t = thread index within it), 16 bytes each
template <int D, typename RowPtr>
__device__ __forceinline__ void load_rows(unsigned char* tile, int t,
                                          RowPtr row_ptr) {
  constexpr int VPR = D / 8;
#pragma unroll 4
  for (int idx = t; idx < ROWS * VPR; idx += 128) {
    const int r = idx / VPR, vec = idx % VPR;
    const __nv_bfloat16* src = row_ptr(r);
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (src) x = *reinterpret_cast<const uint4*>(src + vec * 8);
    *reinterpret_cast<uint4*>(tile + swizzled(r, vec)) = x;
  }
}

// tanh(x / cap) * cap as (1 - 2 / (2^(x * k) + 1)) * cap, k = 2 log2(e) /
// cap: one exp2 and one fast division where tanhf takes some twenty
// instructions. Its absolute error before the cap, ~1e-7 near 0, moves a
// score by ~1e-5 at cap 50, far below a bf16 step of the output; large
// |x| saturates to +-cap (2^(x k) = inf gives 2 / inf = 0).
__device__ __forceinline__ float soft_cap(float x, float k, float cap) {
  return (1.f - __fdividef(2.f, exp2f(x * k) + 1.f)) * cap;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The running state of one thread's two rows: the O accumulator (one
// m64n64 fragment per 64 columns), the running max (the same in all four
// threads of a quad) and this thread's share of the denominator.
template <int D>
struct RowState {
  float o[D / 64][32];
  float m[2];
  float l[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    m[0] = m[1] = NEG;
    l[0] = l[1] = 0.f;
  }

  // one tile of 64 keys, the first at position key0. q, k, v: shared
  // addresses of this warpgroup's Q tile and the stage's K and V tiles.
  // MASK: vis(key, h) says whether key position `key` is visible to this
  // thread's row h (0 or 1); without MASK every key is.
  template <bool MASK, typename Vis>
  __device__ __forceinline__ void step(uint32_t q, uint32_t k, uint32_t v,
                                       int key0, float scale, float softcap,
                                       Vis vis) {
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, kmajor(q, kk), kmajor(k, kk), kk > 0 ? 1 : 0);
    wg_commit();
    wg_wait0();
    fence_regs(s);

    const int qd = threadIdx.x & 3;
    const float cap_k = softcap > 0.f ? 2.f * LOG2E / softcap : 0.f;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale;
      if (softcap > 0.f) x = soft_cap(x, cap_k, softcap);
      if (MASK) {
        const int key = key0 + 8 * (i >> 2) + 2 * qd + (i & 1);
        if (!vis(key, (i >> 1) & 1)) x = NEG;
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = exp2f((m[h] - mx[h]) * LOG2E);
      m[h] = mx[h];
    }
    // P as a bf16 hi/lo pair, in the A-fragment layout of k-step j
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1;
      float p0 = exp2f((s[i] - mx[h]) * LOG2E);
      float p1 = exp2f((s[i + 1] - mx[h]) * LOG2E);
      if (MASK) {
        if (s[i] <= NEG) p0 = 0.f;
        if (s[i + 1] <= NEG) p1 = 0.f;
      }
      sum[h] += p0 + p1;
      const __nv_bfloat162 ph = __floats2bfloat162_rn(p0, p1);
      const float2 back = __bfloat1622float2(ph);
      hi[i >> 3][(i >> 1) & 3] = *reinterpret_cast<const uint32_t*>(&ph);
      lo[i >> 3][(i >> 1) & 3] = pack_bf16(p0 - back.x, p1 - back.y);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i >> 1) & 1];
      fence_regs(o[c]);
    }

    wg_fence();
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wgmma_rs(o[c], hi[j], mnmajor(v, c, j));
        wgmma_rs(o[c], lo[j], mnmajor(v, c, j));
      }
    }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int c = 0; c < D / 64; ++c) fence_regs(o[c]);
  }

  // after the last tile: the denominator summed over the quad
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
  }

  // O / l rounded once to bf16 (0 where l is 0); out(h): row h's first
  // element, or nullptr for a row past the end
  template <typename Out>
  __device__ __forceinline__ void store(Out out) const {
    const int qd = threadIdx.x & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      __nv_bfloat16* row = out(h);
      if (!row) continue;
      const bool live = l[h] > 0.f;
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int i = 4 * n + 2 * h;
          const float a = live ? o[c][i] / l[h] : 0.f;
          const float b = live ? o[c][i + 1] / l[h] : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(row + 64 * c + 8 * n + 2 * qd) =
              __floats2bfloat162_rn(a, b);
        }
    }
  }

  // the unnormalised partial O (fp32) of row h, its max and its
  // denominator, for one part of a split key range
  __device__ __forceinline__ void store_part(int h, float* row, float* m_out,
                                             float* l_out) const {
    const int qd = threadIdx.x & 3;
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int i = 4 * n + 2 * h;
        *reinterpret_cast<float2*>(row + 64 * c + 8 * n + 2 * qd) =
            make_float2(o[c][i], o[c][i + 1]);
      }
    if (qd == 0) {
      *m_out = m[h];
      *l_out = l[h];
    }
  }
};

}  // namespace attn_tile
