// paged_decode: single-token GQA attention over the paged KV pool.
//
// Replaces the Pallas TPU kernel
// repro/kernels/paged_decode.py:paged_decode_attention (kernel body
// `_kernel`). Contract: q (B, Hq, D); k/v pages (P, page, Hkv, D); block
// tables (B, npages) int32; lengths (B,) int32, clamped to npages * page.
// Keys at positions >= lengths[b] are masked and never read, so pages past
// the length (padded block-table columns point at sentinel page 0) stay
// untouched; an optional tanh softcap applies to the scores; the softmax is
// online with fp32 accumulators. Output (B, Hq, D) in q's dtype.
//
// Bound: bytes. A call must read each live K and V row once, B * L * Hkv *
// D * 2 * itemsize, plus q and o; it does about 4 * G * D flops per key and
// kv head, G flops a byte in bf16 (G = Hq / Hkv <= 16), far below the card's
// ridge of ~295. So the design's job is to keep enough bytes in flight on
// every SM; the tensor cores only take the query group's arithmetic and
// shared-memory reads off the critical path.
//
// bf16 at head_dim 64, 128 and 256 (paged_decode_tc_kernel):
//   - Split over keys (flash-decoding). The grid is (B, Hkv, nsplit); part p
//     of sequence b takes the key tiles [p * nt / n, (p + 1) * nt / n) of
//     its nt = ceil(len / 64) tiles, computed here from lengths[b], so the
//     host never reads the lengths back. The wrapper picks n from shapes
//     alone (kernels/paged_decode.py:choose_splits: a block for every SM,
//     in one wave). With n > 1 each part writes its unnormalised fp32 output,
//     max and denominator to scratch and merge_splits.cuh's kernel combines
//     them; a part that sees no key writes (-1e30, 0, 0). With n = 1 the
//     kernel writes bf16 itself and nothing is merged.
//   - Four warps, each its own pipeline: a key tile is 64 keys, and warp w
//     gathers and consumes the 16-key chunk w of each tile of its part.
//     Each lane first fetches the pool row of one key of the warp's next
//     chunk from the block table (one chunk ahead, so the table read hides
//     behind the compute); the chunk's K and V rows are then gathered with
//     16-byte cp.async.cg, neighbouring lanes on neighbouring 16-byte pieces
//     of one row (a D = 128 row is 16 pieces: one instruction covers two
//     rows), into a per-warp ring of 3 stages (2 at D = 256), so the next
//     two chunks are in flight while one computes. Keys past the part's end
//     are zero-filled (src-size 0), never read. No block barrier inside the
//     key loop: a warp waits only for its own copies (cp.async.wait_group,
//     __syncwarp). Shared rows are swizzled (16-byte piece v of row r at
//     v ^ (r mod 8)), so every ldmatrix is free of bank conflicts.
//     TMA is not used: one box per 16-key page and a map per call cost
//     more than they save for 256-byte rows.
//   - Products on mma.sync m16n8k16 (bf16 in, fp32 accumulate). The query
//     group's G rows are M, padded to 16 with zero rows (4 of 16 used for
//     Llama-3.1-8B, all 16 for chatglm3-6b); q is loaded once per block,
//     bf16 and unscaled, into a swizzled shared tile, and the fp32 score
//     accumulator is multiplied by `scale` (q * scale is never rounded to
//     bf16). S = Q K^T takes Q and K through ldmatrix; O += P V takes V
//     through ldmatrix.trans and P straight from the score accumulator's
//     registers, as a bf16 hi/lo pair (hi = bf16(P), lo = bf16(P - hi),
//     one mma each): P rounded to bf16 alone moves rows that see a few
//     dozen keys or fewer past the main-shape tolerance
//     (tests/test_torch_kernels.py shows it on the CPU); the second product
//     costs nothing a kernel bound by bytes would notice. The keys could
//     instead sit in M and the group in N = 8, but the score accumulator
//     would then not be the A operand of P V; wgmma's 64-row M would be 94%
//     padding at G = 4, and the kernel is bound by bytes, not by the tensor
//     cores.
//   - Softmax in registers: attn_tile.cuh's soft_cap, then the mask, then
//     the online max, denominator and rescale, the max reduced across the
//     four lanes of a quad. No score goes to shared memory. Each warp keeps
//     its own (m, l, O); the four are combined once per part, through
//     shared memory, behind the kernel's one block barrier.
//
// fp32 at every head_dim, and bf16 at head_dim 16 and 32, keep the
// CUDA-core kernel (paged_decode_kernel: 2e-5 cannot be held on bf16
// tensor cores, and the toy configs are fp32 at head_dim 16 and 32): one
// block of 128 threads per (b, kv_head), the whole query group (up to 16
// rows, in a group bucket GB of 8 or 16) packed together so every K/V row is
// read once per group. Per tile of 128 tokens: (1) each thread scores one
// token, reading its K row with 16-byte loads against the query group in
// shared memory; (2) one warp per query row updates the running max and
// denominator and turns the scores into probabilities; (3) p @ V: D / EPV
// threads cover one V row with 16-byte loads (EPV = 8 bf16 or 4 fp32
// elements each), each thread keeping G x EPV partial sums over its rows,
// summed across row slots in a fixed order after the last tile.
//
// The dispatch is by dtype and head_dim inside the C entry point; a launch
// that fails returns its error and is never retried on the other kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tile.cuh"
#include "merge_splits.cuh"

namespace {


constexpr int NT = 128;          // threads per block = tokens per tile
constexpr int NW = NT / 32;      // warps per block
constexpr int MAXG = 16;         // query heads per kv head
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

// GB: the group bucket (G <= GB). Static shared memory at GB = 16, D = 256:
// 16 KB each for q_s and acc_s, 8 KB for p_s, within the 48 KB limit.
template <typename T, int D, int GB>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ lengths, T* __restrict__ out, int Hkv, int G,
    int page, int npages, float scale, float softcap) {
  constexpr int EPV = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int TPR = D / EPV;          // threads per V row in p @ V
  constexpr int RPI = NT / TPR;         // V rows read at once (row slots)
  __shared__ float q_s[GB][D];
  __shared__ float p_s[GB][NT];
  __shared__ long long off_s[NT];       // row offset of each tile token
  __shared__ float m_s[GB], l_s[GB], c_s[GB];
  __shared__ float acc_s[GB][D];

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
  for (int i = tid; i < GB * D; i += NT) acc_s[i / D][i % D] = 0.f;
  float acc[GB][EPV];
#pragma unroll
  for (int g = 0; g < GB; ++g)
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
    float s[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) s[g] = 0.f;
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
        for (int g = 0; g < GB; ++g) {
          if (g < G) {
#pragma unroll
            for (int i = 0; i < EPV; ++i) s[g] += q_s[g][e + i] * f[i];
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
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
    for (int g = 0; g < GB; ++g) {
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
      for (int g = 0; g < GB; ++g) {
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
      for (int g = 0; g < GB; ++g)  // unrolled: acc stays in registers
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

template <typename T, int GB>
void launch_g(int D, dim3 grid, cudaStream_t st, const T* q, const T* kp,
              const T* vp, const int* bt, const int* ln, T* out, int Hkv,
              int G, int page, int npages, float scale, float softcap) {
  if (D == 16)
    paged_decode_kernel<T, 16, GB><<<grid, NT, 0, st>>>(
        q, kp, vp, bt, ln, out, Hkv, G, page, npages, scale, softcap);
  else if (D == 32)
    paged_decode_kernel<T, 32, GB><<<grid, NT, 0, st>>>(
        q, kp, vp, bt, ln, out, Hkv, G, page, npages, scale, softcap);
  else if constexpr (sizeof(T) == 4) {  // bf16 at D >= 64: tensor cores
    if (D == 64)
      paged_decode_kernel<T, 64, GB><<<grid, NT, 0, st>>>(
          q, kp, vp, bt, ln, out, Hkv, G, page, npages, scale, softcap);
    else if (D == 128)
      paged_decode_kernel<T, 128, GB><<<grid, NT, 0, st>>>(
          q, kp, vp, bt, ln, out, Hkv, G, page, npages, scale, softcap);
    else
      paged_decode_kernel<T, 256, GB><<<grid, NT, 0, st>>>(
          q, kp, vp, bt, ln, out, Hkv, G, page, npages, scale, softcap);
  }
}

template <typename T>
void launch_core(int D, dim3 grid, cudaStream_t st, const void* q,
                 const void* kp, const void* vp, const void* bt,
                 const void* ln, void* out, int Hkv, int G, int page,
                 int npages, float scale, float softcap) {
  const T* qq = (const T*)q;
  const T* kk = (const T*)kp;
  const T* vv = (const T*)vp;
  const int* bb = (const int*)bt;
  const int* ll = (const int*)ln;
  T* oo = (T*)out;
  if (G <= 8)
    launch_g<T, 8>(D, grid, st, qq, kk, vv, bb, ll, oo, Hkv, G, page, npages,
                   scale, softcap);
  else
    launch_g<T, 16>(D, grid, st, qq, kk, vv, bb, ll, oo, Hkv, G, page,
                    npages, scale, softcap);
}

// ----------------------------------------------------------------------
// bf16 at head_dim 64, 128 and 256 on the tensor cores

using merge_splits::MAX_SPLITS;

// names the merge's instantiation for this caller (merge_splits.cuh)
struct paged_decode_merge;

constexpr int WARPS = 4;               // warps per block, one pipeline each
constexpr int CHUNK = 16;              // keys a warp gathers at once
constexpr int KEYS = WARPS * CHUNK;    // keys per tile: the split's unit
constexpr unsigned FULL = 0xffffffffu;

template <int D>
struct TcShape {
  static constexpr int STAGES = D <= 128 ? 3 : 2;  // per-warp ring depth
  static constexpr int ROW = D * 2;                // bytes of a bf16 row
  static constexpr int TILE = CHUNK * ROW;         // 16 K (or V) rows
  static constexpr int RING = STAGES * 2 * TILE;   // one warp's ring
  static constexpr int OST = D + 8;                // o_s row stride, floats
  static_assert(16 * OST * 4 <= RING, "a warp's O fits in its own ring");
  // the 16-row query tile, then the four rings
  static constexpr size_t bytes = 16 * ROW + (size_t)WARPS * RING;
};

// byte offset of 16-byte piece v of row r in a tile of D-wide bf16 rows:
// the piece's low three bits are XORed with r mod 8, so the 8 rows of an
// ldmatrix 8 x 8 matrix land in 8 distinct 16-byte bank groups
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int v) {
  return (uint32_t)(r * (D * 2) + ((v ^ (r & 7)) << 4));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layouts (PTX, m16n8k16): lane l is in quad row gq = l / 4 with
// quad index tq = l % 4. An fp32 accumulator holds (row gq, columns 2 tq,
// 2 tq + 1) in registers 0-1 and row gq + 8 in 2-3. The A operand holds rows
// gq / gq + 8 at k = 2 tq, 2 tq + 1 (registers 0 / 1) and k + 8 (2 / 3), so
// the two accumulators of 8 keys each are, packed in pairs, the A operand
// of the 16 keys' P V. ldmatrix: lane l names row l % 8 of matrix l / 8.
//
// grid (B, Hkv, nsplit); part_o (nsplit, B * Hq, D) and part_ml (2, nsplit,
// B * Hq) are written only when nsplit > 1
template <int D>
__global__ void __launch_bounds__(128) paged_decode_tc_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages,
    const int* __restrict__ block_tables, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part_o,
    float* __restrict__ part_ml, int Hkv, int G, int page, int npages,
    float scale, float softcap) {
  using Sh = TcShape<D>;
  constexpr int STAGES = Sh::STAGES;
  constexpr int VPR = D / 8;            // 16-byte pieces per row
  constexpr int RPI = 32 / VPR;         // rows one warp copy covers: 4, 2, 1
  constexpr int NI = CHUNK / RPI;       // copies per chunk and tensor
  extern __shared__ __align__(128) unsigned char smem_tc[];
  __shared__ float ml_s[2][WARPS][16];  // each warp's row max and sum

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int part = blockIdx.z;
  const int nsplit = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int mi = lane >> 3, r8 = lane & 7;  // ldmatrix: matrix and row
  const int Hq = Hkv * G;
  const long long row_stride = (long long)Hkv * D;
  unsigned char* ring = smem_tc + 16 * Sh::ROW + warp * Sh::RING;
  const uint32_t q_u = attn_tile::smem_u32(smem_tc);
  const uint32_t ring_u = attn_tile::smem_u32(ring);

  // this part's keys [k0, kend): its share of the sequence's key tiles
  const int len = min(lengths[b], npages * page);
  const int nt = (max(len, 0) + KEYS - 1) / KEYS;
  const int k0 = part * nt / nsplit * KEYS;
  const int kend = min((part + 1) * nt / nsplit * KEYS, len);
  // this warp's chunks: c0, c0 + 4, ... below ceil(kend / 16)
  const int c0 = k0 / CHUNK + warp;
  const int c_end = (kend + CHUNK - 1) / CHUNK;
  const int nmine = c_end > c0 ? (c_end - c0 + WARPS - 1) / WARPS : 0;
  const int* bt = block_tables + (long long)b * npages;

  // pool row of key (lane % 16) of this warp's chunk i (0 past the end)
  auto row_of = [&](int i) -> int {
    const int t = (c0 + WARPS * i) * CHUNK + (lane & 15);
    if (i >= nmine || t >= kend) return 0;
    const int j = t / page;
    return bt[j] * page + (t - j * page);
  };
  // chunk i's K and V rows into its stage; `rows` is row_of(i)
  auto issue = [&](int i, int rows) {
    const int key0 = (c0 + WARPS * i) * CHUNK;
    const uint32_t kt = ring_u + (i % STAGES) * 2 * Sh::TILE;
    const uint32_t vt = kt + Sh::TILE;
#pragma unroll
    for (int x = 0; x < NI; ++x) {
      const int r = x * RPI + lane / VPR;
      const int vec = lane % VPR;
      const int row = __shfl_sync(FULL, rows, r);
      const int bytes = key0 + r < kend ? 16 : 0;
      const long long off =
          bytes ? (long long)row * row_stride + (long long)h * D + vec * 8
                : 0;
      const uint32_t at = swz<D>(r, vec);
      attn_tile::cp_async16(kt + at, k_pages + off, bytes);
      attn_tile::cp_async16(vt + at, v_pages + off, bytes);
    }
  };

  int rows = row_of(0);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nmine) {
      issue(s, rows);
      rows = row_of(s + 1);
    }
    attn_tile::cp_async_commit();
  }

  // the query group, zero rows up to 16, while the first chunks load
  const __nv_bfloat16* qg = q + ((long long)b * Hq + (long long)h * G) * D;
  for (int idx = tid; idx < 16 * VPR; idx += 128) {
    const int r = idx / VPR, vec = idx - r * VPR;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < G) x = *reinterpret_cast<const uint4*>(qg + r * D + vec * 8);
    *reinterpret_cast<uint4*>(smem_tc + swz<D>(r, vec)) = x;
  }
  __syncthreads();

  float o[D / 8][4];                    // O, columns 8 j .. 8 j + 7
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {attn_tile::NEG, attn_tile::NEG};  // rows gq, gq + 8
  float l[2] = {0.f, 0.f};              // this lane's share of the sum
  const float cap_k = softcap > 0.f ? 2.f * attn_tile::LOG2E / softcap : 0.f;

  for (int i = 0; i < nmine; ++i) {
    attn_tile::cp_async_wait<STAGES - 2>();  // this lane's copies of i
    __syncwarp();                            // and the warp's; i - 1 done
    if (i + STAGES - 1 < nmine) {
      issue(i + STAGES - 1, rows);
      rows = row_of(i + STAGES);
    }
    attn_tile::cp_async_commit();
    const int key0 = (c0 + WARPS * i) * CHUNK;
    const uint32_t kt = ring_u + (i % STAGES) * 2 * Sh::TILE;
    const uint32_t vt = kt + Sh::TILE;

    // S = Q K^T: 16 rows x 16 keys, two accumulators of 8 keys
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], bk[4];
      ldsm_x4(a, q_u + swz<D>((mi & 1) * 8 + r8, 2 * kk + (mi >> 1)));
      ldsm_x4(bk, kt + swz<D>((mi >> 1) * 8 + r8, 2 * kk + (mi & 1)));
      mma_bf16(s[0], a, bk[0], bk[1]);
      mma_bf16(s[1], a, bk[2], bk[3]);
    }

    // scale, softcap, mask, online softmax; P as the A operand of P V
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (softcap > 0.f) x = attn_tile::soft_cap(x, cap_k, softcap);
        if (key0 + 8 * n + 2 * tq + (e & 1) >= kend) x = attn_tile::NEG;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      corr[r] = exp2f((m[r] - mx[r]) * attn_tile::LOG2E);
      m[r] = mx[r];
    }
    // P as a bf16 hi/lo pair in the A-operand layout of the 16 keys
    uint32_t hi[4], lo[4];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float x0 = s[n][2 * r], x1 = s[n][2 * r + 1];
        const float p0 =
            x0 <= attn_tile::NEG ? 0.f
                                 : exp2f((x0 - mx[r]) * attn_tile::LOG2E);
        const float p1 =
            x1 <= attn_tile::NEG ? 0.f
                                 : exp2f((x1 - mx[r]) * attn_tile::LOG2E);
        sum[r] += p0 + p1;
        const __nv_bfloat162 ph = __floats2bfloat162_rn(p0, p1);
        const float2 back = __bfloat1622float2(ph);
        hi[2 * n + r] = *reinterpret_cast<const uint32_t*>(&ph);
        lo[2 * n + r] = attn_tile::pack_bf16(p0 - back.x, p1 - back.y);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // O += P V: V through ldmatrix.trans, two 8-column tiles at a time
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      uint32_t bv[4];
      ldsm_x4_t(bv, vt + swz<D>((mi & 1) * 8 + r8, 2 * dd + (mi >> 1)));
      mma_bf16(o[2 * dd], hi, bv[0], bv[1]);
      mma_bf16(o[2 * dd], lo, bv[0], bv[1]);
      mma_bf16(o[2 * dd + 1], hi, bv[2], bv[3]);
      mma_bf16(o[2 * dd + 1], lo, bv[2], bv[3]);
    }
  }
  attn_tile::cp_async_wait<0>();
  __syncwarp();                         // the ring is free: O goes there

  // each warp's (m, l, O) to shared memory, O into the warp's own ring
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
  }
  if (tq == 0) {
    ml_s[0][warp][gq] = m[0];
    ml_s[0][warp][gq + 8] = m[1];
    ml_s[1][warp][gq] = l[0];
    ml_s[1][warp][gq + 8] = l[1];
  }
  float* ow = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<float2*>(ow + gq * Sh::OST + 8 * j + 2 * tq) =
        make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(ow + (gq + 8) * Sh::OST + 8 * j + 2 * tq) =
        make_float2(o[j][2], o[j][3]);
  }
  __syncthreads();

  // the four warps combined, row by row, four columns a thread
  const long long n_rows = (long long)gridDim.x * Hq;
  for (int idx = tid; idx < G * (D / 4); idx += 128) {
    const int r = idx / (D / 4), c = 4 * (idx - r * (D / 4));
    float mw = attn_tile::NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mw = fmaxf(mw, ml_s[0][w][r]);
    float den = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float sc = exp2f((ml_s[0][w][r] - mw) * attn_tile::LOG2E);
      den += sc * ml_s[1][w][r];
      const float4 x = *reinterpret_cast<const float4*>(
          reinterpret_cast<const float*>(smem_tc + 16 * Sh::ROW +
                                         w * Sh::RING) +
          r * Sh::OST + c);
      acc.x += sc * x.x;
      acc.y += sc * x.y;
      acc.z += sc * x.z;
      acc.w += sc * x.w;
    }
    const long long row = (long long)b * Hq + (long long)h * G + r;
    if (nsplit == 1) {
      const bool live = den > 0.f;
      __nv_bfloat162 v[2];
      v[0] = __floats2bfloat162_rn(live ? acc.x / den : 0.f,
                                   live ? acc.y / den : 0.f);
      v[1] = __floats2bfloat162_rn(live ? acc.z / den : 0.f,
                                   live ? acc.w / den : 0.f);
      *reinterpret_cast<uint2*>(out + row * D + c) =
          *reinterpret_cast<const uint2*>(v);
    } else {
      const long long at = (long long)part * n_rows + row;
      *reinterpret_cast<float4*>(part_o + at * D + c) = acc;
      if (c == 0) {
        part_ml[at] = mw;
        part_ml[(long long)nsplit * n_rows + at] = den;
      }
    }
  }
}

template <int D>
cudaError_t launch_tc(cudaStream_t st, const void* q, const void* kp,
                      const void* vp, const void* bt, const void* ln,
                      void* out, void* part_o, void* part_ml, int B, int Hkv,
                      int G, int page, int npages, int nsplit, float scale,
                      float softcap) {
  constexpr size_t bytes = TcShape<D>::bytes;
  // per device, so set on every launch (it is cheap); the carveout asks for
  // all of the SM's shared memory, so two blocks fit at D = 128
  cudaError_t e = cudaFuncSetAttribute(
      paged_decode_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(paged_decode_tc_kernel<D>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  dim3 grid(B, Hkv, nsplit);
  paged_decode_tc_kernel<D><<<grid, 128, bytes, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kp,
      (const __nv_bfloat16*)vp, (const int*)bt, (const int*)ln,
      (__nv_bfloat16*)out, (float*)part_o, (float*)part_ml, Hkv, G, page,
      npages, scale, softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  return merge_splits::launch<paged_decode_merge>(
      st, (const float*)part_o, (const float*)part_ml, (__nv_bfloat16*)out,
      nsplit, (long long)B * Hkv * G, D);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernels were not instantiated for.
// nsplit: parts of each sequence's key range (bf16 at head_dim >= 64 only;
// 1 elsewhere); part_o (nsplit, B * Hq, D) and part_ml (2, nsplit, B * Hq)
// are fp32 scratch, written only when nsplit > 1.
extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages,
                                   const void* block_tables,
                                   const void* lengths, void* out,
                                   void* part_o, void* part_ml, int B,
                                   int Hq, int Hkv, int D, int page,
                                   int npages, int nsplit, float scale,
                                   float softcap, int is_bf16, void* stream) {
  const bool tc = is_bf16 && D >= 64;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > MAXG || page <= 0 ||
      Hkv > 65535 || nsplit < 1 || nsplit > MAX_SPLITS ||
      (!tc && nsplit != 1) || (nsplit > 1 && (!part_o || !part_ml)) ||
      (D != 16 && D != 32 && D != 64 && D != 128 && D != 256))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int G = Hq / Hkv;
  cudaStream_t st = (cudaStream_t)stream;
  if (tc) {
    cudaError_t e;
    if (D == 64)
      e = launch_tc<64>(st, q, k_pages, v_pages, block_tables, lengths, out,
                        part_o, part_ml, B, Hkv, G, page, npages, nsplit,
                        scale, softcap);
    else if (D == 128)
      e = launch_tc<128>(st, q, k_pages, v_pages, block_tables, lengths, out,
                         part_o, part_ml, B, Hkv, G, page, npages, nsplit,
                         scale, softcap);
    else
      e = launch_tc<256>(st, q, k_pages, v_pages, block_tables, lengths, out,
                         part_o, part_ml, B, Hkv, G, page, npages, nsplit,
                         scale, softcap);
    return (int)e;
  }
  dim3 grid(B, Hkv);
  if (is_bf16)
    launch_core<__nv_bfloat16>(D, grid, st, q, k_pages, v_pages,
                               block_tables, lengths, out, Hkv, G, page,
                               npages, scale, softcap);
  else
    launch_core<float>(D, grid, st, q, k_pages, v_pages, block_tables,
                       lengths, out, Hkv, G, page, npages, scale, softcap);
  return (int)cudaGetLastError();
}
