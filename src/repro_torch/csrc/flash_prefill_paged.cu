// flash_prefill_paged: chunk-prefill GQA attention straight over the paged
// KV pool.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_prefill_paged.py:flash_prefill_paged (kernel body
// `_kernel`). Contract: q (B, S, Hq, D), q[b, i] at absolute position
// start[b] + i; k/v pages (P, page, Hkv, D); block tables (B, npages) int32;
// start (B,) int32. The chunk's own K/V rows are already in their pages. A
// key at position t is visible to a query at position p iff t <= p (and
// t < npages * page); an optional tanh softcap applies to the scores; the
// softmax is online with fp32 accumulators. Output (B, S, Hq, D) in q's
// dtype.
//
// Bound: 4 * Hq * D flops per visible (query, key) pair, against each K/V
// row, q and the output moved once. At the main path's shapes a 200-token
// chunk over a 1000-token prefix is bound by operations (at the bf16
// tensor-core peak) and four 40- or 72-token tails over 1000 tokens each by
// bytes; all of them are a few microseconds of work, so the number of
// blocks in flight and each block's serial walk over its keys decide the
// time.
//
// Rows: the Pallas grid keeps all G * S query rows of one (b, kv_head) in
// one program and walks the pages in order. Here the rows are flattened as
// r = i * G + g (chunk position i, group member g) and tiled, so one
// (b, kv_head) spreads over several blocks, heaviest first. A block loads
// its own block-table entries and start position (the Pallas version had
// them in scalar prefetch). A loop over tiles of 64 keys replaces the
// sequential page axis; it ends after the last key the block's last row may
// see, so pages past start + S (padded block-table columns point at
// sentinel page 0) are skipped whole and never read.
//
// bf16 at head_dim 64, 128 and 256: the tensor cores
// (flash_prefill_paged_tc), one warpgroup of 64 flat rows per block and
// attn_tile.cuh's tile arithmetic (S = Q K^T and O += P V on `wgmma`, P as
// a bf16 hi/lo pair, the softmax in registers), shared with the dense
// kernel. A 64-key tile is gathered row by row from its pages (4 pages of
// 16 at the main path's page size; any page size works) with 16-byte
// cp.async.cg copies into the same 128-byte-swizzled bf16 ring of 3 stages
// (2 at D = 256): tiles j + 1 and j + 2 are in flight while tile j computes,
// and keys past the block's last visible one are zero-filled without a
// read. Split over keys: when B * Hkv * (row tiles) would leave the SMs
// idle (the B = 1 tails: 24 blocks; a 200-token chunk: 104), the wrapper
// asks for n parts (kernels/flash_prefill_paged.py:choose_splits); part p of
// a block takes its key tiles [p * nt / n, (p + 1) * nt / n), writes its
// unnormalised fp32 output, max and denominator to scratch, and
// merge_splits.cuh's kernel combines the parts and rounds to bf16 once.
// With n = 1 the tile kernel writes bf16 itself and nothing is merged.
// Against the CUDA-core kernel below: tensor cores instead of fp32 CUDA
// cores, K/V kept bf16, loads in flight during the compute, scores in
// registers, and enough blocks at B = 1.
//
// fp32 at every head_dim, and bf16 at head_dim 16 and 32, keep the CUDA-core
// kernel (flash_prefill_paged_kernel; 2e-5 cannot be held on bf16 or TF32
// tensor cores, and a 16- or 32-wide head has no 64-column swizzle chunk):
// R = 32 flat rows per block; per tile (1) the tile's K and V rows go to
// shared memory as fp32 with 16-byte loads, keys past the block's last
// visible one as zeros; (2) each thread computes a 4-row x 4-key patch of
// the R x KT score tile from shared memory, the query scaled in fp32
// first, and applies the softcap and the causal mask; (3) one warp per row
// updates the running max and denominator and turns the scores into
// probabilities; (4) p @ V: D / 4 threads cover a row of V, four columns
// each, read as float4, each keeping R * D / (4 * NT) rows x 4 columns of
// fp32 accumulators. Both take a query group up to 16 and head_dim up to
// 256. The dispatch is by dtype and head_dim inside the C entry point; a
// launch that fails returns its error and is never retried on the other
// kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tile.cuh"
#include "merge_splits.cuh"

namespace {

constexpr int NT = 128;         // threads per block
constexpr int NW = NT / 32;     // warps per block
constexpr int R = 32;           // query rows per block (flat r = i * G + g)
constexpr int KT = 64;          // keys per tile
constexpr int MAXG = 16;        // query heads per kv head
constexpr int SS = KT + 1;      // score row stride (odd: no bank conflicts)
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

// Shared memory, in this order: per-key row offsets (KT x 8 bytes), V tile
// (KT x D), Q rows (R x (D + 1)), K tile (KT x (D + 1)), scores (R x SS),
// running max / denominator / correction (3 x R). Every float array starts
// 16-byte aligned where it is read as float4 (only V is).
template <int D>
struct Smem {
  static constexpr int QS = D + 1;     // odd strides: column reads of Q and
  static constexpr int KS = D + 1;     // K rows hit distinct banks
  static constexpr int floats = KT * D + R * QS + KT * KS + R * SS + 3 * R;
  static constexpr size_t bytes = KT * sizeof(long long) + floats * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_prefill_paged_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ start_pos, T* __restrict__ out, int S, int Hkv,
    int G, int page, int npages, float scale, float softcap) {
  constexpr int EPV = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int VPR = D / EPV;          // 16-byte loads per K/V row
  constexpr int QS = Smem<D>::QS;
  constexpr int KS = Smem<D>::KS;
  // p @ V: TC threads of four columns each span a row of D; RG row groups
  constexpr int TC = D / 4;
  constexpr int RG = NT / TC;
  constexpr int RPT = R / RG;           // rows per thread in p @ V
  static_assert(NT % TC == 0 && R % RG == 0, "p @ V thread layout");
  static_assert(D % EPV == 0, "16-byte loads must tile a row");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* off_s = reinterpret_cast<long long*>(smem_raw);
  float* v_s = reinterpret_cast<float*>(smem_raw + KT * sizeof(long long));
  float* q_s = v_s + KT * D;
  float* k_s = q_s + R * QS;
  float* s_s = k_s + KT * KS;
  float* m_s = s_s + R * SS;
  float* l_s = m_s + R;
  float* c_s = l_s + R;

  // heaviest row tiles (latest chunk positions, most keys) are issued first
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Hq = Hkv * G;
  const int rows = G * S;               // flat rows of this (b, kv_head)
  const int r0 = tile * R;
  const int r_end = min(r0 + R, rows);  // this block's rows: [r0, r_end)
  const long long row_stride = (long long)Hkv * D;
  const int start = start_pos[b];
  // keys any row of this block may see: [0, kend)
  const int kend = min(start + (r_end - 1) / G + 1, npages * page);
  const int* bt = block_tables + (long long)b * npages;

  // query rows, scaled in fp32 (the reference's q.float() * scale)
  for (int idx = tid; idx < R * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int flat = r0 + r;
    float x = 0.f;
    if (flat < rows) {
      const int i = flat / G, g = flat % G;
      x = to_f(q[(((long long)b * S + i) * Hq + (long long)h * G + g) * D +
                 d]) * scale;
    }
    q_s[r * QS + d] = x;
  }
  if (tid < R) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }

  // score patch: rows tr + 8a, keys tk + 16c (a, c < 4)
  const int tr = tid >> 4;              // 0..7
  const int tk = tid & 15;              // 0..15
  // p @ V patch: rows rg + RG * a (a < RPT), columns 4 * tc .. 4 * tc + 3
  const int tc = tid % TC;
  const int rg = tid / TC;
  float acc[RPT][4];
#pragma unroll
  for (int a = 0; a < RPT; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;

  for (int t0 = 0; t0 < kend; t0 += KT) {
    const int nk = min(KT, kend - t0);  // live keys in this tile
    // (1) K and V rows of the tile -> shared fp32
    if (tid < KT) {
      const int t = t0 + tid;
      long long off = -1;
      if (tid < nk) {
        const int j = t / page;
        off = ((long long)bt[j] * page + (t - j * page)) * row_stride +
              (long long)h * D;
      }
      off_s[tid] = off;
    }
    __syncthreads();
    for (int idx = tid; idx < KT * VPR; idx += NT) {
      const int key = idx / VPR, col = (idx % VPR) * EPV;
      float fk[EPV], fv[EPV];
      const long long off = off_s[key];
      if (off >= 0) {
        load16(k_pages + off + col, fk);
        load16(v_pages + off + col, fv);
      } else {
#pragma unroll
        for (int e = 0; e < EPV; ++e) fk[e] = fv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < EPV; ++e) {
        k_s[key * KS + col + e] = fk[e];
        v_s[key * D + col + e] = fv[e];
      }
    }
    __syncthreads();

    // (2) scores, softcap, causal mask by absolute position
    {
      float sc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[a][c] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float qa[4], kc[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) qa[a] = q_s[(tr + 8 * a) * QS + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) kc[c] = k_s[(tk + 16 * c) * KS + d];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[a][c] += qa[a] * kc[c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = tr + 8 * a;
        const int flat = r0 + r;
        const int qpos = flat < rows ? start + flat / G : -1;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = tk + 16 * c;
          float v = sc[a][c];
          if (softcap > 0.f) v = tanhf(v / softcap) * softcap;
          s_s[r * SS + key] = (key < nk && t0 + key <= qpos) ? v : NEG;
        }
      }
    }
    __syncthreads();

    // (3) online softmax, one warp per row
    for (int r = warp; r < R; r += NW) {
      const int flat = r0 + r;
      const int qpos = flat < rows ? start + flat / G : -1;
      float v[KT / 32];
      float mx = NEG;
#pragma unroll
      for (int k = 0; k < KT / 32; ++k) {
        v[k] = s_s[r * SS + lane + 32 * k];
        mx = fmaxf(mx, v[k]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < KT / 32; ++k) {
        const int key = lane + 32 * k;
        const bool vis = key < nk && t0 + key <= qpos;
        const float e = vis ? expf(v[k] - m_new) : 0.f;
        s_s[r * SS + key] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        l_s[r] = l_s[r] * c + sum;
        m_s[r] = m_new;
        c_s[r] = c;
      }
    }
    __syncthreads();

    // (4) p @ V into register accumulators
#pragma unroll
    for (int a = 0; a < RPT; ++a) {
      const float c = c_s[rg + RG * a];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][e] *= c;
    }
#pragma unroll 4
    for (int k = 0; k < nk; ++k) {
      const float4 vv = *reinterpret_cast<const float4*>(v_s + k * D + 4 * tc);
#pragma unroll
      for (int a = 0; a < RPT; ++a) {
        const float p = s_s[(rg + RG * a) * SS + k];
        acc[a][0] += p * vv.x;
        acc[a][1] += p * vv.y;
        acc[a][2] += p * vv.z;
        acc[a][3] += p * vv.w;
      }
    }
    __syncthreads();  // the next tile rewrites off_s, k_s, v_s and s_s
  }

#pragma unroll
  for (int a = 0; a < RPT; ++a) {
    const int r = rg + RG * a;
    const int flat = r0 + r;
    if (flat >= rows) continue;
    const int i = flat / G, g = flat % G;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    T* o = out + (((long long)b * S + i) * Hq + (long long)h * G + g) * D +
           4 * tc;
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = from_f<T>(acc[a][e] * inv);
  }
}

// ----------------------------------------------------------------------
// bf16 on the tensor cores

using merge_splits::MAX_SPLITS;

// names the merge's instantiation for this caller (merge_splits.cuh)
struct flash_prefill_paged_merge;

template <int D>
struct TcShape {
  static constexpr int STAGES = attn_tile::Stages<D>::value;
  static constexpr int TILE = attn_tile::Tile<D>::bytes;
  // the Q tile, the K ring, the V ring, and slack to align to 1024 bytes
  static constexpr size_t bytes = (size_t)(1 + 2 * STAGES) * TILE + 1024;
};

// grid (row tiles, Hkv, B * nsplit); part_o (nsplit, B * S * Hq, D) and
// part_ml (2, nsplit, B * S * Hq) are read only when nsplit > 1
template <int D>
__global__ void __launch_bounds__(128, 1) flash_prefill_paged_tc_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages,
    const int* __restrict__ block_tables, const int* __restrict__ start_pos,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part_o,
    float* __restrict__ part_ml, int S, int Hkv, int G, int page, int npages,
    int nsplit, float scale, float softcap) {
  using namespace attn_tile;
  constexpr int STAGES = TcShape<D>::STAGES;
  constexpr int TILE = TcShape<D>::TILE;
  constexpr int VPR = D / 8;            // 16-byte vectors per K/V row
  extern __shared__ __align__(16) unsigned char smem_tc[];
  unsigned char* q_s = align1024(smem_tc);
  unsigned char* k_s = q_s + TILE;
  unsigned char* v_s = k_s + STAGES * TILE;

  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z / nsplit;
  const int part = blockIdx.z - b * nsplit;
  const int B = gridDim.z / nsplit;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Hq = Hkv * G;
  const int rows = G * S;
  const int r0 = tile * ROWS;
  const int r_end = min(r0 + ROWS, rows);
  const long long row_stride = (long long)Hkv * D;
  const int start = start_pos[b];
  // keys any row of this block may see: [0, kend); this part's key tiles
  const int kend = min(start + (r_end - 1) / G + 1, npages * page);
  const int nt = (kend + KEYS - 1) / KEYS;
  const int j_lo = part * nt / nsplit;
  const int j_hi = (part + 1) * nt / nsplit;
  const int* bt = block_tables + (long long)b * npages;

  load_rows<D>(q_s, tid, [&](int r) -> const __nv_bfloat16* {
    const int flat = r0 + r;
    if (flat >= rows) return nullptr;
    const int i = flat / G, g = flat - i * G;
    return q + (((long long)b * S + i) * Hq + (long long)h * G + g) * D;
  });
  fence_proxy_async();

  // key tile j -> stage, 16 bytes a copy; keys past kend zero-filled
  auto load_kv = [&](int j, int stage) {
    const uint32_t kt = smem_u32(k_s + stage * TILE);
    const uint32_t vt = smem_u32(v_s + stage * TILE);
#pragma unroll 4
    for (int idx = tid; idx < KEYS * VPR; idx += 128) {
      const int key = idx / VPR, vec = idx - key * VPR;
      const int t = j * KEYS + key;
      long long off = 0;
      int bytes = 0;
      if (t < kend) {
        const int pg = t / page;
        off = ((long long)bt[pg] * page + (t - pg * page)) * row_stride +
              (long long)h * D + vec * 8;
        bytes = 16;
      }
      const uint32_t at = swizzled(key, vec);
      cp_async16(kt + at, k_pages + off, bytes);
      cp_async16(vt + at, v_pages + off, bytes);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (j_lo + s < j_hi) load_kv(j_lo + s, s);
    cp_async_commit();
  }

  const int i_first = r0 / G;           // this block's chunk positions
  int qpos[2];
#pragma unroll
  for (int x = 0; x < 2; ++x)
    qpos[x] = start + (r0 + warp * 16 + (lane >> 2) + 8 * x) / G;
  auto vis = [=](int key, int x) { return key < kend && key <= qpos[x]; };

  RowState<D> rs;
  rs.init();
  const uint32_t q_tile = smem_u32(q_s);
  for (int j = j_lo; j < j_hi; ++j) {
    const int stage = (j - j_lo) % STAGES;
    cp_async_wait<STAGES - 2>();        // this thread's copies of tile j
    fence_proxy_async();
    __syncthreads();                    // everyone's; stage of j - 1 free
    if (j + STAGES - 1 < j_hi)
      load_kv(j + STAGES - 1, (j - j_lo + STAGES - 1) % STAGES);
    cp_async_commit();
    const int key0 = j * KEYS;
    const uint32_t kt = smem_u32(k_s + stage * TILE);
    const uint32_t vt = smem_u32(v_s + stage * TILE);
    if (key0 + KEYS <= kend && key0 + KEYS - 1 <= start + i_first)
      rs.template step<false>(q_tile, kt, vt, key0, scale, softcap, vis);
    else
      rs.template step<true>(q_tile, kt, vt, key0, scale, softcap, vis);
  }
  cp_async_wait<0>();

  rs.finish();
  // row x of this thread -> its index in the (B * S * Hq) output rows
  auto out_row = [&](int x) -> long long {
    const int flat = r0 + warp * 16 + (lane >> 2) + 8 * x;
    if (flat >= rows) return -1;
    const int i = flat / G, g = flat - i * G;
    return ((long long)b * S + i) * Hq + (long long)h * G + g;
  };
  if (nsplit == 1) {
    rs.store([&](int x) -> __nv_bfloat16* {
      const long long row = out_row(x);
      return row < 0 ? nullptr : out + row * D;
    });
    return;
  }
  const long long n_rows = (long long)B * S * Hq;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const long long row = out_row(x);
    if (row < 0) continue;
    const long long at = (long long)part * n_rows + row;
    rs.store_part(x, part_o + at * D, part_ml + at,
                  part_ml + (long long)nsplit * n_rows + at);
  }
}

template <int D>
cudaError_t launch_tc(cudaStream_t st, const void* q, const void* kp,
                      const void* vp, const void* bt, const void* sp,
                      void* out, void* part_o, void* part_ml, int B, int S,
                      int Hkv, int G, int page, int npages, int nsplit,
                      float scale, float softcap) {
  constexpr size_t bytes = TcShape<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_prefill_paged_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((G * S + attn_tile::ROWS - 1) / attn_tile::ROWS, Hkv,
            B * nsplit);
  flash_prefill_paged_tc_kernel<D><<<grid, 128, bytes, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kp,
      (const __nv_bfloat16*)vp, (const int*)bt, (const int*)sp,
      (__nv_bfloat16*)out, (float*)part_o, (float*)part_ml, S, Hkv, G, page,
      npages, nsplit, scale, softcap);
  if (nsplit > 1) {
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    return merge_splits::launch<flash_prefill_paged_merge>(
        st, (const float*)part_o, (const float*)part_ml, (__nv_bfloat16*)out,
        nsplit, (long long)B * S * Hkv * G, D);
  }
  return cudaSuccess;
}

// ----------------------------------------------------------------------
// fp32, and bf16 at head_dim 16 and 32, on the CUDA cores

template <typename T, int D>
cudaError_t launch_d(dim3 grid, cudaStream_t st, const void* q,
                     const void* kp, const void* vp, const void* bt,
                     const void* sp, void* out, int S, int Hkv, int G,
                     int page, int npages, float scale, float softcap) {
  constexpr size_t bytes = Smem<D>::bytes;
  // per device, so set on every launch (it is cheap)
  const cudaError_t e = cudaFuncSetAttribute(
      flash_prefill_paged_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  flash_prefill_paged_kernel<T, D><<<grid, NT, bytes, st>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const int*)bt,
      (const int*)sp, (T*)out, S, Hkv, G, page, npages, scale, softcap);
  return cudaSuccess;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernels were not instantiated for.
// nsplit: parts of each row tile's key range (bf16 at head_dim >= 64 only;
// 1 elsewhere); part_o (nsplit, B * S * Hq, D) and part_ml (2, nsplit,
// B * S * Hq) are fp32 scratch, read only when nsplit > 1.
extern "C" int flash_prefill_paged_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* start, void* out, void* part_o,
    void* part_ml, int B, int S, int Hq, int Hkv, int D, int page,
    int npages, int nsplit, float scale, float softcap, int is_bf16,
    void* stream) {
  const bool tc = is_bf16 && D >= 64;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > MAXG || page <= 0 ||
      npages <= 0 || Hkv > 65535 || nsplit < 1 || nsplit > MAX_SPLITS ||
      (!tc && nsplit != 1) || (long long)B * nsplit > 65535 ||
      (nsplit > 1 && (!part_o || !part_ml)) ||
      (D != 16 && D != 32 && D != 64 && D != 128 && D != 256))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0) return 0;
  const int G = Hq / Hkv;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((G * S + R - 1) / R, Hkv, B);
  cudaError_t e;
  if (tc) {
    if (D == 64)
      e = launch_tc<64>(st, q, k_pages, v_pages, block_tables, start, out,
                        part_o, part_ml, B, S, Hkv, G, page, npages, nsplit,
                        scale, softcap);
    else if (D == 128)
      e = launch_tc<128>(st, q, k_pages, v_pages, block_tables, start, out,
                         part_o, part_ml, B, S, Hkv, G, page, npages, nsplit,
                         scale, softcap);
    else
      e = launch_tc<256>(st, q, k_pages, v_pages, block_tables, start, out,
                         part_o, part_ml, B, S, Hkv, G, page, npages, nsplit,
                         scale, softcap);
  } else if (is_bf16) {
    e = D == 16 ? launch_d<__nv_bfloat16, 16>(grid, st, q, k_pages, v_pages,
                                              block_tables, start, out, S,
                                              Hkv, G, page, npages, scale,
                                              softcap)
                : launch_d<__nv_bfloat16, 32>(grid, st, q, k_pages, v_pages,
                                              block_tables, start, out, S,
                                              Hkv, G, page, npages, scale,
                                              softcap);
  } else {
    switch (D) {
      case 16:
        e = launch_d<float, 16>(grid, st, q, k_pages, v_pages, block_tables,
                                start, out, S, Hkv, G, page, npages, scale,
                                softcap);
        break;
      case 32:
        e = launch_d<float, 32>(grid, st, q, k_pages, v_pages, block_tables,
                                start, out, S, Hkv, G, page, npages, scale,
                                softcap);
        break;
      case 64:
        e = launch_d<float, 64>(grid, st, q, k_pages, v_pages, block_tables,
                                start, out, S, Hkv, G, page, npages, scale,
                                softcap);
        break;
      case 128:
        e = launch_d<float, 128>(grid, st, q, k_pages, v_pages, block_tables,
                                 start, out, S, Hkv, G, page, npages, scale,
                                 softcap);
        break;
      default:
        e = launch_d<float, 256>(grid, st, q, k_pages, v_pages, block_tables,
                                 start, out, S, Hkv, G, page, npages, scale,
                                 softcap);
    }
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
