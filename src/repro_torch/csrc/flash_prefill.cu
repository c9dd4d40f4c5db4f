// flash_prefill: dense GQA flash attention with causal and sliding-window
// masking and a logit softcap.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_prefill.py:flash_prefill
// (kernel body `_kernel`). Contract: q (B, Hq, S, D), k/v (B, Hkv, T, D),
// each given by its (batch, head, row) strides in elements with unit stride
// on D, so the seq-major model layout (B, S, H, D) is read in place.
// Positions are relative and aligned top-left: query i sits at position i,
// key j at j, also when S != T. Key j is visible to query i iff j <= i
// (causal) and j > i - window (window > 0). The softcap tanh(s / cap) * cap
// comes before the mask; the softmax is online with fp32 running max,
// denominator and accumulator; a row with no visible key writes 0 (its
// denominator stays 0, as in the Pallas kernel). Output (B, Hq, S, D) in
// q's dtype, by strides.
//
// Bound: 4 * Hq * D flops per visible (query, key) pair, against q, k, v
// and the output moved once. At long S (Llama-3.1-8B, S = T = 8192: 550
// GFLOP against 0.5 GB) the call is bound by operations at the bf16
// tensor-core peak; at short S (1000 tokens: 8.2 GFLOP against 33 MB) by
// operations too, but so short that a wave of blocks and the causal tail's
// last, shortest tiles decide its time.
//
// Rows: the rows of one kv head are flattened as r = i * G + g (query
// position i, group member g = q head - kv head * G), so each K/V tile is
// loaded once for all G query heads that read it, as the Pallas index map
// h // G does. A loop over tiles of 64 keys replaces the Pallas grid's
// sequential key axis; it starts at the first key any row of the block may
// see (window) and ends after the last one (causal), so fully masked key
// tiles are never visited: the Pallas kernel's whole-block skip, which
// bounds the work by the visible pairs and not by S * T. No divisibility of
// S or T is assumed. Blocks are launched heaviest first (the last row tiles,
// which see the most keys under a causal mask).
//
// bf16 at head_dim 64, 128 and 256: the tensor cores (flash_prefill_tc).
// Each block is NWG consumer warpgroups of 64 flat rows (two at D <= 128,
// one at D = 256, whose O accumulator takes 128 registers a thread), and
// the tile arithmetic is attn_tile.cuh's: S = Q K^T and O += P V on
// `wgmma` (P as a bf16 hi/lo pair), the softmax in registers. K and V stay
// bf16 in shared memory, in a ring of 3 stages (2 at D = 256) of 64-key
// tiles loaded by TMA (cp.async.bulk.tensor, 128-byte swizzle, one mbarrier
// per stage, rows past T filled with zeros), started by one thread: while
// the warpgroups compute tile j, tiles j + 1 and j + 2 are in flight, and
// the load of tile j + 3 starts once every warpgroup has left tile j (one
// block barrier per tile). Q is loaded once per block with 16-byte loads
// into the same swizzled layout. A warpgroup skips a tile none of its rows
// can see and masks only a tile that some of its rows see in part. The
// tensor maps come from cuTensorMapEncodeTiled, looked up at run time
// through the CUDA runtime, so the library links against no -lcuda.
// Against the CUDA-core kernel below, this design does its products on the
// tensor cores; keeps K/V in bf16 (half the shared memory of fp32 tiles);
// keeps the next tiles' loads in flight during the compute, with one
// barrier a tile where the CUDA-core kernel waits on four; and keeps scores
// and probabilities in registers, with no round trip through shared memory
// and no warp per row.
//
// fp32 at every head_dim, and bf16 at head_dim 16 and 32, keep the CUDA-core
// kernel (flash_prefill_kernel): 2e-5 cannot be held on bf16 or TF32
// tensor cores, and a 16- or 32-wide head has no 64-column swizzle chunk.
// One block per tile of R = 32 flat rows. Per key tile: (1) the tile's K and
// V rows go to shared memory as fp32 with 16-byte loads; (2) scores: each
// thread computes a 4-row x 4-key patch of the R x KT tile from shared
// memory, the query scaled in fp32 first, applies the softcap and the mask;
// (3) one warp per row updates the running max and denominator and turns
// scores into probabilities; (4) p @ V: D / 4 threads span a row of V, four
// columns each, read as float4, and each thread keeps R * D / (4 * NT) rows
// x 4 columns of fp32 accumulators in registers. The dispatch is by dtype
// and head_dim inside flash_prefill_launch; a launch that fails returns its
// error and is never retried on the other kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <string.h>

#include "attn_tile.cuh"

namespace {

constexpr int NT = 128;         // threads per block
constexpr int NW = NT / 32;     // warps per block
constexpr int R = 32;           // query rows per block (flat r = i * G + g)
constexpr int KT = 64;          // keys per tile
constexpr int MAXG = 16;        // query heads per kv head
constexpr int SS = KT + 1;      // score row stride (odd: no bank conflicts)
constexpr float NEG = -1e30f;

struct Strides {                // in elements; D has unit stride
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

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

// Whether key position kpos (tile-local key < nk) is visible to a query at
// qpos (-1 for a padding row past the block's last real row).
__device__ __forceinline__ bool visible(int key, int nk, int kpos, int qpos,
                                        bool causal, int window) {
  return key < nk && qpos >= 0 && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// Shared memory, in this order: V tile (KT x D), Q rows (R x (D + 1)),
// K tile (KT x (D + 1)), scores (R x SS), running max / denominator /
// correction (3 x R). V, read as float4, starts the buffer (16-byte
// aligned); the others are read a float at a time.
template <int D>
struct Smem {
  static constexpr int QS = D + 1;     // odd strides: column reads of Q and
  static constexpr int KS = D + 1;     // K rows hit distinct banks
  static constexpr int floats = KT * D + R * QS + KT * KS + R * SS + 3 * R;
  static constexpr size_t bytes = floats * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, Strides st, int S, int T_,
    int G, int causal, int window, float scale, float softcap) {
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
  float* v_s = reinterpret_cast<float*>(smem_raw);
  float* q_s = v_s + KT * D;
  float* k_s = q_s + R * QS;
  float* s_s = k_s + KT * KS;
  float* m_s = s_s + R * SS;
  float* l_s = m_s + R;
  float* c_s = l_s + R;

  // heaviest row tiles (latest query positions, most keys) issued first
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;             // kv head
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rows = G * S;               // flat rows of this (b, kv head)
  const int r0 = tile * R;
  const int r_end = min(r0 + R, rows);  // this block's rows: [r0, r_end)
  const bool win = window > 0;
  // keys any row of this block may see: [kbeg, kend)
  const int i_first = r0 / G, i_last = (r_end - 1) / G;
  const int kbeg = win ? max(0, i_first - window + 1) : 0;
  const int kend = causal ? min(T_, i_last + 1) : T_;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;

  // query rows, scaled in fp32 (the reference's q.astype(f32) * scale)
  for (int idx = tid; idx < R * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int flat = r0 + r;
    float x = 0.f;
    if (flat < rows) {
      const int i = flat / G, g = flat % G;
      x = to_f(q[b * st.qb + (long long)(h * G + g) * st.qh + i * st.qs +
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
  __syncthreads();

  for (int t0 = kbeg; t0 < kend; t0 += KT) {
    const int nk = min(KT, kend - t0);  // live keys in this tile
    // (1) K and V rows of the tile -> shared fp32 (zeros past nk)
    for (int idx = tid; idx < KT * VPR; idx += NT) {
      const int key = idx / VPR, col = (idx % VPR) * EPV;
      float fk[EPV], fv[EPV];
      if (key < nk) {
        const long long t = t0 + key;
        load16(kb + t * st.ks + col, fk);
        load16(vb + t * st.vs + col, fv);
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

    // (2) scores, softcap, mask by relative position
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
        const int qpos = flat < rows ? flat / G : -1;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = tk + 16 * c;
          float x = sc[a][c];
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          s_s[r * SS + key] =
              visible(key, nk, t0 + key, qpos, causal, window) ? x : NEG;
        }
      }
    }
    __syncthreads();

    // (3) online softmax, one warp per row
    for (int r = warp; r < R; r += NW) {
      const int flat = r0 + r;
      const int qpos = flat < rows ? flat / G : -1;
      float x[KT / 32];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < KT / 32; ++j) {
        x[j] = s_s[r * SS + lane + 32 * j];
        mx = fmaxf(mx, x[j]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KT / 32; ++j) {
        const int key = lane + 32 * j;
        const float e = visible(key, nk, t0 + key, qpos, causal, window)
                            ? expf(x[j] - m_new) : 0.f;
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
    for (int key = 0; key < nk; ++key) {
      const float4 vv =
          *reinterpret_cast<const float4*>(v_s + key * D + 4 * tc);
#pragma unroll
      for (int a = 0; a < RPT; ++a) {
        const float p = s_s[(rg + RG * a) * SS + key];
        acc[a][0] += p * vv.x;
        acc[a][1] += p * vv.y;
        acc[a][2] += p * vv.z;
        acc[a][3] += p * vv.w;
      }
    }
    __syncthreads();  // the next tile rewrites k_s, v_s and s_s
  }

#pragma unroll
  for (int a = 0; a < RPT; ++a) {
    const int r = rg + RG * a;
    const int flat = r0 + r;
    if (flat >= rows) continue;
    const int i = flat / G, g = flat % G;
    const float den = fmaxf(l_s[r], 1e-30f);
    T* o = out + b * st.ob + (long long)(h * G + g) * st.oh + i * st.os +
           4 * tc;
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = from_f<T>(acc[a][e] / den);
  }
}

// ----------------------------------------------------------------------
// bf16 on the tensor cores

// NWG consumer warpgroups of 64 flat rows per block
template <int D>
struct TcShape {
  static constexpr int NWG = D <= 128 ? 2 : 1;
  static constexpr int STAGES = attn_tile::Stages<D>::value;
  static constexpr int TILE = attn_tile::Tile<D>::bytes;
  // Q tiles, the K ring, the V ring, the mbarriers, and slack to align the
  // start to 1024 bytes (the swizzle atom)
  static constexpr size_t bytes =
      (size_t)(NWG + 2 * STAGES) * TILE + STAGES * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(TcShape<D>::NWG * 128, 1)
    flash_prefill_tc_kernel(const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __nv_bfloat16* __restrict__ q,
                            __nv_bfloat16* __restrict__ out, Strides st,
                            int S, int T_, int G, int causal, int window,
                            float scale, float softcap) {
  using namespace attn_tile;
  constexpr int NWG = TcShape<D>::NWG;
  constexpr int STAGES = TcShape<D>::STAGES;
  constexpr int TILE = TcShape<D>::TILE;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  unsigned char* q_s = align1024(smem_tc);
  unsigned char* k_s = q_s + NWG * TILE;
  unsigned char* v_s = k_s + STAGES * TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + STAGES * TILE);

  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  const int rows = G * S;
  const int r0 = tile * NWG * ROWS;
  const int r_end = min(r0 + NWG * ROWS, rows);
  const bool win = window > 0;
  // keys any row of this block may see: [kbeg, kend)
  const int kbeg = win ? max(0, r0 / G - window + 1) : 0;
  const int kend = causal ? min(T_, (r_end - 1) / G + 1) : T_;
  const int ntiles = kend > kbeg ? (kend - kbeg + KEYS - 1) / KEYS : 0;

  auto load_tile = [&](int j, int stage) {  // tile j -> stage, one thread
    mbar_expect_tx(&full[stage], 2 * TILE);
    const int key = kbeg + j * KEYS;
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      tma_load_4d(smem_u32(k_s + stage * TILE + c * CHUNK), &kmap,
                  &full[stage], 64 * c, key, h, b);
      tma_load_4d(smem_u32(v_s + stage * TILE + c * CHUNK), &vmap,
                  &full[stage], 64 * c, key, h, b);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  // this warpgroup's rows [wr0, wr_end) and their positions
  const int wr0 = r0 + wg * ROWS;
  const int wr_end = min(wr0 + ROWS, rows);
  const bool has_rows = wr0 < rows;
  const int wi_first = wr0 / G;
  const int wi_last = has_rows ? (wr_end - 1) / G : 0;
  load_rows<D>(q_s + wg * TILE, tid & 127,
               [&](int r) -> const __nv_bfloat16* {
                 const int flat = wr0 + r;
                 if (flat >= rows) return nullptr;
                 const int i = flat / G, g = flat - i * G;
                 return q + b * st.qb + (long long)(h * G + g) * st.qh +
                        (long long)i * st.qs;
               });
  fence_proxy_async();
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < min(STAGES, ntiles); ++j) load_tile(j, j);

  int qpos[2];
#pragma unroll
  for (int x = 0; x < 2; ++x)
    qpos[x] = (wr0 + warp * 16 + (lane >> 2) + 8 * x) / G;
  auto vis = [=](int key, int x) {
    return key < T_ && (!causal || key <= qpos[x]) &&
           (!win || key > qpos[x] - window);
  };

  RowState<D> rs;
  rs.init();
  const uint32_t q_tile = smem_u32(q_s + wg * TILE);
  for (int j = 0; j < ntiles; ++j) {
    const int stage = j % STAGES;
    const int key0 = kbeg + j * KEYS;
    mbar_wait(&full[stage], (j / STAGES) & 1);
    // warpgroup-uniform: skip a tile none of its rows sees, mask a tile
    // some of its rows see in part
    const bool none = !has_rows || (causal && key0 > wi_last) ||
                      (win && key0 + KEYS - 1 <= wi_first - window);
    if (!none) {
      const bool all = key0 + KEYS <= T_ &&
                       (!causal || key0 + KEYS - 1 <= wi_first) &&
                       (!win || key0 > wi_last - window);
      const uint32_t kt = smem_u32(k_s + stage * TILE);
      const uint32_t vt = smem_u32(v_s + stage * TILE);
      if (all)
        rs.template step<false>(q_tile, kt, vt, key0, scale, softcap, vis);
      else
        rs.template step<true>(q_tile, kt, vt, key0, scale, softcap, vis);
    }
    __syncthreads();  // every warpgroup is done with this stage
    if (tid == 0 && j + STAGES < ntiles) load_tile(j + STAGES, stage);
  }

  if (!has_rows) return;
  rs.finish();
  rs.store([&](int x) -> __nv_bfloat16* {
    const int flat = wr0 + warp * 16 + (lane >> 2) + 8 * x;
    if (flat >= rows) return nullptr;
    const int i = flat / G, g = flat - i * G;
    return out + b * st.ob + (long long)(h * G + g) * st.oh +
           (long long)i * st.os;
  });
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, H, T, D) bf16 tensor by its (batch, head, row) strides in elements
// (0 for a dimension of size 1) as a 4-d map (D, T, H, B) with 64 x 64 boxes
// in the 128-byte swizzle. Returns false if it cannot be encoded.
bool kv_map(CUtensorMap* map, const void* base, int B, int H, int T, int D,
            long long sb, long long sh, long long ss) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  // a dimension of size 1 is never stepped over: give it the stride a
  // packed tensor would have
  const cuuint64_t row = ss ? ss * 2 : (cuuint64_t)D * 2;
  const cuuint64_t head = sh ? sh * 2 : row * T;
  const cuuint64_t batch = sb ? sb * 2 : head * H;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {row, head, batch};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_tc(cudaStream_t stream, const void* q, const void* k,
                      const void* v, void* out, const Strides& st, int B,
                      int S, int T_, int Hkv, int G, int causal, int window,
                      float scale, float softcap) {
  CUtensorMap kmap, vmap;
  memset(&kmap, 0, sizeof(kmap));
  memset(&vmap, 0, sizeof(vmap));
  if (T_ > 0 && (!kv_map(&kmap, k, B, Hkv, T_, D, st.kb, st.kh, st.ks) ||
                 !kv_map(&vmap, v, B, Hkv, T_, D, st.vb, st.vh, st.vs)))
    return cudaErrorInvalidValue;
  constexpr size_t bytes = TcShape<D>::bytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_prefill_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  constexpr int rows_per_block = TcShape<D>::NWG * attn_tile::ROWS;
  dim3 grid((G * S + rows_per_block - 1) / rows_per_block, Hkv, B);
  flash_prefill_tc_kernel<D><<<grid, TcShape<D>::NWG * 128, bytes, stream>>>(
      kmap, vmap, (const __nv_bfloat16*)q, (__nv_bfloat16*)out, st, S, T_, G,
      causal, window, scale, softcap);
  return cudaSuccess;
}

// ----------------------------------------------------------------------
// fp32, and bf16 at head_dim 16 and 32, on the CUDA cores

template <typename T, int D>
cudaError_t launch_d(dim3 grid, cudaStream_t stream, const void* q,
                     const void* k, const void* v, void* out,
                     const Strides& st, int S, int T_, int G, int causal,
                     int window, float scale, float softcap) {
  constexpr size_t bytes = Smem<D>::bytes;
  // per device, so set on every launch (it is cheap)
  const cudaError_t e = cudaFuncSetAttribute(
      flash_prefill_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  flash_prefill_kernel<T, D><<<grid, NT, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, st, S, T_, G, causal,
      window, scale, softcap);
  return cudaSuccess;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernels were not instantiated for
// or a tensor map that could not be encoded. Strides are in elements, (batch,
// head, row) for q, k, v and out in turn.
extern "C" int flash_prefill_launch(
    const void* q, const void* k, const void* v, void* out, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int B, int S, int T,
    int Hq, int Hkv, int D, int causal, int window, float scale,
    float softcap, int is_bf16, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > MAXG || B > 65535 ||
      Hkv > 65535 || T < 0 || window < 0 ||
      (D != 16 && D != 32 && D != 64 && D != 128 && D != 256))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0) return 0;
  const int G = Hq / Hkv;
  const Strides st{q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                   v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((G * S + R - 1) / R, Hkv, B);
  cudaError_t e;
  if (is_bf16) {
    switch (D) {
      case 16:
        e = launch_d<__nv_bfloat16, 16>(grid, s, q, k, v, out, st, S, T, G,
                                        causal, window, scale, softcap);
        break;
      case 32:
        e = launch_d<__nv_bfloat16, 32>(grid, s, q, k, v, out, st, S, T, G,
                                        causal, window, scale, softcap);
        break;
      case 64:
        e = launch_tc<64>(s, q, k, v, out, st, B, S, T, Hkv, G, causal,
                          window, scale, softcap);
        break;
      case 128:
        e = launch_tc<128>(s, q, k, v, out, st, B, S, T, Hkv, G, causal,
                           window, scale, softcap);
        break;
      default:
        e = launch_tc<256>(s, q, k, v, out, st, B, S, T, Hkv, G, causal,
                           window, scale, softcap);
    }
  } else {
    switch (D) {
      case 16:
        e = launch_d<float, 16>(grid, s, q, k, v, out, st, S, T, G, causal,
                                window, scale, softcap);
        break;
      case 32:
        e = launch_d<float, 32>(grid, s, q, k, v, out, st, S, T, G, causal,
                                window, scale, softcap);
        break;
      case 64:
        e = launch_d<float, 64>(grid, s, q, k, v, out, st, S, T, G, causal,
                                window, scale, softcap);
        break;
      case 128:
        e = launch_d<float, 128>(grid, s, q, k, v, out, st, S, T, G, causal,
                                 window, scale, softcap);
        break;
      default:
        e = launch_d<float, 256>(grid, s, q, k, v, out, st, S, T, G, causal,
                                 window, scale, softcap);
    }
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
