// Decode attention over a ring KV cache for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the reference's decode attention is plain jnp
// (src/repro/models/attention.py:113-114, `attn_decode`), which widens the
// whole cache to f32, scores every slot and gives the slots not yet written,
// or outside the window, -1e30 before an f32 softmax. Those slots get a
// weight of exactly 0, so this kernel reads only the slots that hold a token:
// for row b, those whose age (steps back from slot pos_b % ring) is below
//   n_b = min(pos_b + 1, ring, window or ring).
// The arithmetic stays the reference's: q.k products and sums in f32, from
// cache elements widened in registers; an online softmax in f32; P kept in
// f32 for P.V; the output rounded once, to q's dtype. No tensor cores, no
// atomics: every sum runs in a fixed order, so the result is deterministic.
//
// What bounds it: one token against the cache is about 4 G FLOPs per cached
// element pair read (G = H / K query heads per kv head), 4 FLOPs a byte at
// G = 4 in bf16, far below the FMA pipes' 20 a byte. So it is bound by the
// bytes of the written slots, K and V each read once, at the HBM rate.
//
// How it fills the card: split-KV. The grid is (chunks, K, B). A CTA takes
// one (row, kv head, chunk of slots) and computes all G query heads of that
// kv head, so each K/V byte is read once for G heads; it writes f32
// partials (m, l and the unnormalised output) to scratch the wrapper
// allocates, and a second, small kernel combines a row's chunks in order.
// With one chunk the first kernel writes the output itself. The chunk
// length adapts to B x K against the SM count (chunk_len): few rows are
// split finely, 64 x 8 rows coarsely. The launch shape depends on the
// tensors' shapes only, never on pos: a chunk past its row's written slots
// exits at once, and nothing reads pos on the host, so a CUDA graph can
// capture the launch.
//
// Inside a CTA (4 warps), the chunk is walked in tiles of TK slots, K and V
// tiles filled by 16-byte cp.async and double-buffered (tile t + 1 in
// flight while tile t is used); slots not to be read are zero-filled
// without a load. Per tile:
//   * scores: SPLIT threads per slot, each over interleaved 16-byte vectors
//     of the K row (rows padded by SPLIT x 16 bytes, so the 8 lanes of each
//     shared-memory phase hit distinct banks), all G heads, then a shuffle
//     sum; q sits in shared memory in f32 (read as broadcasts);
//   * softmax: a warp per head, the tile's max, exp2 with log2(e) folded
//     into the scale, the running m and l rescaled;
//   * P.V: a lane owns 4 (8 at D = 256) columns of the output for every
//     head; the warps' key groups take interleaved slots, and are summed in
//     a fixed order at the end of the chunk.
//
// Accepts a float32 or bfloat16 cache (q and the output in either),
// head_dim D in {8, 16, 32, 64, 128, 256}, G = H / K from 1 to 16; a build
// may hold one (dtype, D) pair only (see dispatch below). A cache
// sharded over its slots passes its first slot's index in the ring (slot0)
// and the ring's length; the log-sum-exp of each (row, head) can be written
// beside the output for a combine across shards. The Python wrapper
// validates shapes, dtypes and contiguity before calling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "sm90_mma.cuh"

namespace {

using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::smem_addr;

constexpr int NT = 128;              // threads per CTA
constexpr int NW = NT / 32;
constexpr int GMAX = 16;             // query heads per kv head
constexpr int TARGET_CTAS_PER_SM = 32;
constexpr int MIN_CHUNK = 128;       // slots, where the tile allows
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__host__ __device__ constexpr int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename T, int D>
struct Geo {
  static constexpr int ES = sizeof(T);
  static constexpr int VEC = 16 / ES;                    // elements per 16-byte vector
  static constexpr int NV = D / VEC;                     // vectors per cache row
  static constexpr int SPLIT0 = NT / clampi(16384 / (D * ES), 16, 64);
  static constexpr int SPLIT = NV < SPLIT0 ? NV : SPLIT0;  // threads per slot (scores)
  static constexpr int TK = NT / SPLIT;                  // slots per tile
  static constexpr int KSTR = D + SPLIT * VEC;           // padded K row, elements
  static constexpr int VSTR = D;
  static constexpr int LPR = D / 4 < 32 ? D / 4 : 32;    // lanes per V row (P.V)
  static constexpr int DPL = D / LPR;                    // output columns per lane
  static constexpr int KPW = 32 / LPR;                   // slots per warp step
  static constexpr int NGRP = NW * KPW;                  // slot groups (P.V)
  static constexpr int TILE_BYTES = TK * (KSTR + VSTR) * ES;
  static_assert(NV >= 1 && NV % SPLIT == 0, "row vectors must split evenly");
  static_assert(TK % NGRP == 0, "tile must split over the slot groups");
  static_assert(DPL == 4 || DPL == 8, "4 or 8 columns a lane");
};

template <typename T, int D>
constexpr size_t smem_bytes(int G) {
  return 2 * (size_t)Geo<T, D>::TILE_BYTES +
         sizeof(float) * ((size_t)G * D + (size_t)G * Geo<T, D>::TK + 3 * GMAX);
}

// The written slots of a row that fall in this shard, as local slot
// intervals [a0, a1) and [b0, b1) (either may be empty).
struct Arc {
  int a0, a1, b0, b1;
  __device__ bool has(int lo, int hi) const {
    return (a0 < hi && lo < a1 && a0 < a1) || (b0 < hi && lo < b1 && b0 < b1);
  }
  __device__ bool holds(int j) const { return (j >= a0 && j < a1) || (j >= b0 && j < b1); }
};

__device__ __forceinline__ Arc arc_of(long long pos, int ring, int window, int slot0, int S) {
  long long n = pos + 1 < ring ? pos + 1 : ring;
  if (window > 0 && window < n) n = window;
  const int s = (int)(pos % ring);                 // the newest token's slot
  const int g0 = s - (int)n + 1;                   // global [g0, s] mod ring
  int a0, a1, b0, b1;
  if (g0 >= 0) {
    a0 = g0; a1 = s + 1; b0 = 0; b1 = 0;
  } else {
    a0 = 0; a1 = s + 1; b0 = g0 + ring; b1 = ring;
  }
  Arc r;
  r.a0 = clampi(a0 - slot0, 0, S); r.a1 = clampi(a1 - slot0, 0, S);
  r.b0 = clampi(b0 - slot0, 0, S); r.b1 = clampi(b1 - slot0, 0, S);
  return r;
}

__device__ __forceinline__ void widen(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}

// DPL consecutive elements of a shared-memory row, widened to f32.
template <typename T, int N>
__device__ __forceinline__ void load_cols(const T* p, float (&f)[N]) {
  if constexpr (sizeof(T) == 2) {
    if constexpr (N == 8) {
      widen(*reinterpret_cast<const uint4*>(p), f);
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      f[0] = __uint_as_float(u.x << 16); f[1] = __uint_as_float(u.x & 0xffff0000u);
      f[2] = __uint_as_float(u.y << 16); f[3] = __uint_as_float(u.y & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + i);
      f[i] = u.x; f[i + 1] = u.y; f[i + 2] = u.z; f[i + 3] = u.w;
    }
  }
}

struct Params {
  const void* q;            // (B, H, D), q_bf16 ? bf16 : f32
  const void* k;            // (B, S, K, D)
  const void* v;
  const long long* pos;     // (B,)
  void* o;                  // (B, H, D), q's dtype
  float* part_o;            // (chunks, B, H, D), unnormalised
  float* part_ml;           // (chunks, B, H, 2): m (log2 domain), l
  float* lse;               // (B, H) natural log, or null
  int B, S, H, K, G, ring, slot0, window, chunk, nchunks, q_bf16;
  float scale2;             // D^-0.5 log2(e)
};

__device__ __forceinline__ float load_q(const Params& p, long long i) {
  return p.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[i])
                  : static_cast<const float*>(p.q)[i];
}

__device__ __forceinline__ void store_o(const Params& p, long long i, float x) {
  if (p.q_bf16)
    static_cast<__nv_bfloat16*>(p.o)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(p.o)[i] = x;
}

template <typename T, int D, int GB>
__global__ void __launch_bounds__(NT) decode_attn_kernel(const Params p) {
  using Gm = Geo<T, D>;
  constexpr int TK = Gm::TK, SPLIT = Gm::SPLIT, VEC = Gm::VEC, NV = Gm::NV;
  constexpr int KSTR = Gm::KSTR, VSTR = Gm::VSTR, DPL = Gm::DPL, LPR = Gm::LPR;
  constexpr int KPW = Gm::KPW, NGRP = Gm::NGRP;

  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.G, S = p.S, H = p.H;
  const long long pos = p.pos[b];
  const Arc arc = arc_of(pos, p.ring, p.window, p.slot0, S);
  const int c0 = c * p.chunk, c1 = min(c0 + p.chunk, S);
  if (p.nchunks > 1 && !arc.has(c0, c1)) return;   // the combine skips it too

  extern __shared__ __align__(16) unsigned char smem[];
  T* kt = reinterpret_cast<T*>(smem);                       // [2][TK][KSTR]
  T* vt = kt + 2 * TK * KSTR;                               // [2][TK][VSTR]
  float* q_s = reinterpret_cast<float*>(smem + 2 * Gm::TILE_BYTES);   // [G][D]
  float* p_s = q_s + G * D;                                 // [G][TK]
  float* m_s = p_s + G * TK;
  float* l_s = m_s + GMAX;
  float* a_s = l_s + GMAX;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long qbase = ((long long)b * H + (long long)kvh * G) * D;
  for (int i = tid; i < G * D; i += NT) q_s[i] = load_q(p, qbase + i);
  if (tid < GMAX) { m_s[tid] = -INFINITY; l_s[tid] = 0.f; a_s[tid] = 1.f; }

  const long long row_stride = (long long)p.K * D;          // between slots
  const T* kg = static_cast<const T*>(p.k) + ((long long)b * S * p.K + kvh) * D;
  const T* vg = static_cast<const T*>(p.v) + ((long long)b * S * p.K + kvh) * D;

  const int t_begin = c0 / TK, t_end = (c1 + TK - 1) / TK;
  auto tile_live = [&](int t) {
    return arc.has(max(t * TK, c0), min(t * TK + TK, c1));
  };
  auto next_tile = [&](int t) {
    for (++t; t < t_end; ++t)
      if (tile_live(t)) return t;
    return t_end;
  };
  auto load_tile = [&](int t, int stage) {
    T* kd = kt + stage * TK * KSTR;
    T* vd = vt + stage * TK * VSTR;
    for (int i = tid; i < TK * NV; i += NT) {
      const int r = i / NV, e = (i % NV) * VEC, j = t * TK + r;
      const bool live = j >= c0 && j < c1 && arc.holds(j);
      const long long off = live ? (long long)j * row_stride + e : 0;
      cp_async16(smem_addr(kd + r * KSTR + e), kg + off, live);
      cp_async16(smem_addr(vd + r * VSTR + e), vg + off, live);
    }
  };

  float acc[GB][DPL];
#pragma unroll
  for (int i = 0; i < GB; ++i)
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[i][d] = 0.f;

  int t = next_tile(t_begin - 1);
  int stage = 0;
  if (t < t_end) {
    load_tile(t, 0);
    cp_async_commit();
  }
  while (t < t_end) {
    const int tn = next_tile(t);
    if (tn < t_end) load_tile(tn, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // scores: slot r of the tile, part sp of its row; all heads
    {
      const int r = tid / SPLIT, sp = tid % SPLIT, j = t * TK + r;
      const T* krow = kt + stage * TK * KSTR + r * KSTR;
      float s[GB];
#pragma unroll
      for (int i = 0; i < GB; ++i) s[i] = 0.f;
#pragma unroll
      for (int jj = 0; jj < NV / SPLIT; ++jj) {
        const int e = (sp + jj * SPLIT) * VEC;
        float kf[VEC];
        widen(*reinterpret_cast<const uint4*>(krow + e), kf);
#pragma unroll
        for (int i = 0; i < GB; ++i) {
          if (i < G) {
            const float* qr = q_s + i * D + e;
#pragma unroll
            for (int u = 0; u < VEC; u += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qr + u);
              s[i] = fmaf(qv.x, kf[u], s[i]);
              s[i] = fmaf(qv.y, kf[u + 1], s[i]);
              s[i] = fmaf(qv.z, kf[u + 2], s[i]);
              s[i] = fmaf(qv.w, kf[u + 3], s[i]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < GB; ++i)
#pragma unroll
        for (int off = 1; off < SPLIT; off <<= 1) s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
      if (sp == 0) {
        const bool live = j >= c0 && j < c1 && arc.holds(j);
#pragma unroll
        for (int i = 0; i < GB; ++i)
          if (i < G) p_s[i * TK + r] = live ? s[i] * p.scale2 : -INFINITY;
      }
    }
    __syncthreads();

    // softmax: a warp per head
    for (int g = warp; g < G; g += NW) {
      float x[(TK + 31) / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < (TK + 31) / 32; ++u) {
        const int r = lane + 32 * u;
        x[u] = r < TK ? p_s[g * TK + r] : -INFINITY;
        mx = fmaxf(mx, x[u]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const bool any = m_new != -INFINITY;
      const float alpha = any ? exp2f(m_old - m_new) : 1.f;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < (TK + 31) / 32; ++u) {
        const int r = lane + 32 * u;
        const float e = any ? exp2f(x[u] - m_new) : 0.f;
        if (r < TK) p_s[g * TK + r] = e;
        sum += r < TK ? e : 0.f;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // P.V: slot group grp takes slots grp, grp + NGRP, ...; a lane DPL columns
    {
      const int grp = warp * KPW + lane / LPR, col = (lane % LPR) * DPL;
      const T* vs = vt + stage * TK * VSTR + col;
#pragma unroll
      for (int i = 0; i < GB; ++i) {
        if (i < G) {
          const float a = a_s[i];
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[i][d] *= a;
        }
      }
#pragma unroll 4
      for (int r = grp; r < TK; r += NGRP) {
        float vf[DPL];
        load_cols<T, DPL>(vs + r * VSTR, vf);
#pragma unroll
        for (int i = 0; i < GB; ++i) {
          if (i < G) {
            const float pr = p_s[i * TK + r];
#pragma unroll
            for (int d = 0; d < DPL; ++d) acc[i][d] = fmaf(pr, vf[d], acc[i][d]);
          }
        }
      }
    }
    __syncthreads();                 // this stage is refilled next
    t = tn;
    stage ^= 1;
  }
  cp_async_wait<0>();
  __syncthreads();

  // the slot groups of a warp, then the warps in order, into o_s (q_s's room)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < GB; ++i)
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[i][d] += __shfl_xor_sync(0xffffffffu, acc[i][d], off);
  float* o_s = q_s;
  const int col = (lane % LPR) * DPL;
  for (int w = 0; w < NW; ++w) {
    if (warp == w && lane < LPR) {
#pragma unroll
      for (int i = 0; i < GB; ++i)
        if (i < G)
#pragma unroll
          for (int d = 0; d < DPL; ++d)
            o_s[i * D + col + d] = (w == 0 ? 0.f : o_s[i * D + col + d]) + acc[i][d];
    }
    __syncthreads();
  }

  const long long obase = ((long long)b * H + (long long)kvh * G);   // (b, h) index
  if (p.nchunks == 1) {
    for (int i = tid; i < G * D; i += NT) {
      const int g = i / D;
      const float l = l_s[g];
      store_o(p, obase * D + i, l > 0.f ? o_s[i] / l : 0.f);
    }
    if (p.lse != nullptr && tid < G) {
      const float l = l_s[tid];
      p.lse[obase + tid] = l > 0.f ? (m_s[tid] + log2f(l)) * LN2 : -INFINITY;
    }
  } else {
    const long long cb = (long long)c * p.B * H;
    for (int i = tid; i < G * D; i += NT) p.part_o[(cb + obase) * D + i] = o_s[i];
    if (tid < G) {
      p.part_ml[(cb + obase + tid) * 2] = m_s[tid];
      p.part_ml[(cb + obase + tid) * 2 + 1] = l_s[tid];
    }
  }
}

// One CTA per (row, head): the row's live chunks in order.
__global__ void __launch_bounds__(NT) decode_attn_combine_kernel(const Params p, int D) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int H = p.H;
  const Arc arc = arc_of(p.pos[b], p.ring, p.window, p.slot0, p.S);
  const long long bh = (long long)b * H + h;
  const long long stride = (long long)p.B * H;      // between chunks
  float M = -INFINITY;
  for (int c = 0; c < p.nchunks; ++c)
    if (arc.has(c * p.chunk, min(c * p.chunk + p.chunk, p.S)))
      M = fmaxf(M, p.part_ml[(c * stride + bh) * 2]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float L = 0.f, acc = 0.f;
    if (M != -INFINITY) {
      for (int c = 0; c < p.nchunks; ++c) {
        if (!arc.has(c * p.chunk, min(c * p.chunk + p.chunk, p.S))) continue;
        const float w = exp2f(p.part_ml[(c * stride + bh) * 2] - M);
        L = fmaf(p.part_ml[(c * stride + bh) * 2 + 1], w, L);
        acc = fmaf(p.part_o[(c * stride + bh) * D + d], w, acc);
      }
    }
    store_o(p, bh * D + d, L > 0.f ? acc / L : 0.f);
    if (d == 0 && p.lse != nullptr)
      p.lse[bh] = L > 0.f ? (M + log2f(L)) * LN2 : -INFINITY;
  }
}

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
      n = 132;
    counts[dev] = n;
  }
  return counts[dev];
}

// Slots per chunk: about TARGET_CTAS_PER_SM CTAs an SM if every slot were
// written, chunks of at least MIN_CHUNK slots (a tile where that is more),
// whole tiles; `forced` > 0 sets it (rounded up to whole tiles).
int chunk_len(int B, int K, int S, int TK, int forced) {
  const int tiles = (S + TK - 1) / TK;
  if (forced > 0) return ((forced + TK - 1) / TK) * TK;
  const long long rows = (long long)B * K;
  long long want = ((long long)TARGET_CTAS_PER_SM * sm_count() + rows - 1) / rows;
  const int min_tiles = MIN_CHUNK > TK ? MIN_CHUNK / TK : 1;
  const long long most = (tiles + min_tiles - 1) / min_tiles;
  if (want > most) want = most;
  if (want < 1) want = 1;
  const long long per = (tiles + want - 1) / want;
  return (int)(per * TK);
}

template <typename T>
int tile_keys(int D) {
  switch (D) {
    case 8: return Geo<T, 8>::TK;
    case 16: return Geo<T, 16>::TK;
    case 32: return Geo<T, 32>::TK;
    case 64: return Geo<T, 64>::TK;
    case 128: return Geo<T, 128>::TK;
    case 256: return Geo<T, 256>::TK;
    default: return 0;
  }
}

template <typename T, int D, int GB>
cudaError_t launch(Params p, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>(p.G);
  const cudaError_t attr = cudaFuncSetAttribute(
      decode_attn_kernel<T, D, GB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.nchunks, p.K, p.B);
  decode_attn_kernel<T, D, GB><<<grid, NT, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.nchunks == 1) return err;
  decode_attn_combine_kernel<<<dim3(p.H, p.B), NT, 0, stream>>>(p, D);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_g(const Params& p, cudaStream_t s) {
  if (p.G <= 1) return launch<T, D, 1>(p, s);
  if (p.G <= 2) return launch<T, D, 2>(p, s);
  if (p.G <= 4) return launch<T, D, 4>(p, s);
  if (p.G <= 8) return launch<T, D, 8>(p, s);
  return launch<T, D, 16>(p, s);
}

// A build may hold one head_dim (REPRO_DECODE_D) and one cache dtype
// (REPRO_DECODE_BF16 = 1 for bf16, 0 for f32) only: six kernels instead of 61,
// a few seconds of nvcc at a model's first decode step. Without the macros
// every pair is compiled.
#ifdef REPRO_DECODE_D
#define REPRO_DECODE_HAS_D(DD) (REPRO_DECODE_D == DD)
#else
#define REPRO_DECODE_HAS_D(DD) 1
#endif
#ifdef REPRO_DECODE_BF16
#define REPRO_DECODE_HAS_BF16(B) (REPRO_DECODE_BF16 == B)
#else
#define REPRO_DECODE_HAS_BF16(B) 1
#endif

template <typename T>
cudaError_t dispatch_d(const Params& p, int D, cudaStream_t s) {
  switch (D) {
#if REPRO_DECODE_HAS_D(8)
    case 8: return dispatch_g<T, 8>(p, s);
#endif
#if REPRO_DECODE_HAS_D(16)
    case 16: return dispatch_g<T, 16>(p, s);
#endif
#if REPRO_DECODE_HAS_D(32)
    case 32: return dispatch_g<T, 32>(p, s);
#endif
#if REPRO_DECODE_HAS_D(64)
    case 64: return dispatch_g<T, 64>(p, s);
#endif
#if REPRO_DECODE_HAS_D(128)
    case 128: return dispatch_g<T, 128>(p, s);
#endif
#if REPRO_DECODE_HAS_D(256)
    case 256: return dispatch_g<T, 256>(p, s);
#endif
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const Params& p, int D, int kv_bf16, cudaStream_t s) {
#if REPRO_DECODE_HAS_BF16(1)
  if (kv_bf16) return dispatch_d<__nv_bfloat16>(p, D, s);
#endif
#if REPRO_DECODE_HAS_BF16(0)
  if (!kv_bf16) return dispatch_d<float>(p, D, s);
#endif
  return cudaErrorInvalidValue;
}

}  // namespace

// Chunks of a launch at this shape (B rows, K kv heads, S local slots,
// head_dim D, kv_bf16 the cache's dtype), with chunk_len_forced > 0 forcing
// the chunk length (a hook for checks and timing only: the model passes 0,
// and the rule decides); the wrapper sizes the partials' scratch by it: chunks x B x
// H x D floats for part_o and chunks x B x H x 2 for part_ml (none when it
// is 1). 0 for an unsupported D.
extern "C" int repro_decode_attention_chunks(int B, int K, int S, int D, int kv_bf16,
                                             int chunk_len_forced) {
  const int TK = kv_bf16 ? tile_keys<__nv_bfloat16>(D) : tile_keys<float>(D);
  if (TK == 0 || B < 1 || K < 1 || S < 1) return 0;
  const int L = chunk_len(B, K, S, TK, chunk_len_forced);
  return (S + L - 1) / L;
}

// q: (B, 1, H, D) in f32 or bf16 (q_bf16), the output o likewise; k, v:
// (B, S, K, D) in f32 or bf16 (kv_bf16); pos: (B,) int64, each row's
// absolute position; all contiguous on the current device. The cache holds
// local slots slot0 .. slot0 + S - 1 of a ring of `ring` slots (slot0 = 0,
// ring = S unsharded); window <= 0 means none. part_o and part_ml are the
// partials' scratch (see repro_decode_attention_chunks; unused with one
// chunk), lse (B, H) f32 or null. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launches (0 on
// success).
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* pos, void* o, void* part_o, void* part_ml,
                                      void* lse, int B, int S, int H, int K, int D, int ring,
                                      int slot0, int window, int q_bf16, int kv_bf16,
                                      int chunk_len_forced, float scale, void* stream) {
  if (B < 1 || S < 1 || K < 1 || H % K != 0 || H / K > GMAX || ring < S || slot0 < 0 ||
      slot0 + S > ring || B > 65535 || K > 65535)
    return (int)cudaErrorInvalidValue;
  const int TK = kv_bf16 ? tile_keys<__nv_bfloat16>(D) : tile_keys<float>(D);
  if (TK == 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.pos = static_cast<const long long*>(pos); p.o = o;
  p.part_o = static_cast<float*>(part_o); p.part_ml = static_cast<float*>(part_ml);
  p.lse = static_cast<float*>(lse);
  p.B = B; p.S = S; p.H = H; p.K = K; p.G = H / K; p.ring = ring; p.slot0 = slot0;
  p.window = window; p.q_bf16 = q_bf16;
  p.chunk = chunk_len(B, K, S, TK, chunk_len_forced);
  p.nchunks = (S + p.chunk - 1) / p.chunk;
  p.scale2 = scale * LOG2E;
  return (int)dispatch(p, D, kv_bf16, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory (bytes) of one CTA at head_dim D and G query heads
// a kv head; 0 for an unsupported D.
extern "C" long long repro_decode_attention_smem_bytes(int D, int G, int kv_bf16) {
  switch (D) {
#define REPRO_DECODE_SMEM(DD) \
  case DD: return kv_bf16 ? smem_bytes<__nv_bfloat16, DD>(G) : smem_bytes<float, DD>(G);
    REPRO_DECODE_SMEM(8)
    REPRO_DECODE_SMEM(16)
    REPRO_DECODE_SMEM(32)
    REPRO_DECODE_SMEM(64)
    REPRO_DECODE_SMEM(128)
    REPRO_DECODE_SMEM(256)
#undef REPRO_DECODE_SMEM
    default: return 0;
  }
}
