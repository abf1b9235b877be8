// Latent (MLA) decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the JAX reference has no latent attention. It
// is the decode step of multi-head latent attention in its absorbed form
// (models/mla.py): one token of H <= 16 heads per row, each head's query
// already carried into the latent (C values) beside its rotated rope part
// (R values), against the row's latent cache of C + R values a slot, shared
// by every head. Scores are q . slot over all C + R values; the values are
// the slot's first C. Row b attends to its written slots only, the n_b =
// min(pos_b + 1, ring) newest of a ring indexed pos % ring.
//
// What bounds it: at the published widths (H = 16, C = 512, R = 64) a slot
// is 1,152 bytes in bf16 and 2 x 16 x (576 + 512) = 34,816 operations for
// the 16 heads, 30 a byte: over the FMA pipes' 20 a byte, under the tensor
// cores' 295. So the bf16 route runs both products on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate; the 16 heads are the 16 rows
// of A) and is then bound by the bytes of the written slots, each read
// once, for all heads together.
//
// How it fills the card: split-KV, from split_kv.cuh (the frame, the chunk
// rule and the combine that decode_attention.cu uses): the grid is (chunks,
// B); a CTA takes one row and one chunk of slots, writes f32 partials, and
// a combine kernel sums a row's chunks in order (with one chunk the CTA
// writes the output). The launch shape depends on the tensors' shapes only.
//
// Inside a CTA (8 warps, two CTAs an SM, so that four warps on each SM
// quarter hide each other's latencies), the chunk is walked in tiles of 32
// slots, filled by 16-byte cp.async and double-buffered: the next tile is
// requested as soon as every warp is done with the stage it goes to. A slot
// is read once for both products, its rows padded by 16 bytes so that
// ldmatrix hits distinct banks. Per tile (three barriers), bf16 route:
//   * scores S (16 x 32) = Q (16 x (C + R)) K^T: each warp takes every 8th
//     k-step of 16 (its Q fragments, loaded once from global memory, stay in
//     registers for the whole chunk) over the tile's slots; the 8 partial
//     tiles go through shared memory and are summed in a fixed order;
//   * online softmax in f32: a warp per 2 heads, taken together, a lane per
//     slot, exp2 with log2(e) folded into the scale;
//   * O (16 x C) += P V: each warp takes every 8th column tile of 8; P is
//     split into two bf16 terms (hi + lo, about 16 bits of each weight), so
//     the weights are not rounded to bf16's 8 bits; V comes through
//     ldmatrix.trans from the same tile as K.
// The f32 route (a cache in float32: the CPU-parity checks) runs the same
// steps on the FMA pipes with every weight in f32.
//
// Accepts q and the cache both bfloat16 (C + R a multiple of 16) or both
// float32; C a multiple of 8; a build holds one (dtype, C, R): see the
// REPRO_MLA_* macros. No atomics: the result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "sm90_mma.cuh"
#include "split_kv.cuh"

#ifndef REPRO_MLA_BF16
#define REPRO_MLA_BF16 1
#endif
#ifndef REPRO_MLA_DC
#define REPRO_MLA_DC 512
#endif
#ifndef REPRO_MLA_DR
#define REPRO_MLA_DR 64
#endif

namespace {

using namespace split_kv;
using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::ldsm_x4;
using sm90::ldsm_x4_trans;
using sm90::mma_bf16;
using sm90::smem_addr;

constexpr int NT = 256;              // threads per CTA
constexpr int NW = NT / 32;
constexpr int HM = 16;               // heads a CTA holds: the rows of the mma tile
constexpr int TK = 32;               // slots per tile
// The chunk rule's targets for these CTAs (8 warps, two tiles of 32 slots):
// two CTAs an SM at a time, some 8 waves when every slot is written, chunks
// of 256 slots or more.
constexpr int CHUNK_TARGET = 16;
constexpr int CHUNK_MIN = 256;

template <typename T, int DC, int DR>
struct Mla {
  static constexpr int W = DC + DR;                // values a slot
  static constexpr int ES = sizeof(T);
  static constexpr int WS = W + 16 / ES;           // padded row in shared memory
  static constexpr int VPR = W * ES / 16;          // 16-byte vectors a slot
  static constexpr int TILE_BYTES = TK * WS * ES;
  static constexpr bool TC = ES == 2;              // the bf16 route
  static constexpr int KSTEPS = W / 16;
  static constexpr int KSW = (KSTEPS + NW - 1) / NW;   // score k-steps a warp
  static constexpr int NB = DC / 8;                    // output column tiles
  static constexpr int NBW = (NB + NW - 1) / NW;       // column tiles a warp
  static constexpr int NACC = HM * DC / NT;            // f32 route: outputs a thread
  static constexpr int NPART = TC ? NW : 1;            // score partials a tile
  static constexpr int SS = TK + 1;                    // padded row of the partials
  static constexpr int PS = TK + 8;                    // padded row of P (bf16 route)
  static constexpr int P_BYTES = TC ? 2 * HM * PS * 2 : HM * TK * 4;
  static constexpr int Q_BYTES = TC ? 0 : HM * WS * ES;   // f32: q in shared memory
  static constexpr size_t SMEM = 2 * (size_t)TILE_BYTES + Q_BYTES +
                                 sizeof(float) * (NPART * HM * SS + 3 * HM) + P_BYTES;
  static_assert((W * ES) % 16 == 0, "a slot is whole 16-byte vectors");
  static_assert(!TC || W % 16 == 0, "the bf16 route needs C + R a multiple of 16");
  static_assert(DC % 8 == 0 && (HM * DC) % NT == 0, "C must be a multiple of 16");
  static_assert(TILE_BYTES % 16 == 0 && Q_BYTES % 16 == 0, "16-byte aligned regions");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int DC, int DR>
__global__ void __launch_bounds__(NT, 2) mla_decode_kernel(const Params p) {
  using M = Mla<T, DC, DR>;
  constexpr int W = M::W, WS = M::WS, SS = M::SS;
  const int c = blockIdx.x, b = blockIdx.y;
  const int S = p.S, H = p.H;
  const Arc arc = arc_of(p.pos[b], p.ring, p.window, p.slot0, S);
  const int c0 = c * p.chunk, c1 = min(c0 + p.chunk, S);
  if (p.nchunks > 1 && !arc.has(c0, c1)) return;   // the combine skips it too

  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);                                  // [2][TK][WS]
  T* q_s = reinterpret_cast<T*>(smem + 2 * M::TILE_BYTES);                // f32: [HM][WS]
  float* s_part = reinterpret_cast<float*>(smem + 2 * M::TILE_BYTES + M::Q_BYTES);
  float* m_s = s_part + M::NPART * HM * SS;
  float* l_s = m_s + HM;
  float* a_s = l_s + HM;
  unsigned char* p_raw = reinterpret_cast<unsigned char*>(a_s + HM);
  __nv_bfloat16* p_hi = reinterpret_cast<__nv_bfloat16*>(p_raw);        // [HM][PS]
  __nv_bfloat16* p_lo = p_hi + HM * M::PS;
  float* p_f = reinterpret_cast<float*>(p_raw);                          // [HM][TK]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const T* qg = static_cast<const T*>(p.q) + (long long)b * H * W;
  if (tid < HM) { m_s[tid] = -INFINITY; l_s[tid] = 0.f; a_s[tid] = 1.f; }
  const T* kg = static_cast<const T*>(p.k) + (long long)b * S * W;

  const int t_begin = c0 / TK, t_end = (c1 + TK - 1) / TK;
  auto tile_live = [&](int t) { return arc.has(max(t * TK, c0), min(t * TK + TK, c1)); };
  auto next_tile = [&](int t) {
    for (++t; t < t_end; ++t)
      if (tile_live(t)) return t;
    return t_end;
  };
  auto load_tile = [&](int t, int stage) {
    T* dst = tiles + stage * TK * WS;
    for (int i = tid; i < TK * M::VPR; i += NT) {
      const int r = i / M::VPR, e = (i % M::VPR) * (16 / M::ES), j = t * TK + r;
      const bool live = j >= c0 && j < c1 && arc.holds(j);
      const long long off = live ? (long long)j * W + e : 0;
      cp_async16(smem_addr(dst + r * WS + e), kg + off, live);
    }
  };

  int t = next_tile(t_begin - 1);
  int stage = 0;
  if (t < t_end) load_tile(t, 0);
  cp_async_commit();

  // q: the bf16 route's A fragments straight from global memory (rows past H
  // zero); the f32 route's copy in shared memory
  uint32_t qa[M::TC ? M::KSW : 1][4];
  float acc[M::TC ? M::NBW : 1][4];
  float facc[M::TC ? 1 : M::NACC];
  if constexpr (M::TC) {
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(qg);
#pragma unroll
    for (int i = 0; i < M::KSW; ++i) {
      const int k0 = (warp + NW * i) * 16 + 2 * tq;
      const bool in = warp + NW * i < M::KSTEPS;
      qa[i][0] = in && g < H ? q32[(g * W + k0) / 2] : 0u;
      qa[i][1] = in && g + 8 < H ? q32[((g + 8) * W + k0) / 2] : 0u;
      qa[i][2] = in && g < H ? q32[(g * W + k0 + 8) / 2] : 0u;
      qa[i][3] = in && g + 8 < H ? q32[((g + 8) * W + k0 + 8) / 2] : 0u;
    }
#pragma unroll
    for (int i = 0; i < M::NBW; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
  } else {
    for (int i = tid; i < HM * W; i += NT) {
      const int h = i / W;
      q_s[h * WS + i % W] = h < H ? qg[i] : T(0.f);
    }
#pragma unroll
    for (int j = 0; j < M::NACC; ++j) facc[j] = 0.f;
  }

  while (t < t_end) {
    cp_async_wait<0>();
    __syncthreads();                 // tile t landed; every warp is done with the other stage
    const int tn = next_tile(t);
    if (tn < t_end) load_tile(tn, stage ^ 1);
    cp_async_commit();
    const T* kt = tiles + stage * TK * WS;

    // scores: partial sums over this warp's share of the slot's values
    if constexpr (M::TC) {
      float sacc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) sacc[n][u] = 0.f;
      const int mat = lane / 8;
      const T* krow = kt + ((mat / 2) * 8 + lane % 8) * WS + (mat % 2) * 8;
#pragma unroll
      for (int i = 0; i < M::KSW; ++i) {
        const int ks = warp + NW * i;
        if (ks < M::KSTEPS) {
#pragma unroll
          for (int n2 = 0; n2 < 2; ++n2) {
            uint32_t r[4];               // b0, b1 of slots 16 n2 .. + 7, then + 8 .. + 15
            ldsm_x4(r, smem_addr(krow + n2 * 16 * WS + ks * 16));
            mma_bf16(sacc[2 * n2], qa[i], r[0], r[1]);
            mma_bf16(sacc[2 * n2 + 1], qa[i], r[2], r[3]);
          }
        }
      }
      float* sp = s_part + warp * HM * SS;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = n * 8 + 2 * tq;
        sp[g * SS + col] = sacc[n][0];
        sp[g * SS + col + 1] = sacc[n][1];
        sp[(g + 8) * SS + col] = sacc[n][2];
        sp[(g + 8) * SS + col + 1] = sacc[n][3];
      }
    } else {
      const T* krow = kt + lane * WS;
      for (int h = warp; h < HM; h += NW) {
        float s = 0.f;
        if (h < H) {
          const T* qr = q_s + h * WS;
          for (int e = 0; e < W; ++e) s = fmaf(to_f(qr[e]), to_f(krow[e]), s);
        }
        s_part[h * SS + lane] = s;
      }
    }
    __syncthreads();

    // online softmax: HM / NW heads a warp, taken together, a lane per slot
    {
      constexpr int HPW = HM / NW;
      const int j = t * TK + lane;
      const bool slot_live = j >= c0 && j < c1 && arc.holds(j);
      float x[HPW], mx[HPW];
#pragma unroll
      for (int u = 0; u < HPW; ++u) {
        const int h = warp + NW * u;
        float s = 0.f;
#pragma unroll
        for (int w2 = 0; w2 < M::NPART; ++w2) s += s_part[(w2 * HM + h) * SS + lane];
        x[u] = slot_live && h < H ? s * p.scale2 : -INFINITY;
        mx[u] = x[u];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < HPW; ++u) mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], off));
      float e[HPW], sum[HPW], alpha[HPW], m_new[HPW];
#pragma unroll
      for (int u = 0; u < HPW; ++u) {
        const float m_old = m_s[warp + NW * u];
        m_new[u] = fmaxf(m_old, mx[u]);
        const bool any = m_new[u] != -INFINITY;
        alpha[u] = any ? exp2f(m_old - m_new[u]) : 1.f;
        e[u] = x[u] != -INFINITY ? exp2f(x[u] - m_new[u]) : 0.f;
        sum[u] = e[u];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < HPW; ++u) sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], off);
#pragma unroll
      for (int u = 0; u < HPW; ++u) {
        const int h = warp + NW * u;
        if constexpr (M::TC) {
          const __nv_bfloat16 hi = __float2bfloat16_rn(e[u]);
          p_hi[h * M::PS + lane] = hi;
          p_lo[h * M::PS + lane] = __float2bfloat16_rn(e[u] - __bfloat162float(hi));
        } else {
          p_f[h * TK + lane] = e[u];
        }
      }
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < HPW; ++u) {
          const int h = warp + NW * u;
          l_s[h] = l_s[h] * alpha[u] + sum[u];
          m_s[h] = m_new[u];
          a_s[h] = alpha[u];
        }
      }
    }
    __syncthreads();

    // O += P V, V the first C values of each slot
    if constexpr (M::TC) {
      uint32_t ph[2][4], pl[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int o0 = g * M::PS + kk * 16 + 2 * tq, o1 = o0 + 8 * M::PS;
        ph[kk][0] = *reinterpret_cast<const uint32_t*>(p_hi + o0);
        ph[kk][1] = *reinterpret_cast<const uint32_t*>(p_hi + o1);
        ph[kk][2] = *reinterpret_cast<const uint32_t*>(p_hi + o0 + 8);
        ph[kk][3] = *reinterpret_cast<const uint32_t*>(p_hi + o1 + 8);
        pl[kk][0] = *reinterpret_cast<const uint32_t*>(p_lo + o0);
        pl[kk][1] = *reinterpret_cast<const uint32_t*>(p_lo + o1);
        pl[kk][2] = *reinterpret_cast<const uint32_t*>(p_lo + o0 + 8);
        pl[kk][3] = *reinterpret_cast<const uint32_t*>(p_lo + o1 + 8);
      }
      const float al0 = a_s[g], al1 = a_s[g + 8];
      const T* vrow = kt + lane * WS;    // lanes 8i..8i+7 address slots 8i..8i+7
#pragma unroll
      for (int i = 0; i < M::NBW; ++i) {
        const int nb = warp + NW * i;
        if (nb < M::NB) {
          acc[i][0] *= al0; acc[i][1] *= al0; acc[i][2] *= al1; acc[i][3] *= al1;
          uint32_t r[4];                 // b0, b1 of slots 0-15, then of slots 16-31
          ldsm_x4_trans(r, smem_addr(vrow + nb * 8));
          mma_bf16(acc[i], ph[0], r[0], r[1]);
          mma_bf16(acc[i], pl[0], r[0], r[1]);
          mma_bf16(acc[i], ph[1], r[2], r[3]);
          mma_bf16(acc[i], pl[1], r[2], r[3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < M::NACC; ++j) {
        const int idx = tid + NT * j, h = idx / DC, col = idx % DC;
        float a = facc[j] * a_s[h];
        for (int r = 0; r < TK; ++r) a = fmaf(p_f[h * TK + r], to_f(kt[r * WS + col]), a);
        facc[j] = a;
      }
    }
    t = tn;
    stage ^= 1;
  }
  cp_async_wait<0>();
  __syncthreads();

  const long long cb = (long long)c * p.B * H;       // this chunk's partials
  const long long bh0 = (long long)b * H;
  auto put = [&](int h, int col, float val) {
    if (h >= H) return;
    if (p.nchunks == 1) {
      const float l = l_s[h];
      store_o(p, (bh0 + h) * DC + col, l > 0.f ? val / l : 0.f);
    } else {
      p.part_o[(cb + bh0 + h) * DC + col] = val;
    }
  };
  if constexpr (M::TC) {
#pragma unroll
    for (int i = 0; i < M::NBW; ++i) {
      const int nb = warp + NW * i;
      if (nb < M::NB) {
        const int col = nb * 8 + 2 * tq;
        put(g, col, acc[i][0]);
        put(g, col + 1, acc[i][1]);
        put(g + 8, col, acc[i][2]);
        put(g + 8, col + 1, acc[i][3]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < M::NACC; ++j) {
      const int idx = tid + NT * j;
      put(idx / DC, idx % DC, facc[j]);
    }
  }
  if (p.nchunks > 1 && tid < H) {
    p.part_ml[(cb + bh0 + tid) * 2] = m_s[tid];
    p.part_ml[(cb + bh0 + tid) * 2 + 1] = l_s[tid];
  }
}

__global__ void __launch_bounds__(NT) mla_decode_combine_kernel(const Params p, int D) {
  combine_rows(p, D);
}

#if REPRO_MLA_BF16
using Elem = __nv_bfloat16;
#else
using Elem = float;
#endif
using Built = Mla<Elem, REPRO_MLA_DC, REPRO_MLA_DR>;

}  // namespace

// Chunks of a launch at this shape (B rows, S slots), with chunk_len_forced
// > 0 forcing the chunk length (a hook for checks and timing only); the
// wrapper sizes the partials by it: chunks x B x H x C floats for part_o and
// chunks x B x H x 2 for part_ml (none when it is 1).
extern "C" int repro_mla_decode_chunks(int B, int S, int chunk_len_forced) {
  if (B < 1 || S < 1) return 0;
  const int L = chunk_len(B, 1, S, TK, chunk_len_forced, CHUNK_TARGET, CHUNK_MIN);
  return (S + L - 1) / L;
}

// This build's (is_bf16, C, R), so the wrapper can check what it loaded.
extern "C" int repro_mla_decode_built(int which) {
  return which == 0 ? REPRO_MLA_BF16 : (which == 1 ? REPRO_MLA_DC : REPRO_MLA_DR);
}

extern "C" long long repro_mla_decode_smem_bytes() { return (long long)Built::SMEM; }

// q: (B, 1, H, C + R) and cache: (B, S, C + R), both of this build's dtype;
// pos: (B,) int64, each row's absolute position (the cache is a ring of S
// slots indexed pos % S); o: (B, 1, H, C) of q's dtype; all contiguous on
// the current device. part_o, part_ml: the partials' scratch (unused with
// one chunk). Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int repro_mla_decode_attention(const void* q, const void* cache, const void* pos,
                                          void* o, void* part_o, void* part_ml, int B, int S,
                                          int H, int C, int R, int is_bf16,
                                          int chunk_len_forced, float scale, void* stream) {
  if (B < 1 || S < 1 || H < 1 || H > HM || B > 65535 || C != REPRO_MLA_DC ||
      R != REPRO_MLA_DR || is_bf16 != REPRO_MLA_BF16)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = cache; p.v = cache; p.pos = static_cast<const long long*>(pos); p.o = o;
  p.part_o = static_cast<float*>(part_o); p.part_ml = static_cast<float*>(part_ml);
  p.lse = nullptr;
  p.B = B; p.S = S; p.H = H; p.K = 1; p.G = H; p.ring = S; p.slot0 = 0; p.window = 0;
  p.q_bf16 = is_bf16;
  p.chunk = chunk_len(B, 1, S, TK, chunk_len_forced, CHUNK_TARGET, CHUNK_MIN);
  p.nchunks = (S + p.chunk - 1) / p.chunk;
  p.scale2 = scale * LOG2E;
  auto kernel = mla_decode_kernel<Elem, REPRO_MLA_DC, REPRO_MLA_DR>;
  // all of the SM's shared memory, so that two CTAs fit on one
  cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Built::SMEM);
  if (attr == cudaSuccess)
    attr = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(p.nchunks, B), NT, Built::SMEM, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.nchunks == 1) return (int)err;
  mla_decode_combine_kernel<<<dim3(H, B), NT, 0, s>>>(p, C);
  return (int)cudaGetLastError();
}
