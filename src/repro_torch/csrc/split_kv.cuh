// The split-KV frame shared by the decode attention kernels
// (decode_attention.cu, mla_decode_attention.cu): one token per row against
// a ring cache, reading only the written slots, split over chunks of slots
// whose f32 partials a combine pass sums in a fixed order.
//
// What lives here: the launch parameters (Params), the written slots of a
// row as intervals of the local slots (Arc, arc_of), the chunk rule
// (chunk_len, on the SM count) and the combine of a row's chunks
// (combine_rows), which each kernel file wraps in a __global__ of its own
// name so that a trace tells the kernels apart.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace split_kv {

constexpr int TARGET_CTAS_PER_SM = 32;
constexpr int MIN_CHUNK = 128;       // slots, where the tile allows
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__host__ __device__ constexpr int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
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
  float scale2;             // the score scale times log2(e)
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

// One CTA per (row h = blockIdx.x, row b = blockIdx.y): the row's live
// chunks in order, D output columns of each head.
__device__ __forceinline__ void combine_rows(const Params& p, int D) {
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

inline int sm_count() {
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

// Slots per chunk: about `target` CTAs an SM (TARGET_CTAS_PER_SM unless a
// kernel of heavier CTAs asks for fewer) if every slot were written, chunks
// of at least `min_chunk` slots (a tile where that is more), whole tiles;
// `forced` > 0 sets it (rounded up to whole tiles). B x K is the number of
// (row, kv head) pairs a launch splits.
inline int chunk_len(int B, int K, int S, int TK, int forced, int target = TARGET_CTAS_PER_SM,
                     int min_chunk = MIN_CHUNK) {
  const int tiles = (S + TK - 1) / TK;
  if (forced > 0) return ((forced + TK - 1) / TK) * TK;
  const long long rows = (long long)B * K;
  long long want = ((long long)target * sm_count() + rows - 1) / rows;
  const int min_tiles = min_chunk > TK ? min_chunk / TK : 1;
  const long long most = (tiles + min_tiles - 1) / min_tiles;
  if (want > most) want = most;
  if (want < 1) want = 1;
  const long long per = (tiles + want - 1) / want;
  return (int)(per * TK);
}

}  // namespace split_kv
