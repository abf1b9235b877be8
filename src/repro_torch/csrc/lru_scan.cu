// RG-LRU linear scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rglru/kernel.py::lru_scan_kernel
// (body `_kernel`). Same function: h_t = a_t * h_{t-1} + b_t over (B, S, W)
// from h_0 = 0, the carry held in f32, the output in a's dtype.
//
// Design: a chunked scan that splits S across CTAs. The TPU kernel walks
// chunks of Q steps along a sequential grid axis and carries h from one
// chunk to the next in VMEM scratch; that carry is free there because the
// grid runs in order. Here CTAs run in parallel and in no order, so the
// chunks are joined by a pass of their own. S is cut into chunks of L steps
// (repro_lru_scan_chunk_len picks L from B, S, W, the route and the card's
// SM count; the wrapper asks it, then sizes the scratch) and one call makes
// three launches on one stream:
//   1. lru_scan_chunk_kernel, grid (W / (64 V), ceil(S/L) - 1, B): each
//      thread owns V consecutive channels of one chunk and composes the
//      chunk's affine maps in f32: A = prod a, H = the chunk's h from a zero
//      start. (A, H) go to f32 scratch of shape (B, ceil(S/L), W). The last
//      chunk feeds no later one and is skipped.
//   2. lru_scan_carry_kernel, grid (W / 32, B) of 32 channels x G = 8
//      segments: carry_{c+1} = A_c carry_c + H_c over the chunk summaries,
//      written as each chunk's carry-in (f32). A walk of all ceil(S/L)
//      summaries by one thread a channel would be a chain of dependent steps
//      that waits on a load every few steps with 2,560 threads on the card;
//      so the summaries are cut into G segments, one thread each, which
//      compose their segment, take its carry-in from the segments before it
//      through shared memory, and re-walk it.
//   3. lru_scan_apply_kernel, grid (W / (64 V), ceil(S/L), B): each thread
//      re-walks its chunk from the carry-in (chunk 0 from zero) with the
//      plain version's arithmetic and writes h.
// Every step rounds the product and then the sum (__fmul_rn, __fadd_rn: no
// fused multiply-add), as the plain version does, so chunk 0 equals it to
// the bit and a later chunk differs only by the rounding of its carry-in
// (composed over chunks and segments, against the sequential walk).
//
// Loads: V channels of one step are one 16-byte load (8 bf16 or 4 f32) when
// W is a multiple of V and a, b and y are 16-byte aligned (the scratch must
// then be too); otherwise a scalar variant (V = 1) runs. Consecutive threads take
// consecutive channels, so a warp reads 512 contiguous bytes of a row. The
// loads of a and b do not depend on h: each pass issues the next U steps'
// loads before it computes the current U steps (the carry pass likewise UC
// summaries). Ragged S and W are masked.
//
// What bounds it on the H100: there is no matmul; the function reads a and
// b once and writes h once, 3*B*S*W elements, so the bound is bytes over
// 3.35 TB/s (11.5 us for B=1, S=2500, W=2560 in bf16). The parent design,
// one thread per (row, channel) walking all S steps, ran 40 CTAs of 64
// threads on 40 of 132 SMs at prefill batch 1, each thread waiting on
// memory latency U steps at a time. Here L is the longest of 64, 32, 16
// and 8 steps whose apply pass still has two CTAs per SM (8 when none has):
// at bf16 B=1 S=2500 W=2560 on 132 SMs, L = 32, and passes 1 and 3 launch 5 x 78 = 390 and 5 x 79 = 395
// CTAs (25,280 threads in pass 3, each with up to 2U 16-byte loads of a and
// b in flight) and the whole grid is resident at once. Pass 1 reads a and b
// from device memory; pass 3 reads them again, from the 50 MB L2 that pass
// 1 has just filled (25.6 MB at that shape), and writes h. The summaries
// and carries add B * ceil(S/L) * W * 12 bytes (2.4 MB at that shape). The
// price of the split is two more launches a call, whose fixed cost
// dominates at short prompts (S = 340: 5.2 MB, 1.6 us of bytes). A
// single-pass scan that chains the chunks through flags in device memory
// (decoupled look-back) would read a and b once and skip pass 2; it is left
// for later, since a CTA that waits on another must never wait on one that
// has not been scheduled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int NT = 64;        // threads per CTA of the chunk and apply passes
constexpr int U = 8;          // steps whose loads are issued ahead of the compute
constexpr int CW = 32;        // channels per CTA of the carry pass
constexpr int G = 8;          // segments of a channel's chunk summaries in the carry pass
constexpr int UC = 8;         // chunk summaries loaded ahead in the carry pass
constexpr int MIN_L = 8, MAX_L = 64;   // the chunk lengths repro_lru_scan_chunk_len picks from
constexpr int MAX_CHUNKS = 65535;      // the grid's y dimension

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// V consecutive channels of one step, loaded and stored as one unit.
template <typename T, int V> struct Pack;

template <typename T> struct Pack<T, 1> {
  T x;
  __device__ __forceinline__ void load(const T* p) { x = *p; }
  __device__ __forceinline__ void zero() { x = from_f32<T>(0.f); }
  __device__ __forceinline__ float get(int) const { return to_f32(x); }
  __device__ __forceinline__ void set(int, float v) { x = from_f32<T>(v); }
  __device__ __forceinline__ void store(T* p) const { *p = x; }
};

template <> struct Pack<float, 4> {
  float4 x;
  __device__ __forceinline__ void load(const float* p) { x = *reinterpret_cast<const float4*>(p); }
  __device__ __forceinline__ void zero() { x = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ float get(int i) const {
    return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
  }
  __device__ __forceinline__ void set(int i, float v) {
    if (i == 0) x.x = v; else if (i == 1) x.y = v; else if (i == 2) x.z = v; else x.w = v;
  }
  __device__ __forceinline__ void store(float* p) const { *reinterpret_cast<float4*>(p) = x; }
};

template <> struct Pack<__nv_bfloat16, 8> {
  uint4 x;                    // bf16 i is bits 16 (i % 2) .. +15 of word i / 2
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    x = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { x = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ uint32_t word(int i) const {
    return i < 2 ? x.x : i < 4 ? x.y : i < 6 ? x.z : x.w;
  }
  __device__ __forceinline__ float get(int i) const {  // a bf16 is the top half of an f32
    const uint32_t w = word(i);
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ __forceinline__ void set(int i, float v) {
    const uint32_t h = __bfloat16_as_ushort(__float2bfloat16(v));
    const uint32_t w = (i & 1) ? ((word(i) & 0xffffu) | (h << 16)) : ((word(i) & 0xffff0000u) | h);
    if (i < 2) x.x = w; else if (i < 4) x.y = w; else if (i < 6) x.z = w; else x.w = w;
  }
  __device__ __forceinline__ void store(__nv_bfloat16* p) const {
    *reinterpret_cast<uint4*>(p) = x;
  }
};

// V floats of the f32 scratch at p (16-byte aligned when V > 1).
template <int V> __device__ __forceinline__ void store_f32(float* p, const float* v) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

template <int V> __device__ __forceinline__ void load_f32(const float* p, float* v) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

// Steps i0 .. i0+U-1 of a chunk of n steps, rows W apart; zero past n.
template <typename T, int V>
__device__ __forceinline__ void load_steps(Pack<T, V> (&pa)[U], Pack<T, V> (&pb)[U],
                                           const T* ap, const T* bp, int i0, int n, int W) {
#pragma unroll
  for (int i = 0; i < U; ++i) {
    if (i0 + i < n) {
      pa[i].load(ap + (long)(i0 + i) * W);
      pb[i].load(bp + (long)(i0 + i) * W);
    } else {
      pa[i].zero();
      pb[i].zero();
    }
  }
}

// Pass 1: the summary (A, H) of chunk blockIdx.y of row blockIdx.z.
template <typename T, int V>
__global__ void __launch_bounds__(NT)
lru_scan_chunk_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      float* __restrict__ chunk_a, float* __restrict__ chunk_h,
                      int S, int W, int L, int nc) {
  const int w = (blockIdx.x * NT + threadIdx.x) * V;
  if (w >= W) return;
  const int c = blockIdx.y, row = blockIdx.z;
  const int t0 = c * L, n = min(L, S - t0);
  const long base = ((long)row * S + t0) * W + w;
  const T* ap = a + base;
  const T* bp = b + base;

  float A[V], H[V];
#pragma unroll
  for (int v = 0; v < V; ++v) { A[v] = 1.f; H[v] = 0.f; }
  Pack<T, V> ca[U], cb[U];
  load_steps<T, V>(ca, cb, ap, bp, 0, n, W);
  for (int i0 = 0; i0 < n; i0 += U) {
    Pack<T, V> na[U], nb[U];
    load_steps<T, V>(na, nb, ap, bp, i0 + U, n, W);
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (i0 + i < n) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float av = ca[i].get(v);
          H[v] = __fadd_rn(__fmul_rn(av, H[v]), cb[i].get(v));
          A[v] = __fmul_rn(A[v], av);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) { ca[i] = na[i]; cb[i] = nb[i]; }
  }
  const long s = ((long)row * nc + c) * W + w;
  store_f32<V>(chunk_a + s, A);
  store_f32<V>(chunk_h + s, H);
}

// Summaries c0 .. c1-1 of one (row, channel), handed to f(c, A_c, H_c) in
// order; the next UC are loaded while the current UC are used.
template <class F>
__device__ __forceinline__ void for_summaries(const float* __restrict__ chunk_a,
                                              const float* __restrict__ chunk_h,
                                              long base, int W, int c0, int c1, F f) {
  float ca[UC], ch[UC];
#pragma unroll
  for (int i = 0; i < UC; ++i) {
    const bool in = c0 + i < c1;
    ca[i] = in ? chunk_a[base + (long)(c0 + i) * W] : 0.f;
    ch[i] = in ? chunk_h[base + (long)(c0 + i) * W] : 0.f;
  }
  for (int c = c0; c < c1; c += UC) {
    float na[UC], nh[UC];
#pragma unroll
    for (int i = 0; i < UC; ++i) {
      const bool in = c + UC + i < c1;
      na[i] = in ? chunk_a[base + (long)(c + UC + i) * W] : 0.f;
      nh[i] = in ? chunk_h[base + (long)(c + UC + i) * W] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < UC; ++i)
      if (c + i < c1) f(c + i, ca[i], ch[i]);
#pragma unroll
    for (int i = 0; i < UC; ++i) { ca[i] = na[i]; ch[i] = nh[i]; }
  }
}

// Pass 2: the carry-in of chunks 1 .. nc-1 for CW channels of row
// blockIdx.y. The nc - 1 summaries that feed a later chunk are cut into G
// segments, one thread each: a thread composes its segment (A, H) as pass 1
// composes a chunk, takes its carry-in from the segments before it (in
// shared memory, in order), and re-walks the segment from there, writing
// carry_{c+1} = A_c carry_c + H_c. A chain of about nc / G + G + nc / G
// dependent steps instead of nc.
__global__ void __launch_bounds__(CW * G)
lru_scan_carry_kernel(const float* __restrict__ chunk_a, const float* __restrict__ chunk_h,
                      float* __restrict__ carry, int W, int nc) {
  __shared__ float seg_a[G][CW], seg_h[G][CW];
  const int lane = threadIdx.x % CW, g = threadIdx.x / CW;
  const int w = blockIdx.x * CW + lane;
  const int n = nc - 1, per = (n + G - 1) / G;
  const int c0 = min(n, g * per), c1 = min(n, c0 + per);
  const long base = (long)blockIdx.y * nc * W + w;
  const bool live = w < W;

  float A = 1.f, H = 0.f;
  if (live)
    for_summaries(chunk_a, chunk_h, base, W, c0, c1, [&](int, float a, float h) {
      H = __fadd_rn(__fmul_rn(a, H), h);
      A = __fmul_rn(A, a);
    });
  seg_a[g][lane] = A;
  seg_h[g][lane] = H;
  __syncthreads();
  float h = 0.f;
  for (int k = 0; k < g; ++k) h = __fadd_rn(__fmul_rn(seg_a[k][lane], h), seg_h[k][lane]);
  if (live)
    for_summaries(chunk_a, chunk_h, base, W, c0, c1, [&](int c, float a, float hc) {
      h = __fadd_rn(__fmul_rn(a, h), hc);
      carry[base + (long)(c + 1) * W] = h;
    });
}

// Pass 3: h over chunk blockIdx.y of row blockIdx.z from its carry-in.
template <typename T, int V>
__global__ void __launch_bounds__(NT)
lru_scan_apply_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ y, const float* __restrict__ carry,
                      int S, int W, int L, int nc) {
  const int w = (blockIdx.x * NT + threadIdx.x) * V;
  if (w >= W) return;
  const int c = blockIdx.y, row = blockIdx.z;
  const int t0 = c * L, n = min(L, S - t0);
  const long base = ((long)row * S + t0) * W + w;
  const T* ap = a + base;
  const T* bp = b + base;
  T* yp = y + base;

  float h[V];
  if (c == 0) {
#pragma unroll
    for (int v = 0; v < V; ++v) h[v] = 0.f;
  } else {
    load_f32<V>(carry + ((long)row * nc + c) * W + w, h);
  }
  Pack<T, V> ca[U], cb[U];
  load_steps<T, V>(ca, cb, ap, bp, 0, n, W);
  for (int i0 = 0; i0 < n; i0 += U) {
    Pack<T, V> na[U], nb[U];
    load_steps<T, V>(na, nb, ap, bp, i0 + U, n, W);
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (i0 + i < n) {
        Pack<T, V> out;
        out.zero();
#pragma unroll
        for (int v = 0; v < V; ++v) {
          h[v] = __fadd_rn(__fmul_rn(ca[i].get(v), h[v]), cb[i].get(v));
          out.set(v, h[v]);
        }
        out.store(yp + (long)(i0 + i) * W);
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) { ca[i] = na[i]; cb[i] = nb[i]; }
  }
}

// Writes the route and the CTAs it launches to grid (when not null): V, then
// the chunk, carry and apply passes' CTAs (0 for a pass not launched).
template <typename T, int V>
cudaError_t launch_passes(const T* a, const T* b, T* y, float* chunk_a, float* chunk_h,
                          float* carry, int B, int S, int W, int L, cudaStream_t stream,
                          long long* grid) {
  const int nc = (S + L - 1) / L;
  const int cols = (W + NT * V - 1) / (NT * V);
  if (grid) {
    grid[0] = V;
    grid[1] = nc > 1 ? (long long)cols * (nc - 1) * B : 0;
    grid[2] = nc > 1 ? (long long)((W + CW - 1) / CW) * B : 0;
    grid[3] = (long long)cols * nc * B;
  }
  if (nc > 1) {
    lru_scan_chunk_kernel<T, V><<<dim3(cols, nc - 1, B), NT, 0, stream>>>(
        a, b, chunk_a, chunk_h, S, W, L, nc);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    lru_scan_carry_kernel<<<dim3((W + CW - 1) / CW, B), CW * G, 0, stream>>>(
        chunk_a, chunk_h, carry, W, nc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  lru_scan_apply_kernel<T, V><<<dim3(cols, nc, B), NT, 0, stream>>>(a, b, y, carry, S, W, L, nc);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Channels a thread: 16 / sizeof(T) on the 16-byte route, 1 on the scalar one.
template <typename T> int route_width(const void* a, const void* b, const void* y, int W) {
  constexpr int V = 16 / sizeof(T);
  return W % V == 0 && aligned16(a) && aligned16(b) && aligned16(y) ? V : 1;
}

template <typename T>
cudaError_t launch_dtype(const void* a, const void* b, void* y, void* chunk_a, void* chunk_h,
                         void* carry, int B, int S, int W, int L, cudaStream_t stream,
                         long long* grid) {
  constexpr int V = 16 / sizeof(T);
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  T* ty = static_cast<T*>(y);
  float* fa = static_cast<float*>(chunk_a);
  float* fh = static_cast<float*>(chunk_h);
  float* fc = static_cast<float*>(carry);
  if (route_width<T>(a, b, y, W) == 1)
    return launch_passes<T, 1>(ta, tb, ty, fa, fh, fc, B, S, W, L, stream, grid);
  if (!aligned16(chunk_a) || !aligned16(chunk_h) || !aligned16(carry))
    return cudaErrorMisalignedAddress;
  return launch_passes<T, V>(ta, tb, ty, fa, fh, fc, B, S, W, L, stream, grid);
}

}  // namespace

// The chunk length for a scan of a, b into y on the current device: the
// longest of MAX_L, ..., MIN_L steps (halving) whose apply pass has two CTAs
// per SM on the route these pointers take, MIN_L when none has, and at least
// ceil(S / MAX_CHUNKS). Returns L >= 1, or minus a CUDA error code.
extern "C" int repro_lru_scan_chunk_len(const void* a, const void* b, const void* y, int B,
                                        int S, int W, int is_bf16) {
  if (B < 1 || S < 1 || W < 1) return -(int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  const int V = is_bf16 ? route_width<__nv_bfloat16>(a, b, y, W) : route_width<float>(a, b, y, W);
  const long cols = (W + NT * V - 1) / (NT * V);
  int L = MAX_L;
  while (L > MIN_L && B * cols * ((S + L - 1) / L) < 2L * sms) L /= 2;
  const int least = (S + MAX_CHUNKS - 1) / MAX_CHUNKS;
  return L > least ? L : least;
}

// a, b, y: (B, S, W), contiguous and of one dtype (is_bf16 = 1 for bfloat16,
// 0 for float32). chunk_a, chunk_h, carry: f32 scratch of B * ceil(S/L) * W
// elements each, from the caller, 16-byte aligned (read only when S > L).
// L: the chunk length, at least 1 (repro_lru_scan_chunk_len's for speed).
// grid: null, or 4 long longs that receive V (the channels a thread: 16 / dtype
// size on the 16-byte route, 1 on the scalar one) and the CTAs launched by
// the chunk, carry and apply passes. Launches up to three kernels on
// `stream`, does not synchronise, and returns the first nonzero
// cudaGetLastError() after a launch (0 on success).
extern "C" int repro_lru_scan(const void* a, const void* b, void* y, void* chunk_a,
                              void* chunk_h, void* carry, int B, int S, int W, int L,
                              int is_bf16, void* stream, long long* grid) {
  if (B < 1 || S < 1 || W < 1 || L < 1 || B > 65535 || (S + L - 1) / L > MAX_CHUNKS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_dtype<__nv_bfloat16>(a, b, y, chunk_a, chunk_h, carry, B, S, W, L, s, grid)
              : launch_dtype<float>(a, b, y, chunk_a, chunk_h, carry, B, S, W, L, s, grid);
  return (int)err;
}
