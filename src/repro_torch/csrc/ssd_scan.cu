// Mamba-2 SSD chunked scan (forward) for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd/kernel.py::ssd_kernel
// (body `_kernel`). Same function: per (batch, head), over chunks of
// Q = min(chunk, S) steps with a zero initial state,
//   u = dt x,  cum = cumsum(dt A) inside the chunk,
//   L_ij = exp(cum_i - cum_j) for j <= i, else 0 (masked, never exponentiated),
//   y = (C B^T o L) u + exp(cum) (C h^T),
//   h <- exp(cum_last) h + sum_j (u_j exp(cum_last - cum_j)) (x) B_j,
// with every product and the (P x N) state in f32 and y written in x's dtype.
// B and C are shared by all heads (one group); dt and A are f32.
//
// Shared by both routes:
//   * x, dt, B and C are read in place from the model's layouts
//     ((B,S,H,P), (B,S,H), (B,S,N)), x, B and C as strided views of the
//     conv output; there is no copy and no padding. The ragged last chunk
//     and S < chunk are masked: rows and keys past the chunk's end load as
//     zeros and their outputs are not written.
//   * cum is summed in order, in f64 over the f32 products dt A (rounded
//     alone, not fused), then rounded to f32: the plain version's
//     arithmetic. Over a chunk of 256 steps cum reaches -10^3 and more, and
//     exp(cum_i - cum_j) turns an ulp of cum into a relative error of 10^-4
//     in L; summed in f64, the kernel's cum and the plain version's are the
//     same f32 numbers.
//
// The bf16 route: chunk-parallel, on the tensor cores (mma.sync.m16n8k16,
// bf16 in, f32 accumulate), four launches on one stream:
//   * cum: one CTA per (batch row, chunk, group of up to 32 heads); the
//     products staged in shared memory, one thread per head sums in order.
//   * stage a, one CTA per (batch row, chunk c < last, head): the chunk's
//     state contribution S_c = x^T (B o w), w_j = dt_j exp(cum_last - cum_j),
//     a (P x N) f32 tile into scratch (B, chunks - 1, H, P, N); 64-step key
//     blocks double-buffered (B by cp.async, x into registers a block ahead).
//   * stage b, elementwise over (B, H, P, N), sequential over the chunks:
//     h_0 = 0, h_c = exp(cum_last,c-1) h_{c-1} + S_{c-1} in f32 registers,
//     each h_c written as its two-term bf16 split (below) for stage c.
//   * stage c, one CTA per (batch row, chunk, head), walking the chunk's
//     64-row query blocks and, inside each, the key blocks at or below the
//     diagonal: y_i = exp(cum_i) C_i h_c^T + sum_{j <= i} G_ij x_j with
//     G = (C B^T) o L o dt_j. C B^T is recomputed per CTA on the tensor cores
//     (exact in f32 from bf16 operands); G is formed on the score fragments
//     in registers (the mask only on the diagonal block) and feeds the next
//     product as its A fragment. h_c, cum and dt are loaded once per CTA;
//     the (query block, key block) items form one stream whose B and x key
//     blocks (and each query block's C rows) arrive by cp.async one item
//     ahead, double-buffered, into bf16 tiles padded to conflict-free
//     ldmatrix strides. (One CTA per query block was slower: each reloaded
//     h_c and repeated the prologue.)
//   At mamba2-130m's training shape that is 1,344 CTAs in stage a and 1,536
//   in stage c, each walking 10 blocks, against 384 sequential walkers in
//   the f32 route.
//   Precision: x, B and C are bf16 already, so C B^T is exact. The three
//   products with an f32 operand (G x, C h^T, x^T (B o w)) take that operand
//   as hi = bf16(t), lo = bf16(t - hi), two products into one f32
//   accumulator, against the exact bf16 side: about 16 bits of the f32
//   operand. A single bf16 rounding of those operands breaks the bf16
//   tolerance; the split stays well inside it, close to f32 (a plain
//   emulation of these stages in tests/test_torch_ssd.py is held to it).
//   L and exp(cum_i) use the fast exponential (relative error about
//   |cum_i - cum_j| 2^-24, far below that budget).
//
// The f32 route (the parity checks; TF32 would not meet their 1e-4): two
// passes on the FP32 FMA pipes. The first computes the C B^T tiles of every
// chunk once per (batch row, chunk) into an f32 scratch (B x chunks x Q x Q).
// The second has one CTA per (32 state rows p, head, batch row) walking the
// chunks in order, which takes the place of the TPU grid's sequential chunk
// axis, with its slice of the state in shared memory; per 64-row query
// block the inter-chunk term, then the masked, decayed C B^T tiles times u,
// then the state update. Tiles are f32 in shared memory, rows padded to an
// odd stride.
//
// What bounds it on the H100: the function reads x, dt, B, C once and
// writes y once (about 110 MB at B=8, S=2048, H=24, P=64, N=128 in bf16,
// 33 us at 3.35 TB/s), and the chunked form does about 18 GFLOP there
// (18 us at the 989 TFLOP/s bf16 rate), so the bound is the bytes. The bf16
// route also moves its scratch (the states, 44 MB in f32, written, read and
// written again as the split) and re-reads B and C per head from L2; the
// split doubles the products with an f32 operand. wgmma with TMA-fed tiles
// is the next step.
// P, N, H, S and chunk need not be powers of two. The bf16 route takes
// P <= 64 and N <= 128, multiples of 8; the f32 route is bounded only by
// shared memory (N = 128: 109,440 bytes per CTA of its second pass).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90_mma.cuh"

namespace {

constexpr int BI = 64;             // query rows per block
constexpr int BJ = 64;             // key rows per block
constexpr int PB = 32;             // state rows p per CTA
constexpr int NT = 256;            // threads: 16 row groups (ty) x 16 lanes (tx)
constexpr int SS = BJ + 1;         // padded row stride of the score tile
constexpr int MAX_SMEM = 232448;   // opt-in shared memory limit per block
static_assert(BI == BJ, "the first pass loads a C block and a B block in one loop");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Odd row stride for an N-wide f32 tile: 16 consecutive rows hit 16 banks.
__host__ __device__ __forceinline__ int odd_stride(int n) { return n | 1; }

__host__ __device__ __forceinline__ size_t smem_floats(int Q, int N) {
  const int ns = odd_stride(N);
  return 2 * (size_t)Q            // dt, cum
         + (size_t)BI * ns        // C block
         + (size_t)BJ * ns        // B block
         + (size_t)BJ * PB        // u block (or u * decay for the state update)
         + (size_t)BI * SS        // score tile
         + (size_t)PB * ns;       // the state slice h[p][n]
}

// First pass: the C B^T tiles of every chunk, once per (batch row, chunk)
// for all heads (B and C are shared by the heads). Grid (lower-triangular
// 64 x 64 tiles of a chunk, chunks, batch rows); each CTA writes one tile
// of cbt[b][chunk][i][j] for i, j < the chunk's length, in f32, summed over
// n in order with fused multiply-adds.
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
              float* __restrict__ cbt, int S, int N, int Q, int nc,
              long long b_sb, long long b_st, long long c_sb, long long c_st) {
  int ib = 0;                                  // tile t -> (ib, jb), jb <= ib
  const int t = blockIdx.x;
  while ((ib + 1) * (ib + 2) / 2 <= t) ++ib;
  const int jb = t - ib * (ib + 1) / 2;
  const int c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * Q, qc = min(Q, S - c0);
  const int i0 = ib * BI, j0 = jb * BJ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int ns = odd_stride(N);
  extern __shared__ float smem[];
  float* s_c = smem;                  // BI x ns
  float* s_b = s_c + BI * ns;         // BJ x ns
  const T* cb = Cm + b * c_sb;
  const T* bb = Bm + b * b_sb;
  for (int e = tid; e < BI * N; e += NT) {
    const int ii = e / N, n = e % N, i = i0 + ii, j = j0 + ii;
    s_c[ii * ns + n] = i < qc ? to_f32(cb[(c0 + i) * c_st + n]) : 0.f;
    s_b[ii * ns + n] = j < qc ? to_f32(bb[(c0 + j) * b_st + n]) : 0.f;
  }
  __syncthreads();
  float sacc[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int l = 0; l < 4; ++l) sacc[k][l] = 0.f;
  for (int n = 0; n < N; ++n) {
    float cv[4], bv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) cv[k] = s_c[(ty + 16 * k) * ns + n];
#pragma unroll
    for (int l = 0; l < 4; ++l) bv[l] = s_b[(tx + 16 * l) * ns + n];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int l = 0; l < 4; ++l) sacc[k][l] = fmaf(cv[k], bv[l], sacc[k][l]);
  }
  float* out = cbt + ((size_t)(b * nc + c) * Q + i0) * Q + j0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ii = ty + 16 * k;
    if (i0 + ii >= qc) continue;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int jj = tx + 16 * l;
      if (j0 + jj < qc) out[(size_t)ii * Q + jj] = sacc[k][l];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, T* __restrict__ y, int S, int H,
               const float* __restrict__ cbt, int P, int N, int Q, int nc,
               long long x_sb, long long x_st, long long b_sb, long long b_st,
               long long c_sb, long long c_st) {
  const int p0 = blockIdx.x * PB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int ns = odd_stride(N);

  extern __shared__ float smem[];
  float* s_dt = smem;                 // Q
  float* s_cum = s_dt + Q;            // Q
  float* s_c = s_cum + Q;             // BI x ns
  float* s_b = s_c + BI * ns;         // BJ x ns
  float* s_u = s_b + BJ * ns;         // BJ x PB
  float* s_sc = s_u + BJ * PB;        // BI x SS
  float* s_h = s_sc + BI * SS;        // PB x ns

  const float a_h = A[h];
  const size_t row_y = (size_t)H * P;          // stride of t in y
  const T* xb = x + b * x_sb + (size_t)h * P;
  T* yb = y + (size_t)b * S * row_y + (size_t)h * P;
  const float* dtb = dt + (size_t)b * S * H + h;
  const T* bb = Bm + b * b_sb;
  const T* cb = Cm + b * c_sb;

  for (int i = tid; i < PB * ns; i += NT) s_h[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int qc = min(Q, S - c0);             // steps in this chunk
    for (int i = tid; i < qc; i += NT) s_dt[i] = dtb[(size_t)(c0 + i) * H];
    __syncthreads();
    if (tid == 0) {                            // cum = cumsum(dt A), in order
      double acc = 0.0;
      for (int i = 0; i < qc; ++i) {
        acc += (double)__fmul_rn(s_dt[i], a_h);
        s_cum[i] = (float)acc;
      }
    }
    __syncthreads();

    // Loads one key block of u = dt x (times exp(cum_last - cum_j) when
    // `to_end`), zeros past the chunk's end and past P.
    auto load_u = [&](int j0, bool to_end) {
      const float cum_last = s_cum[qc - 1];
      for (int e = tid; e < BJ * PB; e += NT) {
        const int jj = e / PB, pp = e % PB, j = j0 + jj, p = p0 + pp;
        float u = 0.f;
        if (j < qc && p < P) {
          u = s_dt[j] * to_f32(xb[(c0 + j) * x_st + p]);
          if (to_end) u = expf(cum_last - s_cum[j]) * u;
        }
        s_u[jj * PB + pp] = u;
      }
    };

    const int nblk = (qc + BI - 1) / BI;
    for (int ib = 0; ib < nblk; ++ib) {
      const int i0 = ib * BI;
      for (int e = tid; e < BI * N; e += NT) {
        const int ii = e / N, n = e % N, i = i0 + ii;
        s_c[ii * ns + n] = i < qc ? to_f32(cb[(c0 + i) * c_st + n]) : 0.f;
      }
      __syncthreads();

      // inter-chunk term: y[i][p] = exp(cum_i) sum_n C[i][n] h[p][n]
      float yacc[4][2];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 0; m < 2; ++m) yacc[k][m] = 0.f;
      if (c0 > 0) {
        for (int n = 0; n < N; ++n) {
          float cv[4], hv[2];
#pragma unroll
          for (int k = 0; k < 4; ++k) cv[k] = s_c[(ty + 16 * k) * ns + n];
#pragma unroll
          for (int m = 0; m < 2; ++m) hv[m] = s_h[(tx + 16 * m) * ns + n];
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int m = 0; m < 2; ++m) yacc[k][m] = fmaf(cv[k], hv[m], yacc[k][m]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = i0 + ty + 16 * k;
          const float e = i < qc ? expf(s_cum[i]) : 0.f;
#pragma unroll
          for (int m = 0; m < 2; ++m) yacc[k][m] *= e;
        }
      }

      // intra-chunk term over the key blocks j0 <= i0
      for (int jb = 0; jb <= ib; ++jb) {
        const int j0 = jb * BJ;
        load_u(j0, false);
        // the C B^T tile from the first pass, masked and decayed: exp is
        // taken for j <= i only
        const float* tile = cbt + ((size_t)(b * nc + c0 / Q) * Q + i0) * Q + j0;
        for (int e = tid; e < BI * BJ; e += NT) {
          const int ii = e / BJ, jj = e % BJ, i = i0 + ii, j = j0 + jj;
          s_sc[ii * SS + jj] = (j <= i && i < qc)
                                   ? tile[(size_t)ii * Q + jj] * expf(s_cum[i] - s_cum[j])
                                   : 0.f;
        }
        __syncthreads();
        const int jn = min(BJ, qc - j0);
        for (int jj = 0; jj < jn; ++jj) {
          float sv[4], uv[2];
#pragma unroll
          for (int k = 0; k < 4; ++k) sv[k] = s_sc[(ty + 16 * k) * SS + jj];
#pragma unroll
          for (int m = 0; m < 2; ++m) uv[m] = s_u[jj * PB + tx + 16 * m];
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int m = 0; m < 2; ++m) yacc[k][m] = fmaf(sv[k], uv[m], yacc[k][m]);
        }
        __syncthreads();
      }

#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + ty + 16 * k;
        if (i >= qc) continue;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int p = p0 + tx + 16 * m;
          if (p < P) yb[(size_t)(c0 + i) * row_y + p] = from_f32<T>(yacc[k][m]);
        }
      }
    }

    if (c0 + qc >= S) break;                   // y only: no state after the last chunk

    // state update: h = exp(cum_last) h + sum_j (u_j exp(cum_last - cum_j)) B_j.
    // Thread (ty, tx) owns h[ty + 16a][tx + 16 n'] for all a, n'.
    const float decay = expf(s_cum[qc - 1]);
    for (int pp = ty; pp < PB; pp += 16)
      for (int n = tx; n < N; n += 16) s_h[pp * ns + n] *= decay;
    for (int j0 = 0; j0 < qc; j0 += BJ) {
      load_u(j0, true);
      for (int e = tid; e < BJ * N; e += NT) {
        const int jj = e / N, n = e % N, j = j0 + jj;
        s_b[jj * ns + n] = j < qc ? to_f32(bb[(c0 + j) * b_st + n]) : 0.f;
      }
      __syncthreads();
      const int jn = min(BJ, qc - j0);
      for (int g0 = 0; g0 < N; g0 += 128) {    // 8 columns of 16 per pass
        float hacc[2][8];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int g = 0; g < 8; ++g) hacc[a][g] = 0.f;
        for (int jj = 0; jj < jn; ++jj) {
          float uv[2], bv[8];
#pragma unroll
          for (int a = 0; a < 2; ++a) uv[a] = s_u[jj * PB + ty + 16 * a];
#pragma unroll
          for (int g = 0; g < 8; ++g) {
            const int n = g0 + tx + 16 * g;
            bv[g] = n < N ? s_b[jj * ns + n] : 0.f;
          }
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int g = 0; g < 8; ++g) hacc[a][g] = fmaf(uv[a], bv[g], hacc[a][g]);
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int g = 0; g < 8; ++g) {
            const int n = g0 + tx + 16 * g;
            if (n < N) s_h[(ty + 16 * a) * ns + n] += hacc[a][g];
          }
      }
      __syncthreads();
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, void* y, float* cbt, int B,
                   int S, int H, int P, int N, int Q, const long long* st,
                   cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q;
  const int nblk = (Q + BI - 1) / BI;
  const size_t smem = smem_floats(Q, N) * sizeof(float);
  const size_t smem_cb = (size_t)(BI + BJ) * odd_stride(N) * sizeof(float);
  if (smem > (size_t)MAX_SMEM || nc > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_cb_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_cb);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      ssd_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid_cb(nblk * (nblk + 1) / 2, nc, B);
  ssd_cb_kernel<T><<<grid_cb, NT, smem_cb, stream>>>(
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), cbt, S, N, Q, nc,
      st[2], st[3], st[4], st[5]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((P + PB - 1) / PB, H, B);
  ssd_fwd_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), S, H, cbt, P, N, Q, nc,
      st[0], st[1], st[2], st[3], st[4], st[5]);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 route
// Chunk-parallel tensor-core version (see the header): the cum kernel, stage
// a (per-chunk states), stage b (the state pass) and stage c (the chunk
// scan). P <= TC_PMAX and N <= TC_NMAX, both multiples of 8; the wrapper
// checks the 16-byte alignment cp.async needs.
constexpr int TC_NT = 128;            // 4 warps
constexpr int TC_PMAX = 64;
constexpr int TC_NMAX = 128;
constexpr int TC_BLK = 64;            // rows of a query block, keys of a key block
constexpr int TC_PSTR = TC_PMAX + 8;  // padded bf16 row strides: conflict-free ldmatrix
constexpr int TC_NSTR = TC_NMAX + 8;

using bf16 = __nv_bfloat16;

// cum for every (batch row, chunk, head): the in-order sum of the f32
// products dt A in f64, rounded once, into cum (B, S, H), dt's layout. One CTA
// per (batch row, chunk, group of up to CUM_HEADS heads): the products are
// staged in shared memory by all threads (coalesced), one thread per head
// sums its column in order, and all threads write cum back.
constexpr int CUM_HEADS = 32;

__global__ void __launch_bounds__(TC_NT)
ssd_cum_kernel(const float* __restrict__ dt, const float* __restrict__ A,
               float* __restrict__ cum, int S, int H, int Q, int nc) {
  extern __shared__ float s_prod[];                   // qc x hg
  const int ng = (H + CUM_HEADS - 1) / CUM_HEADS;
  const int h0 = blockIdx.x % ng * CUM_HEADS;
  const int c = blockIdx.x / ng % nc, b = blockIdx.x / ng / nc;
  const int hg = min(CUM_HEADS, H - h0);
  const int c0 = c * Q, qc = min(Q, S - c0);
  const size_t base = ((size_t)b * S + c0) * H + h0;
  for (int e = threadIdx.x; e < qc * hg; e += TC_NT)
    s_prod[e] = __fmul_rn(dt[base + (size_t)(e / hg) * H + e % hg], A[h0 + e % hg]);
  __syncthreads();
  if (threadIdx.x < hg) {
    double acc = 0.0;
    float* col = s_prod + threadIdx.x;
    for (int i0 = 0; i0 < qc; i0 += 8) {               // 8 loads in flight, then 8 sums
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = i0 + u < qc ? col[(i0 + u) * hg] : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        acc += (double)v[u];
        if (i0 + u < qc) col[(i0 + u) * hg] = (float)acc;
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < qc * hg; e += TC_NT)
    cum[base + (size_t)(e / hg) * H + e % hg] = s_prod[e];
}

// Zeroes columns [from, to) of `rows` padded bf16 rows.
__device__ __forceinline__ void zero_cols(bf16* t, int rows, int stride, int from, int to) {
  const int w = to - from;
  if (w <= 0) return;
  for (int e = threadIdx.x; e < rows * w; e += TC_NT)
    t[(e / w) * stride + from + e % w] = __float2bfloat16(0.f);
}

// Stage a, one CTA per (batch row, chunk c < nc - 1, head): the chunk's state
// contribution S_c[p][n] = sum_j v[j][p] B[j][n], v = exp(cum_last - cum_j)
// (dt_j x[j][p]), into states (B, nc - 1, H, P, N) f32. v is f32 and goes in
// as its two-term bf16 split; B is exact bf16. Warp w owns p rows 16w..16w+15.
// Key blocks of 64 steps are double-buffered: B by cp.async, x (with cum and
// dt) into registers, one block ahead, and split into shared memory after
// the current block's products.
constexpr int STATE_XPT = TC_BLK * (TC_PMAX / 8) / TC_NT;   // x chunks per thread

__global__ void __launch_bounds__(TC_NT)
ssd_state_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ cum, const bf16* __restrict__ Bm,
                    float* __restrict__ states, int S, int H, int P, int N, int Q,
                    int nc, long long x_sb, long long x_st, long long b_sb,
                    long long b_st) {
  using namespace sm90;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sB = reinterpret_cast<bf16*>(smem_raw);        // 2 x TC_BLK x NSTR
  bf16* sVh = sB + 2 * TC_BLK * TC_NSTR;                // 2 x TC_BLK x PSTR
  bf16* sVl = sVh + 2 * TC_BLK * TC_PSTR;               // 2 x TC_BLK x PSTR

  const int h = blockIdx.x % H;
  const int c = blockIdx.x / H % (nc - 1);
  const int b = blockIdx.x / H / (nc - 1);
  const int c0 = c * Q;                                 // a full chunk: Q steps
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int N16 = (N + 15) / 16 * 16, P16 = (P + 15) / 16 * 16;
  zero_cols(sB, 2 * TC_BLK, TC_NSTR, N, N16);
  const bf16* xb = x + b * x_sb + (size_t)h * P;
  const bf16* bb = Bm + b * b_sb;
  const float* cumb = cum + (size_t)b * S * H + h;
  const float* dtb = dt + (size_t)b * S * H + h;
  const float cum_last = cumb[(size_t)(c0 + Q - 1) * H];
  const int cpr_b = N / 8, cpr_x = P16 / 8;
  const int nj = (Q + TC_BLK - 1) / TC_BLK;

  auto load_b = [&](int jb, int stage) {
    for (int e = tid; e < TC_BLK * cpr_b; e += TC_NT) {
      const int r = e / cpr_b, col = (e % cpr_b) * 8, j = jb * TC_BLK + r;
      const bool in = j < Q;
      cp_async16(smem_addr(sB + (stage * TC_BLK + r) * TC_NSTR + col),
                 in ? bb + (c0 + j) * b_st + col : bb, in);
    }
  };
  uint4 xr[STATE_XPT];                                  // x, cum and dt of the next block
  float cr[STATE_XPT], dr[STATE_XPT];
  auto load_x = [&](int jb) {
#pragma unroll
    for (int k = 0; k < STATE_XPT; ++k) {
      const int e = tid + k * TC_NT, r = e / cpr_x, col = (e % cpr_x) * 8;
      const int j = jb * TC_BLK + r;
      xr[k] = make_uint4(0, 0, 0, 0);
      cr[k] = cum_last;                                 // v = 0 past the chunk or P
      dr[k] = 0.f;
      if (e < TC_BLK * cpr_x && j < Q && col < P) {
        xr[k] = *reinterpret_cast<const uint4*>(xb + (c0 + j) * x_st + col);
        cr[k] = cumb[(size_t)(c0 + j) * H];
        dr[k] = dtb[(size_t)(c0 + j) * H];
      }
    }
  };
  auto store_v = [&](int stage) {                       // v's split, [j][p]
#pragma unroll
    for (int k = 0; k < STATE_XPT; ++k) {
      const int e = tid + k * TC_NT, r = e / cpr_x, col = (e % cpr_x) * 8;
      if (e >= TC_BLK * cpr_x) continue;
      const float w = expf(cum_last - cr[k]);
      const bf16* xv = reinterpret_cast<const bf16*>(&xr[k]);
      uint4 hi, lo;
      uint32_t* ph = reinterpret_cast<uint32_t*>(&hi);
      uint32_t* pl = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        split_bf16(__fmul_rn(w, __fmul_rn(dr[k], __bfloat162float(xv[2 * u]))),
                   __fmul_rn(w, __fmul_rn(dr[k], __bfloat162float(xv[2 * u + 1]))), ph[u],
                   pl[u]);
      *reinterpret_cast<uint4*>(sVh + (stage * TC_BLK + r) * TC_PSTR + col) = hi;
      *reinterpret_cast<uint4*>(sVl + (stage * TC_BLK + r) * TC_PSTR + col) = lo;
    }
  };

  float acc[TC_NMAX / 8][4];
#pragma unroll
  for (int j = 0; j < TC_NMAX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // ldmatrix.trans row addresses: A = v^T from v's rows [j][p]; B from B's rows.
  const int a_row = (lane & 7) + ((lane >> 4) << 3), a_col = ((lane >> 3) & 1) * 8;
  const int b_row = (lane & 7) + (((lane >> 3) & 1) << 3), b_col = (lane >> 4) * 8;
  const int p0 = warp * 16;

  load_b(0, 0);
  cp_async_commit();
  load_x(0);
  store_v(0);
  for (int jb = 0; jb < nj; ++jb) {
    const int stage = jb & 1;
    if (jb + 1 < nj) {
      load_b(jb + 1, stage ^ 1);
      load_x(jb + 1);                                   // lands during the products
    }
    cp_async_commit();
    cp_async_wait<1>();                                 // B of block jb has landed
    __syncthreads();
    if (p0 < P) {
      // A k-step's fragments are loaded before its products, and the hi and
      // lo products of one tile are a whole pass apart.
#pragma unroll
      for (int kk = 0; kk < TC_BLK / 16; ++kk) {
        uint32_t ah[4], al[4], bf[TC_NMAX / 16][4];
        const int off = (stage * TC_BLK + kk * 16 + a_row) * TC_PSTR + p0 + a_col;
        ldsm_x4_trans(ah, smem_addr(sVh + off));
        ldsm_x4_trans(al, smem_addr(sVl + off));
#pragma unroll
        for (int np = 0; np < TC_NMAX / 16; ++np)
          if (np * 16 < N)
            ldsm_x4_trans(bf[np], smem_addr(sB + (stage * TC_BLK + kk * 16 + b_row) * TC_NSTR +
                                            np * 16 + b_col));
#pragma unroll
        for (int np = 0; np < TC_NMAX / 16; ++np)
          if (np * 16 < N) {
            mma_bf16(acc[2 * np], ah, bf[np][0], bf[np][1]);
            mma_bf16(acc[2 * np + 1], ah, bf[np][2], bf[np][3]);
          }
#pragma unroll
        for (int np = 0; np < TC_NMAX / 16; ++np)
          if (np * 16 < N) {
            mma_bf16(acc[2 * np], al, bf[np][0], bf[np][1]);
            mma_bf16(acc[2 * np + 1], al, bf[np][2], bf[np][3]);
          }
      }
    }
    if (jb + 1 < nj) store_v(stage ^ 1);                // read after the next barrier
    __syncthreads();                                    // stage is refilled at jb + 2
  }

  float* out = states + ((((size_t)b * (nc - 1) + c) * H + h) * P) * N;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = p0 + g + 8 * r;
    if (p >= P) continue;
#pragma unroll
    for (int nt = 0; nt < TC_NMAX / 8; ++nt) {
      const int n = nt * 8 + 2 * tq;
      if (n < N)
        *reinterpret_cast<float2*>(out + (size_t)p * N + n) =
            make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
    }
  }
}

// Stage b: the state pass, elementwise over (B, H, P, N), sequential over the
// chunks: h_1 = S_0, h_{c+1} = exp(cum_last,c) h_c + S_c, in f32 registers.
// Slot c of hsplit (B, nc - 1, H, 2, P, N) bf16 takes the state at the start
// of chunk c + 1 as its two-term split (hi, then lo), the operand stage c
// copies asynchronously. Four consecutive elements per thread.
__global__ void __launch_bounds__(256)
ssd_pass_kernel(const float* __restrict__ states, const float* __restrict__ cum,
                bf16* __restrict__ hsplit, int B, int S, int H, int P, int N, int Q,
                int nc) {
  const long e4 = ((long)blockIdx.x * 256 + threadIdx.x) * 4;
  const long per_b = (long)H * P * N;
  if (e4 >= (long)B * per_b) return;
  const int b = (int)(e4 / per_b);
  const long pn = (long)P * N;
  const int h = (int)(e4 % per_b / pn);
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc - 1; ++c) {
    const float d = expf(cum[((size_t)b * S + (size_t)(c + 1) * Q - 1) * H + h]);
    const size_t slot = ((size_t)b * (nc - 1) + c) * per_b;
    const float4 sc = *reinterpret_cast<const float4*>(states + slot + e4 % per_b);
    run.x = __fadd_rn(__fmul_rn(d, run.x), sc.x);
    run.y = __fadd_rn(__fmul_rn(d, run.y), sc.y);
    run.z = __fadd_rn(__fmul_rn(d, run.z), sc.z);
    run.w = __fadd_rn(__fmul_rn(d, run.w), sc.w);
    uint2 hi, lo;
    sm90::split_bf16(run.x, run.y, hi.x, lo.x);
    sm90::split_bf16(run.z, run.w, hi.y, lo.y);
    bf16* out = hsplit + 2 * slot + (size_t)h * pn + e4 % per_b;   // (.., h, 2, P, N)
    *reinterpret_cast<uint2*>(out) = hi;
    *reinterpret_cast<uint2*>(out + pn) = lo;
  }
}

// Stage c, one CTA per (batch row, chunk, head), walking the chunk's 64-row
// query blocks ib and, inside each, the key blocks jb <= ib (blocks above the
// diagonal are skipped); warp w owns rows 16w..16w+15 of the query block:
//   y_i = exp(cum_i) C_i h_c^T + sum_{j <= i} G_ij x_j,
//   G_ij = (C_i . B_j) exp(cum_i - cum_j) dt_j.
// C_i . B_j is exact bf16 on tensor cores; the f32 operands G (from the
// score fragments in registers) and h_c (through shared memory) go in as
// their two-term bf16 split (h_c already split by stage b), against the exact
// bf16 x and C. h_c, cum and dt are loaded once per CTA; the (query block,
// key block) items form one stream whose key blocks of B and x (and each
// query block's C block) arrive by cp.async one item ahead.
__global__ void __launch_bounds__(TC_NT, 2)
ssd_chunk_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ cum, const bf16* __restrict__ Bm,
                    const bf16* __restrict__ Cm, const bf16* __restrict__ hsplit,
                    bf16* __restrict__ y, int S, int H, int P, int N, int Q, int nc,
                    long long x_sb, long long x_st, long long b_sb, long long b_st,
                    long long c_sb, long long c_st) {
  using namespace sm90;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sC = reinterpret_cast<bf16*>(smem_raw);         // TC_BLK x NSTR
  bf16* sB = sC + TC_BLK * TC_NSTR;                      // 2 x TC_BLK x NSTR
  bf16* sX = sB + 2 * TC_BLK * TC_NSTR;                  // 2 x TC_BLK x PSTR
  bf16* sHh = sX + 2 * TC_BLK * TC_PSTR;                 // PMAX x NSTR
  bf16* sHl = sHh + TC_PMAX * TC_NSTR;                   // PMAX x NSTR
  float* sCum = reinterpret_cast<float*>(sHl + TC_PMAX * TC_NSTR);  // Q
  float* sDt = sCum + (Q + TC_BLK - 1) / TC_BLK * TC_BLK;            // Q

  const int h = blockIdx.x % H, c = blockIdx.x / H % nc, b = blockIdx.x / H / nc;
  const int c0 = c * Q, qc = min(Q, S - c0);
  const int nblk = (qc + TC_BLK - 1) / TC_BLK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int N16 = (N + 15) / 16 * 16, P16 = (P + 15) / 16 * 16;

  zero_cols(sC, TC_BLK, TC_NSTR, N, N16);
  zero_cols(sB, 2 * TC_BLK, TC_NSTR, N, N16);
  zero_cols(sX, 2 * TC_BLK, TC_PSTR, P, P16);
  zero_cols(sHh, 2 * TC_PMAX, TC_NSTR, N, N16);          // sHh and sHl

  const bf16* xb = x + b * x_sb + (size_t)h * P;
  const bf16* bb = Bm + b * b_sb;
  const bf16* cb = Cm + b * c_sb;
  const int cpr_n = N / 8, cpr_p = P / 8;

  auto load_c = [&](int ib) {                           // query rows of block ib
    for (int e = tid; e < TC_BLK * cpr_n; e += TC_NT) {
      const int r = e / cpr_n, col = (e % cpr_n) * 8, i = ib * TC_BLK + r;
      const bool in = i < qc;
      cp_async16(smem_addr(sC + r * TC_NSTR + col), in ? cb + (c0 + i) * c_st + col : cb,
                 in);
    }
  };
  auto load_keys = [&](int jb, int stage) {             // key rows of B and x
    const int j0 = jb * TC_BLK;
    for (int e = tid; e < TC_BLK * cpr_n; e += TC_NT) {
      const int r = e / cpr_n, col = (e % cpr_n) * 8, j = j0 + r;
      const bool in = j < qc;
      cp_async16(smem_addr(sB + (stage * TC_BLK + r) * TC_NSTR + col),
                 in ? bb + (c0 + j) * b_st + col : bb, in);
    }
    for (int e = tid; e < TC_BLK * cpr_p; e += TC_NT) {
      const int r = e / cpr_p, col = (e % cpr_p) * 8, j = j0 + r;
      const bool in = j < qc;
      cp_async16(smem_addr(sX + (stage * TC_BLK + r) * TC_PSTR + col),
                 in ? xb + (c0 + j) * x_st + col : xb, in);
    }
  };

  if (c > 0) {                                          // h_c as (hi, lo), [p][n]
    const size_t pn = (size_t)P * N;
    const bf16* hs = hsplit + (((size_t)b * (nc - 1) + c - 1) * H + h) * 2 * pn;
    for (int e = tid; e < 2 * P * cpr_n; e += TC_NT) {
      const int t = e / (P * cpr_n), p = e % (P * cpr_n) / cpr_n;
      const int col = (e % cpr_n) * 8;
      cp_async16(smem_addr((t ? sHl : sHh) + p * TC_NSTR + col), hs + t * pn + p * N + col,
                 true);
    }
  }
  load_c(0);
  load_keys(0, 0);
  cp_async_commit();
  for (int j = tid; j < qc; j += TC_NT) {
    const size_t t = ((size_t)b * S + c0 + j) * H + h;
    sCum[j] = cum[t];
    sDt[j] = dt[t];
  }

  const int r0 = warp * 16;
  // ldmatrix row addresses: A from row-major C; B = (.)^T from the rows of B
  // or h (non-transposed); B = x from x's rows (transposed).
  const int a_row = r0 + (lane & 15), a_col = (lane >> 4) * 8;
  const int n_row = (lane & 7) + ((lane >> 4) << 3), n_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3), t_col = (lane >> 4) * 8;
  uint32_t cf[TC_NMAX / 16][4];
  float acc[TC_PMAX / 8][4];
  int row_a = 0, row_b = 0;                             // this lane's two rows
  float cum_a = 0.f, cum_b = 0.f;

  int n = 0;                                            // item (ib, jb), in order
  for (int ib = 0; ib < nblk; ++ib) {
    for (int jb = 0; jb <= ib; ++jb, ++n) {
      const int stage = n & 1;
      cp_async_wait<0>();                               // item n (and C of ib) landed
      __syncthreads();                                  // ... for every warp; item n - 1 done
      if (jb == 0) {                                    // a new query block
        row_a = ib * TC_BLK + r0 + g;
        row_b = row_a + 8;
        cum_a = row_a < qc ? sCum[row_a] : 0.f;
        cum_b = row_b < qc ? sCum[row_b] : 0.f;
#pragma unroll
        for (int kk = 0; kk < TC_NMAX / 16; ++kk)
          if (kk * 16 < N) ldsm_x4(cf[kk], smem_addr(sC + a_row * TC_NSTR + kk * 16 + a_col));
        __syncthreads();                                // sC may be refilled below
      }
      // the next item's loads, one item ahead
      if (jb < ib) {
        load_keys(jb + 1, stage ^ 1);
      } else if (ib + 1 < nblk) {
        load_c(ib + 1);
        load_keys(0, stage ^ 1);
      }
      cp_async_commit();

      if (jb == 0) {
#pragma unroll
        for (int j = 0; j < TC_PMAX / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        if (c > 0) {                                    // exp(cum_i) C_i h_c^T
#pragma unroll
          for (int kk = 0; kk < TC_NMAX / 16; ++kk) {
            if (kk * 16 >= N) continue;
            uint32_t bh[TC_PMAX / 16][4], bl[TC_PMAX / 16][4];
#pragma unroll
            for (int pp = 0; pp < TC_PMAX / 16; ++pp)
              if (pp * 16 < P) {
                const int off = (pp * 16 + n_row) * TC_NSTR + kk * 16 + n_col;
                ldsm_x4(bh[pp], smem_addr(sHh + off));
                ldsm_x4(bl[pp], smem_addr(sHl + off));
              }
            // hi and lo products of one tile a whole pass apart
#pragma unroll
            for (int pp = 0; pp < TC_PMAX / 16; ++pp)
              if (pp * 16 < P) {
                mma_bf16(acc[2 * pp], cf[kk], bh[pp][0], bh[pp][1]);
                mma_bf16(acc[2 * pp + 1], cf[kk], bh[pp][2], bh[pp][3]);
              }
#pragma unroll
            for (int pp = 0; pp < TC_PMAX / 16; ++pp)
              if (pp * 16 < P) {
                mma_bf16(acc[2 * pp], cf[kk], bl[pp][0], bl[pp][1]);
                mma_bf16(acc[2 * pp + 1], cf[kk], bl[pp][2], bl[pp][3]);
              }
          }
          const float ea = row_a < qc ? __expf(cum_a) : 0.f;
          const float eb = row_b < qc ? __expf(cum_b) : 0.f;
#pragma unroll
          for (int j = 0; j < TC_PMAX / 8; ++j) {
            acc[j][0] *= ea; acc[j][1] *= ea;
            acc[j][2] *= eb; acc[j][3] *= eb;
          }
        }
      }

      const int j0 = jb * TC_BLK;
      const bf16* sBs = sB + stage * TC_BLK * TC_NSTR;
      const bf16* sXs = sX + stage * TC_BLK * TC_PSTR;
      float sc[TC_BLK / 8][4];                          // C_i . B_j
#pragma unroll
      for (int j = 0; j < TC_BLK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < TC_NMAX / 16; ++kk) {
        if (kk * 16 >= N) continue;
        uint32_t bk[TC_BLK / 16][4];
#pragma unroll
        for (int jp = 0; jp < TC_BLK / 16; ++jp)
          ldsm_x4(bk[jp], smem_addr(sBs + (jp * 16 + n_row) * TC_NSTR + kk * 16 + n_col));
#pragma unroll
        for (int jp = 0; jp < TC_BLK / 16; ++jp) {
          mma_bf16(sc[2 * jp], cf[kk], bk[jp][0], bk[jp][1]);
          mma_bf16(sc[2 * jp + 1], cf[kk], bk[jp][2], bk[jp][3]);
        }
      }
      // G = (C B^T) o L o dt_j. Only the diagonal block is masked, to j <= i
      // (a select, so an exp of the upper triangle is discarded, never
      // multiplied); keys past the chunk's end occur only there. Rows past
      // the end are never written, whatever they hold.
      const bool diag = jb == ib;
#pragma unroll
      for (int jt = 0; jt < TC_BLK / 8; ++jt) {
        const int j = j0 + jt * 8 + 2 * tq;             // this lane's keys j, j + 1
        const float2 cj = *reinterpret_cast<const float2*>(sCum + j);
        const float2 dj = *reinterpret_cast<const float2*>(sDt + j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l = __expf(((e < 2) ? cum_a : cum_b) - ((e & 1) ? cj.y : cj.x));
          const float v = __fmul_rn(__fmul_rn(sc[jt][e], l), (e & 1) ? dj.y : dj.x);
          sc[jt][e] = (!diag || j + (e & 1) <= ((e < 2) ? row_a : row_b)) ? v : 0.f;
        }
      }
      // y += G x, G split in registers
#pragma unroll
      for (int kk = 0; kk < TC_BLK / 16; ++kk) {
        uint32_t gh[4], gl[4];
        split_bf16(sc[2 * kk][0], sc[2 * kk][1], gh[0], gl[0]);
        split_bf16(sc[2 * kk][2], sc[2 * kk][3], gh[1], gl[1]);
        split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], gh[2], gl[2]);
        split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], gh[3], gl[3]);
        uint32_t bx[TC_PMAX / 16][4];
#pragma unroll
        for (int pp = 0; pp < TC_PMAX / 16; ++pp)
          if (pp * 16 < P)
            ldsm_x4_trans(bx[pp], smem_addr(sXs + (kk * 16 + t_row) * TC_PSTR + pp * 16 + t_col));
#pragma unroll
        for (int pp = 0; pp < TC_PMAX / 16; ++pp)
          if (pp * 16 < P) {
            mma_bf16(acc[2 * pp], gh, bx[pp][0], bx[pp][1]);
            mma_bf16(acc[2 * pp + 1], gh, bx[pp][2], bx[pp][3]);
          }
#pragma unroll
        for (int pp = 0; pp < TC_PMAX / 16; ++pp)
          if (pp * 16 < P) {
            mma_bf16(acc[2 * pp], gl, bx[pp][0], bx[pp][1]);
            mma_bf16(acc[2 * pp + 1], gl, bx[pp][2], bx[pp][3]);
          }
      }

      if (jb == ib) {                                   // the query block is done
        bf16* yb = y + ((size_t)b * S + c0) * H * P + (size_t)h * P;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = r ? row_b : row_a;
          if (i >= qc) continue;
#pragma unroll
          for (int nt = 0; nt < TC_PMAX / 8; ++nt) {
            const int p = nt * 8 + 2 * tq;
            if (p < P)
              *reinterpret_cast<__nv_bfloat162*>(yb + (size_t)i * H * P + p) =
                  __floats2bfloat162_rn(acc[nt][2 * r], acc[nt][2 * r + 1]);
          }
        }
      }
    }
  }
}

size_t chunk_tc_smem(int Q) {
  const int keys = (Q + TC_BLK - 1) / TC_BLK * TC_BLK;
  return sizeof(bf16) * (size_t)(3 * TC_BLK * TC_NSTR + 2 * TC_BLK * TC_PSTR +
                                 2 * TC_PMAX * TC_NSTR) +
         sizeof(float) * 2 * (size_t)keys;
}
constexpr size_t STATE_TC_SMEM =
    sizeof(bf16) * (size_t)(2 * TC_BLK * TC_NSTR + 4 * TC_BLK * TC_PSTR);

cudaError_t launch_tc(const void* x, const float* dt, const float* A, const void* Bm,
                      const void* Cm, void* y, float* cum, float* states, bf16* hsplit,
                      int B, int S, int H, int P, int N, int Q, const long long* st,
                      cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q;
  const size_t smem_c = chunk_tc_smem(Q);
  if (P > TC_PMAX || N > TC_NMAX || P % 8 || N % 8 || smem_c > (size_t)MAX_SMEM ||
      (long)B * nc * H > 0x7fffffffL)
    return cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* bm = static_cast<const bf16*>(Bm);
  const bf16* cm = static_cast<const bf16*>(Cm);
  const int ng = (H + CUM_HEADS - 1) / CUM_HEADS;
  const size_t smem_cum = sizeof(float) * (size_t)Q * min(H, CUM_HEADS);
  if (smem_cum > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_cum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_cum);
  if (err != cudaSuccess) return err;
  ssd_cum_kernel<<<(unsigned)((long)B * nc * ng), TC_NT, smem_cum, stream>>>(
      dt, A, cum, S, H, Q, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (nc > 1) {
    err = cudaFuncSetAttribute(ssd_state_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)STATE_TC_SMEM);
    if (err != cudaSuccess) return err;
    ssd_state_tc_kernel<<<(unsigned)((long)B * (nc - 1) * H), TC_NT, STATE_TC_SMEM,
                          stream>>>(xb, dt, cum, bm, states, S, H, P, N, Q, nc, st[0],
                                    st[1], st[2], st[3]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long quads = (long)B * H * P * N / 4;
    ssd_pass_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(
        states, cum, hsplit, B, S, H, P, N, Q, nc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(ssd_chunk_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
  if (err != cudaSuccess) return err;
  ssd_chunk_tc_kernel<<<(unsigned)((long)B * nc * H), TC_NT, smem_c, stream>>>(
      xb, dt, cum, bm, cm, hsplit, static_cast<bf16*>(y), S, H, P, N, Q, nc, st[0], st[1],
      st[2], st[3], st[4], st[5]);
  return cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) one CTA of the f32 route's second pass needs for
// chunk length Q = min(chunk, S) and state width N; the wrapper refuses
// shapes above the 232,448-byte limit.
extern "C" long long repro_ssd_smem_bytes(int Q, int N) {
  return (long long)(smem_floats(Q, N) * sizeof(float));
}

// Dynamic shared memory (bytes) of one CTA of the bf16 route's stage c (its
// largest) for chunk length Q, and of stage a.
extern "C" long long repro_ssd_bf16_smem_bytes(int Q) { return (long long)chunk_tc_smem(Q); }
extern "C" long long repro_ssd_bf16_state_smem_bytes() { return (long long)STATE_TC_SMEM; }

// The f32 route. x: (B, S, H, P); dt: (B, S, H); A: (H,); Bm, Cm: (B, S, N);
// y: (B, S, H, P), all float32; cbt: f32 scratch of B * ceil(S / Q) * Q * Q
// floats for the first pass's C B^T tiles. y, dt and A are contiguous; x, Bm
// and Cm are read in place from views of the model's projection: their
// (batch, step) strides, in elements, are `strides` = {x_b, x_t, B_b, B_t,
// C_b, C_t}, and the dims after the step are packed (x's head stride is P).
// Q = min(chunk, S). Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int repro_ssd_fwd(const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm, void* y,
                             void* cbt, int B, int S, int H, int P, int N,
                             int Q, const long long* strides, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || N < 1 || Q < 1 || Q > S ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)launch<float>(x, static_cast<const float*>(dt),
                            static_cast<const float*>(A), Bm, Cm, y,
                            static_cast<float*>(cbt), B, S, H, P, N, Q, strides,
                            static_cast<cudaStream_t>(stream));
}

// The bf16 route: x, Bm, Cm and y bfloat16; dt, A f32 as above; cum: f32
// scratch of B * S * H floats; states: f32 scratch of
// B * (ceil(S / Q) - 1) * H * P * N floats and hsplit: bf16 scratch of twice
// as many elements (both may be empty when S <= Q).
// P <= 64 and N <= 128, both multiples of 8; x, Bm and Cm 16-byte aligned
// with strides that are multiples of 8 elements. Four launches on `stream`
// (cum, stage a, stage b, stage c; stages a and b only when there are two
// chunks or more); returns the first launch error (0 on success).
extern "C" int repro_ssd_fwd_bf16(const void* x, const void* dt, const void* A,
                                  const void* Bm, const void* Cm, void* y, void* cum,
                                  void* states, void* hsplit, int B, int S, int H, int P,
                                  int N, int Q, const long long* strides, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || N < 1 || Q < 1 || Q > S)
    return (int)cudaErrorInvalidValue;
  return (int)launch_tc(x, static_cast<const float*>(dt), static_cast<const float*>(A),
                        Bm, Cm, y, static_cast<float*>(cum), static_cast<float*>(states),
                        static_cast<bf16*>(hsplit), B, S, H, P, N, Q, strides,
                        static_cast<cudaStream_t>(stream));
}
