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
// Design (taken from what the kernel computes, not block by block):
//   * two passes on one stream. The first computes the C B^T tiles of every
//     chunk once per (batch row, chunk), into an f32 scratch the wrapper
//     allocates (B x chunks x Q x Q floats, 16.8 MB at mamba2-130m's training
//     shape): B and C are shared by all heads, so this product does not
//     depend on the head or on p, and computing it inside every CTA of the
//     second pass took 60 % of that pass's FMAs (the first version, PERF.md).
//   * the second pass has one CTA per (tile of PB = 32 state rows p, head,
//     batch row). A loop inside the CTA walks the chunks in order, which
//     takes the place of the TPU grid's sequential chunk axis; the CTA's
//     (PB x N) slice of the state stays in shared memory for the whole
//     sequence, as the TPU kept it in VMEM scratch. The p rows of the state
//     are independent, so P is split across CTAs: at mamba2-130m's training
//     shape (B=8, H=24, P=64) the grid is 2 x 24 x 8 = 384 CTAs, two per
//     SM, instead of 192.
//   * a chunk of Q = 256 does not fit in shared memory whole (C B^T alone
//     is 256 KB in f32), so it is walked in blocks of BI = 64 query rows
//     against blocks of BJ = 64 key rows j <= i (blocks wholly above the
//     diagonal are skipped). Per query block: the inter-chunk term from the
//     state, then for each key block the 64 x 64 C B^T tile, masked and
//     multiplied by L as it is loaded into shared memory, and y += scores u
//     from it. The y tile stays in registers and is written once. After all
//     query blocks the state is decayed and takes the chunk's outer
//     products, block by block; the last chunk skips that update (only y is
//     returned).
//   * x, dt, B and C are read in place from the model's layouts
//     ((B,S,H,P), (B,S,H), (B,S,N)), x, B and C as strided views of the
//     conv output; there is no copy and no padding. The ragged last chunk
//     and S < chunk are masked: rows and keys past the chunk's end load as
//     zeros and their outputs are not written.
//   * cum is summed in order by one thread, in f64 over the f32 products
//     dt A (rounded alone, not fused), then rounded to f32: the plain
//     version's arithmetic. Over a chunk of 256 steps cum reaches -10^3 and
//     more, and exp(cum_i - cum_j) turns an ulp of cum into a relative error
//     of 10^-4 in L; summed in f64, the kernel's cum and the plain version's
//     are the same f32 numbers, so the two agree to the rounding of the
//     matmul sums. cum is kept in shared memory with dt.
//   * tiles are f32 in shared memory, rows padded to an odd stride against
//     bank conflicts; the products are FMA loops, 4 x 4 entries of C B^T,
//     4 rows x 2 columns of y and 2 x 16-column state entries per thread.
// P, N, H, S and chunk need not be powers of two; N is bounded only by the
// shared memory (N = 128: 109,440 bytes per CTA of the second pass).
//
// What bounds it on the H100: the function reads x, dt, B, C once and
// writes y once (about 110 MB at B=8, S=2048, H=24, P=64, N=128 in bf16,
// 33 us at 3.35 TB/s), and the chunked form does about 18 GFLOP there
// (C B^T once per chunk, the masked scores times u, C h^T and the state
// update per head; 18 us at the 989 TFLOP/s bf16 tensor-core rate), so the
// bound is the bytes. This version runs on the FP32 FMA pipes (67 TFLOP/s)
// out of shared memory and sits far above that bound; bf16 tensor-core
// tiles (mma.sync, then wgmma + TMA) and a chunk-parallel state pass are
// the later steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace

// Shared memory (bytes) one CTA needs for chunk length Q = min(chunk, S) and
// state width N; the wrapper refuses shapes above the 232,448-byte limit.
extern "C" long long repro_ssd_smem_bytes(int Q, int N) {
  return (long long)(smem_floats(Q, N) * sizeof(float));
}

// x: (B, S, H, P); dt: (B, S, H) f32; A: (H,) f32; Bm, Cm: (B, S, N);
// y: (B, S, H, P); cbt: f32 scratch of B * ceil(S / Q) * Q * Q floats for
// the first pass's C B^T tiles. x, Bm, Cm and y of one dtype (is_bf16 = 1 for bfloat16,
// 0 for float32). y, dt and A are contiguous; x, Bm and Cm are read in place
// from views of the model's projection: their (batch, step) strides, in
// elements, are `strides` = {x_b, x_t, B_b, B_t, C_b, C_t}, and the dims
// after the step are packed (x's head stride is P). Q = min(chunk, S).
// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int repro_ssd_fwd(const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm, void* y,
                             void* cbt, int B, int S, int H, int P, int N,
                             int Q, int is_bf16, const long long* strides,
                             void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || N < 1 || Q < 1 || Q > S ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* cbf = static_cast<float*>(cbt);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, y, cbf, B, S, H, P, N, Q, strides, s)
              : launch<float>(x, dtf, Af, Bm, Cm, y, cbf, B, S, H, P, N, Q, strides, s);
  return (int)err;
}
