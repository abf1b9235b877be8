// Backward of GQA flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the reference has no backward kernel. It is
// the card's form of the gradient of the reference's chunked attention
// (src/repro/kernels/flash_attention/ref.py::attention_chunked, selected by
// ModelConfig.attn_chunked), whose point is to train in O(S·D) bytes: a
// rematerialised scan that never holds the (Sq, Sk) scores. Here the
// forward is the flash kernel (csrc/flash_attention.cu), and this file
// gives its gradient the same property by recomputing P tile by tile
// (FlashAttention-2's dQ/dK/dV). Its plain version is
// kernels/flash_attention/ref.py::flash_bwd_ref.
//
// Function: the gradient of the forward kernel's attention, the same masks
// (padding, causal kpos <= qpos with both positions counted from 0 —
// top-left alignment — and window qpos - kpos < window), GQA with query
// head h reading kv head h / (H / K), the caller's scale (D^-0.5 of the true
// head_dim), softmax in f32. With x = scale q.k, L the row's log-sum-exp
// and Delta = rowsum(dO o O):
//   P = exp(x - L),  dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Delta),
//   dQ = scale dS K,  dK = scale dS^T Q.
//
// Three kernels, launched in order on the caller's stream; deterministic,
// no atomics (every output element has one writer, and sums run in a fixed
// order):
//   (a) flash_bwd_prep_kernel, one CTA per (q tile, q head, batch row): L
//       by an online max and sum over the kv tiles the masks leave (the
//       forward does not save it), and Delta, one warp per row; both f32
//       scratch of (B, H, Sq) from the wrapper.
//   (b) flash_bwd_dkdv_kernel, one CTA per (k tile, kv head, batch row): K
//       and V tiles stay in shared memory while the CTA loops over the G q
//       heads of its group and the q tiles the masks reach; dK and dV
//       accumulate in registers and are written once.
//   (c) flash_bwd_dq_kernel, one CTA per (q tile, q head, batch row): Q and
//       dO stay in shared memory while it loops over the kv tiles; dQ
//       accumulates in registers.
// Mask-bound loops, as the forward's: a tile that the causal or window mask
// covers wholly is never loaded; elements are masked only by position.
//
// Route: FP32 FMA for both dtypes. bf16 inputs are widened to f32 in shared
// memory (tiles padded to D + 1 words, so the 16 rows a half-warp reads fall
// in distinct banks); all products and sums are f32; dQ, dK and dV are
// written in the input dtype. 256 threads as 16 x 16: in a score tile a
// thread owns BM / 16 rows by BM / 16 columns (column tx + 16 j), in an
// accumulator BM / 16 rows by D / 16 columns. Tiles of BM = 64 rows at
// D <= 128 and 32 at D = 256 keep the four D-wide tiles and two score tiles
// of (b) and (c) in 165,888 and 140,288 bytes of shared memory.
//
// What bounds it on the H100: about 10 B H D pairs operations (QK^T again,
// dV, dP, dQ, dK) over q, k, v, dO read once and dQ, dK, dV written once,
// so at training lengths the operations; this route recomputes QK^T twice
// more ((a) and (c)) and dP once more ((c)), 16 B H D pairs in all, on FMA
// pipes whose datasheet peak is 67 TFLOP/s (H100 SXM at its 700 W limit),
// and each FMA's operands come from shared memory (1-2.7 FMAs per 4-byte
// load). The tensor cores (mma.sync or wgmma on bf16 tiles), a saved L and
// a split of (b) over the G heads for K = 1 are the later steps.
//
// Head dim 8 runs as D = 16 with zero-filled columns, as the forward: each
// kernel takes the compute width D and the tensors' width DL <= D.
//
// Accepts float32 and bfloat16, D in {8, 16, 32, 64, 128, 256}, any Sq, Sk
// >= 1, causal or not, optional window (window <= 0 means none). The Python
// wrapper validates shapes, dtypes and contiguity before calling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int NT = 256;            // threads per CTA: 16 row groups x 16 lanes
constexpr float NEG_INF = -1e30f;  // the forward's running-max start

template <int D> struct BwdTile {
  static constexpr int BM = D <= 128 ? 64 : 32;   // rows of a q tile and a k tile
  static constexpr int DS = D + 1;                 // padded row stride of a D-wide tile
  static constexpr int PS = BM + 1;                // padded row stride of a score tile
  static constexpr int RPT = BM / 16;              // tile rows per thread
  static constexpr int DPT = D / 16;               // accumulator columns per thread
  static constexpr size_t SMEM_PREP = sizeof(float) * (size_t)(2 * BM * DS);
  static constexpr size_t SMEM_DKDV = sizeof(float) * (size_t)(4 * BM * DS + 2 * BM * PS + 2 * BM);
  static constexpr size_t SMEM_DQ = sizeof(float) * (size_t)(4 * BM * DS + BM * PS + 2 * BM);
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows p0 .. p0 + BM - 1 of a (rows, stride) tensor into an f32 tile of row
// stride D + 1; rows at or past n and columns at or past DL read as 0.
template <typename T, int D, int DL, int BM>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, long stride,
                                          int p0, int n) {
  for (int i = threadIdx.x; i < BM * D; i += NT) {
    const int r = i / D, c = i % D, p = p0 + r;
    dst[r * (D + 1) + c] = p < n && (DL == D || c < DL) ? to_f32(src[p * stride + c]) : 0.f;
  }
}

__device__ __forceinline__ bool keep(int qp, int kp, int Sq, int Sk, int causal, int window) {
  return qp < Sq && kp < Sk && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
}

// The kv tiles [start, end) a q tile at q0 sees (the forward's bounds).
template <int BM>
__device__ __forceinline__ void kv_range(int q0, int Sk, int causal, int window, int& start,
                                         int& end) {
  end = causal ? min(Sk, q0 + BM) : Sk;
  start = window > 0 ? max(0, q0 - window + 1) / BM * BM : 0;
}

// s[i][j] += A[row i] . B[col j] over D: rows ty * RPT + i of A, rows
// tx + 16 j of B, both D-wide tiles of stride D + 1.
template <int D, int RPT>
__device__ __forceinline__ void tile_dot(float (&s)[RPT][RPT], const float* A, const float* Bt,
                                         int ty, int tx) {
  constexpr int DS = D + 1;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[RPT], b[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) a[i] = A[(ty * RPT + i) * DS + d];
#pragma unroll
    for (int j = 0; j < RPT; ++j) b[j] = Bt[(tx + 16 * j) * DS + d];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < RPT; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// ------------------------------------------------------------------- (a)
template <typename T, int D, int DL>
__global__ void __launch_bounds__(NT)
flash_bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ lse, float* __restrict__ delta, int Sq, int Sk,
                      int H, int K, int causal, int window, float scale) {
  using Tile = BwdTile<D>;
  constexpr int BM = Tile::BM, DS = Tile::DS, RPT = Tile::RPT;
  extern __shared__ float smem[];
  float* sQ = smem;                // BM x DS
  float* sK = sQ + BM * DS;        // BM x DS

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long q_stride = (long)H * DL, kv_stride = (long)K * DL;
  const long q_off = ((long)b * Sq * H + h) * DL;
  const T* kb = k + ((long)b * Sk * K + kh) * DL;
  float* lrow = lse + ((long)b * H + h) * Sq;
  float* drow = delta + ((long)b * H + h) * Sq;

  // Delta = rowsum(dO o O), one warp per row.
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < BM; r += NT / 32) {
    const int qp = q0 + r;
    if (qp >= Sq) break;
    const T* g = dout + q_off + qp * q_stride;
    const T* ov = o + q_off + qp * q_stride;
    float acc = 0.f;
    for (int c = lane; c < DL; c += 32) acc = fmaf(to_f32(g[c]), to_f32(ov[c]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) drow[qp] = acc;
  }

  load_tile<T, D, DL, BM>(sQ, q + q_off, q_stride, q0, Sq);
  int kv_start, kv_end;
  kv_range<BM>(q0, Sk, causal, window, kv_start, kv_end);
  float m_i[RPT], l_i[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
  }
  for (int k0 = kv_start; k0 < kv_end; k0 += BM) {
    __syncthreads();               // the previous tile's sK is no longer read
    load_tile<T, D, DL, BM>(sK, kb, kv_stride, k0, Sk);
    __syncthreads();
    float s[RPT][RPT] = {};
    tile_dot<D, RPT>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qp = q0 + ty * RPT + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const bool ok = keep(qp, k0 + tx + 16 * j, Sq, Sk, causal, window);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RPT; ++j)
        sum += keep(qp, k0 + tx + 16 * j, Sq, Sk, causal, window) ? expf(s[i][j] - m_new) : 0.f;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[i] = expf(m_i[i] - m_new) * l_i[i] + sum;
      m_i[i] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qp = q0 + ty * RPT + i;
      // a row no key is left to has P = 0 (the forward writes 0 there)
      if (qp < Sq) lrow[qp] = l_i[i] > 0.f ? m_i[i] + logf(l_i[i]) : INFINITY;
    }
  }
}

// Scores of one (q tile, k tile) pair for a thread's RPT x RPT elements:
// P = exp(scale q.k - L) where the masks keep the pair, else 0, and
// dP - Delta, with dP = dO . v. Rows are q rows, columns k rows.
template <int D, int RPT>
__device__ __forceinline__ void probs(float (&p)[RPT][RPT], float (&dpd)[RPT][RPT],
                                      const float* sQ, const float* sG, const float* sK,
                                      const float* sV, const float* sL, const float* sDl,
                                      int q0, int k0, int Sq, int Sk, int causal, int window,
                                      float scale, int ty, int tx) {
  float s[RPT][RPT] = {}, dp[RPT][RPT] = {};
  tile_dot<D, RPT>(s, sQ, sK, ty, tx);
  tile_dot<D, RPT>(dp, sG, sV, ty, tx);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty * RPT + i;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const bool ok = keep(q0 + r, k0 + tx + 16 * j, Sq, Sk, causal, window);
      p[i][j] = ok ? expf(s[i][j] * scale - sL[r]) : 0.f;
      dpd[i][j] = dp[i][j] - sDl[r];
    }
  }
}

// L and Delta of rows q0 .. q0 + BM - 1 into shared memory (L = +inf and
// Delta = 0 past Sq, where P is 0 anyway).
template <int BM>
__device__ __forceinline__ void load_rows(float* sL, float* sDl, const float* lrow,
                                          const float* drow, int q0, int Sq) {
  for (int r = threadIdx.x; r < BM; r += NT) {
    const int qp = q0 + r;
    sL[r] = qp < Sq ? lrow[qp] : INFINITY;
    sDl[r] = qp < Sq ? drow[qp] : 0.f;
  }
}

// ------------------------------------------------------------------- (b)
template <typename T, int D, int DL>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H, int K,
                      int causal, int window, float scale) {
  using Tile = BwdTile<D>;
  constexpr int BM = Tile::BM, DS = Tile::DS, PS = Tile::PS, RPT = Tile::RPT,
                DPT = Tile::DPT;
  extern __shared__ float smem[];
  float* sK = smem;                // BM x DS
  float* sV = sK + BM * DS;        // BM x DS
  float* sQ = sV + BM * DS;        // BM x DS
  float* sG = sQ + BM * DS;        // BM x DS: dO
  float* sP = sG + BM * DS;        // BM x PS: P, q rows x k columns
  float* sS = sP + BM * PS;        // BM x PS: dS
  float* sL = sS + BM * PS;        // BM
  float* sDl = sL + BM;            // BM

  const int k0 = blockIdx.x * BM, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long q_stride = (long)H * DL, kv_stride = (long)K * DL;
  const long kv_off = ((long)b * Sk * K + kh) * DL;
  load_tile<T, D, DL, BM>(sK, k + kv_off, kv_stride, k0, Sk);
  load_tile<T, D, DL, BM>(sV, v + kv_off, kv_stride, k0, Sk);

  // q tiles that can see this k tile: causal from the diagonal on, a
  // window up to the tile's last key + window - 1
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + BM - 1 + window) : Sq;

  float acc_k[RPT][DPT] = {}, acc_v[RPT][DPT] = {};
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const long q_off = ((long)b * Sq * H + h) * DL;
    const float* lrow = lse + ((long)b * H + h) * Sq;
    const float* drow = delta + ((long)b * H + h) * Sq;
    for (int q0 = q_lo; q0 < q_hi; q0 += BM) {
      __syncthreads();             // the previous q tile's sQ, sG, sP, sS are read
      load_tile<T, D, DL, BM>(sQ, q + q_off, q_stride, q0, Sq);
      load_tile<T, D, DL, BM>(sG, dout + q_off, q_stride, q0, Sq);
      load_rows<BM>(sL, sDl, lrow, drow, q0, Sq);
      __syncthreads();
      float p[RPT][RPT], dpd[RPT][RPT];
      probs<D, RPT>(p, dpd, sQ, sG, sK, sV, sL, sDl, q0, k0, Sq, Sk, causal, window, scale,
                    ty, tx);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const int at = (ty * RPT + i) * PS + tx + 16 * j;
          sP[at] = p[i][j];
          sS[at] = p[i][j] * dpd[i][j];
        }
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q: this thread's k rows ty * RPT + i
#pragma unroll 2
      for (int r = 0; r < BM; ++r) {
        float pv[RPT], sv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pv[i] = sP[r * PS + ty * RPT + i];
          sv[i] = sS[r * PS + ty * RPT + i];
        }
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const float gv = sG[r * DS + tx + 16 * j], qv = sQ[r * DS + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            acc_v[i][j] = fmaf(pv[i], gv, acc_v[i][j]);
            acc_k[i][j] = fmaf(sv[i], qv, acc_k[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int kp = k0 + ty * RPT + i;
    if (kp >= Sk) continue;
    T* dkr = dk + kv_off + kp * kv_stride;
    T* dvr = dv + kv_off + kp * kv_stride;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int c = tx + 16 * j;
      if (DL == D || c < DL) {
        dkr[c] = from_f32<T>(acc_k[i][j] * scale);
        dvr[c] = from_f32<T>(acc_v[i][j]);
      }
    }
  }
}

// ------------------------------------------------------------------- (c)
template <typename T, int D, int DL>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int Sq, int Sk, int H, int K, int causal, int window,
                    float scale) {
  using Tile = BwdTile<D>;
  constexpr int BM = Tile::BM, DS = Tile::DS, PS = Tile::PS, RPT = Tile::RPT,
                DPT = Tile::DPT;
  extern __shared__ float smem[];
  float* sQ = smem;                // BM x DS
  float* sG = sQ + BM * DS;        // BM x DS: dO
  float* sK = sG + BM * DS;        // BM x DS
  float* sV = sK + BM * DS;        // BM x DS
  float* sS = sV + BM * DS;        // BM x PS: dS, q rows x k columns
  float* sL = sS + BM * PS;        // BM
  float* sDl = sL + BM;            // BM

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long q_stride = (long)H * DL, kv_stride = (long)K * DL;
  const long q_off = ((long)b * Sq * H + h) * DL;
  const long kv_off = ((long)b * Sk * K + kh) * DL;
  load_tile<T, D, DL, BM>(sQ, q + q_off, q_stride, q0, Sq);
  load_tile<T, D, DL, BM>(sG, dout + q_off, q_stride, q0, Sq);
  load_rows<BM>(sL, sDl, lse + ((long)b * H + h) * Sq, delta + ((long)b * H + h) * Sq, q0, Sq);

  int kv_start, kv_end;
  kv_range<BM>(q0, Sk, causal, window, kv_start, kv_end);
  float acc[RPT][DPT] = {};
  for (int k0 = kv_start; k0 < kv_end; k0 += BM) {
    __syncthreads();               // the previous tile's sK, sV, sS are read
    load_tile<T, D, DL, BM>(sK, k + kv_off, kv_stride, k0, Sk);
    load_tile<T, D, DL, BM>(sV, v + kv_off, kv_stride, k0, Sk);
    __syncthreads();
    float p[RPT][RPT], dpd[RPT][RPT];
    probs<D, RPT>(p, dpd, sQ, sG, sK, sV, sL, sDl, q0, k0, Sq, Sk, causal, window, scale, ty,
                  tx);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < RPT; ++j) sS[(ty * RPT + i) * PS + tx + 16 * j] = p[i][j] * dpd[i][j];
    __syncthreads();
    // dQ += dS K: this thread's q rows ty * RPT + i
#pragma unroll 2
    for (int c = 0; c < BM; ++c) {
      float sv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) sv[i] = sS[(ty * RPT + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float kv = sK[c * DS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(sv[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qp = q0 + ty * RPT + i;
    if (qp >= Sq) continue;
    T* dqr = dq + q_off + qp * q_stride;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int c = tx + 16 * j;
      if (DL == D || c < DL) dqr[c] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D, int DL>
cudaError_t launch(const void* dout, const void* q, const void* k, const void* v,
                   const void* o, void* dq, void* dk, void* dv, float* lse, float* delta,
                   int B, int Sq, int Sk, int H, int K, int causal, int window, float scale,
                   cudaStream_t stream) {
  using Tile = BwdTile<D>;
  constexpr int BM = Tile::BM;
  cudaError_t err;
  if ((err = allow_smem(flash_bwd_prep_kernel<T, D, DL>, Tile::SMEM_PREP)) != cudaSuccess ||
      (err = allow_smem(flash_bwd_dkdv_kernel<T, D, DL>, Tile::SMEM_DKDV)) != cudaSuccess ||
      (err = allow_smem(flash_bwd_dq_kernel<T, D, DL>, Tile::SMEM_DQ)) != cudaSuccess)
    return err;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tg = static_cast<const T*>(dout);
  const dim3 grid_q((Sq + BM - 1) / BM, H, B), grid_k((Sk + BM - 1) / BM, K, B);
  flash_bwd_prep_kernel<T, D, DL><<<grid_q, NT, Tile::SMEM_PREP, stream>>>(
      tq, tk, static_cast<const T*>(o), tg, lse, delta, Sq, Sk, H, K, causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D, DL><<<grid_k, NT, Tile::SMEM_DKDV, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, K,
      causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D, DL><<<grid_q, NT, Tile::SMEM_DQ, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dq), Sq, Sk, H, K, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* dout, const void* q, const void* k, const void* v,
                       const void* o, void* dq, void* dk, void* dv, float* lse, float* delta,
                       int B, int Sq, int Sk, int H, int K, int D, int causal, int window,
                       float scale, cudaStream_t stream) {
#define REPRO_FLASH_BWD_CASE(DD, DC)                                                   \
  case DD:                                                                            \
    return launch<T, DC, DD>(dout, q, k, v, o, dq, dk, dv, lse, delta, B, Sq, Sk, H, K, \
                             causal, window, scale, stream);
  switch (D) {
    REPRO_FLASH_BWD_CASE(8, 16)
    REPRO_FLASH_BWD_CASE(16, 16)
    REPRO_FLASH_BWD_CASE(32, 32)
    REPRO_FLASH_BWD_CASE(64, 64)
    REPRO_FLASH_BWD_CASE(128, 128)
    REPRO_FLASH_BWD_CASE(256, 256)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_BWD_CASE
}

}  // namespace

// dout, q, o, dq: (B, Sq, H, D); k, v, dk, dv: (B, Sk, K, D); all contiguous
// and of one dtype (is_bf16 = 1 for bfloat16, 0 for float32). lse and delta:
// f32 scratch of B * H * Sq floats each. Launches the three kernels on
// `stream` in order, does not synchronise, and returns the first
// cudaGetLastError() that is not 0 (0 on success).
extern "C" int repro_flash_attention_bwd(const void* dout, const void* q, const void* k,
                                         const void* v, const void* o, void* dq, void* dk,
                                         void* dv, void* lse, void* delta, int B, int Sq,
                                         int Sk, int H, int K, int D, int is_bf16, int causal,
                                         int window, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || K < 1 || H % K != 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  const cudaError_t err =
      is_bf16 ? dispatch_d<__nv_bfloat16>(dout, q, k, v, o, dq, dk, dv, l, dl, B, Sq, Sk, H, K,
                                          D, causal, window, scale, s)
              : dispatch_d<float>(dout, q, k, v, o, dq, dk, dv, l, dl, B, Sq, Sk, H, K, D,
                                  causal, window, scale, s);
  return (int)err;
}

// Dynamic shared memory (bytes) of one CTA of the dK/dV kernel, the largest
// of the three, at head_dim D; 0 for an unsupported D.
extern "C" long long repro_flash_attention_bwd_smem_bytes(int D) {
  switch (D) {
    case 8:  // computed at width 16
    case 16: return BwdTile<16>::SMEM_DKDV;
    case 32: return BwdTile<32>::SMEM_DKDV;
    case 64: return BwdTile<64>::SMEM_DKDV;
    case 128: return BwdTile<128>::SMEM_DKDV;
    case 256: return BwdTile<256>::SMEM_DKDV;
    default: return 0;
  }
}
