// Backward of GQA flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the reference has no backward kernel. It is
// the card's form of the gradient of the reference's chunked attention
// (src/repro/kernels/flash_attention/ref.py::attention_chunked, selected by
// ModelConfig.attn_chunked), whose point is to train in O(S·D) bytes: a
// rematerialised scan that never holds the (Sq, Sk) scores. Here the
// forward is the flash kernel (csrc/flash_attention.cu), and this file
// gives its gradient the same property by recomputing P tile by tile
// (FlashAttention-2's dQ/dK/dV, without atomics). Its plain version is
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
// Three passes, launched in order on the caller's stream, and a fourth when
// (b) is split; deterministic, no atomics (every output element has one
// writer, and every sum runs in a fixed order):
//   (a) prep, one CTA per (q tile, q head, batch row): L by an online max
//       and sum over the kv tiles the masks leave (the forward does not save
//       it), and Delta in f32; both f32 scratch of (B, H, Sq).
//   (b) dK and dV, one CTA per (k tile, kv head, batch row): the K and V
//       tiles stay in shared memory while the CTA walks the G q heads of its
//       group and the q tiles the masks reach; dK and dV accumulate in
//       registers and are written once. Split (below): one CTA per (k tile,
//       q head, batch row), each writing its head's dK and dV in f32 to
//       scratch, then
//   (r) a reduce kernel that sums the G partials of each kv head in order
//       g = 0 .. G - 1 and writes dK and dV in the input dtype.
//   (c) dQ, one CTA per (q tile, q head, batch row): Q and dO stay in shared
//       memory while it walks the kv tiles; dQ accumulates in registers.
// Mask-bound loops, as the forward's: a tile that the causal or window mask
// covers wholly is never loaded; elements are masked only on tiles that
// cross Sq, Sk, the diagonal or the window's edge.
//
// The split rule. (b) has ceil(Sk / 64) K B CTAs, which leaves most of the
// card idle when there is one kv head: recurrentgemma-2b (K = 1, one row a
// microbatch) has 64 of them at S = 4096 on 132 SMs, each walking G = 10
// heads. The first design of this file, which had only this grid and ran
// bf16 on the FMA pipes, took 15.6 ms at S = 2048 and 23.6 at 4096, 1.5x
// the time for 3x the pairs: its time followed the CTAs the card filled,
// not the work (chip_smoke.py phase 3, H100 80GB HBM3 at 700 W). So when the grid has fewer CTAs than SPLIT_WAVES waves of the
// card's SMs and G > 1, (b) takes one CTA per q head instead: G times the
// CTAs, for 2 B H Sk D f32 of scratch written once and read once by (r)
// (84 MB at recurrentgemma-2b's 1 x 4096, about 50 us at 3.35 TB/s).
// Measured (tools/flash_bwd_split.py, bf16, split against not, H100 80GB
// HBM3 at 700 W): K = 1, 10 q heads, D = 256, window 2048: 0.5885 against
// 1.7903 ms at 1 x 2048 (32 CTAs unsplit), 1.4717 against 2.4325 at 1 x
// 4096 (64), 5.3554 against 5.8066 at 4 x 4096 (256); K = 4, 8 q heads,
// D = 64: 0.3757 against 0.4557 at 1 x 4096 (256), but 0.6879 against
// 0.6539 at 2 x 4096 (512) and 0.7469 against 0.7069 at 8 x 2048 (1,024),
// where the scratch's traffic costs more than the fuller card gains. The
// rule reads the shapes and the SM count only, so the wrapper sizes the
// scratch by the same rule (repro_flash_attention_bwd_scratch_floats).
//
// The bf16 route (mma.sync.m16n8k16, bf16 in, f32 accumulate), the
// forward's tile handling (csrc/flash_attention.cu): bf16 tiles in shared
// memory, filled by 16-byte cp.async and double-buffered, rows padded to
// stride D + 8 so the 8 row addresses of an ldmatrix fall in 8 distinct bank
// groups; exp2f with log2(e) folded into the scale, so L is kept in base 2.
//   (a) S = Q K^T as the forward; the online max and sum of its fragments.
//   (b) each warp owns 16 k rows. S^T = K Q^T and dP^T = V dO^T land in the
//       accumulator layout, which is the A-fragment layout (sm90_mma.cuh),
//       so P^T = exp2(S^T - L) and dS^T = P^T o (dP^T - Delta) are rounded
//       to bf16 in registers and fed straight into dV += P^T dO and
//       dK += dS^T Q (dO and Q by ldmatrix.trans). At D <= 64 the warp's K
//       and V fragments stay in registers for the whole q walk.
//       D >= 128: the dK and dV accumulators of 16 rows by D columns are D
//       floats a thread (256 at D = 256, over the 255-register limit), so
//       the CTA has 8 warps, two on each 16 k rows: each computes S^T and
//       dP^T for half the q tile's columns, the pair swaps its bf16 P^T and
//       dS^T through shared memory (64 x 72 bf16 each), and each accumulates
//       dK and dV for half of D (128 floats a thread at D = 256).
//   (c) S = Q K^T and dP = dO V^T; dS rounded to bf16 in registers as the A
//       fragment of dQ += dS K (K by ldmatrix.trans).
//   Rounding: P and dS are rounded to bf16 only as the A operand of a
//   product; every sum is f32; dQ, dK and dV are rounded once, to bf16.
//   Registers a thread at D = 16, 32, 64, 128, 256 (nvcc 12.8 -Xptxas -v,
//   chip_smoke.py phase 2; D = 8 as D = 16), no spill bytes in any:
//   (a) 74, 78, 92, 108, 42; (b) 164, 185, 238, 166, 242; (c) 154, 162, 198,
//   214, 248. Dynamic shared memory a CTA: (a) 2 (64 + 2 BK) (D + 8) bytes,
//   (b) 2 (6 x 64 (D + 8) [+ 2 x 64 x 72 at D >= 128]) + 1,024, (c) 2 (128 +
//   4 BK) (D + 8), with BK = 64 keys at D <= 128 and 32 at D = 256; so (b)
//   takes 56,320 bytes at D = 64 (registers allow two CTAs an SM) and 222,208
//   at D = 256 (one CTA of 8 warps an SM).
//
// The f32 route keeps the first design's FMA kernels (f32's 1e-4 parity tolerance rules
// out TF32) with the same split rule on its own grid: 256 threads as 16 x
// 16; in a score tile a thread owns BM / 16 rows by BM / 16 columns (column
// tx + 16 j), in an accumulator BM / 16 rows by D / 16 columns; tiles of
// BM = 64 rows at D <= 128 and 32 at D = 256, padded to D + 1 words. Both
// routes' grids hand out the longest causal walks first (the last q tile,
// k tile 0), so short CTAs fill the last wave.
//
// What bounds it on the H100: about 10 B H D pairs operations (QK^T again,
// dV, dP, dQ, dK) over q, k, v, dO read once and dQ, dK, dV written once,
// so at training lengths the operations: 989 TFLOP/s on the bf16 tensor
// cores, 67 TFLOP/s on the FP32 FMA pipes (datasheet peaks, H100 SXM at its
// 700 W limit). Both routes recompute QK^T twice more ((a) and (c)) and dP
// once more ((c)): 16 B H D pairs in all. mma.sync reaches part of the
// tensor-core rate: chip_smoke.py phase 3 measured 1.46 ms at
// recurrentgemma-2b's 1 x 4096 bf16 call against a 0.163 ms bound (11 %)
// and 0.70 ms at 8 x 2048, D = 64 against 0.087 (12 %); the f32 route 21.2
// ms at tiny's 8 x 4096 against 5.13 (24 %). wgmma with TMA-fed tiles and
// L saved by the forward are the later steps.
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

#include "sm90_mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;  // the f32 route's running-max start
constexpr float LOG2E = 1.4426950408889634f;
constexpr int SPLIT_WAVES = 2;     // split (b) below this many waves of CTAs

__device__ __forceinline__ bool keep(int qp, int kp, int Sq, int Sk, int causal, int window) {
  return qp < Sq && kp < Sk && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
}

// The kv tiles [start, end) that q rows q0 .. q0 + rows - 1 see (the
// forward's bounds), start aligned down to a multiple of bk.
__device__ __forceinline__ void kv_range(int q0, int rows, int bk, int Sk, int causal,
                                         int window, int& start, int& end) {
  end = causal ? min(Sk, q0 + rows) : Sk;
  start = window > 0 ? max(0, q0 - window + 1) / bk * bk : 0;
}

// The q rows [lo, hi) that can see k rows k0 .. k0 + rows - 1: causal from
// the diagonal on, a window up to the last key + window - 1.
__device__ __forceinline__ void q_range(int k0, int rows, int Sq, int causal, int window,
                                        int& lo, int& hi) {
  lo = causal ? k0 : 0;
  hi = window > 0 ? min(Sq, k0 + rows - 1 + window) : Sq;
}

// Whether (b) takes one CTA per q head: its kv-head grid has fewer than
// SPLIT_WAVES waves of CTAs and there are heads to split over.
bool split_dkdv(long long ctas, int G) {
  if (G < 2) return false;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  return ctas < (long long)SPLIT_WAVES * sms;
}

// Floats of scratch that `lse` must hold: the rows' L (padded to 64 floats),
// then, when (b) is split, the f32 partials of dK and dV, (B, H, Sk, DL) each.
long long scratch_floats(int B, int Sq, int Sk, int H, int K, int DL, int bn) {
  const long long rows = ((long long)B * H * Sq + 63) / 64 * 64;
  const long long ctas = (long long)((Sk + bn - 1) / bn) * K * B;
  return rows + (split_dkdv(ctas, H / K) ? 2LL * B * H * Sk * DL : 0);
}

// ---------------------------------------------------------------- f32 route
constexpr int NT = 256;            // threads per CTA: 16 row groups x 16 lanes

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

// Rows p0 .. p0 + BM - 1 of a (rows, stride) tensor into a tile of row
// stride D + 1; rows at or past n and columns at or past DL read as 0.
template <int D, int DL, int BM>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, long stride,
                                          int p0, int n) {
  for (int i = threadIdx.x; i < BM * D; i += NT) {
    const int r = i / D, c = i % D, p = p0 + r;
    dst[r * (D + 1) + c] = p < n && (DL == D || c < DL) ? src[p * stride + c] : 0.f;
  }
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

// (a), f32: L (natural log) and Delta.
template <int D, int DL>
__global__ void __launch_bounds__(NT)
flash_bwd_prep_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ o, const float* __restrict__ dout,
                      float* __restrict__ lse, float* __restrict__ delta, int Sq, int Sk,
                      int H, int K, int causal, int window, float scale) {
  using Tile = BwdTile<D>;
  constexpr int BM = Tile::BM, RPT = Tile::RPT;
  extern __shared__ float smem[];
  float* sQ = smem;                // BM x DS
  float* sK = sQ + BM * Tile::DS;  // BM x DS

  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM, h = blockIdx.x, b = blockIdx.y;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long q_stride = (long)H * DL, kv_stride = (long)K * DL;
  const long q_off = ((long)b * Sq * H + h) * DL;
  const float* kb = k + ((long)b * Sk * K + kh) * DL;
  float* lrow = lse + ((long)b * H + h) * Sq;
  float* drow = delta + ((long)b * H + h) * Sq;

  // Delta = rowsum(dO o O), one warp per row.
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < BM; r += NT / 32) {
    const int qp = q0 + r;
    if (qp >= Sq) break;
    const float* g = dout + q_off + qp * q_stride;
    const float* ov = o + q_off + qp * q_stride;
    float acc = 0.f;
    for (int c = lane; c < DL; c += 32) acc = fmaf(g[c], ov[c], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) drow[qp] = acc;
  }

  load_tile<D, DL, BM>(sQ, q + q_off, q_stride, q0, Sq);
  int kv_start, kv_end;
  kv_range(q0, BM, BM, Sk, causal, window, kv_start, kv_end);
  float m_i[RPT], l_i[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
  }
  for (int k0 = kv_start; k0 < kv_end; k0 += BM) {
    __syncthreads();               // the previous tile's sK is no longer read
    load_tile<D, DL, BM>(sK, kb, kv_stride, k0, Sk);
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

// (b), f32. Unsplit, blockIdx.x is the kv head and the CTA walks its G q
// heads; split, blockIdx.x is the q head and the CTA writes that head's
// dK and dV to the f32 partials. blockIdx.z is the k tile.
template <int D, int DL>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
                      int K, int causal, int window, float scale, int split) {
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

  const int G = H / K, k0 = blockIdx.z * BM, b = blockIdx.y;
  const int kh = split ? blockIdx.x / G : blockIdx.x;
  const int h_first = split ? blockIdx.x : kh * G, h_end = split ? h_first + 1 : h_first + G;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long q_stride = (long)H * DL, kv_stride = (long)K * DL;
  const long kv_off = ((long)b * Sk * K + kh) * DL;
  load_tile<D, DL, BM>(sK, k + kv_off, kv_stride, k0, Sk);
  load_tile<D, DL, BM>(sV, v + kv_off, kv_stride, k0, Sk);
  int q_lo, q_hi;
  q_range(k0, BM, Sq, causal, window, q_lo, q_hi);

  float acc_k[RPT][DPT] = {}, acc_v[RPT][DPT] = {};
  for (int h = h_first; h < h_end; ++h) {
    const long q_off = ((long)b * Sq * H + h) * DL;
    const float* lrow = lse + ((long)b * H + h) * Sq;
    const float* drow = delta + ((long)b * H + h) * Sq;
    for (int q0 = q_lo; q0 < q_hi; q0 += BM) {
      __syncthreads();             // the previous q tile's sQ, sG, sP, sS are read
      load_tile<D, DL, BM>(sQ, q + q_off, q_stride, q0, Sq);
      load_tile<D, DL, BM>(sG, dout + q_off, q_stride, q0, Sq);
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

  // unsplit: dk and dv; split: this head's rows of the (B, H, Sk, DL) partials
  const long out_off = split ? ((long)b * H + h_first) * Sk * DL : kv_off;
  const long out_stride = split ? DL : kv_stride;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int kp = k0 + ty * RPT + i;
    if (kp >= Sk) continue;
    float* dkr = dk + out_off + kp * out_stride;
    float* dvr = dv + out_off + kp * out_stride;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int c = tx + 16 * j;
      if (DL == D || c < DL) {
        dkr[c] = acc_k[i][j] * scale;
        dvr[c] = acc_v[i][j];
      }
    }
  }
}

// (c), f32.
template <int D, int DL>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int Sq, int Sk, int H, int K, int causal, int window,
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

  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM, h = blockIdx.x, b = blockIdx.y;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long q_stride = (long)H * DL, kv_stride = (long)K * DL;
  const long q_off = ((long)b * Sq * H + h) * DL;
  const long kv_off = ((long)b * Sk * K + kh) * DL;
  load_tile<D, DL, BM>(sQ, q + q_off, q_stride, q0, Sq);
  load_tile<D, DL, BM>(sG, dout + q_off, q_stride, q0, Sq);
  load_rows<BM>(sL, sDl, lse + ((long)b * H + h) * Sq, delta + ((long)b * H + h) * Sq, q0, Sq);

  int kv_start, kv_end;
  kv_range(q0, BM, BM, Sk, causal, window, kv_start, kv_end);
  float acc[RPT][DPT] = {};
  for (int k0 = kv_start; k0 < kv_end; k0 += BM) {
    __syncthreads();               // the previous tile's sK, sV, sS are read
    load_tile<D, DL, BM>(sK, k + kv_off, kv_stride, k0, Sk);
    load_tile<D, DL, BM>(sV, v + kv_off, kv_stride, k0, Sk);
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
    float* dqr = dq + q_off + qp * q_stride;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int c = tx + 16 * j;
      if (DL == D || c < DL) dqr[c] = acc[i][j] * scale;
    }
  }
}

// --------------------------------------------------------------- bf16 route
using bf16 = __nv_bfloat16;
constexpr int TC_NT = 128;         // threads of (a) and (c): 4 warps of 16 q rows
constexpr int TC_BQ = 64;          // q rows of a tile: (a), (c) and (b)'s inner tile
constexpr int TC_BN = 64;          // k rows of a (b) CTA: 4 warp rows of 16

template <int D> struct Tc {
  static constexpr int STR = D + 8;                // padded row stride (bf16)
  static constexpr int BK = D <= 128 ? 64 : 32;    // keys of a kv tile in (a) and (c)
  static constexpr int DW = D >= 128 ? 2 : 1;      // warps on each 16 k rows in (b)
  static constexpr int NT_B = 128 * DW;            // threads of (b)
  static constexpr int PSTR = TC_BQ + 8;           // row stride of (b)'s P^T and dS^T tiles
  static constexpr size_t SMEM_A = 2 * (size_t)(TC_BQ * STR + 2 * BK * STR);
  static constexpr size_t SMEM_B = 2 * (size_t)(2 * TC_BN * STR + 4 * TC_BQ * STR
                                                + (DW > 1 ? 2 * TC_BN * PSTR : 0))
                                   + 4 * (size_t)(4 * TC_BQ);
  static constexpr size_t SMEM_C = 2 * (size_t)(2 * TC_BQ * STR + 4 * BK * STR);
};

// 4-byte global -> shared copy (zero-filled when `full` is false).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 4 : 0));
}

// Rows p0 .. p0 + ROWS - 1 of a (rows, stride) bf16 tensor into a tile of
// stride D + 8 by 16-byte cp.async; rows at or past n and columns at or past
// DL are zero-filled.
template <int D, int DL, int ROWS, int THREADS>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src, long stride, int p0,
                                        int n) {
  constexpr int CPR = D / 8;
  for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
    const int r = c / CPR, col = (c % CPR) * 8, p = p0 + r;
    const bool in = p < n && (DL == D || col < DL);
    sm90::cp_async16(sm90::smem_addr(dst + r * (D + 8) + col),
                     in ? src + (long)p * stride + col : src, in);
  }
}

// The A fragment of a k-step of 16 from two neighbouring accumulator n-tiles.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = sm90::pack_bf16(lo[0], lo[1]);
  a[1] = sm90::pack_bf16(lo[2], lo[3]);
  a[2] = sm90::pack_bf16(hi[0], hi[1]);
  a[3] = sm90::pack_bf16(hi[2], hi[3]);
}

// ldmatrix lane offsets (row, column) of a B operand: from the rows of a
// [n][k] tile (non-transposed: K for Q K^T) and of a [k][n] tile
// (transposed: V for P V).
__device__ __forceinline__ int b_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int b_col(int lane) { return ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int bt_row(int lane) { return (lane & 7) + (((lane >> 3) & 1) << 3); }
__device__ __forceinline__ int bt_col(int lane) { return (lane >> 4) * 8; }

// A 1-D grid of (tile, head, batch row) with the heads and rows fastest and
// the longest causal q tiles (the last) first.
__device__ __forceinline__ void q_tile_of(int Sq, int H, int& q0, int& h, int& b) {
  const int nq = (Sq + TC_BQ - 1) / TC_BQ, hb = (int)gridDim.x / nq;   // H x B
  const int qt = nq - 1 - (int)(blockIdx.x / hb);
  h = (int)(blockIdx.x % hb) % H;
  b = (int)(blockIdx.x % hb) / H;
  q0 = qt * TC_BQ;
}

// (a), bf16: L in base 2 (scores scaled by scale log2 e), and Delta.
template <int D, int DL>
__global__ void __launch_bounds__(TC_NT)
flash_bwd_prep_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ o, const bf16* __restrict__ dout,
                         float* __restrict__ lse, float* __restrict__ delta, int Sq, int Sk,
                         int H, int K, int causal, int window, float scale_log2) {
  using namespace sm90;
  constexpr int BK = Tc<D>::BK, STR = Tc<D>::STR, KD = D / 16, NKT = BK / 8;
  constexpr bool Q_IN_REGS = D <= 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);    // BQ x STR
  bf16* sK = sQ + TC_BQ * STR;                      // 2 x BK x STR

  int q0, h, b;
  q_tile_of(Sq, H, q0, h, b);
  const int kh = h / (H / K);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3, row0 = warp * 16;
  const long q_stride = (long)H * DL, kv_stride = (long)K * DL;
  const long q_off = ((long)b * Sq * H + h) * DL;
  const bf16* kb = k + ((long)b * Sk * K + kh) * DL;

  int kv_start, kv_end;
  kv_range(q0, TC_BQ, BK, Sk, causal, window, kv_start, kv_end);
  const int ntiles = kv_end > kv_start ? (kv_end - kv_start + BK - 1) / BK : 0;
  cp_tile<D, DL, TC_BQ, TC_NT>(sQ, q + q_off, q_stride, q0, Sq);
  if (ntiles > 0) cp_tile<D, DL, BK, TC_NT>(sK, kb, kv_stride, kv_start, Sk);
  cp_async_commit();                     // group 0: Q and the first K tile

  // Delta = rowsum(dO o O) in f32, one warp per row, while the copies fly
  for (int r = warp; r < TC_BQ; r += TC_NT / 32) {
    const int qp = q0 + r;
    if (qp >= Sq) break;
    const bf16* gr = dout + q_off + qp * q_stride;
    const bf16* orow = o + q_off + qp * q_stride;
    float acc = 0.f;
    for (int c = lane; c < DL; c += 32)
      acc = fmaf(__bfloat162float(gr[c]), __bfloat162float(orow[c]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta[((long)b * H + h) * Sq + qp] = acc;
  }

  float m_r[2] = {-INFINITY, -INFINITY};   // running max, base 2, rows g and g + 8
  float l_r[2] = {0.f, 0.f};               // this lane's part of the row sums
  uint32_t qf[Q_IN_REGS ? KD : 1][4];
  const uint32_t q_addr = smem_addr(sQ + (row0 + (lane & 15)) * STR + (lane >> 4) * 8);
  for (int t = 0; t < ntiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < ntiles)
      cp_tile<D, DL, BK, TC_NT>(sK + (stage ^ 1) * BK * STR, kb, kv_stride,
                                kv_start + (t + 1) * BK, Sk);
    cp_async_commit();
    cp_async_wait<1>();                  // tile t (and Q) have landed
    __syncthreads();
    if constexpr (Q_IN_REGS) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) ldsm_x4(qf[kk], q_addr + kk * 32);
      }
    }
    const int k0 = kv_start + t * BK;
    const uint32_t k_base = smem_addr(sK + (stage * BK + b_row(lane)) * STR + b_col(lane));
    float s[NKT][4] = {};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if constexpr (Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldsm_x4(a, q_addr + kk * 32);
      }
#pragma unroll
      for (int jp = 0; jp < NKT / 2; ++jp) {
        uint32_t bk[4];
        ldsm_x4(bk, k_base + (jp * 16 * STR + kk * 16) * 2);
        mma_bf16(s[2 * jp], a, bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], a, bk[2], bk[3]);
      }
    }
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && q0 + TC_BQ - 1 - k0 >= window);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = q0 + row0 + g + r * 8;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[j][2 * r + c] * scale_log2;
          if (edge && !keep(qp, k0 + j * 8 + 2 * tq + c, Sq, Sk, causal, window)) x = -INFINITY;
          s[j][2 * r + c] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;   // a row masked so far
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NKT; ++j) sum += exp2f(s[j][2 * r] - m_use) + exp2f(s[j][2 * r + 1] - m_use);
      l_r[r] = exp2f(m_r[r] - m_use) * l_r[r] + sum;
      m_r[r] = m_new;
    }
    __syncthreads();                     // stage is refilled at t + 2
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qp = q0 + row0 + g + r * 8;
    // a row no key is left to has P = 0 (the forward writes 0 there)
    if (tq == 0 && qp < Sq) lse[((long)b * H + h) * Sq + qp] = l > 0.f ? m_r[r] + log2f(l) : INFINITY;
  }
}

// (b), bf16. A 1-D grid of (k tile, y, batch row) with y and the rows
// fastest, k tile 0 (the longest causal walk) first; y is the kv head, or
// the q head when split. Warp w owns k rows 16 (w % 4) and, at DW = 2, q
// columns and dK/dV columns of half (w / 4).
template <int D, int DL>
__global__ void __launch_bounds__(Tc<D>::NT_B)
flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         float* __restrict__ part_k, float* __restrict__ part_v, int Sq, int Sk,
                         int H, int K, int causal, int window, float scale_log2, float scale,
                         int split) {
  using namespace sm90;
  constexpr int STR = Tc<D>::STR, DW = Tc<D>::DW, NT_B = Tc<D>::NT_B, PSTR = Tc<D>::PSTR;
  constexpr int KD = D / 16;             // k-steps of S^T and dP^T
  constexpr int QW = TC_BQ / DW;         // q columns of a warp's S^T
  constexpr int NQT = QW / 8;            // its n-tiles
  constexpr int DC = D / DW;             // dK and dV columns of a warp
  constexpr int NDC = DC / 8;            // their n-tiles
  constexpr bool KV_IN_REGS = D <= 64;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);    // BN x STR
  bf16* sV = sK + TC_BN * STR;                      // BN x STR
  bf16* sQ = sV + TC_BN * STR;                      // 2 x BQ x STR
  bf16* sG = sQ + 2 * TC_BQ * STR;                  // 2 x BQ x STR: dO
  bf16* sP = sG + 2 * TC_BQ * STR;                  // BN x PSTR: P^T (DW = 2)
  bf16* sS = sP + (DW > 1 ? TC_BN * PSTR : 0);      // BN x PSTR: dS^T (DW = 2)
  float* sL = reinterpret_cast<float*>(sS + (DW > 1 ? TC_BN * PSTR : 0));  // 2 x BQ
  float* sDl = sL + 2 * TC_BQ;                                              // 2 x BQ

  const int G = H / K, Y = split ? H : K;
  const int yb = (int)gridDim.x / ((Sk + TC_BN - 1) / TC_BN);   // Y x B
  const int k0 = (int)(blockIdx.x / yb) * TC_BN;
  const int y = (int)(blockIdx.x % yb) % Y, b = (int)(blockIdx.x % yb) / Y;
  const int kh = split ? y / G : y;
  const int h_first = split ? y : kh * G, nh = split ? 1 : G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = (warp & 3) * 16, half = warp >> 2;
  const long q_stride = (long)H * DL, kv_stride = (long)K * DL;
  const long kv_off = ((long)b * Sk * K + kh) * DL;

  int q_lo, q_hi;
  q_range(k0, TC_BN, Sq, causal, window, q_lo, q_hi);
  const int nq = q_hi > q_lo ? (q_hi - q_lo + TC_BQ - 1) / TC_BQ : 0;
  const int total = nh * nq;
  auto load_q = [&](int it, int stage) {
    const int hh = h_first + it / nq, q0 = q_lo + (it % nq) * TC_BQ;
    const long q_off = ((long)b * Sq * H + hh) * DL, r_off = ((long)b * H + hh) * Sq;
    cp_tile<D, DL, TC_BQ, NT_B>(sQ + stage * TC_BQ * STR, q + q_off, q_stride, q0, Sq);
    cp_tile<D, DL, TC_BQ, NT_B>(sG + stage * TC_BQ * STR, dout + q_off, q_stride, q0, Sq);
    for (int i = tid; i < 2 * TC_BQ; i += NT_B) {
      const int r = i % TC_BQ, qp = q0 + r;
      const float* src = (i < TC_BQ ? lse : delta) + r_off + (qp < Sq ? qp : 0);
      cp_async4(smem_addr((i < TC_BQ ? sL : sDl) + stage * TC_BQ + r), src, qp < Sq);
    }
  };
  cp_tile<D, DL, TC_BN, NT_B>(sK, k + kv_off, kv_stride, k0, Sk);
  cp_tile<D, DL, TC_BN, NT_B>(sV, v + kv_off, kv_stride, k0, Sk);
  if (total > 0) load_q(0, 0);
  cp_async_commit();                     // group 0: K, V and the first q tile

  float acc_k[NDC][4] = {}, acc_v[NDC][4] = {};
  uint32_t kf[KV_IN_REGS ? KD : 1][4], vf[KV_IN_REGS ? KD : 1][4];
  const uint32_t k_addr = smem_addr(sK + (row0 + (lane & 15)) * STR + (lane >> 4) * 8);
  const uint32_t v_addr = smem_addr(sV + (row0 + (lane & 15)) * STR + (lane >> 4) * 8);

  for (int it = 0; it < total; ++it) {
    const int stage = it & 1;
    if (it + 1 < total) load_q(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                  // q tile it (and K, V) have landed
    __syncthreads();
    if constexpr (KV_IN_REGS) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          ldsm_x4(kf[kk], k_addr + kk * 32);
          ldsm_x4(vf[kk], v_addr + kk * 32);
        }
      }
    }
    const int q0 = q_lo + (it % nq) * TC_BQ;
    const bf16* tQ = sQ + stage * TC_BQ * STR;
    const bf16* tG = sG + stage * TC_BQ * STR;

    // S^T = K Q^T and dP^T = V dO^T over this warp's q columns
    const uint32_t bq = smem_addr(tQ + (half * QW + b_row(lane)) * STR + b_col(lane));
    const uint32_t bg = smem_addr(tG + (half * QW + b_row(lane)) * STR + b_col(lane));
    float st[NQT][4] = {}, dpt[NQT][4] = {};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ak[4], av[4];
      if constexpr (KV_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ak[e] = kf[kk][e];
          av[e] = vf[kk][e];
        }
      } else {
        ldsm_x4(ak, k_addr + kk * 32);
        ldsm_x4(av, v_addr + kk * 32);
      }
#pragma unroll
      for (int jp = 0; jp < NQT / 2; ++jp) {
        uint32_t fq[4], fg[4];
        ldsm_x4(fq, bq + (jp * 16 * STR + kk * 16) * 2);
        ldsm_x4(fg, bg + (jp * 16 * STR + kk * 16) * 2);
        mma_bf16(st[2 * jp], ak, fq[0], fq[1]);
        mma_bf16(st[2 * jp + 1], ak, fq[2], fq[3]);
        mma_bf16(dpt[2 * jp], av, fg[0], fg[1]);
        mma_bf16(dpt[2 * jp + 1], av, fg[2], fg[3]);
      }
    }

    // P^T = exp2(S^T - L) where the masks keep the pair, dS^T = P^T o (dP^T - Delta)
    const bool edge = q0 + TC_BQ > Sq || k0 + TC_BN > Sk || (causal && k0 + TC_BN - 1 > q0) ||
                      (window > 0 && q0 + TC_BQ - 1 - k0 >= window);
    const float* tL = sL + stage * TC_BQ + half * QW;
    const float* tD = sDl + stage * TC_BQ + half * QW;
#pragma unroll
    for (int j = 0; j < NQT; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(tL + j * 8 + 2 * tq);
      const float2 d2 = *reinterpret_cast<const float2*>(tD + j * 8 + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + row0 + g + (e >> 1) * 8;
        const int qp = q0 + half * QW + j * 8 + 2 * tq + (e & 1);
        float p = exp2f(st[j][e] * scale_log2 - ((e & 1) ? l2.y : l2.x));
        if (edge && !keep(qp, kp, Sq, Sk, causal, window)) p = 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - ((e & 1) ? d2.y : d2.x));
      }
    }

    // dV += P^T dO and dK += dS^T Q over this warp's D columns. P^T and dS^T
    // are A fragments straight from the accumulators (DW = 1), or, at DW = 2,
    // after the pair has swapped its halves of them through shared memory;
    // dO and Q by ldmatrix.trans (their rows are the products' k dimension).
    if constexpr (DW > 1) {
#pragma unroll
      for (int j = 0; j < NQT; ++j) {
        const int at = (row0 + g) * PSTR + half * QW + j * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(sP + at) = pack_bf16(st[j][0], st[j][1]);
        *reinterpret_cast<uint32_t*>(sP + at + 8 * PSTR) = pack_bf16(st[j][2], st[j][3]);
        *reinterpret_cast<uint32_t*>(sS + at) = pack_bf16(dpt[j][0], dpt[j][1]);
        *reinterpret_cast<uint32_t*>(sS + at + 8 * PSTR) = pack_bf16(dpt[j][2], dpt[j][3]);
      }
      __syncthreads();
    }
    const uint32_t p_addr = smem_addr(sP + (row0 + (lane & 15)) * PSTR + (lane >> 4) * 8);
    const uint32_t s_addr = smem_addr(sS + (row0 + (lane & 15)) * PSTR + (lane >> 4) * 8);
    const uint32_t gt = smem_addr(tG + bt_row(lane) * STR + half * DC + bt_col(lane));
    const uint32_t qt = smem_addr(tQ + bt_row(lane) * STR + half * DC + bt_col(lane));
#pragma unroll
    for (int kk = 0; kk < TC_BQ / 16; ++kk) {
      uint32_t ap[4], as[4];
      if constexpr (DW == 1) {
        acc_to_a(ap, st[2 * kk], st[2 * kk + 1]);
        acc_to_a(as, dpt[2 * kk], dpt[2 * kk + 1]);
      } else {
        ldsm_x4(ap, p_addr + kk * 32);
        ldsm_x4(as, s_addr + kk * 32);
      }
#pragma unroll
      for (int d16 = 0; d16 < DC / 16; ++d16) {
        uint32_t fg[4], fq[4];
        ldsm_x4_trans(fg, gt + (kk * 16 * STR + d16 * 16) * 2);
        ldsm_x4_trans(fq, qt + (kk * 16 * STR + d16 * 16) * 2);
        mma_bf16(acc_v[2 * d16], ap, fg[0], fg[1]);
        mma_bf16(acc_v[2 * d16 + 1], ap, fg[2], fg[3]);
        mma_bf16(acc_k[2 * d16], as, fq[0], fq[1]);
        mma_bf16(acc_k[2 * d16 + 1], as, fq[2], fq[3]);
      }
    }
    __syncthreads();                     // stage is refilled at it + 2; sP, sS rewritten
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = k0 + row0 + g + r * 8;
    if (kp >= Sk) continue;
#pragma unroll
    for (int j = 0; j < NDC; ++j) {
      const int c = half * DC + j * 8 + 2 * tq;
      if (DL != D && c >= DL) continue;
      const float k0v = acc_k[j][2 * r] * scale, k1v = acc_k[j][2 * r + 1] * scale;
      if (split) {   // this head's rows of the (B, H, Sk, DL) f32 partials
        const long at = (((long)b * H + h_first) * Sk + kp) * DL + c;
        *reinterpret_cast<float2*>(part_k + at) = make_float2(k0v, k1v);
        *reinterpret_cast<float2*>(part_v + at) = make_float2(acc_v[j][2 * r], acc_v[j][2 * r + 1]);
      } else {
        const long at = kv_off + kp * kv_stride + c;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(k0v, k1v);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(acc_v[j][2 * r], acc_v[j][2 * r + 1]);
      }
    }
  }
}

// (c), bf16.
template <int D, int DL>
__global__ void __launch_bounds__(TC_NT)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dq, int Sq, int Sk, int H, int K, int causal,
                       int window, float scale_log2, float scale) {
  using namespace sm90;
  constexpr int BK = Tc<D>::BK, STR = Tc<D>::STR, KD = D / 16, NKT = BK / 8, NDT = D / 8;
  constexpr bool IN_REGS = D <= 64;      // Q and dO fragments for the whole kv walk
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);    // BQ x STR
  bf16* sG = sQ + TC_BQ * STR;                      // BQ x STR: dO
  bf16* sK = sG + TC_BQ * STR;                      // 2 x BK x STR
  bf16* sV = sK + 2 * BK * STR;                     // 2 x BK x STR

  int q0, h, b;
  q_tile_of(Sq, H, q0, h, b);
  const int kh = h / (H / K);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3, row0 = warp * 16;
  const long q_stride = (long)H * DL, kv_stride = (long)K * DL;
  const long q_off = ((long)b * Sq * H + h) * DL;
  const bf16* kb = k + ((long)b * Sk * K + kh) * DL;
  const bf16* vb = v + ((long)b * Sk * K + kh) * DL;

  int kv_start, kv_end;
  kv_range(q0, TC_BQ, BK, Sk, causal, window, kv_start, kv_end);
  const int ntiles = kv_end > kv_start ? (kv_end - kv_start + BK - 1) / BK : 0;
  auto load_kv = [&](int t, int stage) {
    const int k0 = kv_start + t * BK;
    cp_tile<D, DL, BK, TC_NT>(sK + stage * BK * STR, kb, kv_stride, k0, Sk);
    cp_tile<D, DL, BK, TC_NT>(sV + stage * BK * STR, vb, kv_stride, k0, Sk);
  };
  cp_tile<D, DL, TC_BQ, TC_NT>(sQ, q + q_off, q_stride, q0, Sq);
  cp_tile<D, DL, TC_BQ, TC_NT>(sG, dout + q_off, q_stride, q0, Sq);
  if (ntiles > 0) load_kv(0, 0);
  cp_async_commit();                     // group 0: Q, dO and the first kv tile

  float L[2], Dl[2];                     // rows g and g + 8 (P = 0 past Sq)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + row0 + g + r * 8;
    L[r] = qp < Sq ? lse[((long)b * H + h) * Sq + qp] : INFINITY;
    Dl[r] = qp < Sq ? delta[((long)b * H + h) * Sq + qp] : 0.f;
  }
  float acc[NDT][4] = {};
  uint32_t qf[IN_REGS ? KD : 1][4], gf[IN_REGS ? KD : 1][4];
  const uint32_t q_addr = smem_addr(sQ + (row0 + (lane & 15)) * STR + (lane >> 4) * 8);
  const uint32_t g_addr = smem_addr(sG + (row0 + (lane & 15)) * STR + (lane >> 4) * 8);

  for (int t = 0; t < ntiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < ntiles) load_kv(t + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                  // tile t (and Q, dO) have landed
    __syncthreads();
    if constexpr (IN_REGS) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          ldsm_x4(qf[kk], q_addr + kk * 32);
          ldsm_x4(gf[kk], g_addr + kk * 32);
        }
      }
    }
    const int k0 = kv_start + t * BK;
    const uint32_t kb_n = smem_addr(sK + (stage * BK + b_row(lane)) * STR + b_col(lane));
    const uint32_t vb_n = smem_addr(sV + (stage * BK + b_row(lane)) * STR + b_col(lane));

    // S = Q K^T and dP = dO V^T
    float s[NKT][4] = {}, dp[NKT][4] = {};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t aq[4], ag[4];
      if constexpr (IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          aq[e] = qf[kk][e];
          ag[e] = gf[kk][e];
        }
      } else {
        ldsm_x4(aq, q_addr + kk * 32);
        ldsm_x4(ag, g_addr + kk * 32);
      }
#pragma unroll
      for (int jp = 0; jp < NKT / 2; ++jp) {
        uint32_t fk[4], fv[4];
        ldsm_x4(fk, kb_n + (jp * 16 * STR + kk * 16) * 2);
        ldsm_x4(fv, vb_n + (jp * 16 * STR + kk * 16) * 2);
        mma_bf16(s[2 * jp], aq, fk[0], fk[1]);
        mma_bf16(s[2 * jp + 1], aq, fk[2], fk[3]);
        mma_bf16(dp[2 * jp], ag, fv[0], fv[1]);
        mma_bf16(dp[2 * jp + 1], ag, fv[2], fv[3]);
      }
    }

    // dS = P o (dP - Delta), P = exp2(S - L) where the masks keep the pair
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && q0 + TC_BQ - 1 - k0 >= window);
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = q0 + row0 + g + (e >> 1) * 8, kp = k0 + j * 8 + 2 * tq + (e & 1);
        float p = exp2f(s[j][e] * scale_log2 - L[e >> 1]);
        if (edge && !keep(qp, kp, Sq, Sk, causal, window)) p = 0.f;
        dp[j][e] = p * (dp[j][e] - Dl[e >> 1]);
      }

    // dQ += dS K, dS rounded to bf16 in registers as the A fragment; K by
    // ldmatrix.trans
    const uint32_t kb_t = smem_addr(sK + (stage * BK + bt_row(lane)) * STR + bt_col(lane));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int d16 = 0; d16 < D / 16; ++d16) {
        uint32_t fk[4];
        ldsm_x4_trans(fk, kb_t + (kk * 16 * STR + d16 * 16) * 2);
        mma_bf16(acc[2 * d16], a, fk[0], fk[1]);
        mma_bf16(acc[2 * d16 + 1], a, fk[2], fk[3]);
      }
    }
    __syncthreads();                     // stage is refilled at t + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + row0 + g + r * 8;
    if (qp >= Sq) continue;
    bf16* row = dq + q_off + qp * q_stride + 2 * tq;
#pragma unroll
    for (int j = 0; j < NDT; ++j)
      if (DL == D || j * 8 < DL)
        *reinterpret_cast<__nv_bfloat162*>(row + j * 8) =
            __floats2bfloat162_rn(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
  }
}

// ------------------------------------------------------------------ (r)
// dK and dV of each kv head: the sum of its G q heads' f32 partials in
// order g = 0 .. G - 1, written once in T. Four columns a thread.
__device__ __forceinline__ void store4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ void store4(bf16* p, float4 x) {
  reinterpret_cast<__nv_bfloat162*>(p)[0] = __floats2bfloat162_rn(x.x, x.y);
  reinterpret_cast<__nv_bfloat162*>(p)[1] = __floats2bfloat162_rn(x.z, x.w);
}

template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_reduce_kernel(const float* __restrict__ part_k, const float* __restrict__ part_v,
                        T* __restrict__ dk, T* __restrict__ dv, int B, int Sk, int H, int K,
                        int DL) {
  const int G = H / K, C4 = DL / 4, n = B * Sk * K * C4;   // n < 2^31: the launch checks
  for (int i = blockIdx.x * 256 + threadIdx.x; i < n; i += gridDim.x * 256) {
    const int c = i % C4 * 4, r = i / C4, kh = r % K, kp = r / K % Sk, b = r / K / Sk;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int gg = 0; gg < G; ++gg) {
      const long at = (((long)b * H + kh * G + gg) * Sk + kp) * DL + c;
      const float4 a = *reinterpret_cast<const float4*>(part_k + at);
      const float4 w = *reinterpret_cast<const float4*>(part_v + at);
      sk = make_float4(sk.x + a.x, sk.y + a.y, sk.z + a.z, sk.w + a.w);
      sv = make_float4(sv.x + w.x, sv.y + w.y, sv.z + w.z, sv.w + w.w);
    }
    const long out = (((long)b * Sk + kp) * K + kh) * DL + c;
    store4(dk + out, sk);
    store4(dv + out, sv);
  }
}

template <typename T>
cudaError_t launch_reduce(const float* part_k, const float* part_v, void* dk, void* dv, int B,
                          int Sk, int H, int K, int DL, cudaStream_t stream) {
  const long long n = (long long)B * Sk * K * (DL / 4);
  if (n > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int blocks = (int)((n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16);
  flash_bwd_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      part_k, part_v, static_cast<T*>(dk), static_cast<T*>(dv), B, Sk, H, K, DL);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// f32 route
template <int D, int DL>
cudaError_t launch(const void* dout, const void* q, const void* k, const void* v,
                   const void* o, void* dq, void* dk, void* dv, float* lse, float* delta,
                   int B, int Sq, int Sk, int H, int K, int causal, int window, float scale,
                   cudaStream_t stream) {
  using Tile = BwdTile<D>;
  constexpr int BM = Tile::BM;
  cudaError_t err;
  if ((err = allow_smem(flash_bwd_prep_kernel<D, DL>, Tile::SMEM_PREP)) != cudaSuccess ||
      (err = allow_smem(flash_bwd_dkdv_kernel<D, DL>, Tile::SMEM_DKDV)) != cudaSuccess ||
      (err = allow_smem(flash_bwd_dq_kernel<D, DL>, Tile::SMEM_DQ)) != cudaSuccess)
    return err;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tg = static_cast<const float*>(dout);
  const int nk = (Sk + BM - 1) / BM;
  const bool split = split_dkdv((long long)nk * K * B, H / K);
  float* part_k = lse + ((long long)B * H * Sq + 63) / 64 * 64;
  float* part_v = part_k + (long long)B * H * Sk * DL;
  // heads and rows fastest, the longest causal walks first: the last q
  // tile in (a) and (c), k tile 0 in (b)
  const int nq = (Sq + BM - 1) / BM;
  if (nq > 65535 || nk > 65535) return cudaErrorInvalidValue;
  const dim3 grid_q(H, B, nq), grid_k(split ? H : K, B, nk);
  flash_bwd_prep_kernel<D, DL><<<grid_q, NT, Tile::SMEM_PREP, stream>>>(
      tq, tk, static_cast<const float*>(o), tg, lse, delta, Sq, Sk, H, K, causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<D, DL><<<grid_k, NT, Tile::SMEM_DKDV, stream>>>(
      tq, tk, tv, tg, lse, delta, split ? part_k : static_cast<float*>(dk),
      split ? part_v : static_cast<float*>(dv), Sq, Sk, H, K, causal, window, scale, split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dq_kernel<D, DL><<<grid_q, NT, Tile::SMEM_DQ, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<float*>(dq), Sq, Sk, H, K, causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return split ? launch_reduce<float>(part_k, part_v, dk, dv, B, Sk, H, K, DL, stream)
               : cudaSuccess;
}

// bf16 route
template <int D, int DL>
cudaError_t launch_tc(const void* dout, const void* q, const void* k, const void* v,
                      const void* o, void* dq, void* dk, void* dv, float* lse, float* delta,
                      int B, int Sq, int Sk, int H, int K, int causal, int window, float scale,
                      cudaStream_t stream) {
  using T = Tc<D>;
  cudaError_t err;
  if ((err = allow_smem(flash_bwd_prep_tc_kernel<D, DL>, T::SMEM_A)) != cudaSuccess ||
      (err = allow_smem(flash_bwd_dkdv_tc_kernel<D, DL>, T::SMEM_B)) != cudaSuccess ||
      (err = allow_smem(flash_bwd_dq_tc_kernel<D, DL>, T::SMEM_C)) != cudaSuccess)
    return err;
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tg = static_cast<const bf16*>(dout);
  const long long nk = (Sk + TC_BN - 1) / TC_BN;
  const bool split = split_dkdv(nk * K * B, H / K);
  float* part_k = lse + ((long long)B * H * Sq + 63) / 64 * 64;
  float* part_v = part_k + (long long)B * H * Sk * DL;
  const long long blocks_q = (long long)((Sq + TC_BQ - 1) / TC_BQ) * H * B;
  const long long blocks_k = nk * (split ? H : K) * B;
  if (blocks_q > 0x7fffffffLL || blocks_k > 0x7fffffffLL) return cudaErrorInvalidValue;
  const float scale_log2 = scale * LOG2E;
  flash_bwd_prep_tc_kernel<D, DL><<<(unsigned)blocks_q, TC_NT, T::SMEM_A, stream>>>(
      tq, tk, static_cast<const bf16*>(o), tg, lse, delta, Sq, Sk, H, K, causal, window,
      scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkdv_tc_kernel<D, DL><<<(unsigned)blocks_k, T::NT_B, T::SMEM_B, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), part_k,
      part_v, Sq, Sk, H, K, causal, window, scale_log2, scale, split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dq_tc_kernel<D, DL><<<(unsigned)blocks_q, TC_NT, T::SMEM_C, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<bf16*>(dq), Sq, Sk, H, K, causal, window,
      scale_log2, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return split ? launch_reduce<bf16>(part_k, part_v, dk, dv, B, Sk, H, K, DL, stream)
               : cudaSuccess;
}

cudaError_t dispatch_d(const void* dout, const void* q, const void* k, const void* v,
                       const void* o, void* dq, void* dk, void* dv, float* lse, float* delta,
                       int B, int Sq, int Sk, int H, int K, int D, int is_bf16, int causal,
                       int window, float scale, cudaStream_t stream) {
  // bf16 goes to the tensor-core kernels, f32 to the FMA kernels; D = 8 runs
  // at the compute width 16 with zero-filled columns.
#define REPRO_FLASH_BWD_CASE(DD, DC)                                                     \
  case DD:                                                                              \
    return is_bf16 ? launch_tc<DC, DD>(dout, q, k, v, o, dq, dk, dv, lse, delta, B, Sq, \
                                       Sk, H, K, causal, window, scale, stream)         \
                   : launch<DC, DD>(dout, q, k, v, o, dq, dk, dv, lse, delta, B, Sq, Sk, \
                                    H, K, causal, window, scale, stream);
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
// and of one dtype (is_bf16 = 1 for bfloat16, 0 for float32). lse: f32
// scratch of repro_flash_attention_bwd_scratch_floats(...) floats (the rows'
// L, then (b)'s per-head dK and dV partials when it is split); delta: f32
// scratch of B * H * Sq floats. Launches the kernels on `stream` in order,
// does not synchronise, and returns the first cudaGetLastError() that is
// not 0 (0 on success).
extern "C" int repro_flash_attention_bwd(const void* dout, const void* q, const void* k,
                                         const void* v, const void* o, void* dq, void* dk,
                                         void* dv, void* lse, void* delta, int B, int Sq,
                                         int Sk, int H, int K, int D, int is_bf16, int causal,
                                         int window, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || K < 1 || H % K != 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_d(dout, q, k, v, o, dq, dk, dv, static_cast<float*>(lse),
                         static_cast<float*>(delta), B, Sq, Sk, H, K, D, is_bf16, causal,
                         window, scale, static_cast<cudaStream_t>(stream));
}

// Floats of the `lse` scratch that repro_flash_attention_bwd needs for these
// shapes on the current device: B * H * Sq rounded up to 64, plus 2 * B * H
// * Sk * D when the split rule splits the dK/dV pass; 0 for an unsupported D.
extern "C" long long repro_flash_attention_bwd_scratch_floats(int B, int Sq, int Sk, int H,
                                                              int K, int D, int is_bf16) {
  if (B < 1 || Sq < 1 || Sk < 1 || K < 1 || H % K != 0) return 0;
  int bn;
  switch (D) {
    case 8: case 16: case 32: case 64: case 128: bn = 64; break;
    case 256: bn = is_bf16 ? TC_BN : BwdTile<256>::BM; break;
    default: return 0;
  }
  return scratch_floats(B, Sq, Sk, H, K, D, bn);
}

// Dynamic shared memory (bytes) of one CTA of the dK/dV kernel, the largest
// of its route, at head_dim D; 0 for an unsupported D.
extern "C" long long repro_flash_attention_bwd_smem_bytes(int D, int is_bf16) {
  switch (D) {
    case 8:  // computed at width 16
    case 16: return is_bf16 ? Tc<16>::SMEM_B : BwdTile<16>::SMEM_DKDV;
    case 32: return is_bf16 ? Tc<32>::SMEM_B : BwdTile<32>::SMEM_DKDV;
    case 64: return is_bf16 ? Tc<64>::SMEM_B : BwdTile<64>::SMEM_DKDV;
    case 128: return is_bf16 ? Tc<128>::SMEM_B : BwdTile<128>::SMEM_DKDV;
    case 256: return is_bf16 ? Tc<256>::SMEM_B : BwdTile<256>::SMEM_DKDV;
    default: return 0;
  }
}
