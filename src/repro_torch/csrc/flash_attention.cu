// Forward GQA flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
// (body `_kernel`). Same function: online softmax over kv tiles with an f32
// running max m, normaliser l and accumulator; query head h reads kv head
// h / (H / K); scale defaults to D^-0.5; masks go in before the max update
// (padding kpos < Sk, causal kpos <= qpos with both positions counted from
// 0 — top-left alignment — and window qpos - kpos < window); rows with
// l == 0 output 0.
//
// Two routes, chosen by dtype:
//   * bfloat16: flash_fwd_tc_kernel, on the tensor cores (below);
//   * float32: flash_fwd_kernel, on the FP32 FMA pipes. f32 is used only by
//     the float32 parity checks, whose 1e-4 tolerance TF32 (10-bit
//     mantissa) would break, so that route keeps full f32 products.
//
// Shared by both (taken from what the kernel computes, not block by block):
//   * one CTA per (q tile, query head, batch row); a loop inside the CTA
//     walks the kv tiles, which takes the place of the TPU grid's
//     sequential `arbitrary` kv axis. Causal and window masks also bound
//     that loop, so tiles that are wholly masked are never loaded.
//   * tensors are read in the model's (B, S, H, D) layout straight from
//     device memory: no transposes, no repeated kv heads, no padding copies.
//     Ragged edges (Sq, Sk not multiples of the tile) are masked in the
//     kernel. m, l and O stay in registers; O is written once.
//
// The bf16 route (mma.sync.m16n8k16, bf16 in, f32 accumulate):
//   * 4 warps, each owning 16 of the CTA's 64 query rows; the 1-D grid hands
//     out the longest causal q tiles first. (Two m-tiles a warp, 128 rows a
//     CTA, was faster at S = 2048 but slower on granite-8b's prefills of
//     100-340 tokens, whose grids then covered a third of the SMs or less.)
//   * K and V tiles of BK keys (64 at D <= 128, 32 at D = 256) stay bf16 in
//     shared memory, filled by 16-byte cp.async and double-buffered: tile
//     t + 1 is in flight while tile t is multiplied. Rows are padded by 16
//     bytes (stride D + 8), so the 8 row addresses of every ldmatrix fall in
//     8 distinct bank groups. 87,040 bytes at D = 128, 101,376 at D = 256:
//     two CTAs per SM (the f32 staging of the FMA route took 213,760 bytes
//     at D = 256, one CTA per SM).
//   * S = Q K^T: Q fragments by ldmatrix (held in registers for the whole kv
//     loop at D <= 128, re-read per k-step at D = 256, where the 128-float
//     accumulator leaves no room), K fragments by ldmatrix, a k-step's
//     fragments loaded before its products.
//   * softmax on the accumulator fragments in registers: a row lives in the
//     4 lanes of a quad (two shuffles for max and sum); exp2f with log2(e)
//     folded into the scale; masks only on tiles that cross Sk, the
//     diagonal or the window's edge.
//   * O += P V: P is rounded to bf16 in registers and used directly as the
//     A fragment (the m16n8 accumulator layout is the m16n8k16 A layout), so
//     P never goes through shared memory; V fragments by ldmatrix.trans;
//     l sums the unrounded P in f32. Rounding P to bf16 stays well inside
//     the bf16 tolerance (a plain emulation in
//     tests/test_torch_flash_attention.py is held to it).
//
// What bounds it on the H100 at the serving shapes (B=1, bf16, causal):
// about 4 S^2 D H / 2 FLOPs over (2 H + 2 K) S D 2 bytes, so granite-8b's
// prefills (H=32, K=8, D=128, S <= 340) are bound by the 3.35 TB/s memory
// rate (about 2 us at S=340) and from S of about 700 on by the 989 TFLOP/s
// bf16 tensor-core rate (35 us at S=2048). mma.sync reaches only part of
// that rate; wgmma with TMA-fed tiles is the next step.
//
// Head dim 8 (llama3-smoke) runs as D = 16 with zero-filled columns: each
// kernel takes the compute width D and the tensors' own width DL <= D as
// template arguments, reads rows of DL elements (DL-strided) and zero-fills
// columns DL..D-1 of its Q, K and V tiles in shared memory, so Q K^T (over
// the 16 of a bf16 mma k-step) and P V are those of the true D; only the
// first DL output columns are written. The scale stays the caller's (the
// true D's ^-0.5).
//
// Accepts float32 and bfloat16, D in {8, 16, 32, 64, 128, 256}, any Sq, Sk >= 1,
// causal or not, optional window (window <= 0 means none). The Python
// wrapper validates shapes, dtypes and contiguity before calling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90_mma.cuh"

namespace {

constexpr int BQ = 64;             // query rows per CTA
constexpr int BK = 64;             // keys per kv tile
constexpr int NT = 256;            // threads per CTA: 16 row groups x 16 lanes
constexpr int RPT = BQ / 16;       // query rows per thread
constexpr int CPT = BK / 16;       // keys per thread in S
constexpr int PS = BK + 1;         // padded row stride of the P tile
constexpr float NEG_INF = -1e30f;  // the reference's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // sQ and sK rows padded to D + 1 words; sV unpadded; sP padded to BK + 1.
  return sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PS);
}

template <typename T, int D, int DL>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int Sq, int Sk, int H, int K, int causal, int window,
                 float scale) {
  constexpr int DS = D + 1;        // padded row stride of sQ and sK
  constexpr int DPT = D / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                // BQ x DS
  float* sK = sQ + BQ * DS;        // BK x DS
  float* sV = sK + BK * DS;        // BK x D
  float* sP = sV + BK * D;         // BQ x PS

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;         // row group: rows ty*RPT .. ty*RPT+RPT-1
  const int tx = tid & 15;         // lane within the half-warp owning them

  // (B, S, H, DL) layout: consecutive sequence positions are H*DL (or
  // K*DL) elements apart, each row of DL elements is contiguous.
  const long q_stride = (long)H * DL;
  const long kv_stride = (long)K * DL;
  const T* qb = q + ((long)b * Sq * H + h) * DL;
  const T* kb = k + ((long)b * Sk * K + kh) * DL;
  const T* vb = v + ((long)b * Sk * K + kh) * DL;
  T* ob = o + ((long)b * Sq * H + h) * DL;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int qp = q0 + r;
    sQ[r * DS + c] = qp < Sq && (DL == D || c < DL) ? to_f32(qb[qp * q_stride + c]) : 0.f;
  }

  // kv range this q tile can see: causal stops at its last row, a window
  // starts at its first row's oldest visible key.
  int kv_end = Sk;
  if (causal) kv_end = min(Sk, q0 + BQ);
  int kv_start = 0;
  if (window > 0) kv_start = max(0, q0 - window + 1);
  kv_start = (kv_start / BK) * BK;

  float m_i[RPT], l_i[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = kv_start; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's sK, sV, sP are no longer read
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const int kp = k0 + r;
      const bool in = kp < Sk && (DL == D || c < DL);
      sK[r * DS + c] = in ? to_f32(kb[kp * kv_stride + c]) : 0.f;
      sV[r * D + c] = in ? to_f32(vb[kp * kv_stride + c]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this thread's RPT rows x CPT keys (keys tx + 16 j).
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sQ[(ty * RPT + i) * DS + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = sK[(tx + 16 * j) * DS + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Mask, online softmax update, P tile to shared memory.
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = ty * RPT + i;
      const int qp = q0 + row;
      bool ok[CPT];
      float row_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < Sk && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m_i[i], row_max);
      const float alpha = expf(m_i[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[row * PS + tx + 16 * j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l_i[i] = alpha * l_i[i] + row_sum;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    // A row's P entries were written by the 16 lanes of its own half-warp.
    __syncwarp();

    // O += P V for this thread's RPT rows x DPT columns (tx + 16 j).
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sP[(ty * RPT + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vv = sV[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qp = q0 + ty * RPT + i;
    if (qp >= Sq) continue;
    const float inv = l_i[i] > 0.f ? 1.f / l_i[i] : 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      if (DL == D || tx + 16 * j < DL)
        ob[qp * q_stride + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

// ---------------------------------------------------------------- bf16 route
// Tensor-core kernel: 4 warps, each owning 16 of the CTA's BQ = 64 query
// rows; K and V tiles of BK keys stay bf16 in shared memory, double-buffered
// and filled by cp.async; rows padded by 16 bytes (stride D + 8) so that the
// 8 row addresses of an ldmatrix fall in 8 distinct bank groups for every D.
constexpr int TC_BQ = 64;
constexpr int TC_NT = 128;
constexpr float LOG2E = 1.4426950408889634f;

template <int D> struct TcTile {
  static constexpr int BK = D <= 128 ? 64 : 32;   // keys per tile
  static constexpr int STR = D + 8;                // padded row stride (bf16)
  static constexpr bool Q_IN_REGS = D <= 128;      // else re-read per k-step
  static constexpr size_t SMEM =
      sizeof(__nv_bfloat16) * (size_t)(TC_BQ * STR + 4 * BK * STR);
};

template <int D, int DL>
__global__ void __launch_bounds__(TC_NT, 2)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, int B, int Sq, int Sk, int H,
                    int K, int causal, int window, float scale_log2) {
  using namespace sm90;
  constexpr int BK = TcTile<D>::BK, STR = TcTile<D>::STR;
  constexpr bool Q_IN_REGS = TcTile<D>::Q_IN_REGS;
  constexpr int KD = D / 16;        // k-steps of Q K^T
  constexpr int NKT = BK / 8;       // key n-tiles of S
  constexpr int NDT = D / 8;        // d n-tiles of O
  constexpr int CPR = D / 8;        // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BQ x STR
  __nv_bfloat16* sK = sQ + TC_BQ * STR;                             // 2 x BK x STR
  __nv_bfloat16* sV = sK + 2 * BK * STR;                            // 2 x BK x STR

  // Longest causal q tiles first: block 0 takes the last q tile of every
  // (head, row) pair before any shorter one starts.
  const int nq = (Sq + TC_BQ - 1) / TC_BQ;
  const int hb = H * B;
  const int qt = nq - 1 - (int)(blockIdx.x / hb);
  const int h = (int)(blockIdx.x % hb) % H;
  const int b = (int)(blockIdx.x % hb) / H;
  const int q0 = qt * TC_BQ;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = warp * 16;

  const long q_stride = (long)H * DL;
  const long kv_stride = (long)K * DL;
  const __nv_bfloat16* qb = q + ((long)b * Sq * H + h) * DL;
  const __nv_bfloat16* kb = k + ((long)b * Sk * K + kh) * DL;
  const __nv_bfloat16* vb = v + ((long)b * Sk * K + kh) * DL;
  __nv_bfloat16* ob = o + ((long)b * Sq * H + h) * DL;

  int kv_end = Sk;
  if (causal) kv_end = min(Sk, q0 + TC_BQ);
  int kv_start = 0;
  if (window > 0) kv_start = max(0, q0 - window + 1);
  kv_start = (kv_start / BK) * BK;
  const int ntiles = kv_end > kv_start ? (kv_end - kv_start + BK - 1) / BK : 0;

  // 16-byte chunks of 8 columns; the chunks at columns >= DL are zero-filled
  for (int c = tid; c < TC_BQ * CPR; c += TC_NT) {
    const int r = c / CPR, col = (c % CPR) * 8, qp = q0 + r;
    const bool in = qp < Sq && (DL == D || col < DL);
    cp_async16(smem_addr(sQ + r * STR + col), in ? qb + qp * q_stride + col : qb, in);
  }
  auto load_kv = [&](int t, int stage) {
    const int k0 = kv_start + t * BK;
    for (int c = tid; c < BK * CPR; c += TC_NT) {
      const int r = c / CPR, col = (c % CPR) * 8, kp = k0 + r;
      const bool in = kp < Sk && (DL == D || col < DL);
      const long off = in ? kp * kv_stride + col : 0;
      cp_async16(smem_addr(sK + (stage * BK + r) * STR + col), kb + off, in);
      cp_async16(smem_addr(sV + (stage * BK + r) * STR + col), vb + off, in);
    }
  };
  if (ntiles > 0) load_kv(0, 0);
  cp_async_commit();                     // group 0: Q and the first kv tile

  float acc[NDT][4];
#pragma unroll
  for (int j = 0; j < NDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};   // running max, base 2, rows g and g+8
  float l_r[2] = {0.f, 0.f};               // this lane's part of the row sums
  uint32_t qf[Q_IN_REGS ? KD : 1][4];

  // ldmatrix row addresses of this lane: A from row-major Q; B = K^T from
  // K's rows (non-transposed); B = V from V's rows (transposed).
  const uint32_t q_addr = smem_addr(sQ + (row0 + (lane & 15)) * STR + (lane >> 4) * 8);
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_col = (lane >> 4) * 8;

  for (int t = 0; t < ntiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < ntiles) load_kv(t + 1, stage ^ 1);
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
    const uint32_t k_base = smem_addr(sK + (stage * BK + k_row) * STR + k_col);
    const uint32_t v_base = smem_addr(sV + (stage * BK + v_row) * STR + v_col);

    // S = Q K^T; a k-step's K fragments are loaded before its products
    float s[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if constexpr (Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldsm_x4(a, q_addr + kk * 32);
      }
      uint32_t bk[NKT / 2][4];
#pragma unroll
      for (int jp = 0; jp < NKT / 2; ++jp) ldsm_x4(bk[jp], k_base + (jp * 16 * STR + kk * 16) * 2);
#pragma unroll
      for (int jp = 0; jp < NKT / 2; ++jp) {
        mma_bf16(s[2 * jp], a, bk[jp][0], bk[jp][1]);
        mma_bf16(s[2 * jp + 1], a, bk[jp][2], bk[jp][3]);
      }
    }

    // Scale into base 2; masks only on tiles that cross Sk, the diagonal or
    // the window's edge.
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && q0 + TC_BQ - 1 - k0 >= window);
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int qp = q0 + row0 + g + (e >> 1) * 8;
          const int kp = k0 + j * 8 + 2 * tq + (e & 1);
          const bool ok = kp < Sk && (!causal || kp <= qp) &&
                          (window <= 0 || qp - kp < window);
          x = ok ? x : -INFINITY;
        }
        s[j][e] = x;
      }

    // Online softmax on the fragments: a row lives in the 4 lanes of a quad.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NKT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;   // a row masked so far
      const float alpha = exp2f(m_r[r] - m_use);
      m_r[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NKT; ++j) {
        s[j][2 * r] = exp2f(s[j][2 * r] - m_use);
        s[j][2 * r + 1] = exp2f(s[j][2 * r + 1] - m_use);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l_r[r] = alpha * l_r[r] + sum;
#pragma unroll
      for (int j = 0; j < NDT; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }

    // O += P V, P rounded to bf16 in registers as the A fragment; V
    // fragments loaded 4 at a time before their products.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      constexpr int DG = D / 16 < 4 ? D / 16 : 4;
#pragma unroll
      for (int d0 = 0; d0 < D / 16; d0 += DG) {
        uint32_t bv[DG][4];
#pragma unroll
        for (int u = 0; u < DG; ++u)
          ldsm_x4_trans(bv[u], v_base + (kk * 16 * STR + (d0 + u) * 16) * 2);
#pragma unroll
        for (int u = 0; u < DG; ++u) {
          mma_bf16(acc[2 * (d0 + u)], a, bv[u][0], bv[u][1]);
          mma_bf16(acc[2 * (d0 + u) + 1], a, bv[u][2], bv[u][3]);
        }
      }
    }
    __syncthreads();                     // stage is refilled at t + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int qp = q0 + row0 + g + r * 8;
    if (qp >= Sq) continue;
    __nv_bfloat16* orow = ob + qp * q_stride + 2 * tq;
#pragma unroll
    for (int j = 0; j < NDT; ++j)
      if (DL == D || j * 8 < DL)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
            __floats2bfloat162_rn(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
  }
}

template <int D, int DL>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int B,
                      int Sq, int Sk, int H, int K, int causal, int window,
                      float scale, cudaStream_t stream) {
  constexpr size_t smem = TcTile<D>::SMEM;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D, DL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const long blocks = (long)((Sq + TC_BQ - 1) / TC_BQ) * H * B;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  flash_fwd_tc_kernel<D, DL><<<(unsigned)blocks, TC_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), B, Sq,
      Sk, H, K, causal, window, scale * LOG2E);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- f32 route
template <typename T, int D, int DL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int K, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, DL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D, DL><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, K, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Sk, int H, int K, int D, int causal,
                       int window, float scale, cudaStream_t stream) {
  // bf16 goes to the tensor-core kernel, f32 to the FMA kernel; D = 8 runs
  // at the compute width 16 with zero-filled columns.
  constexpr bool tc = sizeof(T) == 2;
#define REPRO_FLASH_CASE(DD, DC)                                                  \
  case DD:                                                                       \
    return tc ? launch_tc<DC, DD>(q, k, v, o, B, Sq, Sk, H, K, causal, window,    \
                                  scale, stream)                                 \
              : launch<float, DC, DD>(q, k, v, o, B, Sq, Sk, H, K, causal,       \
                                      window, scale, stream);
  switch (D) {
    REPRO_FLASH_CASE(8, 16)
    REPRO_FLASH_CASE(16, 16)
    REPRO_FLASH_CASE(32, 32)
    REPRO_FLASH_CASE(64, 64)
    REPRO_FLASH_CASE(128, 128)
    REPRO_FLASH_CASE(256, 256)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_CASE
}

}  // namespace

// q: (B, Sq, H, D), k and v: (B, Sk, K, D), o: (B, Sq, H, D), all contiguous
// and of one dtype (is_bf16 = 1 for bfloat16, 0 for float32). Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int B, int Sq,
                                         int Sk, int H, int K, int D,
                                         int is_bf16, int causal, int window,
                                         float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || K < 1 || H % K != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, K, D, causal, window, scale, s)
              : dispatch_d<float>(q, k, v, o, B, Sq, Sk, H, K, D, causal, window, scale, s);
  return (int)err;
}

// Dynamic shared memory (bytes) of one CTA of the kernel that takes head_dim
// D in the given dtype; 0 for an unsupported D.
extern "C" long long repro_flash_attention_smem_bytes(int D, int is_bf16) {
  switch (D) {
    case 8:  // computed at width 16
    case 16: return is_bf16 ? TcTile<16>::SMEM : smem_bytes<16>();
    case 32: return is_bf16 ? TcTile<32>::SMEM : smem_bytes<32>();
    case 64: return is_bf16 ? TcTile<64>::SMEM : smem_bytes<64>();
    case 128: return is_bf16 ? TcTile<128>::SMEM : smem_bytes<128>();
    case 256: return is_bf16 ? TcTile<256>::SMEM : smem_bytes<256>();
    default: return 0;
  }
}
