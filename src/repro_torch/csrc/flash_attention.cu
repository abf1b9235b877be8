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
// Design (taken from what the kernel computes, not block by block):
//   * one CTA per (q tile of BQ rows, query head, batch row); a loop inside
//     the CTA walks the kv tiles, which takes the place of the TPU grid's
//     sequential `arbitrary` kv axis. Causal and window masks also bound
//     that loop, so tiles that are wholly masked are never loaded.
//   * tensors are read in the model's (B, S, H, D) layout straight from
//     device memory: no transposes, no repeated kv heads, no padding copies.
//     Ragged edges (Sq, Sk not multiples of the tile) are masked in the
//     kernel.
//   * Q, K, V and the probability tile P are staged in shared memory as
//     f32 (rows padded by one word against bank conflicts); S = Q K^T and
//     O += P V are FMA loops, 4 query rows x 4 keys (S) and 4 rows x D/16
//     columns (O) per thread. Each query row is owned by the 16 lanes of a
//     half-warp, so the row max and row sum are warp shuffles.
//   * m, l and the O accumulator stay in registers for the whole kv loop;
//     O is written once, in the input dtype.
//
// What bounds it on the H100 at the serving slice's shapes (B=1, H=32, K=8,
// D=128, bf16, causal, S=100..340): the work is ~2*S^2*D*H FLOPs over
// ~(2*H + 2*K)*S*D*2 bytes, so at S=340 the bound is the 3.35 TB/s memory
// rate (about 2 us) and from S of about 700 on it is the 989 TFLOP/s bf16
// tensor-core rate. This first version runs on the FP32 FMA pipes
// (67 TFLOP/s peak) out of shared memory and so is bounded by shared-memory
// bandwidth and FMA issue, far above either bound; wgmma/TMA tiles are the
// later step.
//
// At D = 256 (recurrentgemma's local attention: H=10, K=1, window 2048)
// the staging takes 213,760 bytes of shared memory, under the 232,448-byte
// opt-in limit, so one CTA runs on each SM, and the accumulator holds
// RPT x D/16 = 64 floats per thread.
//
// Accepts float32 and bfloat16, D in {16, 32, 64, 128, 256}, any Sq, Sk >= 1,
// causal or not, optional window (window <= 0 means none). The Python
// wrapper validates shapes, dtypes and contiguity before calling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <typename T, int D>
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

  // (B, S, H, D) layout: consecutive sequence positions are H*D (or K*D)
  // elements apart, each row of D elements is contiguous.
  const long q_stride = (long)H * D;
  const long kv_stride = (long)K * D;
  const T* qb = q + ((long)b * Sq * H + h) * D;
  const T* kb = k + ((long)b * Sk * K + kh) * D;
  const T* vb = v + ((long)b * Sk * K + kh) * D;
  T* ob = o + ((long)b * Sq * H + h) * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int qp = q0 + r;
    sQ[r * DS + c] = qp < Sq ? to_f32(qb[qp * q_stride + c]) : 0.f;
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
      const bool in = kp < Sk;
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
      ob[qp * q_stride + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int K, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, K, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Sk, int H, int K, int D, int causal,
                       int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Sk, H, K, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, K, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, K, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, K, causal, window, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, Sq, Sk, H, K, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
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
