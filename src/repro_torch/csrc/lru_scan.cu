// RG-LRU linear scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rglru/kernel.py::lru_scan_kernel
// (body `_kernel`). Same function: h_t = a_t * h_{t-1} + b_t over
// (B, S, W) from h_0 = 0, the carry held in f32, the output in a's dtype.
//
// Design (taken from what the kernel computes, not block by block): the TPU
// kernel walks chunks of Q steps along a sequential grid axis, composes the
// affine maps inside a VMEM chunk with an associative scan and carries h in
// VMEM scratch. Here the channels are independent, so one thread owns one
// (batch row, channel w) and walks t = 0..S-1 with h in a register; no
// state crosses threads or blocks. Consecutive threads take consecutive w,
// so each step's loads and stores are coalesced rows of the (B, S, W)
// layout, read in place. The loads of a[t] and b[t] do not depend on h: the
// loop issues the next U steps' loads before it computes the current U
// steps, so up to 2U steps per thread are in flight against memory latency.
// Ragged S and W are masked (no identity padding); h stays in f32 and each
// step rounds the product and the sum separately (no fused multiply-add),
// the same arithmetic as the plain version, so in f32 the two agree to the
// bit.
//
// What bounds it on the H100: there is no matmul; the function reads a and
// b once and writes h once, 3*B*S*W elements, so the bound is bytes over
// 3.35 TB/s (11.5 us for B=1, S=2500, W=2560 in bf16). At prefill batch 1
// the grid is W/64 = 40 CTAs of 64 threads, on 40 of the 132 SMs, and each
// thread's chain of S dependent steps waits on memory latency U steps at a
// time; a chunked two-pass scan that also splits S across CTAs is the later
// step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 64;   // threads (channels) per CTA
constexpr int U = 16;    // steps whose loads are issued ahead of the compute

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(NT)
lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ y, int S, int W) {
  const int w = blockIdx.x * NT + threadIdx.x;
  if (w >= W) return;
  const long base = (long)blockIdx.y * S * W + w;
  const T* ap = a + base;
  const T* bp = b + base;
  T* yp = y + base;

  T ca[U], cb[U];                  // the U steps being computed
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const bool in = i < S;
    ca[i] = in ? ap[(long)i * W] : from_f32<T>(0.f);
    cb[i] = in ? bp[(long)i * W] : from_f32<T>(0.f);
  }
  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += U) {
    T na[U], nb[U];                // the next U steps, loaded ahead
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int t = t0 + U + i;
      const bool in = t < S;
      na[i] = in ? ap[(long)t * W] : from_f32<T>(0.f);
      nb[i] = in ? bp[(long)t * W] : from_f32<T>(0.f);
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int t = t0 + i;
      if (t < S) {
        h = __fadd_rn(__fmul_rn(to_f32(ca[i]), h), to_f32(cb[i]));
        yp[(long)t * W] = from_f32<T>(h);
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      ca[i] = na[i];
      cb[i] = nb[i];
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* y, int B, int S, int W,
                   cudaStream_t stream) {
  const dim3 grid((W + NT - 1) / NT, B);
  lru_scan_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(y),
      S, W);
  return cudaGetLastError();
}

}  // namespace

// a, b, y: (B, S, W), contiguous and of one dtype (is_bf16 = 1 for bfloat16,
// 0 for float32). Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int repro_lru_scan(const void* a, const void* b, void* y, int B,
                              int S, int W, int is_bf16, void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch<__nv_bfloat16>(a, b, y, B, S, W, s)
                                  : launch<float>(a, b, y, B, S, W, s);
  return (int)err;
}
