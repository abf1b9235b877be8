// Warp-level tensor-core and asynchronous-copy helpers for sm_90a, shared by
// the bf16 routes of flash_attention.cu and ssd_scan.cu (inline PTX).
//
// Fragment layouts of mma.sync.m16n8k16 (bf16 in, f32 accumulate), for lane
// l with g = l / 4 and t = l % 4:
//   A (16 x 16, row-major)  a0: (g, 2t..2t+1)   a1: (g+8, 2t..2t+1)
//                           a2: (g, 2t+8..+9)   a3: (g+8, 2t+8..+9)
//   B (16 x 8, k-major)     b0: (k 2t..2t+1, n g)   b1: (k 2t+8..+9, n g)
//   C/D (16 x 8, f32)       c0, c1: (g, 2t..2t+1)   c2, c3: (g+8, 2t..2t+1)
// So the accumulators of two neighbouring n-tiles are, packed to bf16 pairs,
// the A fragment of a k-step of 16: a softmax or a score tile feeds the next
// product straight from registers.

#pragma once

#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; when `full` is false nothing is read and the
// 16 bytes are zero-filled (ragged edges).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(Pending));
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a b, one m16n8k16 tile.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to a bf16 pair; the first goes to the low half (the
// lower column index of a fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The two-term bf16 split of an f32 pair: hi = bf16(v), lo = bf16(v - hi).
// hi + lo carries about 16 bits of v's mantissa, against 8 for hi alone.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

}  // namespace sm90
