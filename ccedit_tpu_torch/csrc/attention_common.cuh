// Shared device helpers for the attention kernels (sm_90a).
//
// wgmma's fp32 accumulator of a score tile holds, for g = lane / 4 and
// t = lane % 4 of each warp's 16 rows, C[g][2t..2t+1] and C[g+8][2t..2t+1]
// of every 8-column block (hopper.cuh) -- the C layout of mma.sync.m16n8k16,
// whose A fragment (16x16, row-major, 4 x b32) is
//   a0 = A[g][2t..2t+1]  a1 = A[g+8][2t..2t+1]  a2 = A[g][2t+8..2t+9]  a3 = A[g+8][2t+8..2t+9]
// (PTX ISA, "Matrix Fragments for mma.m16n8k16").  Two neighbouring 8-column
// blocks of scores therefore form one A fragment of the following P.V
// product (p_fragment), so probabilities never leave registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ccedit {

typedef __nv_bfloat16 bf16;

// a byte-addressed 16-byte store
__device__ __forceinline__ void st128b(void* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

constexpr float kLog2e = 1.4426950408889634f;  // exp(x) == exp2(x * log2(e))

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint4 ld128(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void st128(bf16* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// Strides of one (B, H, N, D) operand, in elements; the D stride is 1.
struct Strides {
  long long b, h, n;
};

// bf16 A fragment of P for keys [16j, 16j+16) from two 8-key score tiles.
__device__ __forceinline__ void p_fragment(uint32_t pa[4], const float s0[4],
                                           const float s1[4]) {
  pa[0] = pack_bf16(s0[0], s0[1]);
  pa[1] = pack_bf16(s0[2], s0[3]);
  pa[2] = pack_bf16(s1[0], s1[1]);
  pa[3] = pack_bf16(s1[2], s1[3]);
}

}  // namespace ccedit
