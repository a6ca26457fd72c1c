// Shared device helpers for the attention kernels (sm_90a).
//
// The matrix products use the warp-level tensor-core instruction
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate).  Its register layouts, with
// g = lane / 4 and t = lane % 4, are (PTX ISA, "Matrix Fragments for mma.m16n8k16"):
//   A (16x16, row-major), 4 x b32:  a0 = A[g][2t..2t+1]      a1 = A[g+8][2t..2t+1]
//                                   a2 = A[g][2t+8..2t+9]    a3 = A[g+8][2t+8..2t+9]
//   B (16x8, "col"), 2 x b32:       b0 = B[2t..2t+1][g]      b1 = B[2t+8..2t+9][g]
//   C (16x8), 4 x f32:              c0,c1 = C[g][2t..2t+1]   c2,c3 = C[g+8][2t..2t+1]
// Two neighbouring 8-column C tiles of a score block therefore form one A
// fragment of the following P.V product, so probabilities never leave registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ccedit {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a byte-addressed 16-byte store
__device__ __forceinline__ void st128b(void* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

constexpr float kLog2e = 1.4426950408889634f;  // exp(x) == exp2(x * log2(e))

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// Online-softmax update for the two rows (g, g+8) that a thread holds in a
// (16 x 8*NB) score tile s[NB][4].  Scores arrive already multiplied by
// scale*log2(e); keys at or past n_valid are masked.  On return s holds the
// unnormalised probabilities exp2(s - m_new), and corr the factors by which
// the running output and row sums must be rescaled.
template <int NB>
__device__ __forceinline__ void online_softmax(float s[NB][4], int key0, int t,
                                               int n_valid, float m[2],
                                               float l[2], float corr[2]) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + nb * 8 + 2 * t + (e & 1);
      if (key >= n_valid) s[nb][e] = -INFINITY;
    }
    mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
    mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // every tile holds at least one valid key, so the new maxima are finite
  const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
  corr[0] = exp2f(m[0] - mn0);  // exp2(-inf) = 0 on the first tile
  corr[1] = exp2f(m[1] - mn1);
  m[0] = mn0;
  m[1] = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    s[nb][0] = exp2f(s[nb][0] - mn0);
    s[nb][1] = exp2f(s[nb][1] - mn0);
    s[nb][2] = exp2f(s[nb][2] - mn1);
    s[nb][3] = exp2f(s[nb][3] - mn1);
    rs0 += s[nb][0] + s[nb][1];
    rs1 += s[nb][2] + s[nb][3];
  }
  rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
  rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
  rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
  rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
  l[0] = l[0] * corr[0] + rs0;
  l[1] = l[1] * corr[1] + rs1;
}

// bf16 A fragment of P for keys [16j, 16j+16) from two 8-key score tiles.
__device__ __forceinline__ void p_fragment(uint32_t pa[4], const float s0[4],
                                           const float s1[4]) {
  pa[0] = pack_bf16(s0[0], s0[1]);
  pa[1] = pack_bf16(s0[2], s0[3]);
  pa[2] = pack_bf16(s1[0], s1[1]);
  pa[3] = pack_bf16(s1[2], s1[3]);
}

}  // namespace ccedit
