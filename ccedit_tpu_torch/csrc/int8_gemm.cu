// Kernel 6: int8 x int8 -> int32 and bf16 x bf16 -> fp32 matrix products,
// C (M, N) = A (M, K) @ B (K, N), all row-major.
//
// Replaces: scripts/int8_probe.py `part_pallas` (:127): the Mosaic int8 dot
// (pallas_call :142) and the bf16 dot (:159) at (1024, 512) @ (512, 1024),
// with which the JAX package asked whether a hand-written kernel reaches the
// matrix unit's int8 rate.  Here it asks the same of mma.sync on the H100.
//
// What bounds it: at 1024x512x1024 the bytes.  The product is 1.07 GOP
// (0.54 us at 1,979 TOP/s int8, 1.09 us at 989 TFLOP/s bf16) against 1 MB
// (int8) or 2 MB (bf16) in and 4 MB out (1.5 / 1.8 us at 3.35 TB/s).  At
// 4096^3 the tensor cores: 137 GOP, 69 us int8 / 139 us bf16.
//
// Design: a 128x128 output tile per block of 8 warps (4 x 2, 32x64 each);
// k tiles of 64 bytes (64 int8, 32 bf16) in shared memory.  A's tile is
// copied as it is; B's is transposed into an n-major tile while staging, so
// it is the "col" operand of mma.sync, and the same 32-bit fragment loads
// feed m16n8k32 s8 or m16n8k16 bf16 (attention_common.cuh).  The shared row
// pitch of 80 bytes spreads a fragment load over all 32 banks.  No
// pipelining and no wgmma: a probe of mma.sync, not a tuned GEMM.
#include <stdint.h>

#include "attention_common.cuh"

namespace ccedit {

namespace {

constexpr int kTM = 128;     // output rows per block
constexpr int kTN = 128;     // output columns per block
constexpr int kKB = 64;      // bytes of a k tile row
constexpr int kP = kKB + 16; // shared row pitch, bytes
constexpr int kThreads = 256;

template <bool I8, typename AccT>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const unsigned char* __restrict__ a, const unsigned char* __restrict__ b,
            AccT* __restrict__ c, int m, int n, int k) {
  constexpr int EB = I8 ? 1 : 2;
  constexpr int BK = kKB / EB;          // k elements per tile
  constexpr int NV = 16 / EB;           // elements per 16-byte vector
  constexpr int VPRB = kTN * EB / 16;   // vectors per B tile row
  __shared__ __align__(16) unsigned char s_a[kTM * kP];
  __shared__ __align__(16) unsigned char s_b[kTN * kP];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % 4, wn = warp / 4;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;

  AccT acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int i = tid; i < kTM * (kKB / 16); i += kThreads) {
      const int r = i / (kKB / 16), cc = i % (kKB / 16);
      st128b(s_a + r * kP + cc * 16,
             ld128b(a + (static_cast<long long>(m0 + r) * k + k0) * EB + cc * 16));
    }
    // k row fastest across threads, so the transposing stores of a warp
    // land in neighbouring bytes of one n-row
    for (int i = tid; i < BK * VPRB; i += kThreads) {
      const int kr = i % BK, c0 = (i / BK) * NV;
      const uint4 vec = ld128b(b + (static_cast<long long>(k0 + kr) * n + n0 + c0) * EB);
      const unsigned char* e = reinterpret_cast<const unsigned char*>(&vec);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if constexpr (I8) {
          s_b[(c0 + j) * kP + kr] = e[j];
        } else {
          *reinterpret_cast<uint16_t*>(s_b + (c0 + j) * kP + 2 * kr) =
              reinterpret_cast<const uint16_t*>(e)[j];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kKB / 32; ++ks) {
      uint32_t fa[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const unsigned char* base = s_a + (wm * 32 + mi * 16 + g) * kP + ks * 32 + 4 * t;
        fa[mi][0] = ld32b(base);
        fa[mi][1] = ld32b(base + 8 * kP);
        fa[mi][2] = ld32b(base + 16);
        fa[mi][3] = ld32b(base + 8 * kP + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const unsigned char* bb = s_b + (wn * 64 + ni * 8 + g) * kP + ks * 32 + 4 * t;
        const uint32_t b0 = ld32b(bb), b1 = ld32b(bb + 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if constexpr (I8) {
            mma_s8_16832(acc[mi][ni], fa[mi], b0, b1);
          } else {
            mma_16816(acc[mi][ni], fa[mi], b0, b1);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const long long row = m0 + wm * 32 + mi * 16 + g;
      const int col = n0 + wn * 64 + ni * 8 + 2 * t;
      AccT* p0 = c + row * n + col;
      AccT* p1 = p0 + 8LL * n;
      p0[0] = acc[mi][ni][0];
      p0[1] = acc[mi][ni][1];
      p1[0] = acc[mi][ni][2];
      p1[1] = acc[mi][ni][3];
    }
  }
}

}  // namespace

}  // namespace ccedit

// C entry point: int8 != 0 takes int8 a, b and writes int32 c; else bf16 a,
// b and fp32 c.  All row-major and contiguous; m, n multiples of 128, k of 64
// (int8) or 32 (bf16).  Returns the launch's cudaError_t; -1 for a shape the
// kernel does not take.
extern "C" int ccedit_gemm(int int8, const void* a, const void* b, void* c, int m, int n,
                           int k, void* stream) {
  using namespace ccedit;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m % kTM || n % kTN || k % (int8 ? kKB : kKB / 2)) return -1;
  const dim3 grid(n / kTN, m / kTM);
  const unsigned char* pa = static_cast<const unsigned char*>(a);
  const unsigned char* pb = static_cast<const unsigned char*>(b);
  if (int8) {
    gemm_kernel<true, int><<<grid, kThreads, 0, st>>>(pa, pb, static_cast<int*>(c), m, n, k);
  } else {
    gemm_kernel<false, float><<<grid, kThreads, 0, st>>>(pa, pb, static_cast<float*>(c), m, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}
