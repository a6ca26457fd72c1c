// Kernel 6: int8 x int8 -> int32 and bf16 x bf16 -> fp32 matrix products,
// C (M, N) = A (M, K) @ B (K, N), all row-major.
//
// Replaces: scripts/int8_probe.py `part_pallas` (:127): the Mosaic int8 dot
// (pallas_call :142) and the bf16 dot (:159) at (1024, 512) @ (512, 1024),
// with which the JAX package asked whether a hand-written kernel reaches the
// matrix unit's int8 rate.  Here it asks the same of wgmma on the H100.
//
// What bounds it: at 1024x512x1024 the bytes.  The product is 1.07 GOP
// (0.54 us at 1,979 TOP/s int8, 1.09 us at 989 TFLOP/s bf16) against 1 MB
// (int8) or 2 MB (bf16) in and 4 MB out (1.5 / 1.8 us at 3.35 TB/s).  At
// 4096^3 the tensor cores: 137 GOP, 69 us int8 / 139 us bf16; its 64 MiB
// fp32 or int32 output alone is 20 us of bytes.
//
// Design: one warp-specialised block of three warpgroups per 128 x 256
// output tile.
//   - Warpgroup 0 is the producer (setmaxnreg 40): one thread keeps a
//     4-stage TMA ring of A and B k-tiles in flight, each stage guarded by a
//     full mbarrier (TMA transaction bytes) and an empty one (the 8
//     consumer warps arrive).  A stage holds 128 bytes of k: A 128 rows x
//     128 B (16 KB) and B 256 columns x 128 B (32 KB).
//   - Warpgroups 1 and 2 are consumers (setmaxnreg 232), 64 rows of the
//     tile each, the 64 x 256 fp32 or s32 accumulator in registers (128 a
//     thread).  bf16: wgmma m64n256k16, A K-major (its rows), B (K, N)
//     row-major read MN-major (4 chunks of 64 columns by 64 k-rows,
//     hopper.cuh's header), 4 steps a stage.  int8: wgmma m64n256k32 .s32.s8.s8, which
//     takes only K-major operands, so B is transposed to B^T (N, K) first
//     (transpose_int8.cu, launched by the wrapper inside the timed call;
//     the bound stays the product's), its tile 256 rows x 128 B; 4 steps a
//     stage.  Each consumer keeps one wgmma group in flight behind the
//     next stage's (wait_group 1) and frees a stage when its group is done.
//   - Epilogue: when both consumers are done the ring is free; each stages
//     its 64 x 256 accumulator through shared memory (rows of 256 + 8
//     words: conflict-free 8-byte stores) and writes it back in 16-byte
//     stores along the rows of C.
// Tails: k past K and B columns past N arrive as zeros from TMA (a bf16 B
// chunk wholly past N is not loaded: its accumulator columns are not
// stored), and the stores clip at N.  M and N are multiples of 128, K of
// 64 (int8) or 32 (bf16).
#include <type_traits>

#include "hopper.cuh"

namespace ccedit {

namespace {

using namespace hopper;

template <bool I8>
struct GemmTiles {
  static constexpr int kBM = 128, kBN = 256, kStages = 4;
  static constexpr int kBK = I8 ? 128 : 64;       // k elements a stage: 128 bytes
  static constexpr int kABytes = kBM * 128;       // A: 128 rows x 128 B
  static constexpr int kBBytes = kBN * 128;       // B: 256 columns x 128 B of k
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kPitch = kBN + 8;          // words of a staged output row
  // + 1024: the dynamic buffer is aligned up to the swizzle atom by hand
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes;
  static_assert(kBM * kPitch * 4 <= kStages * kStageBytes, "the output tile fits in the ring");
  static_assert(kSmemBytes + 128 <= 232448, "the ring does not fit in a block's shared memory");
};

template <bool I8>
__global__ void __launch_bounds__(384, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            void* __restrict__ c_, int n, int k) {
  using T = GemmTiles<I8>;
  using Acc = typename std::conditional<I8, int, float>::type;
  using Acc2 = typename std::conditional<I8, int2, float2>::type;
  constexpr int S = T::kStages;
  extern __shared__ unsigned char raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __shared__ uint64_t full[S], empty[S];

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int m0 = blockIdx.y * T::kBM, n0 = blockIdx.x * T::kBN;
  const int k_tiles = (k + T::kBK - 1) / T::kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    regs_dec<40>();
    if (tid == 0) {
      // bf16: B's 64-column chunks that hold a column of C
      const int chunks = I8 ? 0 : min(4, (n - n0 + 63) / 64);
      const uint32_t bytes = T::kABytes + (I8 ? T::kBBytes : chunks * 64 * 128);
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % S;
        if (kt >= S) mbar_wait(&empty[s], (kt / S - 1) & 1);
        mbar_expect_tx(&full[s], bytes);
        unsigned char* sa = ring + s * T::kStageBytes;
        unsigned char* sb = sa + T::kABytes;
        tma_load_2d(sa, &map_a, &full[s], kt * T::kBK, m0);
        if constexpr (I8) {
          tma_load_2d(sb, &map_b, &full[s], kt * T::kBK, n0);  // B^T rows n0 .. n0 + 255
        } else {
          for (int ch = 0; ch < chunks; ++ch)
            tma_load_2d(sb + ch * 64 * 128, &map_b, &full[s], n0 + 64 * ch, kt * T::kBK);
        }
      }
    }
    return;
  }

  // consumers: warpgroup w owns rows 64w .. 64w + 63 of the tile
  regs_inc<232>();
  const int w = wg - 1, warp = tid / 32, lane = tid % 32, t = lane & 3;
  Acc acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % S;
    mbar_wait(&full[s], (kt / S) & 1);
    const unsigned char* sa = ring + s * T::kStageBytes + w * 64 * 128;
    const unsigned char* sb = ring + s * T::kStageBytes + T::kABytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (I8) {
        WgmmaS8<256>::run(acc, desc(sa + kk * 32, 16, 1024, 1), desc(sb + kk * 32, 16, 1024, 1), 1);
      } else {
        WgmmaSS<256, 1>::run(acc, desc(sa + kk * 32, 16, 1024, 1),
                             desc(sb + kk * 2048, 64 * 128, 1024, 1), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's group is done
    fence_regs(acc);
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % S]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: both consumers are past the ring, which now holds the tile
  named_sync(1, 256);
  Acc* st = reinterpret_cast<Acc*>(ring) + 64 * w * T::kPitch;
  const int r0 = 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = 8 * j + 2 * t;
    Acc2 v0, v1;
    v0.x = acc[4 * j];
    v0.y = acc[4 * j + 1];
    v1.x = acc[4 * j + 2];
    v1.y = acc[4 * j + 3];
    *reinterpret_cast<Acc2*>(st + r0 * T::kPitch + col) = v0;
    *reinterpret_cast<Acc2*>(st + (r0 + 8) * T::kPitch + col) = v1;
  }
  named_sync(2 + w, 128);
  Acc* c = static_cast<Acc*>(c_) + static_cast<long long>(m0 + 64 * w) * n + n0;
  for (int i = tid; i < 64 * 64; i += 128) {
    const int r = i / 64, p = i % 64;
    if (n0 + 4 * p < n)
      *reinterpret_cast<uint4*>(c + static_cast<long long>(r) * n + 4 * p) =
          *reinterpret_cast<const uint4*>(st + r * T::kPitch + 4 * p);
  }
}

template <bool I8>
int launch_gemm(const void* a, const void* b, void* c, int m, int n, int k, cudaStream_t stream) {
  using T = GemmTiles<I8>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_kernel<I8>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const cuuint64_t esize = I8 ? 1 : 2;
  // A (M, K): boxes of 128 bytes of k by 128 rows
  const cuuint64_t a_dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m)};
  const cuuint64_t a_strides[1] = {static_cast<cuuint64_t>(k) * esize};
  const cuuint32_t a_box[2] = {static_cast<cuuint32_t>(T::kBK), T::kBM};
  // int8: B^T (N, K), boxes of 128 bytes of k by 256 rows; bf16: B (K, N),
  // boxes of 64 columns by 64 k-rows
  const cuuint64_t b_dims[2] = {static_cast<cuuint64_t>(I8 ? k : n),
                                static_cast<cuuint64_t>(I8 ? n : k)};
  const cuuint64_t b_strides[1] = {static_cast<cuuint64_t>(I8 ? k : n) * esize};
  const cuuint32_t b_box[2] = {I8 ? 128u : 64u, I8 ? 256u : 64u};
  CUtensorMap ma, mb;
  int err = tiled_map(&ma, I8, 2, a, a_dims, a_strides, a_box);
  if (err == 0) err = tiled_map(&mb, I8, 2, b, b_dims, b_strides, b_box);
  if (err != 0) return err;
  const dim3 grid((n + T::kBN - 1) / T::kBN, m / T::kBM);
  gemm_kernel<I8><<<grid, 384, T::kSmemBytes, stream>>>(ma, mb, c, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace ccedit

// C entry point: int8 != 0 takes int8 a (M, K) and b^T (N, K) (B
// transposed by ccedit_transpose_int8) and writes int32 c; else bf16 a (M,
// K), b (K, N) and fp32 c.  All row-major and contiguous; m, n multiples of
// 128, k of 64 (int8) or 32 (bf16).  Returns the launch's cudaError_t; -1
// for a shape the kernel does not take.
extern "C" int ccedit_gemm(int int8, const void* a, const void* b, void* c, int m, int n,
                           int k, void* stream) {
  using namespace ccedit;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || m % 128 || n % 128 || k % (int8 ? 64 : 32)) return -1;
  return int8 ? launch_gemm<true>(a, b, c, m, n, k, st) : launch_gemm<false>(a, b, c, m, n, k, st);
}
