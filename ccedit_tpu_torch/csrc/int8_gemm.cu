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
//
// Kernel 9, the W8A8 path's dense product (ops/quant.py `gemm_dequant`),
// is a second kernel on the same tiles, ring and int8 main loop
// (`dequant_gemm_kernel`; kernel 6's instantiations are left as they
// were, instruction for instruction): C (M, N) = dequant(A8 (M, K) @ W8
// (N, K)^T), torch's (N, K) Linear weight being the K-major B^T that s8
// wgmma reads, with no transposition.  It replaces no Pallas kernel: the
// JAX package runs `int8_matmul` (ccedit_tpu/ops/quant.py:75-88) in XLA.
// What bounds it: at the UNet's widths the bytes (a 320 -> 320 layer over
// 208,896 tokens: 27 GOP, 14 us at int8 peak, against 67 MB in and 134 MB
// of bf16 out, 60 us).  Its epilogue computes, from each thread's
// accumulator registers, out = bf16(bf16(f32(acc) * sx[m] * sw[n]) +
// bias[n]) (or fp32, or the raw int32 accumulators for a debug entry), sx
// the token's scale, the products rounded one by one (__fmul_rn, no FMA
// contraction) in the order of the JAX expression; it stages the tile
// through the free ring as kernel 6 does and stores it clipped at M and N.
// Tails: any M (TMA zero-fills rows past M), any N (B^T rows past N read
// as zeros; N = 320 and 640 are not multiples of the 256-column tile), K a
// multiple of 16 (the quantizer's zero padding; TMA needs 16-byte global
// strides and zero-fills k past K).
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

// the dequant epilogue of one accumulator: bf16(f32(acc) * sx * sw), then
// + bias in bf16 (kOut 1); f32(acc) * sx * sw + bias in fp32 (kOut 2)
template <int kOut>
__device__ __forceinline__ float dequant(int acc, float sx, float sw, const void* bias, int col) {
  float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
  if constexpr (kOut == 1) {
    y = __bfloat162float(__float2bfloat16_rn(y));
    if (bias != nullptr)
      y = __bfloat162float(__float2bfloat16_rn(
          __fadd_rn(y, __bfloat162float(static_cast<const bf16*>(bias)[col]))));
  } else if (bias != nullptr) {
    y = __fadd_rn(y, static_cast<const float*>(bias)[col]);
  }
  return y;
}

// Kernel 9: kernel 6's int8 tiles and main loop with the dequant epilogue.
// kOut: 0 the int32 accumulators, 1 bf16, 2 fp32; sx: a scale a row of A.
template <int kOut>
__global__ void __launch_bounds__(384, 1)
dequant_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, void* __restrict__ c_,
                    const float* __restrict__ sx, const float* __restrict__ sw,
                    const void* __restrict__ bias, int m, int n, int k) {
  using T = GemmTiles<true>;
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
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % S;
        if (kt >= S) mbar_wait(&empty[s], (kt / S - 1) & 1);
        mbar_expect_tx(&full[s], T::kStageBytes);
        unsigned char* sa = ring + s * T::kStageBytes;
        tma_load_2d(sa, &map_a, &full[s], kt * T::kBK, m0);
        tma_load_2d(sa + T::kABytes, &map_b, &full[s], kt * T::kBK, n0);  // W8 rows n0 ..
      }
    }
    return;
  }

  // consumers: warpgroup w owns rows 64w .. 64w + 63 of the tile
  regs_inc<232>();
  const int w = wg - 1, warp = tid / 32, lane = tid % 32, t = lane & 3;
  int acc[128];
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
    for (int kk = 0; kk < 4; ++kk)
      WgmmaS8<256>::run(acc, desc(sa + kk * 32, 16, 1024, 1), desc(sb + kk * 32, 16, 1024, 1), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's group is done
    fence_regs(acc);
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % S]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: both consumers are past the ring, which now holds the tile
  named_sync(1, 256);
  float* st = reinterpret_cast<float*>(ring) + 64 * w * T::kPitch;  // int bits for kOut 0
  const int r0 = 16 * warp + lane / 4;
  const int row0 = m0 + 64 * w + r0, row1 = row0 + 8;
  const float sx0 = row0 < m ? sx[row0] : 0.f;
  const float sx1 = row1 < m ? sx[row1] : 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = 8 * j + 2 * t;
    float2 v0, v1;
    if constexpr (kOut == 0) {
      v0 = make_float2(__int_as_float(acc[4 * j]), __int_as_float(acc[4 * j + 1]));
      v1 = make_float2(__int_as_float(acc[4 * j + 2]), __int_as_float(acc[4 * j + 3]));
    } else {
      const int c0 = n0 + col, c1 = c0 + 1;
      const float w0 = c0 < n ? sw[c0] : 0.f, w1 = c1 < n ? sw[c1] : 0.f;
      const void* b0 = c0 < n ? bias : nullptr;
      const void* b1 = c1 < n ? bias : nullptr;
      v0 = make_float2(dequant<kOut>(acc[4 * j], sx0, w0, b0, c0),
                       dequant<kOut>(acc[4 * j + 1], sx0, w1, b1, c1));
      v1 = make_float2(dequant<kOut>(acc[4 * j + 2], sx1, w0, b0, c0),
                       dequant<kOut>(acc[4 * j + 3], sx1, w1, b1, c1));
    }
    *reinterpret_cast<float2*>(st + r0 * T::kPitch + col) = v0;
    *reinterpret_cast<float2*>(st + (r0 + 8) * T::kPitch + col) = v1;
  }
  named_sync(2 + w, 128);
  if constexpr (kOut == 1) {  // bf16: 8 columns a 16-byte store
    bf16* c = static_cast<bf16*>(c_);
    const bool vec = n % 8 == 0;
    for (int i = tid; i < 64 * 32; i += 128) {
      const int r = i / 32, p = i % 32, row = m0 + 64 * w + r, col = n0 + 8 * p;
      if (row >= m || col >= n) continue;
      const float* src = st + r * T::kPitch + 8 * p;
      bf16* dst = c + static_cast<long long>(row) * n + col;
      if (vec) {
        st128(dst, make_uint4(pack_bf16(src[0], src[1]), pack_bf16(src[2], src[3]),
                              pack_bf16(src[4], src[5]), pack_bf16(src[6], src[7])));
      } else {
        for (int e = 0; e < 8 && col + e < n; ++e) dst[e] = __float2bfloat16_rn(src[e]);
      }
    }
  } else {  // fp32 or int32: 4 columns a 16-byte store
    float* c = static_cast<float*>(c_);
    const bool vec = n % 4 == 0;
    for (int i = tid; i < 64 * 64; i += 128) {
      const int r = i / 64, p = i % 64, row = m0 + 64 * w + r, col = n0 + 4 * p;
      if (row >= m || col >= n) continue;
      const float* src = st + r * T::kPitch + 4 * p;
      float* dst = c + static_cast<long long>(row) * n + col;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 4 && col + e < n; ++e) dst[e] = src[e];
      }
    }
  }
}

template <int kOut>
int launch_dequant_gemm(const void* a, const void* b, void* c, const float* sx, const float* sw,
                        const void* bias, int m, int n, int k, cudaStream_t stream) {
  using T = GemmTiles<true>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      dequant_gemm_kernel<kOut>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // A8 (M, K) and W8 (N, K): boxes of 128 bytes of k by 128 and 256 rows
  const cuuint64_t a_dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m)};
  const cuuint64_t b_dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t a_box[2] = {128u, T::kBM}, b_box[2] = {128u, T::kBN};
  CUtensorMap ma, mb;
  int err = tiled_map(&ma, true, 2, a, a_dims, strides, a_box);
  if (err == 0) err = tiled_map(&mb, true, 2, b, b_dims, strides, b_box);
  if (err != 0) return err;
  const dim3 grid((n + T::kBN - 1) / T::kBN, (m + T::kBM - 1) / T::kBM);
  dequant_gemm_kernel<kOut><<<grid, 384, T::kSmemBytes, stream>>>(ma, mb, c, sx, sw, bias, m,
                                                                   n, k);
  return static_cast<int>(cudaGetLastError());
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

// Kernel 9: out (M, N) = dequant(a8 (M, K) @ w8 (N, K)^T), int8 operands
// contiguous, K a multiple of 16, any M and N.  out_kind 0 writes the int32
// accumulators, 1 bf16, 2 fp32.  sx: fp32 (M), a scale a row of a8; sw:
// fp32 (N); bias: (N) of out's type, or null (ignored for out_kind 0).
// Returns the launch's cudaError_t; -1 for arguments it does not take.
extern "C" int ccedit_int8_gemm(int out_kind, const void* a8, const void* w8, void* out,
                                const void* sx, const void* sw, const void* bias, int m,
                                int n, int k, void* stream) {
  using namespace ccedit;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || k % 16 || out_kind < 0 || out_kind > 2) return -1;
  const float* sxf = static_cast<const float*>(sx);
  const float* swf = static_cast<const float*>(sw);
  switch (out_kind) {
    case 0: return launch_dequant_gemm<0>(a8, w8, out, sxf, swf, nullptr, m, n, k, st);
    case 1: return launch_dequant_gemm<1>(a8, w8, out, sxf, swf, bias, m, n, k, st);
    default: return launch_dequant_gemm<2>(a8, w8, out, sxf, swf, bias, m, n, k, st);
  }
}
