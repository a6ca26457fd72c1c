// Kernel 3: flash-attention forward for the VAE's mid-block attention: one
// head, head_dim 512; 6144 tokens per frame at 512x768, 1024 at the VAE
// fine-tune's 256x256.  With a non-null `lse` it also writes each row's
// log-sum-exp for the backward (flash_attention_bwd.cu).  Redesigned for
// Hopper.
//
// Replaces: the stock Pallas TPU flash_attention forward
// (jax.experimental.pallas.ops.tpu.flash_attention), called from
// ccedit_tpu/ops/attention.py `_flash_diff` :203 (call :209).
//
// What bounds it on an H100: the tensor cores.  (17, 1, 6144, 512) is
// 17*6144^2*512*4 = 1.31 TFLOP (1.33 ms at 989 TFLOP/s) against 0.43 GB of
// q/k/v/out (0.13 ms) and 17*6144^2 = 6.4e8 exp2 (0.16 ms).
//
// Design: one block of two warpgroups (256 threads) per (batch*head,
// 64-query tile), one block an SM.
//   - The 64 x 512 fp32 output accumulator lives in registers, split by
//     columns: warpgroup w owns columns 256w .. 256w + 255, 128 fp32 a
//     thread (the whole tile would be 256, too many).
//   - S = Q.K^T over the full 512-deep contraction is computed once and
//     split by keys: warpgroup w computes the 64 x 16 scores of keys 16w ..
//     16w + 15 of a 32-key tile (wgmma m64n16k16, 32 steps, Q and K from
//     shared memory, K-major).  The two halves' row maxima meet in shared
//     memory; each warpgroup writes its half of bf16 P (64 x 32, 4 KB)
//     there, and both read all of P for O += P.V (wgmma m64n256k16, P from
//     shared memory, V as an MN-major B in its row-major layout: no
//     transpose).  Recomputing S in each warpgroup instead would have cost
//     half again the tensor work of the whole kernel.
//   - K and V arrive by TMA into a ring of two stages, each a full mbarrier
//     on the TMA bytes; one thread issues tile j + 2 into the stage that
//     tile j has just freed, so tile j + 1 loads while tile j is multiplied.
//   - Softmax: the fp32 online softmax of kernel 1 (exp2, log2(e) folded
//     into the scale); both warpgroups compute the same running maxima, and
//     their partial row sums add at the end.
//
// Shared memory, the crux at d = 512: Q is 64 x 512 bf16 = 64 KB; a key of
// K plus V is 2 KB, so BN = 64 would leave room for one stage only (64 +
// 128 = 192 KB), and two stages take BN = 32: 64 + 2 x 64 + 4 (P) = 196 KB
// of the 227 KB.  Registers: 128 (O) + 8 (S) a thread, under the 255 that
// 256 threads a block allow.  Grid: (12, 1, 1024, 512) is 12 x 16 = 192
// row tiles on 132 SMs (1.45 waves: the second wave holds 60 tiles, 45 %
// full; 128-row tiles would be 96 blocks in one wave, each twice as long,
// the same time); the decoder's (17, 1, 6144, 512) is 1632, 12.4 waves.
//
// What held the simple design back, and what this one does about it: 2
// warps an SM (now 8), the fp32 accumulator in shared memory read and
// written back every 32-key tile (now in registers), V transposed element
// by element (now MN-major wgmma), no copy overlapping any math (now a
// TMA ring), mma.sync (now wgmma for both products).
//
// Training: given a non-null `lse`, the kernel writes each row's fp32
// log2-domain log-sum-exp, m + log2(l) of the scores s * scale_log2, to
// lse[b*h, row], as kernel 1 does for kernel 4.
#include "hopper.cuh"

namespace ccedit {

namespace {

using namespace hopper;

struct FlashTiles512 {
  static constexpr int kD = 512, kChunks = kD / 64;
  static constexpr int kBM = 64, kBN = 32, kStages = 2;
  static constexpr int kQBytes = kBM * kChunks * 128;   // 64 KB
  static constexpr int kKVBytes = kBN * kChunks * 128;  // 32 KB, K or V of one stage
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kPBytes = kBM * kBN * 2;  // bf16 P, core-matrix layout
  static constexpr int kSmemBytes = 1024 + kQBytes + kStages * kStageBytes + kPBytes;
  static constexpr int kThreads = 256;
  static_assert(kSmemBytes + 1024 <= 232448, "the tiles do not fit in a block's shared memory");
};

__global__ void __launch_bounds__(256, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, int tokens_inner,
                       bf16* __restrict__ o, float* __restrict__ lse, int heads, int n_q,
                       int n_k, Strides so, float scale_log2) {
  using T = FlashTiles512;
  constexpr int BM = T::kBM, BN = T::kBN;
  extern __shared__ unsigned char raw[];
  unsigned char* s_q = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* s_kv = s_q + T::kQBytes;  // stage s: K at s * kStageBytes, V kKVBytes on
  unsigned char* s_p = s_kv + T::kStages * T::kStageBytes;
  __shared__ uint64_t q_full, full[T::kStages];
  __shared__ float s_max[2][BM], s_sum[2][BM];

  const int w = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * BM;
  const int n_tiles = (n_k + BN - 1) / BN;
  const bool iq = tokens_inner & 1, ik = tokens_inner & 2, iv = tokens_inner & 4;

  auto load_tile = [&](int j) {  // K and V of tile j into stage j % 2
    const int s = j % T::kStages;
    unsigned char* sk = s_kv + s * T::kStageBytes;
    mbar_expect_tx(&full[s], T::kStageBytes);
    for (int c = 0; c < T::kChunks; ++c) {
      load_chunk(sk + c * BN * 128, &map_k, ik, &full[s], c, h, j * BN, b);
      load_chunk(sk + T::kKVBytes + c * BN * 128, &map_v, iv, &full[s], c, h, j * BN, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < T::kStages; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
    mbar_expect_tx(&q_full, T::kQBytes);
    for (int c = 0; c < T::kChunks; ++c)
      load_chunk(s_q + c * BM * 128, &map_q, iq, &q_full, c, h, q0, b);
    for (int j = 0; j < T::kStages && j < n_tiles; ++j) load_tile(j);
  }
  __syncthreads();

  float acc[128], sc[8];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows r0 and r0 + 8
  const int r0 = 16 * warp + g;
  mbar_wait(&q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % T::kStages;
    mbar_wait(&full[s], (j / T::kStages) & 1);
    const unsigned char* sk = s_kv + s * T::kStageBytes + w * 16 * 128;  // this warpgroup's keys
    const unsigned char* sv = s_kv + s * T::kStageBytes + T::kKVBytes + w * 4 * BN * 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::kD / 16; ++kk)  // chunk kk / 4, 32-byte step kk % 4 within it
      WgmmaSS<16, 0>::run(sc, desc(s_q + (kk / 4) * BM * 128 + (kk % 4) * 32, 16, 1024, 1),
                          desc(sk + (kk / 4) * BN * 128 + (kk % 4) * 32, 16, 1024, 1), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    if ((j + 1) * BN > n_k) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (j * BN + 16 * w + 8 * (i / 4) + 2 * t + (i & 1) >= n_k) sc[i] = -INFINITY;
    }
    float mx0 = fmaxf(fmaxf(sc[0], sc[1]), fmaxf(sc[4], sc[5]));
    float mx1 = fmaxf(fmaxf(sc[2], sc[3]), fmaxf(sc[6], sc[7]));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    if (t == 0) {
      s_max[w][r0] = mx0;
      s_max[w][r0 + 8] = mx1;
    }
    __syncthreads();  // both halves' maxima; the previous tile's P.V is done
    mx0 = fmaxf(mx0, s_max[1 - w][r0]);
    mx1 = fmaxf(mx1, s_max[1 - w][r0 + 8]);
    // every tile holds a valid key, so the new maxima are finite
    const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
    const float corr0 = ex2(m0 - mn0), corr1 = ex2(m1 - mn1);  // 0 on the first tile
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int i = 0; i < 8; i += 4) {
      sc[i] = ex2(fmaf(sc[i], scale_log2, -mn0));
      sc[i + 1] = ex2(fmaf(sc[i + 1], scale_log2, -mn0));
      sc[i + 2] = ex2(fmaf(sc[i + 2], scale_log2, -mn1));
      sc[i + 3] = ex2(fmaf(sc[i + 3], scale_log2, -mn1));
    }
    l0 = l0 * corr0 + (sc[0] + sc[1] + sc[4] + sc[5]);  // this thread's share of the row sum
    l1 = l1 * corr1 + (sc[2] + sc[3] + sc[6] + sc[7]);
    // P[row][key] at [row / 8][key / 8][row % 8][key % 8]: keys 16w + 8i + 2t
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      unsigned char* p = s_p + (r0 / 8) * 512 + (2 * w + i) * 128 + (r0 % 8) * 16 + 4 * t;
      *reinterpret_cast<uint32_t*>(p) = pack_bf16(sc[4 * i], sc[4 * i + 1]);
      *reinterpret_cast<uint32_t*>(p + 512) = pack_bf16(sc[4 * i + 2], sc[4 * i + 3]);  // row + 8
    }
#pragma unroll
    for (int i = 0; i < 128; i += 4) {
      acc[i] *= corr0;
      acc[i + 1] *= corr0;
      acc[i + 2] *= corr1;
      acc[i + 3] *= corr1;
    }
    fence_proxy_async();
    __syncthreads();  // all of P written

    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      WgmmaSS<256, 1>::run(acc, desc(s_p + kk * 256, 128, 512, 0),
                           desc(sv + kk * 2048, BN * 128, 1024, 1), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // stage s and P are free
    if (threadIdx.x == 0 && j + T::kStages < n_tiles) load_tile(j + T::kStages);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (t == 0) {
    s_sum[w][r0] = l0;
    s_sum[w][r0 + 8] = l1;
  }
  __syncthreads();
  l0 = s_sum[0][r0] + s_sum[1][r0];
  l1 = s_sum[0][r0 + 8] + s_sum[1][r0 + 8];
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row0 = q0 + r0, row1 = row0 + 8;
  o += b * so.b + h * so.h + 256 * w;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = 8 * i + 2 * t;
    if (row0 < n_q)
      *reinterpret_cast<uint32_t*>(o + row0 * so.n + col) =
          pack_bf16(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
    if (row1 < n_q)
      *reinterpret_cast<uint32_t*>(o + row1 * so.n + col) =
          pack_bf16(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
  }
  if (lse != nullptr && w == 0 && t == 0) {
    float* row_lse = lse + static_cast<long long>(bh) * n_q;
    if (row0 < n_q) row_lse[row0] = m0 + log2f(l0);
    if (row1 < n_q) row_lse[row1] = m1 + log2f(l1);
  }
}

}  // namespace

}  // namespace ccedit

// C entry point; same conventions as ccedit_spatial_attention (`lse` null or
// a contiguous fp32 (batch * heads, n_q) buffer).  Returns -1 for a head_dim
// other than 512 or an empty n_q or n_k.
extern "C" int ccedit_flash_attention(
    const void* q, const void* k, const void* v, void* o, void* lse, int batch, int heads,
    int n_q, int n_k, int head_dim, const long long* strides, float scale_log2,
    void* stream) {
  using namespace ccedit;
  using T = FlashTiles512;
  if (head_dim != T::kD || n_q <= 0 || n_k <= 0) return -1;
  // above 48 KB, dynamic shared memory needs an opt-in per kernel
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  // the descriptors hold the data pointers, so they are built per launch
  CUtensorMap mq, mk, mv;
  bool iq, ik, iv;
  int err = hopper::tensor_map(&mq, &iq, q, batch, heads, n_q, T::kD, sq, T::kBM);
  if (err == 0) err = hopper::tensor_map(&mk, &ik, k, batch, heads, n_k, T::kD, sk, T::kBN);
  if (err == 0) err = hopper::tensor_map(&mv, &iv, v, batch, heads, n_k, T::kD, sv, T::kBN);
  if (err != 0) return err;
  dim3 grid((n_q + T::kBM - 1) / T::kBM, batch * heads);
  flash_attention_kernel<<<grid, T::kThreads, T::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, (iq ? 1 : 0) | (ik ? 2 : 0) | (iv ? 4 : 0), static_cast<bf16*>(o),
      static_cast<float*>(lse), heads, n_q, n_k, so, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
