// The Hopper forward of kernels 1 and 1c (spatial_attention.cu: exact,
// bf16 Q.K^T; spatial_attention_int8.cu: int8 Q.K^T), one template over the
// Q.K^T operand type `QK`, a policy that each source defines:
//   QK::Acc          the S accumulator's element type (float, or int for s8)
//   QK::kInt8        whether q and k are int8 (their tensor maps)
//   QK::kChunks      128-byte chunks of a Q or K row in shared memory
//   QK::kWidth       q's and k's row width in elements (the tensor maps' D)
//   QK::kStages      stages of the K/V ring
//   QK::scores<BM, BN>(s, q, k)   issues S = Q.K^T of a warpgroup's 64 rows
//                    and a BN-key tile as wgmma, without committing
//   QK::scale_log2(scalar, scales, bh)   the factor of S in the exp2
//
// Design (FlashAttention-3's shape): one block of three warpgroups per
// (batch*head, 128-query tile).
//   - Warpgroup 0 is the producer.  It gives up registers (setmaxnreg 40)
//     and one thread issues TMA loads: Q once, then K and V tiles of BN keys
//     into a ring of kStages stages, each guarded by a full mbarrier (TMA
//     transaction bytes) and an empty one (8 consumer warps arrive).  Tile
//     j + 1 .. j + kStages - 2 load while tile j is multiplied.
//   - Warpgroups 1 and 2 are consumers (setmaxnreg 232), 64 query rows
//     each.  S = Q.K^T is wgmma with Q and K from shared memory (both
//     K-major: m64nBNk16 in bf16, m64nBNk32 in s8); O += P.V is wgmma
//     m64nDk16 with P from registers (the S accumulator converted to bf16 A
//     fragments in place) and V as an MN-major B, read in its row-major
//     layout: no transpose anywhere.  The output accumulator (D/2 fp32 a
//     thread), S and P stay in registers.
//   - Softmax: the fp32 online softmax with exp2 and log2(e) folded into
//     the scale (the scale is applied inside the exp2's FMA; row maxima
//     across the quad of a row, row sums per thread until the end).  Keys
//     at or past n_k are zero-filled by TMA and masked to -inf here.  An s8
//     S converts to fp32 exactly (|S| <= 127^2 * 80 < 2^24).
//   - Ping-pong: the consumers take turns at the tensor cores (named
//     barriers 1 and 2).  In its turn a warpgroup issues P.V of tile j - 1
//     and Q.K^T of tile j as one wgmma group, then hands the turn over and
//     waits for its products; its softmax of tile j then runs while the
//     other warpgroup's products occupy the tensor cores.  At d = 40, where
//     the exponentials are the bound, they overlap the products instead of
//     following them.
//
// Tiles and budgets.  BM = 128 (two warpgroups of 64 rows; kernel 7 found
// 128-row tiles faster than 64, BM mattering more than BN).  A bf16 head is
// ceil(D / 64) 128-byte chunks, an int8 one (40 -> 48, 80 -> 80 bytes) one
// chunk (hopper.cuh); the contraction runs over the row rounded up to the
// step (bf16 40 -> 48, s8 40 -> 64, 80 -> 96: the TMA box's zero columns are
// the pad) and P.V writes exactly D columns (m64n40 reads the first 40 of a
// swizzled 64-column chunk).  Shared memory: Q 128 x chunks x 128 B, a stage
// K + V = BN x (QK chunks + V chunks) x 128 B:
//   bf16 d = 40:  BN 128, 4 stages: 16 KB + 4 x 32 KB = 144 KB
//   bf16 d = 80:  BN 128, 3 stages: 32 KB + 3 x 64 KB = 224 KB (of 227)
//   bf16 d = 160: BN 64,  3 stages: 48 KB + 3 x 48 KB = 192 KB
//   s8 d = 40:    BN 128, 4 stages: 16 KB + 4 x 32 KB = 144 KB
//   s8 d = 80:    BN 128, 4 stages: 16 KB + 4 x 48 KB = 208 KB
// Registers of a consumer thread: S BN/2 (64 at BN = 128), P BN/4 (32), O
// D/2 (20 / 40 / 80): under the 232 that setmaxnreg gives it.  One block of
// 384 threads an SM; (34, 8, 6144, 40) is 48 x 272 blocks.
//
// Training: given a non-null `lse`, the kernel also writes each row's fp32
// log-sum-exp in the log2 domain, m + log2(l) over s * scale_log2, to
// lse[b*h, row]; the backward (spatial_attention_bwd.cu) recomputes P =
// exp2(s * scale_log2 - lse) from it.
#pragma once

#include "hopper.cuh"

namespace ccedit {

namespace {

using namespace hopper;

template <int D, class QK>
struct SpatialTiles {
  static constexpr int kVChunks = (D + 63) / 64;  // 128-byte chunks of a V row
  static constexpr int kBM = 128;                 // two consumer warpgroups of 64 rows
  static constexpr int kBN = D > 128 ? 64 : 128;
  static constexpr int kStages = QK::kStages;
  static constexpr int kQBytes = kBM * QK::kChunks * 128;
  static constexpr int kKBytes = kBN * QK::kChunks * 128;  // K of one stage
  static constexpr int kVBytes = kBN * kVChunks * 128;     // V of one stage
  static constexpr int kStageBytes = kKBytes + kVBytes;
  // + 1024: the dynamic buffer is aligned up to the swizzle atom by hand
  static constexpr int kSmemBytes = 1024 + kQBytes + kStages * kStageBytes;
  static constexpr int kThreads = 384;
  static_assert(D % 8 == 0 && D <= 256, "P.V writes D columns in blocks of 8, at most 256");
  static_assert(kSmemBytes + 64 <= 232448, "the tiles do not fit in a block's shared memory");
};

constexpr int kTurn = 1;  // named barriers kTurn + w: warpgroup w's turn at the tensor cores

template <int D, class QK>
__global__ void __launch_bounds__(384, 1)
spatial_attention_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v, int tokens_inner,
                         bf16* __restrict__ o, float* __restrict__ lse,
                         const float* __restrict__ scales, int heads, int n_q, int n_k,
                         Strides so, float scale_log2) {
  using T = SpatialTiles<D, QK>;
  constexpr int BM = T::kBM, BN = T::kBN, S = T::kStages, NS = BN / 2;
  extern __shared__ unsigned char raw[];
  unsigned char* s_q = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* s_kv = s_q + T::kQBytes;  // stage s: K at s * kStageBytes, V kKBytes on
  __shared__ uint64_t q_full, full[S], empty[S];

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * BM;
  const int n_tiles = (n_k + BN - 1) / BN;
  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
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
      const bool iq = tokens_inner & 1, ik = tokens_inner & 2, iv = tokens_inner & 4;
      mbar_expect_tx(&q_full, T::kQBytes);
      for (int c = 0; c < QK::kChunks; ++c)
        load_chunk(s_q + c * BM * 128, &map_q, iq, &q_full, c, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S;
        if (j >= S) mbar_wait(&empty[s], (j / S - 1) & 1);
        mbar_expect_tx(&full[s], T::kStageBytes);
        unsigned char* sk = s_kv + s * T::kStageBytes;
        for (int c = 0; c < QK::kChunks; ++c)
          load_chunk(sk + c * BN * 128, &map_k, ik, &full[s], c, h, j * BN, b);
        for (int c = 0; c < T::kVChunks; ++c)
          load_chunk(sk + T::kKBytes + c * BN * 128, &map_v, iv, &full[s], c, h, j * BN, b);
      }
    }
    return;
  }

  // consumers: warpgroup w owns query rows 64w .. 64w + 63 of the tile
  regs_inc<232>();
  const int w = wg - 1, warp = tid / 32, lane = tid % 32, t = lane & 3;
  const unsigned char* q_w = s_q + w * 64 * 128;
  const float sl2 = QK::scale_log2(scale_log2, scales, bh);
  float acc[D / 2], sc[NS];
  typename QK::Acc si[NS];
  uint32_t pa[BN / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g and g + 8

  mbar_wait(&q_full, 0);
  if (w == 1) named_arrive(kTurn, 256);  // warpgroup 0 takes the first turn
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % S;
    mbar_wait(&full[s], (j / S) & 1);
    const unsigned char* sk = s_kv + s * T::kStageBytes;
    named_sync(kTurn + w, 256);
    fence_regs(acc);
    wgmma_fence();
    if (j > 0) {  // O += P.V of the previous tile
      const unsigned char* sv = s_kv + ((j - 1) % S) * T::kStageBytes + T::kKBytes;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        WgmmaRS<D, 1>::run(acc, pa[kk], desc(sv + kk * 2048, BN * 128, 1024, 1), 1);
    }
    QK::template scores<BM, BN>(si, q_w, sk);
    wgmma_commit();
    if (!(w == 1 && j == n_tiles - 1)) named_arrive(kTurn + 1 - w, 256);  // the other's turn
    wgmma_wait<0>();
    fence_regs(si);
    fence_regs(acc);
    if (j > 0 && lane == 0) mbar_arrive(&empty[(j - 1) % S]);  // its K and V are consumed
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = static_cast<float>(si[i]);

    // online softmax of the tile: this thread's rows g and g + 8
    if ((j + 1) * BN > n_k) {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        if (j * BN + 8 * (i / 4) + 2 * t + (i & 1) >= n_k) sc[i] = -INFINITY;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < NS; i += 4) {
      mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every tile holds a valid key, so the new maxima are finite
    const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
    const float corr0 = ex2(m0 - mn0), corr1 = ex2(m1 - mn1);  // 0 on the first tile
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < NS; i += 4) {
      sc[i] = ex2(fmaf(sc[i], sl2, -mn0));
      sc[i + 1] = ex2(fmaf(sc[i + 1], sl2, -mn0));
      sc[i + 2] = ex2(fmaf(sc[i + 2], sl2, -mn1));
      sc[i + 3] = ex2(fmaf(sc[i + 3], sl2, -mn1));
      rs0 += sc[i] + sc[i + 1];
      rs1 += sc[i + 2] + sc[i + 3];
    }
    l0 = l0 * corr0 + rs0;  // this thread's share of the row sum
    l1 = l1 * corr1 + rs1;
#pragma unroll
    for (int i = 0; i < D / 2; i += 4) {
      acc[i] *= corr0;
      acc[i + 1] *= corr0;
      acc[i + 2] *= corr1;
      acc[i + 3] *= corr1;
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) p_fragment(pa[kk], sc + 8 * kk, sc + 8 * kk + 4);
  }
  {  // O += P.V of the last tile
    const unsigned char* sv = s_kv + ((n_tiles - 1) % S) * T::kStageBytes + T::kKBytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      WgmmaRS<D, 1>::run(acc, pa[kk], desc(sv + kk * 2048, BN * 128, 1024, 1), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row0 = q0 + 64 * w + 16 * warp + lane / 4, row1 = row0 + 8;
  o += b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * t;
    if (row0 < n_q)
      *reinterpret_cast<uint32_t*>(o + row0 * so.n + col) =
          pack_bf16(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
    if (row1 < n_q)
      *reinterpret_cast<uint32_t*>(o + row1 * so.n + col) =
          pack_bf16(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
  }
  if (lse != nullptr && t == 0) {  // m and l are full-row values in every lane of the quad
    float* row_lse = lse + static_cast<long long>(bh) * n_q;
    if (row0 < n_q) row_lse[row0] = m0 + log2f(l0);
    if (row1 < n_q) row_lse[row1] = m1 + log2f(l1);
  }
}

// Launch the kernel over (B, H, N, D) operands: q and k of QK's type (row
// width QK::kWidth), bf16 v and o.  Strides are in elements of each
// operand.  `scales` is read by QK::scale_log2 (kernel 1c's per-(b, h)
// folded scales; null for kernel 1).
template <int D, class QK>
int launch_spatial(const void* q, const void* k, const void* v, void* o, float* lse,
                   const float* scales, int batch, int heads, int n_q, int n_k, Strides sq,
                   Strides sk, Strides sv, Strides so, float scale_log2, cudaStream_t stream) {
  using T = SpatialTiles<D, QK>;
  if (n_q <= 0 || n_k <= 0) return -1;  // the loop needs a key tile, the grid a row tile
  // above 48 KB, dynamic shared memory needs an opt-in per kernel
  static const cudaError_t attr =
      cudaFuncSetAttribute(spatial_attention_kernel<D, QK>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // the descriptors hold the data pointers, so they are built per launch
  CUtensorMap mq, mk, mv;
  bool iq, ik, iv;
  int err = tensor_map(&mq, &iq, q, batch, heads, n_q, QK::kWidth, sq, T::kBM, QK::kInt8);
  if (err == 0) err = tensor_map(&mk, &ik, k, batch, heads, n_k, QK::kWidth, sk, T::kBN, QK::kInt8);
  if (err == 0) err = tensor_map(&mv, &iv, v, batch, heads, n_k, D, sv, T::kBN);
  if (err != 0) return err;
  dim3 grid((n_q + T::kBM - 1) / T::kBM, batch * heads);
  spatial_attention_kernel<D, QK><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      mq, mk, mv, (iq ? 1 : 0) | (ik ? 2 : 0) | (iv ? 4 : 0), static_cast<bf16*>(o), lse,
      scales, heads, n_q, n_k, so, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace ccedit
