// Kernel 4: the backward of kernel 1 (exact softmax attention), dq, dk and dv
// for head_dim 40, 80 and 160 and any n_q and n_k: the UNet's spatial
// self-attention in training, (48, 8, 3072, 40) and (48, 8, 768, 80) at the
// recipe's 12 frames of 384x512, batch 4, and the CFCA's n_k = 2 * n_q.
//
// Replaces: the stock Pallas TPU flash-attention backward that
// ccedit_tpu/ops/attention.py `_xla_attention_bwd` reaches through
// `jax.vjp(flash_attention)` at kernel 1's shapes.
//
// What bounds it on an H100: the tensor cores at d 80/160, and at d = 40
// the tensor cores with the exponentials close behind.  The work is five
// products of the forward's size (S = K Q^T and dP = V dO^T recomputed,
// dV = P^T dO, dK = dS^T Q, dQ = dS K) and one exp2 a score: at
// (48, 8, 3072, 40) 1.47 ms of tensor time at 989 TFLOP/s and 0.93 ms of
// exp2 at ~3.9 T/s.  The (n_q x n_k) P and dS never reach device memory.
//
// Design (FlashAttention-3's backward, simplified): three kernels.
//   Prep: delta = rowsum(dO * O) in fp32 from the bf16 operands, written
//   with kernel 1's log2-domain lse into a buffer of n_q rows padded to the
//   query tile (padding rows: lse = +inf, so their P is exp2(-inf) = 0, and
//   delta = 0), and the fp32 dQ accumulator zeroed.
//   Main: one block per (batch*head, 128-key tile), three warpgroups.
//     - Warpgroup 0 is the producer (setmaxnreg 24).  One thread loads the
//       block's K and V once by TMA, then streams Q, dO (TMA) and the lse
//       and delta (a bulk copy) of successive 64-query tiles
//       through a ring of kStages stages, each guarded by a full mbarrier
//       (transaction bytes) and an empty one (8 consumer warps arrive).
//       Key blocks start on different query tiles, so their dQ additions
//       to one row seldom collide.
//     - Warpgroups 1 and 2 are consumers (setmaxnreg 240), 64 keys each.
//       Per query tile: S^T = K Q^T and dP^T = V dO^T on wgmma (both
//       operands from shared memory, K-major); P^T = exp2(S^T * scale_log2 -
//       lse) with keys at or past n_k masked to 0 (queries past n_q get 0
//       from their +inf lse), computed while dP^T is still on the tensor
//       cores; dS^T = P^T * (dP^T - delta), all in fp32 registers.  Then dV += P^T dO and dK += dS^T Q on wgmma with P^T
//       and dS^T as bf16 A fragments from registers (as kernel 1's P.V)
//       and dO and Q read MN-major: no transpose anywhere.  dK and dV stay
//       in fp32 registers over the whole walk.
//     - dQ = dS K needs dS with the queries as rows: each consumer writes
//       its dS^T once, bf16, to a swizzled [key][query] tile in shared
//       memory (two buffers, tile parity), which wgmma reads as an MN-major
//       A against K read MN-major.  The consumers take turns, a query tile
//       each: the one whose turn it is waits at a named barrier for the
//       other's half of dS^T, multiplies all 128 keys and adds its fp32
//       result to the dQ accumulator with vector atomics (atomicAdd on
//       float2); the other only arrives there.  So S and dP are computed
//       once: five products, not the seven of the first design's two
//       kernels.
//   Post: dq = scale * dQ_acc in bf16, in dq's own strides.
// The softmax scale multiplies dK and dQ once, at the end.  The atomics add
// in an order that changes from run to run, so dq does too, by a rounding
// of its fp32 sums (chip_smoke.py prints the difference of two calls).
//
// Tiles and budgets.  A head is ceil(D / 64) 128-byte chunks (hopper.cuh);
// S and dP contract over D rounded up to 16 (40 -> 48: the TMA box's zero
// columns are the pad), the other products write exactly D columns.
// Shared memory: K + V 2 x 128 x chunks x 128 B, a stage Q + dO 2 x 64 x
// chunks x 128 B + 512 B of lse and delta, dS^T 2 x 16 KB:
//   d = 40:  32 KB + 4 stages x 16.5 KB + 32 KB = 131 KB
//   d = 80:  64 KB + 3 stages x 32.5 KB + 32 KB = 194 KB
//   d = 160: 96 KB + 2 stages x 48.5 KB + 32 KB = 225 KB (of 227)
// Registers of a consumer thread: dK and dV D/2 fp32 each (20 / 40 / 80),
// S^T and dP^T 32 each, the bf16 P^T and dS^T fragments 16 each, dQ D/2.
// At d = 160, where dK and dV alone take 160, S^T and dP^T are computed in
// two halves of 32 queries and dQ in column pieces of 64, 64 and 32, so at
// most 208 are live.
#include "hopper.cuh"

namespace ccedit {

namespace {

using namespace hopper;

constexpr int kBM = 64;   // queries of a tile (the wrapper pads its scratch rows to it)
constexpr int kBN = 128;  // keys of a block: two consumer warpgroups of 64
constexpr int kDsBar = 1;  // named barriers kDsBar + parity: a tile's dS^T is complete

template <int D>
struct BwdTiles {
  static constexpr int kChunks = (D + 63) / 64;  // 128-byte chunks of a head
  static constexpr int kKSteps = (D + 15) / 16;  // 16-deep steps of S and dP
  static constexpr int kHalves = D > 128 ? 2 : 1;  // S and dP in query halves
  static constexpr int kStages = D <= 64 ? 4 : (D <= 128 ? 3 : 2);
  static constexpr int kKVBytes = kBN * kChunks * 128;  // K or V
  static constexpr int kQBytes = kBM * kChunks * 128;   // Q or dO of a stage
  static constexpr int kDsBytes = kBN * kBM * 2;        // dS^T, bf16 [key][query]
  static constexpr int kStatBytes = kBM * 8;            // lse and delta of a stage's queries
  // + 1024: the dynamic buffer is aligned up to the swizzle atom by hand
  static constexpr int kSmemBytes = 1024 + 2 * kKVBytes + kStages * 2 * kQBytes +
                                    2 * kDsBytes + kStages * kStatBytes;
  static constexpr int kThreads = 384;
  static_assert(D % 8 == 0 && D <= 256, "dK and dV are written in blocks of 8 columns");
  static_assert(kSmemBytes + 128 <= 232448, "the tiles do not fit in a block's shared memory");
};

// bf16 pair `val` at (row r, columns c, c + 1) of a dS^T tile: rows of 64
// queries (128 bytes), 128-byte swizzled as a TMA chunk would be
__device__ __forceinline__ void store_ds(unsigned char* ds, int r, int c, uint32_t val) {
  *reinterpret_cast<uint32_t*>(ds + r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2) = val;
}

// One column piece of dQ for the tile: dS (64 queries x 128 keys, MN-major
// from the dS^T tile) times K's N columns from chunk `kp` (MN-major), added
// to the fp32 accumulator at this thread's rows `row0` and `row0 + 8`.
template <int N>
__device__ __forceinline__ void dq_piece(const unsigned char* ds, const unsigned char* kp,
                                         float* row0, int ld) {
  float acc[N / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    WgmmaSS<N, 1, 1>::run(acc, desc(ds + kk * 2048, kBN * 128, 1024, 1),
                          desc(kp + kk * 2048, kBN * 128, 1024, 1), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    atomicAdd(reinterpret_cast<float2*>(row0 + 8 * j), make_float2(acc[4 * j], acc[4 * j + 1]));
    atomicAdd(reinterpret_cast<float2*>(row0 + 8 * ld + 8 * j),
              make_float2(acc[4 * j + 2], acc[4 * j + 3]));
  }
}

// delta = rowsum(dO * O) and the lse of every padded row, each 64-row tile's
// lse and then its deltas; the dQ accumulator's rows zeroed.  One warp a
// row, 8 rows a block.
__global__ void __launch_bounds__(256)
attention_bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, float* __restrict__ stats,
                          float* __restrict__ dq_acc, int heads, int n_q, int n_q_pad, int d,
                          Strides so, Strides sdo) {
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  float sum = 0.f;
  if (row < n_q) {
    const bf16* po = o + b * so.b + h * so.h + row * so.n;
    const bf16* pd = dout + b * sdo.b + h * sdo.h + row * sdo.n;
    for (int c = lane; c < d; c += 32) sum += __bfloat162float(po[c]) * __bfloat162float(pd[c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  const long long r = static_cast<long long>(bh) * n_q_pad + row;
  if (lane == 0) {  // tile r / kBM: its kBM lse, then its kBM deltas
    float* tile = stats + 2 * (r - r % kBM);
    tile[r % kBM] = row < n_q ? lse[static_cast<long long>(bh) * n_q + row] : INFINITY;
    tile[kBM + r % kBM] = sum;
  }
  for (int c = lane; c < d; c += 32) dq_acc[r * d + c] = 0.f;
}

// dq = scale * dQ_acc in bf16, two columns a thread.
__global__ void __launch_bounds__(256)
attention_bwd_convert_kernel(const float* __restrict__ dq_acc, bf16* __restrict__ dq, int heads,
                        int n_q, int n_q_pad, int d, Strides sdq, float scale) {
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int pairs = d / 2;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(n_q) * pairs) return;
  const int row = static_cast<int>(i / pairs), c = 2 * static_cast<int>(i % pairs);
  const float2 a = *reinterpret_cast<const float2*>(
      dq_acc + (static_cast<long long>(bh) * n_q_pad + row) * d + c);
  *reinterpret_cast<uint32_t*>(dq + b * sdq.b + h * sdq.h + row * sdq.n + c) =
      pack_bf16(a.x * scale, a.y * scale);
}

template <int D>
__global__ void __launch_bounds__(384, 1)
attention_bwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do, int tokens_inner,
                     const float* __restrict__ stats, float* __restrict__ dq_acc,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int n_q, int n_k,
                     Strides sdk, Strides sdv, float scale_log2, float scale) {
  using T = BwdTiles<D>;
  constexpr int S = T::kStages, NH = kBM / T::kHalves;
  extern __shared__ unsigned char raw[];
  unsigned char* s_k = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* s_v = s_k + T::kKVBytes;
  unsigned char* s_qdo = s_v + T::kKVBytes;  // stage s: Q at s * 2 * kQBytes, dO kQBytes on
  unsigned char* s_ds = s_qdo + S * 2 * T::kQBytes;  // dS^T of even and odd tiles
  // stage s: the tile's kBM lse, then its kBM deltas
  float* s_stats = reinterpret_cast<float*>(s_ds + 2 * T::kDsBytes);
  __shared__ uint64_t kv_full, full[S], empty[S];

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.x * kBN;
  const int n_qt = (n_q + kBM - 1) / kBM, n_q_pad = n_qt * kBM;
  const int first = blockIdx.x % n_qt;  // this key block's first query tile
  // byte offset of 16-deep step kk of query half hf in a Q or dO tile
  const auto q_off = [](int hf, int kk) {
    return (kk / 4) * kBM * 128 + hf * NH * 128 + (kk % 4) * 32;
  };
  if (threadIdx.x == 0) {
    mbar_init(&kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    regs_dec<24>();
    if (tid == 0) {
      const bool iq = tokens_inner & 1, ik = tokens_inner & 2, iv = tokens_inner & 4,
                 ido = tokens_inner & 8;
      mbar_expect_tx(&kv_full, 2 * T::kKVBytes);
      for (int c = 0; c < T::kChunks; ++c) {
        load_chunk(s_k + c * kBN * 128, &map_k, ik, &kv_full, c, h, k0, b);
        load_chunk(s_v + c * kBN * 128, &map_v, iv, &kv_full, c, h, k0, b);
      }
      for (int i = 0; i < n_qt; ++i) {
        const int s = i % S, q0 = ((first + i) % n_qt) * kBM;
        if (i >= S) mbar_wait(&empty[s], (i / S - 1) & 1);
        mbar_expect_tx(&full[s], 2 * T::kQBytes + T::kStatBytes);
        unsigned char* sq = s_qdo + s * 2 * T::kQBytes;
        for (int c = 0; c < T::kChunks; ++c) {
          load_chunk(sq + c * kBM * 128, &map_q, iq, &full[s], c, h, q0, b);
          load_chunk(sq + T::kQBytes + c * kBM * 128, &map_do, ido, &full[s], c, h, q0, b);
        }
        bulk_load(s_stats + s * 2 * kBM, stats + 2 * (static_cast<long long>(bh) * n_q_pad + q0),
                  T::kStatBytes, &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup w owns keys 64w .. 64w + 63 of the block
  regs_inc<240>();
  const int w = wg - 1, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane & 3;
  const unsigned char* k_w = s_k + w * 64 * 128;
  const unsigned char* v_w = s_v + w * 64 * 128;
  const int key = k0 + 64 * w + 16 * warp + g;  // this thread's rows of S^T: key, key + 8
  const bool valid0 = key < n_k, valid1 = key + 8 < n_k;
  float dv_acc[D / 2], dk_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dv_acc[i] = dk_acc[i] = 0.f;

  mbar_wait(&kv_full, 0);
  for (int i = 0; i < n_qt; ++i) {
    const int s = i % S, q0 = ((first + i) % n_qt) * kBM;
    mbar_wait(&full[s], (i / S) & 1);
    const unsigned char* sq = s_qdo + s * 2 * T::kQBytes;
    const unsigned char* sdo = sq + T::kQBytes;
    const float* st = s_stats + s * 2 * kBM;
    unsigned char* ds = s_ds + (i & 1) * T::kDsBytes;

    // P^T and dS^T of the tile as bf16 A fragments: pa[kk] and da[kk] hold
    // queries 16kk .. 16kk + 15
    uint32_t pa[kBM / 16][4], da[kBM / 16][4];
#pragma unroll
    for (int hf = 0; hf < T::kHalves; ++hf) {
      // S^T and dP^T as two wgmma groups: P's exponentials run while dP^T
      // is still on the tensor cores
      float sc[NH / 2], dp[NH / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::kKSteps; ++kk)  // chunk kk / 4, 32-byte step kk % 4 within it
        WgmmaSS<NH, 0>::run(sc, desc(k_w + (kk / 4) * kBN * 128 + (kk % 4) * 32, 16, 1024, 1),
                            desc(sq + q_off(hf, kk), 16, 1024, 1), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < T::kKSteps; ++kk)
        WgmmaSS<NH, 0>::run(dp, desc(v_w + (kk / 4) * kBN * 128 + (kk % 4) * 32, 16, 1024, 1),
                            desc(sdo + q_off(hf, kk), 16, 1024, 1), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
#pragma unroll
      for (int j = 0; j < NH / 8; ++j) {  // columns hf * NH + 8j + 2t, + 1
        const float2 l = *reinterpret_cast<const float2*>(st + hf * NH + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] = ((e & 2) ? valid1 : valid0)
                              ? ex2(fmaf(sc[4 * j + e], scale_log2, -((e & 1) ? l.y : l.x)))
                              : 0.f;
      }
#pragma unroll
      for (int kb = 0; kb < NH / 16; ++kb)
        p_fragment(pa[hf * NH / 16 + kb], sc + 8 * kb, sc + 8 * kb + 4);
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < NH / 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(st + kBM + hf * NH + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x));
      }
#pragma unroll
      for (int kb = 0; kb < NH / 16; ++kb)
        p_fragment(da[hf * NH / 16 + kb], dp + 8 * kb, dp + 8 * kb + 4);
    }

    // dS^T to shared memory for dQ: rows 16 warp + g (+ 8) of this
    // warpgroup's 64, columns 16kk + 2t (+ 8)
    const int r0 = 64 * w + 16 * warp + g;
#pragma unroll
    for (int kk = 0; kk < kBM / 16; ++kk) {
      store_ds(ds, r0, 16 * kk + 2 * t, da[kk][0]);
      store_ds(ds, r0 + 8, 16 * kk + 2 * t, da[kk][1]);
      store_ds(ds, r0, 16 * kk + 8 + 2 * t, da[kk][2]);
      store_ds(ds, r0 + 8, 16 * kk + 8 + 2 * t, da[kk][3]);
    }
    fence_proxy_async();

    // dV += P^T dO, dK += dS^T Q (dO and Q MN-major: the contraction runs
    // down their query rows)
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBM / 16; ++kk)
      WgmmaRS<D, 1>::run(dv_acc, pa[kk], desc(sdo + kk * 2048, kBM * 128, 1024, 1), 1);
#pragma unroll
    for (int kk = 0; kk < kBM / 16; ++kk)
      WgmmaRS<D, 1>::run(dk_acc, da[kk], desc(sq + kk * 2048, kBM * 128, 1024, 1), 1);
    wgmma_commit();
    const bool dq_turn = (i & 1) == w;
    if (dq_turn)
      named_sync(kDsBar + (i & 1), 256);  // the other warpgroup's dS^T is in
    else
      named_arrive(kDsBar + (i & 1), 256);
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage

    if (dq_turn) {  // dQ = dS K over the block's 128 keys
      float* row0 = dq_acc + (static_cast<long long>(bh) * n_q_pad + q0 + 16 * warp + g) * D + 2 * t;
      if constexpr (D > 128) {
        dq_piece<64>(ds, s_k, row0, D);
        dq_piece<64>(ds, s_k + kBN * 128, row0 + 64, D);
        dq_piece<D - 128>(ds, s_k + 2 * kBN * 128, row0 + 128, D);
      } else {
        dq_piece<D>(ds, s_k, row0, D);
      }
    }
  }

  const int row0 = key, row1 = key + 8;
  bf16* pk = dk + b * sdk.b + h * sdk.h;
  bf16* pv = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (valid0) {
      *reinterpret_cast<uint32_t*>(pv + row0 * sdv.n + col) = pack_bf16(dv_acc[4 * j], dv_acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(pk + row0 * sdk.n + col) =
          pack_bf16(dk_acc[4 * j] * scale, dk_acc[4 * j + 1] * scale);
    }
    if (valid1) {
      *reinterpret_cast<uint32_t*>(pv + row1 * sdv.n + col) =
          pack_bf16(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
      *reinterpret_cast<uint32_t*>(pk + row1 * sdk.n + col) =
          pack_bf16(dk_acc[4 * j + 2] * scale, dk_acc[4 * j + 3] * scale);
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float *stats, *dq_acc;
  bf16 *dq, *dk, *dv;
  int batch, heads, n_q, n_k;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  float scale_log2, scale;
};

template <int D>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  using T = BwdTiles<D>;
  if (a.n_q <= 0 || a.n_k <= 0) return -1;
  // above 48 KB, dynamic shared memory needs an opt-in per kernel
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // the descriptors hold the data pointers, so they are built per launch
  CUtensorMap mq, mk, mv, mdo;
  bool iq, ik, iv, ido;
  int err = tensor_map(&mq, &iq, a.q, a.batch, a.heads, a.n_q, D, a.sq, kBM);
  if (err == 0) err = tensor_map(&mk, &ik, a.k, a.batch, a.heads, a.n_k, D, a.sk, kBN);
  if (err == 0) err = tensor_map(&mv, &iv, a.v, a.batch, a.heads, a.n_k, D, a.sv, kBN);
  if (err == 0) err = tensor_map(&mdo, &ido, a.dout, a.batch, a.heads, a.n_q, D, a.sdo, kBM);
  if (err != 0) return err;
  const int bhs = a.batch * a.heads, n_q_pad = (a.n_q + kBM - 1) / kBM * kBM;
  attention_bwd_prep_kernel<<<dim3(n_q_pad / 8, bhs), 256, 0, stream>>>(
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout), a.lse, a.stats, a.dq_acc,
      a.heads, a.n_q, n_q_pad, D, a.so, a.sdo);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_bwd_kernel<D><<<dim3((a.n_k + kBN - 1) / kBN, bhs), T::kThreads, T::kSmemBytes,
                            stream>>>(
      mq, mk, mv, mdo, (iq ? 1 : 0) | (ik ? 2 : 0) | (iv ? 4 : 0) | (ido ? 8 : 0), a.stats,
      a.dq_acc, a.dk, a.dv, a.heads, a.n_q, a.n_k, a.sdk, a.sdv, a.scale_log2, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long pairs = static_cast<long long>(a.n_q) * (D / 2);
  attention_bwd_convert_kernel<<<dim3(static_cast<unsigned>((pairs + 255) / 256), bhs), 256, 0,
                            stream>>>(a.dq_acc, a.dq, a.heads, a.n_q, n_q_pad, D, a.sdq, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace ccedit

// C entry point.  Strides are the (batch, head, token) element strides of q,
// k, v, out, dout, dq, dk, dv in that order (24 values); the D stride is 1.
// `lse` is kernel 1's log2-domain row log-sum-exp, contiguous fp32
// (batch * heads, n_q).  `stats` (batch * heads, n_q_pad / 64, 2, 64: each
// 64-query tile's lse, then its deltas) and `dq_acc` (batch * heads,
// n_q_pad, head_dim) are fp32 scratch, n_q_pad being n_q rounded up to the
// 64-query tile.  Launches the prep, main and dq kernels
// on `stream`.  Returns the first cudaError_t (0 = success); -1 for a
// head_dim without an instantiation or an empty n_q or n_k.
extern "C" int ccedit_spatial_attention_bwd(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, void* stats, void* dq_acc, void* dq, void* dk, void* dv, int batch,
    int heads, int n_q, int n_k, int head_dim, const long long* strides, float scale_log2,
    float scale, void* stream) {
  using ccedit::bf16;
  using ccedit::Strides;
  ccedit::BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.stats = static_cast<float*>(stats);
  a.dq_acc = static_cast<float*>(dq_acc);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.batch = batch;
  a.heads = heads;
  a.n_q = n_q;
  a.n_k = n_k;
  Strides* s[8] = {&a.sq, &a.sk, &a.sv, &a.so, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 8; ++i) *s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.scale_log2 = scale_log2;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 40:
      return ccedit::launch_bwd<40>(a, st);
    case 80:
      return ccedit::launch_bwd<80>(a, st);
    case 160:
      return ccedit::launch_bwd<160>(a, st);
    default:
      return -1;
  }
}
