// The Hopper forward of kernels 1 and 1c (spatial_attention.cu: exact,
// bf16 Q.K^T; spatial_attention_int8.cu: int8 Q.K^T), of kernel 5, the
// probes of kernel 1's phases (attention_probe.cu), and of kernel 7, the
// tile sweep (attention_tiles.cu), one template over
//   - the Q.K^T policy `QK` (below: Bf16QK, Int8QK, Bf16QKTr):
//       QK::Acc          the S accumulator's element type (float, or int for s8)
//       QK::kInt8        whether q and k are int8 (their tensor maps)
//       QK::kWidth       q's and k's row width in elements (the row policies'
//                        tensor maps' D)
//       QK::tile_bytes(rows)        shared bytes of a Q or K tile of `rows` tokens
//       QK::load<ROWS>(...)         the TMA loads of such a tile
//       QK::rows(q, w)              warpgroup w's 64 rows of the Q tile
//       QK::scores<BM, BN>(s, q, k) issues S = Q.K^T of a warpgroup's 64 rows
//                        and a BN-key tile as wgmma, without committing
//       QK::scale_log2(scalar, scales, bh)   the factor of S in the exp2
//   - the stage `ST` the work stops after (kernel 5's probes): kQKT sums the
//     raw S rows (no V is loaded), kSoftmax writes the rows' l = sum
//     exp2(s * scale_log2 - m) (no V, no P.V), kFull (the default) is
//     kernels 1 and 1c;
//   - the layout `L` of V and O: RowLayout (the default; (B, H, N, D), unit
//     d stride) or TrLayout ((B, H, D, N), unit token stride: V^T tiles are
//     K-major B operands of P.V, and each warpgroup's O^T is staged through
//     its half of the Q tile so the stores run along the tokens);
//   - the tile: BM query rows a block (64 a consumer warpgroup: 64, 128 or
//     192) and BN keys a K/V tile (16 .. 256; kernel 7 sweeps both).
// Kernels 1 and 1c instantiate the defaults (BM 128, or 192 at d = 64; BN
// 128, or 64 at d = 160), for which the stage's, the layout's and the
// tile's branches compile away; at d = 64 also BM 128, taken where the
// 192-row grid would leave SMs idle (d64_query_tile).
//
// Design (FlashAttention-3's shape): one block of three warpgroups per
// (batch*head, 128-query tile) at the default tile.
//   - Warpgroup 0 is the producer.  It gives up registers (setmaxnreg 40)
//     and one thread issues TMA loads: Q once, then K and V tiles of BN keys
//     into a ring of kStages stages (as many as fit, at most 4), each
//     guarded by a full mbarrier (TMA transaction bytes) and an empty one
//     (every consumer warp arrives).  Tile j + 1 .. j + kStages - 2 load
//     while tile j is multiplied.
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
//     barriers 1 .. kConsumers, round robin).  In its turn a warpgroup
//     issues P.V of tile j - 1 and Q.K^T of tile j as one wgmma group, then
//     hands the turn to the next and waits for its products; its softmax of
//     tile j then runs while the others' products occupy the tensor cores.
//     At d = 40, where the exponentials are the bound, they overlap the
//     products instead of following them.  One consumer (BM 64) has no
//     turns: its softmax follows its products.
//
// Tiles and budgets.  BM = 128: two warpgroups of 64 rows.  Kernel 7's
// sweep of this template on an H100 at (34, 8, 6144, 40) (PERF.md section
// 7) found one consumer without turns 1.75-1.80x slower, BM mattering more
// than BN, and three consumers at BN 128 (192, 128) 7 % faster than this
// default, whose K/V tiles then feed 192 query rows instead of 128.  A
// bf16 head is ceil(D / 64) 128-byte chunks, an int8 one (40 -> 48, 80 ->
// 80 bytes) one chunk (hopper.cuh); the contraction runs over the row
// rounded up to the step (bf16 40 -> 48, s8 40 -> 64, 80 -> 96: the TMA
// box's zero columns are the pad) and P.V writes exactly D columns (m64n40
// reads the first 40 of a swizzled 64-column chunk).  Shared memory: Q 128
// x chunks x 128 B, a stage K + V = BN x (QK chunks + V chunks) x 128 B:
//   bf16 d = 40:  BN 128, 4 stages: 16 KB + 4 x 32 KB = 144 KB
//   bf16 d = 80:  BN 128, 3 stages: 32 KB + 3 x 64 KB = 224 KB (of 227)
//   bf16 d = 160: BN 64,  3 stages: 48 KB + 3 x 48 KB = 192 KB
//   s8 d = 40:    BN 128, 4 stages: 16 KB + 4 x 32 KB = 144 KB
//   s8 d = 80:    BN 128, 4 stages: 16 KB + 4 x 48 KB = 208 KB
//   bf16 and s8 d = 64: BN 128, 4 stages: 24 KB + 4 x 32 KB = 152 KB at BM
//     192, 16 KB + 4 x 32 KB = 144 KB at BM 128 (a row is exactly one
//     128-byte chunk: the TMA box's natural width)
//   kernel 5, d = 40, 4 stages: qkt and softmax 16 KB + 4 x 16 KB (K only);
//     tr bf16 Q 2 x 48 x 128 B = 12 KB, a stage K 12 KB + V^T 2 x 40 x 128
//     B = 10 KB (qkt 12 + 4 x 12 KB, full 12 + 4 x 22 KB)
//   kernel 7, bf16 d = 40: Q BM x 128 B, a stage 2 x BN x 128 B; 4 stages
//     at BN 64 and 128, 3 at BN 256
// Registers of a consumer thread: S BN/2 (64 at BN = 128), P BN/4 (32), O
// D/2 (20 / 40 / 80).  ptxas compiles the whole kernel within 65536 /
// threads (168 at 384 threads, 128 at 512, 255 at 256) whatever setmaxnreg
// grants later, so setmaxnreg (40 / 232) is kept only for kernel 1's two
// consumers (kernel 7's kept pairs and their registers: attention_tiles.cu).
// One block an SM; (34, 8, 6144, 40) is 48 x 272 blocks at BM 128.
//
// Head dim 64 (SD-2.x's heads; kernels 1, 1c and kernel 5's d = 64 probes;
// PERF.md section 6).  The two bounds are equal: at (2, 5, 9216, 64) the
// products take 0.220 ms at 989 TFLOP/s and the exponentials 0.218 ms at
// ~3.9 T/s.  Kernel 5's split of the 128-row design on an H100 (0.727 ms):
// Q.K^T alone 0.195 ms (56 % of its bound), the softmax +0.272, P.V +0.256.
// Neither unit is the ceiling: the same kernel without its exponentials
// (scripts/d64_compare.py's no_exp2) is no faster; moving a share of them
// to a polynomial on the FMA pipe, or issuing Q.K^T of tile j ahead of P.V
// of tile j - 1, made it slower, and packing P to bf16 on the integer pipe
// gained nothing.  What helped, and is the design:
//   - BM 192, three consumer warpgroups taking turns round robin (kernel
//     7's finding at d = 40): a K/V tile feeds 192 query rows, and while one
//     warpgroup runs its softmax two queue products.  At 512 threads ptxas
//     compiles within 128 registers; S 64 + P 32 + O 32 fit without spills
//     (ptxas: 128 registers, 0 bytes spilled; kernel 1c 127).  Where the
//     192-row grid leaves SMs without a block (SD-2.1-768's 576-token
//     level: 120 blocks), the 128-row tile, whose 200 blocks ran faster.
//   - O and l rescaled only where a row's max grows more than kLazy = 8
//     (a factor 2^8) past the m its probabilities are taken against, the
//     warp's 16 rows deciding together (one vote): P <= 2^8 stays exact in
//     bf16 and fp32, and O / l is exact after the final division.  Kernel
//     5's softmax probe rescales its row sums to the true max at the end.
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

enum Stage { kQKT = 0, kSoftmax = 1, kFull = 2 };

struct RowLayout {
  static constexpr bool kTr = false;

  // O += P.V, P from registers, V an MN-major B read in its row-major layout
  template <int D, int BN>
  static __device__ __forceinline__ void pv(float (&acc)[D / 2], const uint32_t (&pa)[BN / 16][4],
                                            const unsigned char* sv) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      WgmmaRS<D, 1>::run(acc, pa[kk], desc(sv + kk * 2048, BN * 128, 1024, 1), 1);
  }
};

struct TrLayout {
  static constexpr bool kTr = true;

  // O += P.V with V^T's tile K-major (the keys along its 128-byte rows):
  // chunk kk / 4 of 64 keys, 32-byte step kk % 4 within it
  template <int D, int BN>
  static __device__ __forceinline__ void pv(float (&acc)[D / 2], const uint32_t (&pa)[BN / 16][4],
                                            const unsigned char* sv) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      WgmmaRS<D, 0>::run(acc, pa[kk], desc(sv + (kk / 4) * D * 128 + (kk % 4) * 32, 16, 1024, 1), 1);
  }
};

// Q.K^T in bf16 over (B, H, N, D) rows: m64nBNk16 steps over D rounded up to
// 16, chunk kk / 4 and 32-byte step kk % 4 within it; the scalar scale.
template <int D>
struct Bf16QK {
  using Acc = float;
  static constexpr bool kInt8 = false;
  static constexpr int kChunks = (D + 63) / 64;
  static constexpr int kWidth = D;

  static constexpr int tile_bytes(int rows) { return rows * kChunks * 128; }

  template <int ROWS>
  static __device__ __forceinline__ void load(unsigned char* dst, const CUtensorMap* map,
                                              bool inner, uint64_t* bar, int h, int n0, int b) {
    for (int c = 0; c < kChunks; ++c) load_chunk(dst + c * ROWS * 128, map, inner, bar, c, h, n0, b);
  }

  static __device__ __forceinline__ const unsigned char* rows(const unsigned char* q, int w) {
    return q + w * 64 * 128;
  }

  template <int BM, int BN>
  static __device__ __forceinline__ void scores(float (&s)[BN / 2], const unsigned char* q,
                                                const unsigned char* k) {
#pragma unroll
    for (int kk = 0; kk < (D + 15) / 16; ++kk)
      WgmmaSS<BN, 0>::run(s, desc(q + (kk / 4) * BM * 128 + (kk % 4) * 32, 16, 1024, 1),
                          desc(k + (kk / 4) * BN * 128 + (kk % 4) * 32, 16, 1024, 1), kk > 0);
  }

  static __device__ __forceinline__ float scale_log2(float scalar, const float*, int) {
    return scalar;
  }
};

// Q.K^T in int8 (kernel 1c, kernel 5's tr int8 probes): q8 and k8 are
// contiguous int8 (B, H, N, DK) rows, DK = D rounded up to 16 bytes (40 ->
// 48, 80 -> 80) with zero columns past D, loaded as one 128-byte-swizzled
// chunk a row (the box's columns past DK arrive as zeros); S = Q.K^T is
// wgmma m64n128k32 .s32.s8.s8 over D rounded up to 32 bytes (2 steps at d =
// 40, 3 at d = 80).  The exp2's factor is each (batch, head)'s folded scale
// scales[b*h] times log2(e) (kernel 1c), or, with kScalar, the scalar
// (kernel 5: one per-tensor scale each for q and k, folded by the caller).
template <int D, bool kScalar = false>
struct Int8QK {
  using Acc = int;
  static constexpr bool kInt8 = true;
  static constexpr int kWidth = (D + 15) / 16 * 16;
  static_assert(kWidth <= 128, "an int8 row is one 128-byte chunk");

  static constexpr int tile_bytes(int rows) { return rows * 128; }

  template <int ROWS>
  static __device__ __forceinline__ void load(unsigned char* dst, const CUtensorMap* map,
                                              bool inner, uint64_t* bar, int h, int n0, int b) {
    load_chunk(dst, map, inner, bar, 0, h, n0, b);
  }

  static __device__ __forceinline__ const unsigned char* rows(const unsigned char* q, int w) {
    return q + w * 64 * 128;
  }

  template <int BM, int BN>
  static __device__ __forceinline__ void scores(int (&s)[BN / 2], const unsigned char* q,
                                                const unsigned char* k) {
    static_assert(BN == 128, "the s8 product is m64n128k32");
#pragma unroll
    for (int kk = 0; kk < (D + 31) / 32; ++kk)
      WgmmaS8<128>::run(s, desc(q + kk * 32, 16, 1024, 1), desc(k + kk * 32, 16, 1024, 1),
                        kk > 0);
  }

  static __device__ __forceinline__ float scale_log2(float scalar, const float* scales, int bh) {
    if constexpr (kScalar) return scalar;
    return scales[bh] * kLog2e;
  }
};

// Q.K^T in bf16 over (B, H, D, N) operands, tokens innermost (kernel 5's tr
// probes): a tile is chunks of 64 tokens by kRows d-rows (40 -> 48, the rows
// past D zero-filled by TMA), so Q^T and K^T are both MN-major and S is
// m64nBNk16 with the transpose bits set (hopper.cuh's header), 16 d-rows a
// step; the scalar scale.
template <int D>
struct Bf16QKTr {
  using Acc = float;
  static constexpr bool kInt8 = false;
  static constexpr int kRows = (D + 15) / 16 * 16;

  static constexpr int tile_bytes(int rows) { return rows / 64 * kRows * 128; }

  template <int ROWS>
  static __device__ __forceinline__ void load(unsigned char* dst, const CUtensorMap* map, bool,
                                              uint64_t* bar, int h, int n0, int b) {
    static_assert(ROWS % 64 == 0, "a tile is whole 64-token chunks");
    for (int c = 0; c < ROWS / 64; ++c) tma_load_4d(dst + c * kRows * 128, map, bar, n0 + 64 * c, 0, h, b);
  }

  static __device__ __forceinline__ const unsigned char* rows(const unsigned char* q, int w) {
    return q + w * kRows * 128;
  }

  template <int BM, int BN>
  static __device__ __forceinline__ void scores(float (&s)[BN / 2], const unsigned char* q,
                                                const unsigned char* k) {
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk)
      WgmmaSS<BN, 1, 1>::run(s, desc(q + kk * 2048, kRows * 128, 1024, 1),
                             desc(k + kk * 2048, kRows * 128, 1024, 1), kk > 0);
  }

  static __device__ __forceinline__ float scale_log2(float scalar, const float*, int) {
    return scalar;
  }
};

// kernel 1's query and key tiles at head dim D
constexpr int default_bm(int d) { return d == 64 ? 192 : 128; }
constexpr int default_bn(int d) { return d > 128 ? 64 : 128; }

// The query tile of kernels 1 and 1c at head dim 64: 192 rows (three
// consumers) where that grid still gives every SM a block, else 128 (at
// SD-2.1-768's level 2, (2, 20, 576, 64), 120 blocks of 192 rows leave 12
// SMs idle and ran slower than 200 of 128).
inline int d64_query_tile(int n_q, int batch_heads) {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return static_cast<long long>(n_q + 191) / 192 * batch_heads >= sms ? 192 : 128;
}

template <int D, class QK, int ST = kFull, class L = RowLayout, int BM = default_bm(D),
          int BN = default_bn(D)>
struct SpatialTiles {
  static constexpr int kVChunks = (D + 63) / 64;  // 128-byte chunks of a V row
  static constexpr int kBM = BM;
  static constexpr int kBN = BN;
  static constexpr int kConsumers = BM / 64;      // consumer warpgroups of 64 rows
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kQBytes = QK::tile_bytes(kBM);
  static constexpr int kKBytes = QK::tile_bytes(kBN);  // K of one stage
  // V of one stage (none before the full stage); a V^T tile is kBN / 64
  // chunks of D d-rows
  static constexpr int kVBytes = ST != kFull ? 0 : L::kTr ? kBN / 64 * D * 128 : kBN * kVChunks * 128;
  static constexpr int kStageBytes = kKBytes + kVBytes;
  // the ring: as many stages as fit beside Q and the barriers, at most 4;
  // + 1024: the dynamic buffer is aligned up to the swizzle atom by hand
  static constexpr int kFit = (232448 - 64 - 1024 - kQBytes) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSmemBytes = 1024 + kQBytes + kStages * kStageBytes;
  static constexpr int kPitchTr = 144;  // bytes of a staged O^T row: 64 tokens + 16, conflict-free
  // head_dim 64 (kernels 1, 1c and 5 at d = 64; the header's "Head dim
  // 64"): O and l are rescaled only where a row's max grows more than kLazy
  // past the m its probabilities are taken against
  static constexpr bool kD64 = D == 64 && !L::kTr;
  static constexpr float kLazy = 8.f;
  static_assert(D % 8 == 0 && D <= 256, "P.V writes D columns in blocks of 8, at most 256");
  static_assert(BM % 64 == 0 && BM >= 64 && BM <= 192, "one to three consumers of 64 rows");
  static_assert(BN % 16 == 0 && BN >= 16 && BN <= 256, "a key tile is wgmma's N");
  static_assert(kStages >= 2, "the tiles do not fit in a block's shared memory");
  static_assert(!L::kTr || (D * kPitchTr <= kQBytes / kConsumers && kBN % 64 == 0),
                "a warpgroup's O^T is staged in its share of the Q tile");
};

constexpr int kTurn = 1;  // named barriers kTurn + w: warpgroup w's turn at the tensor cores

template <int D, class QK, int ST = kFull, class L = RowLayout, int BM = default_bm(D),
          int BN = default_bn(D)>
__global__ void __launch_bounds__(SpatialTiles<D, QK, ST, L, BM, BN>::kThreads, 1)
spatial_attention_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v, int tokens_inner,
                         bf16* __restrict__ o, float* __restrict__ lse,
                         const float* __restrict__ scales, int heads, int n_q, int n_k,
                         Strides so, float scale_log2) {
  using T = SpatialTiles<D, QK, ST, L, BM, BN>;
  constexpr int S = T::kStages, NS = BN / 2, NC = T::kConsumers;
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
      mbar_init(&empty[s], 4 * NC);  // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    if constexpr (NC == 2) regs_dec<40>();
    if (tid == 0) {
      const bool iq = tokens_inner & 1, ik = tokens_inner & 2, iv = tokens_inner & 4;
      mbar_expect_tx(&q_full, T::kQBytes);
      QK::template load<BM>(s_q, &map_q, iq, &q_full, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S;
        if (j >= S) mbar_wait(&empty[s], (j / S - 1) & 1);
        mbar_expect_tx(&full[s], T::kStageBytes);
        unsigned char* sk = s_kv + s * T::kStageBytes;
        QK::template load<BN>(sk, &map_k, ik, &full[s], h, j * BN, b);
        if constexpr (ST == kFull) {
          if constexpr (L::kTr) {  // V^T: chunks of 64 keys by D d-rows
            for (int c = 0; c < BN / 64; ++c)
              tma_load_4d(sk + T::kKBytes + c * D * 128, &map_v, &full[s], j * BN + 64 * c, 0, h, b);
          } else {
            for (int c = 0; c < T::kVChunks; ++c)
              load_chunk(sk + T::kKBytes + c * BN * 128, &map_v, iv, &full[s], c, h, j * BN, b);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup w owns query rows 64w .. 64w + 63 of the tile
  if constexpr (NC == 2) regs_inc<232>();
  const int w = wg - 1, warp = tid / 32, lane = tid % 32, t = lane & 3;
  const int next = NC == 2 ? 1 - w : (w + 1) % NC;  // who takes the turn after w
  const unsigned char* q_w = QK::rows(s_q, w);
  const float sl2 = QK::scale_log2(scale_log2, scales, bh);
  float acc[D / 2], sc[NS];
  typename QK::Acc si[NS];
  uint32_t pa[BN / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g and g + 8
  [[maybe_unused]] float mr0 = -INFINITY, mr1 = -INFINITY;  // kD64 kSoftmax: the rows' true max

  mbar_wait(&q_full, 0);
  if constexpr (NC > 1)
    if (w == NC - 1) named_arrive(kTurn, 256);  // warpgroup 0 takes the first turn
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % S;
    mbar_wait(&full[s], (j / S) & 1);
    const unsigned char* sk = s_kv + s * T::kStageBytes;
    if constexpr (NC > 1) named_sync(kTurn + w, 256);
    if constexpr (ST == kFull) fence_regs(acc);
    wgmma_fence();
    if constexpr (ST == kFull) {
      if (j > 0) {  // O += P.V of the previous tile
        const unsigned char* sv = s_kv + ((j - 1) % S) * T::kStageBytes + T::kKBytes;
        L::template pv<D, BN>(acc, pa, sv);
      }
    }
    QK::template scores<BM, BN>(si, q_w, sk);
    wgmma_commit();
    if constexpr (NC > 1)
      if (!(w == NC - 1 && j == n_tiles - 1)) named_arrive(kTurn + next, 256);  // the next turn
    wgmma_wait<0>();
    fence_regs(si);
    if constexpr (ST == kFull) {
      fence_regs(acc);
      if (j > 0 && lane == 0) mbar_arrive(&empty[(j - 1) % S]);  // its K and V are consumed
    } else if (lane == 0) {
      mbar_arrive(&empty[s]);  // no V: the K tile is consumed
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = static_cast<float>(si[i]);

    if constexpr (ST == kQKT) {  // this thread's share of the raw row sums (keys past n_k are 0)
#pragma unroll
      for (int i = 0; i < NS; i += 4) {
        l0 += sc[i] + sc[i + 1];
        l1 += sc[i + 2] + sc[i + 3];
      }
      continue;
    }

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
    if constexpr (T::kD64) {
      // every tile holds a valid key, so the tile's maxima are finite; the
      // warp rescales (all 16 of its rows) only where one of its rows' max
      // grows kLazy past m, so p = 2^(s - m) <= 2^kLazy and O / l is exact
      const float mt0 = mx0 * sl2, mt1 = mx1 * sl2;
      if constexpr (ST == kSoftmax) {  // the probe's row sums are against the true max
        mr0 = fmaxf(mr0, mt0);
        mr1 = fmaxf(mr1, mt1);
      }
      if (__any_sync(0xffffffffu, mt0 > m0 + T::kLazy || mt1 > m1 + T::kLazy)) {
        const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
        const float corr0 = ex2(m0 - mn0), corr1 = ex2(m1 - mn1);  // 0 on the first tile
        m0 = mn0;
        m1 = mn1;
        l0 *= corr0;
        l1 *= corr1;
        if constexpr (ST == kFull) {
#pragma unroll
          for (int i = 0; i < D / 2; i += 4) {
            acc[i] *= corr0;
            acc[i + 1] *= corr0;
            acc[i + 2] *= corr1;
            acc[i + 3] *= corr1;
          }
        }
      }
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < NS; i += 4) {
        sc[i] = ex2(fmaf(sc[i], sl2, -m0));
        sc[i + 1] = ex2(fmaf(sc[i + 1], sl2, -m0));
        sc[i + 2] = ex2(fmaf(sc[i + 2], sl2, -m1));
        sc[i + 3] = ex2(fmaf(sc[i + 3], sl2, -m1));
        rs0 += sc[i] + sc[i + 1];
        rs1 += sc[i + 2] + sc[i + 3];
      }
      l0 += rs0;  // this thread's share of the row sum
      l1 += rs1;
      if constexpr (ST == kFull) {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) p_fragment(pa[kk], sc + 8 * kk, sc + 8 * kk + 4);
      }
    } else {
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
      if constexpr (ST == kFull) {
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
    }
  }
  if constexpr (ST == kFull) {  // O += P.V of the last tile
    const unsigned char* sv = s_kv + ((n_tiles - 1) % S) * T::kStageBytes + T::kKBytes;
    fence_regs(acc);
    wgmma_fence();
    L::template pv<D, BN>(acc, pa, sv);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if constexpr (ST != kFull) {  // the probes' row sums, to lse[b*h, row]
    if constexpr (T::kD64 && ST == kSoftmax) {  // against the true max, not the lazy m
      l0 *= ex2(m0 - mr0);
      l1 *= ex2(m1 - mr1);
    }
    const int row0 = q0 + 64 * w + 16 * warp + lane / 4, row1 = row0 + 8;
    if (t == 0) {
      float* rows = lse + static_cast<long long>(bh) * n_q;
      if (row0 < n_q) rows[row0] = l0;
      if (row1 < n_q) rows[row1] = l1;
    }
    return;
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row0 = q0 + 64 * w + 16 * warp + lane / 4, row1 = row0 + 8;
  o += b * so.b + h * so.h;
  if constexpr (L::kTr) {
    // O^T through this warpgroup's half of the Q tile (its last Q.K^T is
    // done): [d][64 tokens] at kPitchTr bytes a d-row, then 16-byte stores
    // along the tokens of each d-row (so.n is the d-row stride here)
    unsigned char* ot = const_cast<unsigned char*>(q_w);
    const int r0 = 2 * (16 * warp + lane / 4), r1 = r0 + 16;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = 8 * i + 2 * t;
      *reinterpret_cast<bf16*>(ot + col * T::kPitchTr + r0) = __float2bfloat16(acc[4 * i] * inv0);
      *reinterpret_cast<bf16*>(ot + (col + 1) * T::kPitchTr + r0) =
          __float2bfloat16(acc[4 * i + 1] * inv0);
      *reinterpret_cast<bf16*>(ot + col * T::kPitchTr + r1) = __float2bfloat16(acc[4 * i + 2] * inv1);
      *reinterpret_cast<bf16*>(ot + (col + 1) * T::kPitchTr + r1) =
          __float2bfloat16(acc[4 * i + 3] * inv1);
    }
    named_sync(kTurn + NC + w, 128);
    const int tok0 = q0 + 64 * w;
    for (int i = tid; i < D * 8; i += 128) {
      const int r = i / 8, p = i % 8;
      if (tok0 + 8 * p + 8 <= n_q)
        st128(o + r * so.n + tok0 + 8 * p, ld128(reinterpret_cast<const bf16*>(ot + r * T::kPitchTr) + 8 * p));
    }
  } else {
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
  }
  if (lse != nullptr && t == 0) {  // m and l are full-row values in every lane of the quad
    float* row_lse = lse + static_cast<long long>(bh) * n_q;
    if (row0 < n_q) row_lse[row0] = m0 + log2f(l0);
    if (row1 < n_q) row_lse[row1] = m1 + log2f(l1);
  }
}

// Launch the kernel on prepared tensor maps (bit c of `tokens_inner`: map c
// of q, k, v has the tokens inside the heads, load_chunk's flag).  `lse`
// takes kernel 1's log-sum-exp (null: none) or, before the full stage, the
// probes' (B*H, n_q) row sums.
template <int D, class QK, int ST = kFull, class L = RowLayout, int BM = default_bm(D),
          int BN = default_bn(D)>
int launch_kernel(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                  int tokens_inner, void* o, float* lse, const float* scales, int batch,
                  int heads, int n_q, int n_k, Strides so, float scale_log2, cudaStream_t stream) {
  using T = SpatialTiles<D, QK, ST, L, BM, BN>;
  if (n_q <= 0 || n_k <= 0) return -1;  // the loop needs a key tile, the grid a row tile
  // above 48 KB, dynamic shared memory needs an opt-in per kernel
  static const cudaError_t attr =
      cudaFuncSetAttribute(spatial_attention_kernel<D, QK, ST, L, BM, BN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((n_q + T::kBM - 1) / T::kBM, batch * heads);
  spatial_attention_kernel<D, QK, ST, L, BM, BN><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      mq, mk, mv, tokens_inner, static_cast<bf16*>(o), lse, scales, heads, n_q, n_k, so,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// Launch the kernel over (B, H, N, D) operands: q and k of QK's type (row
// width QK::kWidth), bf16 v and o.  Strides are in elements of each
// operand.  `scales` is read by QK::scale_log2 (kernel 1c's per-(b, h)
// folded scales; null for kernel 1).  BM and BN: the tile (kernel 7's sweep).
template <int D, class QK, int BM = default_bm(D), int BN = default_bn(D)>
int launch_spatial(const void* q, const void* k, const void* v, void* o, float* lse,
                   const float* scales, int batch, int heads, int n_q, int n_k, Strides sq,
                   Strides sk, Strides sv, Strides so, float scale_log2, cudaStream_t stream) {
  using T = SpatialTiles<D, QK, kFull, RowLayout, BM, BN>;
  if (n_q <= 0 || n_k <= 0) return -1;
  // the descriptors hold the data pointers, so they are built per launch
  CUtensorMap mq, mk, mv;
  bool iq, ik, iv;
  int err = tensor_map(&mq, &iq, q, batch, heads, n_q, QK::kWidth, sq, T::kBM, QK::kInt8);
  if (err == 0) err = tensor_map(&mk, &ik, k, batch, heads, n_k, QK::kWidth, sk, T::kBN, QK::kInt8);
  if (err == 0) err = tensor_map(&mv, &iv, v, batch, heads, n_k, D, sv, T::kBN);
  if (err != 0) return err;
  return launch_kernel<D, QK, kFull, RowLayout, BM, BN>(
      mq, mk, mv, (iq ? 1 : 0) | (ik ? 2 : 0) | (iv ? 4 : 0), o, lse, scales, batch, heads, n_q,
      n_k, so, scale_log2, stream);
}

}  // namespace

}  // namespace ccedit
