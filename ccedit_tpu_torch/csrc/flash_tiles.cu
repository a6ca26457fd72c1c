// Kernel 7: the tile sweep.  The simple flash-attention forward of the
// first port of kernel 3 (before kernel 3's redesign for Hopper in
// flash_attention.cu), kept as it was for the sweep: head_dim 40 (rows
// staged 48 wide, as kernel 4 pads them) over BM in {32, 64, 128} and BN in
// {32, 64, 128}, launched only by ccedit_tpu_torch/scripts/profile_blocks.py
// and chip_smoke.py's probe phase, never by the attention dispatch.
//
// Replaces: scripts/profile_blocks.py:26-39 (the stock Pallas TPU flash
// attention forward at eight swept block sizes, call :36).
//
// What bounds it on an H100: at d = 40 the exponentials (272*6144^2 exp2 at
// (34, 8, 6144, 40): 2.63 ms), then the tensor cores (1.66 ms).
//
// Design: one block of BM/16 warps per (batch*head, BM-query tile), BN keys
// per staged tile.  The output accumulator lives in shared memory as fp32
// (BM x D); each warp rescales and accumulates its own 16 rows with
// mma.sync, so no block barrier guards it.  Q (BM x DK), a K tile (BN x DK)
// and the transposed V tile (D x BN) are staged in shared memory too,
// synchronously.  Scores and probabilities stay in registers and the
// softmax is the fp32 online softmax (exp2, log2(e) folded into the scale)
// of attention_common.cuh.  It is the sweep's subject as it stands: the
// redesign's TMA ring, wgmma and register accumulators would change what
// the sweep measures.
#include "attention_common.cuh"

namespace ccedit {

namespace {

// Tile geometry: head dim D, staged DK wide (zero columns [D, DK)), BM query
// rows per block (16 per warp), BN keys per staged tile.
template <int D, int DK, int BM, int BN>
struct FlashTiles {
  static constexpr int kThreads = BM * 2;  // BM / 16 warps
  static constexpr int kLDQ = DK + 8;      // bf16 pitch of Q and K rows
  static constexpr int kLDV = BN + 8;      // bf16 pitch of V^T rows
  static constexpr int kLDO = D + 8;       // fp32 pitch of the accumulator rows
  static constexpr int kVPR = DK / 8;      // 16-byte vectors per staged row
  static constexpr size_t kSmemBytes =
      sizeof(bf16) * (BM * kLDQ + BN * kLDQ + D * kLDV) + sizeof(float) * (BM * kLDO + BM);
  static_assert(D % 8 == 0 && DK % 16 == 0 && DK >= D && DK - D < 16, "bad head-dim padding");
  static_assert(BM % 16 == 0 && BN % 16 == 0 && BM <= 128, "bad tile shape");
  static_assert(kSmemBytes <= 232448, "the tiles do not fit in a block's shared memory");
};

template <int D, int DK, int BM, int BN>
__global__ void __launch_bounds__(BM * 2)
flash_tiles_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       int heads, int n_q, int n_k, Strides sq,
                       Strides sk, Strides sv, Strides so, float scale_log2) {
  using T = FlashTiles<D, DK, BM, BN>;
  constexpr int kLDQ = T::kLDQ, kLDV = T::kLDV, kLDO = T::kLDO, kVPR = T::kVPR;
  constexpr int kThreads = T::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_k = s_q + BM * kLDQ;
  bf16* s_vt = s_k + BN * kLDQ;
  float* s_o = reinterpret_cast<float*>(s_vt + D * kLDV);
  float* s_l = s_o + BM * kLDO;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * BM;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;
  o += b * so.b + h * so.h;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < BM * kVPR; i += kThreads) {
    const int r = i / kVPR, c = i % kVPR;
    st128(s_q + r * kLDQ + c * 8,
          c < D / 8 && q0 + r < n_q ? ld128(q + (q0 + r) * sq.n + c * 8) : zero);
  }
  for (int i = tid; i < BM * kLDO; i += kThreads) s_o[i] = 0.f;

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];

  for (int k0 = 0; k0 < n_k; k0 += BN) {
    __syncthreads();  // previous tile consumed; on the first pass, Q staged
    for (int i = tid; i < BN * kVPR; i += kThreads) {
      const int r = i / kVPR, c = i % kVPR;
      uint4 kv = zero, vv = zero;
      if (c < D / 8 && k0 + r < n_k) {
        kv = ld128(k + (k0 + r) * sk.n + c * 8);
        vv = ld128(v + (k0 + r) * sv.n + c * 8);
      }
      st128(s_k + r * kLDQ + c * 8, kv);
      if (c < D / 8) {
        const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
        for (int j = 0; j < 8; ++j) s_vt[(c * 8 + j) * kLDV + r] = ve[j];
      }
    }
    __syncthreads();

    float s[BN / 8][4];
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
    const bf16* qrow = s_q + r0 * kLDQ + 2 * t;
#pragma unroll 4
    for (int kk = 0; kk < DK / 16; ++kk) {
      uint32_t qa[4];
      qa[0] = ld32(qrow + kk * 16);
      qa[1] = ld32(qrow + 8 * kLDQ + kk * 16);
      qa[2] = ld32(qrow + kk * 16 + 8);
      qa[3] = ld32(qrow + 8 * kLDQ + kk * 16 + 8);
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        const bf16* kb = s_k + (nb * 8 + g) * kLDQ + kk * 16 + 2 * t;
        mma_16816(s[nb], qa, ld32(kb), ld32(kb + 8));
      }
    }
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
      s[nb][0] *= scale_log2; s[nb][1] *= scale_log2;
      s[nb][2] *= scale_log2; s[nb][3] *= scale_log2;
    }
    online_softmax<BN / 8>(s, k0, t, n_k, m, l, corr);

    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) p_fragment(pa[j], s[2 * j], s[2 * j + 1]);

    float* orow = s_o + r0 * kLDO + 2 * t;
#pragma unroll 4
    for (int nd = 0; nd < D / 8; ++nd) {
      float2 top = *reinterpret_cast<float2*>(orow + nd * 8);
      float2 bot = *reinterpret_cast<float2*>(orow + 8 * kLDO + nd * 8);
      float c[4] = {top.x * corr[0], top.y * corr[0], bot.x * corr[1], bot.y * corr[1]};
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        const bf16* vb = s_vt + (nd * 8 + g) * kLDV + j * 16 + 2 * t;
        mma_16816(c, pa[j], ld32(vb), ld32(vb + 8));
      }
      *reinterpret_cast<float2*>(orow + nd * 8) = make_float2(c[0], c[1]);
      *reinterpret_cast<float2*>(orow + 8 * kLDO + nd * 8) = make_float2(c[2], c[3]);
    }
  }

  if (t == 0) {
    s_l[r0] = l[0];
    s_l[r0 + 8] = l[1];
  }
  __syncwarp();
  // each warp writes its own 16 rows, lanes along the columns (coalesced)
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    if (q0 + r >= n_q) break;
    const float inv = 1.f / s_l[r];
    for (int c = 2 * lane; c < D; c += 64) {
      const float2 val = *reinterpret_cast<const float2*>(s_o + r * kLDO + c);
      *reinterpret_cast<uint32_t*>(o + (q0 + r) * so.n + c) = pack_bf16(val.x * inv, val.y * inv);
    }
  }
}

template <int D, int DK, int BM, int BN>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 int batch, int heads, int n_q, int n_k, const long long* strides,
                 float scale_log2, cudaStream_t stream) {
  using T = FlashTiles<D, DK, BM, BN>;
  // above 48 KB, dynamic shared memory needs an opt-in per kernel
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_tiles_kernel<D, DK, BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  dim3 grid((n_q + BM - 1) / BM, batch * heads);
  flash_tiles_kernel<D, DK, BM, BN><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), heads, n_q, n_k, sq, sk, sv, so, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace ccedit

// Kernel 7: the tile sweep at head_dim 40, BM and BN each 32, 64 or 128.
// Returns -1 for any other head_dim or tile pair.
extern "C" int ccedit_flash_attention_tiles(
    const void* q, const void* k, const void* v, void* o, int batch, int heads, int n_q,
    int n_k, int head_dim, int bm, int bn, const long long* strides, float scale_log2,
    void* stream) {
  if (head_dim != 40) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CCEDIT_TILES(BM, BN)                                                              \
  if (bm == BM && bn == BN)                                                               \
    return ccedit::launch_flash<40, 48, BM, BN>(q, k, v, o, batch, heads, n_q, n_k,        \
                                                strides, scale_log2, st);
  CCEDIT_TILES(32, 32) CCEDIT_TILES(32, 64) CCEDIT_TILES(32, 128)
  CCEDIT_TILES(64, 32) CCEDIT_TILES(64, 64) CCEDIT_TILES(64, 128)
  CCEDIT_TILES(128, 32) CCEDIT_TILES(128, 64) CCEDIT_TILES(128, 128)
#undef CCEDIT_TILES
  return -1;
}
