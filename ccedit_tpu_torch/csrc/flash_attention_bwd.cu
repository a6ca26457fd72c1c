// Kernel 4 at head_dim 512: the backward of kernel 3, dq, dk and dv of the
// VAE's single-head mid-block attention in VAE training, (12, 1, 1024, 512)
// at the fine-tune's 12 images of 256x256 and (4, 1, 4096, 512) at 512x512;
// any n_q, n_k >= 1.  Redesigned for Hopper.
//
// Replaces: the stock Pallas TPU flash-attention backward that
// ccedit_tpu/ops/attention.py `_xla_attention_bwd` reaches through
// `jax.vjp(flash_attention)` at kernel 3's shapes.
//
// What bounds it on an H100: the tensor cores.  The function is five
// products of the forward's Q.K^T size (S and dP recomputed, dV = P^T dO,
// dK = dS^T Q, dQ = dS K; 64 GFLOP at (12, 1, 1024, 512): 0.065 ms at 989
// TFLOP/s) against 63 MB of q, k, v, o, dO, dq, dk, dv (0.019 ms).  The
// (n_q x n_k) P and dS never reach device memory.
//
// The crux, the accumulators at d = 512.  dK plus dV of 64 keys is 2 x 64 x
// 512 fp32 = 256 KB, the whole register file of an SM; one warpgroup's
// m64n256 fp32 accumulator is 128 registers a thread.  So no block holds
// both dK and dV of a 64-key tile (kernel 4 at d 40/80/160 does), and dQ by
// fp32 atomics, as there, would push ~100 M fp32 additions through L2 at
// (12, 1, 1024, 512), more than the whole tensor bound.  Hence three
// passes, each owning one output of 64 rows in registers, split by
// columns: warpgroup w holds columns 256w .. 256w + 255 (128 fp32 a
// thread), as kernel 3 (flash_attention.cu) holds its O.
//   dV pass, a block per 64 keys, over query tiles of 32:
//     S^T = K Q^T, P^T = exp2(S^T * scale_log2 - lse), dV += P^T dO.
//     Kernel 3's forward with the log2 lse in place of the running max.
//   dK pass, a block per 64 keys, over query tiles of 16:
//     S^T = K Q^T, dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q.
//   dQ pass, a block per 64 queries, over key tiles of 16:
//     S = Q K^T, dP = dO V^T, dS = P (dP - delta), dQ += dS K.
// 8 product units where the function has 5 (S three times, dP twice): a
// bound of 0.104 ms at (12, 1, 1024, 512).  The three passes are one launch
// (blockIdx.z picks the pass, the two 3-unit passes first), so their 3 x 192
// blocks at (12, 1, 1024, 512) fill 4.4 waves of 132 SMs where each alone
// would leave the second of 1.5 waves half empty.
//
// A block is two warpgroups (256 threads, up to 255 registers each).
//   - The 512-deep score products are wgmma m64n16k16, 32 steps, both
//     operands from shared memory, K-major: in the dV pass each warpgroup
//     computes 16 of the 32 query columns of S^T; in the dK and dQ passes
//     warpgroup 0 computes S (or S^T) and warpgroup 1 dP (or dP^T) of the
//     same 16 columns, hands dP over through shared memory (4 KB fp32), and
//     warpgroup 0 forms dS.  The scores are computed once a pass.
//   - P^T, dS^T or dS goes to shared memory as bf16 (no swizzle, 8 x 8 core
//     matrices), the A operand of the accumulating product, wgmma
//     m64n256k16 with the streamed tile as an MN-major B read in its
//     row-major layout (dO, Q or K): no transpose anywhere.
//   - The resident operands (K; K and V; Q and dO) load once by TMA; the
//     streamed pair (Q and dO, or K and V) arrives by TMA into a ring of two
//     stages, one thread issuing tile j + 2 into the stage tile j frees.
//   - lse and delta: the dV and dK passes read each query column's from
//     global memory (L1), issued before the score product's wait; the dQ
//     pass reads its rows' once.  Queries past n_q take lse = +inf (P = 0)
//     and delta = 0, and their Q and dO rows arrive as zeros; keys past n_k
//     are masked to P = 0 in the dQ pass, and in the other passes their
//     rows are never stored.
//   - The softmax scale multiplies dK and dQ once, in the epilogue.
// delta = rowsum(dO * O) comes from a prep kernel in the same call (the
// stock Pallas backward's `di`, which XLA computes): one warp a row, fp32
// sums of the bf16 operands, each read once (25 MB at (12, 1, 1024, 512),
// ~8 us at the bytes bound), in place of a torch reduction through fp32
// copies.
//
// Shared memory (+ 1 KB of alignment): the dV pass K 64 KB + 2 stages x
// (Q + dO) 2 x 32 rows x 1 KB + P^T 4 KB = 196 KB; the dK and dQ passes
// their two resident operands 128 KB + 2 stages x 2 x 16 rows x 1 KB + dS
// 2 KB + dP 4 KB = 198 KB.  One block an SM.
//
// What held the first design back, and what this one does about it:
// mma.sync on 16-row tiles with 8 warps (now wgmma m64n256 from two
// warpgroups), no copy overlapping the math (now TMA rings), S and dP each
// computed in both of its kernels (now dV needs no dP), 16-key blocks each
// streaming every query (now 64 rows a block: a quarter of the traffic).
#include "hopper.cuh"

namespace ccedit {

namespace {

using namespace hopper;

constexpr int kD = 512, kChunks = kD / 64;
constexpr int kRows = 64;     // rows (keys or queries) a block
constexpr int kStages = 2;    // of the streamed ring
constexpr int kBoxRows = 16;  // rows of a streamed TMA box
enum Pass { kDK = 0, kDQ = 1, kDV = 2 };
// the passes in launch order (blockIdx.z): the 3-unit passes first
__constant__ const int kPassOrder[] = {kDK, kDQ, kDV};
constexpr int kPasses = 3;

template <int P>
struct PassTiles {
  static constexpr int kProducts = P == kDV ? 1 : 2;  // score products: S, or S and dP
  static constexpr int kBN = P == kDV ? 32 : 16;      // streamed rows a tile
  static constexpr int kResBytes = kProducts * kRows * kChunks * 128;
  static constexpr int kTileBytes = kBN * kChunks * 128;  // one streamed operand
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kZBytes = kRows * kBN * 2;          // bf16 P^T or dS
  static constexpr int kDPBytes = kProducts == 2 ? kRows * kBN * 4 : 0;  // fp32 dP
  static constexpr int kSmemBytes = 1024 + kResBytes + kStages * kStageBytes + kZBytes + kDPBytes;
  static_assert(kSmemBytes + 64 <= 232448, "the tiles do not fit in a block's shared memory");
};

constexpr int smem_bytes() {
  return PassTiles<kDK>::kSmemBytes > PassTiles<kDV>::kSmemBytes ? PassTiles<kDK>::kSmemBytes
                                                                 : PassTiles<kDV>::kSmemBytes;
}

// q, k, v and dO as 4-D tensor maps: boxes of kRows rows (the resident
// operands) and of kBoxRows (the streamed ones)
struct Bwd512Maps {
  CUtensorMap q64, k64, v64, do64, q16, k16, v16, do16;
};

struct Bwd512Args {
  int tokens_inner;  // bit 0 q, 1 k, 2 v, 3 dO: load_chunk's flag
  const float *lse, *delta;  // (batch * heads, n_q), fp32; delta from delta_kernel
  bf16 *dq, *dk, *dv;
  int heads, n_q, n_k;
  Strides sdq, sdk, sdv;
  float scale_log2, scale;
};

// byte offset of element (r, c) of a bf16 A operand [kRows][BN] in 8 x 8
// core matrices: [r / 8][c / 8][r % 8][c % 8]
template <int BN>
__device__ __forceinline__ int z_off(int r, int c) {
  return (r / 8) * (BN / 8) * 128 + (c / 8) * 128 + (r % 8) * 16 + (c % 8) * 2;
}

template <int P>
__device__ __forceinline__ void bwd512_pass(const Bwd512Maps& m, const Bwd512Args& a,
                                            unsigned char* smem, uint64_t* res_full,
                                            uint64_t* full) {
  using T = PassTiles<P>;
  constexpr int BN = T::kBN, NP = T::kProducts;
  unsigned char* s_res = smem;  // resident operand r at r * kRows * kChunks * 128
  unsigned char* s_ring = s_res + T::kResBytes;  // stage s: streamed operands 0 and 1
  unsigned char* s_z = s_ring + kStages * T::kStageBytes;
  float* s_dp = reinterpret_cast<float*>(s_z + T::kZBytes);

  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int r0 = blockIdx.x * kRows;
  const int n_rows = P == kDQ ? a.n_q : a.n_k, n_cols = P == kDQ ? a.n_k : a.n_q;
  if (r0 >= n_rows) return;  // the grid covers the longer of n_q and n_k
  const int n_tiles = (n_cols + BN - 1) / BN;
  const int in = a.tokens_inner;
  // resident: dK K and V, dQ Q and dO, dV K; streamed: dK and dV Q and dO,
  // dQ K and V
  const CUtensorMap* res[2] = {P == kDQ ? &m.q64 : &m.k64, P == kDQ ? &m.do64 : &m.v64};
  const bool res_in[2] = {(in & (P == kDQ ? 1 : 2)) != 0, (in & (P == kDQ ? 8 : 4)) != 0};
  const CUtensorMap* str[2] = {P == kDQ ? &m.k16 : &m.q16, P == kDQ ? &m.v16 : &m.do16};
  const bool str_in[2] = {(in & (P == kDQ ? 2 : 1)) != 0, (in & (P == kDQ ? 4 : 8)) != 0};

  auto load_tile = [&](int j) {  // streamed tile j into stage j % 2
    const int s = j % kStages;
    unsigned char* st = s_ring + s * T::kStageBytes;
    mbar_expect_tx(&full[s], T::kStageBytes);
    for (int op = 0; op < 2; ++op)
      for (int c = 0; c < kChunks; ++c)
        for (int part = 0; part < BN / kBoxRows; ++part)
          load_chunk(st + op * T::kTileBytes + c * BN * 128 + part * kBoxRows * 128, str[op],
                     str_in[op], &full[s], c, h, j * BN + part * kBoxRows, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
    mbar_expect_tx(res_full, T::kResBytes);
    for (int r = 0; r < NP; ++r)
      for (int c = 0; c < kChunks; ++c)
        load_chunk(s_res + r * kRows * kChunks * 128 + c * kRows * 128, res[r], res_in[r],
                   res_full, c, h, r0, b);
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_tile(j);
  }
  __syncthreads();

  const int w = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane & 3;
  const int row = 16 * warp + g;  // this thread's rows of the block: row, row + 8
  const long long stat0 = static_cast<long long>(bh) * a.n_q;
  // the dQ pass's rows' lse and delta (queries past n_q: P = 0, dS = 0)
  float lse_r[2] = {INFINITY, INFINITY}, delta_r[2] = {0.f, 0.f};
  if constexpr (P == kDQ) {
    for (int e = 0; e < 2; ++e)
      if (r0 + row + 8 * e < a.n_q) {
        lse_r[e] = a.lse[stat0 + r0 + row + 8 * e];
        delta_r[e] = a.delta[stat0 + r0 + row + 8 * e];
      }
  }
  // the score product of this warpgroup: A resident, B streamed (16 rows)
  const unsigned char* s_a = s_res + (NP == 2 ? w * kRows * kChunks * 128 : 0);
  const int b_off = NP == 2 ? w * T::kTileBytes : w * 16 * 128;
  const int col0 = NP == 2 ? 0 : 16 * w;  // its first column of the tile
  // the accumulating product's B: dV dO, dK Q, dQ K; this warpgroup's 4 chunks
  const int c_off = (P == kDV ? T::kTileBytes : 0) + w * 4 * BN * 128;

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  mbar_wait(res_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    const unsigned char* st = s_ring + s * T::kStageBytes;
    float sc[8];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)  // chunk kk / 4, 32-byte step kk % 4 within it
      WgmmaSS<16, 0>::run(sc, desc(s_a + (kk / 4) * kRows * 128 + (kk % 4) * 32, 16, 1024, 1),
                          desc(st + b_off + (kk / 4) * BN * 128 + (kk % 4) * 32, 16, 1024, 1),
                          kk > 0);
    wgmma_commit();
    // columns col0 + 8 (i / 4) + 2t + (i & 1) of the tile: their lse and
    // delta (dV, dK: queries), fetched while the product runs
    float lse_c[4] = {INFINITY, INFINITY, INFINITY, INFINITY}, delta_c[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (P != kDQ) {
      if (NP == 1 || w == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = j * BN + col0 + 8 * (e / 2) + 2 * t + (e & 1);
          if (q < a.n_q) {
            lse_c[e] = a.lse[stat0 + q];
            if constexpr (P == kDK) delta_c[e] = a.delta[stat0 + q];
          }
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(sc);

    if constexpr (NP == 2) {  // warpgroup 1 hands dP over
      if (w == 1) {
#pragma unroll
        for (int i = 0; i < 8; ++i) s_dp[i * 128 + tid] = sc[i];
      }
      __syncthreads();
    }
    if (NP == 1 || w == 0) {
      // sc[i]: row row + 8 ((i >> 1) & 1), column col0 + 8 (i / 4) + 2t + (i & 1)
      float z[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = 2 * (i / 4) + (i & 1);  // this column's lse_c / delta_c
        const int r = (i >> 1) & 1;
        if constexpr (P == kDQ) {
          const int key = j * BN + 8 * (i / 4) + 2 * t + (i & 1);
          const float p = key < a.n_k ? ex2(fmaf(sc[i], a.scale_log2, -lse_r[r])) : 0.f;
          z[i] = p * (s_dp[i * 128 + tid] - delta_r[r]);
        } else {
          const float p = ex2(fmaf(sc[i], a.scale_log2, -lse_c[e]));
          if constexpr (P == kDK)
            z[i] = p * (s_dp[i * 128 + tid] - delta_c[e]);
          else
            z[i] = p;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        const int col = col0 + 8 * (i / 4) + 2 * t, r = row + 8 * ((i >> 1) & 1);
        *reinterpret_cast<uint32_t*>(s_z + z_off<BN>(r, col)) = pack_bf16(z[i], z[i + 1]);
      }
    }
    fence_proxy_async();
    __syncthreads();  // all of P^T or dS written

    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      WgmmaSS<256, 1>::run(acc, desc(s_z + kk * 256, 128, (BN / 8) * 128, 0),
                           desc(st + c_off + kk * 2048, BN * 128, 1024, 1), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // stage s, P^T / dS and dP are free
    if (threadIdx.x == 0 && j + kStages < n_tiles) load_tile(j + kStages);
  }

  bf16* out = P == kDQ ? a.dq : P == kDK ? a.dk : a.dv;
  const Strides so = P == kDQ ? a.sdq : P == kDK ? a.sdk : a.sdv;
  const float mult = P == kDV ? 1.f : a.scale;
  out += b * so.b + h * so.h + 256 * w;
  const int row0 = r0 + row, row1 = row0 + 8;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = 8 * i + 2 * t;
    if (row0 < n_rows)
      *reinterpret_cast<uint32_t*>(out + row0 * so.n + col) =
          pack_bf16(acc[4 * i] * mult, acc[4 * i + 1] * mult);
    if (row1 < n_rows)
      *reinterpret_cast<uint32_t*>(out + row1 * so.n + col) =
          pack_bf16(acc[4 * i + 2] * mult, acc[4 * i + 3] * mult);
  }
}

// delta = rowsum(dO * O) in fp32, one warp a row, 8 rows a block.
__global__ void __launch_bounds__(256)
delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout, float* __restrict__ delta,
             int heads, int n_q, Strides so, Strides sdo) {
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= n_q) return;
  const bf16* po = o + b * so.b + h * so.h + row * so.n;
  const bf16* pd = dout + b * sdo.b + h * sdo.h + row * sdo.n;
  float sum = 0.f;
#pragma unroll
  for (int c = 8 * lane; c < kD; c += 256) {  // 16-byte vectors
    const uint4 vo = ld128(po + c), vd = ld128(pd + c);
    const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&vo);
    const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&vd);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fx = __bfloat1622float2(x[e]), fy = __bfloat1622float2(y[e]);
      sum = fmaf(fx.x, fy.x, fmaf(fx.y, fy.y, sum));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[static_cast<long long>(bh) * n_q + row] = sum;
}

__global__ void __launch_bounds__(256, 1)
flash_attention_bwd512_kernel(const __grid_constant__ Bwd512Maps maps, Bwd512Args a) {
  extern __shared__ unsigned char raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __shared__ uint64_t res_full, full[kStages];
  switch (kPassOrder[blockIdx.z]) {
    case kDK:
      bwd512_pass<kDK>(maps, a, smem, &res_full, full);
      break;
    case kDQ:
      bwd512_pass<kDQ>(maps, a, smem, &res_full, full);
      break;
    default:
      bwd512_pass<kDV>(maps, a, smem, &res_full, full);
  }
}

}  // namespace

}  // namespace ccedit

// C entry point, with ccedit_spatial_attention_bwd's conventions: strides
// are the (batch, head, token) element strides of q, k, v, out, dout, dq,
// dk, dv (24 values); `lse` is kernel 3's log2-domain row log-sum-exp,
// contiguous fp32 (batch * heads, n_q), and `delta` fp32 scratch of that
// shape.  Launches the delta kernel, then the three passes in one launch, on
// `stream`.  Returns the first cudaError_t (0 = success); -1 for a head_dim
// other than 512 or an empty n_q or n_k.
extern "C" int ccedit_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int batch, int heads, int n_q,
    int n_k, int head_dim, const long long* strides, float scale_log2, float scale,
    void* stream) {
  using namespace ccedit;
  if (head_dim != kD || n_q <= 0 || n_k <= 0) return -1;
  constexpr int kSmem = smem_bytes();
  // above 48 KB, dynamic shared memory needs an opt-in per kernel
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_bwd512_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // q, k, v, out, dout, dq, dk, dv
  Strides s[8];
  for (int i = 0; i < 8; ++i) s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  // the descriptors hold the data pointers, so they are built per launch
  Bwd512Maps m;
  bool iq, ik, iv, ido;
  int err = hopper::tensor_map(&m.q64, &iq, q, batch, heads, n_q, kD, s[0], kRows);
  if (err == 0) err = hopper::tensor_map(&m.k64, &ik, k, batch, heads, n_k, kD, s[1], kRows);
  if (err == 0) err = hopper::tensor_map(&m.v64, &iv, v, batch, heads, n_k, kD, s[2], kRows);
  if (err == 0) err = hopper::tensor_map(&m.do64, &ido, dout, batch, heads, n_q, kD, s[4], kRows);
  if (err == 0) err = hopper::tensor_map(&m.q16, &iq, q, batch, heads, n_q, kD, s[0], kBoxRows);
  if (err == 0) err = hopper::tensor_map(&m.k16, &ik, k, batch, heads, n_k, kD, s[1], kBoxRows);
  if (err == 0) err = hopper::tensor_map(&m.v16, &iv, v, batch, heads, n_k, kD, s[2], kBoxRows);
  if (err == 0) err = hopper::tensor_map(&m.do16, &ido, dout, batch, heads, n_q, kD, s[4], kBoxRows);
  if (err != 0) return err;
  Bwd512Args a;
  a.tokens_inner = (iq ? 1 : 0) | (ik ? 2 : 0) | (iv ? 4 : 0) | (ido ? 8 : 0);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.heads = heads;
  a.n_q = n_q;
  a.n_k = n_k;
  a.sdq = s[5];
  a.sdk = s[6];
  a.sdv = s[7];
  a.scale_log2 = scale_log2;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  delta_kernel<<<dim3((n_q + 7) / 8, batch * heads), 256, 0, st>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), static_cast<float*>(delta),
      heads, n_q, s[3], s[4]);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int row_blocks = ((n_q > n_k ? n_q : n_k) + kRows - 1) / kRows;
  flash_attention_bwd512_kernel<<<dim3(row_blocks, batch * heads, kPasses), 256, kSmem, st>>>(m, a);
  return static_cast<int>(cudaGetLastError());
}
