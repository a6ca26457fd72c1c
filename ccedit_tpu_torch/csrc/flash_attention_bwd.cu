// Kernel 4 at head_dim 512: the backward of kernel 3, dq, dk and dv of the
// VAE's single-head mid-block attention in VAE training, (12, 1, 1024, 512)
// at the fine-tune's 12 images of 256x256 and (4, 1, 4096, 512) at 512x512;
// any n_q, n_k >= 1.
//
// Replaces: the stock Pallas TPU flash-attention backward that
// ccedit_tpu/ops/attention.py `_xla_attention_bwd` reaches through
// `jax.vjp(flash_attention)` at kernel 3's shapes.
//
// What bounds it on an H100: arithmetic.  Five products of the forward's
// QK^T size (S = Q K^T and dP = dO V^T recomputed in both kernels, dV = P^T
// dO, dK = dS^T Q, dQ = dS K; 64 GFLOP at (12, 1, 1024, 512)) against 63 MB
// of q, k, v, o, dO, dq, dk, dv: 0.065 ms on the tensor cores, far above the
// bf16 ridge point.  The (n_q x n_k) P and dS never reach device memory.
//
// Why kernel 4's d 40/80/160 layout does not widen to 512: it keeps a warp's
// dK or dV rows (16 keys x head_dim) in registers, 256 fp32 a thread at
// d = 512, over the 255 limit before anything else, and its dK/dV block
// stages ~430 KB of shared memory at d = 512.  Here the accumulators are
// split by head-dim columns instead: each of a block's 8 warps owns 64 of the
// 512 columns (32 fp32 registers per accumulator), and the small score tiles
// go through shared memory between the warps.
//
// Design: FlashAttention-2's backward, two kernels and no atomics, 8 warps a
// block; delta = rowsum(dO * O) is an fp32 torch reduction in the wrapper
// (the stock Pallas backward's `di`).
//   dK/dV kernel: one block per (batch*head, 16-key tile) walks 32-query
//   steps.  Phase A: each warp computes one 16-key x 8-query tile of S^T =
//   K Q^T (warps 0-3) or dP^T = V dO^T (warps 4-7) over the full head dim
//   (32 mma.sync m16n8k16 k-steps, two accumulators for ILP) into fp32
//   shared memory.  Phase B: all threads form P^T = exp2(S^T * scale_log2 -
//   lse) with kernel 3's log2-domain lse and dS^T = P^T (dP^T - delta), bf16.
//   Phase C: each warp accumulates dV += P^T dO and dK += dS^T Q over its 64
//   columns; dO and Q are the products' B operands in their row-major
//   staging, read with ldmatrix.trans.
//   dQ kernel: one block per (batch*head, 16-query tile) walks 32-key steps
//   the same way: S = Q K^T and dP = dO V^T tiles, dS, then dQ += dS K over
//   each warp's 64 columns (K through ldmatrix.trans).
//   The softmax scale multiplies dK and dQ once, in the epilogue.  Rows
//   past n_q or n_k are staged as zeros, with lse = +inf past n_q and P
//   masked to 0 past n_k, so they add exact zeros.  Shared memory (dynamic):
//   105 KB a block in either kernel (107,264 bytes): two blocks an SM.
//   Staged rows are 520 bf16 (1040 bytes) apart: every 16-byte ldmatrix row
//   and every 32-bit fragment load of a quad falls on its own banks.
//
// ptxas (sm_90a, from chip_smoke.py's verbose build): 128 registers for the
// dK/dV kernel (the __launch_bounds__ cap for two blocks an SM), 114 for the
// dQ kernel, no spills.
//
// Left for later: cp.async/TMA pipelining of the Q/dO and K/V steps, wgmma,
// one pass for S and dP (they are recomputed in both kernels).
#include "attention_common.cuh"

namespace ccedit {

namespace {

constexpr int kD = 512;
constexpr int kLD = kD + 8;        // bf16 pitch of staged rows
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = kD / kWarps;  // head-dim columns of a warp's accumulators
constexpr int kNB = kCols / 8;      // their 8-wide n-tiles
constexpr int kVPR = kD / 8;        // 16-byte vectors per row
constexpr int kRows = 16;           // keys (dK/dV) or queries (dQ) per block
constexpr int kStep = 32;           // queries (dK/dV) or keys (dQ) per step
constexpr int kLDS = kStep + 4;     // fp32 pitch of the S / dP tiles
constexpr int kLDP = kStep + 8;     // bf16 pitch of the P / dS tiles

// One kernel's shared memory: the block's 16 rows of two operands, a step's
// 32 rows of two more, the fp32 S and dP tiles, the bf16 P and dS tiles
// (dQ uses only dS), and a step's lse and delta (dK/dV only).
constexpr size_t kSmemBytes = sizeof(bf16) * (2 * kRows * kLD + 2 * kStep * kLD +
                                              2 * kRows * kLDP) +
                              sizeof(float) * (2 * kRows * kLDS + 2 * kStep);
static_assert(kSmemBytes <= 232448 / 2, "two blocks an SM");

struct Bwd512Args {
  const bf16 *q, *k, *v, *dout;
  bf16 *dq, *dk, *dv;
  const float *lse, *delta;  // (batch * heads, n_q), fp32
  int heads, n_q, n_k;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  float scale_log2, scale;
};

// Rows [r0, r0 + rows) of an (N x 512) operand into shared memory at pitch
// kLD; rows at or past n are zeros.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long stride_n,
                                           int r0, int rows, int n) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < rows * kVPR; i += kThreads) {
    const int r = i / kVPR, c = i % kVPR;
    st128(dst + r * kLD + c * 8, r0 + r < n ? ld128(src + (r0 + r) * stride_n + c * 8) : zero);
  }
}

// A fragment (16 x 16, row-major) at `p` with row pitch `ld`.
__device__ __forceinline__ void a_frag(uint32_t a[4], const bf16* p, int ld) {
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragments of two neighbouring 8-wide n-tiles of a product whose B
// operand is stored row-major with the k index along the rows: `tile` is
// &B[k0][n0], `ld` its pitch.  ldmatrix.x4.trans: lanes 0-7 address rows
// k0..k0+7 at column n0 (b0 of n-tile 0), lanes 8-15 rows k0+8..k0+15 (b1),
// lanes 16-31 the same rows at column n0 + 8 (b0, b1 of n-tile 1); the
// transpose hands lane (g, t) the elements B[2t, 2t+1][g] of each matrix.
__device__ __forceinline__ void b_frags_trans(uint32_t b[4], const bf16* tile, int ld) {
  const int lane = threadIdx.x & 31;
  const bf16* p = tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(addr));
}

// Phase A of either kernel: this warp's 16 x 8 tile of A B^T over the full
// head dim, A rows at `a_rows` and B rows at `b_rows` (both pitch kLD), into
// the fp32 tile `dst` (pitch kLDS) at column `col0`.
__device__ __forceinline__ void score_tile(const bf16* a_rows, const bf16* b_rows,
                                           float* dst, int col0, int g, int t) {
  float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
  const bf16* ap = a_rows + g * kLD + 2 * t;
  const bf16* bp = b_rows + g * kLD + 2 * t;
#pragma unroll 8
  for (int kk = 0; kk < kD / 16; kk += 2) {
    uint32_t af[4];
    a_frag(af, ap + kk * 16, kLD);
    mma_16816(c0, af, ld32(bp + kk * 16), ld32(bp + kk * 16 + 8));
    a_frag(af, ap + kk * 16 + 16, kLD);
    mma_16816(c1, af, ld32(bp + kk * 16 + 16), ld32(bp + kk * 16 + 24));
  }
  dst[g * kLDS + col0 + 2 * t] = c0[0] + c1[0];
  dst[g * kLDS + col0 + 2 * t + 1] = c0[1] + c1[1];
  dst[(g + 8) * kLDS + col0 + 2 * t] = c0[2] + c1[2];
  dst[(g + 8) * kLDS + col0 + 2 * t + 1] = c0[3] + c1[3];
}

__device__ __forceinline__ void store_rows(bf16* out, long long stride_n, int row0, int n,
                                           int col0, const float acc[kNB][4], float mult,
                                           int g, int t) {
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) {
    const int col = col0 + nb * 8 + 2 * t;
    if (row0 + g < n)
      *reinterpret_cast<uint32_t*>(out + (row0 + g) * stride_n + col) =
          pack_bf16(acc[nb][0] * mult, acc[nb][1] * mult);
    if (row0 + g + 8 < n)
      *reinterpret_cast<uint32_t*>(out + (row0 + g + 8) * stride_n + col) =
          pack_bf16(acc[nb][2] * mult, acc[nb][3] * mult);
  }
}

__global__ void __launch_bounds__(kThreads, 2) attention_bwd512_dkdv_kernel(Bwd512Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_k = reinterpret_cast<bf16*>(smem);  // kRows keys x kLD
  bf16* s_v = s_k + kRows * kLD;              // kRows keys x kLD
  bf16* s_q = s_v + kRows * kLD;              // kStep queries x kLD
  bf16* s_do = s_q + kStep * kLD;             // kStep queries x kLD
  bf16* s_pt = s_do + kStep * kLD;            // kRows x kLDP: P^T (keys x queries)
  bf16* s_dst = s_pt + kRows * kLDP;          // kRows x kLDP: dS^T
  float* s_s = reinterpret_cast<float*>(s_dst + kRows * kLDP);  // kRows x kLDS: S^T
  float* s_dp = s_s + kRows * kLDS;           // kRows x kLDS: dP^T
  float* s_lse = s_dp + kRows * kLDS;         // kStep
  float* s_delta = s_lse + kStep;             // kStep

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int k0 = blockIdx.x * kRows;
  const bf16* q = a.q + b * a.sq.b + h * a.sq.h;
  const bf16* dout = a.dout + b * a.sdo.b + h * a.sdo.h;
  const float* lse = a.lse + static_cast<long long>(bh) * a.n_q;
  const float* delta = a.delta + static_cast<long long>(bh) * a.n_q;

  stage_rows(s_k, a.k + b * a.sk.b + h * a.sk.h, a.sk.n, k0, kRows, a.n_k);
  stage_rows(s_v, a.v + b * a.sv.b + h * a.sv.h, a.sv.n, k0, kRows, a.n_k);

  // phase A: warps 0-3 S^T = K Q^T, warps 4-7 dP^T = V dO^T, 8 queries each
  const bool is_dp = warp >= 4;
  const int qc = (warp & 3) * 8;
  // phase C: this warp's columns of dV and dK
  const int d0 = warp * kCols;
  float dv[kNB][4], dk[kNB][4];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[nb][e] = dk[nb][e] = 0.f;

  for (int q0 = 0; q0 < a.n_q; q0 += kStep) {
    __syncthreads();  // the previous step's tiles have been consumed
    stage_rows(s_q, q, a.sq.n, q0, kStep, a.n_q);
    stage_rows(s_do, dout, a.sdo.n, q0, kStep, a.n_q);
    if (tid < kStep) {  // past n_q: P = exp2(-inf) = 0 and dS = 0
      const bool valid = q0 + tid < a.n_q;
      s_lse[tid] = valid ? lse[q0 + tid] : INFINITY;
      s_delta[tid] = valid ? delta[q0 + tid] : 0.f;
    }
    __syncthreads();

    score_tile(is_dp ? s_v : s_k, (is_dp ? s_do : s_q) + qc * kLD, is_dp ? s_dp : s_s, qc, g, t);
    __syncthreads();

    for (int i = tid; i < kRows * kStep; i += kThreads) {
      const int key = i / kStep, qi = i % kStep;
      float p = exp2f(s_s[key * kLDS + qi] * a.scale_log2 - s_lse[qi]);
      if (k0 + key >= a.n_k) p = 0.f;
      s_pt[key * kLDP + qi] = __float2bfloat16(p);
      s_dst[key * kLDP + qi] = __float2bfloat16(p * (s_dp[key * kLDS + qi] - s_delta[qi]));
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kStep / 16; ++j) {
      uint32_t pa[4], da[4];
      a_frag(pa, s_pt + g * kLDP + j * 16 + 2 * t, kLDP);
      a_frag(da, s_dst + g * kLDP + j * 16 + 2 * t, kLDP);
#pragma unroll
      for (int nb = 0; nb < kNB; nb += 2) {
        uint32_t bf[4];
        b_frags_trans(bf, s_do + j * 16 * kLD + d0 + nb * 8, kLD);
        mma_16816(dv[nb], pa, bf[0], bf[1]);
        mma_16816(dv[nb + 1], pa, bf[2], bf[3]);
        b_frags_trans(bf, s_q + j * 16 * kLD + d0 + nb * 8, kLD);
        mma_16816(dk[nb], da, bf[0], bf[1]);
        mma_16816(dk[nb + 1], da, bf[2], bf[3]);
      }
    }
  }

  store_rows(a.dv + b * a.sdv.b + h * a.sdv.h, a.sdv.n, k0, a.n_k, d0, dv, 1.f, g, t);
  store_rows(a.dk + b * a.sdk.b + h * a.sdk.h, a.sdk.n, k0, a.n_k, d0, dk, a.scale, g, t);
}

__global__ void __launch_bounds__(kThreads, 2) attention_bwd512_dq_kernel(Bwd512Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);  // kRows queries x kLD
  bf16* s_do = s_q + kRows * kLD;             // kRows queries x kLD
  bf16* s_k = s_do + kRows * kLD;             // kStep keys x kLD
  bf16* s_v = s_k + kStep * kLD;              // kStep keys x kLD
  bf16* s_ds = s_v + kStep * kLD;             // kRows x kLDP: dS (queries x keys)
  float* s_s = reinterpret_cast<float*>(s_ds + 2 * kRows * kLDP);  // kRows x kLDS: S
  float* s_dp = s_s + kRows * kLDS;           // kRows x kLDS: dP
  float* s_lse = s_dp + kRows * kLDS;         // kRows
  float* s_delta = s_lse + kStep;             // kRows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x * kRows;
  const bf16* k = a.k + b * a.sk.b + h * a.sk.h;
  const bf16* v = a.v + b * a.sv.b + h * a.sv.h;
  const long long base = static_cast<long long>(bh) * a.n_q;

  stage_rows(s_q, a.q + b * a.sq.b + h * a.sq.h, a.sq.n, q0, kRows, a.n_q);
  stage_rows(s_do, a.dout + b * a.sdo.b + h * a.sdo.h, a.sdo.n, q0, kRows, a.n_q);
  if (tid < kRows) {  // past n_q: P = 0 and dS = 0 (those rows are not stored)
    const bool valid = q0 + tid < a.n_q;
    s_lse[tid] = valid ? a.lse[base + q0 + tid] : INFINITY;
    s_delta[tid] = valid ? a.delta[base + q0 + tid] : 0.f;
  }

  // phase A: warps 0-3 S = Q K^T, warps 4-7 dP = dO V^T, 8 keys each
  const bool is_dp = warp >= 4;
  const int kc = (warp & 3) * 8;
  const int d0 = warp * kCols;
  float dq[kNB][4];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) dq[nb][0] = dq[nb][1] = dq[nb][2] = dq[nb][3] = 0.f;

  for (int k0 = 0; k0 < a.n_k; k0 += kStep) {
    __syncthreads();  // the previous key step has been consumed; on the first, Q and dO staged
    stage_rows(s_k, k, a.sk.n, k0, kStep, a.n_k);
    stage_rows(s_v, v, a.sv.n, k0, kStep, a.n_k);
    __syncthreads();

    score_tile(is_dp ? s_do : s_q, (is_dp ? s_v : s_k) + kc * kLD, is_dp ? s_dp : s_s, kc, g, t);
    __syncthreads();

    for (int i = tid; i < kRows * kStep; i += kThreads) {
      const int qi = i / kStep, key = i % kStep;
      float p = exp2f(s_s[qi * kLDS + key] * a.scale_log2 - s_lse[qi]);
      if (k0 + key >= a.n_k) p = 0.f;
      s_ds[qi * kLDP + key] = __float2bfloat16(p * (s_dp[qi * kLDS + key] - s_delta[qi]));
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kStep / 16; ++j) {
      uint32_t da[4];
      a_frag(da, s_ds + g * kLDP + j * 16 + 2 * t, kLDP);
#pragma unroll
      for (int nb = 0; nb < kNB; nb += 2) {
        uint32_t bf[4];
        b_frags_trans(bf, s_k + j * 16 * kLD + d0 + nb * 8, kLD);
        mma_16816(dq[nb], da, bf[0], bf[1]);
        mma_16816(dq[nb + 1], da, bf[2], bf[3]);
      }
    }
  }

  store_rows(a.dq + b * a.sdq.b + h * a.sdq.h, a.sdq.n, q0, a.n_q, d0, dq, a.scale, g, t);
}

int launch_bwd512(const Bwd512Args& a, int batch, cudaStream_t stream) {
  // above 48 KB, dynamic shared memory needs an opt-in per kernel
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(attention_bwd512_dkdv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(attention_bwd512_dq_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kSmemBytes));
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int bhs = batch * a.heads;
  attention_bwd512_dkdv_kernel<<<dim3((a.n_k + kRows - 1) / kRows, bhs), kThreads, kSmemBytes,
                                 stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd512_dq_kernel<<<dim3((a.n_q + kRows - 1) / kRows, bhs), kThreads, kSmemBytes,
                               stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace ccedit

// C entry point, with ccedit_spatial_attention_bwd's conventions: strides
// are the (batch, head, token) element strides of q, k, v, dout, dq, dk, dv
// (21 values); `lse` is kernel 3's log2-domain row log-sum-exp and `delta`
// rowsum(dO * O), both contiguous fp32 (batch * heads, n_q).  Launches the
// dK/dV kernel, then the dQ kernel, on `stream`.  Returns the first
// cudaError_t (0 = success); -1 for a head_dim other than 512.
extern "C" int ccedit_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, void* dk, void* dv, int batch, int heads, int n_q,
    int n_k, int head_dim, const long long* strides, float scale_log2, float scale,
    void* stream) {
  using ccedit::bf16;
  using ccedit::Strides;
  if (head_dim != ccedit::kD) return -1;
  ccedit::Bwd512Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.heads = heads;
  a.n_q = n_q;
  a.n_k = n_k;
  Strides* s[7] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 7; ++i) *s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.scale_log2 = scale_log2;
  a.scale = scale;
  return ccedit::launch_bwd512(a, batch, static_cast<cudaStream_t>(stream));
}
